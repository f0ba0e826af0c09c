"""Domain fine-tuning: (image, caption) pairs -> adapted checkpoint.

Port of ``image_search_tpu/train/finetune.py`` for one device::

    python -m image_search_tpu_torch.train.finetune \\
        --data-dir /captions --weights models/clip.safetensors \\
        --tokenizer-dir models/tokenizer --out models/clip_ft.safetensors

Data layout: every image file with a same-stem ``.txt`` sidecar caption
(``dog.jpg`` + ``dog.txt``). The checkpoint files are the reference's, so
either package reads what the other writes. Training keeps f32 master weights
and computes in bf16 on the card (f32 on the CPU); it runs on the card unless
``--device cpu`` is given. ``--thumb-cache DIR`` decodes from the tiles the
server's cache keeps (``ingest/thumbcache.py``): epochs after the first read
no original. Flags for what is not ported (device meshes, FSDP) raise at
startup.
"""

from __future__ import annotations

import argparse
import logging
import os
import random
import time
from typing import List, Optional, Tuple

log = logging.getLogger(__name__)


class BatchPrefetcher:
    """Keeps ONE batch of host work (decode + preprocess + tokenize) in
    flight on a background thread, so step N+1's input is built while the
    device runs step N.

    ``make_batch()`` runs strictly serialized on the single worker thread,
    so shared state inside it (the sampling RNG, the decode pool) needs no
    extra locking and batch order stays deterministic."""

    def __init__(self, make_batch):
        from concurrent.futures import ThreadPoolExecutor

        self._make = make_batch
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._inflight = self._pool.submit(make_batch)

    def next(self):
        """Return the ready batch and immediately start building the next
        one (overlapping whatever the caller does with the result)."""
        batch = self._inflight.result()
        self._inflight = self._pool.submit(self._make)
        return batch

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)


def find_pairs(data_dir: str) -> List[Tuple[str, str]]:
    """(image_path, caption) pairs via .txt sidecars."""
    from image_search_tpu_torch.ingest.walk import iter_images

    pairs = []
    for img in iter_images(data_dir):
        txt = os.path.splitext(img)[0] + ".txt"
        if os.path.exists(txt):
            with open(txt, encoding="utf-8") as f:
                caption = f.read().strip()
            if caption:
                pairs.append((img, caption))
    return pairs


def run_finetune(
    model,
    cfg,
    tokenizer,
    pairs: List[Tuple[str, str]],
    *,
    mesh=None,
    batch_size: int = 64,
    steps: int = 100,
    learning_rate: float = 1e-5,
    compute_dtype=None,
    preprocess_mode: str = "hf",
    remat: bool = False,
    remat_policy: str = "dots_with_no_batch_dims_saveable",
    fsdp: bool = False,
    seed: int = 0,
    log_every: int = 10,
    checkpoint_dir: str | None = None,
    save_every: int = 100,
    thumb_cache=None,
    device="cuda",
):
    """Trains ``model`` (a ``CLIP`` with f32 parameters, moved to
    ``device``) in place; returns (model, list of losses). A run resumed
    from ``checkpoint_dir`` continues at the saved step.

    remat_policy (with remat=True) names what the recompute saves: the
    default keeps the projections' matmul outputs and recomputes the
    elementwise and LayerNorm work; "" is full remat. The loop logs each
    step's wall time and loss at DEBUG level (``step N: T ms, loss X``)."""
    import torch

    from image_search_tpu_torch.ingest.decode import DecodePool
    from image_search_tpu_torch.ops.preprocess import fused_preprocess, pack_batch
    from image_search_tpu_torch.train.contrastive import adamw, make_train_step

    device = torch.device(device)
    if compute_dtype is None:
        compute_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    init_fn, step_fn = make_train_step(
        cfg, adamw(learning_rate, weight_decay=0.01), compute_dtype, remat, device,
        remat_policy=remat_policy, mesh=mesh, fsdp=fsdp,
    )
    state = init_fn(model)
    if checkpoint_dir:
        from image_search_tpu_torch.train.checkpoint import load_train_state

        restored = load_train_state(checkpoint_dir, state)
        if restored is not None:
            state = restored

    rng = random.Random(seed)
    pool = DecodePool(workers=8, thumb_cache=thumb_cache)

    def make_batch():
        """Decode + pack + tokenize one batch -- host work only. Runs on the
        prefetch thread, overlapped with the device step; the device
        preprocess runs on the main thread."""
        # keep the batch EXACTLY batch_size
        images, captions = [], []
        for _ in range(5):  # refill rounds for decode failures
            need = batch_size - len(images)
            if need == 0:
                break
            # sample WITHOUT replacement within a draw: a pair drawn twice is
            # a false negative for itself in the contrastive batch. (A later
            # refill round may re-pick a pair kept by an earlier one, as in
            # the reference: ROADMAP section C.)
            if len(pairs) >= need:
                batch = rng.sample(pairs, need)
            else:
                batch = [pairs[rng.randrange(len(pairs))] for _ in range(need)]
            kept, decoded = pool.decode_batch([p for p, _ in batch])
            cap_by_path = {p: c for p, c in batch}
            images.extend(decoded)
            captions.extend(cap_by_path[p] for p in kept)
        if len(images) < batch_size:
            return None
        u8, a_h, a_w = pack_batch(images, size=cfg.vision.image_size, mode=preprocess_mode)
        ids = tokenizer(captions, cfg.text.context_length)
        return ids, u8, a_h, a_w

    losses: List[float] = []
    prefetcher = BatchPrefetcher(make_batch)
    try:
        for step in range(state.step, steps):
            t0 = time.perf_counter()
            batch = prefetcher.next()  # the next batch builds during this step
            if batch is None:
                log.warning("step %d skipped: could not fill batch", step)
                continue
            ids, u8, a_h, a_w = batch
            # device preprocess on the main thread; the pixels stay on the device
            u8, a_h, a_w = (torch.from_numpy(a).to(device) for a in (u8, a_h, a_w))
            pixels = fused_preprocess(u8, a_h, a_w, mode=preprocess_mode, out_dtype=torch.float32)
            state, metrics = step_fn(state, ids, pixels)
            loss = float(metrics["loss"])  # waits for the step
            losses.append(loss)
            log.debug("step %d: %.3f ms, loss %.6f", step, (time.perf_counter() - t0) * 1e3, loss)
            if step % log_every == 0:
                log.info("step %d loss %.4f acc %.3f", step, loss, float(metrics["img_to_txt_acc"]))
            if checkpoint_dir and (step + 1) % save_every == 0:
                from image_search_tpu_torch.train.checkpoint import save_train_state

                save_train_state(checkpoint_dir, state)
    finally:
        prefetcher.close()
        pool.close()
    if checkpoint_dir:
        from image_search_tpu_torch.train.checkpoint import save_train_state

        save_train_state(checkpoint_dir, state)
    return state.model, losses


def main(argv: Optional[List[str]] = None) -> None:
    logging.basicConfig(level="INFO")
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--weights", required=True)
    ap.add_argument("--tokenizer-dir", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--mesh-data", type=int, default=None, help="not ported yet: raises")
    ap.add_argument("--mesh-model", type=int, default=1, help="not ported yet: > 1 raises")
    ap.add_argument("--remat", action="store_true",
                    help="recompute activations in backward (less activation memory)")
    ap.add_argument("--remat-policy", default="dots_with_no_batch_dims_saveable",
                    help="with --remat: the default saves the projections' matmul "
                         "outputs; '' = full remat")
    ap.add_argument("--fsdp", action="store_true", help="not ported yet: raises")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="train-state dir: resume + periodic saves")
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--eval-dir", default=None,
                    help="held-out (image, .txt caption) pairs: retrieval "
                         "R@k is measured before and after training (train/eval.py)")
    ap.add_argument("--thumb-cache", default="",
                    help="persistent decoded-tile cache dir (shareable with the server's "
                         "--thumb-cache): epochs after the first skip the full decode")
    ap.add_argument("--device", default="cuda", help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)

    for flag, on in (("--mesh-data", args.mesh_data is not None), ("--mesh-model", args.mesh_model > 1),
                     ("--fsdp", args.fsdp)):
        if on:
            raise NotImplementedError(f"{flag}: multi-device training is not ported yet")

    import torch

    from image_search_tpu_torch.models.convert import (
        build_model, load_checkpoint, params_from_jax, params_to_jax, save_checkpoint,
    )
    from image_search_tpu_torch.tokenizer import CLIPBPETokenizer, HashTokenizer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    compute_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    params, cfg = load_checkpoint(args.weights)
    if args.tokenizer_dir:
        tokenizer = CLIPBPETokenizer.from_dir(args.tokenizer_dir, cfg.text.context_length)
    else:
        log.warning("no --tokenizer-dir: hash tokenizer (NOT for real training)")
        tokenizer = HashTokenizer(cfg.text.vocab_size, cfg.text.context_length)

    pairs = find_pairs(args.data_dir)
    log.info("found %d (image, caption) pairs", len(pairs))
    if not pairs:
        raise SystemExit("no training pairs (need image files with .txt sidecars)")
    model = build_model(cfg, params_from_jax(params, cfg), device, torch.float32, trainable=True)
    del params

    def eval_retrieval(m, tag: str):
        if not args.eval_dir:
            return
        from image_search_tpu_torch.models.embedder import ClipEmbedder
        from image_search_tpu_torch.train.eval import evaluate_pairs

        eval_pairs = find_pairs(args.eval_dir)
        if not eval_pairs:
            log.warning("--eval-dir %s has no pairs; skipping", args.eval_dir)
            return
        # the embedder computes in its model's dtype, and kernel B1 takes only
        # bf16: it gets a frozen copy of the f32 weights in the compute dtype
        emb = ClipEmbedder(build_model(cfg, m.state_dict(), device, compute_dtype), tokenizer=tokenizer)
        metrics, n = evaluate_pairs(emb, eval_pairs)
        log.info("retrieval %s (%d pairs): %s", tag, n, metrics)

    eval_retrieval(model, "BEFORE")
    thumb_cache = None
    if args.thumb_cache:
        from image_search_tpu_torch.ingest.thumbcache import ThumbCache

        thumb_cache = ThumbCache(args.thumb_cache)
    trained, losses = run_finetune(
        model, cfg, tokenizer, pairs,
        batch_size=args.batch_size, steps=args.steps, learning_rate=args.lr,
        compute_dtype=compute_dtype, remat=args.remat, remat_policy=args.remat_policy,
        checkpoint_dir=args.checkpoint_dir, save_every=args.save_every, thumb_cache=thumb_cache,
        device=device,
    )
    save_checkpoint(args.out, params_to_jax(trained), cfg)
    log.info("wrote %s (final loss %.4f)", args.out, losses[-1] if losses else float("nan"))
    eval_retrieval(trained, "AFTER")


if __name__ == "__main__":
    main()
