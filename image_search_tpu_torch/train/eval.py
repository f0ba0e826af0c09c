"""Retrieval evaluation over (image, caption) pair files: decode + embed +
score with the canonical metrics (``utils/eval.py``: bidirectional recall@k
and median rank, pessimistic about ties).

Port of ``image_search_tpu/train/eval.py``. Fine-tuning (``train/finetune.py``,
``--eval-dir``) uses it to show a checkpoint improved. Data layout mirrors
finetune's (.txt caption sidecars next to images, ``finetune.find_pairs``)::

    python -m image_search_tpu_torch.train.eval --data-dir ~/pairs \\
        -w models/clip.safetensors [--ks 1,5,10] [--device cuda]

prints one JSON line of metrics.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Sequence, Tuple

import numpy as np

from image_search_tpu_torch.utils.eval import retrieval_metrics

log = logging.getLogger(__name__)

__all__ = ["evaluate_pairs", "retrieval_metrics"]


def evaluate_pairs(
    embedder,
    pairs: List[Tuple[str, str]],
    ks: Sequence[int] = (1, 5, 10),
    batch_size: int = 64,
) -> Tuple[Dict[str, float], int]:
    """Embed (image_path, caption) pairs with ``embedder`` (ClipEmbedder)
    and score retrieval. Undecodable images are skipped with a log line.
    Returns (metrics, pairs_evaluated)."""
    from image_search_tpu_torch.ingest.decode import decode_image

    img_parts, texts = [], []
    for lo in range(0, len(pairs), batch_size):
        arrs, caps = [], []
        for path, caption in pairs[lo : lo + batch_size]:
            arr = decode_image(path)
            if arr is None:
                log.warning("eval: skipping undecodable %s", path)
                continue
            arrs.append(arr)
            caps.append(caption)
        if arrs:
            img_parts.append(embedder.embed_images(arrs))
            texts.extend(caps)
    if not img_parts:
        raise ValueError("no decodable pairs to evaluate")
    image_emb = np.concatenate(img_parts, axis=0)
    text_emb = np.concatenate(
        [embedder.embed_texts(texts[lo : lo + batch_size]) for lo in range(0, len(texts), batch_size)],
        axis=0,
    )
    return retrieval_metrics(image_emb, text_emb, ks), len(texts)


def main(argv=None) -> None:
    import argparse
    import json
    import os

    import torch

    logging.basicConfig(level="INFO")
    ap = argparse.ArgumentParser(prog="image-search-tpu-torch-eval")
    ap.add_argument("--data-dir", required=True,
                    help="images with .txt caption sidecars (finetune layout)")
    ap.add_argument("-w", "--model-weights", default="")
    ap.add_argument("--model", default="clip-vit-large-patch14")
    ap.add_argument("--tokenizer-dir", default="")
    ap.add_argument("--ks", default="1,5,10")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ns = ap.parse_args(argv)

    from image_search_tpu_torch import check_precision
    from image_search_tpu_torch.config import get_config
    from image_search_tpu_torch.models.convert import build_model, init_params, load_checkpoint, params_from_jax
    from image_search_tpu_torch.models.embedder import ClipEmbedder
    from image_search_tpu_torch.tokenizer import CLIPBPETokenizer, HashTokenizer
    from image_search_tpu_torch.train.finetune import find_pairs

    device = torch.device(ns.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
        check_precision()
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    pairs = find_pairs(ns.data_dir)
    if not pairs:
        raise SystemExit(f"no (image, .txt caption) pairs under {ns.data_dir}")
    if ns.model_weights and os.path.exists(ns.model_weights):
        params, cfg = load_checkpoint(ns.model_weights)
        state = params_from_jax(params, cfg)
    else:
        cfg = get_config(ns.model)
        log.warning("no checkpoint — RANDOM %s weights (smoke only)", cfg.name)
        state = init_params(cfg, torch.Generator(device=device).manual_seed(0), device, dtype)
    model = build_model(cfg, state, device, dtype)
    if ns.tokenizer_dir and os.path.exists(os.path.join(ns.tokenizer_dir, "vocab.json")):
        tok = CLIPBPETokenizer.from_dir(ns.tokenizer_dir, cfg.text.context_length)
    else:
        tok = HashTokenizer(cfg.text.vocab_size, cfg.text.context_length, eos_id=cfg.text.eos_token_id)
    embedder = ClipEmbedder(model, tokenizer=tok)
    ks = tuple(int(k) for k in ns.ks.split(","))
    metrics, n = evaluate_pairs(embedder, pairs, ks, ns.batch_size)
    print(json.dumps({"pairs": n, **metrics}))


if __name__ == "__main__":
    main()
