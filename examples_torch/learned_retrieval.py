#!/usr/bin/env python
"""Fine-tune -> R@1 gate -> serve -> POST /search, on the PyTorch/CUDA port.

The port's twin of ``examples/learned_retrieval.py``: the evidence that
fine-tuning *learns*, with only procedural data and no download.

1. A labeled photo library: 6 classes = 3 colours x 2 patterns (a solid
   square on noisy gray, or stripes), 28 photos a class, each with a caption
   sidecar in ``train.finetune.find_pairs``'s layout. The pixels, the
   captions and the split are the reference's own (the same generator, the
   same draws); the photos are written as 24-bit BMP
   (``ingest.decode.write_bmp24``), so nothing here needs PIL.
2. A BPE vocabulary trained on the captions (``tokenizer.train_bpe``, 800
   entries: word-level merges, every caption within 16 tokens) and two
   towers of hidden 128 in 4 heads (head dim 32), 3 layers each, 64 px
   images in 8 px patches, seeded random weights.
3. ``train.finetune.run_finetune`` in 50-step segments (batch 48, lr 5e-4):
   each segment's checkpoint is scored on the held-out sets (bidirectional
   R@1 from ``train.eval.evaluate_pairs``, plus the direct-dot precision@5
   of the 6 class queries over the whole library); the best is kept, and
   three segments without a better score stop the loop.
4. The gate: the kept checkpoint's bidirectional R@1 >= 0.6 (chance 1/6).
5. The checkpoint and the tokenizer are saved the server's way
   (``models.convert.save_checkpoint`` with the config embedded,
   ``tokenizer.save``), a ``server.engine.SearchEngine`` boots from those
   files, scans the library, and the 6 class queries go through a real
   ``POST /search`` of the port's HTTP server: precision@5 >= 0.8 with
   every query hitting its class.

The recipe is the one the reference's thresholds were tuned on
(``tests/test_learned_retrieval.py``): 800 steps, 28 photos a class, batch
48, lr 5e-4, 50-step segments, patience 3. As in the reference, a step
budget that 50 does not divide drops its remainder, every segment starts
AdamW afresh (each ``run_finetune`` call makes its optimizer), and the
checkpoint is selected on the same held-out sets the gate then reads
(ROADMAP.md section C.5 records these choices).

It runs on the card by default (bf16 compute, kernels B1 and B5 at head dim
32); ``--device cpu`` runs the plain versions in f32::

    python examples_torch/learned_retrieval.py [--seed 0] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import urllib.request

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

COLORS = {"red": (220, 40, 40), "green": (40, 200, 60), "blue": (50, 80, 230)}
PATTERNS = ("square", "stripes")
N_EVAL_SETS = 4  # eval images per class, one per template set
SEG_STEPS = 50  # steps between held-out evaluations
PATIENCE = 3  # evaluations without a better score before the loop stops
R1_GATE = 0.6
P5_GATE = 0.8

# held-out captions: novel compositions of words that the training
# captions use ({p} is the class phrase, "a red square" / "red stripes")
EVAL_TEMPLATES = (
    "a photo of {p}",
    "an image of {p}",
    "a picture showing {p}",
    "{p} over gray",
)
# training captions: 12 templates a pattern, with position and size words
# for squares and thickness words for stripes, so that the photos of a
# contrastive batch rarely share a caption
TRAIN_TEMPLATES = {
    "square": (
        "a photo of a {sz} {c} square in the {pos}",
        "a {sz} {c} square",
        "one {c} square near the {pos}",
        "the {pos} has a {c} square",
        "an image showing a {sz} {c} square",
        "a {c} square over gray noise",
        "a picture of a {sz} {c} square",
        "a {c} square sits in the {pos}",
        "the image shows a {c} square",
        "a single {sz} {c} square",
        "a {c} square on gray",
        "look at the {c} square in the {pos}",
    ),
    "stripes": (
        "a photo of {th} {c} stripes",
        "an image showing {c} stripes",
        "{th} {c} stripes across the picture",
        "a picture of {c} stripes",
        "{th} {c} stripes",
        "{c} stripes over gray noise",
        "horizontal {th} {c} stripes",
        "a photo showing {c} stripes",
        "many {th} {c} stripes",
        "{c} stripes fill the image",
        "a pattern of {th} {c} stripes",
        "the picture contains {c} stripes",
    ),
}


def phrase(color: str, pattern: str) -> str:
    return f"a {color} square" if pattern == "square" else f"{color} stripes"


def class_queries():
    """(query, file-name prefix of its class) for the 6 classes."""
    return [(f"a photo of {phrase(c, p)}", f"{c}_{p}_") for c in COLORS for p in PATTERNS]


def draw(pattern: str, color, rng, size=64):
    """A noisy gray canvas with one coloured pattern -> (image, position,
    size word, thickness word); the reference's draws, in its order."""
    img = rng.integers(100, 145, size=(size, size, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:size, 0:size]
    cy, cx = rng.integers(26, size - 26, 2)
    r = rng.integers(16, 27)
    if pattern == "stripes":
        t = int(rng.integers(3, 8))
        ph = int(rng.integers(0, 2 * t))
        mask = ((yy + ph) // t) % 2 == 0
    else:
        t = 4
        mask = (np.abs(yy - cy) <= r) & (np.abs(xx - cx) <= r)
    img[mask] = color
    pos = ("upper" if cy < size // 2 else "lower") + " " + ("left" if cx < size // 2 else "right")
    return img, pos, ("small" if r < 21 else "large"), ("thin" if t <= 4 else "wide")


def build_library(media: str, per_class: int, seed: int = 0):
    """The labeled library as BMP files with caption sidecars in ``media``.

    Returns (train_pairs, eval_sets, all_captions): the last N_EVAL_SETS
    photos of every class are held out, eval set t holding one photo a class
    captioned with EVAL_TEMPLATES[t] (two photos of one class in a set would
    tie, and the pessimistic ranking would count that as a miss)."""
    from image_search_tpu_torch.ingest.decode import write_bmp24

    rng = np.random.default_rng(seed)
    train_pairs, all_caps = [], []
    eval_sets = [[] for _ in range(N_EVAL_SETS)]
    for color in COLORS:
        for pattern in PATTERNS:
            for i in range(per_class):
                img, pos, sz, th = draw(pattern, COLORS[color], rng)
                stem = f"{color}_{pattern}_{i}"
                path = os.path.join(media, stem + ".bmp")
                write_bmp24(path, img)
                if i >= per_class - N_EVAL_SETS:
                    t = i - (per_class - N_EVAL_SETS)
                    cap = EVAL_TEMPLATES[t].format(p=phrase(color, pattern))
                    eval_sets[t].append((path, cap))
                else:
                    tmpl = TRAIN_TEMPLATES[pattern]
                    cap = tmpl[i % len(tmpl)].format(c=color, pos=pos, sz=sz, th=th)
                    train_pairs.append((path, cap))
                with open(os.path.join(media, stem + ".txt"), "w") as f:
                    f.write(cap)
                all_caps.append(cap)
    return train_pairs, eval_sets, all_caps


def demo_config(tokenizer):
    """The example's two towers: hidden 128 in 4 heads (head dim 32), 3
    layers each, 64 px images in 8 px patches, 16 tokens."""
    from image_search_tpu_torch.config import CLIPConfig, TextConfig, VisionConfig

    return CLIPConfig(
        name="learned-demo-clip",
        text=TextConfig(hidden_size=128, num_layers=3, num_heads=4, vocab_size=tokenizer.vocab_size,
                        context_length=16, eos_token_id=tokenizer.eos_id),
        vision=VisionConfig(hidden_size=128, num_layers=3, num_heads=4, image_size=64, patch_size=8),
        projection_dim=64,
    )


def eval_r1(embedder, eval_sets) -> dict:
    """``train.eval.evaluate_pairs``'s metrics averaged over the eval sets."""
    from image_search_tpu_torch.train.eval import evaluate_pairs

    metrics = [evaluate_pairs(embedder, s, ks=(1, 5))[0] for s in eval_sets]
    return {k: float(np.mean([m[k] for m in metrics])) for k in metrics[0]}


def bidirectional_r1(metrics: dict) -> float:
    return (metrics["recall@1_i2t"] + metrics["recall@1_t2i"]) / 2


def _post(base: str, body: dict):
    req = urllib.request.Request(base + "/search", data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def serve_and_query(ckpt: str, tok_dir: str, media: str, index_dir: str, device) -> dict:
    """A SearchEngine booted from the saved files (``model`` names another
    preset: the checkpoint's own config must win), one /scan of the
    library, the 6 class queries through POST /search of the port's HTTP
    server. -> {query: [(file name, score), ...]} (top 5)."""
    from image_search_tpu_torch.server.app import make_server
    from image_search_tpu_torch.server.args import ServerArgs
    from image_search_tpu_torch.server.engine import SearchEngine

    engine = SearchEngine(ServerArgs(model_weights=ckpt, tokenizer_dir=tok_dir, model="clip-tiny-test",
                                     media_dir=media, index_dir=index_dir, k=5), device=device)
    if engine.cfg.name != "learned-demo-clip":
        raise RuntimeError(f"the engine loaded {engine.cfg.name}, not the checkpoint's config")
    engine.scan()
    server = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_port}"
    served = {}
    try:
        for q, _ in class_queries():
            status, body = _post(base, {"q": q, "referenced_images": []})
            if status != 200:
                raise RuntimeError(f"POST /search {q!r}: status {status}")
            served[q] = [(os.path.basename(h["image_path"]), float(h["score"])) for h in body["images"]]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    return served


def precision_at_5(top: dict) -> dict:
    """{query: share of its top 5 in the query's class}."""
    return {q: sum(name.startswith(prefix) for name, _ in top[q][:5]) / 5.0 for q, prefix in class_queries()}


def run(steps: int = 800, per_class: int = 28, seed: int = 0, batch_size: int = 48, learning_rate: float = 5e-4,
        device: str = "cuda", root: str | None = None, log=print) -> dict:
    """The whole loop; returns the measured metrics (the gates read them)."""
    import torch

    from image_search_tpu_torch.ingest.decode import decode_image
    from image_search_tpu_torch.models.convert import build_model, init_params, params_to_jax, save_checkpoint
    from image_search_tpu_torch.models.embedder import ClipEmbedder
    from image_search_tpu_torch.tokenizer import train_bpe
    from image_search_tpu_torch.train.finetune import run_finetune

    device = torch.device(device)
    compute_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    root = root or tempfile.mkdtemp(prefix="learned_")
    media = os.path.join(root, "photos")
    os.makedirs(media)
    train_pairs, eval_sets, caps = build_library(media, per_class, seed)
    n_classes = len(COLORS) * len(PATTERNS)
    log(f"[1/5] library: {len(train_pairs)} train pairs, {len(eval_sets)} eval sets x {n_classes} classes")

    tokenizer = train_bpe(caps, vocab_size=800, context_length=16)
    cfg = demo_config(tokenizer)
    # the weights are drawn on the CPU, so a seed gives the same start on any device
    state0 = init_params(cfg, torch.Generator().manual_seed(seed), "cpu", torch.float32)
    model = build_model(cfg, state0, device, torch.float32, trainable=True)

    def embedder_of(state):
        # the towers compute in the compute dtype (kernel B1 takes bf16 only)
        return ClipEmbedder(build_model(cfg, state, device, compute_dtype), tokenizer=tokenizer)

    files = sorted(f for f in os.listdir(media) if f.endswith(".bmp"))
    arrays = [decode_image(os.path.join(media, f)) for f in files]

    def direct_top5(embedder) -> dict:
        """The 6 class queries against every photo by a plain dot product
        of normalised embeddings: {query: [(file name, score), ...]}."""
        iemb = embedder.embed_images(arrays)
        iemb = iemb / np.linalg.norm(iemb, axis=1, keepdims=True)
        out = {}
        for q, _ in class_queries():
            t = embedder.embed_texts([q])[0]
            s = iemb @ (t / np.linalg.norm(t))
            out[q] = [(files[j], float(s[j])) for j in np.argsort(-s, kind="stable")[:5]]
        return out

    before = eval_r1(embedder_of(model.state_dict()), eval_sets)
    log(f"[2/5] random init: {before}")

    seg_steps = min(SEG_STEPS, steps)  # a budget under 50 steps is one short segment
    segments = max(1, steps // seg_steps)
    losses, history = [], []
    best = None  # (score, state, metrics, direct top 5, segment)
    since_best = 0
    for seg in range(segments):
        model, seg_losses = run_finetune(model, cfg, tokenizer, train_pairs, batch_size=batch_size, steps=seg_steps,
                                         learning_rate=learning_rate, log_every=100, seed=seed + seg, device=device)
        losses.extend(seg_losses)
        state = {k: t.detach().clone() for k, t in model.state_dict().items()}
        emb = embedder_of(state)
        m = eval_r1(emb, eval_sets)
        top = direct_top5(emb)
        p5 = float(np.mean(list(precision_at_5(top).values())))
        score = bidirectional_r1(m) + p5
        history.append({"segment": seg, "loss": seg_losses[-1], "r1": bidirectional_r1(m), "direct_p5": p5})
        log(f"[3/5] seg {seg}: step {(seg + 1) * seg_steps}, loss {seg_losses[-1]:.3f}, "
            f"held-out R@1 {bidirectional_r1(m):.3f}, direct p@5 {p5:.2f}")
        if best is None or score > best[0]:
            best = (score, state, m, top, seg)
            since_best = 0
        else:
            since_best += 1
            if since_best >= PATIENCE:
                log(f"[3/5] early stop at seg {seg} (no improvement for {PATIENCE} evaluations)")
                break

    _, best_state, after, direct, best_seg = best
    direct_p5 = precision_at_5(direct)
    log(f"[4/5] selected seg {best_seg}: {after}; direct-dot precision@5 {np.mean(list(direct_p5.values())):.2f}")

    ckpt = os.path.join(root, "models", "learned.safetensors")
    tok_dir = os.path.join(root, "models", "tokenizer")
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    save_checkpoint(ckpt, params_to_jax(build_model(cfg, best_state, "cpu", torch.float32)), cfg)
    tokenizer.save(tok_dir)
    served = serve_and_query(ckpt, tok_dir, media, os.path.join(root, "idx"), device)
    per_query = precision_at_5(served)
    precision5 = float(np.mean(list(per_query.values())))
    hits = sum(1 for v in per_query.values() if v > 0)
    log(f"[5/5] served /search precision@5 {precision5:.2f}, {hits}/{len(per_query)} queries hit "
        f"(per query: {per_query})")
    return {
        "seed": seed,
        "learning_rate": learning_rate,
        "device": str(device),
        "chance_r1": 1.0 / n_classes,
        "before": before,
        "after": after,
        "r1": bidirectional_r1(after),
        "losses": (losses[0], losses[-1]),
        "steps_run": len(losses),
        "best_segment": best_seg,
        "history": history,
        "served_precision_at_5": precision5,
        "served_queries_hit": hits,
        "served_n_queries": len(per_query),
        "served_per_query": per_query,
        "served_top5": served,
        "direct_precision_at_5": float(np.mean(list(direct_p5.values()))),
        "direct_top5": direct,
        "vocab_size": tokenizer.vocab_size,
    }


def passes_gate(m: dict) -> bool:
    """The reference's gates: bidirectional R@1 >= 0.6, served precision@5
    >= 0.8, every class query hitting its class."""
    return (m["r1"] >= R1_GATE and m["served_precision_at_5"] >= P5_GATE
            and m["served_queries_hit"] == m["served_n_queries"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--per-class", type=int, default=28)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu for the tests)")
    args = ap.parse_args(argv)
    m = run(steps=args.steps, per_class=args.per_class, seed=args.seed, batch_size=args.batch,
            learning_rate=args.lr, device=args.device)
    print(f"bidirectional R@1: {bidirectional_r1(m['before']):.3f} -> {m['r1']:.3f} (chance {m['chance_r1']:.3f}); "
          f"served precision@5 {m['served_precision_at_5']:.2f}")
    assert m["r1"] >= R1_GATE, "model did not learn (R@1 gate)"
    assert m["served_precision_at_5"] >= P5_GATE, "serving did not retrieve classes"
    assert m["served_queries_hit"] == m["served_n_queries"], m["served_per_query"]


if __name__ == "__main__":
    main()
