"""The port's int8 full scan at 10,000,000 rows x 768 on one CUDA card, and
the cost of its batch-invariant query norm.

At B = 1 and 8, timed in turns by CUDA events (medians):

- ``ops.score_stream.quantize_queries_int8`` (ms per call, over 100 calls);
- ``index.index._search_local`` over the int8 slabs (B2 on each slab, then
  the exact top-k): the whole search of an int8 index;

each with the query norm by ``ops.score_stream.row_norms`` (a fixed pairwise
tree of adds: a row's norm is the same at any B) and by
``torch.linalg.vector_norm`` (torch's reduction, whose order follows the
batch's shape), when the imported package has ``row_norms``; else as the
package computes it.

``--root`` names the checkout whose ``image_search_tpu_torch`` is imported,
so that two commits can be timed on one card in one run (run them in
turns: A, B, B, A). Rows and queries are made on the card from fixed seeds,
the same for every checkout. Prints one JSON line.

    python benchmarks_torch/fullscan_norms.py [--root DIR] [--rows N] [--iters N]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

DIM, SLAB, K, CHUNK = 768, 1 << 20, 1000, 262_144


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def _slabs(torch, dev, n: int):
    """int8 slabs of SLAB rows (a rank-64 mix plus noise, l2-normalised,
    quantised by the package's quantize_rows_int8) -> (slabs, scales)."""
    from image_search_tpu_torch.ops.score_stream import quantize_rows_int8

    gen = torch.Generator(device=dev).manual_seed(31)
    mix = torch.randn(64, DIM, generator=gen, device=dev)
    slabs, scales = [], []
    for lo in range(0, n, SLAB):
        rows = min(SLAB, n - lo)
        cap = -(-rows // 4096) * 4096
        slab = torch.zeros((cap, DIM), dtype=torch.int8, device=dev)
        scale = torch.zeros(cap, device=dev)
        for c0 in range(0, rows, CHUNK):
            c1 = min(rows, c0 + CHUNK)
            e = torch.randn(c1 - c0, 64, generator=gen, device=dev) @ mix
            e += 0.02 * torch.randn(c1 - c0, DIM, generator=gen, device=dev)
            slab[c0:c1], scale[c0:c1] = quantize_rows_int8(torch.nn.functional.normalize(e, dim=-1))
        slabs.append(slab)
        scales.append(scale)
    return tuple(slabs), tuple(scales), mix


def _event_ms(torch, fn, calls: int = 1) -> float:
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def _in_turns(torch, fns: dict, iters: int, calls: int = 1) -> dict:
    """Median ms of each function, called in turns (the order reversed on
    every other round), after two warm-up calls of each."""
    for fn in fns.values():
        fn()
        fn()
    times = {name: [] for name in fns}
    names = list(fns)
    for i in range(iters):
        for name in names if i % 2 == 0 else names[::-1]:
            times[name].append(_event_ms(torch, fns[name], calls))
    return {name: statistics.median(t) for name, t in times.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("fullscan_norms: needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import image_search_tpu_torch
    from image_search_tpu_torch.index.index import _search_local
    from image_search_tpu_torch.ops import score_stream

    here = os.path.dirname(os.path.dirname(os.path.abspath(image_search_tpu_torch.__file__)))
    if here != root:
        print(f"fullscan_norms: imported the package from {here}, not {root}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    slabs, scales, mix = _slabs(torch, dev, args.rows)
    gen = torch.Generator(device=dev).manual_seed(32)
    variants = {"package": None}
    if hasattr(score_stream, "row_norms"):
        tree = score_stream.row_norms
        variants = {"row_norms": tree, "vector_norm": lambda x: torch.linalg.vector_norm(x, dim=-1, keepdim=True)}

    def under(norm, fn):
        def call():
            if norm is None:
                return fn()
            score_stream.row_norms = norm
            try:
                return fn()
            finally:
                score_stream.row_norms = tree
        return call

    out = {"tag": args.tag, "card": _smi(), "torch": torch.__version__, "rows": args.rows, "k": K}
    for B in (1, 8):
        q = torch.randn(B, 64, generator=gen, device=dev) @ mix + 0.02 * torch.randn(B, DIM, generator=gen, device=dev)
        search = {v: under(norm, lambda: _search_local(slabs, args.rows, q, K, scales)) for v, norm in variants.items()}
        quant = {v: under(norm, lambda: score_stream.quantize_queries_int8(q)) for v, norm in variants.items()}
        answers = {v: fn() for v, fn in search.items()}
        first = next(iter(answers.values()))
        out[f"B{B}"] = {
            "search_ms": _in_turns(torch, search, args.iters),
            "quantize_ms": _in_turns(torch, quant, args.iters, calls=100),
            "ids_equal": all(torch.equal(a[1], first[1]) for a in answers.values()),
            "scores_max_abs_diff": max(float((a[0] - first[0]).abs().max()) for a in answers.values()),
        }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
