"""B1 (``ops.attention.fused_attention``) at head dims 64, 80 and 104 and at
S = 240 and 257 keys, on one CUDA card: what makes Hd 104 slow.

From Hd 80 to Hd 104 three things change at once: the MMA work (QK^T's
contraction 80 -> 112, PV's width 80 -> 104), the registers (ptxas spills
76 B a thread in Hd 104's 17-tile instantiation, none in Hd 80's), and the
shared memory a CTA takes for K and V (2 * ceil16(S) * row_ld(Hd) * 2 B:
at S = 257, 95,744 B at Hd 80 -> two CTAs an SM; 130,560 B at Hd 104 ->
one). S = 240 and S = 257 run the same instantiation (17 key tiles: the
same code, registers and spills), but at S = 240 Hd 104's 115,200 B let
two CTAs share an SM. So at each head dim t(257) / t(240) is the extra
work of 257 queries over 272 padded keys (x1.214), plus, at Hd 104 only,
the step from two CTAs an SM to one.

Each case: B = 160, H = 16, non-causal, the tower's layout (q scaled and
contiguous, k and v strided views of one qkv); checked against the plain
version (max abs err); timed by CUDA-graph replay (10 calls a graph),
medians of ``--iters`` replays, the cases in turns. Prints one JSON line.

    python benchmarks_torch/attn_head_dim.py [--iters N]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

B, H, HEAD_DIMS, KEYS = 160, 16, (64, 80, 104), (240, 257)
SMEM_PER_SM, SMEM_RESERVED_PER_CTA = 233_472, 1024  # H100: 228 KiB an SM, 1 KiB kept per CTA


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def _replayer(torch, fn, reps: int = 10):
    """``reps`` calls of ``fn`` captured in one CUDA graph -> a function that
    replays it once and returns the ms per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()

    def replay():
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    replay()
    return replay


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("attn_head_dim: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from image_search_tpu_torch import _build
    from image_search_tpu_torch.ops import attention as A

    dev = torch.device("cuda", 0)
    lib = _build.lib()
    gen = torch.Generator(device=dev).manual_seed(0)
    cases, replays = {}, {}
    for Hd in HEAD_DIMS:
        for S in KEYS:
            D = H * Hd
            qkv = torch.randn(B, S, 3 * D, generator=gen, device=dev).to(torch.bfloat16)
            q, k, v = qkv[..., :D] * Hd**-0.5, qkv[..., D : 2 * D], qkv[..., 2 * D :]
            got = A.fused_attention(q, k, v, H)
            split = lambda t: t.reshape(B, S, H, Hd)
            want = A.attention_reference(split(q), split(k), split(v)).reshape(B, S, D)
            smem = lib.isx_attention_smem_bytes(S, Hd)
            cases[(Hd, S)] = {
                "max_abs_err": (got.float() - want.float()).abs().max().item(),
                "smem_bytes": smem, "ctas_per_sm_by_smem": SMEM_PER_SM // (smem + SMEM_RESERVED_PER_CTA),
                "ms": [],
            }
            del got, want
            replays[(Hd, S)] = (_replayer(torch, lambda q=q, k=k, v=v: A.fused_attention(q, k, v, H)), (q, k, v))
    for _ in range(args.iters):
        for key, (replay, _) in replays.items():
            cases[key]["ms"].append(replay())
    out = {"device": _smi(), "B": B, "H": H, "work_257_over_240": 257 * 272 / (240 * 240), "cases": {}}
    for (Hd, S), c in cases.items():
        c["ms"] = statistics.median(c["ms"])
        out["cases"][f"Hd{Hd}_S{S}"] = c
    for Hd in HEAD_DIMS:
        out[f"Hd{Hd}_t257_over_t240"] = cases[(Hd, 257)]["ms"] / cases[(Hd, 240)]["ms"]
    for S in KEYS:
        out[f"S{S}_t104_over_t80"] = cases[(104, S)]["ms"] / cases[(80, S)]["ms"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
