#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``image_search_tpu_torch``) once on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on a failed check:

1. environment: the card's name and power limit, optional packages, the
   matmul-precision policy (no TF32);
2. build: compile ``image_search_tpu_torch/csrc/*.cu`` with nvcc;
3. each CUDA kernel against its plain PyTorch version at the main paths'
   shapes, on the card, with CUDA-event times for both, the least time the
   card could take for the same work, and the time of one PyTorch call that
   computes the same function where there is one: attention by its four
   routes (B1 and B1p at B=160 S=257 and B=32 S=77 causal, B6 split at
   B=160 S=257 and padded at Sp=264), int8 scores at B=1, 8 and the legacy
   duplicate scan's 1024 (B2, one launch per call; beside it torch._int_mm
   with the epilogue as torch ops), the block-pair mask at 262,144 x 262,144
   rows, the certified route's one call, and at 16,384 x 262,144 from row
   block 512 (B3), values at 65,536 x 1,048,576 (B4), both on the sketch
   slab padded to 80 columns as the scan builds it; attention over one
   packed qkv (B7, also bitwise against B1p) and the qkv projection fused
   into attention (B8, also bitwise against B7 on the qkv its projection
   phase writes, and that phase timed alone) at the B1 shapes, and the
   fused LayerNorm -> matmul (B9) at the vision tower's 41,120 rows, ln1 ->
   qkv and ln2 -> fc, beside F.layer_norm + F.linear and F.linear alone; B5
   at head dims 32 (the learned-retrieval example's vision B=48 S=65 H=4 and
   text S=16 causal), 80 and 104 (B=64 S=257 H=16) beside SDPA's backward,
   at the ragged edges S = 1, 33, 300, its row and column passes' p32/ds
   maps bitwise equal (``isx_attention_bwd_probe``), and at 104 every head's
   gradients bitwise unchanged with its neighbours' columns NaN. The
   attention kernels (B1, B1p, B5, B6, B7, B8) and B9, their plain versions
   and the PyTorch calls are timed by replaying a CUDA graph of 10 calls
   (device time: a text-size kernel is shorter than one launch from Python)
   and print their TFLOP/s and share of the bound; the others by CUDA events
   around each call;
4. ViT-L/14 at full width (seeded random bf16 weights): preprocess + vision
   tower at B=160 and the text tower at B=8 through the attention kernel,
   checked against the same weights' f32 forward on the CPU, and img/s;
   then the vision tower under each other attention route
   (``ISX_ATTN_PIPE=0``: B1p, ``ISX_ATTN_SPLIT=1``: B6, ``ISX_VIT_SPAD=264``:
   B6 on a sequence padded end to end) and under each fused-block
   composition of ``models/block_fused.py`` (B9 + B7 + B9, B9 + B1p, B1 +
   B9), each held against the same f32 forward, its launches counted
   exactly, and timed in turns with the default;
5. the HTTP server on 64 synthetic BMP photos with an int8 index: /scan,
   /search with and without Rocchio feedback (checked against the plain
   scoring of the same index), /health; again on fresh servers under
   ``ISX_ATTN_PIPE=0`` (B1p, never B1) and ``ISX_VIT_SPAD=264``;
6. GET /duplicates on the same server by its three routes: legacy on the
   photos plus byte-identical copies (groups against a brute-force f32 pair
   set), and the legacy scan run directly on 196,608 rows (just under the
   sketch cut) with byte-identical copies (every copy found; wall time and
   B2's share of it), certified on 262,144 concentrated 768-d rows through ?async=1 and
   ?job= (pairs against a brute-force f32 oracle), approximate on 1,048,576
   flat rows (every planted pair found, every emitted pair's score checked);
7. the certified two-stage search: a fresh server with ``--search-twostage``
   on the same 64 photos (/scan, cold /search plain and with feedback on
   the fused tokens -> tower -> Rocchio -> two-stage path, a warm repeat,
   POST /search_image plain and with ?ref=, GET /metrics), each answer
   against the full scan of the same index; then direct at 10,000,000 int8
   rows x 768 made on the card in ten slabs, f32 and bf16 sketches, B = 1
   and 4: ``twostage_topk_block`` against the full scan (scores bitwise,
   ids equal; a query that fails its certificate must have needed more
   blocks in a slab than its quota), timed in turns and split into its
   parts, B2 at the rescore's shape, ``search_twostage`` against ``search``,
   and a flat 2^20-row corpus whose certificates fail and whose answers are
   the full scan's;
8. the rest of the one-card server on 64 synthetic JPEG photos: (A) one
   server with an int8 index, ``--batch-window-ms 2``, ``--thumb-cache`` and
   ``--prune-on-scan``: the startup and post-scan warm-up before the first
   search, no kernel build in a request, a second index scanned from the
   thumbnail cache (64 hits, embeddings bitwise the first scan's), 32
   concurrent clients (half with feedback) whose every answer and text
   embedding equals the query alone, with p50/p99 and the mean batch beside
   the same load without the batcher, ``POST /remove`` of 8 photos (later searches against
   the plain scoring with those rows masked; B2's penalty variant counted),
   a rescan that keeps them out, restore + rescan, 4 files deleted and
   pruned; the first request of a fresh server process with and without the
   warm-up; (B) ``--index-quantize bfloat16`` served (/search plain and with
   feedback, /search_image, against the plain scoring) and direct at
   10,000,000 bf16 rows (B = 1 and 8 against the f32-upcast plain top-k,
   timed in turns with the int8 full scan; the bf16 GEMM with an f32 output
   against f32-upcast chunks on one slab; ``approx=True`` against the exact
   top-k); (C) ``--search-approx`` answers equal the exact search;
9. the OpenCLIP ladder, ``openclip-vit-H-14`` (vision head dim 80) and
   ``openclip-vit-bigG-14`` (104), seeded random weights made on the card:
   B1, B1p, B6 (split and padded) and B7 at each head dim and at 32 against
   their plain versions at B=160 S=257 H=16, timed beside SDPA, at the
   ragged edges S = 1, 33, 300, and with every head's v a distinct
   constant; B8 raising for those head dims; B1 at Hd 32 at the
   learned-retrieval towers' shapes and at bigG's text shape; B9 at the
   presets' widths (K 1280 and 1664); both towers at full width (img/s,
   text ms, launches per head dim on every route, depth 2 against f32 on
   the CPU); each preset's server (/scan, /search plain and with feedback,
   /search_image against the plain scoring, B1's launches per head dim,
   peak memory); H/14 served under ``ISX_ATTN_PIPE=0`` and
   ``ISX_VIT_SPAD=264``; B2 bitwise at 1M rows of D 1024 and 1280;
10. one ViT-L/14 train step (seeded random f32 master weights, bf16 compute,
   B=8) on the card against the same step in f32 on the CPU: loss and
   gradient cosines, and B1/B5 launches per step; the same card step under
   ``ISX_ATTN_PIPE=0`` and ``ISX_ATTN_SPLIT=1`` (loss within 1e-2 of the
   default route's, B5 on every backward);
11. the fine-tune CLI (``train.finetune.main``) on 64 synthetic BMP photos
   with captions, batch 64, 6 steps, with ``--eval-dir`` and
   ``--checkpoint-dir``, once without and once with ``--remat``: the loss
   falls, the output checkpoint reads back with new weights, B1/B5 launch
   counts; ms/step, pairs/s, peak memory;
12. a ``torch.profiler`` split of one batch-64 train step's device time;
13. fine-tuning the ladder: for H/14 and bigG a depth-2 train step on the
   card against f32 on the CPU (global gradient cosine), then 6 steps of
   16 pairs at full width and depth without and with remat (H/14 through
   the fine-tune CLI from a random 3.7 GiB checkpoint, bigG through
   ``make_train_step`` on its weights in memory): finite and falling
   losses, weights that moved, B5 launched at Hd 80 / 104 in the vision
   tower and 64 in the text tower, ms/step, pairs/s, peak memory;
14. the learned-retrieval gate (``examples_torch/learned_retrieval.py``):
   the reference's recipe on seeds 0, 1 and 2 must pass (bidirectional
   R@1 >= 0.6, served p@5 >= 0.8 through POST /search, every query hit), a
   run at lr 0 must fail, B1 and B5 launched at Hd 32 only; the gate's
   towers under the packed route (B1p) and the fully fused blocks (B7).

Each phase sets the attention route switches it needs and restores them
after. The second-to-last line is a JSON object describing every kernel of
the paths; the last line is ``{"ok": true, "device": {...}}``. Without a GPU the
script exits non-zero before any phase and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
ATTN_MAX_ABS = 2e-2  # bf16 kernel vs bf16 plain version (output values are O(1))
ATTN_MIN_COS = 0.9999  # per head vector, bf16 kernel vs f32 plain version
BWD_MAX_REL = 2e-2  # B5 vs its bf16 plain version, as a share of max|plain|
BWD_MIN_COS = 0.999  # B5 per (batch, head) vs its f32 plain version
LN_MM_MAX_REL = 2e-2  # B9 vs its bf16 plain version, as a share of max|plain|
LN_MM_MIN_COS = 0.9999  # B9 per output row vs its f32 plain version
GRAD_MIN_COS = 0.99  # global gradient cosine, bf16 train step on the card vs f32 on the CPU
TRAIN_BATCH, TRAIN_STEPS = 64, 6  # the fine-tune CLI runs (at the CLI's default lr, 1e-5)
TOWER_MIN_COS = 0.99  # bf16 on the card vs f32 on the CPU over 24 layers
VALUES_MAX_ABS = 2e-5  # B4 vs its plain version: f32 sums of 65 exact bf16 products in two orders
MASK_MARGIN = 1e-5  # B3's threshold keeps this far from every block maximum
BAND = 5e-4  # duplicate-scan guarantee band of tests/test_dupscan.py::check_band
SCORE_ATOL = 2e-4  # an emitted pair's score vs its own f32 dot
DIM = 768  # ViT-L/14 embeddings
CERT_ROWS = 262_144  # the certified route's corpus: over the engine's 200,000-row cut
APPROX_ROWS = 1_048_576  # the approximate route's corpus: over its 1,000,000-row cut
LEGACY_ROWS = 196_608  # the legacy route's largest corpus: just under the engine's 200,000-row sketch cut
LEGACY_COPIES = [(3, 150_000), (5, 100_000), (1024, 1025), (77_777, 196_607)]  # (row, its byte-identical copy)

# H100 SXM published peaks (NVIDIA data sheet, dense): the bounds below
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 2):
    """Per-call CUDA-event times (ms) of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def graph_ms(torch, fn, iters: int, reps: int = 10):
    """Per-call device times (ms) of ``fn``: ``reps`` calls captured in one
    CUDA graph, replayed ``iters`` times between CUDA events. A kernel of tens
    of microseconds is shorter than the host's cost of one launch from
    Python, which per-call events (cuda_ms) would measure instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as CUDA graphs ask
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    out = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    del graph
    torch.cuda.empty_cache()
    return out


def ab_ms(torch, plain, kernel, iters: int, timer=cuda_ms):
    """Median ms of both versions, timed in turns: plain, kernel, kernel, plain."""
    p = timer(torch, plain, iters)
    k = timer(torch, kernel, iters) + timer(torch, kernel, iters)
    p += timer(torch, plain, iters)
    return statistics.median(k), statistics.median(p)


def achieved(ops: float, ms: float, b_ms: float) -> str:
    """The kernel's rate and its share of the bound, for the print line."""
    return f"tflops={ops / (ms * 1e-3) / 1e12:.1f} bound_share={b_ms / ms:.1%}"


def bound(nbytes: float, ops: float, peak: float):
    """(least ms the card could take, what binds it): each input read once
    and each output written once at the HBM rate, against the operations at
    the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the towers' attention routes beyond the default (grouped, B1): the switches
# that select each (read by ops.attention.attention_route at every forward)
# and the entry point the vision tower then launches in every layer but the last
ROUTE_SWITCHES = {
    "packed": ({"ISX_ATTN_PIPE": "0"}, "fused_attention_packed"),
    "split": ({"ISX_ATTN_SPLIT": "1"}, "fused_attention_split"),
    "padded": ({"ISX_VIT_SPAD": "264"}, "fused_attention_split_padded"),
}
ROUTE_ENV = ("ISX_ATTN_PIPE", "ISX_ATTN_SPLIT", "ISX_VIT_SPAD", "ISX_VIT_SPAD_CPU", "ISX_ATTN_BF16SM")
# the fused-block compositions (models/block_fused.py): the kernels each runs
# per swapped block (every vision layer but the CLS-only last one)
FUSED_LAUNCHES = {
    "fully fused": {"ln_matmul": 2, "fused_attention_qkv_packed": 1},
    "ln1->qkv only": {"ln_matmul": 1, "fused_attention_packed": 1},
    "ln2->fc only": {"ln_matmul": 1, "fused_attention": 1},
}


@contextlib.contextmanager
def switches(env: dict):
    """Sets route switches for one phase and restores the environment after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def upper_block_pairs(r: int, n: int, row_block0: int) -> int:
    """Block pairs on or above the diagonal: what B3 and B4 compute."""
    ncb = n // 128
    return sum(max(ncb - (row_block0 + rb), 0) for rb in range(r // 128))


def threshold_between_maxima(torch, m, q: float) -> float:
    """The first midpoint at or above quantile q of the finite block maxima
    with no maximum within MASK_MARGIN of it."""
    v = torch.sort(m[torch.isfinite(m)].flatten()).values
    ok = torch.nonzero((v[1:] - v[:-1]) > 2 * MASK_MARGIN).flatten()
    i = int(ok[ok >= int(q * (len(v) - 1))][0])
    return float((v[i] + v[i + 1]) / 2)


def check_attention_bwd(torch, gen, dev, B, S, H, causal, Hd=64, timed=True):
    """B5 against its plain version on the tower's layout (q scaled by
    Hd^-0.5 and contiguous, k and v strided column blocks of one qkv
    projection), timed beside the backward of scaled_dot_product_attention
    on the same inputs unless ``timed`` is false. At S = 1 the softmax has no
    gradient: dq and dk must be exactly zero there."""
    from image_search_tpu_torch.ops.attention import attention_bwd_reference, fused_attention_bwd

    F = torch.nn.functional
    D = H * Hd
    qkv = torch.randn(B, S, 3 * D, generator=gen, device=dev).to(torch.bfloat16)
    q = qkv[..., :D] * Hd**-0.5
    k, v = qkv[..., D : 2 * D], qkv[..., 2 * D :]
    g = torch.randn(B, S, D, generator=gen, device=dev).to(torch.bfloat16)
    got = fused_attention_bwd(q, k, v, g, H, causal)
    torch.cuda.synchronize()
    want = attention_bwd_reference(q, k, v, g, H, causal)
    want32 = attention_bwd_reference(q.float(), k.float(), v.float(), g.float(), H, causal)
    heads = lambda t: t.float().reshape(B, S, H, Hd).permute(0, 2, 1, 3).reshape(B * H, S * Hd)
    shape = f"B={B} S={S} H={H} Hd={Hd} causal={causal}"
    err, rel, cos = {}, {}, {}
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, want32):
        err[name] = (a.float() - b.float()).abs().max().item()
        rel[name] = err[name] / max(b.float().abs().max().item(), 1e-30)
        a2, c2 = heads(a), heads(c)
        live = c2.norm(dim=-1) > 0
        check(bool(torch.isfinite(a2).all()) and torch.equal(a2[~live], torch.zeros_like(a2[~live])),
              f"attention bwd {shape} {name}: not finite, or nonzero where the softmax has no gradient")
        cos[name] = F.cosine_similarity(a2[live], c2[live], dim=-1).min().item() if live.any() else 1.0
        check(rel[name] <= BWD_MAX_REL, f"attention bwd {shape} {name}: max abs err {err[name]} "
              f"= {rel[name]} x max|plain| > {BWD_MAX_REL}")
        check(cos[name] >= BWD_MIN_COS, f"attention bwd {shape} {name}: min cosine {cos[name]} < {BWD_MIN_COS}")
    if not timed:
        return dict(max_abs_err=max(err.values()), max_rel_err=max(rel.values()), min_cos=min(cos.values()),
                    shape=shape)
    k_ms, p_ms = ab_ms(
        torch, lambda: attention_bwd_reference(q, k, v, g, H, causal),
        lambda: fused_attention_bwd(q, k, v, g, H, causal), iters=10, timer=graph_ms,
    )
    to_heads = lambda t: t.reshape(B, S, H, Hd).transpose(1, 2)  # [B, H, S, Hd] views
    qh, kh, vh = (to_heads(t).detach().requires_grad_() for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal, scale=1.0)
    fwd_ms = statistics.median(graph_ms(torch, sdpa, iters=10))
    both_ms = statistics.median(graph_ms(torch, lambda: torch.autograd.grad(sdpa(), (qh, kh, vh), to_heads(g)), iters=10))
    pairs = S * (S + 1) // 2 if causal else S * S  # the (query, key) pairs the data needs
    ops = 5 * 2 * B * H * pairs * Hd
    b_ms, b_by = bound(7 * B * S * D * 2, ops, BF16_FLOP_PER_S)
    print(
        f"B5 attention bwd {shape}: max_abs_err={err} "
        f"(x max|plain|: {rel}) min_cos_vs_f32={cos} kernel_ms={k_ms} {achieved(ops, k_ms, b_ms)} plain_ms={p_ms} "
        f"sdpa_bwd_ms={both_ms - fwd_ms} (fwd+bwd {both_ms} - fwd {fwd_ms}) bound_ms={b_ms} ({b_by})"
        + ("  (kernel SLOWER than plain)" if k_ms > p_ms else "")
    )
    return dict(
        max_abs_err=max(err.values()), max_rel_err=max(rel.values()), min_cos=min(cos.values()),
        ms=k_ms, plain_ms=p_ms, library_ms=both_ms - fwd_ms, bound_ms=b_ms, bound_by=b_by, shape=shape,
    )


def _bwd_probe(torch, q, k, v, g, H, causal):
    """B5 through isx_attention_bwd_probe: (dq, dk, dv, probe maps [2 passes,
    2 (p32, ds), B, H, S, S]); entries of masked pairs stay 0."""
    from image_search_tpu_torch import _build

    B, S, D = q.shape
    dq, dk, dv = (torch.empty(B, S, D, dtype=q.dtype, device=q.device) for _ in range(3))
    stats = torch.empty(3, B, H, S, device=q.device)
    probe = torch.zeros(2, 2, B, H, S, S, device=q.device)
    rc = _build.lib().isx_attention_bwd_probe(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        stats.data_ptr(), probe.data_ptr(), B, S, H, D // H, q.stride(1), k.stride(1), v.stride(1), g.stride(1),
        int(causal), 1.0, _build.stream_handle(q.device),
    )
    _build.check(rc, "attention backward probe")
    torch.cuda.synchronize()
    return dq, dk, dv, probe


def check_bwd_probe(torch, gen, dev, B, S, H, causal, Hd):
    """B5's column pass recomputes p32 and ds from the row pass's statistics
    with the same operands in the same roles and k-step order: the two
    passes' maps must be bitwise equal, and the probed run's gradients
    bitwise those of the entry point."""
    from image_search_tpu_torch.ops.attention import fused_attention_bwd

    D = H * Hd
    qkv = torch.randn(B, S, 3 * D, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = qkv[..., :D] * Hd**-0.5, qkv[..., D : 2 * D], qkv[..., 2 * D :]
    g = torch.randn(B, S, D, generator=gen, device=dev).to(torch.bfloat16)
    *grads, probe = _bwd_probe(torch, q, k, v, g, H, causal)
    shape = f"B={B} S={S} H={H} Hd={Hd} causal={causal}"
    check(torch.equal(probe[0], probe[1]), f"B5 probe {shape}: the two passes' p32/ds maps differ")
    check(all(torch.equal(a, b) for a, b in zip(grads, fused_attention_bwd(q, k, v, g, H, causal))),
          f"B5 probe {shape}: the probed run's gradients differ from the entry point's")
    return shape


def check_bwd_isolation(torch, gen, dev, Hd, B=4, S=257, H=16):
    """B5 keeps each head in its columns (at Hd 104 the padded k-step's
    columns 104-111 are the next head's): for every head h, a copy of q, k,
    v and g in which every OTHER head's columns are NaN must give head h's
    gradient columns bitwise as the all-finite run gives them (a read of a
    neighbour's column, even one multiplied by zero, would carry a NaN in),
    and the all-finite run's outputs, in memory poisoned with NaN before the
    launch, must be finite in every column (a column never written, or one
    written by its neighbour, shows)."""
    from image_search_tpu_torch.ops.attention import fused_attention_bwd

    D = H * Hd
    qkv = torch.randn(B, S, 3 * D, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = qkv[..., :D] * Hd**-0.5, qkv[..., D : 2 * D], qkv[..., 2 * D :]
    g = torch.randn(B, S, D, generator=gen, device=dev).to(torch.bfloat16)
    torch.empty(B * S * D * 8, device=dev, dtype=torch.bfloat16).fill_(float("nan"))  # poison the allocator
    full = fused_attention_bwd(q, k, v, g, H, False)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(t.float()).all()) for t in full), f"B5 Hd={Hd}: a gradient column left unwritten")
    for h in range(H):
        cols = slice(h * Hd, (h + 1) * Hd)
        alone = []
        for t in (q, k, v, g):
            x = torch.full((B, S, D), float("nan"), device=dev, dtype=torch.bfloat16)
            x[..., cols] = t[..., cols]
            alone.append(x)
        got = fused_attention_bwd(*alone, H, False)
        check(all(torch.equal(a[..., cols], b[..., cols]) for a, b in zip(got, full)),
              f"B5 Hd={Hd}: head {h}'s gradients change when its neighbours' columns are NaN")
    print(f"B5 per-head isolation B={B} S={S} H={H} Hd={Hd}: every head's dq, dk, dv bitwise unchanged with every "
          f"other head's columns NaN, and every column written")
    return True


# B5 at the head dims beyond ViT-L/14's: the learned-retrieval example's
# towers (Hd 32: vision B=48 S=65 H=4, text B=48 S=16 H=4 causal) and the
# ladder's vision towers (Hd 80, 104: B=64 S=257 H=16)
BWD_SHAPES = {32: ((48, 65, 4, False), (48, 16, 4, True)), 80: ((64, 257, 16, False),),
              104: ((64, 257, 16, False),)}


def bwd_head_dims(torch, gen, dev):
    """B5 at Hd 32, 80 and 104: timed at BWD_SHAPES against its plain version
    and SDPA's backward; at the ragged edges S = 1, 33 and 300 (causal and
    not); the probe's two passes bitwise equal; the per-head isolation case
    at 104."""
    res = {}
    for Hd, shapes in BWD_SHAPES.items():
        for B, S, H, causal in shapes:
            res[(Hd, S)] = check_attention_bwd(torch, gen, dev, B, S, H, causal, Hd=Hd)
        ragged = [check_attention_bwd(torch, gen, dev, 4, S, 16, causal, Hd=Hd, timed=False)
                  for S in (1, 33, 300) for causal in (False, True)]
        probes = [check_bwd_probe(torch, gen, dev, 2, S, 4, causal, Hd)
                  for S, causal in ((BWD_SHAPES[Hd][0][1], False), (77, True), (300, False), (17, True))]
        res[(Hd, "ragged")] = dict(max_abs_err=max(r["max_abs_err"] for r in ragged),
                                   max_rel_err=max(r["max_rel_err"] for r in ragged),
                                   min_cos=min(r["min_cos"] for r in ragged))
        print(f"B5 at Hd={Hd}, B=4 H=16, S in (1, 33, 300), causal and not: {res[(Hd, 'ragged')]}; probe passes "
              f"bitwise equal at {probes}")
        torch.cuda.empty_cache()
    res["isolation"] = check_bwd_isolation(torch, gen, dev, 104)
    return res


def check_attention_fwd(torch, gen, dev, core: str, B, S, H, causal=False, s_real=None, Hd=64, timed=True):
    """One attention forward kernel against its plain version on the tower's
    layout (q scaled by Hd^-0.5 and contiguous, k and v strided column blocks
    of one fused qkv projection), timed beside scaled_dot_product_attention
    on the same inputs unless ``timed`` is false. ``core``: "grouped" (B1),
    "packed" (B1p), "split" (B6 on unpadded operands) or "padded" (B6 on
    operands padded to S rows, keys >= s_real masked; SDPA gets the same
    boolean key mask)."""
    from image_search_tpu_torch.ops import attention as A

    F = torch.nn.functional
    D = H * Hd
    qkv = torch.randn(B, S, 3 * D, generator=gen, device=dev).to(torch.bfloat16)
    q = qkv[..., :D] * Hd**-0.5
    k, v = qkv[..., D : 2 * D], qkv[..., 2 * D :]
    split = lambda t: t.reshape(B, -1, H, Hd)
    if core == "grouped":
        kernel = lambda: A.fused_attention(q, k, v, H, causal)
        plain = lambda *t: A.attention_reference(*map(split, t), causal).reshape(B, S, D)
    elif core == "packed":
        kernel = lambda: A.fused_attention_packed(q, k, v, H, causal)
        plain = lambda *t: A.attention_packed_reference(*map(split, t), causal).reshape(B, S, D)
    elif core == "split":  # the reference's pad-and-slice, around the padded plain version
        s_main = (S // 128) * 128
        pad = lambda t: split(F.pad(t, (0, 0, 0, s_main + 8 - S)))
        kernel = lambda: A.fused_attention_split(q, k, v, H)
        plain = lambda *t: A.attention_split_reference(*map(pad, t), S)[:, :S].reshape(B, S, D)
    else:
        kernel = lambda: A.fused_attention_split_padded(q, k, v, H, s_real)
        plain = lambda *t: A.attention_split_reference(*map(split, t), s_real).reshape(B, S, D)
    got = kernel()
    torch.cuda.synchronize()
    want, want32 = plain(q, k, v), plain(q.float(), k.float(), v.float())
    err = (got.float() - want.float()).abs().max().item()
    cos = F.cosine_similarity(got.float().reshape(-1, Hd), want32.reshape(-1, Hd), dim=-1).min().item()
    shape = f"B={B} S={S} H={H} Hd={Hd} causal={causal}" + (f" s_real={s_real}" if s_real else "")
    check(err <= ATTN_MAX_ABS, f"attention {core} {shape}: max abs err {err} > {ATTN_MAX_ABS}")
    check(cos >= ATTN_MIN_COS, f"attention {core} {shape}: min cosine {cos} < {ATTN_MIN_COS}")
    if not timed:
        return dict(max_abs_err=err, min_cos=cos, shape=shape)
    k_ms, p_ms = ab_ms(torch, lambda: plain(q, k, v), kernel, iters=10, timer=graph_ms)
    heads = lambda t: split(t).transpose(1, 2)  # [B, H, S, Hd] views
    keys = s_real or S
    mask = None if s_real is None else (torch.arange(S, device=dev) < s_real)[None, None, None, :]
    lib_ms = statistics.median(graph_ms(
        torch, lambda: F.scaled_dot_product_attention(
            heads(q), heads(k), heads(v), attn_mask=mask, is_causal=causal, scale=1.0),
        iters=10,
    ))
    pairs = S * (S + 1) // 2 if causal else S * keys  # the (query, key) pairs the data needs
    ops = 4 * B * H * pairs * Hd
    b_ms, b_by = bound(2 * B * (S + keys) * D * 2, ops, BF16_FLOP_PER_S)
    name = {"grouped": "B1 attention", "packed": "B1p attention packed"}.get(core, f"B6 attention {core}")
    print(
        f"{name} {shape}: max_abs_err={err} min_cos_vs_f32={cos} kernel_ms={k_ms} {achieved(ops, k_ms, b_ms)} "
        f"plain_ms={p_ms} "
        f"sdpa_ms={lib_ms} bound_ms={b_ms} ({b_by})" + ("  (kernel SLOWER than plain)" if k_ms > p_ms else "")
    )
    return dict(
        max_abs_err=err, min_cos=cos, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
        bound_ms=b_ms, bound_by=b_by, shape=shape,
    )


def _attn_bound(B, S, H, causal, extra_ops=0.0, extra_bytes=0.0, Hd=64):
    """Bound of attention over [B, S, H*Hd] q, k and v read once and the
    output written once, plus extra operations and bytes."""
    D = H * Hd
    pairs = S * (S + 1) // 2 if causal else S * S  # the (query, key) pairs the data needs
    return bound(4 * B * S * D * 2 + extra_bytes, 4 * B * H * pairs * Hd + extra_ops, BF16_FLOP_PER_S)


def check_qkv_packed(torch, gen, dev, B, S, H, causal, Hd=64, timed=True):
    """B7 against its plain version on one packed qkv at sm_scale 0.125, and
    bitwise against B1p on (q * 0.125, k, v): a power of two scales q exactly
    in bf16. Timed beside SDPA on the three views unless ``timed`` is
    false."""
    from image_search_tpu_torch.ops import attention as A

    F = torch.nn.functional
    D, scale = H * Hd, 0.125
    qkv = torch.randn(B, S, 3 * D, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = qkv[..., :D], qkv[..., D : 2 * D], qkv[..., 2 * D :]
    kernel = lambda: A.fused_attention_qkv_packed(qkv, H, causal, scale)
    plain = lambda t: A.attention_qkv_packed_reference(t, H, causal, scale)
    got = kernel()
    torch.cuda.synchronize()
    shape = f"B={B} S={S} H={H} Hd={Hd} causal={causal} sm_scale={scale}"
    check(torch.equal(got, A.fused_attention_packed(q * scale, k, v, H, causal)),
          f"B7 {shape}: not bitwise equal to B1p on (q * {scale}, k, v)")
    want, want32 = plain(qkv), plain(qkv.float())
    err = (got.float() - want.float()).abs().max().item()
    cos = F.cosine_similarity(got.float().reshape(-1, Hd), want32.reshape(-1, Hd), dim=-1).min().item()
    check(err <= ATTN_MAX_ABS, f"B7 {shape}: max abs err {err} > {ATTN_MAX_ABS}")
    check(cos >= ATTN_MIN_COS, f"B7 {shape}: min cosine {cos} < {ATTN_MIN_COS}")
    if not timed:
        return dict(max_abs_err=err, min_cos=cos, shape=shape)
    k_ms, p_ms = ab_ms(torch, lambda: plain(qkv), kernel, iters=10, timer=graph_ms)
    heads = lambda t: t.reshape(B, S, H, Hd).transpose(1, 2)
    lib_ms = statistics.median(graph_ms(
        torch, lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v), is_causal=causal, scale=scale),
        iters=10,
    ))
    b_ms, b_by = _attn_bound(B, S, H, causal, Hd=Hd)
    pairs = S * (S + 1) // 2 if causal else S * S
    print(f"B7 attention qkv-packed {shape}: bitwise_equal_B1p=True max_abs_err={err} min_cos_vs_f32={cos} "
          f"kernel_ms={k_ms} {achieved(4 * B * H * pairs * Hd, k_ms, b_ms)} plain_ms={p_ms} sdpa_ms={lib_ms} "
          f"bound_ms={b_ms} ({b_by})"
          + ("  (kernel SLOWER than plain)" if k_ms > p_ms else ""))
    return dict(max_abs_err=err, min_cos=cos, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, shape=shape)


def projection_within_roundoff(torch, qkv, x, w, b) -> bool:
    """qkv (B8's projection phase) against bf16(x w^T) + b from torch's f32
    product: the two f32 sums of D products differ in order, each within
    D * 2^-24 * sum |x w| of the exact sum, and each result then takes two
    bf16 roundings (the product, then the bias add), 2^-8 of a value each."""
    acc = torch.matmul(x.float(), w.float().t())
    tol = 2.0**-7 * (2 * acc.abs() + b.float().abs())
    tol += 2 * x.shape[-1] * 2.0**-24 * torch.matmul(x.float().abs(), w.float().abs().t())
    err = (qkv.float() - (acc.to(torch.bfloat16) + b).float()).abs()
    return bool((err <= tol).all())


def check_qkv_attention(torch, gen, dev, B, S, H, causal):
    """B8 against its plain version (the projection accumulated in f32, then
    B7's plain attention), and bitwise against B7 on the qkv that its
    projection phase writes (``qkv_attention_probe``); timed by CUDA-graph
    replay beside the probe (phase 1 alone) and F.linear + SDPA on the same
    inputs."""
    from image_search_tpu_torch.ops import attention as A

    F = torch.nn.functional
    D, Hd, scale = H * 64, 64, 0.125
    x = torch.randn(B, S, D, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn(3 * D, D, generator=gen, device=dev) * D**-0.5).to(torch.bfloat16)
    b = (0.1 * torch.randn(3 * D, generator=gen, device=dev)).to(torch.bfloat16)
    kernel = lambda: A.fused_qkv_attention(x, w, b, H, causal, scale)
    probe = lambda: A.qkv_attention_probe(x, w, b, H)
    got = kernel()
    torch.cuda.synchronize()
    shape = f"B={B} S={S} D={D} H={H} Hd=64 causal={causal} sm_scale={scale}"
    qkv = probe()
    check(torch.equal(got, A.fused_attention_qkv_packed(qkv, H, causal, scale)),
          f"B8 {shape}: not bitwise equal to B7 on its own projection")
    check(projection_within_roundoff(torch, qkv, x, w, b), f"B8 {shape}: projection off bf16(x w^T) + b")
    del qkv
    want = A.qkv_attention_reference(x, w, b, H, causal, scale)
    want32 = A.qkv_attention_reference(x.float(), w.float(), b.float(), H, causal, scale)
    err = (got.float() - want.float()).abs().max().item()
    cos = F.cosine_similarity(got.float().reshape(-1, Hd), want32.reshape(-1, Hd), dim=-1).min().item()
    del want32
    check(err <= ATTN_MAX_ABS, f"B8 {shape}: max abs err {err} > {ATTN_MAX_ABS}")
    check(cos >= ATTN_MIN_COS, f"B8 {shape}: min cosine {cos} < {ATTN_MIN_COS}")
    k_ms, p_ms = ab_ms(torch, lambda: A.qkv_attention_reference(x, w, b, H, causal, scale), kernel, iters=10,
                       timer=graph_ms)
    proj_ms = statistics.median(graph_ms(torch, probe, iters=10))

    def library():
        qkv = F.linear(x, w, b).reshape(B, S, 3, H, Hd).permute(2, 0, 3, 1, 4)  # [3, B, H, S, Hd] views
        return F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], is_causal=causal, scale=scale)

    lib_ms = statistics.median(graph_ms(torch, library, iters=10))
    b_ms, b_by = _attn_bound(B, S, H, causal, extra_ops=2 * B * S * D * 3 * D,
                             extra_bytes=(3 * D * D + 3 * D) * 2 - 2 * B * S * D * 2)
    ops = 2 * B * S * D * 3 * D + 4 * B * H * (S * (S + 1) // 2 if causal else S * S) * 64
    print(f"B8 qkv-projection attention {shape}: bitwise_equal_B7_on_probe=True max_abs_err={err} "
          f"min_cos_vs_f32={cos} kernel_ms={k_ms} {achieved(ops, k_ms, b_ms)} phase1_ms={proj_ms} "
          f"plain_ms={p_ms} linear+sdpa_ms={lib_ms} bound_ms={b_ms} ({b_by})"
          + ("  (kernel SLOWER than plain)" if k_ms > p_ms else ""))
    return dict(max_abs_err=err, min_cos=cos, ms=k_ms, phase1_ms=proj_ms, plain_ms=p_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, shape=shape)


def check_ln_matmul(torch, gen, dev, M, K, N):
    """B9 against its plain version at the vision tower's rows (B=160 x 257),
    timed (CUDA-graph replay) beside F.layer_norm + F.linear on the same
    inputs, and beside F.linear alone: cuBLAS's GEMM, so that the GEMM's gap
    and the LayerNorm's share show apart."""
    from image_search_tpu_torch.ops.ln_matmul import ln_matmul, ln_matmul_reference

    F = torch.nn.functional
    x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
    ls = 1 + 0.1 * torch.randn(K, generator=gen, device=dev)
    lb = 0.1 * torch.randn(K, generator=gen, device=dev)
    w = (torch.randn(N, K, generator=gen, device=dev) * K**-0.5).to(torch.bfloat16)
    b = (0.1 * torch.randn(N, generator=gen, device=dev)).to(torch.bfloat16)
    kernel = lambda: ln_matmul(x, ls, lb, w, b)
    got = kernel()
    torch.cuda.synchronize()
    want = ln_matmul_reference(x, ls, lb, w, b)
    want32 = ln_matmul_reference(x.float(), ls, lb, w.float(), b.float())
    shape = f"M={M} K={K} N={N}"
    err = (got.float() - want.float()).abs().max().item()
    rel = err / want.float().abs().max().item()
    cos = F.cosine_similarity(got.float(), want32, dim=-1).min().item()
    del want32
    check(rel <= LN_MM_MAX_REL, f"B9 {shape}: max abs err {err} = {rel} x max|plain| > {LN_MM_MAX_REL}")
    check(cos >= LN_MM_MIN_COS, f"B9 {shape}: min row cosine {cos} < {LN_MM_MIN_COS}")
    k_ms, p_ms = ab_ms(torch, lambda: ln_matmul_reference(x, ls, lb, w, b), kernel, iters=5, timer=graph_ms)
    ls16, lb16 = ls.to(torch.bfloat16), lb.to(torch.bfloat16)
    lib_ms = statistics.median(graph_ms(torch, lambda: F.linear(F.layer_norm(x, (K,), ls16, lb16, 1e-5), w, b),
                                        iters=5))
    lin_ms = statistics.median(graph_ms(torch, lambda: F.linear(x, w, b), iters=5))
    b_ms, b_by = bound((M * K + N * K + M * N + N) * 2 + 8 * K, 2 * M * K * N, BF16_FLOP_PER_S)
    print(f"B9 ln_matmul {shape}: max_abs_err={err} (x max|plain|: {rel}) min_row_cos_vs_f32={cos} "
          f"kernel_ms={k_ms} ({2 * M * K * N / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s) plain_ms={p_ms} "
          f"layer_norm+linear_ms={lib_ms} linear_ms={lin_ms} bound_ms={b_ms} ({b_by})"
          + ("  (kernel SLOWER than plain)" if k_ms > p_ms else ""))
    return dict(max_abs_err=err, max_rel_err=rel, min_cos=cos, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                linear_ms=lin_ms, bound_ms=b_ms, bound_by=b_by, shape=shape)


def phase_kernels(torch, gen, dev):
    from image_search_tpu_torch.ops.attention import fused_qkv_attention
    from image_search_tpu_torch.ops.blockmax import (
        blockpair_mask, blockpair_mask_reference, blockpair_values, blockpair_values_reference, kernel_depth,
    )
    from image_search_tpu_torch.ops.score_stream import (
        NEG_INF, quantize_rows_int8, scores_int8_reference, score_plan, stream_scores_int8,
    )

    F = torch.nn.functional
    res = {}
    for core in ("grouped", "packed"):
        for B, S, H, causal in ((160, 257, 16, False), (32, 77, 12, True)):
            res[(core, S)] = check_attention_fwd(torch, gen, dev, core, B, S, H, causal)
    res[("split", 257)] = check_attention_fwd(torch, gen, dev, "split", 160, 257, 16)
    res[("padded", 264)] = check_attention_fwd(torch, gen, dev, "padded", 160, 264, 16, s_real=257)
    torch.cuda.empty_cache()

    for B, S, H, causal in ((TRAIN_BATCH, 257, 16, False), (TRAIN_BATCH, 77, 12, True)):
        res[("attention_bwd", S)] = check_attention_bwd(torch, gen, dev, B, S, H, causal)
    res["attention_bwd_hd"] = bwd_head_dims(torch, gen, dev)

    n0 = fused_qkv_attention.launches
    for B, S, H, causal in ((160, 257, 16, False), (32, 77, 12, True)):
        res[("qkv_packed", S)] = check_qkv_packed(torch, gen, dev, B, S, H, causal)
        res[("qkv_attention", S)] = check_qkv_attention(torch, gen, dev, B, S, H, causal)
    res["qkv_attention_launches"] = fused_qkv_attention.launches - n0  # no path runs B8: its checks' launches
    torch.cuda.empty_cache()
    for N in (3072, 4096):  # ln1 -> qkv and ln2 -> fc
        res[("ln_matmul", N)] = check_ln_matmul(torch, gen, dev, 160 * 257, 1024, N)
        torch.cuda.empty_cache()

    D = DIM
    for N, batches in ((1_000_000, (1, 8)), (65_536, (1024,))):
        rows, scales = quantize_rows_int8(F.normalize(torch.randn(N, D, generator=gen, device=dev), dim=-1))
        pens = torch.zeros(N, device=dev)
        pens[torch.randint(0, N, (1000,), generator=gen, device=dev)] = NEG_INF
        limit = N - 12_345
        for B in batches:
            qi, qs = quantize_rows_int8(F.normalize(torch.randn(B, D, generator=gen, device=dev), dim=-1))
            for pen in (None, pens):
                n0 = stream_scores_int8.launches
                got = stream_scores_int8(rows, qi, qs, scales, limit, pen)
                n_launch = stream_scores_int8.launches - n0
                want = scores_int8_reference(rows, qi, qs, scales, limit, pen)
                check(n_launch == 1, f"int8 scores B={B}: {n_launch} launches (one per call)")
                check(torch.equal(got, want), f"int8 scores B={B} pens={pen is not None}: not bitwise equal")
                err = (got - want).abs().max().item()
                k_ms, p_ms = ab_ms(
                    torch,
                    lambda: scores_int8_reference(rows, qi, qs, scales, limit, pen),
                    lambda: stream_scores_int8(rows, qi, qs, scales, limit, pen),
                    iters=10,
                )
                nbytes = N * D + B * D + 4 * B + 4 * N + 4 * B * N + (4 * N if pen is not None else 0)
                b_ms, b_by = bound(nbytes, 2 * B * N * D, INT8_OP_PER_S)
                # torch._int_mm (needs more than 16 queries) does the integer
                # product alone; with the epilogue as torch ops it computes B2's
                # function, and that is the library column
                lib_ms = mm_ms = None
                if B > 16:
                    gpos = torch.arange(N, device=dev)[None, :]

                    def int_mm_epilogue():
                        s = torch._int_mm(qi, rows.t()).float() * qs[:, None]
                        s = s * scales[None, :]
                        if pen is not None:
                            s = s + pen[None, :]
                        return torch.where(gpos < limit, s, NEG_INF)

                    check(torch.equal(int_mm_epilogue(), want), f"int8 scores B={B}: _int_mm + epilogue differs")
                    mm_ms = statistics.median(cuda_ms(torch, lambda: torch._int_mm(qi, rows.t()), iters=10))
                    lib_ms = statistics.median(cuda_ms(torch, int_mm_epilogue, iters=10))
                plan = score_plan(B, N, D)
                res[("score", B, pen is not None)] = dict(
                    max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, int_mm_ms=mm_ms, bound_ms=b_ms,
                    bound_by=b_by, shape=f"N={N} D={D} B={B} pens={pen is not None} BM={plan['bm']}",
                )
                gbs = N * D / (k_ms * 1e-3) / 1e9
                print(
                    f"B2 int8 scores N={N} D={D} B={B} pens={pen is not None} limit={limit}: "
                    f"bitwise_equal=True launches={n_launch} BM={plan['bm']} grid={plan['grid']} "
                    f"kernel_ms={k_ms} ({gbs:.1f} GB/s of rows, bound_share={b_ms / k_ms:.1%}) "
                    f"plain_ms={p_ms} int_mm_ms={mm_ms} int_mm+epilogue_ms={lib_ms} bound_ms={b_ms} ({b_by})"
                    + ("  (kernel SLOWER than plain)" if k_ms > p_ms else "")
                )
        del rows, scales, pens, got, want
    torch.cuda.empty_cache()

    # B3 and B4 on augmented sketches (64 dims + the residual norm): B3 at the
    # certified route's one call (all 262,144 rows against themselves), and
    # again on a row slab with a nonzero row_block0; B4 at the approximate
    # route's first call. The kernels take the slab as the scan builds it,
    # padded with zero columns to 80 (dupscan._prep_sketch); the plain
    # versions the 65-wide operand. The bound counts d_a = 65.
    da = 65
    dp = kernel_depth(da)
    for name, R, N, r0 in (
        ("mask", CERT_ROWS, CERT_ROWS, 0),
        ("mask", 16_384, CERT_ROWS, 65_536),
        ("values", 65_536, APPROX_ROWS, 0),
    ):
        sk = (torch.randn(N, da, generator=gen, device=dev) / da**0.5).to(torch.bfloat16)
        s_rows, rb0 = sk[r0 : r0 + R], r0 // 128
        skp = F.pad(sk, (0, dp - da))
        p_rows = skp[r0 : r0 + R]
        pairs = upper_block_pairs(R, N, rb0)
        ops = pairs * 2 * 128 * 128 * da
        if name == "mask":
            thr = threshold_between_maxima(torch, blockpair_values_reference(s_rows, sk, rb0), 0.5)
            n0 = blockpair_mask.launches
            got = blockpair_mask(p_rows, skp, thr, rb0)
            n_launch = blockpair_mask.launches - n0
            want = blockpair_mask_reference(s_rows, sk, thr, rb0)
            check(torch.equal(got, want), f"blockpair_mask R={R} N={N}: words not bitwise equal")
            err = 0.0
            bits = int(sum(bin(w & 0xFFFFFFFF).count("1") for w in want.flatten().tolist()))
            detail = f"thr={thr} bits_set={bits} bitwise_equal=True"
            kernel = lambda: blockpair_mask(p_rows, skp, thr, rb0)
            plain = lambda: blockpair_mask_reference(s_rows, sk, thr, rb0)
            out_bytes = 4 * (R // 128) * (N // 4096)
        else:
            n0 = blockpair_values.launches
            got = blockpair_values(p_rows, skp, rb0)
            n_launch = blockpair_values.launches - n0
            want = blockpair_values_reference(s_rows, sk, rb0)
            fin = torch.isfinite(want)
            check(torch.equal(fin, torch.isfinite(got)), f"blockpair_values: -inf pattern differs")
            err = (got[fin] - want[fin]).abs().max().item()
            check(err <= VALUES_MAX_ABS, f"blockpair_values R={R} N={N}: max abs err {err} > {VALUES_MAX_ABS}")
            detail = f"max_abs_err={err}"
            kernel = lambda: blockpair_values(p_rows, skp, rb0)
            plain = lambda: blockpair_values_reference(s_rows, sk, rb0)
            out_bytes = 4 * (R // 128) * (N // 128)
        check(n_launch == 1, f"blockpair_{name}: {n_launch} launches")
        k_ms, p_ms = ab_ms(torch, plain, kernel, iters=3)
        b_ms, b_by = bound(2 * da * (R + N) + out_bytes, ops, BF16_FLOP_PER_S)
        res[(name, R)] = dict(
            max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
            shape=f"R={R} N={N} d_a={da} row_block0={rb0}",
        )
        print(
            f"B{3 if name == 'mask' else 4} blockpair_{name} R={R} N={N} d_a={da} row_block0={rb0} "
            f"block_pairs={pairs}: {detail} kernel_ms={k_ms} ({ops / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s at d_a={da}, "
            f"{ops * dp / da / (k_ms * 1e-3) / 1e12:.1f} at the padded {dp}) "
            f"plain_ms={p_ms} bound_ms={b_ms} ({b_by})" + ("  (kernel SLOWER than plain)" if k_ms > p_ms else "")
        )
        del sk, s_rows, skp, p_rows, got, want
        torch.cuda.empty_cache()
    return res


def phase_towers(torch, gen, dev, smi):
    import numpy as np

    from image_search_tpu_torch.config import get_config
    from image_search_tpu_torch.models.block_fused import COMPOSITIONS, blocks_as
    from image_search_tpu_torch.models.clip import encode_image, encode_text
    from image_search_tpu_torch.models.convert import build_model, init_params
    from image_search_tpu_torch.ops.preprocess import fused_preprocess, pack_batch
    from image_search_tpu_torch.tokenizer import HashTokenizer

    F = torch.nn.functional
    cfg = get_config("clip-vit-large-patch14")
    state = init_params(cfg, gen, dev, torch.bfloat16)
    model = build_model(cfg, state, dev, torch.bfloat16)
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(160)]
    u8, A_h, A_w = (torch.from_numpy(a) for a in pack_batch(images, size=cfg.vision.image_size))
    u8_d, A_h_d, A_w_d = (t.to(dev) for t in (u8, A_h, A_w))
    tok = HashTokenizer(cfg.text.vocab_size, cfg.text.context_length, eos_id=cfg.text.eos_token_id)
    ids = torch.from_numpy(tok([f"a photo of thing number {i}" for i in range(8)]).astype(np.int64))
    L_v, L_t = cfg.vision.num_layers - 1, cfg.text.num_layers - 1

    def vision():
        return encode_image(model, fused_preprocess(u8_d, A_h_d, A_w_d, out_dtype=torch.bfloat16))

    def launched(fn):
        """fn()'s result and the attention forward launches it made, by entry point."""
        _reset_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v for k, v in _read_counts().items() if v and k != "fused_attention_bwd"}

    with torch.inference_mode():
        img, n_img = launched(vision)
        txt, n_txt = launched(lambda: encode_text(model, ids.to(dev)))
        check(n_img == {"fused_attention": L_v}, f"vision forward launched {n_img}, want B1 {L_v} times")
        check(n_txt == {"fused_attention": L_t}, f"text forward launched {n_txt}, want B1 {L_t} times")
        check(img.shape == (160, cfg.projection_dim) and bool(torch.isfinite(img).all()), "bad image embeddings")
        check(txt.shape == (8, cfg.projection_dim) and bool(torch.isfinite(txt).all()), "bad text embeddings")

        cpu = build_model(cfg, {k: t.float().cpu() for k, t in state.items()}, "cpu", torch.float32)
        img32 = encode_image(cpu, fused_preprocess(u8[:4], A_h[:4], A_w[:4]))
        txt32 = encode_text(cpu, ids[:4])
        cos_i = F.cosine_similarity(img[:4].float().cpu(), img32, dim=-1).min().item()
        cos_t = F.cosine_similarity(txt[:4].float().cpu(), txt32, dim=-1).min().item()
        print(f"towers: vision launches/forward={n_img} text launches/forward={n_txt}")
        print(f"towers: bf16 card vs f32 CPU min cosine: image={cos_i} text={cos_t} (bound {TOWER_MIN_COS})")
        check(cos_i >= TOWER_MIN_COS, f"image embeddings: cosine {cos_i} < {TOWER_MIN_COS}")
        check(cos_t >= TOWER_MIN_COS, f"text embeddings: cosine {cos_t} < {TOWER_MIN_COS}")
        del cpu

        ms = statistics.median(cuda_ms(torch, vision, iters=5))
        txt_ms = statistics.median(cuda_ms(torch, lambda: encode_text(model, ids.to(dev)), iters=5))
        ips = 160 / (ms * 1e-3)
        print(
            f"towers: ViT-L/14 bf16 preprocess+vision B=160: {ms} ms/batch = {ips} img/s; "
            f"text tower B=8: {txt_ms} ms  [{smi}]"
        )

        # the vision tower under each other route: launches, cosine against
        # the same f32 CPU tower, and img/s against the default route, timed
        # in turns (default, route, route, default)
        routes = {}
        for route, (env, entry) in ROUTE_SWITCHES.items():
            with switches(env):
                got, n = launched(vision)
                check(n == {entry: L_v}, f"vision on the {route} route launched {n}, want {entry} {L_v} times")
                cos = F.cosine_similarity(got[:4].float().cpu(), img32, dim=-1).min().item()
                check(cos >= TOWER_MIN_COS, f"image embeddings, {route} route: cosine {cos} < {TOWER_MIN_COS}")
                if route == "packed":
                    _, n_t = launched(lambda: encode_text(model, ids.to(dev)))
                    check(n_t == {entry: L_t}, f"text on the packed route launched {n_t}, want {entry} {L_t} times")
            base = cuda_ms(torch, vision, iters=5)
            with switches(env):
                r_ms = cuda_ms(torch, vision, iters=5) + cuda_ms(torch, vision, iters=5)
            base += cuda_ms(torch, vision, iters=5)
            r_ms, base = statistics.median(r_ms), statistics.median(base)
            routes[route] = {"img_per_s": 160 / (r_ms * 1e-3), "default_img_per_s": 160 / (base * 1e-3),
                             "ms": r_ms, "default_ms": base, "cos_image": cos}
            print(
                f"towers: {route} route {env}: vision launches {n}, cosine vs f32 CPU {cos}; "
                f"B=160 {r_ms} ms = {160 / (r_ms * 1e-3)} img/s vs default route {base} ms = "
                f"{160 / (base * 1e-3)} img/s ({(base / r_ms - 1) * 100:+.2f}% img/s)  [{smi}]"
            )

        # the vision tower under each fused-block composition (blocks 0..L-2
        # swapped, Block.forward restored on exit even when a check fails):
        # exact launches, cosine against the same f32 CPU tower, and img/s
        # against the default block, timed in turns (default, composition,
        # composition, default)
        fused = {}
        for name, fn in COMPOSITIONS.items():
            want = {k: v * L_v for k, v in FUSED_LAUNCHES[name].items()}
            with blocks_as(fn):
                got, n = launched(vision)
                check(n == want, f"vision under the {name} blocks launched {n}, want {want}")
                cos = F.cosine_similarity(got[:4].float().cpu(), img32, dim=-1).min().item()
                check(cos >= TOWER_MIN_COS, f"image embeddings, {name} blocks: cosine {cos} < {TOWER_MIN_COS}")
            base = cuda_ms(torch, vision, iters=5)
            with blocks_as(fn):
                c_ms = cuda_ms(torch, vision, iters=5) + cuda_ms(torch, vision, iters=5)
            base += cuda_ms(torch, vision, iters=5)
            c_ms, base = statistics.median(c_ms), statistics.median(base)
            fused[name] = {"img_per_s": 160 / (c_ms * 1e-3), "default_img_per_s": 160 / (base * 1e-3),
                           "ms": c_ms, "default_ms": base, "cos_image": cos, "launches": n}
            print(
                f"towers: {name} blocks: vision launches {n}, cosine vs f32 CPU {cos}; B=160 {c_ms} ms = "
                f"{160 / (c_ms * 1e-3)} img/s vs default blocks {base} ms = {160 / (base * 1e-3)} img/s "
                f"({(base / c_ms - 1) * 100:+.2f}% img/s)  [{smi}]"
            )
    del model, state
    torch.cuda.empty_cache()
    return {"img_per_s": ips, "vision_ms": ms, "text_ms": txt_ms, "cos_image": cos_i, "cos_text": cos_t,
            "routes": routes, "fused": fused}


def _http(method: str, url: str, body=None, raw=None):
    data = raw if raw is not None else None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method)
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        status, raw = r.status, r.read()
    return status, json.loads(raw), (time.perf_counter() - t0) * 1e3


def _plain_scores_top(torch, idx, q, k: int):
    """The plain scoring of one query vector [1, D] over the index's rows
    (B2's plain version with the tombstone penalties for int8 rows, both
    operands upcast to f32 for bf16 rows), tombstoned rows dropped ->
    (scores, paths), torch.topk's order."""
    from image_search_tpu_torch.index.index import NEG_INF, _l2
    from image_search_tpu_torch.ops.score_stream import quantize_queries_int8, scores_int8_reference

    with idx._lock:
        slabs, _, scales, pens = idx._snapshot()
        size = idx._size
    parts, start = [], 0
    if scales is not None:
        qi, qs = quantize_queries_int8(q)
    for i, slab in enumerate(slabs):
        pen = None if pens is None else pens[i]
        if scales is not None:
            parts.append(scores_int8_reference(slab, qi, qs, scales[i], size - start, pen))
        else:
            s = _l2(q).to(slab.dtype).float() @ slab.float().T
            s = s if pen is None else s + pen[None, :]
            gpos = torch.arange(slab.shape[0], device=s.device) + start
            parts.append(torch.where(gpos[None, :] < size, s, torch.full_like(s, NEG_INF)))
        start += slab.shape[0]
    v, i = torch.topk(torch.cat(parts, dim=1), min(k, size), dim=-1)
    keep = v[0] > NEG_INF / 2
    return v[0][keep].cpu().tolist(), [idx.paths[j] for j in i[0][keep].cpu().tolist()]


def _plain_top(torch, engine, query: str, refs, k: int):
    """The plain scoring of the engine's own index for one request."""
    from image_search_tpu_torch.index.index import _rocchio_queries

    idx = engine.index
    with idx._lock:
        slabs, norms, scales, _ = idx._snapshot()
        sel = [idx._row[engine._resolve_selection(m)] for m in refs] or [-1]
    text = engine._cache_get(query).float().reshape(1, -1)
    q = _rocchio_queries(slabs, scales, norms, text, torch.tensor([sel], device=text.device))
    return _plain_scores_top(torch, idx, q, k)


def _photos(media: str, fmt: str = "bmp", n: int = 64, lo: int = 64, hi: int = 640, seed: int = 1):
    """n synthetic photos (a flat colour and a square, sides in [lo, hi)),
    one in four under sub/, as BMP or JPEG (quality 92)."""
    import numpy as np

    from image_search_tpu_torch.ingest.decode import write_bmp24

    os.makedirs(os.path.join(media, "sub"), exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = (int(x) for x in rng.integers(lo, hi, 2))
        img = np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
        y, x = h // 4, w // 4
        img[y : 3 * y, x : 3 * x] = rng.integers(0, 256, 3)  # a square
        path = os.path.join(media, "sub" if i % 4 == 0 else "", f"photo_{i:02d}.{'jpg' if fmt == 'jpeg' else 'bmp'}")
        if fmt == "jpeg":
            from PIL import Image

            img[:, :, 2] = np.linspace(0, 255, w, dtype=np.uint8)[None, :]  # a ramp: the DCT has work
            Image.fromarray(img).save(path, quality=92)
        else:
            write_bmp24(path, img)


@contextlib.contextmanager
def _server_on(dev, model: str, media: str, index_dir: str, flags=()):
    """The HTTP server over the photos in ``media`` and the index in
    ``index_dir`` (int8 unless ``flags`` say otherwise), seeded random
    weights, with ``flags`` added to the command line (``--batch-window-ms``
    reaches make_server): yields (engine, base URL, k)."""
    from image_search_tpu_torch.server.app import make_server, parse_args
    from image_search_tpu_torch.server.engine import SearchEngine

    args, device = parse_args([
        "--media-dir", media, "--index-dir", index_dir,
        "--index-quantize", "int8", "--model", model,
        "--model-weights", os.path.join(os.path.dirname(index_dir), "no-checkpoint.safetensors"),
        "--device", str(dev), *flags,
    ])
    engine = SearchEngine(args, device=device)
    server = make_server(engine, "127.0.0.1", 0, batch_window_ms=args.batch_window_ms)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield engine, f"http://127.0.0.1:{server.server_port}", min(args.k, 64)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), "server thread did not stop")


@contextlib.contextmanager
def _serving(dev, model: str, flags=()):
    """The HTTP server over 64 synthetic BMP photos and an empty int8 index,
    seeded random weights, with ``flags`` added to the command line: yields
    (engine, base URL, media dir, k)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        media = os.path.join(tmp, "photos")
        _photos(media)
        with _server_on(dev, model, media, os.path.join(tmp, "index"), flags) as (engine, base, k):
            yield engine, base, media, k


def _scan_and_search(torch, engine, base: str, k: int):
    """/scan of the 64 photos, /search plain and with feedback, /health, each
    answer checked (the /search answers against the plain scoring of the same
    index). -> (kernel launches of the run, the attention forward's launches
    of the run per head dim, request times)."""
    _reset_counts()
    st, scan, scan_ms = _http("GET", base + "/scan")
    st1, plain, ms1 = _http("POST", base + "/search", {"q": "a red square", "referenced_images": []})
    marked = [plain["images"][0]["image_path"], plain["images"][5]["image_path"]]
    st2, fb, ms2 = _http("POST", base + "/search", {"q": "a red square", "referenced_images": marked})
    st3, health, ms3 = _http("GET", base + "/health")
    torch.cuda.synchronize()
    launches, by_hd = _read_counts(), _read_counts_by_hd()

    check(st == 200 and scan["embedded"] == 64 and scan["decode_failures"] == 0, f"/scan: {scan}")
    for name, s, body in (("plain", st1, plain), ("feedback", st2, fb)):
        check(s == 200 and set(body) == {"images"}, f"/search {name}: status {s}, keys {set(body)}")
        imgs = body["images"]
        check(len(imgs) == k, f"/search {name}: {len(imgs)} images, want {k}")
        for d in imgs:
            check(set(d) == {"id", "image_path", "score"}, f"/search {name}: row keys {set(d)}")
            check(d["image_path"].startswith("media/"), f"/search {name}: path {d['image_path']}")
            check(d["id"] == urllib.parse.quote(d["image_path"], safe=""), f"/search {name}: id {d['id']}")
    check(st3 == 200 and health["status"] == "ok" and health["corpus"] == 64, f"/health: {health}")
    check(launches["stream_scores_int8"] > 0, f"B2 not on the path: {launches}")
    check([d["score"] for d in plain["images"]] != [d["score"] for d in fb["images"]],
          "feedback did not move the query")
    for name, body, refs in (("plain", plain, []), ("feedback", fb, marked)):
        want_s, want_p = _plain_top(torch, engine, "a red square", refs, k)
        got_s = [d["score"] for d in body["images"]]
        got_p = [engine.to_abs_path(d["image_path"]) for d in body["images"]]
        check(got_s == want_s, f"/search {name}: scores differ from the plain scoring")
        distinct = [j for j in range(k) if got_s.count(got_s[j]) == 1]
        check(all(got_p[j] == want_p[j] for j in distinct), f"/search {name}: ids differ")
    print(
        f"server: /scan embedded {scan['embedded']} photos in {scan['seconds']} s = "
        f"{scan['embedded'] / scan['seconds']} img/s (request {scan_ms} ms); "
        f"/search plain {ms1} ms, feedback {ms2} ms, /health {ms3} ms"
    )
    return launches, by_hd, {"scan_s": scan["seconds"], "scan_ms": scan_ms, "search_ms": (ms1, ms2)}


def _attention_launches(launches):
    return {k: v for k, v in launches.items() if v and k.startswith("fused_attention") and k != "fused_attention_bwd"}


def phase_server(torch, dev, model: str = "clip-vit-large-patch14"):
    """The default route: /scan + /search (B1 in both towers), then
    GET /duplicates on the same server."""
    from image_search_tpu_torch.config import get_config

    cfg = get_config(model)
    want = {"fused_attention": cfg.vision.num_layers - 1 + cfg.text.num_layers - 1}
    with _serving(dev, model) as (engine, base, media, k):
        launches, _, _ = _scan_and_search(torch, engine, base, k)
        print(f"server: kernel launches in the /scan + /search run: {launches}")
        check(_attention_launches(launches) == want, f"/scan + /search launched {launches}, want {want}")
        dup = phase_duplicates(torch, dev, engine, base, media)
    return launches, dup


def phase_server_routes(torch, dev, model: str = "clip-vit-large-patch14"):
    """/scan + /search on a fresh server under ISX_ATTN_PIPE=0 (B1p in both
    towers, B1 never) and under ISX_VIT_SPAD=264 (B6's padded entry in the
    vision tower, B1 in the text tower); the switches are set for the run
    only."""
    from image_search_tpu_torch.config import get_config

    cfg = get_config(model)
    L_v, L_t = cfg.vision.num_layers - 1, cfg.text.num_layers - 1
    res = {}
    for route, text_entry in (("packed", "fused_attention_packed"), ("padded", "fused_attention")):
        env, entry = ROUTE_SWITCHES[route]
        want = {entry: L_v}
        want[text_entry] = want.get(text_entry, 0) + L_t
        with switches(env), _serving(dev, model) as (engine, base, _, k):
            launches, _, times = _scan_and_search(torch, engine, base, k)
        print(f"server, {route} route {env}: kernel launches in the /scan + /search run: {launches}")
        check(_attention_launches(launches) == want, f"{route} route: /scan + /search launched {launches}, want {want}")
        res[route] = dict(launches=launches, **times)
    return res


TWOSTAGE_ROWS = 10_000_000  # the archive corpus of the two-stage phase, int8 x 768 = 7.7 GB
TWOSTAGE_SLAB = 1 << 20  # rows per slab, as the index allocates them
TWOSTAGE_K, TWOSTAGE_C = 1000, 4096  # the engine's k and candidate budget


def _check_images(name: str, body, k: int):
    check(set(body) == {"images"} and len(body["images"]) == k, f"{name}: {len(body.get('images', []))} images, want {k}")
    for d in body["images"]:
        check(set(d) == {"id", "image_path", "score"} and d["image_path"].startswith("media/"), f"{name}: row {d}")


def _same_answer(name: str, got_s, got_p, want_s, want_p):
    """Scores equal; paths equal wherever the score is not tied."""
    check(list(got_s) == list(want_s), f"{name}: scores differ from the full scan")
    distinct = [j for j in range(len(got_s)) if list(got_s).count(got_s[j]) == 1]
    check(all(got_p[j] == want_p[j] for j in distinct), f"{name}: ids differ from the full scan")


def twostage_http(torch, dev, model: str = "clip-vit-large-patch14"):
    """--search-twostage --index-quantize int8 on the 64 photos: /scan,
    /search plain and with feedback (two cold queries: the fused path), a
    warm repeat of both (the two-stage feedback batch), POST /search_image
    plain and with ?ref=, GET /metrics. /search against the plain scoring of
    the same index; /search_image against index.search (search_with_feedback)
    on the photo's B=1 embedding. -> (launches of the run, request times)."""
    from image_search_tpu_torch.config import get_config
    from image_search_tpu_torch.ingest.decode import decode_image_bytes
    from image_search_tpu_torch.utils.metrics import global_metrics

    cfg = get_config(model)
    with _serving(dev, model, ["--search-twostage"]) as (engine, base, media, k):
        fused0 = global_metrics.snapshot()["counters"].get("fused_searches", 0)
        _reset_counts()
        st, scan, _ = _http("GET", base + "/scan")
        check(st == 200 and scan["embedded"] == 64, f"two-stage /scan: {scan}")
        check(engine.index.sketch_fresh, "two-stage: no sketch after /scan")
        plain_q, fb_q = "a red square", "a green square"
        st1, plain, ms1 = _http("POST", base + "/search", {"q": plain_q, "referenced_images": []})
        marked = [plain["images"][0]["image_path"], plain["images"][5]["image_path"]]
        st2, fb, ms2 = _http("POST", base + "/search", {"q": fb_q, "referenced_images": marked})
        fused = global_metrics.snapshot()["counters"].get("fused_searches", 0) - fused0
        st3, plain_w, ms3 = _http("POST", base + "/search", {"q": plain_q, "referenced_images": []})
        st4, fb_w, ms4 = _http("POST", base + "/search", {"q": fb_q, "referenced_images": marked})
        photo = sorted(engine.index.paths)[7]
        with open(photo, "rb") as f:
            data = f.read()
        st5, img, ms5 = _http("POST", base + "/search_image", raw=data)
        qs = urllib.parse.urlencode([("ref", m) for m in marked])
        st6, img_fb, ms6 = _http("POST", base + f"/search_image?{qs}", raw=data)
        st7, metrics, _ = _http("GET", base + "/metrics")
        torch.cuda.synchronize()
        launches = _read_counts()

        check(all(s == 200 for s in (st1, st2, st3, st4, st5, st6, st7)), "two-stage: a request failed")
        for name, body in (("plain", plain), ("feedback", fb), ("plain warm", plain_w), ("feedback warm", fb_w),
                           ("image", img), ("image feedback", img_fb)):
            _check_images(f"two-stage /search {name}", body, k)
        check(fused == 2, f"two-stage: {fused} fused searches, want the 2 cold ones")
        for name, body, q, refs in (("plain", plain, plain_q, []), ("feedback", fb, fb_q, marked),
                                    ("plain warm", plain_w, plain_q, []), ("feedback warm", fb_w, fb_q, marked)):
            want_s, want_p = _plain_top(torch, engine, q, refs, k)
            _same_answer(f"two-stage /search {name}", [d["score"] for d in body["images"]],
                         [engine.to_abs_path(d["image_path"]) for d in body["images"]], want_s, want_p)
        emb = engine.embedder.embed_images_async([decode_image_bytes(data)], min_bucket=1)[:1]
        sel = [engine._resolve_selection(m) for m in marked]
        for name, body, (s_, i_) in (("image", img, engine.index.search(emb, k)),
                                     ("image feedback", img_fb, engine.index.search_with_feedback(emb, sel, k))):
            _same_answer(f"two-stage /search_image {name}", [d["score"] for d in body["images"]],
                         [engine.to_abs_path(d["image_path"]) for d in body["images"]],
                         s_[0].tolist(), [engine.index.paths[j] for j in i_[0].tolist()])
        check(img["images"][0]["image_path"] == engine.to_media_path(photo), "/search_image: the photo is not its own top hit")
        g = metrics["gauges"]
        check(set(metrics) == {"uptime_sec", "counters", "gauges", "latencies", "model"} and metrics["model"] == model,
              f"/metrics keys {set(metrics)}")
        check(g["corpus_size"] == 64.0 and g["twostage_sketch_active"] == 1.0, f"/metrics gauges {g}")
        check(g["twostage_certified_total"] == engine.index.twostage_certified == 6
              and engine.index.twostage_fallbacks == 0,
              f"two-stage: {engine.index.twostage_certified} certified, {engine.index.twostage_fallbacks} fallbacks")
        L_v, L_t = cfg.vision.num_layers - 1, cfg.text.num_layers - 1
        want = {"fused_attention": 3 * L_v + 2 * L_t}  # /scan, 2 cold queries, 2 image queries at B=1
        check(_attention_launches(launches) == want, f"two-stage run launched {launches}, want {want}")
        check(launches["stream_scores_int8"] >= 6, f"two-stage: B2 not on the rescore path: {launches}")
    times = dict(search_cold_ms=(ms1, ms2), search_warm_ms=(ms3, ms4), search_image_ms=(ms5, ms6))
    print(f"two-stage server: {engine.index.twostage_certified} certified, 0 fallbacks, fused_searches +{fused}; "
          f"launches {launches}; {times}")
    return launches, times


def _slabs_on_device(torch, gen, dev, n: int, mix=None, noise: float = 0.02):
    """int8 slabs of TWOSTAGE_SLAB rows (the last one partial, a multiple of
    4096) holding n rows made on the card: a rank-64 mix plus noise when
    ``mix`` is given, else Gaussian; l2-normalised, quantised by the port's
    quantize_rows_int8. -> (slabs, scales)."""
    from image_search_tpu_torch.ops.score_stream import quantize_rows_int8

    slabs, scales = [], []
    for lo in range(0, n, TWOSTAGE_SLAB):
        rows = min(TWOSTAGE_SLAB, n - lo)
        cap = -(-rows // 4096) * 4096
        slab = torch.zeros((cap, DIM), dtype=torch.int8, device=dev)
        scale = torch.zeros(cap, device=dev)
        for c0 in range(0, rows, 262_144):  # one f32 chunk at a time
            c1 = min(rows, c0 + 262_144)
            if mix is None:
                e = torch.randn(c1 - c0, DIM, generator=gen, device=dev)
            else:
                e = torch.randn(c1 - c0, mix.shape[0], generator=gen, device=dev) @ mix
                e += noise * torch.randn(c1 - c0, DIM, generator=gen, device=dev)
            slab[c0:c1], scale[c0:c1] = quantize_rows_int8(torch.nn.functional.normalize(e, dim=-1))
        slabs.append(slab)
        scales.append(scale)
    return slabs, scales


def _index_over(torch, dev, slabs, scales, n: int):
    """A VectorIndex over slabs made on the card (VectorIndex.add quantises on
    the host: minutes and a 30 GB host array at 10M rows); no paths."""
    from image_search_tpu_torch.index.index import VectorIndex

    index = VectorIndex(DIM, device=dev, quantize="int8")
    index._emb_slabs, index._scale_slabs = list(slabs), list(scales)
    index._norm_slabs = [torch.ones(s.shape[0], device=dev) for s in slabs]
    index._pen_slabs = [torch.zeros(s.shape[0], device=dev) for s in slabs]
    index._size = n
    return index


def _needed_blocks(torch, twostage, slabs, sk, n: int, q, tau, m: int, share: int):
    """For each query and slab: the blocks whose bound exceeds tau (the k-th
    exact score), which a certificate needs chosen, and the query's own pick
    per slab (quota, or quota // share under the union). -> ([B, slabs], [slabs])."""
    qt, _, _ = twostage._exact_query_vector(q, True)
    q_s, q_res, infl = twostage._query_bound_terms(qt, sk.basis, sk.ub_slack)
    nb_list = [s.shape[0] // twostage.BLOCK for s in slabs]
    quotas = [min(nb_i, -(-m * nb_i // sum(nb_list))) for nb_i in nb_list]
    needed, start = [], 0
    for i, s in enumerate(sk.sketches):
        ub = twostage._upper_bounds(q_s, q_res, infl, s, sk.resid[i], None, start, n)
        needed.append((ub.reshape(q.shape[0], -1, twostage.BLOCK).amax(dim=2) > tau[:, None]).sum(dim=1))
        start += s.shape[0]
    own = [mi if share == 1 or mi <= 1 else max(1, mi // share) for mi in quotas]
    return torch.stack(needed, dim=1).cpu(), torch.tensor(own)


def _split_ms(torch, call, iters: int = 5):
    """Median device ms of each part of twostage_topk_block (its ``timer``
    marks: stage1, gather, rescore, topk), CUDA events at each mark."""
    parts = {}
    for _ in range(iters + 1):
        start = torch.cuda.Event(enable_timing=True)
        marks = []

        def mark(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((name, e))

        start.record()
        call(mark)
        torch.cuda.synchronize()
        prev = start
        for name, e in marks:
            parts.setdefault(name, []).append(prev.elapsed_time(e))
            prev = e
    return {k: statistics.median(v[1:]) for k, v in parts.items()}  # the first call warms up


def twostage_10m(torch, dev):
    """twostage_topk_block against the full scan (_search_local: B2 per slab +
    exact_topk) on TWOSTAGE_ROWS concentrated int8 rows made on the card,
    f32 and bf16 sketches, B = 1 and 4: every query certified, scores bitwise
    and ids equal (ties aside); times in turns and the two-stage split; B2 on
    the gathered rows of one selection against its plain version;
    search_twostage against search end to end. Then 2^20 flat rows: every
    certificate fails and search_twostage answers with the full scan."""
    from image_search_tpu_torch.index import twostage
    from image_search_tpu_torch.index.index import VectorIndex, _search_local
    from image_search_tpu_torch.ops.score_stream import quantize_queries_int8, scores_int8_reference, stream_scores_int8
    from image_search_tpu_torch.ops.topk import exact_topk

    gen = torch.Generator(device=dev).manual_seed(21)
    n, k = TWOSTAGE_ROWS, TWOSTAGE_K
    mix = torch.randn(64, DIM, generator=gen, device=dev)
    t0 = time.perf_counter()
    slabs, scales = _slabs_on_device(torch, gen, dev, n, mix)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    index = _index_over(torch, dev, slabs, scales, n)
    sketches, build_s = {}, {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        index.build_sketch(dtype=dtype)
        torch.cuda.synchronize()
        build_s[dtype] = time.perf_counter() - t0
        sketches[dtype] = index._sketch
    nb = sum(s.shape[0] for s in slabs) // twostage.BLOCK
    print(f"two-stage 10M: {n} rows x {DIM} int8 in {len(slabs)} slabs made in {gen_s:.2f} s; sketch builds {build_s}; "
          f"device memory {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    slabs, scales = tuple(slabs), tuple(scales)
    res = {"rows": n, "k": k, "slabs": len(slabs), "sketch_build_s": build_s}
    for B in (1, 4):
        q = torch.randn(B, 64, generator=gen, device=dev) @ mix + 0.02 * torch.randn(B, DIM, generator=gen, device=dev)
        want_s, want_i = _search_local(slabs, n, q, k, scales)

        def full():
            return _search_local(slabs, n, q, k, scales)

        qi, qs = quantize_queries_int8(q)
        starts = [sum(s.shape[0] for s in slabs[:j]) for j in range(len(slabs))]
        scores = torch.cat([stream_scores_int8(sl, qi, qs, scales[j], n - starts[j]) for j, sl in enumerate(slabs)], dim=1)
        b2_ms = statistics.median(cuda_ms(torch, lambda: [stream_scores_int8(sl, qi, qs, scales[j], n - starts[j])
                                                          for j, sl in enumerate(slabs)], iters=5))
        topk_ms = statistics.median(cuda_ms(torch, lambda: exact_topk(scores, k), iters=5))
        del scores
        wall, busy, top = _profiled(torch, full)
        res[("full", B)] = dict(profiled_wall_ms=wall, device_busy_ms=busy)
        print(f"full scan 10M B={B}: profiled call wall {wall} ms, device busy {busy} ms; top kernels {top[:4]}")
        for dtype, sk in sketches.items():
            share = 1 << (B - 1).bit_length() if B > 1 else 1
            m = VectorIndex._block_budget(sk, TWOSTAGE_C, share, nb)

            def two(timer=None):
                return twostage.twostage_topk_block(slabs, sk.sketches, sk.resid, sk.basis, n, q, k, m, scales,
                                                    None, sk.ub_slack, share, timer=timer)

            s_, i_, cert = two()
            needed, own = _needed_blocks(torch, twostage, slabs, sk, n, q, want_s[:, k - 1], m, share)
            for b in range(B):
                # the certificate holds iff every block whose bound exceeds the
                # k-th exact score was chosen; a query's own top blocks of each
                # slab always are, so it can fail only where a slab needs more
                fits = bool((needed[b] <= own).all())
                check(bool(cert[b]) or not fits, f"two-stage 10M {dtype} B={B}: query {b} failed within its quotas")
            if bool(cert.all()):
                check(torch.equal(s_, want_s), f"two-stage 10M {dtype} B={B}: scores not bitwise the full scan's")
                ties = torch.zeros_like(s_, dtype=torch.bool)
                ties[:, 1:] |= s_[:, 1:] == s_[:, :-1]
                ties[:, :-1] |= s_[:, :-1] == s_[:, 1:]
                check(torch.equal(i_[~ties], want_i[~ties]), f"two-stage 10M {dtype} B={B}: ids differ")
                check(torch.equal(torch.sort(i_[ties]).values, torch.sort(want_i[ties]).values)
                      or bool(ties[:, -1].any()), f"two-stage 10M {dtype} B={B}: tied ids differ")
                verdict = f"certified, scores bitwise the full scan's ({int(ties.sum())} tied positions)"
            else:
                index._sketch = sk
                got = index.search_twostage(q, k, count_failures=False)
                check((got[0] == want_s.cpu().numpy()).all(), f"two-stage 10M {dtype} B={B}: fallback differs")
                verdict = f"NOT certified {cert.tolist()}: search_twostage answers with the full scan's scores"
            two_ms, full_ms = ab_ms(torch, full, two, iters=5)
            split = _split_ms(torch, two)
            wall, busy, top = _profiled(torch, two)
            res[(dtype, B)] = dict(twostage_ms=two_ms, full_ms=full_ms, m=m, split=split, certified=cert.tolist(),
                                   needed_blocks=needed.sum(dim=1).tolist(), needed_max_per_slab=needed.amax(dim=1).tolist(),
                                   own_per_slab=own.tolist(), full_b2_ms=b2_ms, full_topk_ms=topk_ms,
                                   profiled_wall_ms=wall, device_busy_ms=busy)
            print(f"two-stage 10M {dtype} sketch B={B}: {verdict}; two-stage {two_ms} ms vs full scan {full_ms} ms "
                  f"({full_ms / two_ms:.2f}x) in turns; m={m} blocks = {m * twostage.BLOCK} rows; split {split}; "
                  f"blocks whose bound exceeds tau, per query {needed.sum(dim=1).tolist()}, most in one slab "
                  f"{needed.amax(dim=1).tolist()} against a query's own per-slab pick {own.tolist()}; profiled call "
                  f"wall {wall} ms, device busy {busy} ms; top kernels {top[:5]}; full scan: B2 over {len(slabs)} "
                  f"slabs {b2_ms} ms + exact_topk {topk_ms} ms")

    # B2 at the rescore's shape: the rows of one selection's blocks against the plain version
    qi, qs = quantize_queries_int8(torch.randn(4, 64, generator=gen, device=dev) @ mix)
    blocks = torch.randperm(TWOSTAGE_SLAB // twostage.BLOCK, generator=gen, device=dev)[:TWOSTAGE_C]
    rows = slabs[0].view(-1, twostage.BLOCK, DIM)[blocks].reshape(-1, DIM)
    rscale = scales[0].view(-1, twostage.BLOCK)[blocks].reshape(-1)
    N = rows.shape[0]
    for B in (1, 4):
        got = stream_scores_int8(rows, qi[:B], qs[:B], rscale, N)
        check(torch.equal(got, scores_int8_reference(rows, qi[:B], qs[:B], rscale, N)),
              f"B2 at the rescore shape B={B}: not bitwise its plain version")
        k_ms, p_ms = ab_ms(torch, lambda: scores_int8_reference(rows, qi[:B], qs[:B], rscale, N),
                           lambda: stream_scores_int8(rows, qi[:B], qs[:B], rscale, N), iters=10)
        b_ms, _ = bound(N * DIM + B * DIM + 4 * B + 4 * N + 4 * B * N, 2 * B * N * DIM, INT8_OP_PER_S)
        res[("rescore_b2", B)] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, rows=N)
        print(f"B2 at the rescore shape N={N} B={B}: bitwise plain; kernel {k_ms} ms, plain {p_ms} ms, bound {b_ms} ms")
    del rows

    # the entry points, end to end (host clock and fetch included): f32 sketch, B=1
    index._sketch = sketches["float32"]
    q = torch.randn(1, 64, generator=gen, device=dev) @ mix
    c0 = index.twostage_certified
    got, want = index.search_twostage(q, k), index.search(q, k)
    check(index.twostage_certified == c0 + 1 and (got[0] == want[0]).all(), "search_twostage at 10M: not certified or differs")
    e2e_two, e2e_full = ab_ms(torch, lambda: index.search(q, k), lambda: index.search_twostage(q, k), iters=5)
    res["search_twostage_ms"], res["search_ms"] = e2e_two, e2e_full
    print(f"VectorIndex at 10M, B=1: search_twostage {e2e_two} ms vs search {e2e_full} ms (events around each call)")
    del index, sketches, slabs, scales, want_s, want_i
    torch.cuda.empty_cache()

    # a flat corpus: the certificate must fail, the answer is the full scan's
    n = TWOSTAGE_SLAB
    slabs, scales = _slabs_on_device(torch, gen, dev, n)
    index = _index_over(torch, dev, slabs, scales, n)
    index.build_sketch()
    for B in (1, 4):
        q = torch.randn(B, DIM, generator=gen, device=dev)
        f0, c0 = index.twostage_fallbacks, index.twostage_certified
        got, want = index.search_twostage(q, k), index.search(q, k)
        check(index.twostage_fallbacks == f0 + 1 and index.twostage_certified == c0,
              f"flat corpus B={B}: the certificate did not fail")
        check((got[0] == want[0]).all() and (got[1] == want[1]).all(), f"flat corpus B={B}: fallback differs")
    q = torch.randn(1, DIM, generator=gen, device=dev)
    fb_ms, full_ms = ab_ms(torch, lambda: index.search(q, k),
                           lambda: index.search_twostage(q, k, count_failures=False), iters=5)
    res["flat"] = dict(rows=n, fallback_ms=fb_ms, full_ms=full_ms)
    print(f"two-stage flat {n} rows: every certificate failed, answers the full scan's; "
          f"search_twostage (bound pass + fallback) {fb_ms} ms vs search {full_ms} ms")
    del index, slabs, scales
    torch.cuda.empty_cache()
    return res


def phase_twostage(torch, dev):
    """The certified two-stage search: served over HTTP, then direct at 10M
    rows and on a flat corpus."""
    launches, times = twostage_http(torch, dev)
    return launches, times, twostage_10m(torch, dev)


SERVE_CLIENTS, SERVE_ROUNDS = 32, 8  # the batcher's load: clients, requests each (one after another)
BF16_ROWS = 10_000_000  # the direct bf16 corpus: 768-d rows, 15.4 GB
# bf16 rows: two f32 sums of the same exact products in two orders (cuBLAS's
# GEMM with an f32 output, the plain version's upcast matmul) differ by up to
# a few ulp of a score near 1; the bound for any two orders is 2 * 768 * 2^-24
NEAR_TIE = 1e-5


def _wait_gauge(base: str, name: str, timeout: float = 600.0) -> float:
    """Poll GET /metrics until the gauge ``name`` reads 1 -> seconds waited."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if _http("GET", base + "/metrics")[1]["gauges"].get(name) == 1.0:
            return time.perf_counter() - t0
        time.sleep(0.02)
    raise SmokeFailure(f"gauge {name} did not reach 1 within {timeout} s")


def _load(base: str, tag: str, marks):
    """SERVE_CLIENTS client threads released together, each sending
    SERVE_ROUNDS /search requests one after another, every query new (the
    text tower runs in every batch), every other client marking ``marks``
    -> ({(query, refs): images}, client ms of every request)."""
    answers, lat, errors = {}, [], []
    lock = threading.Lock()
    start = threading.Barrier(SERVE_CLIENTS)

    def client(c):
        try:
            start.wait()
            refs = tuple(marks) if c % 2 else ()
            for r in range(SERVE_ROUNDS):
                q = f"{tag} query {c} {r}"
                st, body, ms = _http("POST", base + "/search", {"q": q, "referenced_images": list(refs)})
                check(st == 200, f"{tag} load: /search answered {st}")
                with lock:
                    answers[(q, refs)] = body["images"]
                    lat.append(ms)
        except Exception as err:  # reported below, on the main thread
            with lock:
                errors.append(repr(err))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not errors and not any(t.is_alive() for t in threads), f"{tag} load: {errors[:3]}")
    return answers, lat


def _pct(xs, p: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))]


def _mean_batch(before, after) -> float:
    """Searches per engine.search_many call between two GET /metrics bodies
    (the full-scan path times one index_search per call)."""
    n = after["counters"].get("searches", 0) - before["counters"].get("searches", 0)
    calls = after["latencies"]["index_search"]["count"] - before["latencies"].get("index_search", {}).get("count", 0)
    return n / calls


def _pairs(images):
    return [(d["image_path"], d["score"]) for d in images]


def _close_answer(name: str, got_s, got_p, want_s, want_p, tol: float = NEAR_TIE):
    """Scores within ``tol``; paths equal wherever no neighbour lies within
    ``tol`` (a near-tie may swap under another summation order)."""
    check(len(got_s) == len(want_s), f"{name}: {len(got_s)} results, want {len(want_s)}")
    err = max((abs(a - b) for a, b in zip(got_s, want_s)), default=0.0)
    check(err <= tol, f"{name}: scores {err} from the plain scoring")
    apart = [j for j in range(len(got_s))
             if all(abs(got_s[j] - got_s[i]) > tol for i in (j - 1, j + 1) if 0 <= i < len(got_s))]
    check(all(got_p[j] == want_p[j] for j in apart), f"{name}: ids differ from the plain scoring")
    return err


def _served(engine, images):
    return [d["score"] for d in images], [engine.to_abs_path(d["image_path"]) for d in images]


def serving_batched(torch, dev, model: str, tmp: str, media: str, thumbs: str):
    """Step A: one server with an int8 index, --batch-window-ms 2,
    --thumb-cache and --prune-on-scan on the JPEG photos."""
    import numpy as np

    from image_search_tpu_torch import _build
    from image_search_tpu_torch.ops.score_stream import stream_scores_int8
    from image_search_tpu_torch.server.app import make_server, parse_args
    from image_search_tpu_torch.server.engine import SearchEngine
    from image_search_tpu_torch.utils.metrics import global_metrics

    res = {}
    lib, built = _build._lib, _build.build_seconds
    flags = ["--batch-window-ms", "2", "--thumb-cache", thumbs, "--prune-on-scan"]
    with _server_on(dev, model, media, os.path.join(tmp, "index_a"), flags) as (engine, base, k):
        _wait_gauge(base, "serving_warmup_done")  # the startup warm-up, on an empty index
        client = os.path.join(REPO, "image_search_tpu_torch", "client", "static")
        for path, name in (("/", "index.html"), ("/static/app.js", "app.js"), ("/a/client/route", "index.html")):
            with urllib.request.urlopen(base + path, timeout=60) as r, open(os.path.join(client, name), "rb") as f:
                check(r.status == 200 and r.read() == f.read(), f"GET {path} is not the client's {name}")
        global_metrics.gauge("serving_warmup_done", 0.0)
        _reset_counts()
        st, scan, _ = _http("GET", base + "/scan")
        tc = engine.thumb_cache
        check(st == 200 and scan["embedded"] == 64 and scan["decode_failures"] == 0, f"/scan: {scan}")
        check((tc.misses, tc.hits) == (64, 0), f"first scan: {tc.misses} cache misses, {tc.hits} hits, want 64, 0")
        res["scan_cold_img_per_s"] = scan["embedded"] / scan["seconds"]
        res["rewarm_s"] = _wait_gauge(base, "serving_warmup_done")  # the re-warm after a scan that embedded

        # the model-upgrade path: a second index over the same photos and cache
        args2, device = parse_args([
            "--media-dir", media, "--index-dir", os.path.join(tmp, "index_a2"), "--index-quantize", "int8",
            "--model", model, "--model-weights", os.path.join(tmp, "no-checkpoint.safetensors"),
            "--device", str(dev), "--thumb-cache", thumbs,
        ])
        second = SearchEngine(args2, device=device)
        stats2 = second.scan()
        check((second.thumb_cache.hits, second.thumb_cache.misses) == (64, 0),
              f"second scan: {second.thumb_cache.hits} cache hits, {second.thumb_cache.misses} misses, want 64, 0")
        res["scan_warm_img_per_s"] = stats2.images_per_sec
        paths_a, emb_a = engine.index.store.load_all()
        paths_b, emb_b = second.index.store.load_all()
        row_b = {p: i for i, p in enumerate(paths_b)}
        check(sorted(paths_a) == sorted(paths_b) and all(np.array_equal(emb_a[i], emb_b[row_b[p]])
                                                         for i, p in enumerate(paths_a)),
              "cache-hit embeddings are not bitwise the first scan's")
        del second
        torch.cuda.empty_cache()

        check(_build._lib is lib and _build.build_seconds == built, "a kernel build ran inside the server")
        st, first, res["first_search_ms"] = _http("POST", base + "/search", {"q": "a red square", "referenced_images": []})
        marks = [d["image_path"] for d in first["images"][:2]]

        before = _http("GET", base + "/metrics")[1]
        answers, lat = _load(base, "batched", marks)
        after = _http("GET", base + "/metrics")[1]
        res["batched"] = dict(p50_ms=_pct(lat, 0.5), p99_ms=_pct(lat, 0.99), mean_batch=_mean_batch(before, after))
        check(res["batched"]["mean_batch"] > 1.0, f"the batcher formed no batch: {res['batched']}")
        check(after["counters"].get("batched_feedback_searches", 0) > before["counters"].get("batched_feedback_searches", 0),
              "no feedback search was batched")
        for (q, refs), images in answers.items():  # the text embedding the batch made, from the cache
            check(_pairs(images) == _pairs(engine.search(q, list(refs))), f"batched answer to {q!r} differs from it alone")
        # the text tower: each query's embedding made in its batch (cached) against the query alone (B=1)
        differ = [q for q, _ in answers
                  if not torch.equal(engine._cache_get(q).reshape(-1), engine.embedder.embed_texts_device([q])[0].reshape(-1))]
        check(not differ, f"text tower: {len(differ)} of {len(answers)} embeddings made in a batch differ from the "
                          f"query alone, e.g. {differ[:3]}")

        server0 = make_server(engine, "127.0.0.1", 0)  # the same engine, no batcher
        thread0 = threading.Thread(target=server0.serve_forever, daemon=True)
        thread0.start()
        base0 = f"http://127.0.0.1:{server0.server_port}"
        try:
            before = _http("GET", base0 + "/metrics")[1]
            _, lat0 = _load(base0, "unbatched", marks)
            after = _http("GET", base0 + "/metrics")[1]
        finally:
            server0.shutdown()
            server0.server_close()
            thread0.join(timeout=30)
        res["unbatched"] = dict(p50_ms=_pct(lat0, 0.5), p99_ms=_pct(lat0, 0.99), mean_batch=_mean_batch(before, after))
        print(f"serving A: GET / and a client route answer index.html, /static/app.js the client's file; "
              f"{SERVE_CLIENTS} clients x {SERVE_ROUNDS} /search (half with feedback): window 2 ms "
              f"{res['batched']}, window 0 {res['unbatched']}; every batched answer and text embedding equals the "
              f"query alone ({len(answers)} of {len(answers)}); first /search after the re-warm {res['first_search_ms']} ms "
              f"(re-warm {res['rewarm_s']} s); scan {res['scan_cold_img_per_s']} img/s with the cache cold, "
              f"{res['scan_warm_img_per_s']} warm (64 hits, embeddings bitwise the first scan's)")

        # POST /remove: later searches omit the photos, through B2's penalty variant
        paths = sorted(engine.index.paths)
        victims = [engine.to_media_path(p) for p in paths[:8]]
        marks2 = [engine.to_media_path(p) for p in paths[8:10]]
        st, body, _ = _http("POST", base + "/remove", {"images": victims})
        check(st == 200 and body == {"removed": 8}, f"/remove: {st} {body}")
        pen0 = stream_scores_int8.penalty_launches
        for name, q, refs in (("plain", "after removal", []), ("feedback", "after removal, marked", marks2)):
            st, body, _ = _http("POST", base + "/search", {"q": q, "referenced_images": refs})
            check(st == 200 and len(body["images"]) == 56, f"/search after /remove {name}: {len(body['images'])} results")
            check(not set(victims) & {d["image_path"] for d in body["images"]}, f"/search after /remove {name}: a removed photo")
            _same_answer(f"/search after /remove {name}", *_served(engine, body["images"]), *_plain_top(torch, engine, q, refs, k))
        res["penalty_launches_after_remove"] = stream_scores_int8.penalty_launches - pen0
        check(res["penalty_launches_after_remove"] >= 2, "B2's penalty variant did not run after /remove")

        st, scan, _ = _http("GET", base + "/scan")
        check(scan["embedded"] == 0 and scan["pruned"] == 0, f"rescan after /remove: {scan}")
        body = _http("POST", base + "/search", {"q": "after rescan", "referenced_images": []})[1]
        check(len(body["images"]) == 56 and not set(victims) & {d["image_path"] for d in body["images"]},
              "a rescan brought a removed photo back")
        st, body, _ = _http("POST", base + "/remove", {"images": victims, "restore": True})
        check(st == 200 and body == {"restored": 8}, f"/remove restore: {st} {body}")
        hits = tc.hits
        st, scan, _ = _http("GET", base + "/scan")
        check(scan["embedded"] == 8 and tc.hits - hits == 8, f"rescan after restore: {scan}, {tc.hits - hits} cache hits")
        body = _http("POST", base + "/search", {"q": "after restore", "referenced_images": []})[1]
        check(len(body["images"]) == 64 and set(victims) <= {d["image_path"] for d in body["images"]},
              "restore + rescan did not bring the photos back")
        gone = paths[-4:]
        for p in gone:
            os.remove(p)
        st, scan, _ = _http("GET", base + "/scan")
        check(scan["pruned"] == 4 and scan["embedded"] == 0, f"rescan after deleting 4 files: {scan}")
        body = _http("POST", base + "/search", {"q": "after prune", "referenced_images": []})[1]
        check(len(body["images"]) == 60 and not {engine.to_media_path(p) for p in gone} & {d["image_path"] for d in body["images"]},
              "a pruned photo came back")
        torch.cuda.synchronize()
        res["launches"] = _read_counts()
    print(f"serving A: /remove 8 -> 56 results, each /search equal to the plain scoring with the rows masked, B2 "
          f"penalty launches {res['penalty_launches_after_remove']}; rescan kept them out; restore + rescan brought "
          f"them back (8 cache hits); 4 files deleted -> pruned 4; launches {res['launches']}")
    return res


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def first_request(model: str, dev, tmp: str, media: str, window: str):
    """The user's entry point in a fresh process (``python -m
    image_search_tpu_torch.server.app``) over step A's index: seconds until
    /health answers, with a window until serving_warmup_done, then the first
    and the second /search (client ms). The process is stopped after."""
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "image_search_tpu_torch.server.app", "--media-dir", media,
           "--index-dir", os.path.join(tmp, "index_a"), "--index-quantize", "int8", "--model", model,
           "--model-weights", os.path.join(tmp, "no-checkpoint.safetensors"), "--port", str(port),
           "--batch-window-ms", window, "--device", str(dev)]
    with open(os.path.join(tmp, f"server_{window}.log"), "w") as log_f:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log_f, stderr=subprocess.STDOUT)
        try:
            t0 = time.perf_counter()
            while True:
                check(proc.poll() is None, f"the server process exited with {proc.returncode}")
                check(time.perf_counter() - t0 < 300, "the server process did not answer /health")
                try:
                    _http("GET", base + "/health")
                    break
                except OSError:
                    time.sleep(0.1)
            out = {"up_s": time.perf_counter() - t0}
            if float(window) > 0:
                out["warmup_s"] = _wait_gauge(base, "serving_warmup_done", timeout=300)
            for name in ("first_ms", "second_ms"):
                st, body, out[name] = _http("POST", base + "/search", {"q": f"{name} query", "referenced_images": []})
                check(st == 200 and len(body["images"]) == 60, f"fresh server /search: {st}")
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    return out


def serving_bf16_http(torch, dev, model: str, tmp: str, media: str, thumbs: str):
    """Step B, served: --index-quantize bfloat16 on the photos left after
    step A: /search plain and with feedback, /search_image, each against the
    plain scoring of the same rows (both operands upcast to f32)."""
    from image_search_tpu_torch.ingest.decode import decode_image_bytes

    res = {}
    with _server_on(dev, model, media, os.path.join(tmp, "index_bf16"),
                    ["--index-quantize", "bfloat16", "--thumb-cache", thumbs]) as (engine, base, k):
        st, scan, _ = _http("GET", base + "/scan")
        check(st == 200 and scan["embedded"] == 60, f"bf16 /scan: {scan}")
        check(engine.index._emb_slabs[0].dtype == torch.bfloat16, "the index rows are not bf16")
        marks = [engine.to_media_path(p) for p in sorted(engine.index.paths)[:2]]
        errs = []
        for name, q, refs in (("plain", "a red square", []), ("feedback", "a green square", marks)):
            st, body, ms = _http("POST", base + "/search", {"q": q, "referenced_images": refs})
            check(st == 200 and len(body["images"]) == 60, f"bf16 /search {name}: {st}")
            errs.append(_close_answer(f"bf16 /search {name}", *_served(engine, body["images"]), *_plain_top(torch, engine, q, refs, k)))
        photo = sorted(engine.index.paths)[5]
        with open(photo, "rb") as f:
            data = f.read()
        st, body, ms = _http("POST", base + "/search_image", raw=data)
        check(st == 200 and body["images"][0]["image_path"] == engine.to_media_path(photo), "bf16 /search_image")
        emb = engine.embedder.embed_images_async([decode_image_bytes(data)], min_bucket=1)[:1].float()
        errs.append(_close_answer("bf16 /search_image", *_served(engine, body["images"]), *_plain_scores_top(torch, engine.index, emb, k)))
        res["max_abs_err"] = max(errs)
    print(f"serving B: bf16 rows served: /search plain and feedback and /search_image within {res['max_abs_err']} "
          f"of the plain scoring, ids equal away from near-ties")
    return res


def bf16_10m(torch, dev):
    """Step B, direct: BF16_ROWS bf16 rows (and the same rows as int8) made
    on the card in slabs; the bf16 full scan at B = 1 and 8 against the
    f32-upcast plain top-k, timed in turns with the int8 full scan; the two
    ways to score a bf16 slab in f32 on one slab; approx=True against the
    exact order on the int8 rows."""
    from image_search_tpu_torch.index.index import _l2, _search_local
    from image_search_tpu_torch.ops.score_stream import float_scores, quantize_rows_int8

    gen = torch.Generator(device=dev).manual_seed(31)
    n, k = BF16_ROWS, TWOSTAGE_K
    mix = torch.randn(64, DIM, generator=gen, device=dev)
    bf, i8, sc = [], [], []
    for lo in range(0, n, TWOSTAGE_SLAB):
        rows = min(TWOSTAGE_SLAB, n - lo)
        cap = -(-rows // 4096) * 4096
        bf.append(torch.zeros((cap, DIM), dtype=torch.bfloat16, device=dev))
        i8.append(torch.zeros((cap, DIM), dtype=torch.int8, device=dev))
        sc.append(torch.zeros(cap, device=dev))
        for c0 in range(0, rows, 262_144):
            c1 = min(rows, c0 + 262_144)
            e = torch.randn(c1 - c0, 64, generator=gen, device=dev) @ mix
            e = torch.nn.functional.normalize(e + 0.02 * torch.randn(c1 - c0, DIM, generator=gen, device=dev), dim=-1)
            bf[-1][c0:c1] = e.bfloat16()
            i8[-1][c0:c1], sc[-1][c0:c1] = quantize_rows_int8(e)
    bf, i8, sc = tuple(bf), tuple(i8), tuple(sc)
    torch.cuda.synchronize()
    res = {"rows": n, "gb": sum(s.numel() * 2 for s in bf) / 1e9}
    for B in (1, 8):
        q = torch.randn(B, 64, generator=gen, device=dev) @ mix + 0.02 * torch.randn(B, DIM, generator=gen, device=dev)
        got_s, got_i = _search_local(bf, n, q, k)
        check(got_s.dtype == torch.float32, "bf16 scan scores are not f32")
        qb = _l2(q).bfloat16().float()
        parts, start = [], 0
        for slab in bf:  # the plain version: both operands upcast to f32, a chunk at a time
            s = torch.cat([qb @ slab[c:c + 262_144].float().T for c in range(0, slab.shape[0], 262_144)], dim=1)
            gpos = torch.arange(slab.shape[0], device=dev) + start
            parts.append(torch.where(gpos[None, :] < n, s, torch.full_like(s, -3.0e38)))
            start += slab.shape[0]
        want_s, want_i = torch.topk(torch.cat(parts, dim=1), k, dim=-1)
        del parts
        err = float((got_s - want_s).abs().max())
        check(err <= NEAR_TIE, f"bf16 10M B={B}: scores {err} from the f32-upcast plain top-k")
        near = torch.zeros_like(got_s, dtype=torch.bool)
        near[:, 1:] |= (got_s[:, 1:] - got_s[:, :-1]).abs() <= NEAR_TIE
        near[:, :-1] |= (got_s[:, :-1] - got_s[:, 1:]).abs() <= NEAR_TIE
        check(torch.equal(got_i[~near], want_i[~near]), f"bf16 10M B={B}: ids differ from the f32-upcast plain top-k")
        bf_ms, i8_ms = ab_ms(torch, lambda: _search_local(i8, n, q, k, sc), lambda: _search_local(bf, n, q, k), iters=5)
        # the two ways to leave a bf16 product in f32, on one slab
        qb16 = _l2(q).bfloat16()
        gemm_ms, up_ms = ab_ms(
            torch,
            lambda: torch.cat([qb16.float() @ bf[0][c:c + 262_144].float().T for c in range(0, bf[0].shape[0], 262_144)], dim=1),
            lambda: float_scores(_l2(q), bf[0]), iters=5,
        )
        # approx=True: lax.top_k's order, the same values as the exact path
        a_s, a_i = _search_local(i8, n, q, k, sc, approx=True)
        e_s, e_i = _search_local(i8, n, q, k, sc)
        check(torch.equal(a_s, e_s), f"approx 10M B={B}: values differ from the exact top-k")
        tie = torch.zeros_like(a_s, dtype=torch.bool)
        tie[:, 1:] |= a_s[:, 1:] == a_s[:, :-1]
        tie[:, :-1] |= a_s[:, :-1] == a_s[:, 1:]
        check(torch.equal(a_i[~tie], e_i[~tie]), f"approx 10M B={B}: ids differ from the exact top-k away from ties")
        approx_ms, exact_ms = ab_ms(torch, lambda: _search_local(i8, n, q, k, sc),
                                    lambda: _search_local(i8, n, q, k, sc, approx=True), iters=5)
        res[B] = dict(bf16_ms=bf_ms, int8_ms=i8_ms, max_abs_err=err, slab_gemm_f32_out_ms=gemm_ms,
                      slab_upcast_ms=up_ms, approx_ms=approx_ms, exact_ms=exact_ms)
        print(f"bf16 10M B={B}: full scan {bf_ms} ms vs int8 {i8_ms} ms in turns; scores within {err} of the "
              f"f32-upcast plain top-k, ids equal away from near-ties; one 2^20-row slab: bf16 GEMM with f32 out "
              f"{gemm_ms} ms vs f32-upcast chunks {up_ms} ms; int8 approx (lax.top_k order) {approx_ms} ms vs exact "
              f"{exact_ms} ms, values bitwise")
    del bf, i8, sc
    torch.cuda.empty_cache()
    return res


def serving_approx(torch, dev, model: str, tmp: str, media: str, thumbs: str):
    """Step C: --search-approx: /search plain and with feedback and
    /search_image, each equal to the same engine's exact index call."""
    from image_search_tpu_torch.ingest.decode import decode_image_bytes

    with _server_on(dev, model, media, os.path.join(tmp, "index_approx"),
                    ["--search-approx", "--thumb-cache", thumbs]) as (engine, base, k):
        st, scan, _ = _http("GET", base + "/scan")
        check(st == 200 and scan["embedded"] == 60, f"approx /scan: {scan}")
        marks = [engine.to_media_path(p) for p in sorted(engine.index.paths)[:2]]
        for name, q, refs in (("plain", "a red square", []), ("feedback", "a green square", marks)):
            st, body, _ = _http("POST", base + "/search", {"q": q, "referenced_images": refs})
            text = engine._cache_get(q).float().reshape(1, -1)
            s, i = engine.index.search_with_feedback_batch(text, [[engine._resolve_selection(m) for m in refs]], k)
            check(st == 200 and _pairs(body["images"]) == _pairs(engine._format_results(s[0], i[0])),
                  f"approx /search {name}: differs from the exact search")
        photo = sorted(engine.index.paths)[5]
        with open(photo, "rb") as f:
            data = f.read()
        st, body, _ = _http("POST", base + "/search_image", raw=data)
        emb = engine.embedder.embed_images_async([decode_image_bytes(data)], min_bucket=1)[:1]
        s, i = engine.index.search(emb, k)
        check(st == 200 and _pairs(body["images"]) == _pairs(engine._format_results(s[0], i[0])),
              "approx /search_image: differs from the exact search")
    print("serving C: --search-approx: /search plain and feedback and /search_image equal the exact search")


def phase_serving(torch, dev, model: str = "clip-vit-large-patch14"):
    """The rest of the one-card server on 64 synthetic JPEG photos: the
    batcher, the warm-up, /remove with restore, --prune-on-scan and the
    thumbnail cache (A); the first request of a fresh server process with
    and without the warm-up; bf16 rows served and at 10M rows (B);
    --search-approx (C)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serving_") as tmp:
        media, thumbs = os.path.join(tmp, "photos"), os.path.join(tmp, "thumbs")
        _photos(media, fmt="jpeg", lo=480, hi=1400, seed=2)
        res = {"batched": serving_batched(torch, dev, model, tmp, media, thumbs)}
        res["first_request"] = {w: first_request(model, dev, tmp, media, w) for w in ("0", "2")}
        print(f"fresh server process, first and second /search: window 0 (no warm-up) {res['first_request']['0']}, "
              f"window 2 (warm-up) {res['first_request']['2']}")
        res["bf16_http"] = serving_bf16_http(torch, dev, model, tmp, media, thumbs)
        res["bf16_10m"] = bf16_10m(torch, dev)
        serving_approx(torch, dev, model, tmp, media, thumbs)
    return res


LADDER = {"openclip-vit-H-14": 80, "openclip-vit-bigG-14": 104}  # preset -> its vision tower's head dim
LADDER_ROWS = 1_000_000  # B2 at the ladder's row widths
# B9's (K, N) in the presets' fully fused vision blocks: H/14's qkv and fc1, bigG's
LADDER_LN_MATMUL = ((1280, 3840), (1280, 5120), (1664, 4992), (1664, 8192))
# the kernels line's entries at the ladder's head dims: (entry point, the
# Pallas body it replaces, the ladder phase's result for it)
LADDER_ENTRIES = (
    ("fused_attention", "attention.py:665", "grouped"),
    ("fused_attention_packed", "attention.py:29", "packed"),
    ("fused_attention_split_padded", "attention.py:492", "padded"),
    ("fused_attention_qkv_packed", "attention.py:276", "qkv_packed"),
)


def check_head_isolation(torch, gen, dev, Hd, B=160, S=257, H=16):
    """B1, B1p, B6 (split and padded) and B7 at the vision shape with every
    head's v a distinct constant (head h: h + 1): each output column must
    hold its own head's constant, whatever the logits, so a read or a store
    past a head's edge (at Hd 104: columns 104-111 are the next head's) shows
    as another head's value; the output starts as NaN, so a column never
    written shows too."""
    from image_search_tpu_torch.ops import attention as A

    F = torch.nn.functional
    D, Sp = H * Hd, (S // 128) * 128 + 8
    qkv = torch.randn(B, S, 3 * D, generator=gen, device=dev).to(torch.bfloat16)
    const = torch.arange(1, H + 1, device=dev, dtype=torch.float32).repeat_interleave(Hd)
    qkv[..., 2 * D :] = const.to(torch.bfloat16)
    q, k, v = qkv[..., :D] * Hd**-0.5, qkv[..., D : 2 * D], qkv[..., 2 * D :]
    pad = lambda t: F.pad(t, (0, 0, 0, Sp - S))
    calls = {
        "grouped": lambda: A.fused_attention(q, k, v, H),
        "packed": lambda: A.fused_attention_packed(q, k, v, H),
        "split": lambda: A.fused_attention_split(q, k, v, H),
        "padded": lambda: A.fused_attention_split_padded(pad(q), pad(k), pad(v), H, S)[:, :S],
        "qkv_packed": lambda: A.fused_attention_qkv_packed(qkv, H, False, Hd**-0.5),
    }
    worst = {}
    for core, call in calls.items():
        torch.empty(B * Sp * D * 4, device=dev, dtype=torch.bfloat16).fill_(float("nan"))  # poison the allocator
        got = call()
        torch.cuda.synchronize()
        rel = (got.float() / const - 1).abs()
        worst[core] = rel.max().item()
        check(bool(torch.isfinite(rel).all()) and worst[core] <= 2e-2,
              f"attention {core} Hd={Hd}: a column left its head (max |out / own constant - 1| = {worst[core]})")
    print(f"ladder: per-head isolation B={B} S={S} H={H} Hd={Hd}: max |out / own head's constant - 1| {worst} "
          f"(<= 2e-2; neighbouring constants differ by >= 1/{H})")
    return worst


def ladder_kernels(torch, gen, dev, Hd):
    """B1, B1p, B6 (split and padded) and B7 at the vision shape B=160 S=257
    H=16 and head dim Hd against their plain versions, timed beside SDPA; B1,
    B1p and B7 at the ragged edges S = 1, 33 and 300 (causal and not); the
    per-head isolation case; B8 (built at 64 only) raises for the head dim."""
    from image_search_tpu_torch.ops import attention as A

    res = {}
    for core in ("grouped", "packed"):
        res[core] = check_attention_fwd(torch, gen, dev, core, 160, 257, 16, Hd=Hd)
    res["split"] = check_attention_fwd(torch, gen, dev, "split", 160, 257, 16, Hd=Hd)
    res["padded"] = check_attention_fwd(torch, gen, dev, "padded", 160, 264, 16, s_real=257, Hd=Hd)
    res["qkv_packed"] = check_qkv_packed(torch, gen, dev, 160, 257, 16, False, Hd=Hd)
    torch.cuda.empty_cache()
    ragged = []
    for S in (1, 33, 300):
        for causal in (False, True):
            for core in ("grouped", "packed"):
                ragged.append(check_attention_fwd(torch, gen, dev, core, 4, S, 16, causal, Hd=Hd, timed=False))
            ragged.append(check_qkv_packed(torch, gen, dev, 4, S, 16, causal, Hd=Hd, timed=False))
    print(f"ladder: B1, B1p, B7 at Hd={Hd}, B=4 H=16, S in (1, 33, 300), causal and not: "
          f"max_abs_err={max(r['max_abs_err'] for r in ragged)} min_cos_vs_f32={min(r['min_cos'] for r in ragged)}")
    res["isolation"] = check_head_isolation(torch, gen, dev, Hd)
    x = torch.zeros(1, 8, 2 * Hd, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(6 * Hd, 2 * Hd, device=dev, dtype=torch.bfloat16)
    try:
        A.fused_qkv_attention(x, w, w[:, 0].contiguous(), 2)
        raise SmokeFailure(f"B8 ran at head dim {Hd}: it is built at 64 only")
    except NotImplementedError as err:
        check(f"head dim {Hd} not built" in str(err), f"B8 at head dim {Hd}: {err}")
    for core in ("grouped", "packed", "padded", "qkv_packed"):
        res[core]["ragged_max_abs_err"] = max(r["max_abs_err"] for r in ragged)
    return res


def tower_bound_ms(tc, batch: int, tokens: int, causal: bool, extra_ops: float = 0.0) -> float:
    """The least ms the card could take for one tower forward of ``batch``
    sequences of ``tokens``: its matmul and attention operations (every
    layer counted in full) at the bf16 peak against its bf16 weights read
    once at the HBM rate, whichever is longer."""
    D, M, L = tc.hidden_size, tc.mlp_size, tc.num_layers
    pairs = tokens * (tokens + 1) / 2 if causal else tokens * tokens
    ops = batch * (L * (2 * tokens * (4 * D * D + 2 * D * M) + 4 * pairs * D) + extra_ops)
    return bound(L * (4 * D * D + 2 * D * M) * 2, ops, BF16_FLOP_PER_S)[0]


def _ladder_depth2(cfg):
    import dataclasses

    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_layers=2),
                               vision=dataclasses.replace(cfg.vision, num_layers=2))


def ladder_towers(torch, gen, dev, name: str, smi):
    """One ladder preset at full width and depth, seeded random bf16 weights
    made on the card: preprocess + vision tower at B=160 and the text tower
    at B=8 (B1 in every layer but the last, counted), img/s and text ms;
    the vision tower once under each other route and under the fully fused
    blocks (launches counted exactly, output against the default route's);
    then at depth 2 the card's embeddings of 4 images and 4 texts against the
    same weights in f32 on the CPU through the plain versions."""
    import numpy as np

    from image_search_tpu_torch.config import get_config
    from image_search_tpu_torch.models.block_fused import COMPOSITIONS, blocks_as
    from image_search_tpu_torch.models.clip import encode_image, encode_text
    from image_search_tpu_torch.models.convert import build_model, init_params
    from image_search_tpu_torch.ops.preprocess import fused_preprocess, pack_batch
    from image_search_tpu_torch.tokenizer import HashTokenizer

    F = torch.nn.functional
    cfg = get_config(name)
    t0 = time.perf_counter()
    state = init_params(cfg, gen, dev, torch.bfloat16)  # on the card: bigG is ~2.5 B parameters
    model = build_model(cfg, state, dev, torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in state.values())
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(160)]
    u8, A_h, A_w = (torch.from_numpy(a) for a in pack_batch(images, size=cfg.vision.image_size))
    u8_d, A_h_d, A_w_d = (t.to(dev) for t in (u8, A_h, A_w))
    tok = HashTokenizer(cfg.text.vocab_size, cfg.text.context_length, eos_id=cfg.text.eos_token_id)
    ids = torch.from_numpy(tok([f"a photo of thing number {i}" for i in range(8)]).astype(np.int64))
    L_v, L_t = cfg.vision.num_layers - 1, cfg.text.num_layers - 1
    Hd_v, Hd_t = cfg.vision.hidden_size // cfg.vision.num_heads, cfg.text.hidden_size // cfg.text.num_heads

    def vision(m=model, n=160):
        return encode_image(m, fused_preprocess(u8_d[:n], A_h_d[:n], A_w_d[:n], out_dtype=torch.bfloat16))

    def launched(fn):
        """fn()'s result, its kernel launches by entry point, and the
        attention forward's launches by entry point and head dim."""
        _reset_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v for k, v in _read_counts().items() if v and k != "fused_attention_bwd"}, _read_counts_by_hd()

    res = {"params": n_params, "init_s": init_s}
    with torch.inference_mode():
        img, n_img, hd_img = launched(vision)
        txt, n_txt, hd_txt = launched(lambda: encode_text(model, ids.to(dev)))
        check(n_img == {"fused_attention": L_v}, f"{name} vision forward launched {n_img}, want B1 {L_v} times")
        check(n_txt == {"fused_attention": L_t}, f"{name} text forward launched {n_txt}, want B1 {L_t} times")
        check(hd_img == {"fused_attention": {Hd_v: L_v}} and hd_txt == {"fused_attention": {Hd_t: L_t}},
              f"{name}: launches per head dim vision {hd_img}, text {hd_txt}, want B1 at {Hd_v} / {Hd_t}")
        check(img.shape == (160, cfg.projection_dim) and bool(torch.isfinite(img).all()), f"{name}: bad image embeddings")
        check(txt.shape == (8, cfg.projection_dim) and bool(torch.isfinite(txt).all()), f"{name}: bad text embeddings")
        ms = statistics.median(cuda_ms(torch, vision, iters=5))
        txt_ms = statistics.median(cuda_ms(torch, lambda: encode_text(model, ids.to(dev)), iters=5))
        vc = cfg.vision
        patch_ops = 2 * (vc.seq_len - 1) * 3 * vc.patch_size**2 * vc.hidden_size
        v_bound = tower_bound_ms(vc, 160, vc.seq_len, False, patch_ops)
        t_bound = tower_bound_ms(cfg.text, 8, cfg.text.context_length, True)
        res |= {"vision_ms": ms, "img_per_s": 160 / (ms * 1e-3), "text_ms": txt_ms, "vision_bound_ms": v_bound,
                "text_bound_ms": t_bound, "vision_launches": n_img, "text_launches": n_txt}
        print(f"ladder towers {name} ({n_params} parameters made on the card in {init_s:.2f} s): vision launches "
              f"{n_img}, text launches {n_txt}; bf16 preprocess+vision B=160 {ms} ms/batch = {160 / (ms * 1e-3)} "
              f"img/s (bound {v_bound} ms = {160 / (v_bound * 1e-3)} img/s, {v_bound / ms:.1%} of it); text tower "
              f"B=8 {txt_ms} ms (bound {t_bound} ms)  [{smi}]")
        routes = {}
        variants = {r: (lambda env=env: switches(env), {entry: L_v}) for r, (env, entry) in ROUTE_SWITCHES.items()}
        variants["fully fused"] = (lambda: blocks_as(COMPOSITIONS["fully fused"]),
                                   {k: v * L_v for k, v in FUSED_LAUNCHES["fully fused"].items()})
        for route, (ctx, want) in variants.items():
            with ctx():
                got, n, by_hd = launched(vision)
            cos = F.cosine_similarity(got.float(), img.float(), dim=-1).min().item()
            check(n == want, f"{name} vision on the {route} route launched {n}, want {want}")
            want_hd = {k: {Hd_v: v} for k, v in want.items() if k.startswith("fused_attention")}
            check(by_hd == want_hd, f"{name} vision on the {route} route: launches per head dim {by_hd}, want {want_hd}")
            check(cos >= TOWER_MIN_COS, f"{name} {route} route: cosine {cos} to the default route < {TOWER_MIN_COS}")
            routes[route] = {"launches": n, "launches_by_hd": by_hd, "cos_to_default": cos}
        res["routes"] = routes
        print(f"ladder towers {name}: vision under each other route, launches and min cosine to the default "
              f"route's embeddings: {routes}")
        del model, state, img, txt
        torch.cuda.empty_cache()

        cfg2 = _ladder_depth2(cfg)
        state2 = init_params(cfg2, gen, dev, torch.bfloat16)
        m2 = build_model(cfg2, state2, dev, torch.bfloat16)
        img, n_img, _ = launched(lambda: vision(m2, 4))
        txt, n_txt, _ = launched(lambda: encode_text(m2, ids[:4].to(dev)))
        check(n_img == n_txt == {"fused_attention": 1}, f"{name} depth 2: launched {n_img} and {n_txt}")
        cpu = build_model(cfg2, {k: t.float().cpu() for k, t in state2.items()}, "cpu", torch.float32)
        img32 = encode_image(cpu, fused_preprocess(u8[:4], A_h[:4], A_w[:4]))
        txt32 = encode_text(cpu, ids[:4])
        cos_i = F.cosine_similarity(img.float().cpu(), img32, dim=-1).min().item()
        cos_t = F.cosine_similarity(txt.float().cpu(), txt32, dim=-1).min().item()
        print(f"ladder towers {name} at full width and depth 2: bf16 card vs f32 CPU min cosine image={cos_i} "
              f"text={cos_t} (bound {TOWER_MIN_COS})")
        check(cos_i >= TOWER_MIN_COS and cos_t >= TOWER_MIN_COS, f"{name} depth 2: cosine {cos_i} / {cos_t}")
        res |= {"cos_image": cos_i, "cos_text": cos_t}
        del m2, state2, cpu
    torch.cuda.empty_cache()
    return res


def ladder_server(torch, dev, name: str):
    """The HTTP server of one ladder preset on the 64 photos, seeded random
    weights at full width, an int8 index: /scan, /search plain and with
    feedback (against the plain scoring of the same index), one
    /search_image (against the plain scoring of the photo's B=1
    embedding); launches counted, the peak memory read."""
    from image_search_tpu_torch.config import get_config
    from image_search_tpu_torch.ingest.decode import decode_image_bytes

    cfg = get_config(name)
    L_v, L_t = cfg.vision.num_layers - 1, cfg.text.num_layers - 1
    Hd_v, Hd_t = cfg.vision.hidden_size // cfg.vision.num_heads, cfg.text.hidden_size // cfg.text.num_heads
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()  # what earlier phases still hold: not the server's
    with _serving(dev, name) as (engine, base, media, k):
        launches, by_hd, times = _scan_and_search(torch, engine, base, k)
        want = {"fused_attention": L_v + L_t}  # /scan's one vision batch, one text batch (feedback hits the cache)
        check(_attention_launches(launches) == want, f"{name}: /scan + /search launched {launches}, want {want}")
        want_hd = {"fused_attention": {Hd_v: L_v, Hd_t: L_t}}
        check(by_hd == want_hd, f"{name}: /scan + /search launches per head dim {by_hd}, want {want_hd}")
        photo = sorted(engine.index.paths)[7]
        with open(photo, "rb") as f:
            data = f.read()
        _reset_counts()
        st, img, img_ms = _http("POST", base + "/search_image", raw=data)
        torch.cuda.synchronize()
        img_launches, img_by_hd = _read_counts(), _read_counts_by_hd()
        check(st == 200, f"{name} /search_image: status {st}")
        _check_images(f"{name} /search_image", img, k)
        check(_attention_launches(img_launches) == {"fused_attention": L_v},
              f"{name} /search_image launched {img_launches}, want B1 {L_v} times")
        check(img_launches["stream_scores_int8"] > 0, f"{name} /search_image: B2 not on the path")
        check(img_by_hd == {"fused_attention": {Hd_v: L_v}}, f"{name} /search_image: launches per head dim {img_by_hd}")
        emb = engine.embedder.embed_images_async([decode_image_bytes(data)], min_bucket=1)[:1]
        want_s, want_p = _plain_scores_top(torch, engine.index, emb.float().reshape(1, -1), k)
        _same_answer(f"{name} /search_image", [d["score"] for d in img["images"]],
                     [engine.to_abs_path(d["image_path"]) for d in img["images"]], want_s, want_p)
        check(img["images"][0]["image_path"] == engine.to_media_path(photo), f"{name} /search_image: not its own top hit")
        peak = (torch.cuda.max_memory_allocated() - live) / 2**30
    # B1 at the vision head dim in the two counted runs, as its wrapper counted them
    vision_b1 = by_hd["fused_attention"][Hd_v] + img_by_hd["fused_attention"][Hd_v]
    print(f"ladder server {name}: launches /scan + /search {launches} (per head dim {by_hd}), /search_image "
          f"{img_launches} (per head dim {img_by_hd}); /search_image {img_ms} ms; peak memory {peak:.2f} GiB above "
          f"the {live / 2**30:.2f} GiB held before")
    return dict(launches=launches, image_launches=img_launches, vision_b1=vision_b1, search_image_ms=img_ms,
                peak_gib=peak, **times)


def ladder_scores(torch, gen, dev):
    """B2 at the ladder's row widths (H/14's 1024, bigG's 1280), 1M rows and
    B = 1 and 8: bitwise its plain version in one launch, timed in turns
    against the bound. At 1280 the plain version sums in f64 (an f32 sum of
    int8 products is exact only below 2^24)."""
    from image_search_tpu_torch.ops.score_stream import quantize_rows_int8, scores_int8_reference, stream_scores_int8

    F = torch.nn.functional
    res = {}
    N = LADDER_ROWS
    for D in (1024, 1280):
        rows, scales = quantize_rows_int8(F.normalize(torch.randn(N, D, generator=gen, device=dev), dim=-1))
        limit = N - 12_345
        for B in (1, 8):
            qi, qs = quantize_rows_int8(F.normalize(torch.randn(B, D, generator=gen, device=dev), dim=-1))
            n0 = stream_scores_int8.launches
            got = stream_scores_int8(rows, qi, qs, scales, limit)
            n_launch = stream_scores_int8.launches - n0
            want = scores_int8_reference(rows, qi, qs, scales, limit)
            check(n_launch == 1 and torch.equal(got, want), f"int8 scores D={D} B={B}: {n_launch} launches, "
                  f"bitwise equal {torch.equal(got, want)}")
            k_ms, p_ms = ab_ms(torch, lambda: scores_int8_reference(rows, qi, qs, scales, limit),
                               lambda: stream_scores_int8(rows, qi, qs, scales, limit), iters=10)
            b_ms, b_by = bound(N * D + B * D + 4 * B + 4 * N + 4 * B * N, 2 * B * N * D, INT8_OP_PER_S)
            res[(D, B)] = dict(max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms,
                               bound_by=b_by, shape=f"N={N} D={D} B={B}")
            print(f"ladder: B2 int8 scores N={N} D={D} B={B}: bitwise_equal=True launches=1 kernel_ms={k_ms} "
                  f"({N * D / (k_ms * 1e-3) / 1e9:.1f} GB/s of rows, bound_share={b_ms / k_ms:.1%}) plain_ms={p_ms} "
                  f"bound_ms={b_ms} ({b_by})")
            del got, want
        del rows, scales
        torch.cuda.empty_cache()
    return res


def phase_ladder(torch, gen, dev, smi):
    """OpenCLIP H/14 (vision head dim 80) and bigG (104) on the card: the
    attention kernels at those head dims and at 32 (the learned-retrieval
    example's, with B1 also at its towers' shapes), B1 at bigG's text shape
    B=32 S=77 H=20 causal, B9 at the widths of their fully fused vision blocks,
    both towers at full width, each preset's server, H/14
    served again under ISX_ATTN_PIPE=0 (B1p) and ISX_VIT_SPAD=264 (B6), and
    B2 at the presets' row widths."""
    res = {"kernels": {}, "towers": {}, "server": {}}
    for Hd in (*LADDER.values(), 32):
        res["kernels"][Hd] = ladder_kernels(torch, gen, dev, Hd)
    # B1 at Hd 32 where the learned-retrieval example's towers run it: vision
    # B=48 S=65 H=4, text B=48 S=16 H=4 causal
    res["gate_b1"] = {S: check_attention_fwd(torch, gen, dev, "grouped", 48, S, 4, causal, Hd=32)
                      for S, causal in ((65, False), (16, True))}
    res["bigg_text"] = check_attention_fwd(torch, gen, dev, "grouped", 32, 77, 20, True)
    res["ln_matmul"] = {kn: check_ln_matmul(torch, gen, dev, 160 * 257, *kn) for kn in LADDER_LN_MATMUL}
    torch.cuda.empty_cache()
    for name in LADDER:
        res["towers"][name] = ladder_towers(torch, gen, dev, name, smi)
        res["server"][name] = ladder_server(torch, dev, name)
    res["h14_routes"] = phase_server_routes(torch, dev, model="openclip-vit-H-14")
    res["scores"] = ladder_scores(torch, gen, dev)
    return res


def _kernel_counts():
    from image_search_tpu_torch.ops import attention as A
    from image_search_tpu_torch.ops.blockmax import blockpair_mask, blockpair_values
    from image_search_tpu_torch.ops.ln_matmul import ln_matmul
    from image_search_tpu_torch.ops.score_stream import stream_scores_int8

    return (A.fused_attention, A.fused_attention_packed, A.fused_attention_split, A.fused_attention_split_padded,
            A.fused_attention_bwd, stream_scores_int8, blockpair_mask, blockpair_values,
            A.fused_attention_qkv_packed, A.fused_qkv_attention, ln_matmul)


def _reset_counts():
    from image_search_tpu_torch.ops.score_stream import stream_scores_int8

    for fn in _kernel_counts():
        fn.launches = 0
        if hasattr(fn, "launches_by_hd"):
            fn.launches_by_hd = {}
    stream_scores_int8.penalty_launches = 0


def _read_counts():
    from image_search_tpu_torch.ops.score_stream import stream_scores_int8

    out = {fn.__name__: fn.launches for fn in _kernel_counts()}
    out["stream_scores_int8_penalty"] = stream_scores_int8.penalty_launches
    return out


def _read_counts_by_hd():
    """The attention forward entry points' launches per head dim since the
    last _reset_counts, as their wrappers counted them: {name: {Hd: n}}."""
    return {fn.__name__: dict(fn.launches_by_hd) for fn in _kernel_counts()
            if getattr(fn, "launches_by_hd", None)}


def _groups(pairs, paths):
    """Union-find groups of (i, j) pairs as a set of sorted path tuples."""
    parent = {}

    def find(x):
        while parent.get(x, x) != x:
            x = parent[x]
        return x

    for i, j in pairs:
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[ri] = rj
    groups = {}
    for i, j in pairs:
        groups.setdefault(find(i), set()).update((i, j))
    return {tuple(sorted(paths[r] for r in g)) for g in groups.values()}


def _check_served_groups(route: str, served, must, joined, paths) -> None:
    """The served groups hold every pair of ``must`` in one group, and each
    lies inside one group that the pairs of ``joined`` (each already held
    against its f32 dot) make: no group is joined by an unchecked pair."""
    served = [set(grp) for grp in served]
    for i, j in must:
        check(any({paths[i], paths[j]} <= grp for grp in served), f"{route}: pair {(i, j)} not in a served group")
    outer = [set(grp) for grp in _groups(joined, paths)]
    for grp in served:
        check(any(grp <= o for o in outer), f"{route}: served group {sorted(grp)[:4]} not joined by checked pairs")


def _oracle_pairs(torch, x, threshold: float, chunk: int = 4096):
    """Brute force on the card: every (i, j, score), i < j, with the full-f32
    dot of rows x >= threshold, in row chunks against the rows after them."""
    out_i, out_j, out_s = [], [], []
    for lo in range(0, x.shape[0], chunk):
        g = x[lo : lo + chunk] @ x[lo:].T
        keep = g >= threshold
        keep &= torch.arange(g.shape[1], device=x.device)[None, :] > torch.arange(g.shape[0], device=x.device)[:, None]
        i, j = torch.nonzero(keep, as_tuple=True)
        out_i.append(i + lo)
        out_j.append(j + lo)
        out_s.append(g[i, j])
    i, j, v = (torch.cat(t).cpu().tolist() for t in (out_i, out_j, out_s))
    return {(a, b): c for a, b, c in zip(i, j, v)}


def _dequantized(torch, index):
    from image_search_tpu_torch.index.index import _gather_rows

    slabs, _, scales, _ = index._snapshot()
    return _gather_rows(slabs, scales, torch.arange(index._size, device=slabs[0].device))


def _plant(torch, gen, x, pairs, noise: float = 0.01):
    """Make row j a near-duplicate of row i for each (i, j), in place."""
    for i, j in pairs:
        v = x[i] + noise * torch.randn(x.shape[1], generator=gen, device=x.device)
        x[j] = v / v.norm()
    return x


def _synthetic_index(torch, dev, media, x):
    from image_search_tpu_torch.index.index import VectorIndex

    index = VectorIndex(x.shape[1], device=dev, quantize="int8")
    paths = [os.path.join(media, "synthetic", f"{i:07d}.jpg") for i in range(x.shape[0])]
    t0 = time.perf_counter()
    index.add(paths, x.cpu().numpy())
    torch.cuda.synchronize()
    return index, time.perf_counter() - t0


def _timed_scan(torch, index, scan: str, threshold: float, **build_kw):
    """Build the index's sketch and run one sketch scan directly, timing the
    build, phase 1 (the block-pair sweep and its decode, done when progress
    first reaches one half) and phase 2 (the exact rescore). -> (pairs, ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.build_sketch(**build_kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    marks = []

    def progress(done, total):
        if not marks and 2 * done >= total:
            marks.append(time.perf_counter())

    pairs = getattr(index, scan)(threshold=threshold, progress=progress)
    t2 = time.perf_counter()
    ms = {"sketch_ms": (t1 - t0) * 1e3, "phase1_ms": (marks[0] - t1) * 1e3, "rescore_ms": (t2 - marks[0]) * 1e3}
    return pairs, ms


def legacy_large(torch, dev, media):
    """VectorIndex.find_near_duplicates (the legacy route) on LEGACY_ROWS
    random 768-d rows with LEGACY_COPIES byte-identical copies: every copy
    found and nothing else; wall time, B2's launches, and the device time of
    one batch's B2 calls and exact top-k, timed apart on the same slabs."""
    from image_search_tpu_torch.index.index import _gather_rows
    from image_search_tpu_torch.ops.score_stream import quantize_queries_int8, stream_scores_int8
    from image_search_tpu_torch.ops.topk import exact_topk

    gen = torch.Generator(device=dev).manual_seed(11)
    n, thr, batch = LEGACY_ROWS, 0.95, 1024
    x = torch.nn.functional.normalize(torch.randn(n, DIM, generator=gen, device=dev), dim=-1)
    for i, j in LEGACY_COPIES:
        x[j] = x[i]
    index, build_s = _synthetic_index(torch, dev, media, x)
    del x
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pairs = index.find_near_duplicates(threshold=thr, batch=batch)
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = _read_counts()
    found = {(i, j) for i, j, _ in pairs}
    check(found == set(LEGACY_COPIES), f"legacy {n} rows: pairs {sorted(found ^ set(LEGACY_COPIES))[:5]} differ")
    check(min(sc for _, _, sc in pairs) > 0.999, f"legacy {n} rows: a copy scored below 0.999")
    batches = -(-n // batch)
    check(counts["stream_scores_int8"] == batches * len(index._snapshot()[0]),
          f"legacy {n} rows: {counts['stream_scores_int8']} B2 launches for {batches} batches")
    # one batch's work, timed apart: B2 on every slab, then the exact top-k
    slabs, _, scales, pens = index._snapshot()
    size = index._size
    qi, qs = quantize_queries_int8(_gather_rows(slabs, scales, torch.arange(batch, device=dev)))
    starts = [sum(sl.shape[0] for sl in slabs[:i]) for i in range(len(slabs))]

    def b2_batch():
        return [stream_scores_int8(sl, qi, qs, scales[i], size - starts[i], None if pens is None else pens[i])
                for i, sl in enumerate(slabs)]

    scores = torch.cat(b2_batch(), dim=1)
    b2_ms = statistics.median(cuda_ms(torch, b2_batch, iters=5))
    topk_ms = statistics.median(cuda_ms(torch, lambda: exact_topk(scores, 9), iters=5))
    del scores
    share = batches * b2_ms / wall_ms
    print(f"duplicates legacy (direct) {n} rows x {DIM} int8, {len(slabs)} slab(s), batch {batch}: "
          f"pairs={len(pairs)} (planted {len(LEGACY_COPIES)}, all found) wall_ms={wall_ms} "
          f"B2 launches={counts['stream_scores_int8']} B2 per batch={b2_ms} ms, B2 share={share:.1%} "
          f"exact_topk per batch={topk_ms} ms ({batches * topk_ms / wall_ms:.1%}) corpus add {build_s:.1f} s")
    return dict(ms=wall_ms, counts=counts, rows=n, pairs=len(pairs), b2_batch_ms=b2_ms, b2_share=share,
                topk_batch_ms=topk_ms)


def phase_duplicates(torch, dev, engine, base, media):
    """GET /duplicates by its three routes on the served engine. Each route's
    kernel counts are set to 0 just before its request and read just after."""
    res = {}

    # 1. legacy: the photos plus byte-identical copies of three of them
    photos = sorted(engine.index.paths)
    copies = []
    for n, src in enumerate(photos[:: len(photos) // 3][:3]):
        dst = os.path.join(media, f"copy_{n}.bmp")
        shutil.copyfile(src, dst)
        copies.append((src, dst))
    st, scan, _ = _http("GET", base + "/scan")
    check(st == 200 and scan["embedded"] == len(copies), f"/scan of the copies: {scan}")
    x = _dequantized(torch, engine.index)
    paths = [engine.to_media_path(p) for p in engine.index.paths]
    g = (x @ x.T).cpu()
    scores = sorted(g[torch.triu(torch.ones_like(g, dtype=torch.bool), diagonal=1)].tolist())
    # the highest threshold below the copies that no pair score lies within
    # 3e-3 of: the legacy scan scores int8 queries against int8 rows, the
    # brute force f32 rows, and the two differ by ~5e-4 at D = 768
    thr = next(
        t / 10_000 for t in range(9_950, 0, -1)
        if not any(abs(v - t / 10_000) < 3e-3 for v in scores)
    )
    want = _groups([(i, j) for i in range(len(paths)) for j in range(i + 1, len(paths)) if g[i, j] >= thr], paths)
    _reset_counts()
    st, body, ms = _http("GET", base + f"/duplicates?threshold={thr}")
    counts = _read_counts()
    check(st == 200 and body["mode"] == "legacy_exact", f"/duplicates legacy: {st} {body.get('mode')}")
    check(counts["stream_scores_int8"] > 0, f"legacy route did not launch B2: {counts}")
    got = {tuple(grp) for grp in body["groups"]}
    check(got == want, f"/duplicates legacy: groups differ from the brute-force f32 groups: {got ^ want}")
    for src, dst in copies:
        pair = {engine.to_media_path(src), engine.to_media_path(dst)}
        check(any(pair <= set(grp) for grp in got), f"copy {dst} not grouped with {src}")
    res["legacy"] = dict(ms=ms, counts=counts, rows=len(paths), threshold=thr, groups=len(got))
    print(f"duplicates legacy: {len(paths)} photos threshold={thr} groups={sorted(map(len, got))} "
          f"wall_ms={ms} launches={counts}")
    del x, g

    # 1b. legacy at the size its users reach: LEGACY_ROWS int8 rows, just under
    # the engine's sketch cut, with byte-identical planted copies, scanned
    # directly; B2's share of the wall time from its own timed calls
    res["legacy_large"] = legacy_large(torch, dev, media)

    # 2. certified: CERT_ROWS concentrated rows (rank 32 + noise), 64 planted pairs
    gen = torch.Generator(device=dev).manual_seed(7)
    n, thr = CERT_ROWS, 0.95
    m = torch.randn(32, DIM, generator=gen, device=dev)
    x = torch.randn(n, 32, generator=gen, device=dev) @ m
    x = torch.nn.functional.normalize(x + 0.02 * torch.randn(n, DIM, generator=gen, device=dev), dim=-1)
    x = _plant(torch, gen, x, [(2 * p, 2 * p + 1) for p in range(64)])
    engine.index, build_s = _synthetic_index(torch, dev, media, x)
    del x
    _reset_counts()
    t0 = time.perf_counter()
    st, job, _ = _http("GET", base + f"/duplicates?threshold={thr}&async=1")
    check(st == 202 and job["poll"] == f"/duplicates?job={job['job']}", f"/duplicates async: {st} {job}")
    progress = []
    while True:
        st, body, _ = _http("GET", base + job["poll"])
        if st != 202:
            break
        progress.append(body["progress"])
        time.sleep(0.2)
    ms = (time.perf_counter() - t0) * 1e3
    counts = _read_counts()
    check(st == 200 and body["state"] == "done" and body["mode"] == "certified", f"certified: {st} {body.get('mode')}")
    check(counts["blockpair_mask"] > 0 and counts["blockpair_values"] == 0, f"certified route launches: {counts}")
    check(progress == sorted(progress), f"progress not monotone: {progress}")
    x = _dequantized(torch, engine.index)
    paths = engine.index.paths
    oracle = _oracle_pairs(torch, x, thr - BAND)
    must = {k for k, v in oracle.items() if v >= thr + BAND}
    # the pairs themselves, from the same scan run directly (the gated sketch, as the engine builds it)
    pairs, parts = _timed_scan(torch, engine.index, "find_near_duplicates_sketch", thr, min_certifiable=0.5)
    got_d = {(i, j): s for i, j, s in pairs}
    check(set(got_d) >= must, f"certified: missing pairs {sorted(must - set(got_d))[:5]}")
    check(set(got_d) <= set(oracle), f"certified: spurious pairs {sorted(set(got_d) - set(oracle))[:5]}")
    worst = max((abs(s - oracle[k]) for k, s in got_d.items()), default=0.0)
    check(worst < SCORE_ATOL, f"certified: score off its f32 dot by {worst}")
    in_band = sum(1 for v in oracle.values() if v < thr + BAND)
    _check_served_groups("certified", body["groups"], must, oracle, [engine.to_media_path(p) for p in paths])
    res["certified"] = dict(ms=ms, counts=counts, rows=n, pairs=len(got_d), build_s=build_s, **parts)
    print(f"duplicates certified: {n} rows threshold={thr} pairs={len(got_d)} oracle={len(oracle)} "
          f"(in band {in_band}) groups={len(body['groups'])} max_score_err={worst} polls={len(progress)} "
          f"wall_ms={ms} (corpus add {build_s:.1f} s) launches={counts}; direct scan {parts}")
    del x

    # 3. approximate: APPROX_ROWS flat rows, 20 in-block and 3 cross-block planted pairs
    n, thr = APPROX_ROWS, 0.5
    cross = [(100, n // 2), (n // 5, n - 576), (1_000, 2_222)]
    planted = [(2 * p, 2 * p + 1) for p in range(20)] + cross
    x = torch.nn.functional.normalize(torch.randn(n, DIM, generator=gen, device=dev), dim=-1)
    x = _plant(torch, gen, x, planted)
    engine.index = None
    torch.cuda.empty_cache()
    engine.index, build_s = _synthetic_index(torch, dev, media, x)
    del x
    _reset_counts()
    st, body, ms = _http("GET", base + f"/duplicates?threshold={thr}")
    counts = _read_counts()
    check(st == 200 and body["mode"] == "approximate", f"approximate: {st} {body.get('mode')}")
    check(counts["blockpair_values"] > 0, f"approximate route did not launch B4: {counts}")
    paths = engine.index.paths
    groups = body["groups"]
    # the emitted pairs themselves, from the same scan run directly
    pairs, parts = _timed_scan(torch, engine.index, "find_near_duplicates_candidates", thr, min_certifiable=0.0)
    engine.index.drop_sketch()
    check({(i, j) for i, j, _ in pairs} >= set(planted), "approximate (direct): planted pair missing")
    # served: every planted pair found, every group joined by checked pairs
    _check_served_groups("approximate", groups, planted, {(i, j) for i, j, _ in pairs},
                         [engine.to_media_path(p) for p in paths])
    x = _dequantized(torch, engine.index)
    ii = torch.tensor([p[0] for p in pairs], device=dev)
    jj = torch.tensor([p[1] for p in pairs], device=dev)
    dots = (x[ii] * x[jj]).sum(dim=1).cpu().tolist()
    worst = max(abs(s - d) for (_, _, s), d in zip(pairs, dots))
    check(worst < SCORE_ATOL, f"approximate: score off its f32 dot by {worst}")
    check(min(s for _, _, s in pairs) >= thr - BAND, "approximate: a pair below threshold - band")
    res["approximate"] = dict(ms=ms, counts=counts, rows=n, pairs=len(pairs), build_s=build_s, **parts)
    print(f"duplicates approximate: {n} rows threshold={thr} groups={len(groups)} pairs={len(pairs)} "
          f"max_score_err={worst} wall_ms={ms} (corpus add {build_s:.1f} s) launches={counts}; "
          f"direct scan {parts}")
    del x
    engine.index = None
    torch.cuda.empty_cache()
    return res


def _train_batch(torch, cfg, B: int, seed: int):
    """Token ids and preprocessed f32 pixels of B random photos, on the CPU."""
    import numpy as np

    from image_search_tpu_torch.ops.preprocess import fused_preprocess, pack_batch
    from image_search_tpu_torch.tokenizer import HashTokenizer

    rng = np.random.default_rng(seed)
    images = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(B)]
    u8, A_h, A_w = (torch.from_numpy(a) for a in pack_batch(images, size=cfg.vision.image_size))
    tok = HashTokenizer(cfg.text.vocab_size, cfg.text.context_length, eos_id=cfg.text.eos_token_id)
    ids = torch.from_numpy(tok([f"a photo of thing number {i}" for i in range(B)]).astype(np.int64))
    return ids, fused_preprocess(u8, A_h, A_w)


def _cos(a_list, b_list) -> float:
    dot = sum(float((a.double() * b.double()).sum()) for a, b in zip(a_list, b_list))
    na = sum(float((a.double() ** 2).sum()) for a in a_list) ** 0.5
    nb = sum(float((b.double() ** 2).sum()) for b in b_list) ** 0.5
    return dot / (na * nb)


def _step_against_cpu(torch, dev, cfg, state, ids, pixels, what: str):
    """One train step of ``cfg`` from ``state`` on the card (f32 master
    weights, bf16 compute) and the same step in f32 on the CPU, same batch
    -> (losses, gradients on the CPU, the card step's launches, its
    launches per head dim), both keyed "card" / "cpu"."""
    from image_search_tpu_torch.models.convert import build_model
    from image_search_tpu_torch.train.contrastive import adamw, make_train_step

    grads, loss, counts, by_hd = {}, {}, None, None
    for tag, where, dtype in (("card", dev, torch.bfloat16), ("cpu", torch.device("cpu"), torch.float32)):
        t0 = time.perf_counter()
        init_fn, step_fn = make_train_step(cfg, adamw(1e-5), dtype, False, where)
        st = init_fn(build_model(cfg, {k: t.to(where) for k, t in state.items()}, where, torch.float32, trainable=True))
        if tag == "card":
            _reset_counts()
        st, metrics = step_fn(st, ids, pixels)
        loss[tag] = float(metrics["loss"])
        if tag == "card":
            torch.cuda.synchronize()
            counts, by_hd = _read_counts(), _read_counts_by_hd()
        grads[tag] = {k: p.grad.detach().float().cpu() for k, p in st.model.named_parameters()}
        print(f"{what}: {tag} step ({dtype}) {time.perf_counter() - t0:.1f} s, loss {loss[tag]}")
        del st, init_fn, step_fn
        torch.cuda.empty_cache()
    return loss, grads, counts, by_hd


def _grad_cosines(grads):
    """The card's gradients against the CPU's: (global cosine, per tower,
    the three lowest per-tensor cosines)."""
    gc, gg = grads["card"], grads["cpu"]
    names = sorted(gc)
    glob = _cos([gc[n] for n in names], [gg[n] for n in names])
    tower = {t: _cos([gc[n] for n in names if n.startswith(t)], [gg[n] for n in names if n.startswith(t)])
             for t in ("vision.", "text.")}
    return glob, tower, sorted((_cos([gc[n]], [gg[n]]), n) for n in names)[:3]


def phase_train_grad(torch, dev):
    """One ViT-L/14 train step on the card (f32 master weights, bf16 compute)
    against the same step in f32 on the CPU, same weights and batch."""
    from image_search_tpu_torch.config import get_config
    from image_search_tpu_torch.models.convert import build_model, init_params
    from image_search_tpu_torch.train.contrastive import adamw, make_train_step

    cfg = get_config("clip-vit-large-patch14")
    state = init_params(cfg, torch.Generator(device=dev).manual_seed(1), dev, torch.float32)
    ids, pixels = _train_batch(torch, cfg, 8, seed=2)
    loss, grads, counts, _ = _step_against_cpu(torch, dev, cfg, state, ids, pixels, "train grad check")
    L_v, L_t = cfg.vision.num_layers - 1, cfg.text.num_layers - 1
    check(counts["fused_attention"] == L_v + L_t and counts["fused_attention_bwd"] == L_v + L_t,
          f"train step launches {counts}, want {L_v + L_t} of B1 and of B5")

    # the same step on the card under the packed and split routes: the
    # route's forward in every layer but the last, B5 for every backward
    routes = {}
    for route, text_entry in (("packed", "fused_attention_packed"), ("split", "fused_attention")):
        env, entry = ROUTE_SWITCHES[route]
        want = {entry: L_v}
        want[text_entry] = want.get(text_entry, 0) + L_t
        with switches(env):
            init_fn, step_fn = make_train_step(cfg, adamw(1e-5), torch.bfloat16, False, dev)
            st = init_fn(build_model(cfg, state, dev, torch.float32, trainable=True))
            _reset_counts()
            st, metrics = step_fn(st, ids, pixels)
            torch.cuda.synchronize()
            n = _read_counts()
        r_loss = float(metrics["loss"])
        del st, init_fn, step_fn
        torch.cuda.empty_cache()
        print(f"train step, {route} route {env}: loss {r_loss} (default route {loss['card']}, "
              f"diff {abs(r_loss - loss['card'])}); launches {n}")
        check(_attention_launches(n) == want and n["fused_attention_bwd"] == L_v + L_t,
              f"{route} route train step launched {n}, want {want} and B5 {L_v + L_t}")
        check(abs(r_loss - loss["card"]) <= 1e-2, f"{route} route loss {r_loss} vs default {loss['card']}")
        routes[route] = {"loss": r_loss, "launches": n}
    del state
    glob, tower, lowest = _grad_cosines(grads)
    dloss = abs(loss["card"] - loss["cpu"])
    print(f"train grad check ViT-L/14 B=8: loss card {loss['card']} cpu {loss['cpu']} (diff {dloss}); "
          f"gradient cosine global {glob} vision {tower['vision.']} text {tower['text.']} "
          f"(bound {GRAD_MIN_COS}); lowest per-tensor {lowest}; launches {counts}")
    check(all(math.isfinite(x) for x in loss.values()), f"train step losses: {loss}")
    check(glob >= GRAD_MIN_COS, f"global gradient cosine {glob} < {GRAD_MIN_COS}")
    return {"loss_card": loss["card"], "loss_cpu": loss["cpu"], "cos_global": glob,
            "cos_vision": tower["vision."], "cos_text": tower["text."], "cos_min_tensor": lowest[0],
            "routes": routes}


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def _captioned_photos(data: str, n: int = 64):
    """n BMP photos (a coloured square on another colour, sizes 64-400 px)
    with caption sidecars, the fine-tune CLI's layout."""
    import numpy as np

    from image_search_tpu_torch.ingest.decode import write_bmp24

    os.makedirs(data)
    rng = np.random.default_rng(4)
    colours = ["red", "green", "blue", "yellow", "white", "black", "purple", "orange"]
    for i in range(n):
        h, w = (int(x) for x in rng.integers(64, 400, 2))
        img = np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
        img[h // 4 : 3 * h // 4, w // 4 : 3 * w // 4] = rng.integers(0, 256, 3)
        write_bmp24(os.path.join(data, f"photo_{i:02d}.bmp"), img)
        with open(os.path.join(data, f"photo_{i:02d}.txt"), "w") as f:
            f.write(f"photo {i}: a {colours[i % 8]} square on {colours[(i // 8) % 8]}")


def _random_checkpoint(torch, dev, cfg, path: str, seed: int, what: str):
    """The reference's checkpoint file of seeded random f32 weights made on
    the card."""
    from image_search_tpu_torch.models.convert import build_model, init_params, params_to_jax, save_checkpoint

    model = build_model(cfg, init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev, torch.float32),
                        dev, torch.float32)
    t0 = time.perf_counter()
    save_checkpoint(path, params_to_jax(model), cfg)
    print(f"{what}: wrote a random checkpoint ({os.path.getsize(path) / 2**30:.2f} GiB) in "
          f"{time.perf_counter() - t0:.1f} s")
    del model
    torch.cuda.empty_cache()


def _finetune_cli(torch, argv):
    """``train.finetune.main(argv)`` with its log captured at DEBUG level ->
    dict(steps [(step, ms, loss)], evals {tag: metrics}, wall s, counts,
    counts per head dim, peak bytes, bytes held before the run)."""
    from image_search_tpu_torch.train import finetune

    logger = logging.getLogger(finetune.__name__)
    rec = _Records()
    logger.addHandler(rec)
    level = logger.level
    logger.setLevel(logging.DEBUG)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        _reset_counts()
        t0 = time.perf_counter()
        finetune.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out = dict(wall=wall, counts=_read_counts(), by_hd=_read_counts_by_hd(),
                   peak=torch.cuda.max_memory_allocated(), live=live)
    finally:
        logger.removeHandler(rec)
        logger.setLevel(level)
    out["steps"] = [r.args for r in rec.records if r.levelno == logging.DEBUG and r.msg.startswith("step ")]
    out["evals"] = {r.args[0]: r.args[2] for r in rec.records if r.msg.startswith("retrieval ")}
    return out


def _weights_moved(got, want, where) -> list:
    """For each (tower, group, name) in ``where``: the output checkpoint's
    array is finite and differs from the input's."""
    import numpy as np

    pick = lambda tree, path: tree[path[0]] if len(path) == 1 else pick(tree[path[0]], path[1:])
    return [bool(np.isfinite(pick(got, w)).all()) and not np.array_equal(pick(got, w), pick(want, w)) for w in where]


def phase_finetune(torch, dev, smi):
    """``train.finetune.main`` on the card, without and with --remat."""
    import numpy as np

    from image_search_tpu_torch.config import get_config
    from image_search_tpu_torch.models.convert import load_checkpoint

    cfg = get_config("clip-vit-large-patch14")
    L = cfg.vision.num_layers + cfg.text.num_layers
    res = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ft_") as tmp:
        weights = os.path.join(tmp, "in.safetensors")
        _random_checkpoint(torch, dev, cfg, weights, 3, "finetune ViT-L/14")
        data = os.path.join(tmp, "photos")
        _captioned_photos(data)
        want_in, _ = load_checkpoint(weights)
        for remat in (False, True):
            tag = "remat" if remat else "plain"
            out = os.path.join(tmp, f"out_{tag}.safetensors")
            argv = ["--data-dir", data, "--weights", weights, "--out", out, "--batch-size", str(TRAIN_BATCH),
                    "--steps", str(TRAIN_STEPS), "--eval-dir", data, "--checkpoint-dir", os.path.join(tmp, f"ck_{tag}"),
                    "--device", str(dev)] + (["--remat"] if remat else [])
            run = _finetune_cli(torch, argv)
            steps, evals, counts, peak, wall = run["steps"], run["evals"], run["counts"], run["peak"], run["wall"]
            losses = [a[2] for a in steps]
            step_ms = [a[1] for a in steps]
            check(len(steps) == TRAIN_STEPS, f"finetune {tag}: {len(steps)} steps logged, want {TRAIN_STEPS}")
            check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"finetune {tag}: losses {losses}")
            check(set(evals) == {"BEFORE", "AFTER"}, f"finetune {tag}: evaluations {sorted(evals)}")
            got, got_cfg = load_checkpoint(out)
            check(got_cfg == cfg, f"finetune {tag}: output config differs")
            moved = _weights_moved(got, want_in, (("vision", "blocks", "qkv_w"), ("text", "blocks", "fc_w"),
                                                  ("logit_scale",)))
            check(all(moved), f"finetune {tag}: output weights unchanged or not finite: {moved}")
            per_fwd = 2 * L if remat else L - 2  # the recompute runs B1 again
            eval_b1 = 2 * (L - 2)  # BEFORE and AFTER: one image and one text batch each
            want_b1 = TRAIN_STEPS * per_fwd + eval_b1
            want_b5 = TRAIN_STEPS * (L if remat else L - 2)
            check(counts["fused_attention"] == want_b1 and counts["fused_attention_bwd"] == want_b5,
                  f"finetune {tag}: launches {counts}, want B1 {want_b1} and B5 {want_b5}")
            ms = statistics.median(step_ms[1:])
            res[tag] = dict(ms_per_step=ms, first_step_ms=step_ms[0], pairs_per_s=TRAIN_BATCH / (ms * 1e-3),
                            peak_bytes=peak, losses=losses, counts=counts, wall_s=wall,
                            recall1_before=evals["BEFORE"]["recall@1_i2t"], recall1_after=evals["AFTER"]["recall@1_i2t"])
            print(f"finetune {tag}: ViT-L/14 B={TRAIN_BATCH} {TRAIN_STEPS} steps: {ms} ms/step (median of steps 1-"
                  f"{TRAIN_STEPS - 1}; step 0 {step_ms[0]} ms) = {TRAIN_BATCH / (ms * 1e-3)} pairs/s; peak "
                  f"{peak / 2**30:.2f} GiB; losses {losses}; recall@1 i2t {evals['BEFORE']['recall@1_i2t']} -> "
                  f"{evals['AFTER']['recall@1_i2t']}; launches {counts} (B1 {TRAIN_STEPS} x {per_fwd} + eval "
                  f"{eval_b1}, B5 {TRAIN_STEPS} x {want_b5 // TRAIN_STEPS}); CLI wall {wall:.1f} s  [{smi}]")
            torch.cuda.empty_cache()
    return res


# the ladder's full-depth fine-tune on the card: the loss of step 1 overshoots
# the first, as in ViT-L/14's CLI run, and the last must fall below it
LADDER_TRAIN_BATCH, LADDER_TRAIN_STEPS = 16, 6


def _b5_per_step(cfg, remat: bool):
    """B5's launches per train step by head dim: every layer's attention core
    but each tower's CLS/EOS-only last one, every layer under remat (its
    recompute runs the kernel in the last layer too)."""
    per = {}
    for tower in (cfg.vision, cfg.text):
        hd = tower.hidden_size // tower.num_heads
        per[hd] = per.get(hd, 0) + tower.num_layers - (0 if remat else 1)
    return per


def ladder_train_grad(torch, dev, name: str):
    """One train step of a ladder preset at full width and depth 2 on the card
    (f32 master weights, bf16 compute) against the same step in f32 on the
    CPU, same weights and batch: the global gradient cosine, and B5 launched
    at the vision tower's head dim and the text tower's."""
    from image_search_tpu_torch.config import get_config
    from image_search_tpu_torch.models.convert import init_params

    cfg = _ladder_depth2(get_config(name))
    state = init_params(cfg, torch.Generator(device=dev).manual_seed(11), dev, torch.float32)
    ids, pixels = _train_batch(torch, cfg, 8, seed=12)
    loss, grads, _, by_hd = _step_against_cpu(torch, dev, cfg, state, ids, pixels, f"ladder train grad {name} depth 2")
    del state
    want = _b5_per_step(cfg, False)
    check(by_hd.get("fused_attention_bwd") == want, f"{name} depth-2 step: B5 per head dim {by_hd}, want {want}")
    glob, tower, lowest = _grad_cosines(grads)
    print(f"ladder train grad {name} at full width and depth 2, B=8: loss card {loss['card']} cpu {loss['cpu']}; "
          f"gradient cosine global {glob} vision {tower['vision.']} text {tower['text.']} (bound {GRAD_MIN_COS}); "
          f"lowest per-tensor {lowest}; launches per head dim {by_hd}")
    check(all(math.isfinite(x) for x in loss.values()), f"{name} depth-2 train step losses: {loss}")
    check(glob >= GRAD_MIN_COS, f"{name} depth 2: global gradient cosine {glob} < {GRAD_MIN_COS}")
    return {"loss_card": loss["card"], "loss_cpu": loss["cpu"], "cos_global": glob, "cos_vision": tower["vision."],
            "cos_text": tower["text."], "cos_min_tensor": lowest[0], "launches_by_hd": by_hd}


def _step_summary(name, tag, step_ms, losses, peak, live, by_hd, want_hd, batch, smi, how):
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], f"{name} {tag}: losses {losses}")
    check(by_hd.get("fused_attention_bwd") == want_hd,
          f"{name} {tag}: B5 launches per head dim {by_hd.get('fused_attention_bwd')}, want {want_hd}")
    ms = statistics.median(step_ms[1:])
    print(f"ladder train {name} {tag} ({how}): B={batch} {len(losses)} steps: {ms} ms/step (median of steps 1-"
          f"{len(losses) - 1}; step 0 {step_ms[0]} ms) = {batch / (ms * 1e-3)} pairs/s; peak {peak / 2**30:.2f} GiB "
          f"({live / 2**30:.2f} GiB of it held before the run); losses {losses}; launches per head dim {by_hd}  [{smi}]")
    return dict(ms_per_step=ms, first_step_ms=step_ms[0], pairs_per_s=batch / (ms * 1e-3), peak_bytes=peak,
                live_bytes=live, losses=losses, launches_by_hd=by_hd, how=how)


def ladder_train_steps(torch, dev, name: str, smi):
    """LADDER_TRAIN_STEPS train steps of a ladder preset at full width and
    depth on the card, without and with remat, from seeded random f32 master
    weights made on the card, through make_train_step on the weights in
    memory (bigG's checkpoint would be a 10 GB file): one batch of
    LADDER_TRAIN_BATCH random photos repeated, so the loss must fall;
    ms/step, pairs/s, peak memory, B5's launches per head dim."""
    from image_search_tpu_torch.config import get_config
    from image_search_tpu_torch.models.convert import build_model, init_params
    from image_search_tpu_torch.train.contrastive import adamw, make_train_step

    cfg = get_config(name)
    ids, pixels = (t.to(dev) for t in _train_batch(torch, cfg, LADDER_TRAIN_BATCH, seed=13))
    res = {}
    for remat in (False, True):
        tag = "remat" if remat else "plain"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        init_fn, step_fn = make_train_step(cfg, adamw(1e-5), torch.bfloat16, remat, dev,
                                           remat_policy="dots_with_no_batch_dims_saveable" if remat else "")
        st = init_fn(build_model(cfg, init_params(cfg, torch.Generator(device=dev).manual_seed(14), dev,
                                                  torch.float32), dev, torch.float32, trainable=True))
        w0 = st.model.vision.blocks[0].qkv.weight.detach().clone()
        _reset_counts()
        losses, step_ms = [], []
        for _ in range(LADDER_TRAIN_STEPS):
            t0 = time.perf_counter()
            st, m = step_fn(st, ids, pixels)
            losses.append(float(m["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        by_hd = _read_counts_by_hd()
        moved = not torch.equal(w0, st.model.vision.blocks[0].qkv.weight.detach())
        check(moved and bool(torch.isfinite(st.model.vision.blocks[0].qkv.weight).all()),
              f"{name} {tag}: the first vision block's qkv weights did not move or are not finite")
        want = {k: v * LADDER_TRAIN_STEPS for k, v in _b5_per_step(cfg, remat).items()}
        res[tag] = _step_summary(name, tag, step_ms, losses, torch.cuda.max_memory_allocated(), live, by_hd, want,
                                 LADDER_TRAIN_BATCH, smi, "make_train_step on weights in memory")
        del st, init_fn, step_fn, w0
        torch.cuda.empty_cache()
    return res


def ladder_finetune_cli(torch, dev, name: str, smi):
    """``train.finetune.main`` on a ladder preset (H/14: a 3.7 GiB random
    checkpoint) on 64 captioned BMP photos, LADDER_TRAIN_STEPS steps of
    LADDER_TRAIN_BATCH, without and with --remat: finite and falling losses,
    output weights that moved, B5's launches per head dim; ms/step, pairs/s,
    peak memory."""
    from image_search_tpu_torch.config import get_config
    from image_search_tpu_torch.models.convert import load_checkpoint

    cfg = get_config(name)
    res = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ladder_ft_") as tmp:
        weights = os.path.join(tmp, "in.safetensors")
        _random_checkpoint(torch, dev, cfg, weights, 15, f"ladder finetune {name}")
        data = os.path.join(tmp, "photos")
        _captioned_photos(data)
        want_in, _ = load_checkpoint(weights)
        for remat in (False, True):
            tag = "remat" if remat else "plain"
            out = os.path.join(tmp, f"out_{tag}.safetensors")
            argv = ["--data-dir", data, "--weights", weights, "--out", out, "--batch-size", str(LADDER_TRAIN_BATCH),
                    "--steps", str(LADDER_TRAIN_STEPS), "--device", str(dev)] + (["--remat"] if remat else [])
            run = _finetune_cli(torch, argv)
            steps = run["steps"]
            check(len(steps) == LADDER_TRAIN_STEPS, f"{name} finetune {tag}: {len(steps)} steps logged")
            got, got_cfg = load_checkpoint(out)
            check(got_cfg == cfg, f"{name} finetune {tag}: output config differs")
            moved = _weights_moved(got, want_in, (("vision", "blocks", "qkv_w"), ("text", "blocks", "fc_w")))
            check(all(moved), f"{name} finetune {tag}: output weights unchanged or not finite: {moved}")
            del got
            want = {k: v * LADDER_TRAIN_STEPS for k, v in _b5_per_step(cfg, remat).items()}
            res[tag] = _step_summary(name, tag, [a[1] for a in steps], [a[2] for a in steps], run["peak"], run["live"],
                                     run["by_hd"], want, LADDER_TRAIN_BATCH, smi,
                                     f"finetune.main, CLI wall {run['wall']:.1f} s")
            torch.cuda.empty_cache()
        del want_in
    return res


def phase_train_ladder(torch, dev, smi):
    """Fine-tuning the OpenCLIP ladder on the card: for each preset a
    depth-2 train step against f32 on the CPU, then full-depth steps without
    and with remat (H/14 through the fine-tune CLI, bigG through
    make_train_step on its weights in memory), B5 at Hd 80 (H/14) and 104
    (bigG) in every vision layer the step differentiates, at 64 in the text
    tower's."""
    res = {"grad": {}, "steps": {}}
    for name in LADDER:
        res["grad"][name] = ladder_train_grad(torch, dev, name)
    res["steps"]["openclip-vit-H-14"] = ladder_finetune_cli(torch, dev, "openclip-vit-H-14", smi)
    res["steps"]["openclip-vit-bigG-14"] = ladder_train_steps(torch, dev, "openclip-vit-bigG-14", smi)
    return res


GATE_SEEDS = (0, 1, 2)


def gate_routes(torch, dev, smi):
    """The learned-retrieval example's towers (Hd 32, seeded random bf16
    weights) on 48 random 64 px photos and 48 captions under the packed
    route (B1p) and the fully fused blocks (B9 + B7 + B9), launches counted
    per head dim, outputs against the default route's."""
    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "examples_torch"))
    import learned_retrieval as gate

    from image_search_tpu_torch.models.block_fused import COMPOSITIONS, blocks_as
    from image_search_tpu_torch.models.clip import encode_image, encode_text
    from image_search_tpu_torch.models.convert import build_model, init_params
    from image_search_tpu_torch.ops.preprocess import fused_preprocess, pack_batch
    from image_search_tpu_torch.tokenizer import train_bpe

    F = torch.nn.functional
    caps = [t.format(c=c, pos="upper left", sz="small", th="thin") for ts in gate.TRAIN_TEMPLATES.values() for t in ts
            for c in gate.COLORS]
    tok = train_bpe(caps, vocab_size=800, context_length=16)
    cfg = gate.demo_config(tok)
    model = build_model(cfg, init_params(cfg, torch.Generator(device=dev).manual_seed(16), dev, torch.bfloat16), dev,
                        torch.bfloat16)
    rng = np.random.default_rng(17)
    u8, A_h, A_w = (torch.from_numpy(a).to(dev) for a in pack_batch(
        [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(48)], size=cfg.vision.image_size))
    ids = torch.from_numpy(tok(caps[:48]).astype(np.int64)).to(dev)
    vision = lambda: encode_image(model, fused_preprocess(u8, A_h, A_w, out_dtype=torch.bfloat16))
    text = lambda: encode_text(model, ids)
    res = {}
    with torch.inference_mode():
        img0, txt0 = vision(), text()
        for route, ctx, entry in (("packed", lambda: switches({"ISX_ATTN_PIPE": "0"}), "fused_attention_packed"),
                                  ("fully fused", lambda: blocks_as(COMPOSITIONS["fully fused"]),
                                   "fused_attention_qkv_packed")):
            with ctx():
                _reset_counts()
                img, txt = vision(), text()
                torch.cuda.synchronize()
                by_hd = _read_counts_by_hd()
            want = {entry: {32: cfg.vision.num_layers + cfg.text.num_layers - 2}}  # both towers, last blocks aside
            check(by_hd == want, f"gate towers, {route} route: launches per head dim {by_hd}, want {want}")
            cos = min(F.cosine_similarity(a.float(), b.float(), dim=-1).min().item()
                      for a, b in ((img, img0), (txt, txt0)))
            check(cos >= TOWER_MIN_COS, f"gate towers, {route} route: cosine {cos} to the default route's")
            res[route] = {"launches_by_hd": by_hd, "cos_to_default": cos}
    print(f"gate towers (Hd 32) under the other routes: {res}  [{smi}]")
    del model
    return res


def phase_learned_retrieval(torch, dev, smi):
    """The port's learned-retrieval gate (examples_torch/learned_retrieval.py)
    on the card: the full recipe on seeds 0, 1 and 2 must pass (bidirectional
    R@1 >= 0.6, served p@5 >= 0.8, every query hit), a run with lr = 0 must
    fail; B1 and B5 launched at Hd 32 and at no other head dim."""
    sys.path.insert(0, os.path.join(REPO, "examples_torch"))
    import learned_retrieval as gate

    res = {"seeds": {}}
    b1 = b5 = 0
    for seed, lr in [(s, 5e-4) for s in GATE_SEEDS] + [(0, 0.0)]:
        tag = f"seed {seed}" if lr else "lr 0"
        with tempfile.TemporaryDirectory(prefix="chip_smoke_gate_") as tmp:
            _reset_counts()
            t0 = time.perf_counter()
            m = gate.run(steps=800 if lr else 50, seed=seed, learning_rate=lr, device=str(dev), root=tmp,
                         log=lambda msg: None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            by_hd = _read_counts_by_hd()
        hds = {hd for v in by_hd.values() for hd in v}
        check(hds == {32} and by_hd.get("fused_attention", {}).get(32, 0) > 0
              and by_hd.get("fused_attention_bwd", {}).get(32, 0) > 0,
              f"gate {tag}: launches per head dim {by_hd}, want B1 and B5 at 32 only")
        passed = gate.passes_gate(m)
        print(f"gate {tag}: R@1 {m['before']['recall@1_i2t']:.3f}/{m['before']['recall@1_t2i']:.3f} -> bidirectional "
              f"{m['r1']:.3f}; served p@5 {m['served_precision_at_5']:.3f} ({m['served_queries_hit']}/"
              f"{m['served_n_queries']} queries hit); direct p@5 {m['direct_precision_at_5']:.3f}; "
              f"{m['steps_run']} steps, best segment {m['best_segment']}; loss {m['losses'][0]:.3f} -> "
              f"{m['losses'][1]:.3f}; {wall:.1f} s; launches per head dim {by_hd}; gate "
              f"{'PASSED' if passed else 'FAILED'}  [{smi}]")
        if lr:
            check(passed, f"gate {tag}: R@1 {m['r1']}, served p@5 {m['served_precision_at_5']}, hits "
                  f"{m['served_queries_hit']}/{m['served_n_queries']}")
            b1 += by_hd["fused_attention"][32]
            b5 += by_hd["fused_attention_bwd"][32]
        else:
            check(not passed, f"gate lr 0: the untrained checkpoint passed (R@1 {m['r1']}, p@5 "
                  f"{m['served_precision_at_5']}): the gate has no teeth")
        res["seeds"][tag] = {"r1": m["r1"], "served_p5": m["served_precision_at_5"], "hits": m["served_queries_hit"],
                             "direct_p5": m["direct_precision_at_5"], "steps": m["steps_run"],
                             "best_segment": m["best_segment"], "wall_s": wall, "launches_by_hd": by_hd}
    res["b1_launches"], res["b5_launches"] = b1, b5
    res["routes"] = gate_routes(torch, dev, smi)
    return res


def _kernel_class(name: str) -> str:
    low = name.lower()
    if "attn_fwd" in low:
        return "B1"
    if "attn_bwd" in low:
        return "B5"
    if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "GEMM"
    if "multi_tensor" in low or "adam" in low:
        return "optimizer"
    if "layer_norm" in low:
        return "LayerNorm"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "elementwise"


def _device_split(prof):
    """A profile's device time (ms) by kernel class, and its 8 costliest
    kernels as (ms, name)."""
    from torch.autograd import DeviceType

    split, top = {}, []
    events = prof.key_averages()
    # a user annotation (the optimizer's record_function) has a device-side
    # twin spanning its kernels: count only names that are not CPU events
    cpu_names = {evt.key for evt in events if getattr(evt, "device_type", None) == DeviceType.CPU}
    for evt in events:
        if getattr(evt, "device_type", None) != DeviceType.CUDA or evt.key in cpu_names:
            continue
        us = getattr(evt, "self_device_time_total", None)
        us = evt.self_cuda_time_total if us is None else us
        split[_kernel_class(evt.key)] = split.get(_kernel_class(evt.key), 0.0) + us / 1e3
        top.append((us / 1e3, evt.key[:60]))
    return split, sorted(top, reverse=True)[:8]


def _profiled(torch, fn):
    """One call of fn under torch.profiler -> (wall ms, device busy ms, the
    8 costliest kernels)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    split, top = _device_split(prof)
    return wall, sum(split.values()), top


def phase_train_profile(torch, dev):
    """Where one batch-64 ViT-L/14 train step spends the card's time:
    host-clock ms/step over 3 steps, then ``torch.profiler`` over one."""
    from image_search_tpu_torch.config import get_config
    from image_search_tpu_torch.models.convert import build_model, init_params
    from image_search_tpu_torch.train.contrastive import adamw, make_train_step

    cfg = get_config("clip-vit-large-patch14")
    init_fn, step_fn = make_train_step(cfg, adamw(1e-5), torch.bfloat16, False, dev)
    st = init_fn(build_model(cfg, init_params(cfg, torch.Generator(device=dev).manual_seed(5), dev, torch.float32),
                             dev, torch.float32, trainable=True))
    ids, pixels = (t.to(dev) for t in _train_batch(torch, cfg, TRAIN_BATCH, seed=6))
    st, _ = step_fn(st, ids, pixels)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        st, m = step_fn(st, ids, pixels)
        float(m["loss"])
        times.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        st, m = step_fn(st, ids, pixels)
        float(m["loss"])
        wall = (time.perf_counter() - t0) * 1e3
    split, top = _device_split(prof)
    busy = sum(split.values())
    print(f"train profile ViT-L/14 B={TRAIN_BATCH} no remat: {statistics.median(times)} ms/step host clock "
          f"({times}); profiled step wall {wall} ms, device busy "
          + (f"{busy} ms ({busy / wall:.1%}): {split}; top kernels {top}" if busy else "not measured (no device events)"))
    del st, init_fn, step_fn
    torch.cuda.empty_cache()
    return {"ms_per_step": statistics.median(times), "profiled_wall_ms": wall, "device_ms": split}


def ptxas_attention(log_path):
    """The registers and spill bytes that ptxas reported (``-Xptxas -v``, in
    the build's nvcc.log) for each instantiation of the attention forward
    kernel: [{Hd, norm_p, key_tiles, registers, spill_stores, spill_loads}]."""
    import re

    rows, cur = [], None
    for line in open(log_path, errors="replace"):
        m = re.search(r"Compiling entry function '_ZN8attn_fwd15attn_fwd_kernelILi(\d+)ELb(\d)ELi(\d+)E", line)
        if m:
            cur = {"Hd": int(m[1]), "norm_p": m[2] == "1", "key_tiles": int(m[3])}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur |= {"spill_stores": int(m[1]), "spill_loads": int(m[2])}
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows.append(cur | {"registers": int(m[1])})
            cur = None
    return sorted(rows, key=lambda r: (r["Hd"], r["norm_p"], r["key_tiles"]))


def ptxas_attention_bwd(log_path):
    """ptxas's registers and spill bytes for each instantiation of B5's two
    passes: [{Hd, pass, key_tiles (row pass), probe, registers,
    spill_stores, spill_loads}]."""
    import re

    rows, cur = [], None
    for line in open(log_path, errors="replace"):
        m = re.search(r"Compiling entry function '_ZN8attn_bwd\d+attn_bwd_(rows|cols)_kernelILi(\d+)E(?:Li(\d+)E)?Lb(\d)E",
                      line)
        if m:
            cur = {"Hd": int(m[2]), "pass": m[1], "key_tiles": int(m[3]) if m[3] else None, "probe": m[4] == "1"}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur |= {"spill_stores": int(m[1]), "spill_loads": int(m[2])}
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows.append(cur | {"registers": int(m[1])})
            cur = None
    return sorted(rows, key=lambda r: (r["Hd"], r["pass"], r["probe"], r["key_tiles"] or 0))


def _laps():
    """lap(name) prints the seconds since the previous lap (or the first call)."""
    last = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        print(f"phase {name}: {now - last[0]:.1f} s")
        last[0] = now

    return lap


def entry(name, source, replaces, path_launches, row, max_abs_err):
    """One kernel of the ``kernels`` line."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    return {"name": name, "route": "cuda", "source": "image_search_tpu_torch/csrc/" + source,
            "replaces": "image_search_tpu/ops/" + replaces, "launches": path_launches,
            "max_abs_err": max_abs_err, **{k: row[k] for k in keys}}


def ladder_entries(ladder):
    """The ``kernels`` line's entries at the ladder's vision head dims, from
    phase_ladder's result: launches at that head dim as the wrappers counted
    them, of B1 in the preset's served /scan + /search and /search_image, of
    the others in the vision forward on their route (B7: the fully fused
    blocks)."""
    rows = []
    for name, hd in LADDER.items():
        res = ladder["kernels"][hd]
        for kernel, replaces, core in LADDER_ENTRIES:
            if core == "grouped":
                launches = ladder["server"][name]["vision_b1"]
            else:
                route = "fully fused" if core == "qkv_packed" else core
                launches = ladder["towers"][name]["routes"][route]["launches_by_hd"].get(kernel, {}).get(hd, 0)
            err = max(res[core]["max_abs_err"], res[core].get("ragged_max_abs_err", 0.0),
                      res["split"]["max_abs_err"] if core == "padded" else 0.0)
            rows.append(entry(f"{kernel}_hd{hd}", f"attention_fwd_hd{hd}.cu", replaces, launches, res[core], err))
    return rows


def new_head_dim_entries(bwd, ladder, train_ladder, learned):
    """The ``kernels`` line's entries of B5 at Hd 32, 80 and 104 and of the
    forward family at Hd 32. Launches as the wrappers counted them: B5 at 80
    and 104 in the ladder's full-depth fine-tune (H/14's CLI runs, bigG's
    steps, with and without remat), B1 and B5 at 32 in the learned-retrieval
    gate's three seeds, B1p and B7 at 32 in the gate's towers on those routes."""
    rows = []
    for hd, name in ((80, "openclip-vit-H-14"), (104, "openclip-vit-bigG-14")):
        launches = sum(v["launches_by_hd"]["fused_attention_bwd"][hd] for v in train_ladder["steps"][name].values())
        row = bwd[(hd, 257)]
        err = max(row["max_abs_err"], bwd[(hd, "ragged")]["max_abs_err"])
        rows.append(entry(f"fused_attention_bwd_hd{hd}", f"attention_bwd_hd{hd}.cu", "attention.py:122", launches, row,
                          err))
    err = max(bwd[(32, 65)]["max_abs_err"], bwd[(32, 16)]["max_abs_err"], bwd[(32, "ragged")]["max_abs_err"])
    rows.append(entry("fused_attention_bwd_hd32", "attention_bwd_hd32.cu", "attention.py:122", learned["b5_launches"],
                      bwd[(32, 65)], err))
    k32, gate_b1 = ladder["kernels"][32], ladder["gate_b1"]
    err = max(gate_b1[65]["max_abs_err"], gate_b1[16]["max_abs_err"], k32["grouped"]["max_abs_err"],
              k32["grouped"]["ragged_max_abs_err"])
    rows.append(entry("fused_attention_hd32", "attention_fwd_hd32.cu", "attention.py:665", learned["b1_launches"],
                      gate_b1[65], err))
    for kernel, replaces, core, route in (("fused_attention_packed", "attention.py:29", "packed", "packed"),
                                          ("fused_attention_qkv_packed", "attention.py:276", "qkv_packed",
                                           "fully fused")):
        launches = learned["routes"][route]["launches_by_hd"][kernel][32]
        err = max(k32[core]["max_abs_err"], k32[core]["ragged_max_abs_err"])
        rows.append(entry(f"{kernel}_hd32", "attention_fwd_hd32.cu", replaces, launches, k32[core], err))
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import image_search_tpu_torch
    from image_search_tpu_torch import _build

    check("jax" not in sys.modules, "the port imported jax")
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(smi)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    for mod in ("aiohttp", "safetensors", "PIL", "triton"):
        try:
            __import__(mod)
            print(f"optional package {mod}: importable")
        except ImportError:
            print(f"optional package {mod}: absent")
    image_search_tpu_torch.check_precision()
    preset = {k: os.environ.pop(k) for k in ROUTE_ENV if k in os.environ}
    if preset:
        print(f"attention route switches cleared (each phase sets its own): {preset}")
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}")

    t0 = time.perf_counter()
    lib_path = _build.build()
    print(f"build: {lib_path} in {time.perf_counter() - t0:.2f} s "
          f"({'compiled' if _build.build_seconds is not None else 'cached'})")
    _build.lib()
    for row in ptxas_attention(lib_path.parent / "nvcc.log"):
        print(f"ptxas: attention forward Hd={row['Hd']} {'B1p/B6/B7' if row['norm_p'] else 'B1'} "
              f"key tiles={row['key_tiles']}: {row['registers']} registers, spill stores {row['spill_stores']} B, "
              f"spill loads {row['spill_loads']} B")
    for row in ptxas_attention_bwd(lib_path.parent / "nvcc.log"):
        what = f"row pass key tiles={row['key_tiles']}" if row["pass"] == "rows" else "column pass"
        print(f"ptxas: attention backward (B5) Hd={row['Hd']} {what}{' probe' if row['probe'] else ''}: "
              f"{row['registers']} registers, spill stores {row['spill_stores']} B, spill loads {row['spill_loads']} B")

    gen = torch.Generator(device=dev).manual_seed(0)
    lap = _laps()
    kern = phase_kernels(torch, gen, dev)
    lap("kernels")
    towers = phase_towers(torch, gen, dev, smi)
    lap("towers")
    launches, dup = phase_server(torch, dev)
    lap("server + duplicates")
    served = phase_server_routes(torch, dev)
    lap("server routes")
    ts_launches, ts_times, ts = phase_twostage(torch, dev)
    lap("two-stage")
    serving = phase_serving(torch, dev)
    sv_launches = serving["batched"]["launches"]
    lap("serving")
    ladder = phase_ladder(torch, gen, dev, smi)
    lap("ladder")
    grad = phase_train_grad(torch, dev)
    ft = phase_finetune(torch, dev, smi)
    prof = phase_train_profile(torch, dev)
    lap("training")
    train_ladder = phase_train_ladder(torch, dev, smi)
    lap("ladder training")
    learned = phase_learned_retrieval(torch, dev, smi)
    lap("learned retrieval")
    check("jax" not in sys.modules, "the port imported jax")
    check(not any(m == "image_search_tpu" or m.startswith("image_search_tpu.") for m in sys.modules),
          "the port imported the JAX package")


    print(smi)
    print(json.dumps({"kernels": [
        entry("fused_attention", "attention.cu", "attention.py:665",
              launches["fused_attention"] + ts_launches["fused_attention"] + sv_launches["fused_attention"],
              kern[("grouped", 257)],
              max(kern[("grouped", 257)]["max_abs_err"], kern[("grouped", 77)]["max_abs_err"])),
        entry("fused_attention_packed", "attention.cu", "attention.py:29",
              served["packed"]["launches"]["fused_attention_packed"], kern[("packed", 257)],
              max(kern[("packed", 257)]["max_abs_err"], kern[("packed", 77)]["max_abs_err"])),
        entry("stream_scores_int8", "score_stream.cu", "score_stream.py:67",
              dup["legacy"]["counts"]["stream_scores_int8"] + ts_launches["stream_scores_int8"]
              + sv_launches["stream_scores_int8"],
              kern[("score", 1024, False)],
              max(v["max_abs_err"] for key, v in kern.items() if key[0] == "score")),
        entry("blockpair_mask", "blockmax.cu", "blockmax.py:66",
              dup["certified"]["counts"]["blockpair_mask"], kern[("mask", CERT_ROWS)], 0.0),
        entry("blockpair_values", "blockmax.cu", "blockmax.py:125",
              dup["approximate"]["counts"]["blockpair_values"], kern[("values", 65_536)],
              kern[("values", 65_536)]["max_abs_err"]),
        entry("fused_attention_bwd", "attention_bwd.cu", "attention.py:122",
              ft["plain"]["counts"]["fused_attention_bwd"], kern[("attention_bwd", 257)],
              max(kern[("attention_bwd", 257)]["max_abs_err"], kern[("attention_bwd", 77)]["max_abs_err"])),
        entry("fused_attention_split_padded", "attention.cu", "attention.py:492",
              served["padded"]["launches"]["fused_attention_split_padded"], kern[("padded", 264)],
              max(kern[("padded", 264)]["max_abs_err"], kern[("split", 257)]["max_abs_err"])),
        entry("fused_attention_qkv_packed", "attention.cu", "attention.py:276",
              towers["fused"]["fully fused"]["launches"]["fused_attention_qkv_packed"], kern[("qkv_packed", 257)],
              max(kern[("qkv_packed", 257)]["max_abs_err"], kern[("qkv_packed", 77)]["max_abs_err"])),
        entry("fused_qkv_attention", "qkv_attention.cu", "attention.py:374", kern["qkv_attention_launches"],
              kern[("qkv_attention", 257)],
              max(kern[("qkv_attention", 257)]["max_abs_err"], kern[("qkv_attention", 77)]["max_abs_err"])),
        entry("ln_matmul", "ln_matmul.cu", "ln_matmul.py:42",
              towers["fused"]["fully fused"]["launches"]["ln_matmul"], kern[("ln_matmul", 3072)],
              max(kern[("ln_matmul", 3072)]["max_abs_err"], kern[("ln_matmul", 4096)]["max_abs_err"])),
        *ladder_entries(ladder),
        *new_head_dim_entries(kern["attention_bwd_hd"], ladder, train_ladder, learned),
    ], "img_per_s": towers["img_per_s"],
        "route_img_per_s": {r: v["img_per_s"] for r, v in towers["routes"].items()},
        "fused_block_img_per_s": {r: v["img_per_s"] for r, v in towers["fused"].items()},
        "train_ms_per_step": ft["plain"]["ms_per_step"], "train_pairs_per_s": ft["plain"]["pairs_per_s"],
        "train_remat_ms_per_step": ft["remat"]["ms_per_step"],
        "train_grad_cos": grad["cos_global"],
        "duplicates_ms": {k: v["ms"] for k, v in dup.items()},
        "twostage": {"http_ms": ts_times, "rows": ts["rows"], "k": ts["k"],
                     **{f"{d}_B{b}": {key: ts[(d, b)][key] for key in ("twostage_ms", "full_ms", "m", "split", "certified")}
                        for d in ("float32", "bfloat16") for b in (1, 4)},
                     "search_twostage_ms": ts["search_twostage_ms"], "search_ms": ts["search_ms"],
                     "flat": ts["flat"]},
        "duplicates_direct_ms": {k: {p: v[p] for p in ("sketch_ms", "phase1_ms", "rescore_ms")}
                                 for k, v in dup.items() if k in ("certified", "approximate")},
        "serving": {"batched": serving["batched"]["batched"], "unbatched": serving["batched"]["unbatched"],
                    "b2_penalty_launches": sv_launches["stream_scores_int8_penalty"],
                    "scan_img_per_s": {"cache_cold": serving["batched"]["scan_cold_img_per_s"],
                                       "cache_warm": serving["batched"]["scan_warm_img_per_s"]},
                    "first_request": serving["first_request"],
                    "bf16_10m": {f"B{b}": serving["bf16_10m"][b] for b in (1, 8)}},
        "ladder": {name: {"img_per_s": ladder["towers"][name]["img_per_s"],
                          "text_ms": ladder["towers"][name]["text_ms"],
                          "cos_image": ladder["towers"][name]["cos_image"],
                          "cos_text": ladder["towers"][name]["cos_text"],
                          "scan_s": ladder["server"][name]["scan_s"],
                          "search_ms": ladder["server"][name]["search_ms"],
                          "search_image_ms": ladder["server"][name]["search_image_ms"],
                          "peak_gib": ladder["server"][name]["peak_gib"]} for name in LADDER}
        | {"bigg_text_b1_ms": ladder["bigg_text"]["ms"],
           "ln_matmul_ms": {f"K{k}_N{n}": v["ms"] for (k, n), v in ladder["ln_matmul"].items()},
           "int8_scores_ms": {f"D{d}_B{b}": v["ms"] for (d, b), v in ladder["scores"].items()}},
        "ladder_train": {name: {"grad_cos": train_ladder["grad"][name]["cos_global"],
                                **{f"{tag}_ms_per_step": v["ms_per_step"] for tag, v in train_ladder["steps"][name].items()},
                                **{f"{tag}_pairs_per_s": v["pairs_per_s"] for tag, v in train_ladder["steps"][name].items()},
                                **{f"{tag}_peak_gib": v["peak_bytes"] / 2**30 for tag, v in train_ladder["steps"][name].items()}}
                         for name in LADDER},
        "learned_retrieval": {tag: {k: v[k] for k in ("r1", "served_p5", "hits", "steps", "wall_s")}
                              for tag, v in learned["seeds"].items()}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
