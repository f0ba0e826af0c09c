"""Full-scan scores: kernel B2 for int8 rows, its plain PyTorch version, the
int8 query quantizer, and :func:`float_scores` for f32 and bf16 rows.

``stream_scores_int8`` is the port of ``image_search_tpu/ops/
score_stream.py::stream_scores_int8`` (Pallas ``_kernel``/``_kernel_pen``).
On a CUDA tensor it launches ``csrc/score_stream.cu``; on a CPU tensor it runs
:func:`scores_int8_reference`. The two are bitwise equal, and both are
bitwise equal to the reference's s32 path: the int8 dot is summed exactly
(the kernel in int32; the plain version in f32, exact while every partial
sum stays below 2^24, which 127 * 127 * D does for any int8 operands at
D <= 1040, and in f64 at wider rows: OpenCLIP H/14's 1024 takes f32,
bigG's 1280 f64), its conversion to f32 rounds once, and the epilogue
rounds after every step in the reference's order.
"""

from __future__ import annotations

import torch

from image_search_tpu_torch import _build

NEG_INF = torch.finfo(torch.float32).min
BN = 128  # slab rows per CTA tile of the kernel (csrc/score_stream.cu: kBN)
NORM_ROWS = 32  # rows of every norm reduction: the batcher's largest batch


def row_norms(x: torch.Tensor) -> torch.Tensor:
    """l2 norms of the rows of [B, D] -> [B, 1], each reduced inside a block
    of ``NORM_ROWS`` rows (zero rows pad the last). torch picks a
    reduction's order by the tensor's shape on the card, so a query's norm
    -- and with it its int8 rounding -- would depend on the other queries of
    its batch; one block shape gives every row the same order at any B (a
    batched search answers each query exactly as it answers it alone)."""
    b = x.shape[0]
    xp = torch.nn.functional.pad(x, (0, 0, 0, -b % NORM_ROWS)).contiguous()
    blocks = [torch.linalg.vector_norm(xp[i : i + NORM_ROWS], dim=-1, keepdim=True) for i in range(0, max(b, 1), NORM_ROWS)]
    return (blocks[0] if len(blocks) == 1 else torch.cat(blocks))[:b]


def float_scores(q, rows):
    """l2-normalized f32 queries [B, D] x f32 or bf16 rows [n, D] -> [B, n]
    f32 scores (the reference's ``shard_scores``). bf16 rows are dotted with
    the query cast to bf16: every product is exact in f32 and the sums are
    f32, so the scores leave in f32 (a bf16 output would round each score to
    8 bits and tie thousands of rows at the top-k boundary). On the card that
    is one cuBLAS GEMM with an f32 output; the CPU has none, so there both
    operands are upcast (the same products, summed in f32)."""
    if rows.dtype != torch.bfloat16:
        return q @ rows.T
    qb = q.to(torch.bfloat16)
    if rows.device.type == "cuda":
        return torch.mm(qb, rows.T, out_dtype=torch.float32)
    return qb.float() @ rows.float().T


def quantize_rows_int8(x: torch.Tensor):
    """[N, D] f32 -> (int8 values, f32 per-row scales), symmetric.

    Same op order as ``parallel/sharded_search.py::quantize_rows_int8`` as the
    reference's search runs it: amax, ``max(amax, 1e-12) / 127``,
    ``clip(round(x / scale), -127, 127)`` with half-to-even rounding
    (``torch.round``, like ``jnp.round``). Compiled, XLA turns the division
    by the constant 127 into a multiply by its f32 reciprocal (about 4% of
    scales then differ from a true division by one ulp), and torch's CUDA
    division by a Python scalar does the same; the multiply is written out
    so that the CPU and the card give the reference's served scales."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def quantize_queries_int8(x: torch.Tensor):
    """Raw [B, D] f32 queries -> (int8 values, f32 scales) of their
    l2-normalized form, rounded as the reference's compiled search rounds
    them (``index/index.py::_search_local``: ``_l2`` then
    ``quantize_rows_int8``).

    Mathematically ``round((x / n) / scale)``; XLA's simplifier rewrites
    ``(x / n) / scale`` into ``x / (n * scale)``, which rounds differently
    near .5 (about 0.4% of elements of small-integer queries, where exact
    ties are common). The port computes that form so that its int8 answers
    are the reference's bitwise."""
    n = torch.clamp(row_norms(x), min=1e-12)
    scale = torch.clamp((x / n).abs().amax(dim=-1, keepdim=True), min=1e-12) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x / (n * scale)), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def scores_int8_reference(rows, qi, qs, scales, limit: int, pens=None):
    """Plain version: [B, N] f32 masked scores."""
    exact = torch.float32 if 127 * 127 * rows.shape[1] < 2**24 else torch.float64  # see the module docstring
    s = (qi.to(exact) @ rows.to(exact).T).float()
    s = s * qs[:, None]
    s = s * scales[None, :]
    if pens is not None:
        s = s + pens[None, :]
    gpos = torch.arange(rows.shape[0], device=rows.device)
    return torch.where(gpos[None, :] < limit, s, torch.full_like(s, NEG_INF))


def _check_cuda_operands(rows, qi, qs, scales, pens):
    dev = rows.device
    n, d = rows.shape
    b = qi.shape[0]
    want = [
        ("rows", rows, torch.int8, (n, d)),
        ("qi", qi, torch.int8, (b, d)),
        ("qs", qs, torch.float32, (b,)),
        ("scales", scales, torch.float32, (n,)),
    ]
    if pens is not None:
        want.append(("pens", pens, torch.float32, (n,)))
    for name, t, dtype, shape in want:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"score kernel: {name} must be a contiguous {dtype} {shape} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if d % 4:
        raise ValueError(f"score kernel: D={d} must be a multiple of 4")


def score_plan(b: int, n: int, d: int):
    """The one launch of a call: queries per CTA tile (BM: 16 for B <= 16,
    64 up to 64 queries, 128 above), slab rows per tile (BN) and the tile
    grid (query tiles, row tiles), launched as one dimension of
    ``m_tiles * n_tiles`` CTAs, query tiles fastest. D only has to be a
    multiple of 4: the kernel masks its last step over D."""
    bm = 16 if b <= 16 else 64 if b <= 64 else 128
    return dict(bm=bm, bn=BN, grid=(-(-b // bm), -(-n // BN)))


def stream_scores_int8(rows, qi, qs, scales, limit: int, pens=None):
    """Masked cosine scores [B, N] f32 in one pass over an int8 slab.

    rows [N, D] int8, qi [B, D] int8, qs [B] f32, scales [N] f32, pens [N] f32
    additive penalties (0 live, NEG_INF tombstoned) or None; rows at
    position >= ``limit`` score NEG_INF. One launch for any batch
    (:func:`score_plan`). ``launches`` counts every launch,
    ``penalty_launches`` those with ``pens`` (the reference's ``_kernel_pen``)."""
    if rows.device.type == "cpu":
        return scores_int8_reference(rows, qi, qs, scales, limit, pens)
    if rows.device.type != "cuda":
        raise ValueError(f"stream_scores_int8: no route for device {rows.device}")
    _check_cuda_operands(rows, qi, qs, scales, pens)
    n, d = rows.shape
    b = qi.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=rows.device)
    limit = max(-(2**31), min(int(limit), 2**31 - 1))
    rc = _build.lib().isx_score_int8(
        rows.data_ptr(), qi.data_ptr(), qs.data_ptr(), scales.data_ptr(),
        None if pens is None else pens.data_ptr(), out.data_ptr(),
        n, d, b, limit, score_plan(b, n, d)["bm"], _build.stream_handle(rows.device),
    )
    _build.check(rc, "score kernel launch")
    stream_scores_int8.launches += 1
    if pens is not None:
        stream_scores_int8.penalty_launches += 1
    return out


stream_scores_int8.launches = 0
stream_scores_int8.penalty_launches = 0
