"""Two-stage EXACT top-k: a sketch-bound pass, then a certified exact rescore.

Port of ``image_search_tpu/index/twostage.py`` for one device: the sketch
build (PR 2's half, which the duplicate scan in ``index/dupscan.py`` also
reads) and the search (``twostage_topk``, ``twostage_topk_block``).

Build (one streaming pass over the slabs):
  - W [D, d_s]: orthonormal basis of the corpus's top-d_s principal
    directions (host SVD of a row sample, :func:`fit_basis`);
  - per row i with (dequantized) stored vector r_i:
      s_i = W^T r_i           the sketch, [d_s] f32 or bf16
      t_i = ||r_i - W s_i||   the residual norm, inflated by ``SLACK_T``.

Query q~ (the vector the full scan really dots rows against: for int8 slabs
quantize(q) * scale, integer-exact in f32): q_s = W^T q~, q_t = ||q~ - W q_s||.
Because W is orthonormal, q~ . r_i = q_s . s_i + (q~ - W q_s) . (r_i - W s_i),
so by Cauchy-Schwarz q~ . r_i <= q_s . s_i + q_t * t_i =: UB_i. The same
holds between two rows, which is what the duplicate scan bounds.

Search: (1) UB pass over the sketches only (260 B a row for f32 sketches,
132 B for bf16, against 768 B an int8 row), choosing candidates; (2) exact
rescore of the candidates with the full scan's own arithmetic, top-k,
tau = the k-th score; (3) CERTIFICATE: if the largest UB outside the
candidates is <= tau - ``FULL_SCAN_SLACK[dtype]``, no other row can enter
the top-k and the answer is the full scan's. Otherwise the caller falls back
to the full scan, so the answer never depends on the data, only the speed.

Precision on this port. The reference inflates UB by ``SLACK`` (1e-4, f32
reduction error, gamma_768 ~ 9.2e-5) and charges ``FULL_SCAN_SLACK`` for
its TPU full scan, whose DEFAULT-precision f32 dots round operands to bf16.
Here every f32 matmul is full f32 (no TF32,
``image_search_tpu_torch.check_precision``), on the card and on the CPU:
  - the sketch dots (build ``r @ W``, query ``q~ @ W``, the f32 stage-1 dot)
    are f32-accurate, as the reference's ``Precision.HIGHEST`` ones are;
  - bf16 sketches: q_s is rounded to bf16 (as the reference does) and both
    operands are upcast to f32 for the dot. A product of two bf16 values is
    exact in f32, so the dot errs only by f32 reduction (``SLACK``), and the
    two bf16 roundings are charged to ``ub_slack`` (``_sketch_chunk``). A
    bf16 x bf16 matmul in torch would round its result to bf16 (2^-8
    relative, ~40x ``SLACK``) and break the bound;
  - the f32 full scan (``q @ slab.T``) and the rescore (``q @ rows.T`` on
    the gathered rows) differ from the real dot only by f32 reduction
    order, <= gamma_D each, far inside the reference's f32 charge
    (2^-8 (2 + 2^-8) + 5e-4 ~ 8.4e-3). So the reference's constants stay
    sound here, only looser than needed: some queries fall back that a
    tighter constant would certify. They are kept so that the port
    certifies exactly the queries the reference does (the CPU tests
    require equal counts); a tighter constant is speed work;
  - int8 slabs charge zero: the rescore is kernel B2 itself, on the gathered
    rows, so its scores are the full scan's bit for bit.

``SLACK`` at the row width D. Three f32 reductions of length D enter UB:
the sketch s_i = W^T r_i (one D-long dot a component), the query's
q_s = W^T q~, and ||r_i||^2 in t_i (and ||q~||^2 in q_t). For vectors of
norm about 1 each is within gamma_D ~ D * 2^-23 of its real value in the
worst case (rounding errors of one sign; random ones give ~sqrt(D) * 2^-24),
the account the reference gives at D = 768 (gamma_768 ~ 9.2e-5) to size its
1e-4. That account grows with D: gamma_1024 ~ 1.22e-4 and gamma_1280 ~
1.53e-4, both over 1e-4. So the inflation follows D (:func:`slack_for_dim`):
1e-4 * D / 768 above 768 (1.33e-4 at OpenCLIP H/14's 1024, 1.67e-4 at
bigG's 1280), the same margin over gamma_D at every width, and the
reference's 1e-4 at 768 and below, so ViT-L/14's answers (and every
narrower test's) stay the JAX package's bit for bit. A larger inflation only
admits more candidates or fails more certificates (a full-scan fallback):
never a wrong answer. The duplicate scan (``index/dupscan.py``) bounds
row-row dots from the same sketches, so its pair slack follows D the same
way; its own 65-term accumulation on the tensor cores stays within 2e-5.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from image_search_tpu_torch.ops.score_stream import float_scores, quantize_queries_int8, stream_scores_int8
from image_search_tpu_torch.ops.topk import exact_topk, stable_topk

NEG_INF = float(torch.finfo(torch.float32).min)
SLACK = 1e-4   # UB inflation at D <= SLACK_DIM: bounds f32 reduction error of either route
SLACK_DIM = 768  # the row width the reference sized SLACK for (gamma_768 ~ 9.2e-5)
SLACK_T = 1e-5  # residual-norm-squared inflation before the sqrt
DEFAULT_SKETCH_DIM = 64
DEFAULT_CANDIDATES = 4096
BLOCK = 128
DEFAULT_BLOCKS = 4096

# The certificate's deduction for the full scan's rounding, the reference's
# constants (module doc: sound here, and looser than the port needs). They
# also feed the certifiability estimate of ``VectorIndex.build_sketch``.
FULL_SCAN_SLACK = {
    "int8": 0.0,
    "bfloat16": (2.0 ** -8) * (1.0 + 2.0 ** -8) + 5e-4,
    "float32": (2.0 ** -8) * (2.0 + 2.0 ** -8) + 5e-4,
}


def slack_for_dim(dim: int) -> float:
    """UB inflation for rows of width ``dim``: ``SLACK`` up to SLACK_DIM,
    then in proportion to D (the module doc's error argument)."""
    return SLACK * max(int(dim), SLACK_DIM) / SLACK_DIM


def estimate_certifiable_fraction(
    sample_rows: np.ndarray,    # [n, D] f32 (dequantized, ~unit) row sample
    basis: np.ndarray,          # [D, d_s] the fitted orthonormal basis
    corpus_size: int,
    k: int,
    candidate_rows: int,
    fs_slack: float,
    ub_slack: float = 0.0,
    n_queries: int = 256,
) -> float:
    """Predict, at build time, the fraction of queries the certificate will
    pass — so a spectrally flat corpus can skip PUBLISHING the sketch
    instead of paying TWOSTAGE_DISABLE_AFTER failed bound passes (~40 ms
    each at 10M) before adaptive disable kicks in (round-3 verdict item #7).

    Method: replay the certificate on the row sample itself. Sample rows
    stand in for queries (leave-self-out); ranks are FRACTION-scaled so the
    sample-size quantiles estimate the corpus-size ones: tau becomes the
    ceil(k/N * n)-th best exact score, rest_max the (c/N * n + 1)-th best
    UB. This is row-granularity (the v1 selection) — the shipped block
    selection's certificate is at least as tight (twostage_topk_block
    module comment), so the estimate errs toward NOT publishing, which is
    the cheap mistake (fallback = full scan, always exact).

    Purely advisory: the gate affects SPEED only — a published sketch is
    still certified per query, an unpublished one just means full scans."""
    x = np.asarray(sample_rows, np.float32)
    n = x.shape[0]
    if n < 32 or corpus_size <= 0 or k >= corpus_size:
        # tiny corpora fall back by construction anyway; a k that covers the
        # corpus is clamped to it by the search, whose candidates then cover
        # every row (certified by construction). There the reference's rank
        # scaling raises (k_s > n; ROADMAP C.6)
        return 1.0
    w = np.asarray(basis, np.float32)
    s = x @ w                                             # [n, d_s]
    t = np.sqrt(
        np.maximum((x * x).sum(1) - (s * s).sum(1), 0.0) + SLACK_T
    )                                                     # [n]
    qi = np.unique(np.linspace(0, n - 1, min(n_queries, n)).astype(np.int64))
    q, qs, q_res = x[qi], s[qi], t[qi]
    exact = q @ x.T                                       # [nq, n]
    infl = np.sqrt((qs * qs).sum(1)) * ub_slack + slack_for_dim(x.shape[1])   # [nq]
    ub = qs @ s.T + q_res[:, None] * t[None, :] + infl[:, None]
    # leave-self-out: a text query is not a corpus row, and self's 1.0
    # score would make every flat corpus look certifiable
    ar = np.arange(len(qi))
    exact[ar, qi] = -np.inf
    ub[ar, qi] = -np.inf
    k_s = max(1, round(k / corpus_size * n))
    c_s = int(min(max(k_s, round(candidate_rows / corpus_size * n)), n - 2))
    tau = np.partition(exact, n - k_s, axis=1)[:, n - k_s]
    rest = np.partition(ub, n - (c_s + 1), axis=1)[:, n - (c_s + 1)]
    return float(np.mean(rest <= tau - fs_slack))


class SketchState(NamedTuple):
    """Device-resident sketch aligned with the index's emb slabs."""

    basis: torch.Tensor              # [D, d_s] f32 orthonormal
    sketches: Tuple[torch.Tensor, ...]  # per slab: [n_b, d_s] f32 or bf16
    resid: Tuple[torch.Tensor, ...]     # per slab: [n_b] f32 residual norms
    built_rows: int                  # corpus size the sketch covers
    # UB inflation for lossy sketch storage (bf16): the max over rows of
    # ||a_i - round(a_i)|| + 2^-8 ||round(a_i)|| (see _sketch_chunk). Zero
    # for f32 sketches. A 0-dim f32 tensor on the index's device.
    ub_slack: Optional[torch.Tensor] = None


def fit_basis(sample_rows: np.ndarray, d_s: int = DEFAULT_SKETCH_DIM) -> np.ndarray:
    """Top-d_s principal directions of a (dequantized) row sample.

    Host-side float64 SVD; orthonormality error ~1e-15 is absorbed by
    ``SLACK``. The basis only affects SPEED (bound tightness) — any
    orthonormal W keeps the method exact — so a few-10k-row sample is
    plenty.
    """
    x = np.asarray(sample_rows, np.float64)
    assert x.ndim == 2 and x.shape[0] >= 1
    d_s = min(d_s, min(x.shape))
    # principal directions of the raw second moment (not mean-centered:
    # the bound is about energy capture, not variance)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return np.ascontiguousarray(vt[:d_s].T.astype(np.float32))  # [D, d_s]


def _dequant_rows(slab: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    r = slab.float()
    if scale is not None:
        r = r * scale[:, None]
    return r


def _sketch_chunk(slab, scale, basis, to_bf16: bool = False):
    """One chunk -> (sketch, inflated residual norm, ub_slack 0-dim tensor).

    ``to_bf16`` stores the sketch in bfloat16. The bound stays rigorous:
    with a = W^T r and a~ = bf16(a),
        q_s . a  <=  q_s . a~  +  ||q_s|| (||a - a~|| + 2^-8 ||a~||)
    where the 2^-8 ||a~|| term absorbs rounding q_s itself to bf16 (bf16
    round-to-nearest has relative error <= 2^-8 per element); the chunk's
    maximum of the bracket is returned as the inflation."""
    r = _dequant_rows(slab, scale)
    s = r @ basis  # full f32: the identity needs s = W^T r to f32 accuracy
    nrm2 = (r * r).sum(dim=1)
    ss = (s * s).sum(dim=1)
    t = torch.sqrt(torch.clamp(nrm2 - ss, min=0.0) + SLACK_T)
    if not to_bf16:
        return s, t, torch.zeros((), dtype=torch.float32, device=s.device)
    s16 = s.to(torch.bfloat16)
    s16f = s16.float()
    delta = torch.sqrt(((s - s16f) ** 2).sum(dim=1))
    anorm = torch.sqrt((s16f * s16f).sum(dim=1))
    return s16, t, (delta + anorm * (2.0 ** -8)).max()


# rows per sketch step: the dequantized f32 temporary of a chunk is at most
# 262144 x 768 x 4 B = 805 MB, where a whole 1M-row slab would take 3 GB
SKETCH_CHUNK_ROWS = 262_144


def sketch_slab(
    slab: torch.Tensor,                  # [n, D] f32/bf16/int8 rows
    scale: Optional[torch.Tensor],       # [n] f32 for int8, else None
    basis: torch.Tensor,                 # [D, d_s] f32
    to_bf16: bool = False,
):
    """One slab -> (sketch [n, d_s], inflated residual norms [n] f32,
    ub_slack 0-dim f32 tensor — see _sketch_chunk)."""
    n = slab.shape[0]
    g = SKETCH_CHUNK_ROWS
    if n <= g:
        return _sketch_chunk(slab, scale, basis, to_bf16)
    parts_s, parts_t, slacks = [], [], []
    for off in range(0, n, g):
        end = min(off + g, n)
        sc = None if scale is None else scale[off:end]
        s, t, d = _sketch_chunk(slab[off:end], sc, basis, to_bf16)
        parts_s.append(s)
        parts_t.append(t)
        slacks.append(d)
    return torch.cat(parts_s), torch.cat(parts_t), torch.stack(slacks).max()


# -- the search ------------------------------------------------------------------


def _slab_dtype_name(slab: torch.Tensor) -> str:
    return str(slab.dtype).removeprefix("torch.")


def _exact_query_vector(queries: torch.Tensor, is_int8: bool):
    """Raw [B, D] queries -> (the vector the full scan really dots rows
    against, int8 values, f32 scales); the last two are None for float
    slabs. int8 queries are quantized as the full scan quantizes them
    (``quantize_queries_int8``: the reference's compiled rounding)."""
    if is_int8:
        qi, qs = quantize_queries_int8(queries.float())
        return qi.float() * qs[:, None], qi, qs
    from image_search_tpu_torch.index.index import _l2

    return _l2(queries.float()), None, None


def _query_bound_terms(qt_vec, basis, ub_slack):
    """-> (q_s [B, d_s], q_t [B], the per-query UB inflation [B])."""
    q_s = qt_vec @ basis
    qs2 = (q_s * q_s).sum(dim=1)
    q_res = torch.sqrt(torch.clamp((qt_vec * qt_vec).sum(dim=1) - qs2, min=0.0) + SLACK_T)
    return q_s, q_res, torch.sqrt(qs2) * ub_slack + slack_for_dim(qt_vec.shape[1])


def _upper_bounds(q_s, q_res, infl, sk, resid, pen, start: int, size: int):
    """[B, n] upper bounds of one slab's rows, NEG_INF at rows >= size.

    A bf16 sketch is dotted against bf16(q_s), both upcast to f32: each
    product is exact in f32 and the two roundings are in ``ub_slack``."""
    if sk.dtype == torch.bfloat16:
        dot = q_s.to(torch.bfloat16).float() @ sk.float().T
    else:
        dot = q_s @ sk.T
    ub = dot + q_res[:, None] * resid[None, :] + infl[:, None]
    if pen is not None:
        ub = ub + pen[None, :]
    valid = (torch.arange(sk.shape[0], device=ub.device) + start) < size
    return torch.where(valid[None, :], ub, torch.full_like(ub, NEG_INF))


def _gather_candidates(parts, idx):
    """Per-query candidate rows idx [B, c] (global ids) of a slabbed array,
    rows [n, D] or a vector [n] per slab -> [B, c, D] or [B, c]."""
    out, start = None, 0
    for p in parts:
        n = p.shape[0]
        v = p[torch.clamp(idx - start, 0, n - 1)]
        in_slab = ((idx >= start) & (idx < start + n)).reshape(idx.shape + (1,) * (v.dim() - 2))
        out = torch.where(in_slab, v, torch.zeros_like(v) if out is None else out)
        start += n
    return out


def _rescore_int8(slabs, scales, idx, qi, qs):
    """Exact rescore of per-query candidate rows idx [B, c]: the integer dot
    (exact in f32: every partial sum is an integer below 2^24), times the
    query scale, times the row scale, the full scan's multiply order."""
    s = torch.einsum("bd,bcd->bc", qi.float(), _gather_candidates(slabs, idx).float())
    return s * qs[:, None] * _gather_candidates(scales, idx)


def _rescore_float(slabs, idx, q):
    """Exact rescore of per-query candidate rows idx [B, c] of f32 or bf16
    slabs (bf16: the query cast to bf16, exact products, as the full scan):
    equal to the full scan's scores up to f32 reduction order. Each query
    has its own rows (a batched product, not ``float_scores``' one GEMM), so
    bf16 operands are upcast: the products are exact either way."""
    rows = _gather_candidates(slabs, idx)
    if rows.dtype == torch.bfloat16:
        q, rows = q.to(torch.bfloat16).float(), rows.float()
    return torch.einsum("bd,bcd->bc", q, rows)


def twostage_topk(
    slabs, sketches, resid, basis, size: int, queries, k: int,
    c: int = DEFAULT_CANDIDATES, scales=None, pens=None, ub_slack=0.0,
):
    """Certified exact top-k, row candidates (the reference's first
    selection, served under ``ISX_TWOSTAGE_ROWS``): the exact top-(c+1) rows
    by UB, the top c rescored. -> (vals [B, k], ids [B, k] int64, certified
    [B] bool); rows of ``certified`` that are False MUST be re-answered by
    the full scan. The [B, N] bound array is built whole, as the reference
    builds it."""
    is_int8 = slabs[0].dtype == torch.int8
    fs_slack = FULL_SCAN_SLACK[_slab_dtype_name(slabs[0])]
    qt_vec, qi, qs = _exact_query_vector(queries, is_int8)
    q_s, q_res, infl = _query_bound_terms(qt_vec, basis, ub_slack)
    parts, start = [], 0
    for i, sk in enumerate(sketches):
        parts.append(_upper_bounds(q_s, q_res, infl, sk, resid[i], None if pens is None else pens[i], start, size))
        start += sk.shape[0]
    ub_vals, ub_idx = exact_topk(torch.cat(parts, dim=1), c + 1)
    cand = ub_idx[:, :c]
    rest_max = ub_vals[:, c]
    if is_int8:
        ex = _rescore_int8(slabs, scales, cand, qi, qs)
    else:
        ex = _rescore_float(slabs, cand, qt_vec)
    if pens is not None:
        ex = ex + _gather_candidates(pens, cand)
    ex = torch.where(cand < size, ex, torch.full_like(ex, NEG_INF))
    vals, pos = stable_topk(ex, k)  # lax.top_k's order, as the reference
    ids = torch.gather(cand, 1, pos)
    certified = rest_max <= vals[:, k - 1] - fs_slack
    return vals, ids, certified


# -- block candidates (the default) ------------------------------------------------
#
# Candidates are whole 128-row blocks: blockmax_j = max of UB over block j,
# the m blocks of largest blockmax are rescored whole, and rest_max = the
# largest blockmax outside them bounds every row not rescored. Per-slab
# quotas m_i = min(nb_i, ceil(m nb_i / nb)) keep selection and gather within
# each slab, so the gather reads ~m blocks whatever the slab count. Batched
# queries share one block set: the union of each query's own top-(m_i //
# share) blocks, filled to m_i with the best remaining blocks by batch-max;
# each query's certificate uses its own max over the blocks not chosen.


def _select_blocks(bmax, m_i: int, share_eff: int):
    """[B, nb_i] block maxima -> the m_i chosen block ids, in the reference's
    order. The union lift ``shared + 1e30`` is kept as f32 arithmetic: every
    finite union block rounds to 1e30, so the union blocks tie and come out
    in block order, as ``lax.top_k`` gives them."""
    shared = bmax.amax(dim=0)
    if share_eff == 1 or m_i <= 1:
        return stable_topk(shared[None], m_i)[1][0]
    mq = max(1, m_i // share_eff)
    qb = stable_topk(bmax, mq)[1]
    union = torch.zeros(shared.shape, dtype=torch.bool, device=bmax.device).index_fill_(0, qb.reshape(-1), True)
    return stable_topk(torch.where(union, shared + 1e30, shared)[None], m_i)[1][0]


def twostage_topk_block(
    slabs, sketches, resid, basis, size: int, queries, k: int,
    m: int = DEFAULT_BLOCKS, scales=None, pens=None, ub_slack=0.0, share: int = 0,
    timer=None,
):
    """Certified exact top-k, block candidates (comment above): the serving
    path. ``share`` is the count of DISTINCT queries the union budget is
    split over (serving pads batches by repeating rows; 0: all B).
    -> (vals [B, k], ids [B, k] int64, certified [B] bool); False rows MUST be
    re-answered by the full scan. The bound array is built one slab at a
    time ([B, slab rows] f32), never [B, N]. int8 rows are rescored by
    kernel B2 in one launch over the gathered rows, so the scores are the
    full scan's bit for bit.

    ``timer(name)``, when given, is called at the end of each part (stage1,
    gather, rescore, topk) for a caller that splits the time."""
    mark = timer or (lambda name: None)
    is_int8 = slabs[0].dtype == torch.int8
    fs_slack = FULL_SCAN_SLACK[_slab_dtype_name(slabs[0])]
    qt_vec, qi, qs = _exact_query_vector(queries, is_int8)
    q_s, q_res, infl = _query_bound_terms(qt_vec, basis, ub_slack)
    B = qt_vec.shape[0]
    share_eff = B if share <= 0 else max(1, min(share, B))
    nb_list = []
    for s in slabs:
        if s.shape[0] % BLOCK:
            raise ValueError(f"slab rows {s.shape[0]} are not a multiple of BLOCK={BLOCK}")
        nb_list.append(s.shape[0] // BLOCK)
    nb = sum(nb_list)
    quotas = [min(nb_i, -(-m * nb_i // nb)) for nb_i in nb_list]

    chosen_blocks = []
    rest_max = torch.full((B,), NEG_INF, device=qt_vec.device)
    start = 0
    for i, sk in enumerate(sketches):
        ub = _upper_bounds(q_s, q_res, infl, sk, resid[i], None if pens is None else pens[i], start, size)
        bmax = ub.reshape(B, nb_list[i], BLOCK).amax(dim=2)
        blocks = _select_blocks(bmax, quotas[i], share_eff)
        chosen = torch.zeros(nb_list[i], dtype=torch.bool, device=bmax.device).index_fill_(0, blocks, True)
        rest_max = torch.maximum(rest_max, torch.where(chosen[None, :], NEG_INF, bmax).amax(dim=1))
        chosen_blocks.append(blocks)
        start += sk.shape[0]
    mark("stage1")

    d = slabs[0].shape[1]
    rows, rscale, rpens, gid = [], [], [], []
    start = 0
    for i, blocks in enumerate(chosen_blocks):
        nb_i = nb_list[i]
        rows.append(slabs[i].view(nb_i, BLOCK, d)[blocks])
        if scales is not None:
            rscale.append(scales[i].view(nb_i, BLOCK)[blocks])
        if pens is not None:
            rpens.append(pens[i].view(nb_i, BLOCK)[blocks])
        gid.append((start + blocks[:, None] * BLOCK + torch.arange(BLOCK, device=blocks.device)).reshape(-1))
        start += slabs[i].shape[0]
    n_rows = sum(quotas) * BLOCK
    rows = torch.cat(rows).reshape(n_rows, d)
    gid = torch.cat(gid)
    rpens = torch.cat(rpens).reshape(n_rows) if pens is not None else None
    mark("gather")

    if is_int8:
        ex = stream_scores_int8(rows, qi, qs, torch.cat(rscale).reshape(n_rows), n_rows, rpens)
    else:
        ex = float_scores(qt_vec, rows)
        if rpens is not None:
            ex = ex + rpens[None, :]
    ex = torch.where(gid[None, :] < size, ex, torch.full_like(ex, NEG_INF))
    mark("rescore")

    vals, pos = exact_topk(ex, k)
    ids = gid[pos]
    certified = rest_max <= vals[:, k - 1] - fs_slack
    mark("topk")
    return vals, ids, certified
