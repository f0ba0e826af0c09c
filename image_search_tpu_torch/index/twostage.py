"""The corpus sketch: a low-dimensional projection of every row and the norm
of what it leaves out, which bounds every dot product from above.

Port of the sketch-building part of ``image_search_tpu/index/twostage.py``;
the duplicate scan (``index/dupscan.py``) is its user here. The two-stage
search that also reads it is not ported yet.

Build (one streaming pass over the slabs):
  - W [D, d_s]: orthonormal basis of the corpus's top-d_s principal
    directions (host SVD of a row sample, :func:`fit_basis`);
  - per row i with (dequantized) stored vector r_i:
      s_i = W^T r_i           the sketch, [d_s] f32 or bf16
      t_i = ||r_i - W s_i||   the residual norm, inflated by ``SLACK_T``.

Because W is orthonormal, r_i . r_j <= s_i . s_j + t_i * t_j (Cauchy-Schwarz
on the residuals). The f32 matmuls run in full f32 (no TF32:
``image_search_tpu_torch.check_precision``), as the reference runs them at
``Precision.HIGHEST``, so the identity holds to f32 rounding, which ``SLACK``
covers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

SLACK = 1e-4   # UB inflation: bounds f32 reduction error of either route
SLACK_T = 1e-5  # residual-norm-squared inflation before the sqrt
DEFAULT_SKETCH_DIM = 64
BLOCK = 128
DEFAULT_BLOCKS = 4096

# The reference's certificate deduction for the full scan's operand rounding
# on the TPU (its module doc, item 2). Here it only feeds the certifiability
# estimate of ``VectorIndex.build_sketch``; equal values make the port choose
# the same duplicate-scan route as the reference.
FULL_SCAN_SLACK = {
    "int8": 0.0,
    "bfloat16": (2.0 ** -8) * (1.0 + 2.0 ** -8) + 5e-4,
    "float32": (2.0 ** -8) * (2.0 + 2.0 ** -8) + 5e-4,
}


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
    if n < 32 or corpus_size <= 0:
        return 1.0  # tiny corpora fall back by construction anyway
    w = np.asarray(basis, np.float32)
    s = x @ w                                             # [n, d_s]
    t = np.sqrt(
        np.maximum((x * x).sum(1) - (s * s).sum(1), 0.0) + SLACK_T
    )                                                     # [n]
    qi = np.unique(np.linspace(0, n - 1, min(n_queries, n)).astype(np.int64))
    q, qs, q_res = x[qi], s[qi], t[qi]
    exact = q @ x.T                                       # [nq, n]
    infl = np.sqrt((qs * qs).sum(1)) * ub_slack + SLACK   # [nq]
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
    slab: torch.Tensor,                  # [n, D] f32/int8 rows
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
