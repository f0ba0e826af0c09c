"""Exact top-k over [B, N] scores, in the reference's order.

Port of ``image_search_tpu/ops/topk.py::exact_topk``: plain XLA there, not a
Pallas kernel, so plain torch here. Values AND indices equal the
reference's, ties included:

- below the two-level threshold (N not a multiple of ``_LANES``, or fewer
  than ``hold`` rows of ``_LANES``) it is ``lax.top_k``'s order: values
  descending, the lower index first among equal values;
- above it, the reference's two-level selection with its own order: each
  row of ``_LANES`` scores gives its max, the ``hold`` best rows are taken
  (the lower row first on ties), and the top-k of the gathered candidates
  is taken in candidate order on ties, then mapped back to
  ``rows * _LANES + pos % _LANES``.

``torch.topk`` orders equal values arbitrarily (on the CPU and on the card),
so each level is :func:`stable_topk`: ``torch.topk``'s k-th value, every
score above it plus the first indices (in index order) of those equal to
it, then a stable sort of those k. No full sort of the scores. Scores carry
no NaN: invalid rows hold ``NEG_INF``, a finite value.

:func:`lax_topk` is ``lax.top_k``'s order at any N: what the reference's
``approx_max_k`` (``--search-approx``) returns off the TPU.
"""

from __future__ import annotations

import torch

_LANES = 128
_MIN_HOLD = 2048


def _row_cumsum(mask: torch.Tensor) -> torch.Tensor:
    """Inclusive int64 cumsum of a bool [B, N] along each row, through one
    scan of the flattened tensor less each row's starting total: at B > 1
    torch's per-row scan kernel is two orders of magnitude slower on the
    card than its 1-D scan over the same elements."""
    B, n = mask.shape
    flat = torch.cumsum(mask.reshape(-1), dim=0).view(B, n)
    if B == 1:
        return flat
    return flat - torch.cat([flat.new_zeros(1), flat[:-1, -1]])[:, None]


def stable_topk(scores: torch.Tensor, k: int):
    """Top-k over the last dim of [B, N], values descending, the lower index
    first among equal values (``lax.top_k``'s order) -> (values, int64 indices)."""
    B, n = scores.shape
    if k == 0:
        return scores[:, :0], torch.zeros((B, 0), dtype=torch.int64, device=scores.device)
    kth = torch.topk(scores, k, dim=-1, largest=True, sorted=False).values.amin(dim=-1, keepdim=True)
    above = scores > kth
    equal = scores == kth
    # of the scores equal to the k-th value, the first (k - #above) by index
    need = k - above.sum(dim=-1, keepdim=True)
    take = above | (equal & (_row_cumsum(equal) <= need))
    # the k taken indices of each row, ascending: each goes to its rank among
    # the taken (column k collects the rest and is dropped)
    slot = torch.where(take, _row_cumsum(take) - 1, k)
    cols = torch.arange(n, device=scores.device).expand(B, n)
    idx = torch.zeros((B, k + 1), dtype=torch.int64, device=scores.device).scatter_(1, slot, cols)[:, :k]
    vals = torch.gather(scores, 1, idx)
    vals, order = torch.sort(vals, dim=-1, descending=True, stable=True)
    return vals, torch.gather(idx, 1, order)


def _hold(n: int, k: int) -> int:
    """The rows of ``_LANES`` scores the two-level selection keeps, or 0
    below its threshold (N not a multiple of ``_LANES``, or too few rows)."""
    hold = _MIN_HOLD
    while hold < 2 * k:
        hold *= 2
    return 0 if n % _LANES or n // _LANES < hold else hold


def exact_topk(scores: torch.Tensor, k: int):
    """Exact top-k over [B, N] scores -> (values [B, k], indices [B, k] int64),
    values and indices equal to the reference's ``exact_topk``."""
    B, n = scores.shape
    hold = _hold(n, k)
    nr = n // _LANES
    if not hold:
        return stable_topk(scores, k)
    s3 = scores.reshape(B, nr, _LANES)
    _, rows = stable_topk(s3.amax(dim=2), hold)  # [B, hold] best rows
    cand = torch.gather(s3, 1, rows[:, :, None].expand(B, hold, _LANES))  # [B, hold, 128]
    vals, pos = stable_topk(cand.reshape(B, hold * _LANES), k)
    sel_rows = torch.gather(rows, 1, pos // _LANES)
    return vals, sel_rows * _LANES + pos % _LANES


def lax_topk(scores: torch.Tensor, k: int):
    """``lax.top_k``'s values and indices over [B, N] at any N (the lower
    index first among equal values). Above the two-level threshold,
    :func:`exact_topk` gives the k values and every index whose score is
    above the k-th; the rest are the lowest indices holding the k-th value
    (``torch.topk`` of a key that is larger for a lower index), and the k
    are ordered by value, then index. No per-row scan over N."""
    B, n = scores.shape
    if k == 0 or not _hold(n, k):
        return stable_topk(scores, k)
    vals, idx = exact_topk(scores, k)
    kth = vals[:, k - 1 : k]
    above = vals > kth
    key = torch.where(scores == kth, n - torch.arange(n, device=scores.device), 0)
    eq = torch.topk(key, k, dim=-1).indices  # ascending index among the equal
    use_eq = torch.arange(k, device=scores.device)[None, :] < k - above.sum(dim=-1, keepdim=True)
    cand = torch.cat([torch.where(above, idx, n), torch.where(use_eq, eq, n)], dim=1)  # n: unused
    cand = torch.sort(cand, dim=-1).values
    cv = torch.gather(scores, 1, cand.clamp(max=n - 1))
    cv = torch.where(cand < n, cv, torch.full_like(cv, float("-inf")))
    cv, order = torch.sort(cv, dim=-1, descending=True, stable=True)
    return cv[:, :k], torch.gather(cand, 1, order[:, :k])
