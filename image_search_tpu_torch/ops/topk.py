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
"""

from __future__ import annotations

import torch

_LANES = 128
_MIN_HOLD = 2048


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
    take = above | (equal & (torch.cumsum(equal, dim=-1) <= need))
    # the k taken indices of each row, ascending: each goes to its rank among
    # the taken (column k collects the rest and is dropped)
    slot = torch.where(take, torch.cumsum(take, dim=-1) - 1, k)
    cols = torch.arange(n, device=scores.device).expand(B, n)
    idx = torch.zeros((B, k + 1), dtype=torch.int64, device=scores.device).scatter_(1, slot, cols)[:, :k]
    vals = torch.gather(scores, 1, idx)
    vals, order = torch.sort(vals, dim=-1, descending=True, stable=True)
    return vals, torch.gather(idx, 1, order)


def exact_topk(scores: torch.Tensor, k: int):
    """Exact top-k over [B, N] scores -> (values [B, k], indices [B, k] int64),
    values and indices equal to the reference's ``exact_topk``."""
    B, n = scores.shape
    hold = _MIN_HOLD
    while hold < 2 * k:
        hold *= 2
    nr = n // _LANES
    if n % _LANES or nr < hold:
        return stable_topk(scores, k)
    s3 = scores.reshape(B, nr, _LANES)
    _, rows = stable_topk(s3.amax(dim=2), hold)  # [B, hold] best rows
    cand = torch.gather(s3, 1, rows[:, :, None].expand(B, hold, _LANES))  # [B, hold, 128]
    vals, pos = stable_topk(cand.reshape(B, hold * _LANES), k)
    sel_rows = torch.gather(rows, 1, pos // _LANES)
    return vals, sel_rows * _LANES + pos % _LANES
