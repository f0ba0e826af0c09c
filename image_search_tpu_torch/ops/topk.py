"""Exact top-k over [B, N] scores.

The reference's ``ops/topk.py::exact_topk`` is a two-level selection that
works around a slow ``lax.top_k`` on the TPU; it is plain XLA, not a Pallas
kernel. Here it is ``torch.topk`` with the same contract: the values equal a
full top-k's, sorted descending, and the indices may differ from another
implementation's only among equal values. Whether a hierarchy pays on the
H100 is for a measurement to say (PERF.md, Open questions).
"""

from __future__ import annotations

import torch


def exact_topk(scores: torch.Tensor, k: int):
    """-> (values [B, k] f32, indices [B, k] int64)."""
    return torch.topk(scores, k, dim=-1, largest=True, sorted=True)
