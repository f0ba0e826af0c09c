"""Retrieval-quality evaluation: recall@k / median rank over paired data.

Gives fine-tuning (train/finetune.py) and checkpoint conversions an
objective quality gate — the reference's only quality signal is "pritty
precise searches with just a few rounds" (its README).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def retrieval_metrics(
    image_embeddings: np.ndarray,  # [N, D] row i pairs with text row i
    text_embeddings: np.ndarray,  # [N, D]
    ks: Sequence[int] = (1, 5, 10),
) -> Dict[str, float]:
    """Symmetric text<->image retrieval metrics over aligned pairs."""
    img = np.asarray(image_embeddings, np.float64)
    txt = np.asarray(text_embeddings, np.float64)
    if img.shape != txt.shape or img.ndim != 2 or img.shape[0] == 0:
        raise ValueError(
            f"need aligned [N, D] embeddings, got {img.shape} / {txt.shape}"
        )
    img = img / np.linalg.norm(img, axis=1, keepdims=True)
    txt = txt / np.linalg.norm(txt, axis=1, keepdims=True)
    sims = txt @ img.T  # [N_text, N_image]
    diag = np.diag(sims)
    # PESSIMISTIC tie handling: a candidate scoring exactly equal to the
    # true match counts as ranked ahead of it (rank = #{sims >= true},
    # 1-based; self contributes the 1). A collapsed tower mapping every
    # input to one vector therefore scores at the bottom, not at
    # recall@1 = 1.0 — argsort-based ranking silently rewarded it.
    r_t2i = np.sum(sims >= diag[:, None], axis=1)
    r_i2t = np.sum(sims >= diag[None, :], axis=0)
    out: Dict[str, float] = {
        "median_rank_t2i": float(np.median(r_t2i)),
        "median_rank_i2t": float(np.median(r_i2t)),
    }
    for k in ks:
        out[f"recall@{k}_t2i"] = float((r_t2i <= k).mean())
        out[f"recall@{k}_i2t"] = float((r_i2t <= k).mean())
    return out
