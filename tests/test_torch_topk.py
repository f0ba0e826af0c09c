"""The port's ``exact_topk`` against the JAX package's, values AND indices,
on tied scores: below the reference's two-level threshold (``lax.top_k``'s
order, the lower index first among equal values) and above it (the
two-level selection's own order). Scores are made with numpy from a seed;
both sides see the same f32 arrays, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

from image_search_tpu.ops.topk import exact_topk as ref_topk
from image_search_tpu_torch.ops.topk import exact_topk, lax_topk, stable_topk

NEG_INF = float(np.finfo(np.float32).min)
TWO_LEVEL_N = 2 * 128 * 2048  # above the reference's threshold: N/128 rows >= hold


def _same(scores: np.ndarray, k: int):
    want_v, want_i = (np.asarray(a) for a in ref_topk(scores, k))
    got_v, got_i = exact_topk(torch.from_numpy(scores), k)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    assert got_i.dtype == torch.int64
    return got_i.numpy()


def _copies(rng, b, values, copies):
    """[b, values * copies] scores: each of ``values`` distinct values
    ``copies`` times, at shuffled positions."""
    base = np.repeat(rng.normal(size=(b, values)).astype(np.float32), copies, axis=1)
    return np.stack([rng.permutation(row) for row in base])


@pytest.mark.parametrize("k", [1, 5, 12, 40, 200])
def test_tied_f32_scores_below_threshold(k):
    """200 scores, 40 values x 5 copies: the k boundary falls inside a tie."""
    idx = _same(_copies(np.random.default_rng(k), 3, 40, 5), k)
    assert all(len(set(row)) == k for row in idx)


@pytest.mark.parametrize("n,k", [(1000, 100), (4099, 64), (128 * 300, 1000)])
def test_tied_int8_scores_below_threshold(n, k):
    """int8 index scores: integer dot products times one shared scale, so
    whole runs of rows score exactly alike."""
    rng = np.random.default_rng(n)
    dots = rng.integers(-6, 7, size=(2, n)).astype(np.float32)
    _same(dots * np.float32(1 / 256), k)


@pytest.mark.parametrize("k", [1, 100, 1000, 1500])
def test_tied_scores_above_threshold(k):
    """2 x 128 x 2048 scores of a few hundred distinct values: the two-level
    selection (hold 2048, or 4096 once 2k > 2048)."""
    rng = np.random.default_rng(k + 7)
    _same(rng.integers(-200, 200, size=(2, TWO_LEVEL_N)).astype(np.float32) / 64, k)


def test_tied_rows_above_threshold_pick_the_lower_row():
    """Above the threshold, whole 128-score rows tie on their max: the
    reference keeps the lower rows, and so must the port."""
    rng = np.random.default_rng(3)
    s = rng.integers(0, 4, size=(1, TWO_LEVEL_N)).astype(np.float32)
    s[0, rng.choice(TWO_LEVEL_N, 50, replace=False)] = 9.0
    _same(s, 300)


@pytest.mark.parametrize("n", [TWO_LEVEL_N, TWO_LEVEL_N + 1, 300])
def test_all_scores_equal(n):
    idx = _same(np.zeros((2, n), np.float32), 17)
    np.testing.assert_array_equal(idx, np.broadcast_to(np.arange(17), (2, 17)))


def test_invalid_rows_tie_at_neg_inf():
    """Past the live rows every score is NEG_INF (a finite value, never NaN):
    a k larger than the live count fills up with them in index order."""
    rng = np.random.default_rng(5)
    s = np.full((2, 640), NEG_INF, np.float32)
    s[:, :30] = _copies(rng, 2, 10, 3)
    idx = _same(s, 50)
    np.testing.assert_array_equal(idx[:, 30:], np.broadcast_to(np.arange(30, 50), (2, 20)))


def test_stable_topk_keeps_index_order_within_ties():
    rng = np.random.default_rng(9)
    s = torch.from_numpy(_copies(rng, 4, 25, 8))
    vals, idx = stable_topk(s, 60)
    full_v, full_i = torch.sort(s, dim=-1, descending=True, stable=True)
    assert torch.equal(vals, full_v[:, :60]) and torch.equal(idx, full_i[:, :60])
    assert stable_topk(s, 0)[1].shape == (4, 0)


@pytest.mark.parametrize("n,k", [(TWO_LEVEL_N, 1000), (TWO_LEVEL_N, 1500), (TWO_LEVEL_N + 1, 100), (640, 50)])
def test_lax_topk_is_lax_top_k_at_any_n(n, k):
    """``--search-approx``'s order: the reference's ``approx_max_k`` off the
    TPU, which is ``lax.top_k``'s, values and indices, above the two-level
    threshold too (where exact_topk keeps its own order)."""
    import jax

    rng = np.random.default_rng(n + k)
    s = rng.integers(-200, 200, size=(2, n)).astype(np.float32) / 64
    want_v, want_i = (np.asarray(a) for a in jax.lax.approx_max_k(s, k, recall_target=0.95))
    got_v, got_i = lax_topk(torch.from_numpy(s), k)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
