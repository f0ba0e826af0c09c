"""Kernel B2's plain version (the CPU route of ``stream_scores_int8``) and the
int8 query quantizer against the JAX package's, BITWISE.

The reference's Pallas kernel runs in interpret mode, as its own tests run it
(tests/test_score_stream.py). There is no tolerance: the int8 dot is an exact
integer and every epilogue step rounds in the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_tpu.ops.score_stream import NEG_INF as JAX_NEG_INF
from image_search_tpu.ops.score_stream import stream_scores_int8 as jax_stream_scores_int8
from image_search_tpu.parallel.sharded_search import quantize_rows_int8 as jax_quantize
from image_search_tpu.index.index import _l2 as jax_l2
from image_search_tpu_torch.ops.score_stream import (
    NEG_INF,
    quantize_queries_int8,
    quantize_rows_int8,
    scores_int8_reference,
    stream_scores_int8,
)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _inputs(seed, n, d, b):
    rng = np.random.default_rng(seed)
    rows, scales = (np.array(a) for a in jax_quantize(jnp.asarray(_unit(rng, n, d))))
    qi, qs = (np.array(a) for a in jax_quantize(jnp.asarray(_unit(rng, b, d))))
    pens = np.zeros((n,), np.float32)
    pens[rng.choice(n, size=7, replace=False)] = JAX_NEG_INF
    return rows, scales, qi, qs, pens


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("limit_frac", [1.0, 0.6, 0.0])
@pytest.mark.parametrize("with_pens", [False, True])
def test_plain_bitwise_vs_pallas(b, limit_frac, with_pens):
    n, d, block = 512, 128, 128
    rows, scales, qi, qs, pens = _inputs(b * 10 + int(limit_frac * 10), n, d, b)
    limit = int(n * limit_frac) - (3 if 0 < limit_frac < 1 else 0)  # mid-block cut
    p = pens if with_pens else None
    want = jax_stream_scores_int8(
        jnp.asarray(rows), jnp.asarray(qi), jnp.asarray(qs), jnp.asarray(scales),
        jnp.int32(limit), None if p is None else jnp.asarray(p), block=block, interpret=True,
    )
    got = stream_scores_int8(
        *map(torch.from_numpy, (rows, qi, qs, scales)), limit,
        None if p is None else torch.from_numpy(p),
    )
    assert got.shape == (b, n) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ragged_n_and_small_d_plain():
    """The port masks the ragged edge itself (no N % 4096 or D % 128
    requirement): compare with an explicit per-element computation."""
    rng = np.random.default_rng(2)
    n, d, b = 37, 12, 3
    rows, scales = quantize_rows_int8(torch.from_numpy(_unit(rng, n, d)))
    qi, qs = quantize_rows_int8(torch.from_numpy(_unit(rng, b, d)))
    got = scores_int8_reference(rows, qi, qs, scales, limit=30)
    s32 = qi.numpy().astype(np.int64) @ rows.numpy().astype(np.int64).T
    want = (s32.astype(np.float32) * qs.numpy()[:, None]) * scales.numpy()[None, :]
    want[:, 30:] = NEG_INF
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_rows_bitwise_vs_reference():
    rng = np.random.default_rng(4)
    x = np.concatenate(
        [
            _unit(rng, 64, 48),
            rng.standard_normal((8, 48)).astype(np.float32) * 10,
            np.zeros((1, 48), np.float32),  # amax 0 -> scale 1e-12/127
            # amax 127 -> scale exactly 1: exact .5 ties round half to even
            np.array([[127.0, 2.5, -3.5, 0.5, -0.5, 1.5] + [0.0] * 42], np.float32),
        ]
    )
    q, s = quantize_rows_int8(torch.from_numpy(x))
    # as the reference's jitted search runs it (XLA compiles the division by
    # the constant 127 into a multiply by its reciprocal)
    jq, js = jax.jit(jax_quantize)(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.numpy()[-1, :6].tolist() == [127, 2, -4, 0, 0, 2]


@pytest.mark.parametrize("kind", ["small_integers", "zero_row"])
def test_query_quantization_bitwise_vs_compiled_reference(kind):
    """Raw queries -> int8 as the reference's jitted search computes
    ``quantize_rows_int8(_l2(x))``. Small-integer queries have exact norms
    (sums of squares of small integers are exact in any order) and many
    exact .5 ties, where the compiled rounding sequence matters."""
    rng = np.random.default_rng(5)
    if kind == "small_integers":
        x = rng.integers(-8, 9, size=(256, 96)).astype(np.float32)
    else:
        x = np.zeros((2, 96), np.float32)
    jq, js = jax.jit(lambda a: jax_quantize(jax_l2(a)))(jnp.asarray(x))
    q, s = quantize_queries_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_query_quantization_general_queries_within_norm_roundoff():
    """General f32 queries: XLA and torch sum the squares for the norm in
    different orders, so the norm (and with it the scale) may differ in the
    last bit -- at most 2 ulp of the scale, and an int8 value moves by one
    only where it sat on a .5 boundary."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((256, 96)).astype(np.float32) * 3
    jq, js = jax.jit(lambda a: jax_quantize(jax_l2(a)))(jnp.asarray(x))
    q, s = quantize_queries_int8(torch.from_numpy(x))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=2.5e-7, atol=0)
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32))
    assert diff.max() <= 1 and diff.mean() < 1e-3


@pytest.mark.parametrize("b", [1, 5, 32, 33, 70])
def test_query_quantization_is_the_same_at_any_batch(b):
    """A query's int8 values and scale do not depend on the other queries of
    its batch (norms are reduced in blocks of ``NORM_ROWS`` rows): each row
    of a batch of b equals the same query quantized alone, bitwise."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((b, 768)).astype(np.float32) * 3)
    q, s = quantize_queries_int8(x)
    for i in range(b):
        qa, sa = quantize_queries_int8(x[i : i + 1])
        assert torch.equal(q[i : i + 1], qa) and torch.equal(s[i : i + 1], sa)


def test_no_route_for_other_devices():
    t8 = torch.empty((4, 8), dtype=torch.int8, device="meta")
    f = torch.empty((4,), device="meta")
    with pytest.raises(ValueError, match="no route"):
        stream_scores_int8(t8, t8, f, f, 4)


@pytest.mark.parametrize("b", [1, 8, 16, 17, 296, 1024, 5000])
def test_launch_plan(b):
    """One launch per call at every batch: BM follows B (16 up to 16
    queries, padded queries never stored; 64 up to 64; 128 above), the grid
    covers every query and every row of a ragged N in tiles of BM x 128,
    whatever D."""
    from image_search_tpu_torch.ops.score_stream import BN, score_plan

    want_bm = 16 if b <= 16 else 64 if b <= 64 else 128
    for n, d in ((100_003, 768), (128, 768), (1, 12)):
        plan = score_plan(b, n, d)
        bm, (m_tiles, n_tiles) = plan["bm"], plan["grid"]
        assert bm == want_bm and plan["bn"] == BN == 128
        assert (m_tiles - 1) * bm < b <= m_tiles * bm
        assert (n_tiles - 1) * BN < n <= n_tiles * BN
    assert score_plan(b, 100_003, 768)["grid"][1] == 782
