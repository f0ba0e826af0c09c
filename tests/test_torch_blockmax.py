"""Kernels B3 and B4's plain versions (the CPU route of ``blockpair_mask`` and
``blockpair_values``) against the JAX package's Pallas kernels, run in
interpret mode as tests/test_dupscan.py runs them, on the same numpy-seeded
bf16 sketches.

The mask must be BITWISE equal: its thresholds are kept 1e-5 away from every
block maximum, since the two frameworks sum the 65 products in different
orders (a maximum moves by ~1e-7). The values agree within 2e-5.

The duplicate scan hands the kernels its sketch slab with the depth padded
from 65 to 80 (``dupscan._prep_sketch``, TMA's 16-byte rows): the padded
slab must give exactly what the 65-wide operand gives.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_tpu.ops import blockmax as jax_blockmax
from image_search_tpu_torch.index.dupscan import _prep_sketch
from image_search_tpu_torch.index.slabs import Slabs
from image_search_tpu_torch.index.twostage import SketchState
from image_search_tpu_torch.ops import blockmax

DA = 65  # a 64-dim sketch plus the residual norm
DIM_UNUSED = 768  # the basis's row count: _prep_sketch does not read the basis
MARGIN = 1e-5


def _sketches(seed, n):
    """[n, DA] bf16 as numpy f32 values (exactly representable in bf16)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, DA)).astype(np.float32) / np.sqrt(DA)
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _both(a32):
    return jnp.asarray(a32, jnp.bfloat16), torch.from_numpy(a32).to(torch.bfloat16)


def _maxima(rows32, cols32, rb0):
    """numpy f64 block maxima of the exact products, -inf below the diagonal."""
    d = rows32.astype(np.float64) @ cols32.astype(np.float64).T
    nb_r, nb_c = rows32.shape[0] // 128, cols32.shape[0] // 128
    m = d.reshape(nb_r, 128, nb_c, 128).max(axis=(1, 3))
    upper = np.arange(nb_c)[None, :] >= rb0 + np.arange(nb_r)[:, None]
    return np.where(upper, m, -np.inf)


def _thresholds(m, quantiles=(0.3, 0.5, 0.9)):
    """Midpoints of gaps of the finite maxima at least 2 * MARGIN wide, at
    or above each quantile."""
    v = np.sort(m[np.isfinite(m)].ravel())
    wide = np.nonzero(np.diff(v) > 2 * MARGIN)[0]
    out = []
    for q in quantiles:
        i = wide[wide >= int(q * (len(v) - 1))][0]
        out.append(float((v[i] + v[i + 1]) / 2))
    return out


@pytest.mark.parametrize("n", [4096, 8192])
@pytest.mark.parametrize("rb0", [0, 4])
def test_mask_bitwise_vs_pallas(n, rb0):
    r = blockmax.ROWS_TILE
    cols32 = _sketches(n + rb0, n)
    rows32 = cols32[rb0 * 128 : rb0 * 128 + r] if rb0 * 128 + r <= n else _sketches(1, r)
    rows_j, rows_t = _both(rows32)
    cols_j, cols_t = _both(cols32)
    m = _maxima(rows32, cols32, rb0)
    negative = False
    for thr in _thresholds(m):
        want = np.asarray(jax_blockmax.blockpair_mask(
            rows_j, cols_j, jnp.float32(thr), jnp.int32(rb0), interpret=True
        ))
        got = blockmax.blockpair_mask(rows_t, cols_t, thr, rb0)
        assert got.dtype == torch.int32 and got.shape == (r // 128, n // 4096)
        np.testing.assert_array_equal(got.numpy(), want)
        # the bits say what the exact maxima say
        bits = (got.numpy().astype(np.uint32)[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
        np.testing.assert_array_equal(bits.reshape(m.shape).astype(bool), m >= thr)
        negative |= bool((got.numpy() < 0).any())
    assert negative  # bit 31 makes a word negative


@pytest.mark.parametrize("rb0", [0, 4])
def test_values_vs_pallas(rb0):
    r, n = blockmax.ROWS_TILE, blockmax.COLS_TILE_V
    cols32 = _sketches(7 + rb0, n)
    rows32 = cols32[rb0 * 128 : rb0 * 128 + r]
    rows_j, rows_t = _both(rows32)
    cols_j, cols_t = _both(cols32)
    want = np.asarray(jax_blockmax.blockpair_values(rows_j, cols_j, jnp.int32(rb0), interpret=True))
    got = blockmax.blockpair_values(rows_t, cols_t, rb0).numpy()
    assert got.shape == want.shape == (r // 128, n // 128)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, _maxima(rows32, cols32, rb0), rtol=0, atol=2e-5)


def test_shape_contract_is_the_references():
    a = torch.zeros(1024, DA, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple"):
        blockmax.blockpair_mask(a, a, 0.5, 0)  # N = 1024 is not a multiple of 4096
    with pytest.raises(ValueError, match="multiple"):
        blockmax.blockpair_values(a, torch.zeros(4096, DA, dtype=torch.bfloat16), 0)
    with pytest.raises(ValueError, match="bf16"):
        blockmax.blockpair_mask(a.float(), torch.zeros(4096, DA), 0.5, 0)
    meta = torch.empty(1024, DA, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no route"):
        blockmax.blockpair_values(meta, torch.empty(16384, DA, dtype=torch.bfloat16, device="meta"), 0)


@pytest.mark.parametrize("rb0", [0, 4])
def test_prep_sketch_slab_padded_to_80_changes_no_maximum(rb0):
    """_prep_sketch's 80-wide slab gives, through the plain versions, exactly
    the maxima and words of its 65-wide part, and what the JAX package's
    kernels give on the 65-wide operand."""
    n, size = 2 * blockmax.COLS_TILE_V, 2 * blockmax.COLS_TILE_V - 300  # rows past size are zeroed
    rng = np.random.default_rng(11 + rb0)
    sk = rng.normal(size=(n, DA - 1)).astype(np.float32) / np.sqrt(DA)
    resid = np.abs(rng.normal(size=n)).astype(np.float32) / np.sqrt(DA)
    state = SketchState(
        basis=torch.zeros(DIM_UNUSED, DA - 1), sketches=(torch.from_numpy(sk),), resid=(torch.from_numpy(resid),),
        built_rows=size,
    )
    sl = Slabs(rows=(torch.empty(n, 0),), norms=(torch.ones(n),), scales=None, pens=None, size=size)  # the layout only
    s_all, n_pad, _, nb_real, _ = _prep_sketch(sl, state, n, granule=blockmax.COLS_TILE_V)
    assert s_all.shape == (n_pad, blockmax.kernel_depth(DA)) == (n, 80)
    assert s_all.dtype == torch.bfloat16 and s_all.is_contiguous() and nb_real == -(-size // 128)
    assert not s_all[:, DA:].any()
    s65 = s_all[:, :DA].contiguous()
    r = blockmax.ROWS_TILE
    rows80, rows65 = s_all[rb0 * 128 : rb0 * 128 + r], s65[rb0 * 128 : rb0 * 128 + r]
    m80 = blockmax.blockpair_values(rows80, s_all, rb0)
    m65 = blockmax.blockpair_values(rows65, s65, rb0)
    assert torch.equal(m80, m65)
    rows_j, cols_j = jnp.asarray(rows65.float().numpy(), jnp.bfloat16), jnp.asarray(s65.float().numpy(), jnp.bfloat16)
    want = np.asarray(jax_blockmax.blockpair_values(rows_j, cols_j, jnp.int32(rb0), interpret=True))
    np.testing.assert_array_equal(np.isinf(m80.numpy()), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(m80.numpy()[fin], want[fin], rtol=0, atol=2e-5)
    for thr in _thresholds(m65.numpy().astype(np.float64)):
        w80 = blockmax.blockpair_mask(rows80, s_all, thr, rb0)
        assert torch.equal(w80, blockmax.blockpair_mask(rows65, s65, thr, rb0))
        np.testing.assert_array_equal(
            w80.numpy(),
            np.asarray(jax_blockmax.blockpair_mask(rows_j, cols_j, jnp.float32(thr), jnp.int32(rb0), interpret=True)),
        )
