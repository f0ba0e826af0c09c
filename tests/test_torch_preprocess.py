"""The port's preprocess against the JAX package's, on the same
``pack_batch`` inputs (f32 on the CPU, atol 1e-6).

Where the resample is the identity (hf mode with the short side at the
model's 28 px, whatever the long side; reference mode at 28 x 28) every tap
is 0 or 1, so the sums are exact in any order and the two packages must
agree to f32 round-off: padding, crop and normalize are checked exactly.
Elsewhere XLA and torch sum the taps in different orders, and a value within
round-off of a .5 lands on the other side of the uint8 rounding between the
passes: one LSB (within PIL's own <= 1 LSB), for about one value in 10^4.
``test_any_size_differs_by_at_most_one_lsb`` bounds that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_tpu.ops import preprocess as jpre
from image_search_tpu_torch import check_precision
from image_search_tpu_torch.ops import preprocess as tpre


IDENTITY_SIZES = {
    "hf": [(28, 28), (28, 40), (40, 28), (28, 100), (131, 28), (28, 29)],
    "reference": [(28, 28)] * 3,
}


def _exact_images(seed, mode="hf"):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for h, w in IDENTITY_SIZES[mode]]


def _images(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, 256, size=(int(rng.integers(lo, hi)), int(rng.integers(lo, hi)), 3), dtype=np.uint8)
        for _ in range(n)
    ]


def _both(images, size, mode, out_dtype=(jnp.float32, torch.float32)):
    u8, A_h, A_w = jpre.pack_batch(images, size=size, mode=mode)
    want = jpre.fused_preprocess(
        jnp.asarray(u8), jnp.asarray(A_h), jnp.asarray(A_w), mode=mode, out_dtype=out_dtype[0]
    )
    got = tpre.fused_preprocess(
        *map(torch.from_numpy, (u8, A_h, A_w)), mode=mode, out_dtype=out_dtype[1]
    )
    return got, want


@pytest.mark.parametrize("mode", ["hf", "reference"])
@pytest.mark.parametrize("seed", [0, 1])
def test_fused_preprocess_matches_jax(mode, seed):
    got, want = _both(_exact_images(seed, mode), 28, mode)
    assert got.shape == want.shape == (len(IDENTITY_SIZES[mode]), 28, 28, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_bf16_output_matches_jax():
    got, want = _both(_exact_images(2), 28, "hf", (jnp.bfloat16, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("mode", ["hf", "reference"])
@pytest.mark.parametrize("seed,n,lo,hi,size", [(0, 6, 8, 90, 28), (1, 6, 28, 300, 28), (4, 2, 150, 400, 224)])
def test_any_size_differs_by_at_most_one_lsb(mode, seed, n, lo, hi, size):
    got, want = _both(_images(seed, n, lo, hi), size, mode)
    mean, std = (jpre.CLIP_MEAN, jpre.CLIP_STD) if mode == "hf" else (jpre.IMAGENET_MEAN, jpre.IMAGENET_STD)
    diff = np.abs(got.numpy() - np.asarray(want))
    assert diff.max() <= 1.0 / 255.0 / min(std) + 1e-6
    assert (diff > 1e-6).mean() < 1e-3


@pytest.mark.parametrize("h,w,mode", [(40, 60, "hf"), (300, 200, "hf"), (17, 90, "reference")])
def test_host_helpers_equal_reference(h, w, mode):
    """The numpy helpers are carried over unchanged."""
    for a, b in zip(tpre.preprocess_matrices(h, w, size=28, mode=mode),
                    jpre.preprocess_matrices(h, w, size=28, mode=mode)):
        np.testing.assert_array_equal(a, b)
    ims = _images(h + w, 3, 5, 70) + [np.zeros((h, w), np.uint8), np.zeros((h, w, 4), np.uint8)]
    for a, b in zip(tpre.pack_batch(ims, size=28, mode=mode), jpre.pack_batch(ims, size=28, mode=mode)):
        np.testing.assert_array_equal(a, b)


def test_precision_policy_pins_full_f32():
    check_precision()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
