"""Kernel B1's plain version (the CPU route of ``fused_attention``) against the
JAX package's Pallas grouped kernel in interpret mode and its XLA oracle.

Same inputs, made with numpy from a seed, go to both packages; f32 on the
CPU, tolerance rtol = atol = 1e-5 (the reference's own for this kernel,
tests/test_attention.py). The CUDA kernel itself is checked on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_tpu.ops.attention import attention_reference as jax_attention_reference
from image_search_tpu.ops.attention import fused_attention_grouped
from image_search_tpu_torch.ops.attention import attention_reference, fused_attention


def _qkv(seed, B, S, H, Hd):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, S, H, Hd)) * 0.3).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize(
    "B,S,H,Hd,group,causal",
    [
        (2, 17, 4, 16, 4, False),
        (2, 17, 4, 16, 2, True),
        (1, 33, 2, 24, 2, False),  # the tiny vision tower's head dim
        (3, 16, 4, 16, 4, True),  # the tiny text tower's shape
    ],
)
def test_plain_matches_pallas_grouped_and_oracle(B, S, H, Hd, group, causal):
    q, k, v = _qkv(B * 100 + S, B, S, H, Hd)
    scale = Hd**-0.5
    got = fused_attention(
        *(torch.from_numpy(a.reshape(B, S, H * Hd)) for a in (q, k, v)), H, causal, scale
    ).numpy()
    pallas = fused_attention_grouped(
        *(jnp.asarray(a.reshape(B, S, H * Hd)) for a in (q, k, v)),
        heads=H, group=group, causal=causal, sm_scale=scale, interpret=True,
    )
    oracle = jax_attention_reference(*map(jnp.asarray, (q, k, v)), causal=causal, sm_scale=scale)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(oracle).reshape(B, S, H * Hd), rtol=1e-5, atol=1e-5)
    # the [B, S, H, Hd] entry point is the same function
    direct = attention_reference(*map(torch.from_numpy, (q, k, v)), causal=causal, sm_scale=scale)
    np.testing.assert_array_equal(direct.numpy().reshape(B, S, H * Hd), got)


def test_strided_views_equal_contiguous():
    """The towers hand k and v over as column blocks of one fused qkv
    projection; the result must not depend on the layout."""
    B, S, H, Hd = 2, 11, 2, 16
    D = H * Hd
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((B, S, 3 * D)).astype(np.float32))
    q, k, v = qkv[..., :D], qkv[..., D : 2 * D], qkv[..., 2 * D :]
    assert not k.is_contiguous()
    a = fused_attention(q, k, v, H, causal=True)
    b = fused_attention(q.contiguous(), k.contiguous(), v.contiguous(), H, causal=True)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_bf16_rounds_probabilities_before_pv():
    """bf16 inputs: logits and softmax statistics stay f32, p is rounded to
    bf16 before PV, and the output comes back in bf16 (the grouped kernel's
    order) -- within bf16 round-off of the f32 computation."""
    B, S, H, Hd = 1, 20, 2, 16
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, B, S, H, Hd))
    out16 = attention_reference(q.bfloat16(), k.bfloat16(), v.bfloat16(), causal=True)
    out32 = attention_reference(
        q.bfloat16().float(), k.bfloat16().float(), v.bfloat16().float(), causal=True
    )
    assert out16.dtype == torch.bfloat16
    np.testing.assert_allclose(out16.float().numpy(), out32.numpy(), atol=2e-2)


def test_causal_first_row_and_no_nan():
    """Causal row 0 sees only key 0, so its output is v[0]; masked logits are
    finfo(f32).min, never -inf, so nothing turns into NaN."""
    B, S, H, Hd = 1, 6, 1, 16
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, B, S, H, Hd))
    out = attention_reference(q, k, v, causal=True)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out[0, 0].numpy(), v[0, 0].numpy(), rtol=1e-6, atol=1e-6)


def test_no_route_for_other_devices():
    """Only CPU tensors take the plain version; any other device goes to the
    kernel or raises -- nothing falls back."""
    t = torch.empty((1, 4, 32), device="meta")
    with pytest.raises(ValueError, match="no route"):
        fused_attention(t, t, t, 2)
