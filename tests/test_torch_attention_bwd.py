"""Kernel B5's plain version (the CPU route of ``fused_attention_bwd``) against
the JAX package's Pallas backward in interpret mode and ``jax.vjp`` of its XLA
oracle, and ``AttentionCore`` (B1 forward, B5 backward) as a differentiable op.

Same inputs, made with numpy from a seed, go to both packages; f32 on the
CPU, tolerance rtol = atol = 1e-5. The CUDA kernel itself is checked on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_tpu.ops.attention import attention_reference as jax_attention_reference
from image_search_tpu.ops.attention import fused_attention_bwd as pallas_attention_bwd
from image_search_tpu_torch.ops.attention import (
    AttentionCore,
    attention_bwd_reference,
    fused_attention,
    fused_attention_bwd,
)

SM_SCALE = 0.27


def _inputs(seed, B, S, D):
    """q, k, v and a non-uniform cotangent g, [B, S, D] f32."""
    rng = np.random.default_rng(seed)
    q, k, v = ((rng.standard_normal((B, S, D)) * 0.4).astype(np.float32) for _ in range(3))
    g = (rng.standard_normal((B, S, D)) * np.linspace(0.2, 2.0, D)).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,S,H,Hd", [(2, 13, 4, 8), (2, 17, 2, 16), (1, 33, 2, 24)])
def test_plain_matches_pallas_backward_and_oracle_vjp(B, S, H, Hd, causal):
    D = H * Hd
    q, k, v, g = _inputs(B * 1000 + S * 10 + Hd, B, S, D)
    n0 = fused_attention_bwd.launches
    got = fused_attention_bwd(*map(torch.from_numpy, (q, k, v, g)), H, causal, SM_SCALE)
    assert fused_attention_bwd.launches == n0  # the CPU route launches nothing

    pallas = pallas_attention_bwd(
        *map(jnp.asarray, (q, k, v, g)), heads=H, causal=causal, sm_scale=SM_SCALE, interpret=True
    )

    def oracle(q_, k_, v_):
        split = lambda t: t.reshape(B, S, H, Hd)
        return jax_attention_reference(split(q_), split(k_), split(v_), causal=causal, sm_scale=SM_SCALE).reshape(B, S, D)

    _, vjp = jax.vjp(oracle, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    for name, a, p, o in zip(("dq", "dk", "dv"), got, pallas, want):
        assert a.shape == (B, S, D) and a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), np.asarray(p), rtol=1e-5, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(o), rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_core_gradcheck_f64(causal):
    """The CPU route of the autograd op in f64: B5's analytic gradient against
    finite differences of B1's plain forward."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 5, 8)) * 0.5).requires_grad_() for _ in range(3))
    assert torch.autograd.gradcheck(lambda a, b, c: AttentionCore.apply(a, b, c, 2, causal, 0.7), (q, k, v))


def test_strided_views_give_the_gradients_of_contiguous_ones():
    """The towers hand k and v over as column blocks of one fused qkv
    projection: B5 and the op's gradients must not depend on the layout."""
    B, S, H, Hd = 2, 11, 2, 16
    D = H * Hd
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((B, S, 3 * D)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32))
    q, k, v = qkv[..., :D], qkv[..., D : 2 * D], qkv[..., 2 * D :]
    assert not k.is_contiguous()
    strided = fused_attention_bwd(q, k, v, g, H, True, 0.5)
    contiguous = fused_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(), g, H, True, 0.5)
    for a, b in zip(strided, contiguous):
        assert a.is_contiguous()
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    # through autograd: one leaf qkv, its three column blocks into the op
    leaf = qkv.clone().requires_grad_()
    out = AttentionCore.apply(leaf[..., :D], leaf[..., D : 2 * D], leaf[..., 2 * D :], H, True, 0.5)
    out.backward(g)
    np.testing.assert_array_equal(leaf.grad.numpy(), torch.cat(contiguous, dim=-1).numpy())
    np.testing.assert_array_equal(out.detach().numpy(), fused_attention(q, k, v, H, True, 0.5).numpy())


def test_bf16_rounds_at_the_reference_points():
    """bf16 operands: the outputs come back in bf16, within bf16 round-off of
    the f32 computation on the same (rounded) inputs."""
    B, S, H, Hd = 1, 20, 2, 16
    D = H * Hd
    q, k, v, g = (torch.from_numpy(a).bfloat16() for a in _inputs(5, B, S, D))
    got = attention_bwd_reference(q, k, v, g, H, True, 1.0)
    want = attention_bwd_reference(q.float(), k.float(), v.float(), g.float(), H, True, 1.0)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), atol=3e-2 * float(b.abs().max()))


def test_no_route_for_other_devices():
    t = torch.empty((1, 4, 32), device="meta")
    with pytest.raises(ValueError, match="no route"):
        fused_attention_bwd(t, t, t, t, 2)
