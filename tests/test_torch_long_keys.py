"""The attention forward past the short kernels' 320 keys on the CPU: the
long-key kernel's plain version (``ops.attention.attention_long_reference``,
keys in blocks of 64 with an online max and sum) against the exact softmax
and the JAX package's plain oracle, the CPU route that takes it, and the
preset that needs it (OpenCLIP ViT-H/14 at 378 px, 730 vision tokens).

Inputs are made with numpy from a seed. Tolerances: f32 at atol 1e-5 (the
blocked sums against the exact ones, in another order), bf16 at the
short kernels' 2e-2 (``tests/test_torch_cuda.py::_close_to_plain``: the
same rounding of p and of the output at other places).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image_search_tpu.ops.attention as jattn
from image_search_tpu_torch.config import get_config
from image_search_tpu_torch.ops import attention as A


def _qkv(S, H=2, Hd=16, B=2, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed + S)
    q, k, v = (rng.standard_normal((B, S, H, Hd)).astype(dtype) for _ in range(3))
    return q * Hd**-0.5, k, v


def _exact(q, k, v, causal, normalize=False):
    """The short kernels' plain versions, with their key limit lifted."""
    ref = A.attention_packed_reference if normalize else A.attention_reference
    old, A.MAX_KEYS = A.MAX_KEYS, 1 << 30
    try:
        return ref(q, k, v, causal)
    finally:
        A.MAX_KEYS = old


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [321, 400, 730])
def test_long_plain_version_is_the_softmax_in_f32(S, causal, normalize):
    q, k, v = (torch.from_numpy(a) for a in _qkv(S))
    got = A.attention_long_reference(q, k, v, causal, 1.0, normalize)
    assert torch.allclose(got, _exact(q, k, v, causal, normalize), atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_long_plain_version_matches_the_jax_oracle_in_bf16(causal):
    q, k, v = _qkv(577, H=3, Hd=32, B=1, seed=3)
    bf = lambda a: torch.from_numpy(a).bfloat16()
    got = A.attention_long_reference(bf(q), bf(k), bf(v), causal).float().numpy()
    want = np.asarray(jattn.attention_reference(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=causal),
                      np.float32)
    assert np.abs(got - want).max() <= 2e-2


@pytest.mark.parametrize("S,long", [(320, False), (321, True)])
def test_cpu_route_takes_the_long_plain_version_past_320_keys(S, long, monkeypatch):
    """``fused_attention``, ``fused_attention_packed`` and B7 on a CPU tensor:
    past 320 keys, the long-key kernel's rounding points."""
    calls = []
    inner = A.attention_long_reference

    def recorded(*a, **kw):
        calls.append(kw.get("normalize", a[5] if len(a) > 5 else False))
        return inner(*a, **kw)

    monkeypatch.setattr(A, "attention_long_reference", recorded)
    q, k, v = (torch.from_numpy(a.reshape(2, S, 32)).bfloat16() for a in _qkv(S))
    A.fused_attention(q, k, v, 2)
    A.fused_attention_packed(q, k, v, 2)
    A.fused_attention_qkv_packed(torch.cat([q, k, v], dim=-1), 2)
    assert calls == ([False, True, True] if long else [])


def test_dfn5b_preset_has_730_vision_tokens_and_quick_gelu():
    cfg = get_config("dfn5b-clip-vit-h-14-378")
    assert cfg.vision.seq_len == 730 > A.MAX_KEYS and cfg.vision.head_dim == 80
    assert cfg.vision.act == cfg.text.act == "quick_gelu"
    assert (cfg.text.num_layers, cfg.text.hidden_size, cfg.projection_dim) == (24, 1024, 1024)
