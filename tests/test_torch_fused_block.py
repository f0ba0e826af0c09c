"""Kernels B7, B8 and B9 and the fused-block compositions on the CPU: each
plain version against the JAX package's Pallas kernel in interpret mode, the
B7 and B9 gradients against ``jax.grad`` of the reference's custom VJPs, and
the tiny vision tower under each composition against the reference's tower
with its ``_block`` swapped for copies of ``benchmarks/block_fused_e2e.py``'s
compositions (passing ``interpret=True``; nothing in the JAX package is
edited).

Inputs are made with numpy from a seed. Tolerances are the reference's own
tests' (``tests/test_ln_matmul.py``, ``tests/test_attention.py``): kernels at
rtol = atol = 2e-5, gradients at rtol 1e-4 and atol 1e-5; towers in f32 at
atol 1e-4 and in bf16 at cosine >= 0.9999. Shapes repeat where they can:
each Pallas shape costs an interpret-mode compile.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image_search_tpu.ops.attention as jattn
import image_search_tpu.ops.ln_matmul as jln
from image_search_tpu.config import tiny_test_config
from image_search_tpu.models import clip as jclip
from image_search_tpu_torch.models import block_fused
from image_search_tpu_torch.models import clip as tclip
from image_search_tpu_torch.models.convert import build_model, params_from_jax
from image_search_tpu_torch.ops import attention as tattn
from image_search_tpu_torch.ops import ln_matmul as tln


def _rand(seed, *shape, scale=1.0, base=0.0):
    return (base + np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# --- B9: fused LayerNorm -> matmul ----------------------------------------------


def _ln_inputs(M, K, N):
    """x, w [K, N] (the reference's layout), b, ln scale, ln bias."""
    return (_rand(M, M, K), _rand(K, K, N, scale=0.1), _rand(N, N, scale=0.1),
            _rand(1, K, scale=0.1, base=1.0), _rand(2, K, scale=0.1))


@pytest.mark.parametrize("M,K,N", [(48, 32, 64), (33, 32, 48)])
def test_ln_matmul_plain_matches_pallas(M, K, N):
    """Includes an M that is not a multiple of the reference's block."""
    x, w, b, ls, lb = _ln_inputs(M, K, N)
    n0 = tln.ln_matmul.launches
    tx, tw, tb, tls, tlb = _t(x, w, b, ls, lb)
    got = tln.ln_matmul(tx, tls, tlb, tw.t(), tb, eps=1e-5).numpy()
    assert tln.ln_matmul.launches == n0  # the CPU route launches nothing
    want = jln.ln_matmul(*map(jnp.asarray, (x, ls, lb, w, b)), eps=1e-5, block_m=16, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    oracle = jln.ln_matmul_reference(*map(jnp.asarray, (x, ls, lb, w, b)), eps=1e-5)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=2e-5, atol=2e-5)


def test_ln_matmul_plain_rounds_as_the_kernel_does():
    """bf16: y is rounded to w's dtype before the f32 product, the product
    to bf16 before the bias, which is added in bf16."""
    x, w, b, ls, lb = _ln_inputs(48, 32, 64)
    tx, tw, tb, tls, tlb = _t(x, w, b, ls, lb)
    x16, w16, b16 = tx.bfloat16(), tw.t().bfloat16(), tb.bfloat16()
    got = tln.ln_matmul_reference(x16, tls, tlb, w16, b16)
    x32 = x16.float()
    y = (x32 - x32.mean(-1, keepdim=True)) / torch.sqrt(x32.var(-1, unbiased=False, keepdim=True) + 1e-5)
    y = (y * tls + tlb).bfloat16()
    want = (y.float() @ w16.float().t()).bfloat16() + b16
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=2e-2)
    want_ref = jln.ln_matmul_reference(*map(jnp.asarray, (x16.float().numpy(), ls, lb)),
                                       jnp.asarray(w16.t().float().numpy(), jnp.bfloat16),
                                       jnp.asarray(b16.float().numpy(), jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want_ref, np.float32), atol=2e-2)


def test_ln_matmul_core_gradients_match_jax_grad():
    """LnMatmulCore's gradients (autodiff of the plain version) against
    jax.grad of ln_matmul_core (its Pallas forward in interpret mode)."""
    x, w, b, ls, lb = _ln_inputs(48, 32, 64)
    leaves = [t.requires_grad_() for t in _t(x, ls, lb, w.T.copy(), b)]
    (tln.LnMatmulCore.apply(*leaves, 1e-5) ** 2).sum().backward()

    def loss(x, ls, lb, w, b):
        return jnp.sum(jln.ln_matmul_core(x, ls, lb, w, b, 1e-5, 16, True) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (x, ls, lb, w, b)))
    got = [t.grad.numpy() for t in leaves]
    got[3] = got[3].T
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-5)


# --- B7: attention over a packed qkv ------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_qkv_packed_plain_matches_pallas(causal):
    B, S, H, Hd = 2, 19, 4, 8
    qkv = _rand(7, B, S, 3 * H * Hd, scale=0.4)
    n0 = tattn.fused_attention_qkv_packed.launches
    got = tattn.fused_attention_qkv_packed(torch.from_numpy(qkv), H, causal, Hd**-0.5).numpy()
    assert tattn.fused_attention_qkv_packed.launches == n0
    want = jattn.attention_qkv_packed_core(jnp.asarray(qkv), H, causal, Hd**-0.5, True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    # B1p on the views with q pre-scaled is the same function in f32
    D = H * Hd
    q, k, v = _t(qkv[..., :D] * Hd**-0.5, qkv[..., D : 2 * D], qkv[..., 2 * D :])
    np.testing.assert_allclose(tattn.fused_attention_packed(q, k, v, H, causal).numpy(), got, rtol=1e-5, atol=1e-6)


def test_qkv_packed_core_gradients_match_jax_grad():
    """AttentionQkvPackedCore's gradient (B5's plain version on the views)
    against jax.grad of attention_qkv_packed_core (Pallas forward and
    backward in interpret mode)."""
    B, S, H, Hd = 2, 11, 2, 8
    qkv = _rand(8, B, S, 3 * H * Hd, scale=0.3)
    t = torch.from_numpy(qkv).requires_grad_()
    (tattn.AttentionQkvPackedCore.apply(t, H, False, 0.25) ** 2).sum().backward()
    want = jax.grad(lambda a: jnp.sum(jattn.attention_qkv_packed_core(a, H, False, 0.25, True) ** 2))(
        jnp.asarray(qkv))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


# --- B8: the qkv projection fused into attention ------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_qkv_attention_plain_matches_pallas(causal):
    B, S, H, Hd = 2, 33, 4, 16
    D = H * Hd
    x, w, b = _rand(20, B, S, D, scale=0.3), _rand(21, D, 3 * D, scale=0.1), _rand(22, 3 * D, scale=0.1)
    n0 = tattn.fused_qkv_attention.launches
    tx, tw, tb = _t(x, w, b)
    got = tattn.fused_qkv_attention(tx, tw.t(), tb, H, causal, Hd**-0.5).numpy()
    assert tattn.fused_qkv_attention.launches == n0
    want = jattn.fused_qkv_attention(*map(jnp.asarray, (x, w, b)), heads=H, causal=causal, sm_scale=Hd**-0.5,
                                     interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    # the same function as projecting in plain torch and running B7 on the result
    qkv = torch.from_numpy(np.einsum("bsd,de->bse", x, w) + b)
    np.testing.assert_allclose(tattn.fused_attention_qkv_packed(qkv, H, causal, Hd**-0.5).numpy(), got,
                               rtol=2e-5, atol=2e-5)


# --- the compositions in the tiny vision tower ----------------------------------------


def _ref_ln_linear(x, scale, bias, w, b, c):
    Bx, S, D = x.shape
    return jln.ln_matmul_core(
        x.reshape(Bx * S, D), scale, bias, w.astype(x.dtype), b.astype(x.dtype), c.layernorm_eps, 16, True,
    ).reshape(Bx, S, -1)


def _ref_fused_mlp(x, blk, c):
    h = jclip._act(_ref_ln_linear(x, blk["ln2_scale"], blk["ln2_bias"], blk["fc_w"], blk["fc_b"], c), c.act)
    return jnp.einsum("bsm,md->bsd", h, blk["proj_w"].astype(x.dtype)) + blk["proj_b"].astype(x.dtype)


def _ref_o_proj(attn, blk, dtype):
    return jnp.einsum("bsd,de->bse", attn, blk["o_w"].astype(dtype)) + blk["o_b"].astype(dtype)


def _ref_full_fused(x, blk, c, causal, s_real=None):
    H, Hd = c.num_heads, c.head_dim
    qkv = _ref_ln_linear(x, blk["ln1_scale"], blk["ln1_bias"], blk["qkv_w"], blk["qkv_b"], c)
    attn = jattn.attention_qkv_packed_core(qkv, H, causal, float(Hd**-0.5), True)
    x = x + _ref_o_proj(attn, blk, x.dtype)
    return x + _ref_fused_mlp(x, blk, c)


def _ref_qkv_only(x, blk, c, causal, s_real=None):
    D = x.shape[-1]
    H, Hd = c.num_heads, c.head_dim
    qkv = _ref_ln_linear(x, blk["ln1_scale"], blk["ln1_bias"], blk["qkv_w"], blk["qkv_b"], c)
    q = qkv[..., :D] * float(Hd**-0.5)
    out = jattn.attention_core(q, qkv[..., D : 2 * D], qkv[..., 2 * D :], H, causal, 1.0, True)
    x = x + _ref_o_proj(out, blk, x.dtype)
    return x + jclip._mlp(jclip._layer_norm(x, blk["ln2_scale"], blk["ln2_bias"], c.layernorm_eps), blk, c)


def _ref_mlp_only(x, blk, c, causal, s_real=None):
    x = x + jclip._attention(jclip._layer_norm(x, blk["ln1_scale"], blk["ln1_bias"], c.layernorm_eps), blk, c, causal)
    return x + _ref_fused_mlp(x, blk, c)


REFERENCE_BLOCKS = {"fully fused": _ref_full_fused, "ln1->qkv only": _ref_qkv_only, "ln2->fc only": _ref_mlp_only}


def _params(cfg, seed):
    """The reference's parameter pytree from a numpy seed: LayerNorm scales
    near 1, every other weight N(0, 0.05^2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        base = 1.0 if "ln" in name and name.endswith("scale") else 0.0
        return (base + 0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(lambda: jclip.init_params(jax.random.key(0), cfg)))


@functools.cache
def _tiny():
    cfg = tiny_test_config()
    jparams = _params(cfg, 11)
    state = params_from_jax(jparams, cfg)
    return cfg, jparams, {dt: build_model(cfg, state, "cpu", dt) for dt in (torch.float32, torch.bfloat16)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(block_fused.COMPOSITIONS))
def test_tiny_tower_under_each_composition_equals_reference(monkeypatch, name, dtype):
    """The port's tiny vision tower under one composition against the
    reference's with its _block swapped for the benchmark's composition:
    the same weights and pixels, and the composition runs on every block
    but the CLS-only last one (B9 calls counted through a spy)."""
    for env in ("ISX_ATTN_PIPE", "ISX_ATTN_SPLIT", "ISX_VIT_SPAD"):
        monkeypatch.delenv(env, raising=False)
    cfg, jparams, models = _tiny()
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "f32" else (torch.bfloat16, jnp.bfloat16)
    px = _rand(5, 2, cfg.vision.image_size, cfg.vision.image_size, 3)
    calls = []
    real = tln.ln_matmul
    monkeypatch.setattr(tln, "ln_matmul", lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    with torch.no_grad(), block_fused.blocks_as(block_fused.COMPOSITIONS[name]):
        got = tclip.encode_image(models[tdt], torch.from_numpy(px)).float().numpy()
    per_block = 2 if name == "fully fused" else 1
    assert len(calls) == per_block * (cfg.vision.num_layers - 1)
    traced = []
    monkeypatch.setattr(jclip, "_block", lambda *a: traced.append(1) or REFERENCE_BLOCKS[name](*a))
    want = np.asarray(jclip.encode_image(jparams, cfg, jnp.asarray(px), jdt), np.float32)
    assert traced  # the reference's scan traced the swapped block
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.9999, cos.min()


def test_blocks_as_restores_the_shipped_forward_when_the_body_raises():
    shipped = tclip.Block.forward
    with pytest.raises(RuntimeError, match="inside"):
        with block_fused.blocks_as(block_fused.block_full_fused):
            assert tclip.Block.forward is not shipped
            raise RuntimeError("inside")
    assert tclip.Block.forward is shipped


@pytest.mark.parametrize("name", sorted(block_fused.COMPOSITIONS))
def test_compositions_refuse_a_padded_sequence(name):
    cfg, _, models = _tiny()
    blk = models[torch.float32].vision.blocks[0]
    x = torch.zeros(1, 8, cfg.vision.hidden_size)
    with pytest.raises(ValueError, match="padded"):
        block_fused.COMPOSITIONS[name](blk, x, False, s_real=5)


@pytest.mark.parametrize("name", sorted(block_fused.COMPOSITIONS))
def test_compositions_equal_the_shipped_block_in_f32(name):
    """In f32 every composition is the shipped block's function (the same
    LayerNorm, projections and softmax in other kernels)."""
    cfg, _, models = _tiny()
    blk = models[torch.float32].vision.blocks[0]
    x = torch.from_numpy(_rand(9, 2, 5, cfg.vision.hidden_size))
    with torch.no_grad():
        want = blk(x, False)
        got = block_fused.COMPOSITIONS[name](blk, x, False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_full_fused_block_gradients_equal_the_shipped_block():
    """Training through the fully fused block (B9's and B7's VJPs) gives the
    shipped block's gradients in f32."""
    cfg, jparams, _ = _tiny()
    grads = []
    for fused in (False, True):
        model = build_model(cfg, params_from_jax(jparams, cfg), "cpu", torch.float32, trainable=True)
        blk = model.vision.blocks[0]
        x = torch.from_numpy(_rand(10, 2, 5, cfg.vision.hidden_size)).requires_grad_()
        out = block_fused.block_full_fused(blk, x, False) if fused else blk(x, False)
        (out**2).sum().backward()
        grads.append([x.grad] + [p.grad for p in blk.parameters()])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
