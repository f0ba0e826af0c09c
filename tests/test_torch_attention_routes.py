"""The towers' attention routes on the CPU: kernels B1p and B6 (plain
versions) against the JAX package's Pallas kernels in interpret mode, the
port's ``attention_route`` against the core the reference's ``_attention``
calls, and both packages' towers, gradients and first train step under each
route.

The reference picks a Pallas core only on a TPU: here its
``_use_fused_attention`` is patched to True and each core entry point is
wrapped to record its call and run in interpret mode (nothing in the JAX
package is edited). Inputs are made with numpy from a seed. Tolerances: f32
at rtol = atol = 1e-5 (the reference's own for these kernels), bf16 towers
at cosine >= 0.9999, the first train step's loss and gradients at rtol 1e-4
(as tests/test_torch_train.py).
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image_search_tpu.ops.attention as jattn
from image_search_tpu.config import CLIPConfig, TextConfig, VisionConfig, tiny_test_config
from image_search_tpu.models import clip as jclip
from image_search_tpu.train import contrastive as jtrain
from image_search_tpu_torch.models import clip as tclip
from image_search_tpu_torch.models.convert import build_model, params_from_jax
from image_search_tpu_torch.ops import attention as tattn
from image_search_tpu_torch.train import contrastive

ROUTE_ENV = ("ISX_ATTN_PIPE", "ISX_ATTN_SPLIT", "ISX_VIT_SPAD", "ISX_VIT_SPAD_CPU", "ISX_ATTN_BF16SM")
# the reference's core entry points, each called with interpret as its last argument
REFERENCE_CORES = {
    "attention_grouped_core": "grouped",
    "attention_core": "packed",
    "attention_split_core": "split",
    "fused_attention_split_padded": "padded",
}


@pytest.fixture
def routes(monkeypatch):
    """Clears the route switches; the reference takes its Pallas cores (in
    interpret mode) and records the route of each call it makes."""
    for name in ROUTE_ENV:
        monkeypatch.delenv(name, raising=False)
    calls = []
    monkeypatch.setattr(jclip, "_use_fused_attention", lambda: True)
    for name, route in REFERENCE_CORES.items():
        def wrapped(*args, _orig=getattr(jattn, name), _route=route):
            calls.append(_route)
            return _orig(*args[:-1], True)

        monkeypatch.setattr(jattn, name, wrapped)
    return calls


def _setenv(monkeypatch, **env):
    for k, v in env.items():
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)


def _rand(seed, *shape, scale=0.4):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


class _Spy:
    """Counts calls of one of the port's attention entry points (the CPU
    route counts no launches); ``fail()`` makes a call an error."""

    def __init__(self, monkeypatch, name="fused_attention_split_padded"):
        self.n, self.allowed = 0, True
        orig = getattr(tattn, name)

        def spy(*a, **kw):
            assert self.allowed, f"{name} called"
            self.n += 1
            return orig(*a, **kw)

        monkeypatch.setattr(tattn, name, spy)

    def fail(self):
        self.allowed = False


# --- kernel level -------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,S,H,Hd", [(2, 17, 4, 16), (1, 33, 2, 24)])
def test_packed_plain_matches_pallas(B, S, H, Hd, causal):
    q, k, v = (_rand(B * S + i, B, S, H * Hd) for i in range(3))
    scale = Hd**-0.5
    n0 = tattn.fused_attention_packed.launches
    got = tattn.fused_attention_packed(*map(torch.from_numpy, (q, k, v)), H, causal, scale).numpy()
    assert tattn.fused_attention_packed.launches == n0  # the CPU route launches nothing
    want = jattn.fused_attention_packed(
        *map(jnp.asarray, (q, k, v)), heads=H, causal=causal, sm_scale=scale, interpret=True
    )
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    split = lambda a: torch.from_numpy(a).reshape(B, S, H, Hd)
    direct = tattn.attention_packed_reference(split(q), split(k), split(v), causal, scale)
    np.testing.assert_array_equal(direct.reshape(B, S, H * Hd).numpy(), got)


def test_packed_and_grouped_round_p_at_different_points():
    """bf16: B1p rounds the normalised p, B1 the unnormalised one, so their
    outputs differ in the last bits; in f32 both are the same function."""
    B, S, H, Hd = 2, 40, 2, 16
    q, k, v = (torch.from_numpy(_rand(i, B, S, H * Hd, scale=1.0)) for i in range(3))
    f32 = [fn(q, k, v, H, False) for fn in (tattn.fused_attention, tattn.fused_attention_packed)]
    np.testing.assert_allclose(f32[0].numpy(), f32[1].numpy(), rtol=1e-5, atol=1e-6)
    b16 = [fn(q.bfloat16(), k.bfloat16(), v.bfloat16(), H, False) for fn in (tattn.fused_attention, tattn.fused_attention_packed)]
    assert not torch.equal(b16[0], b16[1])
    np.testing.assert_allclose(b16[0].float().numpy(), b16[1].float().numpy(), atol=2e-2)


@pytest.mark.parametrize("B,S,H,Hd", [(2, 129, 4, 16), (1, 136, 2, 8), (2, 257, 2, 16)])
def test_split_plain_matches_pallas(B, S, H, Hd):
    q, k, v = (_rand(S * 10 + i, B, S, H * Hd) for i in range(3))
    got = tattn.fused_attention_split(*map(torch.from_numpy, (q, k, v)), H, 0.25).numpy()
    want = jattn.fused_attention_split(*map(jnp.asarray, (q, k, v)), heads=H, sm_scale=0.25, interpret=True)
    assert got.shape == (B, S, H * Hd)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    oracle = jattn.attention_reference(*(jnp.asarray(a).reshape(B, S, H, Hd) for a in (q, k, v)), sm_scale=0.25)
    np.testing.assert_allclose(got, np.asarray(oracle).reshape(B, S, H * Hd), rtol=1e-5, atol=1e-5)


def test_split_padded_plain_matches_pallas():
    """Pre-padded operands whose pad rows hold garbage: the real rows equal
    the Pallas kernel's and the oracle's over the real keys, and so do the
    pad query rows (both compute them over the real keys)."""
    B, S, Sp, H, Hd = 2, 129, 136, 4, 16
    q, k, v = (_rand(30 + i, B, Sp, H * Hd, scale=1.0) for i in range(3))
    got = tattn.fused_attention_split_padded(*map(torch.from_numpy, (q, k, v)), H, S, 0.25).numpy()
    want = np.asarray(jattn.fused_attention_split_padded(*map(jnp.asarray, (q, k, v)), H, S, 0.25, True))
    np.testing.assert_allclose(got[:, :S], want[:, :S], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[:, S:], want[:, S:], rtol=1e-5, atol=1e-5)
    oracle = jattn.attention_reference(*(jnp.asarray(a[:, :S]).reshape(B, S, H, Hd) for a in (q, k, v)), sm_scale=0.25)
    np.testing.assert_allclose(got[:, :S], np.asarray(oracle).reshape(B, S, H * Hd), rtol=1e-5, atol=1e-5)


def test_split_padded_skips_pad_keys_whatever_they_hold():
    """Pad keys are left out by index, so inf or NaN in a pad row never
    reaches a real row."""
    B, S, Sp, H = 1, 130, 136, 2
    q, k, v = (torch.from_numpy(_rand(40 + i, B, Sp, H * 8)) for i in range(3))
    base = tattn.fused_attention_split_padded(q, k, v, H, S)
    k2, v2 = k.clone(), v.clone()
    k2[:, S:] = float("inf")
    v2[:, S:] = float("nan")
    got = tattn.fused_attention_split_padded(q, k2, v2, H, S)
    assert torch.isfinite(got).all()
    assert torch.equal(got, base)


def test_split_regime_equals_reference():
    assert [tattn.split_regime(S) for S in range(1, 401)] == [jattn.split_regime(S) for S in range(1, 401)]


def test_split_rejects_a_sequence_outside_its_regime():
    x = torch.zeros(1, 137, 16)
    with pytest.raises(ValueError, match="regime"):
        tattn.fused_attention_split(x, x, x, 2)
    with pytest.raises(ValueError, match="regime"):
        tattn.fused_attention_split_padded(x, x, x, 2, 129)  # Sp must be 136
    t = torch.empty((1, 257, 32), device="meta")
    with pytest.raises(ValueError, match="no route"):
        tattn.fused_attention_split(t, t, t, 2)


# --- route level --------------------------------------------------------------


@pytest.mark.parametrize("pipe", [None, "", "0", "3", "4"])
@pytest.mark.parametrize("heads", [4, 6, 12])
def test_route_names_the_core_the_reference_calls(routes, monkeypatch, heads, pipe):
    """Over ISX_ATTN_PIPE, ISX_ATTN_SPLIT, causal, a sequence in and out of
    the split regime and a padded one: the reference's ``_attention`` (traced
    with abstract inputs) calls exactly the core the port names."""
    Hd = 8
    D = heads * Hd
    cfg = types.SimpleNamespace(num_heads=heads, head_dim=Hd)
    blk = {
        "qkv_w": jax.ShapeDtypeStruct((D, 3 * D), jnp.float32),
        "qkv_b": jax.ShapeDtypeStruct((3 * D,), jnp.float32),
        "o_w": jax.ShapeDtypeStruct((D, D), jnp.float32),
        "o_b": jax.ShapeDtypeStruct((D,), jnp.float32),
    }
    _setenv(monkeypatch, ISX_ATTN_PIPE=pipe)
    seen = set()
    for split in (None, "1"):
        _setenv(monkeypatch, ISX_ATTN_SPLIT=split)
        for S, causal, s_real in ((129, False, None), (129, True, None), (77, True, None), (16, False, None), (136, False, 129)):
            routes.clear()
            x = jax.ShapeDtypeStruct((2, S, D), jnp.float32)
            jax.eval_shape(lambda x_, b_: jclip._attention(x_, b_, cfg, causal, s_real), x, blk)
            want = tattn.attention_route(S, heads, causal, s_real)
            assert routes == [want], (S, causal, s_real, split)
            seen.add(want)
    group = 4 if pipe is None else int(pipe or 0)
    assert seen == {"padded", "split", "grouped" if group > 0 and heads % group == 0 else "packed"}


def test_bf16_softmax_switch_raises_where_the_reference_would_use_it(monkeypatch):
    """ISX_ATTN_BF16SM=1 changes only the grouped route in the reference, and
    that option is not ported: the grouped route raises, the others run."""
    for name in ROUTE_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("ISX_ATTN_BF16SM", "1")
    with pytest.raises(NotImplementedError, match="ISX_ATTN_BF16SM"):
        tattn.attention_route(257, 16, False)
    assert tattn.attention_route(257, 16, False, 257) == "padded"
    monkeypatch.setenv("ISX_ATTN_PIPE", "0")
    assert tattn.attention_route(77, 12, True) == "packed"


def _tiny_s257_cfg():
    """Vision S = (128/8)^2 + 1 = 257, the ViT-L/14 alignment regime at toy
    width (tests/test_spad.py)."""
    return CLIPConfig(
        name="spad-test",
        text=TextConfig(hidden_size=64, num_layers=2, num_heads=4, vocab_size=64, context_length=8, eos_token_id=2),
        vision=VisionConfig(hidden_size=64, num_layers=3, num_heads=4, image_size=128, patch_size=8),
        projection_dim=32,
    )


def _params(cfg, seed):
    """The reference's parameter pytree filled from a numpy seed: LayerNorm
    scales near 1, every other weight N(0, 0.05^2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        base = 1.0 if "ln" in name and name.endswith("scale") else 0.0
        return (base + 0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(lambda: jclip.init_params(jax.random.key(0), cfg)))


@functools.cache
def _models(which):
    """(cfg, reference params, port model f32, port model bf16), built once
    and only read."""
    cfg = tiny_test_config() if which == "tiny" else _tiny_s257_cfg()
    jparams = _params(cfg, 7)
    state = params_from_jax(jparams, cfg)
    return (cfg, jparams, *(build_model(cfg, state, "cpu", dt) for dt in (torch.float32, torch.bfloat16)))


def _ids(cfg, B, seed):
    rng = np.random.default_rng(seed)
    tc = cfg.text
    ids = rng.integers(0, tc.eos_token_id, size=(B, tc.context_length)).astype(np.int32)
    ids[0, 3:] = tc.eos_token_id
    ids[-1, -1] = tc.eos_token_id
    return ids


def _agree(got, want, dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.9999, cos.min()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "which,env,want",
    [
        ("tiny", {}, {"grouped"}),
        ("tiny", {"ISX_ATTN_PIPE": "0"}, {"packed"}),
        ("s257", {"ISX_ATTN_SPLIT": "1"}, {"split"}),
        ("s257", {"ISX_VIT_SPAD": "264", "ISX_VIT_SPAD_CPU": "1"}, {"padded"}),
    ],
)
def test_towers_equal_the_reference_under_each_route(routes, monkeypatch, which, env, want, dtype):
    """Both packages' towers, same weights and inputs, under one route: the
    reference called exactly the route's core, and the embeddings agree.
    The split routes change the vision tower only (the text tower is
    causal), so at S=257 only that tower runs."""
    cfg, jparams, m32, m16 = _models(which)
    _setenv(monkeypatch, **env)
    jdt, model = (jnp.float32, m32) if dtype == "f32" else (jnp.bfloat16, m16)
    px = _rand(5, 2, cfg.vision.image_size, cfg.vision.image_size, 3, scale=1.0)
    with torch.no_grad():
        _agree(tclip.encode_image(model, torch.from_numpy(px)).float().numpy(),
               np.asarray(jclip.encode_image(jparams, cfg, jnp.asarray(px), jdt), np.float32), dtype)
        if which == "tiny":
            ids = _ids(cfg, 3, 6)
            _agree(tclip.encode_text(model, torch.from_numpy(ids.astype(np.int64))).float().numpy(),
                   np.asarray(jclip.encode_text(jparams, cfg, jnp.asarray(ids), jdt), np.float32), dtype)
    assert set(routes) == want


# --- gradients ------------------------------------------------------------------


@pytest.mark.parametrize("route,S,causal", [("packed", 6, False), ("packed", 6, True), ("split", 130, False)])
def test_attention_core_gradcheck_f64(route, S, causal):
    """The route's plain forward and B5's analytic gradient, in f64 (at
    S=130, gradcheck's fast mode: one random projection of the Jacobian
    instead of its 3 x 1040 columns)."""
    rng = np.random.default_rng(S)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, S, 8)) * 0.5).requires_grad_() for _ in range(3))
    fn = lambda a, b, c: tattn.AttentionCore.apply(a, b, c, 2, causal, 0.7, route)
    assert torch.autograd.gradcheck(fn, (q, k, v), fast_mode=S > 100)


@pytest.mark.parametrize("route,S,causal", [("packed", 17, False), ("packed", 17, True), ("split", 129, False)])
def test_attention_core_gradients_equal_jax_grad(route, S, causal):
    """Forward and (dq, dk, dv) against jax.vjp of the reference's
    ``attention_core`` / ``attention_split_core`` in interpret mode (whose
    backward is the Pallas B5, also in interpret mode)."""
    B, H, D = 2, 4, 32
    q, k, v = (_rand(S + i, B, S, D) for i in range(3))
    g = _rand(S + 9, B, S, D, scale=1.0)
    if route == "packed":
        fn = lambda a, b, c: jattn.attention_core(a, b, c, H, causal, 0.5, True)
    else:
        fn = lambda a, b, c: jattn.attention_split_core(a, b, c, H, 0.5, True)
    want_out, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tattn.AttentionCore.apply(*leaves, H, causal, 0.5, route)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)
    for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)


def _train_batch(cfg, B, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.text.vocab_size, size=(B, cfg.text.context_length))
    ids[ids == cfg.text.eos_token_id] = 0
    ids[:, -1] = cfg.text.eos_token_id
    ids[1, 5:] = cfg.text.eos_token_id
    pix = rng.normal(size=(B, cfg.vision.image_size, cfg.vision.image_size, 3))
    return ids.astype(np.int32), pix.astype(np.float32)


def test_first_train_step_on_the_packed_route_matches_reference(monkeypatch):
    """ISX_ATTN_PIPE=0: the port's step runs B1p's and B5's plain versions
    in every layer but the last; loss and every gradient equal
    ``jax.value_and_grad`` of the reference's loss at rtol 1e-4 (in f32 the
    routes compute one function)."""
    for name in ROUTE_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("ISX_ATTN_PIPE", "0")
    cfg = tiny_test_config()
    jparams = _params(cfg, 0)
    ids, pix = _train_batch(cfg, 8, 1)

    def loss_fn(p):
        img, txt, scale = jclip.forward(p, cfg, jnp.asarray(ids), jnp.asarray(pix), compute_dtype=jnp.float32)
        return jtrain.clip_loss(img, txt, scale)[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(jax.tree.map(jnp.asarray, jparams))
    spy = _Spy(monkeypatch, "fused_attention_packed")
    _Spy(monkeypatch, "fused_attention").fail()
    init_fn, step_fn = contrastive.make_train_step(cfg, contrastive.adamw(1e-3), torch.float32, False, "cpu")
    s = init_fn(build_model(cfg, params_from_jax(jparams, cfg), "cpu", torch.float32, trainable=True))
    s, m = step_fn(s, ids, pix)
    assert spy.n == cfg.vision.num_layers + cfg.text.num_layers - 2
    np.testing.assert_allclose(float(m["loss"]), float(want_loss), rtol=1e-4, atol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, want_grads), cfg)
    for name, p in s.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5, err_msg=name)


# --- the padded path's rules ------------------------------------------------------


def test_invalid_padded_length_raises(monkeypatch):
    m32 = _models("s257")[2]
    monkeypatch.setenv("ISX_VIT_SPAD", "384")
    monkeypatch.setenv("ISX_VIT_SPAD_CPU", "1")
    px = torch.from_numpy(_rand(1, 1, 128, 128, 3, scale=1.0))
    with pytest.raises(ValueError, match="ISX_VIT_SPAD"):
        tclip.encode_image(m32, px)


@pytest.mark.parametrize("case", ["off_regime", "remat", "cpu_without_opt_in"])
def test_padded_switch_is_ignored_where_the_reference_ignores_it(monkeypatch, case):
    """An off-regime tower (S=5), a remat forward, and a CPU tensor without
    ISX_VIT_SPAD_CPU=1 never pad: the output is bitwise the unswitched one."""
    for name in ROUTE_ENV:
        monkeypatch.delenv(name, raising=False)
    cfg, _, m32, _ = _models("tiny" if case == "off_regime" else "s257")
    px = torch.from_numpy(_rand(2, 2, cfg.vision.image_size, cfg.vision.image_size, 3, scale=1.0))
    remat = case == "remat"
    with torch.no_grad():
        base = tclip.encode_image(m32, px, remat=remat)
        monkeypatch.setenv("ISX_VIT_SPAD", "264")
        if case != "cpu_without_opt_in":
            monkeypatch.setenv("ISX_VIT_SPAD_CPU", "1")
        spy = _Spy(monkeypatch)
        got = tclip.encode_image(m32, px, remat=remat)
    assert spy.n == 0
    assert torch.equal(got, base)


def test_padded_route_runs_every_layer_but_the_last(monkeypatch):
    for name in ROUTE_ENV:
        monkeypatch.delenv(name, raising=False)
    cfg, _, m32, _ = _models("s257")
    monkeypatch.setenv("ISX_VIT_SPAD", "264")
    monkeypatch.setenv("ISX_VIT_SPAD_CPU", "1")
    spy = _Spy(monkeypatch)
    with torch.no_grad():
        tclip.encode_image(m32, torch.from_numpy(_rand(3, 1, 128, 128, 3, scale=1.0)))
    assert spy.n == cfg.vision.num_layers - 1


def test_gradient_through_the_padded_route_raises(monkeypatch):
    """The reference's padded kernel has no VJP: a train step without remat
    under ISX_VIT_SPAD raises instead of differentiating something else."""
    for name in ROUTE_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("ISX_VIT_SPAD", "264")
    monkeypatch.setenv("ISX_VIT_SPAD_CPU", "1")
    cfg = _tiny_s257_cfg()
    jparams = _params(cfg, 1)
    init_fn, step_fn = contrastive.make_train_step(cfg, contrastive.adamw(1e-3), torch.float32, False, "cpu")
    s = init_fn(build_model(cfg, params_from_jax(jparams, cfg), "cpu", torch.float32, trainable=True))
    ids, pix = _train_batch(cfg, 2, 3)
    with pytest.raises(NotImplementedError, match="ISX_VIT_SPAD"):
        step_fn(s, ids, pix)
