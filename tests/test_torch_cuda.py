"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the towers' and the train step's launches through them.

Needs an NVIDIA GPU and nvcc: every test here is marked ``cuda`` and skips
(decided in a fixture, at run time) where ``torch.cuda.is_available()`` is
false. This file imports no jax, so it also runs on a machine without it;
there, skip tests/conftest.py (which imports jax):

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch
import torch.nn.functional as F

from image_search_tpu_torch.config import CLIPConfig, TextConfig, VisionConfig
from image_search_tpu_torch.ops import attention as attn
from image_search_tpu_torch.ops import blockmax
from image_search_tpu_torch.ops.attention import (
    attention_bwd_reference,
    attention_reference,
    fused_attention,
    fused_attention_bwd,
)
from image_search_tpu_torch.ops.score_stream import (
    NEG_INF,
    quantize_rows_int8,
    scores_int8_reference,
    stream_scores_int8,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


# the head dims the attention kernels (B1, B1p, B5, B6, B7) are built at: the
# learned-retrieval example's towers, ViT-L/14 (and every text tower),
# OpenCLIP H/14's vision tower, bigG's (the contraction padded to 112)
HEAD_DIMS = [32, 64, 80, 104]


def _seed(base: int, Hd: int) -> int:
    """A case's seed: ``base`` at Hd 64, else offset by the head dim."""
    return base if Hd == 64 else base + Hd


@pytest.mark.parametrize("Hd", HEAD_DIMS)
@pytest.mark.parametrize("B,S,H,causal", [(2, 257, 16, False), (3, 77, 12, True), (1, 1, 2, True), (2, 300, 4, False)])
def test_attention_kernel_matches_plain(dev, B, S, H, causal, Hd):
    g = torch.Generator(device=dev).manual_seed(_seed(B * S, Hd))
    D = H * Hd
    qkv = torch.randn(B, S, 3 * D, generator=g, device=dev).bfloat16()
    q = qkv[..., :D] * Hd**-0.5
    k, v = qkv[..., D : 2 * D], qkv[..., 2 * D :]
    n0 = fused_attention.launches
    got = fused_attention(q, k, v, H, causal)
    torch.cuda.synchronize()
    assert fused_attention.launches == n0 + 1
    split = lambda t: t.reshape(B, S, H, Hd)
    want = attention_reference(split(q), split(k), split(v), causal).reshape(B, S, D)
    want32 = attention_reference(split(q).float(), split(k).float(), split(v).float(), causal).reshape(B, S, D)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    assert F.cosine_similarity(got.float().reshape(-1, Hd), want32.reshape(-1, Hd), dim=-1).min() >= 0.9999


def test_attention_kernel_rejects_what_it_cannot_take(dev):
    x = torch.zeros(1, 8, 128, device=dev)
    with pytest.raises(ValueError, match="bf16"):
        fused_attention(x, x, x, 2)
    y = torch.zeros(1, 8, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="head dim"):
        fused_attention(y, y, y, 4)  # Hd = 16


def _tower_qkv(dev, B, S, H, seed, Hd=64):
    """The tower's layout: q scaled by Hd^-0.5 and contiguous, k and v strided
    column blocks of one fused qkv projection."""
    g = torch.Generator(device=dev).manual_seed(seed)
    D = H * Hd
    qkv = torch.randn(B, S, 3 * D, generator=g, device=dev).bfloat16()
    return qkv[..., :D] * Hd**-0.5, qkv[..., D : 2 * D], qkv[..., 2 * D :]


def _close_to_plain(got, want, want32, Hd=64):
    """bf16 kernel vs bf16 plain within 2e-2, and per head vector cosine >=
    0.9999 against the f32 plain version (chip_smoke.py's ATTN_* bounds)."""
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    assert F.cosine_similarity(got.float().reshape(-1, Hd), want32.float().reshape(-1, Hd), dim=-1).min() >= 0.9999


@pytest.mark.parametrize("Hd", HEAD_DIMS)
@pytest.mark.parametrize("B,S,H,causal", [(2, 257, 16, False), (3, 77, 12, True), (1, 1, 2, True), (2, 300, 4, False)])
def test_packed_kernel_matches_plain(dev, B, S, H, causal, Hd):
    """B1p, the route under ISX_ATTN_PIPE=0."""
    q, k, v = _tower_qkv(dev, B, S, H, _seed(B * S + 2, Hd), Hd)
    n0 = attn.fused_attention_packed.launches
    got = attn.fused_attention_packed(q, k, v, H, causal)
    torch.cuda.synchronize()
    assert attn.fused_attention_packed.launches == n0 + 1
    split = lambda t: t.reshape(B, S, H, Hd)
    want = attn.attention_packed_reference(split(q), split(k), split(v), causal).reshape(B, S, H * Hd)
    want32 = attn.attention_packed_reference(*(split(t).float() for t in (q, k, v)), causal).reshape(B, S, H * Hd)
    _close_to_plain(got, want, want32, Hd)


@pytest.mark.parametrize("Hd", HEAD_DIMS)
@pytest.mark.parametrize("B,S,H", [(2, 257, 16), (3, 129, 4), (1, 136, 2)])
def test_split_kernel_matches_plain(dev, B, S, H, Hd):
    """B6 on unpadded operands, the route under ISX_ATTN_SPLIT=1."""
    q, k, v = _tower_qkv(dev, B, S, H, _seed(B * S + 3, Hd), Hd)
    n0 = attn.fused_attention_split.launches
    got = attn.fused_attention_split(q, k, v, H)
    torch.cuda.synchronize()
    assert attn.fused_attention_split.launches == n0 + 1
    want = attn.fused_attention_split(q.cpu(), k.cpu(), v.cpu(), H)
    want32 = attn.fused_attention_split(q.cpu().float(), k.cpu().float(), v.cpu().float(), H)
    _close_to_plain(got.cpu(), want, want32, Hd)


@pytest.mark.parametrize("Hd", HEAD_DIMS)
@pytest.mark.parametrize("B,S,H", [(2, 257, 16), (3, 129, 4), (1, 136, 2)])
def test_split_padded_kernel_matches_plain_and_skips_pad_keys(dev, B, S, H, Hd):
    """B6 on operands padded to Sp rows, the route under ISX_VIT_SPAD: every
    row against the plain version, and inf/NaN in the pad rows of k and v
    change nothing (pad keys are skipped by index)."""
    Sp = (S // 128) * 128 + 8
    q, k, v = _tower_qkv(dev, B, Sp, H, _seed(B * S + 4, Hd), Hd)
    n0 = attn.fused_attention_split_padded.launches
    got = attn.fused_attention_split_padded(q, k, v, H, S)
    torch.cuda.synchronize()
    assert attn.fused_attention_split_padded.launches == n0 + 1
    split = lambda t: t.reshape(B, Sp, H, Hd)
    want = attn.attention_split_reference(split(q), split(k), split(v), S).reshape(B, Sp, H * Hd)
    want32 = attn.attention_split_reference(*(split(t).float() for t in (q, k, v)), S).reshape(B, Sp, H * Hd)
    _close_to_plain(got, want, want32, Hd)
    k2, v2 = k.clone(), v.clone()
    k2[:, S:] = float("inf")
    v2[:, S:] = float("nan")
    assert torch.equal(attn.fused_attention_split_padded(q, k2, v2, H, S), got)


def test_packed_and_split_kernels_reject_what_they_cannot_take(dev):
    """Wrong dtype, an unbuilt head dim, and a sequence outside the split
    regime all raise; nothing falls back to another route."""
    z = lambda S, dtype=torch.bfloat16: torch.zeros(1, S, 128, device=dev, dtype=dtype)
    calls = (
        lambda t, h: attn.fused_attention_packed(t, t, t, h),
        lambda t, h: attn.fused_attention_split(t, t, t, h),
        lambda t, h: attn.fused_attention_split_padded(t, t, t, h, 257),
    )
    for call, S in zip(calls, (257, 257, 264)):
        with pytest.raises(ValueError, match="bf16"):
            call(z(S, torch.float32), 2)
        with pytest.raises(NotImplementedError, match="head dim"):
            call(z(S), 8)  # Hd = 16
    with pytest.raises(ValueError, match="regime"):
        attn.fused_attention_split(z(300), z(300), z(300), 2)
    with pytest.raises(ValueError, match="regime"):
        attn.fused_attention_split_padded(z(300), z(300), z(300), 2, 257)  # Sp must be 264


@pytest.mark.parametrize("Hd", HEAD_DIMS)
@pytest.mark.parametrize(
    "B,S,H,causal",
    [(64, 257, 16, False), (64, 77, 12, True), (1, 1, 2, True), (2, 300, 4, False), (3, 33, 2, True), (2, 200, 4, True)],
)
def test_attention_bwd_kernel_matches_plain(dev, B, S, H, causal, Hd):
    """B5 at the train step's shapes (vision and text at batch 64) and odd
    ones, at every head dim it is built at: within 2e-2 x max|plain| of the
    bf16 plain version, and per (batch, head) cosine >= 0.999 against the f32
    plain version."""
    g = torch.Generator(device=dev).manual_seed(_seed(B * S + 1, Hd))
    D = H * Hd
    qkv = torch.randn(B, S, 3 * D, generator=g, device=dev).bfloat16()
    q = qkv[..., :D] * Hd**-0.5
    k, v = qkv[..., D : 2 * D], qkv[..., 2 * D :]
    go = torch.randn(B, S, D, generator=g, device=dev).bfloat16()
    n0 = fused_attention_bwd.launches
    got = fused_attention_bwd(q, k, v, go, H, causal)
    torch.cuda.synchronize()
    assert fused_attention_bwd.launches == n0 + 1
    want = attention_bwd_reference(q, k, v, go, H, causal)
    want32 = attention_bwd_reference(q.float(), k.float(), v.float(), go.float(), H, causal)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, want32):
        assert a.dtype == torch.bfloat16 and a.is_contiguous(), name
        assert (a.float() - b.float()).abs().max().item() <= 2e-2 * b.float().abs().max().item(), name
        heads = lambda t: t.float().reshape(B, S, H, Hd).permute(0, 2, 1, 3).reshape(B * H, S * Hd)
        a, c = heads(a), heads(c)
        live = c.norm(dim=-1) > 0  # at S = 1 the softmax has no gradient: dq = dk = 0
        assert torch.equal(a[~live], torch.zeros_like(a[~live])), name
        if live.any():
            assert F.cosine_similarity(a[live], c[live], dim=-1).min() >= 0.999, name


def test_attention_bwd_kernel_rejects_what_it_cannot_take(dev):
    x = torch.zeros(1, 8, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        fused_attention_bwd(x, x, x, x.float(), 2)
    with pytest.raises(NotImplementedError, match="head dim"):
        fused_attention_bwd(x, x, x, x, 8)  # Hd = 16
    with pytest.raises(ValueError, match="shape"):
        fused_attention_bwd(x, x, x, torch.zeros(1, 9, 128, device=dev, dtype=torch.bfloat16), 2)


@pytest.mark.parametrize(
    "N,D,B,pens",
    [(100_003, 768, 1, False), (100_003, 768, 8, True), (4099, 768, 32, True), (777, 12, 3, True),
     (10_007, 768, 7, True), (10_007, 768, 16, False), (10_007, 768, 17, True), (10_007, 768, 129, False),
     (1000, 100, 17, True), (130, 36, 1, False)],
)
def test_score_kernel_bitwise_equals_plain(dev, N, D, B, pens):
    """One launch, bitwise the plain version, at every ragged edge: B across
    the 16 / 64 / 128 query tiles, N not a multiple of the 128-row tile, D
    not a multiple of the 64-byte ring step (and of 16: the 4-byte copies),
    and limit at N, just below it, at 0, inside a row tile and past N."""
    g = torch.Generator(device=dev).manual_seed(N + B)
    rows, scales = quantize_rows_int8(F.normalize(torch.randn(N, D, generator=g, device=dev), dim=-1))
    qi, qs = quantize_rows_int8(F.normalize(torch.randn(B, D, generator=g, device=dev), dim=-1))
    pen = None
    if pens:
        pen = torch.zeros(N, device=dev)
        pen[torch.randint(0, N, (N // 50 + 1,), generator=g, device=dev)] = NEG_INF
    for limit in (N, N - 3, 0, min(N, 128) - 37, N + 1000):
        n0 = stream_scores_int8.launches
        got = stream_scores_int8(rows, qi, qs, scales, limit, pen)
        torch.cuda.synchronize()
        assert stream_scores_int8.launches == n0 + 1
        assert torch.equal(got, scores_int8_reference(rows, qi, qs, scales, limit, pen))


@pytest.mark.parametrize("B", [1024, 1500])
def test_score_kernel_takes_a_large_batch_in_one_launch(dev, B):
    """The legacy duplicate scan's batch of 1024 queries at D = 768 (and a
    batch whose last query tile is ragged): one launch, bitwise equal to the
    plain version, with and without penalties."""
    g = torch.Generator(device=dev).manual_seed(B)
    N, D = 65_536, 768
    rows, scales = quantize_rows_int8(F.normalize(torch.randn(N, D, generator=g, device=dev), dim=-1))
    qi, qs = quantize_rows_int8(F.normalize(torch.randn(B, D, generator=g, device=dev), dim=-1))
    pen = torch.zeros(N, device=dev)
    pen[torch.randint(0, N, (1000,), generator=g, device=dev)] = NEG_INF
    for p in (None, pen):
        n0 = stream_scores_int8.launches
        got = stream_scores_int8(rows, qi, qs, scales, N - 5, p)
        torch.cuda.synchronize()
        assert stream_scores_int8.launches == n0 + 1
        assert torch.equal(got, scores_int8_reference(rows, qi, qs, scales, N - 5, p))


def _sketches(dev, n, da, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(n, da, generator=g, device=dev) / da**0.5).bfloat16()


def _threshold_between_maxima(m, q):
    """A threshold near quantile q of the finite block maxima with no
    maximum within 1e-5 of it (summation order may move a maximum by ~1e-7)."""
    v = torch.sort(m[torch.isfinite(m)].flatten()).values
    gaps = v[1:] - v[:-1]
    i = int(q * (len(v) - 1))
    while gaps[i] < 2e-5:
        i += 1
    return float((v[i] + v[i + 1]) / 2)


@pytest.mark.parametrize(
    "R,N,da,rb0",
    [(1024, 8192, 65, 0), (2048, 8192, 65, 4), (1024, 4096, 17, 3), (1024, 4096, 80, 1), (1024, 8192, 72, 2),
     (1024, 8192, 33, 5), (2048, 16384, 65, 40)],
)
def test_blockpair_mask_kernel_bitwise_equals_plain(dev, R, N, da, rb0):
    s_cols = _sketches(dev, N, da, R + N + da)
    s_rows = s_cols[rb0 * 128 : rb0 * 128 + R].contiguous() if rb0 * 128 + R <= N else _sketches(dev, R, da, 1)
    m = blockmax.blockpair_values_reference(s_rows, s_cols, rb0)
    for q in (0.5, 0.99):
        thr = _threshold_between_maxima(m, q)
        n0 = blockmax.blockpair_mask.launches
        got = blockmax.blockpair_mask(s_rows, s_cols, thr, rb0)
        torch.cuda.synchronize()
        assert blockmax.blockpair_mask.launches == n0 + 1
        want = blockmax.blockpair_mask_reference(s_rows, s_cols, thr, rb0)
        assert got.dtype == torch.int32 and torch.equal(got, want)
        assert bool((want < 0).any()) or q > 0.9  # bit 31 set somewhere at the median


@pytest.mark.parametrize(
    "R,N,da,rb0",
    [(1024, 16384, 65, 4), (2048, 16384, 65, 0), (1024, 16384, 33, 100), (2048, 16384, 72, 40), (1024, 16384, 17, 0)],
)
def test_blockpair_values_kernel_matches_plain(dev, R, N, da, rb0):
    s_cols = _sketches(dev, N, da, R + N)
    s_rows = _sketches(dev, R, da, 2)
    n0 = blockmax.blockpair_values.launches
    got = blockmax.blockpair_values(s_rows, s_cols, rb0)
    torch.cuda.synchronize()
    assert blockmax.blockpair_values.launches == n0 + 1
    want = blockmax.blockpair_values_reference(s_rows, s_cols, rb0)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    assert (got[fin] - want[fin]).abs().max().item() <= 2e-5


@pytest.mark.parametrize("rb0", [0, 40])
def test_blockpair_kernels_take_the_scan_slab_padded_to_80(dev, rb0):
    """The duplicate scan's operand (dupscan._prep_sketch pads d_a = 65 to
    80 with zeros, so the launch copies nothing): the words bitwise and the
    maxima within 2e-5 of the plain versions on the 65-wide operand, with a
    row block past the first column word at rb0 = 40."""
    R, N = 2048, 16384
    s65 = _sketches(dev, N, 65, 80 + rb0)
    s80 = F.pad(s65, (0, 15))
    rows65, rows80 = s65[rb0 * 128 : rb0 * 128 + R], s80[rb0 * 128 : rb0 * 128 + R]
    want = blockmax.blockpair_values_reference(rows65, s65, rb0)
    n0 = blockmax.blockpair_values.launches
    got = blockmax.blockpair_values(rows80, s80, rb0)
    torch.cuda.synchronize()
    assert blockmax.blockpair_values.launches == n0 + 1
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    assert (got[fin] - want[fin]).abs().max().item() <= 2e-5
    for q in (0.5, 0.99):
        thr = _threshold_between_maxima(want, q)
        assert torch.equal(blockmax.blockpair_mask(rows80, s80, thr, rb0),
                           blockmax.blockpair_mask_reference(rows65, s65, thr, rb0))


def test_blockpair_kernels_reject_what_they_cannot_take(dev):
    a = torch.zeros(1024, 81, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="depth"):
        blockmax.blockpair_mask(a, torch.zeros(4096, 81, device=dev, dtype=torch.bfloat16), 0.5, 0)
    with pytest.raises(ValueError, match="bf16"):
        blockmax.blockpair_values(a.float(), torch.zeros(16384, 81, device=dev), 0)
    with pytest.raises(ValueError, match="multiple"):
        blockmax.blockpair_mask(a[:, :65], a[:, :65], 0.5, 0)


def test_score_kernel_rejects_what_it_cannot_take(dev):
    rows = torch.zeros(8, 6, dtype=torch.int8, device=dev)
    s = torch.ones(8, device=dev)
    q = torch.zeros(1, 6, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        stream_scores_int8(rows, q, torch.ones(1, device=dev), s, 8)
    with pytest.raises(ValueError, match="int8"):
        stream_scores_int8(rows.float(), q, torch.ones(1, device=dev), s, 8)


def test_towers_launch_the_kernel_once_per_layer_but_the_last(dev):
    """A narrow CLIP whose heads are 64 wide: every layer but the CLS/EOS
    one goes through the kernel, and the bf16 card output stays close to
    the f32 CPU forward of the same weights."""
    from image_search_tpu_torch.models.clip import encode_image, encode_text
    from image_search_tpu_torch.models.convert import build_model, init_params

    cfg = CLIPConfig(
        name="narrow-64",
        text=TextConfig(hidden_size=256, num_layers=3, num_heads=4, vocab_size=300, context_length=20, eos_token_id=299),
        vision=VisionConfig(hidden_size=256, num_layers=4, num_heads=4, image_size=56, patch_size=14),
        projection_dim=32,
    )
    state = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev, torch.bfloat16)
    model = build_model(cfg, state, dev, torch.bfloat16)
    cpu = build_model(cfg, {k: t.float().cpu() for k, t in state.items()}, "cpu", torch.float32)
    px = torch.randn(3, 56, 56, 3)
    ids = torch.randint(0, 299, (3, 20))
    ids[:, 9:] = 299
    n0 = fused_attention.launches
    img = encode_image(model, px.to(dev))
    n1 = fused_attention.launches
    txt = encode_text(model, ids.to(dev))
    n2 = fused_attention.launches
    assert (n1 - n0, n2 - n1) == (3, 2)
    assert F.cosine_similarity(img.float().cpu(), encode_image(cpu, px), dim=-1).min() >= 0.99
    assert F.cosine_similarity(txt.float().cpu(), encode_text(cpu, ids), dim=-1).min() >= 0.99


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_launches_b5_once_per_layer_but_the_last(dev, remat):
    """A narrow CLIP whose heads are 64 wide, f32 master weights and bf16
    compute on the card: every attention core's backward goes through B5
    (all layers under remat, whose recompute runs B1 a second time), and the
    gradients stay close to the f32 CPU step of the same weights."""
    from image_search_tpu_torch.models.convert import build_model, init_params
    from image_search_tpu_torch.train.contrastive import adamw, make_train_step

    cfg = CLIPConfig(
        name="narrow-64",
        text=TextConfig(hidden_size=256, num_layers=3, num_heads=4, vocab_size=300, context_length=20, eos_token_id=299),
        vision=VisionConfig(hidden_size=256, num_layers=4, num_heads=4, image_size=56, patch_size=14),
        projection_dim=32,
    )
    state = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    px = torch.randn(4, 56, 56, 3, generator=torch.Generator().manual_seed(1))
    ids = torch.randint(0, 299, (4, 20), generator=torch.Generator().manual_seed(2))
    ids[:, 9:] = 299
    grads = {}
    for where, dtype in ((dev, torch.bfloat16), (torch.device("cpu"), torch.float32)):
        init_fn, step_fn = make_train_step(
            cfg, adamw(1e-4), dtype, remat, where, remat_policy="dots_with_no_batch_dims_saveable"
        )
        s = init_fn(build_model(cfg, state, where, torch.float32, trainable=True))
        n_fwd, n_bwd = fused_attention.launches, fused_attention_bwd.launches
        s, m = step_fn(s, ids, px)
        assert torch.isfinite(m["loss"])
        if where == dev:
            torch.cuda.synchronize()
            L = cfg.vision.num_layers + cfg.text.num_layers - (0 if remat else 2)
            assert fused_attention_bwd.launches - n_bwd == L
            assert fused_attention.launches - n_fwd == (2 * L if remat else L)
        grads[where.type] = torch.cat([p.grad.float().cpu().flatten() for p in s.model.parameters()])
    assert F.cosine_similarity(grads["cuda"], grads["cpu"], dim=0) >= 0.99


_ROUTE_KERNELS = ("fused_attention", "fused_attention_packed", "fused_attention_split", "fused_attention_split_padded")
_ROUTES = {  # switches -> (vision tower's entry point, text tower's)
    "packed": ({"ISX_ATTN_PIPE": "0"}, "fused_attention_packed", "fused_attention_packed"),
    "split": ({"ISX_ATTN_SPLIT": "1"}, "fused_attention_split", "fused_attention"),
    "padded": ({"ISX_VIT_SPAD": "264"}, "fused_attention_split_padded", "fused_attention"),
}


def _narrow_257():
    """Heads 64 wide, 4 of them (the default head group divides them: B1 is
    the default route), and the vision tower at ViT-L/14's S = 257."""
    return CLIPConfig(
        name="narrow-64-s257",
        text=TextConfig(hidden_size=256, num_layers=3, num_heads=4, vocab_size=300, context_length=20, eos_token_id=299),
        vision=VisionConfig(hidden_size=256, num_layers=3, num_heads=4, image_size=224, patch_size=14),
        projection_dim=32,
    )


def _route_counts():
    return {name: getattr(attn, name).launches for name in _ROUTE_KERNELS}


def _launched(before, after):
    return {k: v - before[k] for k, v in after.items() if v != before[k]}


@pytest.mark.parametrize("route", sorted(_ROUTES))
def test_towers_take_each_route(dev, monkeypatch, route):
    """Under each route's switch a forward launches its core L-1 times per
    tower and nothing else (vision on B1p or B6, text on B1p or B1), and the
    bf16 card output stays close to the f32 CPU forward of the same weights."""
    from image_search_tpu_torch.models.clip import encode_image, encode_text
    from image_search_tpu_torch.models.convert import build_model, init_params

    env, vision_kernel, text_kernel = _ROUTES[route]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = _narrow_257()
    state = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev, torch.bfloat16)
    model = build_model(cfg, state, dev, torch.bfloat16)
    px = torch.randn(3, 224, 224, 3)
    ids = torch.randint(0, 299, (3, 20))
    ids[:, 9:] = 299
    with torch.no_grad():
        n0 = _route_counts()
        img = encode_image(model, px.to(dev))
        n1 = _route_counts()
        txt = encode_text(model, ids.to(dev))
        n2 = _route_counts()
        torch.cuda.synchronize()
    assert _launched(n0, n1) == {vision_kernel: 2}
    assert _launched(n1, n2) == {text_kernel: 2}
    cpu = build_model(cfg, {k: t.float().cpu() for k, t in state.items()}, "cpu", torch.float32)
    with torch.no_grad():
        assert F.cosine_similarity(img.float().cpu(), encode_image(cpu, px), dim=-1).min() >= 0.99
        assert F.cosine_similarity(txt.float().cpu(), encode_text(cpu, ids), dim=-1).min() >= 0.99


@pytest.mark.parametrize("route", ["packed", "split"])
def test_train_step_takes_each_route_with_b5(dev, monkeypatch, route):
    """A train step on the packed and split routes: the route's forward runs
    in every layer but the last, B5 makes one launch per such layer, and the
    gradients stay close to the f32 CPU step. The padded route has no
    gradient and raises."""
    from image_search_tpu_torch.models.convert import build_model, init_params
    from image_search_tpu_torch.train.contrastive import adamw, make_train_step

    env, vision_kernel, text_kernel = _ROUTES[route]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = _narrow_257()
    state = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    px = torch.randn(4, 224, 224, 3, generator=torch.Generator().manual_seed(1))
    ids = torch.randint(0, 299, (4, 20), generator=torch.Generator().manual_seed(2))
    ids[:, 9:] = 299
    grads = {}
    for where, dtype in ((dev, torch.bfloat16), (torch.device("cpu"), torch.float32)):
        init_fn, step_fn = make_train_step(cfg, adamw(1e-4), dtype, False, where)
        s = init_fn(build_model(cfg, state, where, torch.float32, trainable=True))
        n0, b0 = _route_counts(), fused_attention_bwd.launches
        s, m = step_fn(s, ids, px)
        assert torch.isfinite(m["loss"])
        if where == dev:
            torch.cuda.synchronize()
            want = {vision_kernel: 2}
            want[text_kernel] = want.get(text_kernel, 0) + 2
            assert _launched(n0, _route_counts()) == want
            assert fused_attention_bwd.launches - b0 == 4
        grads[where.type] = torch.cat([p.grad.float().cpu().flatten() for p in s.model.parameters()])
    assert F.cosine_similarity(grads["cuda"], grads["cpu"], dim=0) >= 0.99

    monkeypatch.setenv("ISX_VIT_SPAD", "264")
    init_fn, step_fn = make_train_step(cfg, adamw(1e-4), torch.bfloat16, False, dev)
    s = init_fn(build_model(cfg, state, dev, torch.float32, trainable=True))
    with pytest.raises(NotImplementedError, match="ISX_VIT_SPAD"):
        step_fn(s, ids, px)


# --- B7, B8 and B9 and the fused-block compositions ---------------------------------


def _packed_qkv(dev, B, S, H, seed, Hd=64):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(B, S, 3 * H * Hd, generator=g, device=dev).bfloat16()


def _views(qkv):
    D = qkv.shape[-1] // 3
    return qkv[..., :D], qkv[..., D : 2 * D], qkv[..., 2 * D :]


@pytest.mark.parametrize("Hd", HEAD_DIMS)
@pytest.mark.parametrize("B,S,H,causal", [(2, 257, 16, False), (3, 77, 12, True), (1, 1, 2, True), (2, 300, 4, False)])
def test_qkv_packed_kernel_matches_plain_and_b1p_bitwise(dev, B, S, H, causal, Hd):
    """B7 on the three column views with sm_scale 0.125 in the f32 logits:
    close to its plain version, and bitwise equal to B1p on (q * 0.125, k,
    v) at sm_scale 1 (a power of two scales q exactly in bf16)."""
    qkv = _packed_qkv(dev, B, S, H, _seed(B * S + 5, Hd), Hd)
    n0 = attn.fused_attention_qkv_packed.launches
    got = attn.fused_attention_qkv_packed(qkv, H, causal, 0.125)
    torch.cuda.synchronize()
    assert attn.fused_attention_qkv_packed.launches == n0 + 1
    split = lambda t: t.reshape(B, S, H, Hd)
    q, k, v = _views(qkv)
    want = attn.attention_packed_reference(split(q), split(k), split(v), causal, 0.125).reshape(B, S, H * Hd)
    want32 = attn.attention_packed_reference(*(split(t).float() for t in (q, k, v)), causal, 0.125).reshape(B, S, H * Hd)
    _close_to_plain(got, want, want32, Hd)
    assert torch.equal(got, attn.fused_attention_packed(q * 0.125, k, v, H, causal))


@pytest.mark.parametrize("B,S,H,causal", [(4, 257, 16, False), (4, 77, 12, True)])
def test_qkv_packed_core_backward_is_b5_on_the_views(dev, B, S, H, causal):
    qkv = _packed_qkv(dev, B, S, H, B * S + 6).requires_grad_()
    go = torch.randn(B, S, H * 64, device=dev).bfloat16()
    n0 = fused_attention_bwd.launches
    (dqkv,) = torch.autograd.grad(attn.AttentionQkvPackedCore.apply(qkv, H, causal, 0.125), qkv, go)
    torch.cuda.synchronize()
    assert fused_attention_bwd.launches == n0 + 1
    want = torch.cat(attention_bwd_reference(*_views(qkv.detach()), go, H, causal, 0.125), dim=-1)
    assert dqkv.shape == qkv.shape and dqkv.dtype == torch.bfloat16
    assert (dqkv.float() - want.float()).abs().max().item() <= 2e-2 * want.float().abs().max().item()


@pytest.mark.parametrize(
    "B,S,H,causal",
    [(2, 257, 16, False), (3, 77, 12, True), (1, 1, 2, True), (2, 130, 4, False), (2, 17, 4, True), (1, 320, 2, False)],
)
def test_qkv_attention_kernel_matches_plain(dev, B, S, H, causal):
    """B8: the projection in the kernel's own mma tiles, then B7's attention."""
    g = torch.Generator(device=dev).manual_seed(B * S + 7)
    D = H * 64
    x = torch.randn(B, S, D, generator=g, device=dev).bfloat16()
    w = (torch.randn(3 * D, D, generator=g, device=dev) * D**-0.5).bfloat16()
    b = (torch.randn(3 * D, generator=g, device=dev) * 0.1).bfloat16()
    n0 = attn.fused_qkv_attention.launches
    got = attn.fused_qkv_attention(x, w, b, H, causal, 0.125)
    torch.cuda.synchronize()
    assert attn.fused_qkv_attention.launches == n0 + 1
    want = attn.qkv_attention_reference(x, w, b, H, causal, 0.125)
    want32 = attn.qkv_attention_reference(x.float(), w.float(), b.float(), H, causal, 0.125)
    _close_to_plain(got, want, want32)


@pytest.mark.parametrize("B,S,H,causal", [(8, 257, 16, False), (32, 77, 12, True), (2, 1, 2, True), (3, 300, 4, False)])
def test_qkv_attention_is_b7_on_its_projection(dev, B, S, H, causal):
    """B8's attention phase is B7's body (attention_tc.cuh) on the qkv its
    projection phase writes: bitwise B7 on the probe's qkv, at the vision
    and the text shape and at ragged S; the probe's qkv is bf16(x w^T) + b
    within the round-off of two bf16 roundings and of two f32 sums of D
    products in different orders (D * 2^-24 * sum |x w| each)."""
    g = torch.Generator(device=dev).manual_seed(B * S + 9)
    D = H * 64
    x = torch.randn(B, S, D, generator=g, device=dev).bfloat16()
    w = (torch.randn(3 * D, D, generator=g, device=dev) * D**-0.5).bfloat16()
    b = (torch.randn(3 * D, generator=g, device=dev) * 0.1).bfloat16()
    n0 = attn.fused_qkv_attention.launches
    qkv = attn.qkv_attention_probe(x, w, b, H)
    got = attn.fused_qkv_attention(x, w, b, H, causal, 0.125)
    torch.cuda.synchronize()
    assert attn.fused_qkv_attention.launches == n0 + 1  # the probe counts no launch
    assert qkv.shape == (B, S, 3 * D) and qkv.dtype == torch.bfloat16
    assert torch.equal(got, attn.fused_attention_qkv_packed(qkv, H, causal, 0.125))
    acc = torch.matmul(x.float(), w.float().t())
    tol = 2.0**-7 * (2 * acc.abs() + b.float().abs()) + 2 * D * 2.0**-24 * torch.matmul(x.float().abs(), w.float().abs().t())
    err = (qkv.float() - (acc.bfloat16() + b).float()).abs()
    assert bool((err <= tol).all())
    assert (err == 0).float().mean().item() > 0.99


def test_qkv_kernels_reject_what_they_cannot_take(dev):
    x = torch.zeros(2, 8, 128, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(384, 128, device=dev, dtype=torch.bfloat16)
    b = torch.zeros(384, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        attn.fused_qkv_attention(x.float(), w, b, 2)
    with pytest.raises(NotImplementedError, match="head dim"):
        attn.fused_qkv_attention(x, w, b, 8)  # Hd = 16
    with pytest.raises(ValueError, match="contiguous"):
        attn.fused_qkv_attention(x.transpose(0, 1).contiguous().transpose(0, 1), w, b, 2)
    with pytest.raises(ValueError, match="shape"):
        attn.fused_qkv_attention(x, w[:256], b, 2)
    with pytest.raises(NotImplementedError, match="S=321"):
        attn.fused_qkv_attention(torch.zeros(1, 321, 128, device=dev, dtype=torch.bfloat16), w, b, 2)
    with pytest.raises(ValueError, match="card only"):
        attn.qkv_attention_probe(x.cpu(), w.cpu(), b.cpu(), 2)
    with pytest.raises(ValueError, match="bf16"):
        attn.fused_attention_qkv_packed(torch.zeros(1, 8, 384, device=dev), 2)
    with pytest.raises(NotImplementedError, match="head dim"):
        attn.fused_attention_qkv_packed(torch.zeros(1, 8, 384, device=dev, dtype=torch.bfloat16), 8)


@pytest.mark.parametrize("Hd", [80, 104])
def test_qkv_kernel_raises_at_the_ladder_head_dims_and_bwd_kernel_runs(dev, Hd):
    """B8 is built at head dim 64 only: at H/14's 80 and bigG's 104 it raises
    NotImplementedError naming the head dim and ROADMAP B.1, and never
    reaches a kernel. B5 and the forward run at the same head dims; B5 at a
    head dim that no kernel is built at raises the same way."""
    H = 2
    x = torch.zeros(1, 8, H * Hd, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(3 * H * Hd, H * Hd, device=dev, dtype=torch.bfloat16)
    b = torch.zeros(3 * H * Hd, device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match=f"head dim {Hd} not built.*ROADMAP B.1"):
        attn.fused_qkv_attention(x, w, b, H)
    with pytest.raises(NotImplementedError, match=f"head dim {Hd} not built.*ROADMAP B.1"):
        attn.qkv_attention_probe(x, w, b, H)
    assert fused_attention(x, x, x, H).shape == x.shape
    n0 = fused_attention_bwd.launches_by_hd.get(Hd, 0)
    assert all(t.shape == x.shape for t in fused_attention_bwd(x, x, x, x, H))
    assert fused_attention_bwd.launches_by_hd[Hd] == n0 + 1
    y = torch.zeros(1, 8, 2 * 48, device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="head dim 48 not built"):
        fused_attention_bwd(y, y, y, y, 2)


def _ladder_depth2(name):
    """An OpenCLIP ladder preset at full width, both towers cut to 2 layers."""
    import dataclasses

    from image_search_tpu_torch.config import get_config

    cfg = get_config(name)
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, num_layers=2), vision=dataclasses.replace(cfg.vision, num_layers=2)
    )


@pytest.mark.parametrize("name", ["openclip-vit-H-14", "openclip-vit-bigG-14"])
def test_ladder_towers_launch_b1_at_their_head_dims(dev, name):
    """H/14 (vision Hd 80) and bigG (Hd 104) at full width and depth 2: the
    vision tower launches B1 once per layer but the last, so does the text
    tower (Hd 64), and the bf16 card embeddings stay close to the f32 CPU
    forward of the same weights (the repo's bf16 policy bound)."""
    from image_search_tpu_torch.models.clip import encode_image, encode_text
    from image_search_tpu_torch.models.convert import build_model, init_params

    cfg = _ladder_depth2(name)
    state = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev, torch.bfloat16)
    model = build_model(cfg, state, dev, torch.bfloat16)
    px = torch.randn(4, 224, 224, 3, generator=torch.Generator().manual_seed(1))
    ids = torch.randint(0, 49407, (4, 77), generator=torch.Generator().manual_seed(2))
    ids[:, 9:] = 49407
    with torch.no_grad():
        n0 = _route_counts()
        img = encode_image(model, px.to(dev))
        n1 = _route_counts()
        txt = encode_text(model, ids.to(dev))
        n2 = _route_counts()
        torch.cuda.synchronize()
    assert _launched(n0, n1) == {"fused_attention": 1}
    assert _launched(n1, n2) == {"fused_attention": 1}
    cpu = build_model(cfg, {k: t.float().cpu() for k, t in state.items()}, "cpu", torch.float32)
    with torch.no_grad():
        assert F.cosine_similarity(img.float().cpu(), encode_image(cpu, px), dim=-1).min() >= 0.99
        assert F.cosine_similarity(txt.float().cpu(), encode_text(cpu, ids), dim=-1).min() >= 0.99


@pytest.mark.parametrize("name", ["openclip-vit-H-14", "openclip-vit-bigG-14"])
def test_ladder_train_step_launches_b5_at_its_head_dims(dev, name):
    """A train step of H/14 and bigG at full width and depth 2 on the card (f32
    master weights, bf16 compute): it completes, B5 runs once in each
    tower's first layer at that tower's head dim (vision 80 or 104, text
    64), and the gradients stay close to the f32 CPU step of the same
    weights (chip_smoke.py's GRAD_MIN_COS)."""
    from image_search_tpu_torch.models.convert import build_model, init_params
    from image_search_tpu_torch.train.contrastive import adamw, make_train_step

    cfg = _ladder_depth2(name)
    Hd_v = cfg.vision.hidden_size // cfg.vision.num_heads
    state = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    px = torch.randn(2, 224, 224, 3, generator=torch.Generator().manual_seed(1))
    ids = torch.randint(0, 49407, (2, 77), generator=torch.Generator().manual_seed(2))
    ids[:, 9:] = 49407
    grads = {}
    for where, dtype in ((dev, torch.bfloat16), (torch.device("cpu"), torch.float32)):
        init_fn, step_fn = make_train_step(cfg, adamw(1e-4), dtype, False, where)
        s = init_fn(build_model(cfg, state, where, torch.float32, trainable=True))
        before = dict(fused_attention_bwd.launches_by_hd)
        s, m = step_fn(s, ids, px)
        assert torch.isfinite(m["loss"])
        if where == dev:
            torch.cuda.synchronize()
            after = fused_attention_bwd.launches_by_hd
            assert {hd: n - before.get(hd, 0) for hd, n in after.items() if n != before.get(hd, 0)} == {Hd_v: 1, 64: 1}
        grads[where.type] = torch.cat([p.grad.float().cpu().flatten() for p in s.model.parameters()])
        del s, init_fn, step_fn
    assert F.cosine_similarity(grads["cuda"], grads["cpu"], dim=0) >= 0.99


@pytest.mark.parametrize(
    "M,K,N",
    [(41_120, 1024, 3072), (1000, 1024, 4096), (33, 32, 48), (130, 40, 200), (1, 8, 8), (41_120, 1024, 4096),
     (257, 72, 136)],
)
def test_ln_matmul_kernel_matches_plain(dev, M, K, N):
    """B9 against its bf16 plain version within 2e-2 x max|plain| and per
    row cosine >= 0.9999 against the f32 plain version, at the vision
    tower's ln1 -> qkv and ln2 -> fc shapes and at edges: an M that is not a
    tile multiple, a K below or past a multiple of the 64-deep k step
    (K = 72: a second step of 8 columns), N below one 256-column tile."""
    from image_search_tpu_torch.ops.ln_matmul import ln_matmul, ln_matmul_reference

    g = torch.Generator(device=dev).manual_seed(M + K + N)
    x = (torch.randn(M, K, generator=g, device=dev) * 2 + 0.5).bfloat16()
    ls = 1 + 0.1 * torch.randn(K, generator=g, device=dev)
    lb = 0.1 * torch.randn(K, generator=g, device=dev)
    w = (torch.randn(N, K, generator=g, device=dev) * K**-0.5).bfloat16()
    b = (0.1 * torch.randn(N, generator=g, device=dev)).bfloat16()
    n0 = ln_matmul.launches
    got = ln_matmul(x, ls, lb, w, b)
    torch.cuda.synchronize()
    assert ln_matmul.launches == n0 + 1
    want = ln_matmul_reference(x, ls, lb, w, b)
    want32 = ln_matmul_reference(x.float(), ls, lb, w.float(), b.float())
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2 * want.float().abs().max().item()
    assert F.cosine_similarity(got.float(), want32, dim=-1).min() >= 0.9999


def test_ln_matmul_kernel_rejects_what_it_cannot_take(dev):
    from image_search_tpu_torch.ops.ln_matmul import ln_matmul

    x = torch.zeros(4, 64, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(32, 64, device=dev, dtype=torch.bfloat16)
    b = torch.zeros(32, device=dev, dtype=torch.bfloat16)
    ls, lb = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    with pytest.raises(ValueError, match="bf16"):
        ln_matmul(x.float(), ls, lb, w, b)
    with pytest.raises(ValueError, match="multiples of 8"):
        ln_matmul(x[:, :36].contiguous(), ls[:36], lb[:36], w[:, :36].contiguous(), b)
    with pytest.raises(ValueError, match="contiguous"):
        ln_matmul(x, ls, lb, torch.zeros(64, 32, device=dev, dtype=torch.bfloat16).t(), b)
    with pytest.raises(ValueError, match=r"\[N"):
        ln_matmul(x, ls, lb, w, b[:16])


@pytest.mark.parametrize("name", ["fully fused", "ln1->qkv only", "ln2->fc only"])
def test_fused_blocks_run_their_kernels_once_per_layer_but_the_last(dev, name):
    """A narrow CLIP whose heads are 64 wide, under each composition: the
    kernels of the composition on every vision layer but the CLS-only one,
    and the bf16 card output close to the f32 CPU forward."""
    from image_search_tpu_torch.models import block_fused
    from image_search_tpu_torch.models.clip import encode_image
    from image_search_tpu_torch.models.convert import build_model, init_params
    from image_search_tpu_torch.ops.ln_matmul import ln_matmul

    cfg = CLIPConfig(
        name="narrow-64",
        text=TextConfig(hidden_size=256, num_layers=2, num_heads=4, vocab_size=300, context_length=20, eos_token_id=299),
        vision=VisionConfig(hidden_size=256, num_layers=4, num_heads=4, image_size=56, patch_size=14),
        projection_dim=32,
    )
    state = init_params(cfg, torch.Generator(device=dev).manual_seed(1), dev, torch.bfloat16)
    model = build_model(cfg, state, dev, torch.bfloat16)
    cpu = build_model(cfg, {k: t.float().cpu() for k, t in state.items()}, "cpu", torch.float32)
    px = torch.randn(3, 56, 56, 3)
    fns = (ln_matmul, attn.fused_attention_qkv_packed, attn.fused_attention_packed, fused_attention)
    n0 = [f.launches for f in fns]
    with torch.no_grad(), block_fused.blocks_as(block_fused.COMPOSITIONS[name]):
        img = encode_image(model, px.to(dev))
    torch.cuda.synchronize()
    n = tuple(f.launches - a for f, a in zip(fns, n0))
    want = {"fully fused": (6, 3, 0, 0), "ln1->qkv only": (3, 0, 3, 0), "ln2->fc only": (3, 0, 0, 3)}[name]
    assert n == want
    assert F.cosine_similarity(img.float().cpu(), encode_image(cpu, px), dim=-1).min() >= 0.99


# ---- the tensor-core attention kernels: ragged edges, pad rows, run-to-run bits ----

RAGGED_S = [1, 15, 16, 17, 63, 64, 65, 77, 257, 264, 300]


def _forward(core, q, k, v, H, causal):
    if core == "grouped":
        return fused_attention(q, k, v, H, causal)
    return attn.fused_attention_packed(q, k, v, H, causal)


def _forward_plain(core, q, k, v, H, causal):
    B, S, D = q.shape
    split = lambda t: t.reshape(B, S, H, D // H)
    ref = attention_reference if core == "grouped" else attn.attention_packed_reference
    return ref(*(split(t) for t in (q, k, v)), causal).reshape(B, S, D)


@pytest.mark.parametrize("Hd", HEAD_DIMS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", RAGGED_S)
@pytest.mark.parametrize("core", ["grouped", "packed"])
def test_forward_kernels_at_ragged_edges(dev, core, S, causal, Hd):
    """B1 and B1p at every edge of the 16-row and 16-key tiles and of the
    4-tile CTAs (a lone ragged tile, a CTA taking a remainder): every row
    written (the output starts as NaN) and close to the plain version."""
    B, H = 2, 3
    q, k, v = _tower_qkv(dev, B, S, H, _seed(7 * S + causal, Hd), Hd)
    torch.empty(B * S * H * Hd * 4, device=dev, dtype=torch.bfloat16).fill_(float("nan"))  # poison the allocator
    got = _forward(core, q, k, v, H, causal)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    want = _forward_plain(core, q, k, v, H, causal)
    want32 = _forward_plain(core, q.float(), k.float(), v.float(), H, causal)
    _close_to_plain(got, want, want32, Hd)


@pytest.mark.parametrize("core", ["grouped", "packed", "split", "padded", "qkv_packed"])
def test_forward_kernels_keep_each_head_in_its_columns_at_hd104(dev, core):
    """At Hd 104 the contraction is padded to 112 and PV runs 13 n-tiles:
    columns 104-111 of a head are the next head's. Every head's v is a
    distinct constant (head h: h + 1), so every output column must hold its
    own head's constant (a convex combination of one value), whatever the
    logits; a read or a store past a head's edge shows as another head's
    value. The output starts as NaN, so a column never written shows too."""
    B, S, H, Hd = 3, 257, 16, 104
    D = H * Hd
    g = torch.Generator(device=dev).manual_seed(104)
    qkv = torch.randn(B, S, 3 * D, generator=g, device=dev).bfloat16()
    const = torch.arange(1, H + 1, device=dev, dtype=torch.float32).repeat_interleave(Hd)  # [D]
    qkv[..., 2 * D :] = const.bfloat16()
    q, k, v = _views(qkv)
    q = q * Hd**-0.5
    Sp = (S // 128) * 128 + 8
    torch.empty(B * Sp * D * 4, device=dev, dtype=torch.bfloat16).fill_(float("nan"))  # poison the allocator
    if core == "grouped":
        got = fused_attention(q, k, v, H)
    elif core == "packed":
        got = attn.fused_attention_packed(q, k, v, H)
    elif core == "split":
        got = attn.fused_attention_split(q, k, v, H)
    elif core == "padded":
        pad = lambda t: F.pad(t, (0, 0, 0, Sp - S))
        got = attn.fused_attention_split_padded(pad(q), pad(k), pad(v), H, S)[:, :S]
    else:
        got = attn.fused_attention_qkv_packed(qkv, H, False, Hd**-0.5)
    torch.cuda.synchronize()
    rel = (got.float() / const - 1).abs()
    assert torch.isfinite(rel).all()
    assert rel.max().item() <= 2e-2  # neighbouring heads' constants differ by >= 1/16


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_kernel_keeps_each_head_in_its_columns_at_hd104(dev, causal):
    """At Hd 104 both of B5's passes pad the contraction of Q K^T and G V^T
    to 112, whose columns 104-111 are the next head's: with every other
    head's columns of q, k, v and g NaN, each head's dq, dk and dv must be
    bitwise those of the all-finite run (a read of a neighbour's column,
    even one multiplied by zero, carries the NaN in); the all-finite run's
    outputs, in memory poisoned with NaN, are finite (every column written
    by its own head)."""
    B, S, H, Hd = 2, 257, 16, 104
    D = H * Hd
    q, k, v = _tower_qkv(dev, B, S, H, 1040 + causal, Hd)
    go = torch.randn(B, S, D, generator=torch.Generator(device=dev).manual_seed(1041), device=dev).bfloat16()
    torch.empty(B * S * D * 8, device=dev, dtype=torch.bfloat16).fill_(float("nan"))  # poison the allocator
    full = fused_attention_bwd(q, k, v, go, H, causal)
    torch.cuda.synchronize()
    assert all(torch.isfinite(t.float()).all() for t in full)
    for h in range(H):
        cols = slice(h * Hd, (h + 1) * Hd)
        alone = []
        for t in (q, k, v, go):
            x = torch.full((B, S, D), float("nan"), device=dev, dtype=torch.bfloat16)
            x[..., cols] = t[..., cols]
            alone.append(x)
        for a, b in zip(fused_attention_bwd(*alone, H, causal), full):
            assert torch.equal(a[..., cols], b[..., cols]), h


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", [1, 15, 17, 65, 257, 264, 300])
def test_qkv_packed_kernel_on_strided_views_at_ragged_edges(dev, S, causal):
    """B7 reads q, k and v as column views of one [B, S, 3D] qkv (row stride
    3D): close to its plain version and bitwise B1p on (q * 0.125, k, v)."""
    B, H = 2, 4
    qkv = _packed_qkv(dev, B, S, H, 11 * S + causal)
    got = attn.fused_attention_qkv_packed(qkv, H, causal, 0.125)
    q, k, v = _views(qkv)
    split = lambda t: t.reshape(B, S, H, 64)
    want = attn.attention_packed_reference(split(q), split(k), split(v), causal, 0.125).reshape(B, S, H * 64)
    want32 = attn.attention_packed_reference(*(split(t).float() for t in (q, k, v)), causal, 0.125)
    _close_to_plain(got, want, want32.reshape(B, S, H * 64))
    assert torch.equal(got, attn.fused_attention_packed(q * 0.125, k, v, H, causal))


@pytest.mark.parametrize("fill", ["inf", "nan", "-inf"])
@pytest.mark.parametrize("S", [129, 257])
def test_split_padded_kernel_ignores_non_finite_pad_rows(dev, S, fill):
    """The padded route's keys at or past s_real are never read: inf or NaN
    in the pad rows of k and v (and of q: those rows are never read by the
    towers) leave every real output row bitwise as it was."""
    B, H = 2, 4
    Sp = (S // 128) * 128 + 8
    q, k, v = _tower_qkv(dev, B, Sp, H, 13 * S)
    base = attn.fused_attention_split_padded(q, k, v, H, S)
    q2, k2, v2 = q.clone(), k.clone(), v.clone()
    for t in (q2, k2, v2):
        t[:, S:] = float(fill)
    got = attn.fused_attention_split_padded(q2, k2, v2, H, S)
    torch.cuda.synchronize()
    assert torch.equal(got[:, :S], base[:, :S])
    assert torch.isfinite(got[:, :S].float()).all()


def _run_twice(fn):
    a = fn()
    b = fn()
    torch.cuda.synchronize()
    return a, b


@pytest.mark.parametrize("S,causal", [(257, False), (77, True), (300, False), (17, True)])
def test_attention_kernels_give_the_same_bits_on_every_run(dev, S, causal):
    """No atomics, no order that depends on scheduling: each forward entry
    and B5 give bitwise the same output on two launches."""
    B, H = 3, 4
    q, k, v = _tower_qkv(dev, B, S, H, 17 * S)
    go = torch.randn(B, S, H * 64, device=dev).bfloat16()
    qkv = _packed_qkv(dev, B, S, H, 19 * S)
    calls = [
        lambda: fused_attention(q, k, v, H, causal),
        lambda: attn.fused_attention_packed(q, k, v, H, causal),
        lambda: attn.fused_attention_qkv_packed(qkv, H, causal, 0.125),
        lambda: fused_attention_bwd(q, k, v, go, H, causal),
    ]
    if not causal and attn.split_regime(S):
        Sp = (S // 128) * 128 + 8
        qp, kp, vp = _tower_qkv(dev, B, Sp, H, 23 * S)
        calls += [lambda: attn.fused_attention_split(q, k, v, H),
                  lambda: attn.fused_attention_split_padded(qp, kp, vp, H, S)]
    for call in calls:
        a, b = _run_twice(call)
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("Hd", HEAD_DIMS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", RAGGED_S)
def test_attention_bwd_kernel_at_ragged_edges(dev, S, causal, Hd):
    """B5 at every tile edge: within 2e-2 x max|plain| of the bf16 plain
    version, per (batch, head) cosine >= 0.999 against f32 where the softmax
    has a gradient (S = 1 has none: exactly zero)."""
    B, H = 2, 3
    q, k, v = _tower_qkv(dev, B, S, H, _seed(29 * S + causal, Hd), Hd)
    go = torch.randn(B, S, H * Hd, generator=torch.Generator(device=dev).manual_seed(S), device=dev).bfloat16()
    got = fused_attention_bwd(q, k, v, go, H, causal)
    torch.cuda.synchronize()
    want = attention_bwd_reference(q, k, v, go, H, causal)
    want32 = attention_bwd_reference(q.float(), k.float(), v.float(), go.float(), H, causal)
    heads = lambda t: t.float().reshape(B, S, H, Hd).permute(0, 2, 1, 3).reshape(B * H, S * Hd)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, want32):
        assert a.dtype == torch.bfloat16 and a.is_contiguous() and torch.isfinite(a.float()).all(), name
        assert (a.float() - b.float()).abs().max().item() <= 2e-2 * max(b.float().abs().max().item(), 1e-30), name
        a, c = heads(a), heads(c)
        live = c.norm(dim=-1) > 0
        assert torch.equal(a[~live], torch.zeros_like(a[~live])), name
        if live.any():
            assert F.cosine_similarity(a[live], c[live], dim=-1).min() >= 0.999, name


@pytest.mark.parametrize("Hd", HEAD_DIMS)
@pytest.mark.parametrize("S,causal", [(257, False), (77, True), (1, False), (17, True), (300, False)])
def test_attention_bwd_column_pass_reproduces_the_row_pass(dev, S, causal, Hd):
    """B5's column pass recomputes p32 and ds from the row pass's (max, sum,
    t) with the same operands in the same roles and the same k-step order:
    the two passes' maps (isx_attention_bwd_probe) are bitwise equal, and the
    probed run gives the same gradients as the plain entry point."""
    import ctypes

    from image_search_tpu_torch import _build

    B, H = 2, 3
    q, k, v = _tower_qkv(dev, B, S, H, _seed(31 * S + causal, Hd), Hd)
    go = torch.randn(B, S, H * Hd, generator=torch.Generator(device=dev).manual_seed(S + 1), device=dev).bfloat16()
    dq, dk, dv = (torch.empty_like(go) for _ in range(3))
    stats = torch.empty(3, B, H, S, device=dev)
    probe = torch.zeros(2, 2, B, H, S, S, device=dev)
    rc = _build.lib().isx_attention_bwd_probe(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), go.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        stats.data_ptr(), probe.data_ptr(), B, S, H, Hd, q.stride(1), k.stride(1), v.stride(1), go.stride(1),
        int(causal), ctypes.c_float(1.0), _build.stream_handle(dev),
    )
    _build.check(rc, "attention backward probe")
    torch.cuda.synchronize()
    rows, cols = probe[0], probe[1]
    assert torch.equal(rows, cols)
    p32 = rows[0]
    if causal:
        assert torch.equal(p32.triu(1), torch.zeros_like(p32))
    assert torch.allclose(p32.sum(-1), torch.ones(B, H, S, device=dev), atol=1e-5)
    for a, b in zip((dq, dk, dv), fused_attention_bwd(q, k, v, go, H, causal)):
        assert torch.equal(a, b)


def test_softmax_division_is_the_ieee_quotient(dev):
    """B1p's, B6's, B7's and B5's p = e / sum is formed as RN(e r) plus one
    FMA correction with r = RN(1 / sum) (isx_attention_div_probe runs that
    function): bitwise the card's correctly rounded division over the
    softmax's range (e in [0, 1] down to subnormals, sum >= 1)."""
    from image_search_tpu_torch import _build

    g = torch.Generator(device=dev).manual_seed(41)
    n = 1 << 22
    x = torch.exp(-110 * torch.rand(n, generator=g, device=dev))  # down into the subnormals
    x[:4] = torch.tensor([0.0, 1.0, 1e-45, 2.0**-126], device=dev)
    y = 1 + 400 * torch.rand(n, generator=g, device=dev)
    y[: n // 4] = torch.floor(y[: n // 4])  # integer sums: quotients that land on ties and exact values
    out = torch.empty_like(x)
    _build.check(_build.lib().isx_attention_div_probe(x.data_ptr(), y.data_ptr(), out.data_ptr(), n,
                                                     _build.stream_handle(dev)), "division probe")
    torch.cuda.synchronize()
    assert torch.equal(out, x / y)



# ---- the certified two-stage search on the card ----


def _concentrated(g, dev, n, d=768, rank=64):
    mix = torch.randn(rank, d, generator=g, device=dev)
    x = torch.randn(n, rank, generator=g, device=dev) @ mix + 0.02 * torch.randn(n, d, generator=g, device=dev)
    return F.normalize(x, dim=-1), mix


@pytest.mark.parametrize("with_pens", [False, True])
def test_twostage_rescore_is_bitwise_the_full_scan(dev, with_pens):
    """B2 over 2048 gathered blocks of a 262,144-row slab (the block path's
    rescore) gives the full scan's scores of those rows bit for bit."""
    from image_search_tpu_torch.index import twostage

    g = torch.Generator(device=dev).manual_seed(31)
    n, d = 262_144, 768
    rows, scales = quantize_rows_int8(F.normalize(torch.randn(n, d, generator=g, device=dev), dim=-1))
    pens = None
    if with_pens:
        pens = torch.zeros(n, device=dev)
        pens[torch.randint(0, n, (500,), generator=g, device=dev)] = NEG_INF
    qi, qs = quantize_rows_int8(F.normalize(torch.randn(4, d, generator=g, device=dev), dim=-1))
    full = stream_scores_int8(rows, qi, qs, scales, n, pens)
    blocks = torch.randperm(n // twostage.BLOCK, generator=g, device=dev)[:2048]
    gid = (blocks[:, None] * twostage.BLOCK + torch.arange(twostage.BLOCK, device=dev)).reshape(-1)
    g_rows = rows.view(-1, twostage.BLOCK, d)[blocks].reshape(-1, d)
    g_pens = None if pens is None else pens[gid]
    got = stream_scores_int8(g_rows, qi, qs, scales[gid], gid.numel(), g_pens)
    torch.cuda.synchronize()
    assert torch.equal(got, full[:, gid])


def test_bf16_sketch_bound_holds_on_every_row(dev):
    """bf16 sketches on the card: the stage-1 bound (bf16 q_s, both operands
    upcast) is >= the full scan's exact score of every row."""
    from image_search_tpu_torch.index import twostage
    from image_search_tpu_torch.index.slabs import Slabs

    g = torch.Generator(device=dev).manual_seed(32)
    x = F.normalize(torch.randn(65_536, 768, generator=g, device=dev), dim=-1)
    rows, scales = quantize_rows_int8(x)
    basis = torch.from_numpy(twostage.fit_basis(x[::8].cpu().numpy(), 64)).to(dev)
    sk, resid, slack = twostage.sketch_slab(rows, scales, basis, to_bf16=True)
    q = torch.cat([torch.randn(4, 768, generator=g, device=dev), x[:4]])
    qt, qi, qs = twostage._exact_query_vector(q, True)
    state = twostage.SketchState(basis, (sk,), (resid,), rows.shape[0], slack)
    q_s, q_res, infl = twostage._query_bound_terms(qt, state)
    sl = Slabs(rows=(rows,), norms=(torch.ones_like(scales),), scales=(scales,), pens=None, size=rows.shape[0])
    ub = twostage._upper_bounds(q_s, q_res, infl, sl, state, 0)
    exact = stream_scores_int8(rows, qi, qs, scales, rows.shape[0])
    assert sk.dtype == torch.bfloat16 and float(slack) > 0
    assert bool((ub >= exact).all())


def test_search_twostage_equals_search_on_a_million_rows(dev):
    """VectorIndex on the card, 2^20 concentrated int8 rows: search_twostage
    certifies and equals search (scores bitwise), f32 and bf16 sketches,
    B = 1 and 4, plain and with feedback."""
    import numpy as np

    from image_search_tpu_torch.index.index import VectorIndex

    g = torch.Generator(device=dev).manual_seed(33)
    n = 1 << 20
    x, mix = _concentrated(g, dev, n + 4)
    index = VectorIndex(768, device=dev, quantize="int8")
    for lo in range(0, n, 1 << 18):
        index.add([f"p{i}" for i in range(lo, lo + (1 << 18))], x[lo : lo + (1 << 18)].cpu().numpy())
    q = x[n:].cpu().numpy()
    for dtype in ("float32", "bfloat16"):
        index.build_sketch(dtype=dtype)
        for B in (1, 4):
            c0 = index.twostage_certified
            got, want = index.search_twostage(q[:B], 1000), index.search(q[:B], 1000)
            assert index.twostage_certified == c0 + 1
            np.testing.assert_array_equal(got[0], want[0])
            distinct = np.diff(want[0], axis=1, prepend=np.inf, append=-np.inf)
            distinct = (distinct[:, :-1] != 0) & (distinct[:, 1:] != 0)
            np.testing.assert_array_equal(got[1][distinct], want[1][distinct])
        sels = [["p3", "p77"], [], ["p1000"], []]
        got = index.search_twostage_feedback_batch(q, sels, 1000)
        want = index.search_with_feedback_batch(q, sels, 1000)
        np.testing.assert_array_equal(got[0], want[0])


def test_fused_twostage_path_never_syncs_with_the_host(dev):
    """tokens -> text tower -> Rocchio -> two-stage is queued without a host
    sync (a synchronising call raises under sync debug mode "error"); the
    one device-to-host copy comes after, and the answer is the full scan's."""
    import numpy as np

    from image_search_tpu_torch.index.index import VectorIndex, _fetch, _fused_twostage

    g = torch.Generator(device=dev).manual_seed(34)
    n = 1 << 16
    x, _ = _concentrated(g, dev, n)
    index = VectorIndex(768, device=dev, quantize="int8")
    index.add([f"p{i}" for i in range(n)], x.cpu().numpy())
    index.build_sketch()
    table = torch.randn(1000, 768, generator=g, device=dev)
    text_fn = lambda ids: table[ids].mean(dim=1)  # a stand-in tower: ids -> [B, D]
    ids = torch.randint(0, 1000, (2, 77), generator=g, device=dev)
    sel = torch.tensor([[5, 9, -1, -1, -1, -1, -1, -1], [-1] * 8], device=dev)
    sl, sk, k, c, _ = index._twostage_snapshot(100, 4096)
    m = index._block_budget(sk, c, 2, sl.capacity // 128)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s, i, cert, text = _fused_twostage(text_fn, ids, sel, sl, sk, k, m, 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ok, s_np, i_np, text_np = _fetch(cert, s, i, text)
    want = index.search_with_feedback_batch(text_np, [["p5", "p9"], []], 100)
    assert ok
    np.testing.assert_array_equal(s_np, want[0])


def test_bf16_full_scan_scores_in_f32_and_matches_the_upcast_plain_top_k(dev):
    """bf16 rows (--index-quantize bfloat16): the full scan's scores leave
    the GEMM in f32 (a bf16 output would round them to 8 bits and tie
    thousands of rows), within 1e-5 of the plain version (both operands
    upcast to f32: the same exact products, summed in another order), and
    its ids equal the plain top-k's away from near-ties."""
    from image_search_tpu_torch.index.index import _search_local
    from image_search_tpu_torch.index.slabs import Slabs, l2
    from image_search_tpu_torch.ops.score_stream import float_scores

    g = torch.Generator(device=dev).manual_seed(17)
    n, k = 300_017, 1000
    rows = F.normalize(torch.randn(n, 768, generator=g, device=dev), dim=-1).bfloat16()
    slabs = (rows[:262_144].contiguous(), torch.cat([rows[262_144:], rows.new_zeros(4096 - (n - 262_144) % 4096, 768)]))
    q = torch.randn(4, 768, generator=g, device=dev)
    s = float_scores(l2(q), slabs[0])
    assert s.dtype == torch.float32 and not torch.equal(s.bfloat16().float(), s)
    norms = tuple(torch.ones(r.shape[0], device=dev) for r in slabs)
    got_s, got_i = _search_local(Slabs(rows=slabs, norms=norms, scales=None, pens=None, size=n), q, k)
    plain = l2(q).bfloat16().float() @ rows.float().T
    want_s, want_i = torch.topk(plain, k, dim=-1)
    assert got_s.dtype == torch.float32 and (got_s - want_s).abs().max().item() <= 1e-5
    near = torch.zeros_like(got_s, dtype=torch.bool)
    near[:, 1:] |= (got_s[:, 1:] - got_s[:, :-1]).abs() <= 1e-5
    near[:, :-1] |= (got_s[:, :-1] - got_s[:, 1:]).abs() <= 1e-5
    assert torch.equal(got_i[~near], want_i[~near])


@pytest.mark.parametrize("b", [1, 8, 16, 32, 40])
def test_query_quantization_is_the_same_at_any_batch_on_the_card(dev, b):
    """torch's CUDA reductions pick their order by shape; the query norms
    are reduced in blocks of ``NORM_ROWS`` rows, so each row of a batch of b
    quantizes bitwise as the same query alone."""
    from image_search_tpu_torch.ops.score_stream import quantize_queries_int8

    g = torch.Generator(device=dev).manual_seed(23)
    x = torch.randn(b, 768, generator=g, device=dev) * 3
    q, s = quantize_queries_int8(x)
    for i in range(b):
        qa, sa = quantize_queries_int8(x[i : i + 1])
        assert torch.equal(q[i : i + 1], qa) and torch.equal(s[i : i + 1], sa)


def test_removal_runs_the_penalty_variant_bitwise_the_plain_version(dev):
    """After remove_paths the int8 full scan passes the tombstone penalties
    to B2 (the reference's _kernel_pen): each slab's scores equal
    scores_int8_reference with ``pens`` bitwise, and searches omit the
    removed rows."""
    import numpy as np

    from image_search_tpu_torch.index.index import VectorIndex
    from image_search_tpu_torch.ops.score_stream import quantize_queries_int8

    rng = np.random.default_rng(3)
    emb = rng.normal(size=(9000, 768)).astype(np.float32)
    paths = [f"/p/{i}" for i in range(len(emb))]
    index = VectorIndex(768, device=dev, quantize="int8", min_capacity=4096, slab_rows=4096)
    index.add(paths, emb)
    dead = [paths[i] for i in (0, 17, 4095, 4096, 8999)]
    assert index.remove_paths(dead) == 5
    q = torch.from_numpy(emb[[0, 17, 4096, 100]]).to(dev)
    n0, p0 = stream_scores_int8.launches, stream_scores_int8.penalty_launches
    s, i = index.search(q, k=50)
    assert stream_scores_int8.penalty_launches - p0 == stream_scores_int8.launches - n0 == len(index._emb_slabs)
    assert not {0, 17, 4095, 4096, 8999} & set(i[s > NEG_INF / 2].tolist())
    sl = index._snapshot()
    qi, qs = quantize_queries_int8(q)
    for slab, scales, pens, start in sl.per_slab():
        got = stream_scores_int8(slab, qi, qs, scales, sl.size - start, pens)
        assert torch.equal(got, scores_int8_reference(slab, qi, qs, scales, sl.size - start, pens))


ROW_QUANT_WIDTHS = [1, 5, 32, 64, 100, 129, 136, 257, 512, 768, 1024, 1280]
ROW_FORMATS = [torch.int8, torch.bfloat16, torch.float32]


def _append_rows(dev, n, d, seed):
    """Raw f32 rows on the card: random normal at magnitudes 0.01-100, and
    the edge rows (zero, one-hot, exact int8 ties at .5, 1e-20, 1e20)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, d, generator=g, device=dev) * torch.empty(n, 1, device=dev).uniform_(0.01, 100.0, generator=g)
    x[0] = 0
    x[1] = 0
    x[1, d // 2] = 3.0
    if d >= 5:  # norm 128, max 127: y / scale = x, so 0.5, 1.5, 15.5, 3.5 tie
        x[2] = 0
        x[2, torch.randperm(d, generator=g, device=dev)[:5]] = torch.tensor([127, 0.5, -1.5, 15.5, -3.5], device=dev)
    x[3] = torch.randn(d, generator=g, device=dev) * 1e-20
    x[4] = torch.randn(d, generator=g, device=dev) * 1e20
    return x


@pytest.mark.parametrize("dtype", ROW_FORMATS, ids=["int8", "bf16", "f32"])
@pytest.mark.parametrize("d", ROW_QUANT_WIDTHS)
def test_row_quant_kernel_bitwise_equals_plain(dev, d, dtype):
    """One launch writes a slab slice at a nonzero offset, bitwise the plain
    version run on the CPU, with n not a multiple of a block's 8 rows, and
    leaves the rows around the slice as they were."""
    from image_search_tpu_torch.ops.row_quant import normalize_rows_into, normalize_rows_reference

    n, lo, cap = 1037, 123, 1300
    x = _append_rows(dev, n, d, seed=d)
    rows = torch.full((cap, d), 7, dtype=dtype, device=dev)
    norms = torch.full((cap,), -2.0, device=dev)
    scales = torch.full((cap,), -3.0, device=dev) if dtype == torch.int8 else None
    n0 = normalize_rows_into.launches
    normalize_rows_into(x, rows[lo : lo + n], norms[lo : lo + n], None if scales is None else scales[lo : lo + n])
    torch.cuda.synchronize()
    assert normalize_rows_into.launches == n0 + 1
    want_rows, want_norms, want_scales = normalize_rows_reference(x.cpu(), dtype)
    assert torch.equal(rows[lo : lo + n].cpu().view(torch.uint8), want_rows.view(torch.uint8))
    assert torch.equal(norms[lo : lo + n].cpu().view(torch.int32), want_norms.view(torch.int32))
    if scales is not None:
        assert torch.equal(scales[lo : lo + n].cpu().view(torch.int32), want_scales.view(torch.int32))
        assert (scales[:lo] == -3).all() and (scales[lo + n :] == -3).all()
    assert (rows[:lo] == 7).all() and (rows[lo + n :] == 7).all()
    assert (norms[:lo] == -2).all() and (norms[lo + n :] == -2).all()


def test_row_quant_kernel_rejects_what_it_cannot_take(dev):
    from image_search_tpu_torch.ops.row_quant import normalize_rows_into

    x = torch.zeros(4, 768, device=dev)
    rows, norms = torch.zeros(4, 768, dtype=torch.int8, device=dev), torch.zeros(4, device=dev)
    with pytest.raises(ValueError, match="scales"):
        normalize_rows_into(x, rows, norms)  # int8 without scales
    with pytest.raises(ValueError, match="scales"):
        normalize_rows_into(x, rows.float(), norms, torch.zeros(4, device=dev))
    with pytest.raises(ValueError, match="rows"):
        normalize_rows_into(x, rows.to(torch.int16), norms)
    with pytest.raises(ValueError, match="x"):
        normalize_rows_into(x.half(), rows.float(), norms)
    with pytest.raises(ValueError, match="shared memory"):
        normalize_rows_into(torch.zeros(1, 200_000, device=dev), torch.zeros(1, 200_000, device=dev), norms[:1])


def _append_writes(slab_rows, lo, n, chunk):
    """The writes ``VectorIndex._add_in_memory`` makes for rows [lo, lo + n):
    each slab's part in chunks of at most ``chunk`` rows."""
    writes, start = 0, 0
    for rows in slab_rows:
        part = max(0, min(lo + n, start + rows) - max(lo, start))
        writes += -(-part // chunk)
        start += rows
    return writes


@pytest.mark.parametrize("chunk", [16384, 3000])
@pytest.mark.parametrize("quantize", ["int8", "bfloat16", None])
def test_cuda_index_appends_bitwise_the_cpu_index(dev, quantize, chunk, monkeypatch):
    """4096-row adds (pageable and pinned, as the store's restore and the
    benchmark's loader pass them) through the first slab's doubling and a
    slab boundary, and one add longer than a chunk: the slabs, norms and
    scales equal a CPU index's filled the same way, slab by slab, and the
    kernel ran once a chunk within each slab an add reached."""
    import numpy as np

    from image_search_tpu_torch.index import index as index_mod
    from image_search_tpu_torch.ops.row_quant import normalize_rows_into

    monkeypatch.setattr(index_mod, "_APPEND_ROWS", chunk)
    d, sizes = 768, [4096, 4096, 1000, 5192, 4096, 777, 20000]
    x = np.random.default_rng(11).normal(size=(sum(sizes), d)).astype(np.float32)
    x[5] = 0
    kw = dict(quantize=quantize, min_capacity=4096, slab_rows=8192)
    gpu, cpu = index_mod.VectorIndex(d, device=dev, **kw), index_mod.VectorIndex(d, device="cpu", **kw)
    pinned = torch.empty(max(sizes), d, pin_memory=True)
    off = 0
    for j, n in enumerate(sizes):
        paths = [f"/p/{i}.jpg" for i in range(off, off + n)]
        rows = x[off : off + n]
        if j % 2:
            pinned[:n].copy_(torch.from_numpy(rows))
            rows_in = pinned[:n].numpy()
        else:
            rows_in = rows
        n0 = normalize_rows_into.launches
        assert gpu.add(paths, rows_in) == n
        want = _append_writes([s.shape[0] for s in gpu._emb_slabs], off, n, chunk)
        assert normalize_rows_into.launches - n0 == want
        assert cpu.add(paths, rows) == n
        off += n
    torch.cuda.synchronize()
    assert len(gpu._emb_slabs) == len(cpu._emb_slabs) == 5
    groups = [gpu._emb_slabs, gpu._norm_slabs] + ([gpu._scale_slabs] if quantize == "int8" else [])
    groups_cpu = [cpu._emb_slabs, cpu._norm_slabs] + ([cpu._scale_slabs] if quantize == "int8" else [])
    for slabs, slabs_cpu in zip(groups, groups_cpu):
        for a, b in zip(slabs, slabs_cpu):
            assert torch.equal(a.cpu().view(torch.uint8), b.view(torch.uint8))
    _, ids = gpu.search(torch.from_numpy(x[[1, 9000, 39000]]).to(dev), k=1)
    assert np.asarray(ids)[:, 0].tolist() == [1, 9000, 39000]


# ---- the long-key forward (S past MAX_KEYS = 320: OpenCLIP ViT-H/14 at 378 px has 730 tokens) ----

LONG_CASES = [(S, Hd) for S in (321, 577, 730, 1025) for Hd in (64, 80)] + [(730, 32), (730, 104)]


def _long_forward(core, q, k, v, H, causal):
    if core == "qkv_packed":
        return attn.fused_attention_qkv_packed(torch.cat([q, k, v], dim=-1), H, causal)
    return _forward(core, q, k, v, H, causal)


def _long_plain(core, q, k, v, H, causal):
    return _forward_plain("grouped" if core == "grouped" else "packed", q, k, v, H, causal)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,Hd", LONG_CASES)
@pytest.mark.parametrize("core", ["grouped", "packed"])
def test_long_key_kernel_matches_plain(dev, core, S, Hd, causal):
    """B1 and B1p past 320 keys (the long-key kernel, both rounding modes)
    against their plain versions, which follow its rounding points
    (``attention_long_reference``): every row written (the output starts as
    NaN), within the short kernels' bounds (``_close_to_plain``: the same
    bf16 rounding of p and of the output, f32 sums in another order)."""
    B, H = 2, 4
    q, k, v = _tower_qkv(dev, B, S, H, _seed(11 * S + causal, Hd), Hd)
    torch.empty(B * S * H * Hd * 4, device=dev, dtype=torch.bfloat16).fill_(float("nan"))  # poison the allocator
    fn = fused_attention if core == "grouped" else attn.fused_attention_packed
    n0 = fn.long_launches_by_hd.get(Hd, 0)
    got = _long_forward(core, q, k, v, H, causal)
    torch.cuda.synchronize()
    assert fn.long_launches_by_hd[Hd] == n0 + 1
    assert torch.isfinite(got.float()).all()
    want = _long_plain(core, q, k, v, H, causal)
    want32 = _long_plain(core, q.float(), k.float(), v.float(), H, causal)
    _close_to_plain(got, want, want32, Hd)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B", [1, 160])
@pytest.mark.parametrize("core", ["grouped", "packed", "qkv_packed"])
def test_long_key_kernel_at_the_vision_shape(dev, core, B, causal):
    """S = 730, H = 16, Hd = 80 (OpenCLIP ViT-H/14 at 378 px): B = 1 (a
    /search_image upload, 4 warps a CTA) and B = 160 (a scan batch, 8)."""
    S, H, Hd = 730, 16, 80
    q, k, v = _tower_qkv(dev, B, S, H, _seed(B + 7 * causal, Hd), Hd)
    got = _long_forward(core, q, k, v, H, causal)
    torch.cuda.synchronize()
    want = _long_plain(core, q, k, v, H, causal)
    want32 = _long_plain(core, q.float(), k.float(), v.float(), H, causal)
    _close_to_plain(got, want, want32, Hd)


@pytest.mark.parametrize("core", ["grouped", "packed", "qkv_packed"])
def test_long_key_kernel_only_past_320_keys(dev, core):
    """S <= 320 takes the short kernels (the long-key counters stay still),
    S = 321 the long-key kernel; both count as launches of their entry."""
    fn = {"grouped": fused_attention, "packed": attn.fused_attention_packed,
          "qkv_packed": attn.fused_attention_qkv_packed}[core]
    for S, long_step in ((77, 0), (257, 0), (320, 0), (321, 1)):
        q, k, v = _tower_qkv(dev, 2, S, 4, S)
        n0, l0 = fn.launches, fn.long_launches
        _long_forward(core, q, k, v, 4, False)
        torch.cuda.synchronize()
        assert (fn.launches - n0, fn.long_launches - l0) == (1, long_step), (core, S)


def test_long_key_path_raises_where_it_has_no_kernel(dev):
    """B5 and B6 stage the whole sequence: past 320 keys they raise."""
    z = lambda S: torch.zeros(1, S, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="S=321"):
        fused_attention_bwd(z(321), z(321), z(321), z(321), 2)
    with pytest.raises(NotImplementedError, match="split tail"):
        attn.fused_attention_split(z(385), z(385), z(385), 2)  # s_main 384, in the split regime


def test_long_key_kernel_gives_the_same_bits_on_every_run(dev):
    q, k, v = _tower_qkv(dev, 3, 730, 16, 5, 80)
    for core in ("grouped", "packed"):
        a = _forward(core, q, k, v, 16, False)
        b = _forward(core, q, k, v, 16, False)
        torch.cuda.synchronize()
        assert torch.equal(a, b), core
