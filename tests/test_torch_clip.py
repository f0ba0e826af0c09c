"""The port's CLIP towers, checkpoint reader and embedder against the JAX
package, at ``tiny_test_config`` sizes on the CPU in f32.

Weights come from the reference's ``init_params`` and pass through
``params_from_jax``; inputs are made with numpy from a seed. Tolerance:
atol 1e-5 and cosine >= 0.9999 (the reference's own bound for tower parity).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_tpu.config import tiny_test_config
from image_search_tpu.models import clip as jclip
from image_search_tpu.models.convert import save_checkpoint
from image_search_tpu.models.embedder import ClipEmbedder as JaxEmbedder
from image_search_tpu.models.embedder import _bucket_batch as jax_bucket_batch
from image_search_tpu.tokenizer import HashTokenizer
from image_search_tpu_torch.config import CLIPConfig as PortCLIPConfig
from image_search_tpu_torch.models import embedder as tembedder
from image_search_tpu_torch.models.clip import CLIP, _layer_norm, encode_image, encode_text
from image_search_tpu_torch.models.convert import (
    build_model,
    init_params,
    load_checkpoint,
    params_from_jax,
)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config()
    jparams = jclip.init_params(jax.random.key(0), cfg)
    np_params = jax.tree.map(np.asarray, jparams)
    model = build_model(cfg, params_from_jax(np_params, cfg), "cpu", torch.float32)
    return cfg, jparams, model


def _close(got, want, atol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() >= 0.9999, cos.min()


def _ids(cfg, seed):
    """Token ids with the first EOS at varied positions, repeated EOS after
    it, and one row without any EOS (pooled at position 0)."""
    rng = np.random.default_rng(seed)
    tc = cfg.text
    ids = rng.integers(0, tc.eos_token_id, size=(5, tc.context_length)).astype(np.int32)
    for row, pos in enumerate((3, 0, tc.context_length - 1, 7)):
        ids[row, pos:] = tc.eos_token_id
    return ids


@pytest.mark.parametrize("normalize", [False, True])
def test_encode_image_matches_jax(setup, normalize):
    cfg, jparams, model = setup
    rng = np.random.default_rng(1)
    px = rng.standard_normal((3, cfg.vision.image_size, cfg.vision.image_size, 3)).astype(np.float32)
    want = jclip.encode_image(jparams, cfg, jnp.asarray(px), normalize=normalize)
    got = encode_image(model, torch.from_numpy(px), normalize=normalize)
    _close(got.numpy(), want)


@pytest.mark.parametrize("normalize", [False, True])
def test_encode_text_matches_jax(setup, normalize):
    cfg, jparams, model = setup
    ids = _ids(cfg, 2)
    want = jclip.encode_text(jparams, cfg, jnp.asarray(ids), normalize=normalize)
    got = encode_text(model, torch.from_numpy(ids.astype(np.int64)), normalize=normalize)
    _close(got.numpy(), want)


def test_cls_and_eos_last_blocks_equal_full_stack(setup):
    """The truncated last blocks compute exactly what the full last block
    computes at the pooled row."""
    cfg, _, model = setup
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, cfg.vision.seq_len, cfg.vision.hidden_size)).astype(np.float32))
    last = model.vision.blocks[-1]
    np.testing.assert_allclose(
        last.forward_cls(x)[:, 0].numpy(), last(x, causal=False)[:, 0].numpy(), atol=1e-5
    )
    ids = torch.from_numpy(_ids(cfg, 4).astype(np.int64))
    eos = torch.argmax((ids == cfg.text.eos_token_id).int(), dim=-1)
    xt = torch.from_numpy(
        rng.standard_normal((ids.shape[0], cfg.text.context_length, cfg.text.hidden_size)).astype(np.float32)
    )
    lt = model.text.blocks[-1]
    full = lt(xt, causal=True)[torch.arange(ids.shape[0]), eos]
    np.testing.assert_allclose(lt.forward_eos(xt, eos)[:, 0].numpy(), full.numpy(), atol=1e-5)


def test_bf16_model_runs_close_to_f32(setup):
    """The card's dtype path (bf16 weights and activations, f32 statistics)
    runs on the CPU too and stays close to f32."""
    cfg, jparams, model = setup
    m16 = build_model(cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg), "cpu", torch.bfloat16)
    rng = np.random.default_rng(5)
    px = torch.from_numpy(rng.standard_normal((2, 28, 28, 3)).astype(np.float32))
    e16 = encode_image(m16, px)
    assert e16.dtype == torch.bfloat16
    cos = torch.nn.functional.cosine_similarity(e16.float(), encode_image(model, px), dim=-1)
    assert cos.min() >= 0.99


def test_load_checkpoint_reads_reference_file(setup, tmp_path):
    cfg, jparams, model = setup
    path = str(tmp_path / "tiny.safetensors")
    save_checkpoint(path, jparams, cfg)
    params, cfg2 = load_checkpoint(path)
    # the port's own copy of the config classes, field for field the same
    assert isinstance(cfg2, PortCLIPConfig)
    assert dataclasses.asdict(cfg2) == dataclasses.asdict(cfg)
    flat_want = jax.tree_util.tree_leaves_with_path(jparams)
    for key_path, leaf in flat_want:
        node = params
        for k in key_path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    loaded = build_model(cfg2, params_from_jax(params, cfg2), "cpu", torch.float32)
    for (k, a), (_, b) in zip(sorted(loaded.state_dict().items()), sorted(model.state_dict().items())):
        assert torch.equal(a, b), k


def test_init_params_fills_every_weight_deterministically(setup):
    cfg = setup[0]
    a = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    b = init_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    c = init_params(cfg, torch.Generator().manual_seed(1), "cpu", torch.float32)
    with torch.device("meta"):
        want = CLIP(cfg).state_dict()
    assert {k: tuple(v.shape) for k, v in a.items()} == {k: tuple(v.shape) for k, v in want.items()}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["vision.patch_embedding.weight"], c["vision.patch_embedding.weight"])
    build_model(cfg, a, "cpu", torch.bfloat16)  # loads strictly


def test_layer_norm_statistics_in_f32():
    ln = torch.nn.LayerNorm(8, eps=1e-5)
    x = (torch.arange(16.0).reshape(2, 8) * 1000 + 1).bfloat16()
    got = _layer_norm(x, ln)
    want = torch.nn.functional.layer_norm(x.float(), (8,), eps=1e-5).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


# --- embedder --------------------------------------------------------------


def test_bucket_batch_matches_reference():
    assert [tembedder._bucket_batch(n) for n in range(1, 161)] == [
        jax_bucket_batch(n) for n in range(1, 161)
    ]


@pytest.fixture(scope="module")
def embedders(setup):
    cfg, jparams, model = setup
    tok = HashTokenizer(cfg.text.vocab_size, cfg.text.context_length, eos_id=cfg.text.eos_token_id)
    return tembedder.ClipEmbedder(model, tokenizer=tok), JaxEmbedder(jparams, cfg, tokenizer=tok)


def test_embed_images_matches_jax(embedders):
    """uint8 -> preprocess -> tower. The two resample matmuls sum in another
    order than XLA's, which moves a few pixels across the uint8 rounding
    between the passes (one LSB, within PIL's own <= 1 LSB; see
    test_torch_preprocess.py): atol 1e-3 here, cosine still >= 0.9999."""
    port, ref = embedders
    rng = np.random.default_rng(6)
    images = [rng.integers(0, 256, size=(20 + 9 * i, 50 - 4 * i, 3), dtype=np.uint8) for i in range(5)]
    images.append(rng.integers(0, 256, size=(31, 17), dtype=np.uint8))  # grayscale
    _close(port.embed_images(images), ref.embed_images(images), atol=1e-3)


def test_embed_images_exact_resample_sizes_match_jax(embedders):
    """Sizes whose resample is the identity (short side at the 28 px model
    input; see test_torch_preprocess.py) make the preprocess exact, so the
    towers' full tolerance holds end to end."""
    port, ref = embedders
    rng = np.random.default_rng(8)
    sizes = [(28, 28), (28, 64), (90, 28), (28, 29)]
    images = [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for h, w in sizes]
    _close(port.embed_images(images), ref.embed_images(images))


def test_embed_texts_matches_jax(embedders):
    port, ref = embedders
    texts = ["a red square", "two dogs on a beach at night", "", "x " * 40]
    got = port.embed_texts(texts)
    assert got.shape == (4, port.cfg.projection_dim)
    _close(got, ref.embed_texts(texts))


def test_sub_batches_equal_single_dispatch(embedders, monkeypatch):
    port, _ = embedders
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, size=(30, 30, 3), dtype=np.uint8) for _ in range(10)]
    whole = port.embed_images(images)
    monkeypatch.setattr(tembedder, "MAX_DEVICE_BATCH", 4)
    split = port.embed_images(images)
    assert split.shape == whole.shape
    np.testing.assert_allclose(split, whole, atol=1e-5)


def test_tokenizer_eos_mismatch_raises(setup):
    cfg, _, model = setup
    bad = HashTokenizer(cfg.text.vocab_size, cfg.text.context_length, eos_id=5)
    with pytest.raises(ValueError, match="eos_id"):
        tembedder.ClipEmbedder(model, tokenizer=bad)
    with pytest.raises(NotImplementedError):
        tembedder.ClipEmbedder(model, mesh=object())


@pytest.mark.parametrize("value", [None, "1", "0"])
@pytest.mark.parametrize("tower", ["image", "text"])
def test_cls_and_eos_last_switches_match_jax(setup, monkeypatch, tower, value):
    """ISX_CLS_LAST / ISX_EOS_LAST, read as the reference reads them: unset
    or "1" runs the CLS/EOS-only last block, "0" the full last block and
    then the pooled row. Both packages agree under each value, and the port
    takes the truncated block exactly when the switch is on."""
    from image_search_tpu_torch.models.clip import Block

    cfg, jparams, model = setup
    name, truncated = ("ISX_CLS_LAST", "forward_cls") if tower == "image" else ("ISX_EOS_LAST", "forward_eos")
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)
    calls = []
    real = getattr(Block, truncated)
    monkeypatch.setattr(Block, truncated, lambda self, *a, **kw: calls.append(1) or real(self, *a, **kw))
    if tower == "image":
        px = np.random.default_rng(7).standard_normal((3, cfg.vision.image_size, cfg.vision.image_size, 3))
        px = px.astype(np.float32)
        want = jclip.encode_image(jparams, cfg, jnp.asarray(px))
        got = encode_image(model, torch.from_numpy(px))
    else:
        ids = _ids(cfg, 8)
        want = jclip.encode_text(jparams, cfg, jnp.asarray(ids))
        got = encode_text(model, torch.from_numpy(ids.astype(np.int64)))
    _close(got.numpy(), want)
    assert calls == ([] if value == "0" else [1])
