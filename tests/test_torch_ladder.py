"""The model ladder on the CPU: OpenCLIP H/14's and bigG's head dims (80 and
104) through the port's plain attention versions and towers, their
checkpoints, the HuggingFace conversion (``--from-hf``) and B2 at bigG's
1280-wide rows, each against the JAX package.

Two tiny configurations keep the ladder's head dims at small sizes: an
"H-like" one (vision hidden 160, 2 heads: Hd 80) and a "bigG-like" one
(vision hidden 208, 2 heads: Hd 104, MLP 512 as bigG's own is no clean
ratio), both with gelu, 2 layers, 28 px images in 14 px patches and a text
tower of hidden 128 in 2 heads. Same inputs, made with numpy from a seed, go
to both packages; f32, atol 1e-5 for attention and the towers (cosine >=
0.9999), equal arrays for the conversion, bitwise for B2. The CUDA kernels
at these head dims are checked on the card (tests/test_torch_cuda.py,
chip_smoke.py's ladder phase).
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from image_search_tpu import config as jcfg
from image_search_tpu.models import clip as jclip
from image_search_tpu.models import convert as jconvert
from image_search_tpu.ops import attention as jattn
from image_search_tpu.ops.score_stream import stream_scores_int8 as jax_stream_scores_int8
from image_search_tpu.parallel.sharded_search import quantize_rows_int8 as jax_quantize
from image_search_tpu_torch import config as pcfg
from image_search_tpu_torch.models import convert
from image_search_tpu_torch.models.clip import encode_image, encode_text
from image_search_tpu_torch.ops import attention as A
from image_search_tpu_torch.ops.score_stream import stream_scores_int8
from image_search_tpu_torch.server.app import make_server
from image_search_tpu_torch.server.engine import SearchEngine, ServerArgs
from image_search_tpu_torch.tokenizer import train_bpe

ATOL = 1e-5
TOWER_MIN_COS = 0.9999
TEXT = dict(hidden_size=128, num_layers=2, num_heads=2, act="gelu", vocab_size=520, context_length=16)
LADDER = {  # name -> vision tower fields
    "ladder-h-tiny": dict(hidden_size=160, num_layers=2, num_heads=2, act="gelu", image_size=28, patch_size=14),
    "ladder-bigg-tiny": dict(hidden_size=208, num_layers=2, num_heads=2, act="gelu", image_size=28, patch_size=14,
                             mlp_size_override=512),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch and numpy ops: under parallel test workers OpenBLAS's
    and torch's threads would oversubscribe the cores."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tokenizer():
    return train_bpe(["a red square", "a blue circle on a photo", "photo of a cat"] * 3, vocab_size=TEXT["vocab_size"],
                     context_length=TEXT["context_length"])


def _config(lib, name: str, eos: int):
    """The named tiny ladder configuration in ``lib``'s own classes (the JAX
    package's or the port's), built field by field."""
    return lib.CLIPConfig(
        name=name,
        text=lib.TextConfig(**TEXT, eos_token_id=eos),
        vision=lib.VisionConfig(**LADDER[name]),
        projection_dim=32,
    )


@pytest.fixture(scope="module", params=sorted(LADDER))
def ladder(request, tokenizer):
    """(JAX config, port config, reference-layout params, port state) of one
    tiny ladder configuration: seeded random weights, carried to the port
    through ``params_from_jax``."""
    name = request.param
    jc, pc = _config(jcfg, name, tokenizer.eos_id), _config(pcfg, name, tokenizer.eos_id)
    init = convert.init_params(pc, torch.Generator().manual_seed(len(name)), "cpu", torch.float32)
    jparams = convert.params_to_jax(convert.build_model(pc, init, "cpu", torch.float32))
    return jc, pc, jparams, convert.params_from_jax(jparams, pc)


def _close(got, want, atol=ATOL, min_cos=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    if min_cos is not None:
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
        assert cos.min() >= min_cos, cos.min()


def _qkv(seed, B, S, H, Hd):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, S, H, Hd)) * 0.3).astype(np.float32) for _ in range(3)]


def _oracle(q, k, v, causal, scale):
    oracle = jax.jit(jattn.attention_reference, static_argnames=("causal", "sm_scale"))
    return np.asarray(oracle(*map(jnp.asarray, (q, k, v)), causal=causal, sm_scale=scale))


# ---- the attention forward family (B1, B1p, B6, B7) at Hd 80 and 104 ----------


@pytest.mark.parametrize("Hd", [80, 104])
def test_grouped_plain_matches_pallas_in_interpret_mode(Hd):
    """B1's plain version (the CPU route of ``fused_attention``) against the
    reference's grouped Pallas kernel run in interpret mode."""
    B, S, H, causal = 1, 17, 2, Hd == 104
    q, k, v = _qkv(Hd, B, S, H, Hd)
    packed = lambda a: a.reshape(B, S, H * Hd)
    got = A.fused_attention(*(torch.from_numpy(packed(a)) for a in (q, k, v)), H, causal, Hd**-0.5)
    want = jattn.fused_attention_grouped(*(jnp.asarray(packed(a)) for a in (q, k, v)), heads=H, group=2,
                                         causal=causal, sm_scale=Hd**-0.5, interpret=True)
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("Hd", [80, 104])
@pytest.mark.parametrize("core,S,causal", [
    ("grouped", 33, True), ("packed", 33, False), ("packed", 17, True), ("split", 129, False),
    ("padded", 136, False), ("qkv_packed", 33, True),
])
def test_plain_versions_match_the_oracle(core, S, causal, Hd):
    """B1, B1p, B6 (split on S rows, padded to Sp = 136 with s_real = 129) and
    B7 (one packed qkv, sm_scale on the logits) against the reference's
    ``attention_reference`` in f32: the rounding points differ only where f32
    rounds to f32."""
    B, H = 2, 2
    scale = Hd**-0.5
    q, k, v = _qkv(S + Hd, B, S, H, Hd)
    t = lambda a: torch.from_numpy(a.reshape(B, S, H * Hd))
    if core == "grouped":
        got = A.fused_attention(t(q), t(k), t(v), H, causal, scale)
    elif core == "packed":
        got = A.fused_attention_packed(t(q), t(k), t(v), H, causal, scale)
    elif core == "split":
        got = A.fused_attention_split(t(q), t(k), t(v), H, scale)
    elif core == "qkv_packed":
        got = A.fused_attention_qkv_packed(torch.cat([t(q), t(k), t(v)], dim=-1), H, causal, scale)
    else:  # the real keys are the first s_real rows; the pad rows hold garbage
        s_real = 129
        got = A.fused_attention_split_padded(t(q), t(k), t(v), H, s_real, scale)[:, :s_real]
        want = _oracle(q[:, :s_real], k[:, :s_real], v[:, :s_real], False, scale)
        _close(got.numpy(), want.reshape(B, s_real, H * Hd))
        return
    _close(got.numpy(), _oracle(q, k, v, causal, scale).reshape(B, S, H * Hd))


# ---- the towers, the checkpoint, the HF conversion -----------------------------


def test_towers_match_jax(ladder):
    """Both towers of the tiny ladder configuration through ``params_from_jax``
    against ``image_search_tpu.models.clip``: the tower bound."""
    jc, pc, jparams, state = ladder
    model = convert.build_model(pc, state, "cpu", torch.float32)
    rng = np.random.default_rng(1)
    px = rng.standard_normal((3, 28, 28, 3)).astype(np.float32)
    ids = rng.integers(0, jc.text.eos_token_id, size=(3, 16)).astype(np.int32)
    ids[0, 5:], ids[1, 15:] = jc.text.eos_token_id, jc.text.eos_token_id
    with torch.no_grad():
        img = encode_image(model, torch.from_numpy(px))
        txt = encode_text(model, torch.from_numpy(ids.astype(np.int64)))
    # one jit over each reference tower: a single XLA compile, ~5x faster here
    # than the op-by-op compiles of an eager call
    want_img = jax.jit(jclip.encode_image, static_argnums=1)(jparams, jc, jnp.asarray(px))
    want_txt = jax.jit(jclip.encode_text, static_argnums=1)(jparams, jc, jnp.asarray(ids))
    _close(img.numpy(), want_img, min_cos=TOWER_MIN_COS)
    _close(txt.numpy(), want_txt, min_cos=TOWER_MIN_COS)


def test_port_reads_the_reference_checkpoint(ladder, tmp_path):
    """A checkpoint that the JAX package writes: the port's ``load_checkpoint``
    gives its config field for field and the same state."""
    jc, pc, jparams, state = ladder
    path = str(tmp_path / "ladder.safetensors")
    jconvert.save_checkpoint(path, jparams, jc)
    params, cfg = convert.load_checkpoint(path)
    assert cfg == pc
    got = convert.params_from_jax(params, cfg)
    assert got.keys() == state.keys()
    for key in state:  # the file holds the 0-d logit scale as [1]
        assert torch.equal(got[key].reshape(state[key].shape), state[key]), key


def _import_transformers():
    """``transformers`` with ``CLIPModel`` loaded, but not the two packages it
    would load for nothing on the way (TensorFlow through its image
    transforms, scikit-learn through its generation helpers: about 8 s of
    import on one core). ``USE_TF=0`` covers a first import; where another
    test file imported ``transformers`` first, its availability flags are
    already set, so they are turned off for this one import and restored."""
    old_env = os.environ.get("USE_TF")
    os.environ["USE_TF"] = "0"
    try:
        import transformers
        from transformers.utils import import_utils

        flags = {k: getattr(import_utils, k) for k in ("_tf_available", "_sklearn_available") if hasattr(import_utils, k)}
        try:
            for k in flags:
                setattr(import_utils, k, False)
            from transformers import CLIPModel  # noqa: F401 (the lazy module loads here)
        finally:
            for k, v in flags.items():
                setattr(import_utils, k, v)
    finally:
        if old_env is None:
            os.environ.pop("USE_TF")
        else:
            os.environ["USE_TF"] = old_env
    return transformers


def _hf_clip(cfg):
    """A random-init ``transformers.CLIPModel`` of ``cfg``'s shapes, gelu."""
    transformers = _import_transformers()

    text = transformers.CLIPTextConfig(
        vocab_size=cfg.text.vocab_size, hidden_size=cfg.text.hidden_size, intermediate_size=cfg.text.mlp_size,
        num_hidden_layers=cfg.text.num_layers, num_attention_heads=cfg.text.num_heads,
        max_position_embeddings=cfg.text.context_length, hidden_act="gelu", eos_token_id=cfg.text.eos_token_id,
    )
    vision = transformers.CLIPVisionConfig(
        hidden_size=cfg.vision.hidden_size, intermediate_size=cfg.vision.mlp_size,
        num_hidden_layers=cfg.vision.num_layers, num_attention_heads=cfg.vision.num_heads,
        image_size=cfg.vision.image_size, patch_size=cfg.vision.patch_size, hidden_act="gelu",
    )
    torch.manual_seed(0)
    hf = transformers.CLIPConfig.from_text_vision_configs(text, vision, projection_dim=cfg.projection_dim)
    return transformers.CLIPModel(hf).eval()


@pytest.fixture(scope="module")
def hf_model(ladder):
    return _hf_clip(ladder[1])


def _assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), path
    for key in want:
        if isinstance(want[key], dict):
            _assert_trees_equal(got[key], want[key], f"{path}/{key}")
        else:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=f"{path}/{key}")


def test_hf_state_dict_converts_as_the_reference_does(ladder, hf_model):
    jc, pc, _, _ = ladder
    sd = hf_model.state_dict()
    _assert_trees_equal(convert.params_from_hf_state_dict(sd, pc), jconvert.params_from_hf_state_dict(sd, jc))


@pytest.mark.parametrize("layout", ["whole", "two shards"])
def test_hf_dir_reads_whole_and_sharded(ladder, hf_model, tmp_path, layout):
    """``params_from_hf_dir`` on a directory that ``save_pretrained`` wrote,
    and on the same weights split into two shards named by
    ``model.safetensors.index.json``, one shard in F16 and one in BF16 (the
    published directories hold either): the arrays of the state dict rounded
    to the same types, converted by the reference."""
    jc, pc, _, _ = ladder
    sd = hf_model.state_dict()
    d = str(tmp_path / "hf")
    hf_model.save_pretrained(d, safe_serialization=True)
    if layout == "two shards":
        os.remove(os.path.join(d, "model.safetensors"))
        keys = sorted(sd)
        shards = {"model-00001-of-00002.safetensors": (keys[::2], torch.float16),
                  "model-00002-of-00002.safetensors": (keys[1::2], torch.bfloat16)}
        weight_map = {}
        for fname, (names, dtype) in shards.items():
            save_file({k: sd[k].to(dtype).contiguous() for k in names}, os.path.join(d, fname), metadata={"format": "pt"})
            weight_map |= {k: fname for k in names}
            sd = {k: (t.to(dtype).float() if k in names else t) for k, t in sd.items()}
        with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f)
    _assert_trees_equal(convert.params_from_hf_dir(d, pc), jconvert.params_from_hf_state_dict(sd, jc))


def _corpus(media):
    from PIL import Image

    rng = np.random.default_rng(5)
    os.makedirs(media)
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, (28, 28 + 4 * i, 3), dtype=np.uint8)).save(f"{media}/p{i}.png")


def _serve(engine):
    server = make_server(engine)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_port}"


def _post(base, body):
    import urllib.request

    req = urllib.request.Request(base + "/search", data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read()


def test_engine_from_hf_dir_serves_as_the_reference_checkpoint(ladder, hf_model, tokenizer, tmp_path, monkeypatch):
    """``--from-hf <local dir>`` with no checkpoint: the engine converts the
    directory at startup, copies its BPE files into a tokenizer directory
    that has none, and answers /search (plain and with feedback) byte for
    byte as an engine loaded from the reference's checkpoint of the same HF
    weights. No ``transformers`` is needed for a local directory."""
    jc, pc, _, _ = ladder
    monkeypatch.setitem(pcfg.PRESETS, pc.name, lambda: pc)  # the tiny configuration as a preset
    hf = str(tmp_path / "hf")
    hf_model.save_pretrained(hf, safe_serialization=True)
    tokenizer.save(hf)
    ref_ckpt = str(tmp_path / "ref.safetensors")
    jconvert.save_checkpoint(ref_ckpt, jconvert.params_from_hf_state_dict(hf_model.state_dict(), jc), jc)
    media = str(tmp_path / "pics")
    _corpus(media)
    monkeypatch.setitem(__import__("sys").modules, "transformers", None)
    common = dict(media_dir=media, model=pc.name, chunk_size=4, k=50, index_quantize="int8")
    ckpt = str(tmp_path / "converted.safetensors")
    from_hf = SearchEngine(ServerArgs(model_weights=ckpt, from_hf=hf, tokenizer_dir=str(tmp_path / "tok"),
                                      index_dir=str(tmp_path / "idx_hf"), **common), device="cpu")
    from_ref = SearchEngine(ServerArgs(model_weights=ref_ckpt, tokenizer_dir=hf, index_dir=str(tmp_path / "idx_ref"),
                                       **common), device="cpu")
    assert os.path.exists(ckpt) and from_hf.cfg == pc
    for name in ("vocab.json", "merges.txt"):
        with open(os.path.join(hf, name), "rb") as a, open(os.path.join(tmp_path, "tok", name), "rb") as b:
            assert a.read() == b.read()
    bodies = []
    for engine in (from_hf, from_ref):
        assert engine.scan().embedded == 6
        server, thread, base = _serve(engine)
        try:
            status, plain = _post(base, {"q": "a red square", "referenced_images": []})
            marked = [d["image_path"] for d in json.loads(plain)["images"][:2]]
            status2, fb = _post(base, {"q": "a red square", "referenced_images": marked})
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)
        assert status == status2 == 200 and len(json.loads(plain)["images"]) == 6
        bodies.append((plain, fb))
    assert bodies[0] == bodies[1]


# ---- B2 at the ladder's row widths ---------------------------------------------


@pytest.mark.parametrize("rows_from", ["unit vectors", "extreme"])
@pytest.mark.parametrize("d", [1024, 1280])
def test_int8_scores_bitwise_at_ladder_widths(d, rows_from):
    """B2's plain version at H/14's and bigG's row widths, bitwise against the
    reference's ``stream_scores_int8`` in interpret mode (its s32 path). On
    rows quantized from unit vectors every partial sum stays far below 2^24;
    "extreme" rows (every entry +-1/sqrt(d), so every int8 value is +-127,
    and the queries the same rows) reach 127 * 127 * d, above 2^24 at 1280,
    where an f32 sum would round."""
    n, b, block = 512, 8, 128
    rng = np.random.default_rng(d)
    if rows_from == "unit vectors":
        x = rng.standard_normal((n + b, d)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    else:
        x = (rng.choice([-1.0, 1.0], size=(n + b, d)) / np.sqrt(d)).astype(np.float32)
        x[n:] = x[:b]  # each query equals a row: its score is 127 * 127 * d
    rows, scales = (np.array(a) for a in jax_quantize(jnp.asarray(x[:n])))
    qi, qs = (np.array(a) for a in jax_quantize(jnp.asarray(x[n:])))
    limit = n - 3
    want = jax_stream_scores_int8(jnp.asarray(rows), jnp.asarray(qi), jnp.asarray(qs), jnp.asarray(scales),
                                  jnp.int32(limit), block=block, interpret=True)
    got = stream_scores_int8(*map(torch.from_numpy, (rows, qi, qs, scales)), limit)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if rows_from == "extreme":
        assert (np.abs(qi.astype(np.int64) @ rows.astype(np.int64).T).max()) == 127 * 127 * d
