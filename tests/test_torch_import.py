"""The port imports torch and nothing of jax or of the JAX package, and
imports without nvcc or triton. The modules it copied from the JAX package
behave as their counterparts there.

The import checks run in a fresh interpreter: this test process has jax and
the JAX package loaded already (tests/conftest.py).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "image_search_tpu_torch",
    "image_search_tpu_torch._build",
    "image_search_tpu_torch.config",
    "image_search_tpu_torch.tokenizer",
    "image_search_tpu_torch.tokenizer.bpe",
    "image_search_tpu_torch.utils.metrics",
    "image_search_tpu_torch.utils.eval",
    "image_search_tpu_torch.ops.attention",
    "image_search_tpu_torch.ops.blockmax",
    "image_search_tpu_torch.ops.score_stream",
    "image_search_tpu_torch.ops.preprocess",
    "image_search_tpu_torch.ops.topk",
    "image_search_tpu_torch.ops.ln_matmul",
    "image_search_tpu_torch.models.clip",
    "image_search_tpu_torch.models.convert",
    "image_search_tpu_torch.models.embedder",
    "image_search_tpu_torch.models.block_fused",
    "image_search_tpu_torch.index.store",
    "image_search_tpu_torch.index.twostage",
    "image_search_tpu_torch.index.dupscan",
    "image_search_tpu_torch.index.index",
    "image_search_tpu_torch.ingest.walk",
    "image_search_tpu_torch.ingest.decode",
    "image_search_tpu_torch.ingest.thumbcache",
    "image_search_tpu_torch.ingest.pipeline",
    "image_search_tpu_torch.server.wire",
    "image_search_tpu_torch.server.args",
    "image_search_tpu_torch.server.engine",
    "image_search_tpu_torch.server.app",
    "image_search_tpu_torch.train",
    "image_search_tpu_torch.train.contrastive",
    "image_search_tpu_torch.train.checkpoint",
    "image_search_tpu_torch.train.eval",
    "image_search_tpu_torch.train.finetune",
]


def _python(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=180
    )


def test_port_never_imports_jax_or_the_jax_package():
    code = (
        "import importlib, os, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "ref = sorted(m for m in sys.modules if m == 'image_search_tpu' or m.startswith('image_search_tpu.'))\n"
        "assert not ref, ref\n"
        f"root = os.path.join({REPO!r}, 'image_search_tpu') + os.sep\n"
        "files = sorted(f for f in (getattr(m, '__file__', None) for m in list(sys.modules.values())) if f and os.path.abspath(f).startswith(root))\n"
        "assert not files, files\n"
        "assert 'triton' not in sys.modules\n"
    )
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]


def _copy_config():
    from image_search_tpu import config as ref
    from image_search_tpu_torch import config as port

    # every JAX preset is in the port; the port's own are exactly the ones it alone serves
    assert set(ref.PRESETS) <= set(port.PRESETS) and "clip-vit-large-patch14" in ref.PRESETS
    assert set(port.PRESETS) - set(ref.PRESETS) == {"dfn5b-clip-vit-h-14-378"}
    for name in ref.PRESETS:
        assert dataclasses.asdict(port.get_config(name)) == dataclasses.asdict(ref.get_config(name))
        assert port.CLIPConfig.from_json(ref.get_config(name).to_json()).to_json() == ref.get_config(name).to_json()


def _copy_tokenizer():
    from image_search_tpu.tokenizer import HashTokenizer as RefHash, train_bpe as ref_train
    from image_search_tpu_torch.tokenizer import HashTokenizer, train_bpe

    texts = ["a red square", "", "A Photo of THINGS, number 42!", "é ü 漢字 emoji 🙂", "x" * 300]
    np.testing.assert_array_equal(HashTokenizer(49408, 77, eos_id=49407)(texts),
                                  RefHash(49408, 77, eos_id=49407)(texts))
    port_bpe = train_bpe(texts * 3, vocab_size=400, context_length=16)
    ref_bpe = ref_train(texts * 3, vocab_size=400, context_length=16)
    np.testing.assert_array_equal(port_bpe(texts), ref_bpe(texts))


def _copy_store(tmp_path):
    """Each package reads the index directory the other one wrote."""
    from image_search_tpu.index.store import EmbeddingStore as RefStore
    from image_search_tpu_torch.index.store import EmbeddingStore

    rng = np.random.default_rng(0)
    emb = rng.normal(size=(10, 24)).astype(np.float32)
    paths = [f"/photos/p{i}.jpg" for i in range(10)]
    for writer, reader, name in ((RefStore, EmbeddingStore, "a"), (EmbeddingStore, RefStore, "b")):
        w = writer(str(tmp_path / name), 24)
        w.append(paths[:6], emb[:6])
        w.append(paths[6:], emb[6:])
        w.tombstone([paths[2]], exclude=True)
        r = reader(str(tmp_path / name), 24)
        got_paths, got_emb = [], []
        for p, e in r.iter_shards():
            got_paths += list(p)
            got_emb.append(e)
        assert got_paths == paths and len(r) == 10
        np.testing.assert_array_equal(np.concatenate(got_emb), emb)
        live, _ = r.liveness()
        assert live is not None and not live[2] and live.sum() == 9
        assert r.excluded_paths() == {paths[2]}


def _copy_args_and_wire():
    from image_search_tpu.server import args as ref_args, wire as ref_wire
    from image_search_tpu_torch.server import args as port_args, wire as port_wire

    body = {"q": "cat", "referenced_images": ["media/a.jpg"]}
    assert port_wire.SearchParams.from_json(body) == port_wire.SearchParams(**vars(ref_wire.SearchParams.from_json(body)))
    assert port_wire.SearchParams.from_json({"q": "x"}).referenced_images == []
    for bad in ({"q": 3}, {"referenced_images": []}, {"q": "x", "referenced_images": "a"}):
        for mod in (port_wire, ref_wire):
            with pytest.raises(Exception):
                mod.SearchParams.from_json(bad)
    argv = ["-m", "/photos", "--index-quantize", "int8", "--k", "7"]
    assert vars(port_args.build_parser().parse_args([])) == vars(ref_args.build_parser().parse_args([]))
    assert vars(port_args.build_parser().parse_args(argv)) == vars(ref_args.build_parser().parse_args(argv))
    assert dataclasses.asdict(port_args.ServerArgs()) == dataclasses.asdict(ref_args.ServerArgs())


def _copy_walk(tmp_path):
    from image_search_tpu.ingest.walk import find_images as ref_find
    from image_search_tpu_torch.ingest.walk import find_images

    for rel in ("a.jpg", "b.PNG", "sub/c.bmp", "sub/d.txt", ".hidden/e.jpg", "f.webp"):
        os.makedirs(os.path.dirname(str(tmp_path / rel)), exist_ok=True)
        (tmp_path / rel).write_bytes(b"x")
    assert sorted(find_images(str(tmp_path))) == sorted(ref_find(str(tmp_path)))


def _copy_eval():
    from image_search_tpu.utils.eval import retrieval_metrics as ref
    from image_search_tpu_torch.utils.eval import retrieval_metrics

    rng = np.random.default_rng(1)
    img = rng.normal(size=(12, 8)).astype(np.float32)
    for txt in (img, np.roll(img, 1, axis=0), img + rng.normal(size=img.shape).astype(np.float32)):
        assert retrieval_metrics(img, txt, (1, 2, 5)) == ref(img, txt, (1, 2, 5))
    for bad in ((img, img[:3]), (img[:0], img[:0])):
        for fn in (retrieval_metrics, ref):
            with pytest.raises(ValueError):
                fn(*bad)


def _png_header(w: int, h: int) -> bytes:
    """A PNG whose header declares w x h RGB pixels and which holds none."""
    import struct
    import zlib

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)) + chunk(b"IEND", b"")


def _copy_decode():
    import io

    from PIL import Image

    from image_search_tpu.ingest import decode as ref
    from image_search_tpu_torch.ingest import decode as port

    assert port.MAX_QUERY_PIXELS == ref.MAX_QUERY_PIXELS
    rng = np.random.default_rng(2)
    arr = rng.integers(0, 256, size=(37, 53, 3), dtype=np.uint8)
    for fmt, img in (("PNG", Image.fromarray(arr)), ("BMP", Image.fromarray(arr)),
                     ("PNG", Image.fromarray(arr[:, :, 0])), ("PNG", Image.fromarray(arr).convert("RGBA"))):
        buf = io.BytesIO()
        img.save(buf, format=fmt)
        got = port.decode_image_bytes(buf.getvalue())
        np.testing.assert_array_equal(got, ref.decode_image_bytes(buf.getvalue()))
        assert got.shape == arr.shape and got.dtype == np.uint8
    for bad in (b"", b"not an image", _png_header(8_001, 8_000), _png_header(8_000, 8_000)[:40]):
        assert port.decode_image_bytes(bad) is None and ref.decode_image_bytes(bad) is None


def _copy_client():
    """The web client the port serves is the reference's, so
    tests/test_client_*.py (jsdom) cover it too: the scripts and the style
    sheet byte for byte, index.html but for one path in its header
    comment."""
    ref = os.path.join(REPO, "image_search_tpu", "client", "static")
    port = os.path.join(REPO, "image_search_tpu_torch", "client", "static")
    names = sorted(os.listdir(ref))
    assert names == sorted(os.listdir(port)) == ["app.js", "index.html", "logic.js", "style.css"]
    for name in names:
        with open(os.path.join(ref, name), "rb") as a, open(os.path.join(port, name), "rb") as b:
            want, got = a.read(), b.read()
        if name == "index.html":  # line 3: the path of the original project's client sources
            want, got = want.splitlines(), got.splitlines()
            assert len(want) == len(got) and [i for i in range(len(want)) if want[i] != got[i]] == [2]
            del want[2], got[2]
        assert got == want, name


def _copy_thumbcache():
    """The port's copy differs from the reference's in its docstring only."""
    import ast

    trees = []
    for pkg in ("image_search_tpu", "image_search_tpu_torch"):
        with open(os.path.join(REPO, pkg, "ingest", "thumbcache.py")) as f:
            tree = ast.parse(f.read())
        tree.body = tree.body[1:]  # the module docstring
        trees.append(ast.dump(tree))
    assert trees[0] == trees[1]


@pytest.mark.parametrize("module", ["config", "tokenizer", "store", "args_and_wire", "walk", "eval", "decode",
                                    "client", "thumbcache"])
def test_copies_behave_as_the_jax_packages(module, tmp_path):
    fn = globals()["_copy_" + module]
    fn(tmp_path) if fn.__code__.co_argcount else fn()


def test_kernel_library_is_not_built_at_import():
    """Importing the port compiles nothing (there is no nvcc here); the
    library path is keyed by the sources and lives under build/."""
    proc = _python(
        "from image_search_tpu_torch import _build\n"
        "import image_search_tpu_torch.ops.attention, image_search_tpu_torch.ops.score_stream\n"
        "assert _build._lib is None and _build.build_seconds is None\n"
        "print(_build.library_path())\n"
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    rel = os.path.relpath(proc.stdout.strip(), REPO).split(os.sep)
    assert rel[:2] == ["build", "torch_kernels"] and rel[-1] == "libisx_kernels.so"


@pytest.mark.parametrize("name", ["attention.cu", "attention_bwd.cu", "score_stream.cu", "blockmax.cu"])
def test_kernel_sources_name_the_tpu_kernel_they_replace(name):
    with open(os.path.join(REPO, "image_search_tpu_torch", "csrc", name)) as f:
        src = f.read()
    want = {
        "attention.cu": ("_attn_kernel_grouped", "_attn_kernel (", "_attn_kernel_split"), "attention_bwd.cu": ("_attn_bwd_kernel", "attention.py:122"),
        "score_stream.cu": ("_kernel_pen",), "blockmax.cu": ("_values_kernel",),
    }[name]
    assert all(w in src for w in want) and 'extern "C"' in src and "cudaGetLastError" in src
