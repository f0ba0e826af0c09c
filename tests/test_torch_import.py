"""The port imports torch and never jax, and imports without nvcc or triton.

Each check runs in a fresh interpreter: this test process has jax loaded
already (tests/conftest.py).
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "image_search_tpu_torch",
    "image_search_tpu_torch._build",
    "image_search_tpu_torch._jaxfree",
    "image_search_tpu_torch.ops.attention",
    "image_search_tpu_torch.ops.score_stream",
    "image_search_tpu_torch.ops.preprocess",
    "image_search_tpu_torch.ops.topk",
    "image_search_tpu_torch.models.clip",
    "image_search_tpu_torch.models.convert",
    "image_search_tpu_torch.models.embedder",
    "image_search_tpu_torch.index.index",
    "image_search_tpu_torch.ingest.decode",
    "image_search_tpu_torch.ingest.pipeline",
    "image_search_tpu_torch.server.engine",
    "image_search_tpu_torch.server.app",
]


def _python(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=180
    )


def test_port_never_imports_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "ref = sorted(m for m in sys.modules if m.startswith('image_search_tpu.'))\n"
        "print(bad, ref)\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
    )
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    # only the jax-free reference modules the port may import
    allowed = {
        "image_search_tpu.config", "image_search_tpu.tokenizer", "image_search_tpu.tokenizer.bpe",
        "image_search_tpu.utils", "image_search_tpu.utils.metrics", "image_search_tpu.utils.profiling",
        "image_search_tpu.version",
    }
    ref = eval(proc.stdout.strip().split("] ", 1)[1])
    assert set(ref) <= allowed, set(ref) - allowed


def test_jaxfree_loader_shares_the_reference_files():
    code = (
        "import sys\n"
        "from image_search_tpu_torch import _jaxfree\n"
        "for m in (_jaxfree.store, _jaxfree.wire, _jaxfree.args, _jaxfree.walk):\n"
        "    assert sys.modules[m.__name__] is m\n"
        "    print(m.__file__)\n"
        "assert _jaxfree.load('server/wire.py') is _jaxfree.wire\n"
        "p = _jaxfree.wire.SearchParams.from_json({'q': 'x'})\n"
        "assert p.referenced_images == [] and 'jax' not in sys.modules\n"
    )
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    files = proc.stdout.split()
    assert [os.path.relpath(f, REPO) for f in files] == [
        os.path.join("image_search_tpu", p)
        for p in ("index/store.py", "server/wire.py", "server/args.py", "ingest/walk.py")
    ]


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


@pytest.mark.parametrize("name", ["attention.cu", "score_stream.cu"])
def test_kernel_sources_name_the_tpu_kernel_they_replace(name):
    with open(os.path.join(REPO, "image_search_tpu_torch", "csrc", name)) as f:
        src = f.read()
    want = {"attention.cu": "_attn_kernel_grouped", "score_stream.cu": "_kernel_pen"}[name]
    assert want in src and 'extern "C"' in src and "cudaGetLastError" in src
