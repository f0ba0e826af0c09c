"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface and are compiled by ``nvcc`` into one
shared library, loaded with ``ctypes`` -- no PyTorch headers, so a build takes
seconds, not minutes. Each source compiles in its own ``nvcc`` process, all
started together, and one more links the objects. The library lands in
``build/torch_kernels/<hash>/`` under the repository root, keyed by a hash of
the sources and the flags, and is built at first use: importing this module
builds nothing, and nothing here
runs on a machine without ``nvcc`` until a CUDA tensor reaches a kernel.

Every C entry point launches on the stream it is given (the wrappers pass
``torch.cuda.current_stream().cuda_stream``) and returns ``cudaGetLastError()``;
:func:`check` turns a nonzero return into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libisx_kernels.so"

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build this process ran (None: cached or not built)

_vp, _i, _ll, _f, _sz = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_size_t,
)
_SIGNATURES = {
    "isx_attention_fwd": (
        [_vp, _vp, _vp, _vp, _i, _i, _i, _i, _ll, _ll, _ll, _ll, _i, _f, _vp], _i,
    ),
    "isx_attention_fwd_normalized": (
        [_vp, _vp, _vp, _vp, _i, _i, _i, _i, _ll, _ll, _ll, _ll, _i, _i, _i, _f, _vp], _i,
    ),
    "isx_attention_smem_bytes": ([_i, _i], _sz),
    "isx_attention_div_probe": ([_vp, _vp, _vp, _i, _vp], _i),
    "isx_attention_bwd": (
        [_vp] * 8 + [_i, _i, _i, _i, _ll, _ll, _ll, _ll, _i, _f, _vp], _i,
    ),
    "isx_attention_bwd_probe": (
        [_vp] * 9 + [_i, _i, _i, _i, _ll, _ll, _ll, _ll, _i, _f, _vp], _i,
    ),
    "isx_attention_bwd_smem_bytes": ([_i, _i], _sz),
    "isx_score_int8": ([_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _vp], _i),
    "isx_blockpair_mask": ([_vp, _vp, _i, _i, _i, _f, _i, _vp, _vp], _i),
    "isx_blockpair_values": ([_vp, _vp, _i, _i, _i, _i, _vp, _vp], _i),
    "isx_ln_matmul": ([_vp] * 6 + [_i, _i, _i, _f, _vp], _i),
    "isx_qkv_attention": ([_vp] * 4 + [_i, _i, _i, _i, _i, _f, _vp], _i),
    "isx_qkv_attention_probe": ([_vp] * 4 + [_i, _i, _i, _i, _vp], _i),
    "isx_qkv_attention_smem_bytes": ([_i], _sz),
    "isx_row_quant": ([_vp, _vp, _vp, _vp, _ll, _i, _i, _vp, _i, _i, _vp], _i),
}


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _headers():
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile ``csrc/*.cu`` unless a library for these exact sources exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        objs = [os.path.join(tmpdir, src.stem + ".o") for src in _sources()]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(_sources(), objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        (out.parent / "nvcc.log").write_text("".join(logs))
        for src, p, text in zip(_sources(), procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({p.returncode}):\n{text[-4000:]}")
        tmp = os.path.join(tmpdir, LIB_NAME)
        link = subprocess.run(
            [nvcc, "-shared", "-o", tmp, *objs], capture_output=True, text=True
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-4000:]}")
        os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = handle
        return _lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        import torch

        name = torch.cuda.get_device_name() if torch.cuda.is_available() else "?"
        raise RuntimeError(f"{what}: CUDA error {rc} on {name}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
