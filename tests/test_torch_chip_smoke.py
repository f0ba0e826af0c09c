"""chip_smoke.py refuses to run without a GPU: importing it runs nothing,
and running it where ``torch.cuda.is_available()`` is false exits non-zero
before any phase, printing no result."""

import contextlib
import importlib.util
import io
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def test_import_has_no_side_effects():
    out = io.StringIO()
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    with contextlib.redirect_stdout(out):
        spec.loader.exec_module(mod)
    assert out.getvalue() == ""
    assert callable(mod.main)
    with open(SCRIPT) as f:
        imported = re.findall(r"^\s*(?:from|import) (\S+)", f.read(), re.M)
    assert not [m for m in imported if m.split(".")[0] in ("jax", "jaxlib")]
    # nothing of the JAX package either: the port keeps its own copies
    assert not [m for m in imported if m.split(".")[0] == "image_search_tpu"]
    assert "image_search_tpu_torch.config" in imported


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_exits_nonzero_without_gpu(tmp_path, where):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the script would run")
    if where == "alone":
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(SCRIPT, script)
        cwd = str(tmp_path)
    else:
        script, cwd = SCRIPT, REPO
    proc = subprocess.run(
        [sys.executable, script], cwd=cwd, capture_output=True, text=True, timeout=180,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert proc.returncode != 0
    assert proc.stdout == ""  # no phase ran, no result line
    assert "is_available() is False" in proc.stderr
