"""Load the reference's numpy/stdlib-only modules without importing jax.

``image_search_tpu.index.store`` (the on-disk format), ``server/wire.py``,
``server/args.py`` and ``ingest/walk.py`` import nothing from jax, but their
packages' ``__init__`` files do: a plain ``import image_search_tpu.index.store``
runs ``image_search_tpu/index/__init__.py``, which imports jax. So the port
loads each of these files by path, as a module of its own, and both packages
share one source file for each -- nothing is copied.

The module is put into ``sys.modules`` before it executes: ``dataclasses``
looks its defining module up there (``wire.py``'s ``@dataclass`` fails without
it).
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

REFERENCE_ROOT = Path(__file__).resolve().parent.parent / "image_search_tpu"


def load(relpath: str):
    """Load ``image_search_tpu/<relpath>`` (e.g. ``"index/store.py"``) once."""
    name = "image_search_tpu_torch._jaxfree." + relpath[: -len(".py")].replace("/", ".")
    mod = sys.modules.get(name)
    if mod is not None:
        return mod
    spec = importlib.util.spec_from_file_location(name, REFERENCE_ROOT / relpath)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {REFERENCE_ROOT / relpath}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


store = load("index/store.py")
wire = load("server/wire.py")
args = load("server/args.py")
walk = load("ingest/walk.py")
