"""What every cell shares: the spec in ``BENCHMARK.json``, the per-layer
metric readers, the device record and the result line.

A cell's traffic file names its ``kind`` (``search``, ``scan``,
``finetune``): the driver module ``drivers/<kind>.py`` runs it and returns a
:class:`Result`. The harness keeps the metrics that ``BENCHMARK.json``
declares for the cell: its end-to-end metrics with ``--trace 0``, its
per-layer metrics (each read by ``metrics/<name>.py``) with ``--trace 1``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"unknown workload {name!r}; known: {[w['name'] for w in bench['workloads']]}")


def traffic(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` prints, in ``BENCHMARK.json``'s order."""
    return [m for m in bench["per_layer" if trace else "end_to_end"] if _applies(m, cell)]


def reader(name: str):
    """``metrics/<name>.py``'s ``read(ctx) -> float | None``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    mod_name = "bench_port_metric_" + "".join(c if c.isalnum() else "_" for c in name)
    loaded = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(loaded)
    loaded.loader.exec_module(mod)
    return mod.read


JAX_NAMES = frozenset(("jax", "jaxlib", "flax", "image_search_tpu"))


def jax_modules() -> list:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX
    package's, compared whole (``image_search_tpu_torch`` is the port)."""
    return sorted({name.partition(".")[0] for name in list(sys.modules)} & JAX_NAMES)


def driver(kind: str):
    return importlib.import_module(f"bench_port.drivers.{kind}")


@dataclasses.dataclass
class Result:
    """What a driver hands back: the end-to-end values it measured, the
    context the per-layer readers read, the outcome of the comparison with
    the plain reference, and the device record."""

    end_to_end: dict  # metric name -> value
    context: dict  # what metrics/<name>.py read (see their docstrings)
    correct: bool
    checks: dict  # short plain name -> {"value": x, "limit": y}
    attempted: int
    failed: int
    device: dict
    breakdown: dict | None = None


def device_record(torch, device, count: int, peak_bytes: int) -> dict:
    """The run's device. ``run.py`` never reaches a driver without a card;
    the CPU record exists for the harness's own tests."""
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(peak_bytes)}


def _number(x: float) -> float:
    """JSON has no infinity: a request that failed is infinitely slow, and
    such a run is never correct; its tail is written as 1e300."""
    return 1e300 if math.isinf(x) else float(x)


def result_line(bench: dict, cell: str, trace: bool, res: Result) -> dict:
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        if trace:
            value = reader(m["name"])(res.context)
            print(f"per-layer {m['name']}: {value!r}", file=sys.stderr)
        else:
            value = res.end_to_end.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": _number(value), "unit": m["unit"]}
    line = {"correct": bool(res.correct), "attempted": int(res.attempted), "failed": int(res.failed),
            "metrics": metrics, "device": dict(res.device)}
    if trace and res.breakdown is not None:
        line["breakdown"] = res.breakdown
    line["checks"] = res.checks
    return line


def print_result(line: dict) -> None:
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own nvcc cache is ``build/torch_kernels/`` already)."""
    base = os.path.join(ROOT, "build", "bench_port_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def host_state() -> dict:
    """The host's CPU times (``/proc/stat``) and memory (``/proc/meminfo``),
    each only where its file can be read."""
    out = {}
    try:
        with open("/proc/stat") as f:
            cpu = [int(x) for x in f.readline().split()[1:]]
        out["cpu_total"], out["cpu_steal"] = sum(cpu[:8]), cpu[7]
    except (OSError, ValueError, IndexError):
        pass
    try:
        with open("/proc/meminfo") as f:
            mem = {line.split(":")[0]: int(line.split()[1]) for line in f}
        out["available_gib"], out["cached_gib"] = mem["MemAvailable"] / 2**20, mem["Cached"] / 2**20
    except (OSError, ValueError, KeyError, IndexError):
        pass
    return out


def host_line(a: dict, b: dict) -> str:
    """What the host did between two ``host_state`` readings: the CPU time
    stolen from this machine, and its free memory and page cache at the
    first."""
    parts = []
    if "cpu_total" in a and "cpu_total" in b:
        steal = (b["cpu_steal"] - a["cpu_steal"]) / max(1, b["cpu_total"] - a["cpu_total"])
        parts.append(f"CPU steal {100 * steal} % over the run")
    if "available_gib" in a:
        parts.append(f"at the start {a['available_gib']} GiB available, {a['cached_gib']} GiB page cache")
    return "host: " + ("; ".join(parts) or "not read")
