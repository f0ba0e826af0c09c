"""Run one cell of the port's benchmark and print its result line.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name in ``BENCHMARK.json``; its configuration is
``bench_port/configs/<config>.json`` and its traffic mix
``bench_port/traffic/<traffic>.json``, whose ``kind`` names the driver. The
last line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: every number compared with the plain reference beside its
limit, also printed as the last lines of standard error; the line before
them reads the host: its CPU steal and memory compaction over the run).
Without a CUDA
card, or with fewer cards than the cell asks for, it prints no result and
exits with 2; with JAX or the JAX package loaded once the window has
closed, with 3.
"""

import time

START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

if os.environ.get("PYTHONHASHSEED") != "0":
    # one string-hash seed for every run, so no two runs lay out the
    # program's dicts and sets differently; set-up still counts from here
    os.execve(sys.executable, [sys.executable] + sys.argv,
              dict(os.environ, PYTHONHASHSEED="0", BENCH_PORT_START=repr(START)))
START = float(os.environ.pop("BENCH_PORT_START", START))

import argparse  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from bench_port import harness, model_config
    from bench_port.drivers.common import Cell

    harness.cache_env()
    bench = harness.spec()
    w = harness.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"{args.workload} needs {w['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result", file=sys.stderr)
        return 2
    host0 = harness.host_state()
    cfg = model_config.load(w["config"])
    mix = harness.traffic(w["traffic"])
    tmp = tempfile.mkdtemp(prefix="bench_port_")
    try:
        cell = Cell(args.workload, cfg, mix, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                    tmp, START)
        res = harness.driver(mix["kind"]).run(cell)
        line = harness.result_line(bench, args.workload, bool(args.trace), res)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    loaded = harness.jax_modules()
    if loaded:
        print(f"{args.workload}: the run loaded {loaded}, JAX or the JAX package: no result", file=sys.stderr)
        return 3
    print(harness.host_line(host0, harness.host_state()), file=sys.stderr)
    harness.print_result(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
