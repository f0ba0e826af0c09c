"""Find the query-by-photo cell's knee: one set-up, then windows at rising rates.

    python3 bench_port/sweep_photo.py --workload <name> --seed <n> --seconds <s> --rates 10,20,30

As ``sweep.py`` does for ``/search`` (the search driver's ``Serving`` and
schedule are its own): one JSON line a rate, from
``drivers/search_image.py::sweep``. The knee is the highest rate whose p95
holds steady with no backlog; a cell runs at 4/5 of it. Not part of any
cell's run.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    from bench_port import harness, model_config
    from bench_port.drivers import search_image
    from bench_port.drivers.common import Cell

    harness.cache_env()
    w = harness.workload(harness.spec(), args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cfg, mix = model_config.load(w["config"]), harness.traffic(w["traffic"])
    tmp = tempfile.mkdtemp(prefix="bench_port_sweep_")
    try:
        cell = Cell(args.workload, cfg, mix, args.seed, args.seconds, False, torch.device("cuda", 0), tmp, START)
        search_image.sweep(cell, [float(r) for r in args.rates.split(",")])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
