"""Readings that set a cell's limits: the program and the control on many
seeds, on the card at the cell's own size.

    python3 bench_port/control.py --workload <name> --seeds 11,12,13 --seconds <s>

For every seed it runs the cell (a short window at its own load), compares
the program's answers with the plain reference, then puts the control in
the program's place (the reference one precision step below what the
configuration states) and compares that too; one JSON line a seed. The
benchmark's own runs never run the control.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
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
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from bench_port import harness, model_config
    from bench_port.drivers.common import Cell

    harness.cache_env()
    w = harness.workload(harness.spec(), args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cfg, mix = model_config.load(w["config"]), harness.traffic(w["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        tmp = tempfile.mkdtemp(prefix="bench_port_control_")
        try:
            cell = Cell(args.workload, cfg, mix, seed, args.seconds, False, torch.device("cuda", 0), tmp,
                        time.perf_counter())
            out = harness.driver(mix["kind"]).control(cell)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps({"workload": args.workload, "seed": seed} | out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
