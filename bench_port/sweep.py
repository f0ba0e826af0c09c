"""Find a search cell's knee: one set-up, then windows at rising rates.

    python3 bench_port/sweep.py --workload <name> --seed <n> --seconds <s> --rates 100,200,400

For each rate (the mix's, with ``rate_per_s`` replaced) one open-loop window
of ``--seconds`` after its warm-up phase; one JSON line a rate: requests,
failures, p50 and p95 from the due time, the p95 of the window's first and
second halves (a growing backlog shows as a later half slower than the
first), the generator's lateness and the mean batch. The knee is the
highest rate whose p95 holds steady with no backlog; a cell runs at 4/5 of
it. Not part of any cell's run.
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    from bench_port import gen_search, harness, model_config
    from bench_port.drivers import search
    from bench_port.drivers.common import Cell
    from bench_port.readers import delta, timer_calls

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
        serving = search.Serving(torch, cell)
        for n, rate in enumerate(float(r) for r in args.rates.split(",")):
            reqs = gen_search.schedule(dict(mix, rate_per_s=rate), args.seed + n, args.seconds)
            out = serving.window(search.OpenLoad(reqs, [], "loadgen.py"), args.seconds, False, tag=f"rate{n}")
            lat, late = search.latencies(reqs, out["answers"]["rows"])
            ok = [x for x in lat if x != float("inf")]
            half = len(lat) // 2
            calls = timer_calls(out, "index_search")
            print(json.dumps({
                "rate_per_s": rate, "requests": len(lat), "failed": len(lat) - len(ok),
                "p50_ms": search._quantile(lat, 0.5), "p95_ms": search._quantile(lat, 0.95),
                "p95_first_half_ms": search._quantile(lat[:half], 0.95),
                "p95_second_half_ms": search._quantile(lat[half:], 0.95),
                "late_p95_ms": search._quantile(late, 0.95) if late else None,
                "batch_mean": delta(out, "searches") / calls if calls else None,
            }), flush=True)
        serving.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
