"""One traced run of a search cell, read through the program's own spans.

    python3 bench_port/span_report.py --workload l14-search-10m --seed <n> --seconds <s>

It runs the cell as ``run.py --trace 1`` does and prints the same result
line, then keeps the profiler's events and reads them with
``bench_port/spans.py`` (as the readers of a traced run do): on standard
error the per-layer metrics that need that record (``SPAN_METRICS``), the
share of the device-idle time in which no program span was open, and the
ten longest device-idle gaps with the spans open across them and the
Python garbage collections that overlap them; last on standard output one
JSON line ``{"spans": <record less its intervals>, "metrics": {...}, "collections": [...]}``.
"""

import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port import run  # noqa: E402  (re-executes this script under run.py's string-hash seed)

SPAN_METRICS = ("search.launch_ms", "search.sync_ms", "search.format_ms", "search.tower_device_ms",
                "search.topk_device_ms")


def main(argv=None) -> int:
    from bench_port import harness, spans, trace
    from bench_port.drivers import search

    argv = (sys.argv[1:] if argv is None else argv) + ["--trace", "1"]
    kept, collections, started = {}, [], []

    class KeepingTracer(trace.Tracer):
        def summary(self):
            if self.prof is not None and self.bounds is not None:
                kept["spans"] = spans.record(self.prof.profiler.kineto_results.events(), *self.bounds)
                kept["bounds"] = self.bounds
            return super().summary()

    result_line = harness.result_line

    def with_span_metrics(bench, cell, traced, res):
        if "spans" in kept:
            ctx = dict(res.context, spans=kept["spans"])
            kept["metrics"] = {name: harness.reader(name)(ctx) for name in SPAN_METRICS}
        return result_line(bench, cell, traced, res)

    def on_gc(phase, info):
        if phase == "start":
            started.append(time.time_ns())
        elif started:
            collections.append((started.pop(), time.time_ns(), info["generation"]))

    search.Tracer, harness.result_line = KeepingTracer, with_span_metrics
    gc.callbacks.append(on_gc)
    try:
        rc = run.main(argv)
    finally:
        gc.callbacks.remove(on_gc)
    rec = kept.get("spans")
    if rc != 0 or rec is None:
        print("span report: no traced window", file=sys.stderr)
        return rc or 1
    print(spans.describe(rec), file=sys.stderr)
    for name, value in kept.get("metrics", {}).items():
        print(f"span metric {name}: {value!r}", file=sys.stderr)
    for name in sorted(rec["host_s"], key=lambda n: -rec["host_s"][n]):
        print(f"span {name}: {rec['count'][name]} spans, host {rec['host_s'][name]} s, device "
              f"{rec['device_s'].get(name, 0.0)} s", file=sys.stderr)
    for g in rec["gaps"]:
        gcs = [(gen, (e - s) / 1e9) for s, e, gen in collections if s < g["end_ns"] and e > g["start_ns"]]
        print(f"gap {g['s']} s: open {g['open']}; collections (generation, s) {gcs}", file=sys.stderr)
    w0, w1 = kept["bounds"]
    in_window = [c for c in collections if w0 <= c[0] < w1]
    for gen in sorted({c[2] for c in in_window}):
        took = [(e - s) / 1e9 for s, e, g in in_window if g == gen]
        print(f"collections of generation {gen} in the window: {len(took)}, {sum(took)} s, longest {max(took)} s",
              file=sys.stderr)
    rec = {key: v for key, v in rec.items() if key != "intervals"}  # one pair a span: too long for a line
    print(json.dumps({"spans": rec, "metrics": kept.get("metrics", {}), "collections": in_window}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
