"""``POST /search_image`` (query by photo) under open- or closed-loop load over
a corpus made from the seed.

Set-up, as the search driver's (``drivers/search.py::Serving``): the engine
on the configuration's flags and the harness's weights, the corpus made on
the device and loaded through ``VectorIndex.add``, ``make_server`` and its
batcher's warm-up; then the pool of JPEGs made from the seed
(``gen_photo_query``), each posted once to the engine (every upload shape
the window will see), and the schedule's warm-up phase of the same
traffic. The window: every request due in it, sent by ``loadgen_photo.py``
(a process of its own) at its due time with the photo's bytes; latency
counts from the due time, and a failed request is infinitely slow. A closed
loop and its metric are the search driver's. After the window closes and
every answer is in, the peak memory is read, the server and the engine are
freed, and the reference (``reference/search_image.py``) answers the
sampled requests.

Traced runs also record, for the readers: the program's spans
(``bench_port/spans.py``), B2's calls, the attention forward's shapes and
the long-key kernel's launch count over the window.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

from bench_port import gen_corpus, gen_photo_query, harness
from bench_port.drivers import common, search
from bench_port.drivers.scan import _AttnShapes
from bench_port.reference import search_image as ref_search_image
from bench_port.trace import Tracer


def long_launches():
    """Launches of the long-key attention forward so far (every entry that
    reaches it), or None where the program counts none."""
    from image_search_tpu_torch.ops import attention as A

    fns = (A.fused_attention, A.fused_attention_packed, A.fused_attention_qkv_packed)
    if not all(hasattr(f, "long_launches") for f in fns):
        return None
    return sum(f.long_launches for f in fns)


PHOTO_SPANS = ("image.decode", "image_embed", "image.preprocess", "index_search", "search.rocchio", "search.scan",
               "search.topk", "search.to_host")


def describe(record: dict) -> str:
    """The stderr line of a traced run: host and device ms a request (an
    ``image_embed`` span) in each span of the query-by-photo path."""
    n = record["count"].get("image_embed", 0)
    if n <= 0:
        return "spans: no image query started in the window"
    parts = [f"{name} {1e3 * record['host_s'].get(name, 0.0) / n} / {1e3 * record['device_s'].get(name, 0.0) / n}"
             for name in PHOTO_SPANS]
    return f"spans, host / device ms a request over {n} requests: " + "; ".join(parts)


class PhotoServing(search.Serving):
    """The search driver's set-up, and the pool of photos posted once."""

    def __init__(self, torch, cell: common.Cell):
        super().__init__(torch, cell)
        self.photos = gen_photo_query.write_pool(torch, cell.mix, cell.seed, os.path.join(cell.tmp, "pool"),
                                                 cell.device)
        for path in self.photos:
            with open(path, "rb") as f:
                self.engine.search_by_image(f.read(), self.args.k)
        common.free(torch, cell.device)

    def window(self, load, seconds: float, trace: bool, tag: str = "load") -> dict:
        """One run of ``load`` (``search.load_of``'s: its warm-up phase,
        then the window of ``seconds``) -> the answers, counter snapshots at
        the window's ends, the trace summary and record, this process's CPU
        seconds in the window, and the set-up's end."""
        from image_search_tpu_torch.utils.metrics import global_metrics

        torch, tmp = self.torch, self.cell.tmp
        spec_path, out_path = os.path.join(tmp, f"{tag}.json"), os.path.join(tmp, f"{tag}.answers.json")
        b2 = search._Spans(torch, self.engine) if trace else None
        shapes = _AttnShapes(torch) if trace else None
        tracer = Tracer(torch, trace)
        t = time.perf_counter()
        tracer.start()
        if trace:
            print(f"search_image: the profiler took {time.perf_counter() - t} s to start", file=sys.stderr)
        t0 = time.monotonic() + 1.0 + load.lead_s()
        with open(spec_path, "w") as f:
            json.dump({"port": self.srv.server_port, "t0": t0, "seconds": seconds, "k": self.args.k,
                       "photos": self.photos} | load.spec(), f)
        loadgen = subprocess.Popen([sys.executable, os.path.join(harness.HERE, load.script), spec_path, out_path])
        self._pin(loadgen.pid)
        try:
            time.sleep(max(0.0, t0 - time.monotonic()))
            setup_end = time.perf_counter()
            before, long0, cpu0 = global_metrics.snapshot(), long_launches(), search.cpu_s()
            for rec in (b2, shapes):
                if rec:
                    rec.on = True
            with tracer.window():
                time.sleep(max(0.0, t0 + seconds - time.monotonic()))
            cpu1 = search.cpu_s()
            for rec in (b2, shapes):
                if rec:
                    rec.on = False
            loadgen.wait(timeout=seconds + 120)
            after, long1 = global_metrics.snapshot(), long_launches()
            tracer.stop()
        finally:
            if loadgen.poll() is None:
                loadgen.kill()
                loadgen.wait()
            if b2:
                b2.restore()
            if shapes:
                shapes.restore()
        with open(out_path) as f:
            answers = json.load(f)
        record = search.span_record(tracer)
        if record is not None:
            print(describe(record), file=sys.stderr)
        return {"answers": answers, "before": before, "after": after, "summary": tracer.summary(), "spans": record,
                "b2": b2.b2 if b2 else [], "attn_calls": shapes.calls if shapes else [],
                "long_launches": None if long0 is None else long1 - long0, "cpu_s": cpu1 - cpu0,
                "setup_end": setup_end}


def run(cell: common.Cell) -> harness.Result:
    import torch

    mix, device = cell.mix, cell.device
    serving = PhotoServing(torch, cell)
    load = search.load_of(mix, cell.seed, cell.seconds)
    out = serving.window(load, cell.seconds, cell.trace)
    setup_s = out["setup_end"] - cell.start
    summary = out["summary"]
    peak = common.peak_bytes(torch, device)
    k, load_s, photos = serving.args.k, serving.load_s, serving.photos
    serving.close()
    seen = load.seen(out["answers"], cell.seconds, out["cpu_s"])
    reqs, keep, lat, late, failed = seen["reqs"], seen["keep"], seen["lat"], seen["late"], seen["failed"]
    p50, p95 = (search._quantile(lat, 0.5), search._quantile(lat, 0.95)) if lat else (None, None)
    print(f"search_image: {seen['per_s']} searches/s ({load.metric}); from the due time p50 {p50} ms, "
          f"p95 {p95} ms", file=sys.stderr)
    print(f"search_image: {seen['attempted']} requests attempted, {failed} failed; generator lateness p95 "
          f"{search._quantile(late, 0.95) if late else 0.0} ms; corpus load {load_s} s of set-up {setup_s} s",
          file=sys.stderr)
    if seen["note"]:
        print(f"search_image: {seen['note']}", file=sys.stderr)
    checks, correct = _check(torch, cell, reqs, keep, out["answers"], k, photos)
    context = {
        "before": out["before"], "after": out["after"], "trace": summary, "seconds": cell.seconds,
        "spans": out["spans"], "b2_calls": out["b2"], "attn_calls": out["attn_calls"],
        "long_launches": out["long_launches"], "model": cell.model, "corpus_rows": mix["corpus"]["rows"],
        "latency_ms": {"p50": p50, "p95": p95},
    }
    return harness.Result(
        end_to_end={load.metric: seen["per_s"], "setup_s": setup_s},
        context=context, correct=correct and failed == 0, checks=checks, attempted=seen["attempted"], failed=failed,
        device=harness.device_record(torch, device, 1, peak) | (
            {"busy_s": summary["busy_s"], "window_s": summary["window_s"]} if summary else {}),
        breakdown=summary["breakdown"] if summary else None,
    )


def _requests(reqs, keep, answers, photos):
    """The sampled requests as the reference takes them, and the served
    answers; a sampled request never answered is listed apart."""
    kept = answers["kept"]
    missing = [i for i in keep if kept[str(i)]["body"] is None]
    got = [i for i in keep if kept[str(i)]["body"] is not None]
    served = [search._served(kept[str(i)]["body"]) for i in got]
    requests = [{"photo": photos[reqs[i]["photo"]], "refs": [gen_corpus.row_of(p) for p in kept[str(i)]["refs"]]}
                for i in got]
    return requests, served, missing


def _check(torch, cell: common.Cell, reqs, keep, answers, k: int, photos, extra=None):
    """The sampled answers against the plain reference -> (checks, correct);
    with ``extra`` (more answers to the same requests) also their numbers."""
    requests, served, missing = _requests(reqs, keep, answers, photos)
    look_up = [[r for r, _ in s] for s in served]
    if extra is not None:
        look_up = [a + [r for r, _ in b] for a, b in zip(look_up, extra)]
    ids, scores, found = ref_search_image.answers(cell.model, search._state(torch, cell), cell.mix["corpus"],
                                                  cell.seed, requests, k, cell.device, look_up=look_up)
    limits = cell.mix["limits"]

    def numbers(ans, unanswered):
        nums = search.ref_search.compare(ans, ids, scores, found, k)
        return {
            "unanswered": {"value": unanswered, "limit": 0},
            "malformed": {"value": nums["malformed"], "limit": 0},
            "score_gap": {"value": nums["score_gap"], "limit": limits["score_gap"]},
            "rank_gap": {"value": nums["rank_gap"], "limit": limits["rank_gap"]},
        }

    checks = numbers(served, len(missing))
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if extra is not None:
        return checks, correct, numbers(extra, 0)
    return checks, correct


def control(cell: common.Cell) -> dict:
    """One run of the cell, then the control in the program's place: the
    reference in fp8 and int4 answering the same sampled requests, with the
    same marks -> both sets of numbers."""
    import torch

    serving = PhotoServing(torch, cell)
    load = search.load_of(cell.mix, cell.seed, cell.seconds)
    out = serving.window(load, cell.seconds, False)
    k, photos = serving.args.k, serving.photos
    serving.close()
    seen = load.seen(out["answers"], cell.seconds, out["cpu_s"])
    reqs, keep = seen["reqs"], seen["keep"]
    requests, _, _ = _requests(reqs, keep, out["answers"], photos)
    c_ids, c_scores, _ = ref_search_image.answers(cell.model, search._state(torch, cell), cell.mix["corpus"],
                                                  cell.seed, requests, k, cell.device, lowp=True)
    ctrl = [list(zip(i.tolist(), v.tolist())) for i, v in zip(c_ids, c_scores)]
    checks, correct, ctrl_checks = _check(torch, cell, reqs, keep, out["answers"], k, photos, extra=ctrl)
    return {"program": checks, "program_correct": correct, "control": ctrl_checks,
            "control_correct": all(c["value"] <= c["limit"] for c in ctrl_checks.values())}


def sweep(cell: common.Cell, rates: list) -> list:
    """One set-up, then one open-loop window a rate (the mix's, with
    ``rate_per_s`` replaced) -> a dict a rate: requests, failures, p50 and
    p95 from the due time, the p95 of the window's two halves (a growing
    backlog shows as a later half slower than the first), searches a
    second. The knee is the highest rate whose p95 holds steady with no
    backlog."""
    import torch

    serving = PhotoServing(torch, cell)
    out = []
    for n, rate_per_s in enumerate(rates):
        reqs = gen_photo_query.schedule(dict(cell.mix, rate_per_s=rate_per_s), cell.seed + n, cell.seconds)
        res = serving.window(search.OpenLoad(reqs, [], "loadgen_photo.py"), cell.seconds, False, tag=f"rate{n}")
        rows = res["answers"]["rows"]
        lat, _ = search.latencies(reqs, rows)
        half = len(lat) // 2
        out.append({
            "rate_per_s": rate_per_s, "requests": len(lat), "failed": sum(1 for x in lat if math.isinf(x)),
            "searches_per_s": search.rate(reqs, rows),
            "p50_ms": search._quantile(lat, 0.5), "p95_ms": search._quantile(lat, 0.95),
            "p95_first_half_ms": search._quantile(lat[:half], 0.95),
            "p95_second_half_ms": search._quantile(lat[half:], 0.95),
        })
        print(json.dumps(out[-1]), flush=True)
    serving.close()
    return out
