"""``POST /search`` under open- or closed-loop load over a corpus made from the seed.

Set-up: the engine on the configuration's flags and the harness's weights;
the corpus made on the device block by block and loaded through
``VectorIndex.add`` with the index's store detached (rows restored at
server start are never rewritten to it); ``make_server`` with its batcher,
whose own warm-up (``warm_serving_buckets``) is waited for; then the
traffic's warm-up phase, so the window starts on a server in its steady
state. The window, open loop: every request due in it, sent by
``loadgen.py`` (a process of its own) at its due time; latency counts from
the due time, and a failed request is infinitely slow; ``searches_per_s``.
Closed loop (a mix with ``sessions``, ``ClosedLoad``): the sessions each
send their next request when the last is answered
(``loadgen_closed.py``); ``saturated_searches_per_s`` counts the answers
with status 200 that arrive inside the window, over its seconds. After
the window closes and every answer is in, the peak memory is read, the
server and the engine are freed, and the reference answers the sampled
requests.

Traced runs also record, for the readers: the program's spans
(``bench_port/spans.py``), and around ``engine.search_many`` and B2 the
harness's own (``_Spans``).
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

from bench_port import gen_corpus, gen_photo_query, gen_search, gen_sessions, harness, spans, weights
from bench_port.drivers import common
from bench_port.reference import search as ref_search
from bench_port.trace import Tracer

ADD_ROWS = 4096  # rows a VectorIndex.add call: one aligned append block


def load_corpus(torch, engine, corpus: dict, seed: int, device) -> float:
    """The corpus into the engine's index through ``add``, with the store
    detached for the load -> seconds taken."""
    t0 = time.perf_counter()
    index = engine.index
    store, index.store = index.store, None
    try:
        mix = gen_corpus.mix_matrix(torch, seed, corpus["rank"], engine.cfg.projection_dim, device)
        host = None
        for b, lo, rows in gen_corpus.blocks(corpus["rows"], corpus["block_rows"]):
            raw = gen_corpus.block(torch, seed, b, rows, mix, corpus["noise"])
            if torch.device(device).type == "cuda":
                if host is None or host.shape[0] < rows:
                    host = torch.empty(raw.shape, dtype=torch.float32, pin_memory=True)
                host[:rows].copy_(raw)
                arr = host[:rows].numpy()
            else:
                arr = raw.numpy()
            for c in range(0, rows, ADD_ROWS):
                n = min(ADD_ROWS, rows - c)
                paths = [os.path.join(engine.media_dir, gen_corpus.rel_path(lo + c + j)) for j in range(n)]
                index.add(paths, arr[c : c + n])
    finally:
        index.store = store
    return time.perf_counter() - t0


def _quantile(xs, q: float) -> float:
    """Nearest rank: the smallest value with at least q of the values at or
    below it."""
    xs = sorted(xs)
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


class _Spans:
    """Host spans of ``engine.search_many`` in the window (traced runs):
    (seconds, queries, text-cache hits), and B2's calls (B, rows, D)."""

    def __init__(self, torch, engine):
        from image_search_tpu_torch.index import index as index_mod
        from image_search_tpu_torch.utils.metrics import global_metrics

        self.calls, self.b2, self.on = [], [], False
        inner, metrics = engine.search_many, global_metrics
        self._index_mod, self._b2_inner = index_mod, index_mod.stream_scores_int8

        def search_many(queries, selections=None, k=None):
            if not self.on:
                return inner(queries, selections, k)
            hits0 = metrics.snapshot()["counters"].get("text_embed_cache_hits", 0.0)
            t = time.perf_counter()
            with torch.profiler.record_function("engine.search_many"):
                out = inner(queries, selections, k)
            dt = time.perf_counter() - t
            hits = metrics.snapshot()["counters"].get("text_embed_cache_hits", 0.0) - hits0
            self.calls.append({"s": dt, "queries": list(queries), "hits": hits})
            return out

        def b2(slab, qi, qs, scales, limit, pens=None):
            if self.on:
                self.b2.append((qi.shape[0], max(0, min(int(limit), slab.shape[0])), slab.shape[1], pens is not None))
            return self._b2_inner(slab, qi, qs, scales, limit, pens)

        engine.search_many = search_many
        index_mod.stream_scores_int8 = b2

    def restore(self) -> None:
        self._index_mod.stream_scores_int8 = self._b2_inner


class Serving:
    """The set-up, kept for windows of traffic: the engine holding the
    corpus, its server on a free port and the batcher's warm-up done."""

    def __init__(self, torch, cell: common.Cell):
        from image_search_tpu_torch.server import app

        common.quiet_program_logs()
        self.torch, self.cell = torch, cell
        media, index_dir = os.path.join(cell.tmp, "media"), os.path.join(cell.tmp, "index")
        os.makedirs(media)
        self.cpus = sorted(os.sched_getaffinity(0))
        self.engine, self.args = common.build_engine(torch, cell, media, index_dir)
        self.load_s = load_corpus(torch, self.engine, cell.mix["corpus"], cell.seed, cell.device)
        self.srv = app.make_server(self.engine, "127.0.0.1", 0, batch_window_ms=self.args.batch_window_ms)
        self.serve = threading.Thread(target=self.srv.serve_forever, name="bench-http", daemon=True)
        self.serve.start()
        common.join_threads("serving-warmup")

    def window(self, load, seconds: float, trace: bool, tag: str = "load") -> dict:
        """One run of ``load`` (``load_of``'s: its warm-up phase, then the
        window of ``seconds``) -> the answers, counter snapshots at the
        window's ends, the trace summary and spans, this process's CPU
        seconds in the window, and the set-up's end."""
        from image_search_tpu_torch.utils.metrics import global_metrics

        torch, tmp = self.torch, self.cell.tmp
        spec_path, out_path = os.path.join(tmp, f"{tag}.json"), os.path.join(tmp, f"{tag}.answers.json")
        harness_spans = _Spans(torch, self.engine) if trace else None
        tracer = Tracer(torch, trace)
        t = time.perf_counter()
        tracer.start()  # before the load is scheduled: starting the profiler can take seconds
        if trace:
            print(f"search: the profiler took {time.perf_counter() - t} s to start", file=sys.stderr)
        t0 = time.monotonic() + 1.0 + load.lead_s()
        with open(spec_path, "w") as f:
            json.dump({"port": self.srv.server_port, "t0": t0, "seconds": seconds, "k": self.args.k} | load.spec(), f)
        loadgen = subprocess.Popen([sys.executable, os.path.join(harness.HERE, load.script), spec_path, out_path])
        self._pin(loadgen.pid)
        try:
            time.sleep(max(0.0, t0 - time.monotonic()))
            setup_end = time.perf_counter()
            before, cpu0 = global_metrics.snapshot(), cpu_s()
            if harness_spans:
                harness_spans.on = True
            with tracer.window():
                time.sleep(max(0.0, t0 + seconds - time.monotonic()))
            cpu1 = cpu_s()
            if harness_spans:
                harness_spans.on = False
            loadgen.wait(timeout=seconds + 120)
            after = global_metrics.snapshot()
            tracer.stop()
        finally:
            if loadgen.poll() is None:
                loadgen.kill()
                loadgen.wait()
            if harness_spans:
                harness_spans.restore()
        with open(out_path) as f:
            answers = json.load(f)
        return {"answers": answers, "before": before, "after": after, "summary": tracer.summary(),
                "spans": span_record(tracer), "calls": harness_spans.calls if harness_spans else [],
                "b2": harness_spans.b2 if harness_spans else [], "cpu_s": cpu1 - cpu0, "setup_end": setup_end}

    def _pin(self, pid: int) -> None:
        """The load generator on the last CPU, every thread of this process
        (server, batcher, engine) on the others: the two never take each
        other's core."""
        if len(self.cpus) < 2:
            return
        os.sched_setaffinity(pid, self.cpus[-1:])
        for tid in os.listdir("/proc/self/task"):
            try:
                os.sched_setaffinity(int(tid), self.cpus[:-1])
            except OSError:  # a thread that has ended
                pass

    def close(self) -> None:
        self.srv.shutdown()
        self.srv.server_close()
        self.serve.join(30)
        del self.engine, self.srv
        common.free(self.torch, self.cell.device)


class OpenLoad:
    """Open loop: every request due at a time fixed before the run (the
    kind's ``schedule``), sent then by the kind's load generator whatever
    the earlier ones are doing; ``searches_per_s``."""

    metric = "searches_per_s"

    def __init__(self, requests: list, keep: list, script: str):
        self.requests, self.keep, self.script = requests, keep, script

    def spec(self) -> dict:
        return {"requests": self.requests, "keep": self.keep}

    def lead_s(self) -> float:
        """Seconds of traffic before the window: its warm-up phase."""
        return -min(0.0, min(r["at"] for r in self.requests))

    def seen(self, answers: dict, seconds: float, server_cpu_s: float) -> dict:
        """What the client saw: the requests sent and the sampled ones, the
        rate, ms a request from due to answered (inf when failed) and from
        due to sent, and the requests attempted and failed."""
        lat, late = latencies(self.requests, answers["rows"])
        return {"reqs": self.requests, "keep": self.keep, "per_s": rate(self.requests, answers["rows"]), "lat": lat,
                "late": late, "attempted": len(lat), "failed": sum(1 for x in lat if math.isinf(x)), "note": None}


class ClosedLoad:
    """Closed loop (``gen_sessions``): the mix's sessions each send their
    next request the moment the last is answered (``loadgen_closed.py``);
    ``saturated_searches_per_s``. Every request sent is attempted, and one
    never answered has failed."""

    metric = "saturated_searches_per_s"
    script = "loadgen_closed.py"

    def __init__(self, mix: dict, seed: int):
        self.mix, self.seed = mix, seed

    def spec(self) -> dict:
        return {"mix": self.mix, "seed": self.seed, "keep": gen_sessions.check_caps(self.mix)}

    def lead_s(self) -> float:
        return float(self.mix["warmup_s"])

    def seen(self, answers: dict, seconds: float, server_cpu_s: float) -> dict:
        rows, client = answers["rows"], answers["client"]
        lat = [(r[2] - r[0]) * 1e3 for r in rows if r and r[3] == 200 and 0 <= r[2] < seconds]
        note = (f"load generator: {client['cpu_s']} CPU s in the {client['seconds']} s window, event-loop lag "
                f"p50 {client['lag_ms']['p50']} ms, p99 {client['lag_ms']['p99']} ms, max {client['lag_ms']['max']} "
                f"ms over {client['ticks']} ticks; server process {server_cpu_s} CPU s")
        return {"reqs": answers["requests"], "keep": sorted(int(i) for i in answers["kept"]),
                "per_s": saturated_rate(rows, seconds), "lat": lat, "late": [], "attempted": len(rows),
                "failed": sum(1 for r in rows if not r or r[3] != 200), "note": note}


OPEN = {"search": (gen_search, "loadgen.py"), "search_image": (gen_photo_query, "loadgen_photo.py")}


def load_of(mix: dict, seed: int, seconds: float):
    """The load a traffic mix asks for: a closed loop where it names
    ``sessions``, else the open loop of its kind."""
    if mix.get("sessions"):
        return ClosedLoad(mix, seed)
    maker, script = OPEN[mix["kind"]]
    reqs = maker.schedule(mix, seed, seconds)
    return OpenLoad(reqs, maker.check_sample(reqs, seed, mix["check_requests"]), script)


def span_record(tracer):
    """The program's spans over a traced window (``bench_port/spans.py``),
    or None."""
    if tracer.prof is None or tracer.bounds is None:
        return None
    record = spans.record(tracer.prof.profiler.kineto_results.events(), *tracer.bounds)
    print(spans.describe(record), file=sys.stderr)
    return record


def cpu_s() -> float:
    """This process's CPU seconds so far, user and system, every thread."""
    t = os.times()
    return t.user + t.system


def saturated_rate(rows: list, seconds: float) -> float:
    """Closed loop: answers with status 200 that arrived inside the window,
    over its seconds; those in flight at its close do not count."""
    return sum(1 for r in rows if r and r[3] == 200 and 0 <= r[2] < seconds) / seconds


def rate(reqs: list, rows: list) -> float:
    """Searches a second over the window: every request due in it that was
    answered, over the time from the window's start to the last of their
    answers (so a backlog that outlasts the window counts its time)."""
    ends = [rows[i][2] for i, r in enumerate(reqs) if r["window"] and rows[i] and rows[i][3] == 200]
    return len(ends) / max(ends) if ends else 0.0


def latencies(reqs: list, rows: list):
    """Window requests' ms from due to answered (inf when failed), and their
    ms from due to sent (the generator's lateness)."""
    window = [(i, r) for i, r in enumerate(reqs) if r["window"]]
    lat = [(rows[i][2] - r["at"]) * 1e3 if rows[i] and rows[i][3] == 200 else math.inf for i, r in window]
    late = [(rows[i][1] - r["at"]) * 1e3 for i, r in window if rows[i]]
    return lat, late


def run(cell: common.Cell) -> harness.Result:
    import torch

    mix, device = cell.mix, cell.device
    serving = Serving(torch, cell)
    load = load_of(mix, cell.seed, cell.seconds)
    out = serving.window(load, cell.seconds, cell.trace)
    setup_s = out["setup_end"] - cell.start
    summary = out["summary"]
    peak = common.peak_bytes(torch, device)
    k, load_s = serving.args.k, serving.load_s
    serving.close()
    seen = load.seen(out["answers"], cell.seconds, out["cpu_s"])
    reqs, keep, lat, late, failed = seen["reqs"], seen["keep"], seen["lat"], seen["late"], seen["failed"]
    half = len(lat) // 2
    p50, p95 = (_quantile(lat, 0.5), _quantile(lat, 0.95)) if lat else (None, None)
    print(f"search: {seen['per_s']} searches/s ({load.metric}); from the due time p50 {p50} ms, p95 {p95} ms",
          file=sys.stderr)
    print(f"search: p95 of the window's first half {_quantile(lat[:half], 0.95) if half else 0.0} ms, of its second "
          f"{_quantile(lat[half:], 0.95) if lat else 0.0} ms", file=sys.stderr)
    print(f"search: {seen['attempted']} requests attempted, {failed} failed; generator lateness p50 "
          f"{statistics.median(late) if late else 0.0} ms, p95 {_quantile(late, 0.95) if late else 0.0} ms; "
          f"corpus load {load_s} s of set-up {setup_s} s", file=sys.stderr)
    if seen["note"]:
        print(f"search: {seen['note']}", file=sys.stderr)
    checks, correct = _check(torch, cell, reqs, keep, out["answers"], k)
    context = {
        "before": out["before"], "after": out["after"], "trace": summary, "seconds": cell.seconds,
        "spans": out["spans"], "calls": out["calls"], "b2_calls": out["b2"], "model": cell.model,
        "corpus_rows": mix["corpus"]["rows"], "latency_ms": {"p50": p50, "p95": p95},
    }
    return harness.Result(
        end_to_end={load.metric: seen["per_s"], "setup_s": setup_s},
        context=context, correct=correct and failed == 0, checks=checks, attempted=seen["attempted"], failed=failed,
        device=harness.device_record(torch, device, 1, peak) | (
            {"busy_s": summary["busy_s"], "window_s": summary["window_s"]} if summary else {}),
        breakdown=summary["breakdown"] if summary else None,
    )


def _served(body: str):
    return [(gen_corpus.row_of(d["image_path"]), float(d["score"])) for d in json.loads(body)["images"]]


def _requests(reqs, keep, answers):
    """The sampled requests as the reference takes them, and the served
    answers; a sampled request never answered is listed apart."""
    kept = answers["kept"]
    missing = [i for i in keep if kept[str(i)]["body"] is None]
    got = [i for i in keep if kept[str(i)]["body"] is not None]
    served = [_served(kept[str(i)]["body"]) for i in got]
    requests = [{"q": reqs[i]["q"], "refs": [gen_corpus.row_of(p) for p in kept[str(i)]["refs"]]} for i in got]
    return requests, served, missing


def _state(torch, cell: common.Cell):
    return weights.make(cell.model, cell.seed, cell.device,
                        torch.bfloat16 if torch.device(cell.device).type == "cuda" else torch.float32)


def _check(torch, cell: common.Cell, reqs, keep, answers, k: int, extra=None):
    """The sampled answers against the plain reference -> (checks, correct);
    with ``extra`` (more answers to the same requests) also their numbers."""
    requests, served, missing = _requests(reqs, keep, answers)
    look_up = [[r for r, _ in s] for s in served]
    if extra is not None:
        look_up = [a + [r for r, _ in b] for a, b in zip(look_up, extra)]
    ids, scores, found = ref_search.answers(cell.model, _state(torch, cell), cell.mix["corpus"], cell.seed,
                                            requests, k, cell.device, look_up=look_up)
    limits = cell.mix["limits"]

    def numbers(ans, unanswered):
        nums = ref_search.compare(ans, ids, scores, found, k)
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
    reference in fp8 and int4 (``reference/search.py``) answering the same
    sampled requests, with the same marks -> both sets of numbers."""
    import torch

    serving = Serving(torch, cell)
    load = load_of(cell.mix, cell.seed, cell.seconds)
    out = serving.window(load, cell.seconds, False)
    k = serving.args.k
    serving.close()
    seen = load.seen(out["answers"], cell.seconds, out["cpu_s"])
    reqs, keep = seen["reqs"], seen["keep"]
    requests, served, _ = _requests(reqs, keep, out["answers"])
    c_ids, c_scores, _ = ref_search.answers(cell.model, _state(torch, cell), cell.mix["corpus"], cell.seed,
                                            requests, k, cell.device, lowp=True)
    ctrl = [list(zip(i.tolist(), v.tolist())) for i, v in zip(c_ids, c_scores)]
    checks, correct, ctrl_checks = _check(torch, cell, reqs, keep, out["answers"], k, extra=ctrl)
    return {"program": checks, "program_correct": correct, "control": ctrl_checks,
            "control_correct": all(c["value"] <= c["limit"] for c in ctrl_checks.values())}
