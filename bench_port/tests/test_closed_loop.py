"""The closed loop of the capacity cells: each session waits for its
previous answer and refines from it, the metric counts only the window's
answers with status 200, the check's sample is the one a choice after the
window would make, the load generator records its own CPU time and lag,
the open-loop files still give the requests they gave, and both kinds of
closed-loop cell are driven end to end on the CPU (the program passes its
check, the control and an altered answer fail it)."""

import asyncio
import hashlib
import json
import random
import time

import pytest
import torch

from bench_port import gen_sessions, harness, loadgen_closed
from bench_port.drivers import search
from bench_port.drivers.common import Cell
from bench_port.tests import tiny
from bench_port.tests.test_photo_query import MIX as PHOTO_MIX

MIX = dict(harness.traffic("search-10m-saturated"), vocabulary=512)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _drive(plans, post, seconds=0.4, warmup=0.1, caps=None):
    spec = {"t0": time.monotonic() + warmup + 0.02, "seconds": seconds, "mix": {"warmup_s": warmup},
            "keep": caps or gen_sessions.check_caps(dict(MIX, check_requests=8)), "k": 50}
    return asyncio.run(loadgen_closed.run(spec, plans, post)), spec


def _tagged(plans):
    """Each session's requests, marked with the session they came from."""
    def tag(s, plan):
        for r in plan:
            yield {**r, "s": s}

    return [tag(s, plan) for s, plan in enumerate(plans)]


def _images(n):
    return json.dumps({"images": [{"image_path": f"{n}/{j}", "score": 1.0 - j / 100} for j in range(50)]}).encode()


def test_a_session_sends_nothing_before_its_previous_answer():
    in_flight, calls = {}, []

    async def post(r, refs):
        assert in_flight.get(r["s"], 0) == 0, "a second request of one session in flight"
        in_flight[r["s"]] = 1
        sent = time.monotonic()
        await asyncio.sleep(random.Random(len(calls)).uniform(0.001, 0.02))
        calls.append((r["s"], sent, time.monotonic()))
        in_flight[r["s"]] = 0
        return 200, _images(len(calls))

    out, _ = _drive(_tagged(gen_sessions.sessions(dict(MIX, sessions=5), 2**31 + 1)), post)
    assert len(calls) == len(out["rows"]) > 5 * 5
    for s in range(5):
        mine = [c for c in calls if c[0] == s]
        assert len(mine) > 5 and all(b[1] >= a[2] for a, b in zip(mine, mine[1:]))


PHOTO_CLOSED = dict(PHOTO_MIX, sessions=3, rate_per_s=None)


@pytest.mark.parametrize("mix", [MIX, PHOTO_CLOSED], ids=["search", "search_image"])
def test_a_refinement_marks_results_of_its_own_sessions_previous_answer(mix):
    calls = []  # (request, refs) in the order they were posted

    async def post(r, refs):
        calls.append((r, refs))
        n = len(calls)
        await asyncio.sleep(0.002 * (1 + r["s"]))  # the sessions interleave
        return 200, _images(n)

    _drive(_tagged(gen_sessions.sessions(dict(mix, sessions=3), 2**31 + 2)), post)
    last = {}  # session -> (the number its previous answer was made for, its request)
    refined = 0
    for n, (r, refs) in enumerate(calls, 1):
        if r["kind"] == "refine":
            prev_n, prev = last[r["s"]]
            assert refs == [f"{prev_n}/{j}" for j in r["ranks"]] and 1 <= len(refs) <= 5
            assert {key: prev[key] for key in ("q", "photo") if key in prev} == \
                {key: r[key] for key in ("q", "photo") if key in r}
            refined += 1
        else:
            assert refs == []
        last[r["s"]] = (n, r)
    assert 0.5 < refined / len(calls) < 0.7


def test_answers_after_the_close_and_failed_answers_are_not_counted():
    rows = [[-1.0, -1.0, -0.5, 200],  # answered in the warm-up
            [0.0, 0.0, 1.0, 200], [1.0, 1.0, 2.0, 500], [2.0, 2.0, 3.9, 200],
            [3.5, 3.5, 4.2, 200],  # in flight at the close
            None]  # never answered
    assert search.saturated_rate(rows, 4.0) == 2 / 4.0
    load = search.load_of(MIX, 2**31 + 5, 4.0)
    client = {"cpu_s": 0.5, "seconds": 4.0, "ticks": 400, "lag_ms": {"p50": 0.1, "p99": 1.0, "max": 2.0}}
    seen = load.seen({"rows": rows, "requests": [{}] * 6, "kept": {}, "client": client}, 4.0, 3.0)
    assert load.metric == "saturated_searches_per_s" and seen["per_s"] == 0.5
    assert (seen["attempted"], seen["failed"]) == (6, 2) and seen["lat"] == [1000.0, pytest.approx(1900.0)]


def test_the_sample_holds_only_the_windows_answers_with_status_200():
    count = [0]

    async def post(r, refs):
        count[0] += 1
        await asyncio.sleep(0.03)
        return (500 if count[0] % 3 == 0 else 200), _images(count[0])

    out, spec = _drive(gen_sessions.sessions(dict(MIX, sessions=4), 2**31 + 3), post, seconds=0.3,
                       caps=gen_sessions.check_caps(dict(MIX, check_requests=64)))
    rows, kept = out["rows"], [int(i) for i in out["kept"]]
    assert kept and any(r[3] == 500 for r in rows) and any(r[2] >= 0.3 for r in rows)
    for i in kept:
        assert rows[i][3] == 200 and 0 <= rows[i][2] < spec["seconds"]
    window = [i for i, r in enumerate(rows) if r[3] == 200 and 0 <= r[2] < spec["seconds"]]
    assert len(kept) == min(64, len(window))  # too few to choose from: every one is kept


def test_the_sample_is_the_choice_made_after_the_window():
    rng = random.Random(5)
    reqs = []
    for i in range(400):
        h = rng.random()
        if rng.random() < 0.4:
            reqs.append([("new", (h,))])
        else:
            reqs.append([("costly", (-rng.randint(1, 5), -rng.randint(5, 60), h)), ("other", (h,))])
    caps = gen_sessions.check_caps(dict(MIX, check_requests=64))
    sample = loadgen_closed._Sample(caps)
    for i, pick in enumerate(reqs):
        sample.offer(i, pick, i)
    new = sorted((p[0][1], i) for i, p in enumerate(reqs) if p[0][0] == "new")[: caps["new"]]
    costly = sorted((p[0][1], i) for i, p in enumerate(reqs) if p[0][0] == "costly")[: caps["costly"]]
    held = {i for _, i in costly}
    other = sorted((p[1][1], i) for i, p in enumerate(reqs) if p[0][0] == "costly" and i not in held)[: caps["other"]]
    want = {i for _, i in new + costly + other}
    assert set(sample.kept()) == want and len(want) == 64
    assert all(sample.kept()[i] == i for i in want)


@pytest.mark.parametrize("mix", [MIX, PHOTO_CLOSED], ids=["search", "search_image"])
def test_sessions_are_a_function_of_the_seed_and_every_block_asks_the_same_work(mix):
    def first(seed, n=3 * gen_sessions.BLOCK):
        return [[next(p) for _ in range(n)] for p in gen_sessions.sessions(dict(mix, sessions=4), seed)]

    a = first(2**31 + 9)
    assert a == first(2**31 + 9) and a != first(2**31 + 10)
    for plan in a + first(2**31 + 10):
        assert plan[0]["kind"] == "new"
        for b in range(0, len(plan), gen_sessions.BLOCK):
            block = plan[b: b + gen_sessions.BLOCK]
            assert sum(r["kind"] == "new" for r in block) == round(mix["new_share"] * gen_sessions.BLOCK)
            marks = sorted(len(r["ranks"]) for r in block if r["kind"] == "refine")
            assert all(mix["marks"][0] <= m <= mix["marks"][1] for m in marks)
            assert all(0 <= j < mix["mark_from_top"] for r in block for j in r["ranks"])


def test_photo_sessions_share_the_pool_evenly():
    mix = dict(PHOTO_MIX, pool=16, sessions=4, rate_per_s=None)
    firsts = [[r["photo"] for r in (next(p) for _ in range(40)) if r["kind"] == "new"][:4]
              for p in gen_sessions.sessions(mix, 2**31 + 4)]
    assert sorted(x for f in firsts for x in f) == list(range(16))


@pytest.mark.parametrize("name,script,digest", [
    ("search-10m", "loadgen.py", "9a792be034372e084ff41cda74efaaa5d0bb89745136872d5796d233459eba6c"),
    ("photo-query-2m", "loadgen_photo.py", "f05949ed7f70590288f99ebd86d71a9d88127dbbfabab0b0eaf6e6d8507bf342"),
])
def test_open_loop_files_yield_the_requests_they_gave_before(name, script, digest):
    """The schedule and check sample of each open-loop file, for one seed,
    hashed as the tree before the closed loop made them, for the load
    generator they had."""
    load = search.load_of(harness.traffic(name), 2**31 + 1234, 40)
    assert isinstance(load, search.OpenLoad) and load.script == script
    assert hashlib.sha256(json.dumps([load.requests, load.keep]).encode()).hexdigest() == digest


def test_the_load_generator_records_its_own_cpu_time_and_lag():
    async def post(r, refs):
        t = time.process_time()
        while time.process_time() - t < 0.015:  # the client's own work, on its one thread
            pass
        await asyncio.sleep(0.005)
        return 200, _images(1)

    out, spec = _drive(gen_sessions.sessions(dict(MIX, sessions=2), 2**31 + 7), post, seconds=0.5)
    client = out["client"]
    assert client["seconds"] == spec["seconds"] and 0.25 < client["cpu_s"] < 1.0
    lag = client["lag_ms"]
    assert client["ticks"] > 5 and 0.0 <= lag["p50"] <= lag["p99"] <= lag["max"] and lag["max"] >= 10.0


def _cell(tmp_path, kind, seconds=2.0, seed=2**31 + 31):
    mix = dict(tiny.SEARCH_MIX if kind == "search" else PHOTO_MIX, rate_per_s=None, sessions=4, think_s=[0.0, 0.0])
    return Cell(f"tiny-{kind}-saturated", tiny.config(), mix, seed, seconds, False, torch.device("cpu"), str(tmp_path),
                time.perf_counter())


@pytest.mark.parametrize("kind", ["search", "search_image"])
def test_closed_loop_program_is_correct_and_the_control_is_not(tmp_path, kind):
    out = harness.driver(kind).control(_cell(tmp_path, kind))
    assert out["program_correct"], out["program"]
    assert not out["control_correct"], out["control"]


@pytest.mark.parametrize("kind", ["search", "search_image"])
def test_closed_loop_answer_altered_where_produced(tmp_path, monkeypatch, kind):
    from image_search_tpu_torch.index import index as index_mod

    topk = index_mod.exact_topk

    def shifted(scores, k):
        v, i = topk(scores, k)
        return v, (i + 1) % scores.shape[1]  # every answer names its neighbour's row

    monkeypatch.setattr(index_mod, "exact_topk", shifted)
    res = harness.driver(kind).run(_cell(tmp_path, kind))
    assert not res.correct, res.checks
    assert res.failed == 0 and "saturated_searches_per_s" in res.end_to_end


@pytest.mark.parametrize("mix,sibling,sessions", [("search-10m-saturated", "search-10m", 32),
                                                  ("photo-query-2m-saturated", "photo-query-2m", 16)])
def test_the_capacity_mixes_are_their_siblings_in_a_closed_loop(mix, sibling, sessions):
    """Corpus, pool, words, marks, sample and limits as the open-loop
    sibling's; 32 sessions, the batcher's largest batch."""
    from image_search_tpu_torch.server.app import SearchBatcher
    import inspect

    got, want = harness.traffic(mix), harness.traffic(sibling)
    assert isinstance(search.load_of(got, 2**31 + 6, 40), search.ClosedLoad)
    assert got["sessions"] == sessions and got["think_s"] == [0.0, 0.0]
    assert {k: v for k, v in got.items() if k not in ("why", "rate_per_s", "sessions", "think_s")} == \
        {k: v for k, v in want.items() if k not in ("why", "rate_per_s", "think_s")}
    assert inspect.signature(SearchBatcher).parameters["max_batch"].default == 32
