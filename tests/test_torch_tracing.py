"""The port's spans and the search batcher's queue-wait counters, on the
tiny model's demo engine on the CPU.

``utils.metrics.span`` opens a ``torch.profiler.record_function`` range only
while a profiler session runs; otherwise it hands back one shared no-op. A
batched ``/search`` under a CPU profiler that records every thread leaves
each span of the search path once, on its own thread, in the path's order
and nesting; without a profiler it opens none, and the answer is the same
bytes either way.
"""

import json
import os
import threading
import time
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image
from torch._C._profiler import _ExperimentalConfig

from image_search_tpu_torch.server.app import SearchBatcher, make_server
from image_search_tpu_torch.server.engine import SearchEngine, ServerArgs
from image_search_tpu_torch.utils.metrics import global_metrics, span

BATCHER_SPANS = ["batcher.collect", "search.resolve", "search.text_tower", "search.rocchio", "search.scan",
                 "search.topk", "search.to_host", "search.format"]
INSIDE_INDEX_SEARCH = ["search.rocchio", "search.scan", "search.topk", "search.to_host"]


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """The tiny model's demo engine (seeded random weights) over 6 photos,
    int8 rows, behind the batcher, its warm-up done."""
    root = tmp_path_factory.mktemp("torch_tracing")
    media = str(root / "pics")
    os.makedirs(media)
    rng = np.random.default_rng(5)
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, (28, 28 + 3 * i, 3), dtype=np.uint8)).save(f"{media}/{i}.png")
    args = ServerArgs(model="clip-tiny-test", model_weights=str(root / "absent.safetensors"), media_dir=media,
                      index_dir=str(root / "idx"), k=4, index_quantize="int8")
    engine = SearchEngine(args, device="cpu")
    assert engine.scan().embedded == 6
    srv = make_server(engine, batch_window_ms=5.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    for t in threading.enumerate():
        if t.name.startswith("serving-warmup"):
            t.join(timeout=120)
    yield engine, f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(base, body):
    req = urllib.request.Request(base + "/search", data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def _profiled(fn):
    """fn() under a CPU profiler that records every thread -> (its value,
    the user annotations as (name, thread, start_ns, end_ns))."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                  experimental_config=_ExperimentalConfig(profile_all_threads=True))
    with prof:
        out = fn()
    ranges = [(e.name(), e.start_thread_id(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    return out, ranges


def test_span_without_a_profiler_opens_no_range(server, monkeypatch):
    """No profiler: every span is the one shared no-op, record_function is
    never called, and a batched /search answers the direct path's bytes,
    as it does with the spans recorded."""
    engine, base = server
    opened = []
    inner = torch.autograd.profiler.record_function
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name, *a: opened.append(name) or inner(name, *a))
    assert not torch.autograd.profiler._is_profiler_enabled
    assert span("a") is span("b")
    marked = [engine.search("a probe")[1]["image_path"]]
    status, body = _post(base, {"q": "spans off", "referenced_images": marked})
    assert status == 200 and opened == []
    assert body == engine.render_images_json(engine.search("spans off", marked))
    (status_on, body_on), _ = _profiled(lambda: _post(base, {"q": "spans off", "referenced_images": marked}))
    assert status_on == 200 and body_on == body
    assert "search.to_host" in opened and "http.render" in opened


def test_one_batch_records_each_span_once_in_order(server):
    """One /search (a text-cache miss, with a mark) under the profiler: each
    span of the table once; the batcher's on one thread, in the path's
    order, rocchio to to_host inside the index_search timer's span;
    http.render on the handler's thread, after search.format."""
    engine, base = server
    marked = [engine.search("another probe")[0]["image_path"]]
    (status, _), ranges = _profiled(lambda: _post(base, {"q": "a cold query", "referenced_images": marked}))
    assert status == 200
    names = [r[0] for r in ranges]
    for name in BATCHER_SPANS + ["http.render", "index_search"]:
        assert names.count(name) == 1, (name, names)
    at = {r[0]: r for r in ranges}
    batcher_thread = at["batcher.collect"][1]
    assert {at[n][1] for n in BATCHER_SPANS + ["index_search"]} == {batcher_thread}
    assert at["http.render"][1] != batcher_thread
    for a, b in zip(BATCHER_SPANS, BATCHER_SPANS[1:]):
        assert at[a][3] <= at[b][2], (a, b)
    assert at["search.format"][3] <= at["http.render"][2]
    outer = at["index_search"]
    for name in INSIDE_INDEX_SEARCH:
        assert outer[2] <= at[name][2] and at[name][3] <= outer[3], name
    assert not outer[2] <= at["search.format"][2] < outer[3]


class _Held:
    """An engine whose search_many waits for ``release``."""

    def __init__(self):
        self.entered, self.release = threading.Event(), threading.Event()

    def search_many(self, queries, selections):
        self.entered.set()
        assert self.release.wait(timeout=60)
        return [[] for _ in queries]


def _counters():
    c = global_metrics.snapshot()["counters"]
    return c.get("search_queue_wait_s", 0.0), c.get("search_queue_waits", 0.0)


@pytest.mark.parametrize("held_s", [0.15, 0.4])
def test_queue_wait_counts_the_time_the_worker_was_busy(held_s):
    """A request queued while the worker answers another batch waits at
    least as long as the worker is held, and the counters say so."""
    eng = _Held()
    b = SearchBatcher(eng, window_ms=1)
    b.start()
    out = []
    try:
        first = threading.Thread(target=lambda: out.append(b.submit("first")))
        first.start()
        assert eng.entered.wait(timeout=30)
        wait0, n0 = _counters()
        second = threading.Thread(target=lambda: out.append(b.submit("second")))
        second.start()
        deadline = time.monotonic() + 30
        while b._queue.qsize() < 1 and time.monotonic() < deadline:  # queued before the clock starts
            time.sleep(0.001)
        time.sleep(held_s)
        eng.release.set()
        for t in (first, second):
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        b.stop()
    wait1, n1 = _counters()
    assert out == [[], []]
    assert n1 - n0 == 1 and wait1 - wait0 >= held_s


def test_text_embed_timer_is_gone_and_metrics_keep_their_keys(server):
    """A cold /search through the batcher: GET /metrics has its five keys,
    no text_embed timer, the index_search timer and the queue counters."""
    engine, base = server
    wait0, n0 = _counters()
    assert _post(base, {"q": "a query never seen", "referenced_images": []})[0] == 200
    with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
        snap = json.loads(r.read())
    assert set(snap) == {"uptime_sec", "counters", "gauges", "latencies", "model"}
    assert "text_embed" not in snap["latencies"] and "index_search" in snap["latencies"]
    assert snap["counters"]["search_queue_waits"] >= n0 + 1
    assert snap["counters"]["search_queue_wait_s"] >= wait0


IMAGE_SPANS = ["image.decode", "image_embed", "image.preprocess", "index_search"]


def _post_image(base, data, refs=()):
    query = urllib.parse.urlencode([("k", 4)] + [("ref", r) for r in refs])
    req = urllib.request.Request(base + "/search_image?" + query, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def test_one_image_query_records_its_spans(server):
    """One /search_image with a mark under the profiler: the upload's decode,
    the tower's launch (the image_embed timer) with the preprocess inside it,
    and the index search, each once on the handler's thread, in that order;
    the image_searches counter moves by one, and the answer is the bytes of
    the same request with no profiler."""
    engine, base = server
    with open(sorted(engine.index.paths)[2], "rb") as f:
        data = f.read()
    marked = [engine.search("an image probe")[1]["image_path"]]
    plain = _post_image(base, data, marked)
    before = global_metrics.snapshot()["counters"].get("image_searches", 0.0)
    (status, body), ranges = _profiled(lambda: _post_image(base, data, marked))
    assert status == 200 and (status, body) == plain
    assert global_metrics.snapshot()["counters"]["image_searches"] == before + 1
    names = [r[0] for r in ranges]
    for name in IMAGE_SPANS:
        assert names.count(name) == 1, (name, names)
    at = {r[0]: r for r in ranges}
    assert len({at[n][1] for n in IMAGE_SPANS}) == 1
    assert at["image.decode"][3] <= at["image_embed"][2] and at["image_embed"][3] <= at["index_search"][2]
    assert at["image_embed"][2] <= at["image.preprocess"][2] and at["image.preprocess"][3] <= at["image_embed"][3]
