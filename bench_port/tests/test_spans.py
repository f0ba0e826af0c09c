"""The program's spans read from profiler events (``bench_port/spans.py``)
and the search path's readers that take them, on synthetic events: host
time per span, device time through the events' correlation ids, the
device-idle time no span covers, and the longest idle gaps."""

import pytest
from torch.autograd import DeviceType

from bench_port import harness, spans

MS = 1_000_000  # ns


class Ev:
    """The part of a profiler event that ``spans.record`` reads."""

    def __init__(self, name, kind, start, end, thread=0, corr=0, linked=0):
        self._name, self._kind, self._s, self._e = name, kind, start * MS, end * MS
        self._thread, self._corr, self._linked = thread, corr, linked

    def name(self):
        return self._name

    def device_type(self):
        return DeviceType.CPU if self._kind in ("cpu_op", "user_annotation", "cuda_runtime") else DeviceType.CUDA

    def is_user_annotation(self):
        return self._kind in ("user_annotation", "gpu_user_annotation")

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def start_thread_id(self):
        return self._thread

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked


def span(name, s, e, thread, corr):
    return Ev(name, "user_annotation", s, e, thread, corr)


def op(s, e, thread, corr, name="aten::op"):
    return Ev(name, "cpu_op", s, e, thread, corr)


def kernel(s, e, linked, name="kernel"):
    return Ev(name, "kernel", s, e, linked=linked)


# the window is [0, 1000) ms; the batcher on thread 2, another scan on thread
# 3, the handler on thread 4
EVENTS = [
    span("search.topk", -100, -50, 2, 14), op(-90, -80, 2, 15),  # before the window
    span("engine.search_many", 55, 765, 2, 12),  # the harness's own range
    span("batcher.collect", 10, 50, 2, 1),
    span("search.text_tower", 60, 200, 2, 2), op(70, 80, 2, 3, "aten::mm"),
    op(202, 205, 2, 13, "aten::stack"),  # under the harness's range only
    span("index_search", 210, 700, 2, 4),
    span("search.scan", 220, 300, 2, 5),
    span("search.topk", 300, 400, 2, 6), op(310, 320, 2, 7, "aten::sort"),
    span("search.to_host", 400, 650, 2, 8), op(410, 640, 2, 9, "aten::copy_"),
    op(655, 660, 2, 30, "aten::cat"),  # in index_search, after search.to_host
    span("search.format", 700, 760, 2, 10),
    span("search.scan", 300, 350, 3, 21), op(305, 306, 3, 22, "aten::empty"),
    span("http.render", 770, 800, 4, 11),
    Ev("cudaLaunchKernel", "cuda_runtime", 311, 312, 99, corr=9, linked=7),  # a runtime call, its id an op's
    Ev("Lazy Function Loading", "cuda_runtime", 900, 901, 1, corr=7),  # the profiler's own, an op's id
    kernel(-40, 20, 15), kernel(85, 180, 3), kernel(240, 420, 0, "score_int8_kernel"),  # B2: no op, no link
    kernel(420, 500, 7, "sort"), Ev("Memcpy DtoH", "gpu_memcpy", 500, 520, linked=9), kernel(520, 530, 13),
    kernel(660, 670, 30),
    # the device-side ranges: each spans the kernels launched while its host range was innermost
    Ev("search.scan", "gpu_user_annotation", 240, 420, corr=5), Ev("index_search", "gpu_user_annotation", 240, 670, corr=4),
    Ev("engine.search_many", "gpu_user_annotation", 85, 670, corr=12), Ev("search.topk", "gpu_user_annotation", 420, 500, corr=6),
]


@pytest.fixture(scope="module")
def rec():
    return spans.record(EVENTS, 0, 1000 * MS)


def test_host_time_and_count_of_spans_that_start_in_the_window(rec):
    assert rec["count"] == {"batcher.collect": 1, "search.text_tower": 1, "index_search": 1, "search.scan": 2,
                            "search.topk": 1, "search.to_host": 1, "search.format": 1, "http.render": 1}
    assert rec["host_s"]["search.scan"] == pytest.approx(0.130)
    assert rec["host_s"]["search.topk"] == pytest.approx(0.100)
    assert "engine.search_many" not in rec["host_s"]


def test_overlapping_spans_count_their_shared_time_once(rec):
    """search.scan on threads 2 and 3 and search.topk abut and overlap;
    the span before the window is not among them."""
    assert rec["intervals"]["search.scan"] == [[220 * MS, 300 * MS], [300 * MS, 350 * MS]]
    assert spans.union_s(rec, ["search.scan"]) == pytest.approx(0.130)
    assert spans.union_s(rec, ["search.scan", "search.topk"]) == pytest.approx(0.180)
    assert spans.union_s(rec, ["absent"]) == 0.0


def test_a_kernel_belongs_to_the_span_that_launched_it(rec):
    """The sort launched inside search.topk on thread 2 runs while thread 3
    holds a search.scan span: it counts under search.topk only. B2, linked
    to no op, counts in the innermost device-side range that holds it,
    search.scan's; the cat after search.to_host counts in the enclosing
    index_search. A runtime call or a profiler event that repeats an op's
    correlation id changes nothing."""
    assert rec["device_s"] == pytest.approx({"search.text_tower": 0.095, "search.scan": 0.180, "search.topk": 0.080,
                                             "search.to_host": 0.020, "index_search": 0.010})
    # the stack under the harness's range alone; the kernel of the span before the window counts nowhere
    assert rec["device_unspanned_s"] == pytest.approx(0.010)


def test_idle_time_with_no_span_open_and_the_longest_gaps(rec):
    assert rec["idle_s"] == pytest.approx(0.585)
    assert rec["idle_unspanned_s"] == pytest.approx(0.230)
    assert [(g["start_ns"] // MS, g["end_ns"] // MS, g["open"]) for g in rec["gaps"]] == [
        (20, 85, []), (180, 240, ["index_search"]), (530, 660, ["search.to_host"]), (670, 1000, [])]
    assert spans.describe(rec).startswith("spans: 39.316")


def test_readers_of_the_record(rec):
    ctx = {"spans": rec}
    got = {name: harness.reader(name)(ctx) for name in ("search.launch_ms", "search.sync_ms", "search.format_ms",
                                                        "search.tower_device_ms", "search.topk_device_ms")}
    assert got == pytest.approx({"search.launch_ms": 370.0, "search.sync_ms": 250.0, "search.format_ms": 90.0,
                                 "search.tower_device_ms": 95.0, "search.topk_device_ms": 80.0})


@pytest.mark.parametrize("name", ["search.launch_ms", "search.sync_ms", "search.format_ms",
                                  "search.tower_device_ms", "search.topk_device_ms", "search.queue_wait_ms"])
def test_readers_return_nothing_where_the_program_has_no_spans_or_counters(name):
    """The parent program: no record, no queue counters, no batch."""
    empty = {"before": {"counters": {}}, "after": {"counters": {"searches": 5}}}
    assert harness.reader(name)(empty) is None
    assert harness.reader(name)(dict(empty, spans=spans.record([], 0, MS))) is None


def test_queue_wait_reader():
    ctx = {"before": {"counters": {"search_queue_wait_s": 1.0, "search_queue_waits": 10}},
           "after": {"counters": {"search_queue_wait_s": 1.5, "search_queue_waits": 110}}}
    assert harness.reader("search.queue_wait_ms")(ctx) == pytest.approx(5.0)
