"""The program's own spans in a traced run, read from ``torch.profiler``'s
events: each span's host time, and the device time of the kernels launched
inside it.

A program span is a ``record_function`` range that the program opens
(``image_search_tpu_torch.utils.metrics.span``; every timer of its
``Metrics`` is one too): a user annotation on a host thread, other than the
harness's own ranges (``HARNESS_SPANS``). A span counts if it starts inside
the window. A device event (kernel, copy or fill) carries in
``linked_correlation_id`` the correlation id of the host event that launched
it (the op innermost on the launching thread at the launch); it belongs to
the innermost program span open on that op's thread (``start_thread_id``)
when the op starts, and counts where that span counts. A kernel launched
outside every op (B2, through ctypes) carries no link; it belongs to the
innermost program span whose device-side range (the profiler's
``gpu_user_annotation``, with the host range's correlation id) holds it.

``record`` is the whole reading, in plain numbers; the per-layer readers
(``metrics/search.*_ms.py``) take it from their context under ``"spans"``.
"""

from __future__ import annotations

import bisect

from bench_port.trace import _union

HARNESS_SPANS = ("engine.search_many",)  # bench_port/drivers/search.py's own range

# what the search path's metrics sum (a batch is one ``search.to_host``)
LAUNCH = ("search.text_tower", "search.rocchio", "search.scan", "search.topk")
SYNC = ("search.to_host",)
FORMAT = ("search.format", "http.render")
BATCH, SEARCH = "search.to_host", "http.render"


class _Thread:
    """One thread's program spans (nested, as ranges on one thread are),
    for 'the innermost span open at t'."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda x: (x[0], -x[1]))  # (start, end, index), outer first
        self.starts = [s for s, _, _ in self.spans]
        self.parent, stack = [], []
        for j, (s, _, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(j)

    def innermost(self, t: int):
        """The index of the innermost span that holds ``t``, or None."""
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0:
            s, e, i = self.spans[j]
            if e > t:
                return i
            j = self.parent[j]
        return None


def record(events, w0: int, w1: int) -> dict:
    """The window [w0, w1) (ns, the profiler's clock) ->
    ``{"host_s": {span: s}, "count": {span: n}, "intervals": {span: [[start, end], ...]},
    "device_s": {span: s}, "device_unspanned_s": s, "idle_s": s, "idle_unspanned_s": s, "gaps": [...]}``.
    Host and device sums and the host intervals (ns) are over the spans that start in the window;
    ``device_unspanned_s`` is the window's device time that no program span
    launched; ``idle_unspanned_s`` the part of the window's device-idle time
    in which no program span was open on any thread; ``gaps`` the ten
    longest device-idle intervals, each with the innermost program span
    open at its middle on each thread (``open``)."""
    from torch.autograd import DeviceType

    spans, host, device, ranges = [], {}, [], []  # spans: (start, end, name, thread)
    span_of = {}  # a program span's correlation id -> its index
    for e in events:
        if e.device_type() == DeviceType.CPU:
            # ops and ranges only: runtime calls and the profiler's own events
            # number their correlation ids apart, and may repeat an op's
            if e.is_user_annotation() or "::" in e.name():
                host[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
            if e.is_user_annotation() and e.name() not in HARNESS_SPANS:
                span_of[e.correlation_id()] = len(spans)
                spans.append((e.start_ns(), e.end_ns(), e.name(), e.start_thread_id()))
        elif e.is_user_annotation():
            ranges.append((e.start_ns(), e.end_ns(), e.correlation_id()))
        else:
            device.append((e.start_ns(), e.end_ns(), e.linked_correlation_id()))
    threads = {}
    for i, (s, e, _, tid) in enumerate(spans):
        threads.setdefault(tid, []).append((s, e, i))
    threads = {tid: _Thread(v) for tid, v in threads.items()}
    # a kernel launched outside every op (through ctypes) links to none: the
    # profiler's device-side copy of each range, which spans the kernels
    # launched while that range was innermost, names its range instead
    on_device = _Thread([(s, e, span_of[c]) for s, e, c in ranges if c in span_of])
    inside = [w0 <= s < w1 for s, _, _, _ in spans]
    out = {"host_s": {}, "count": {}, "intervals": {}, "device_s": {}, "device_unspanned_s": 0.0}
    for (s, e, name, _), counted in zip(spans, inside):
        if counted:
            out["host_s"][name] = out["host_s"].get(name, 0.0) + (e - s) / 1e9
            out["count"][name] = out["count"].get(name, 0) + 1
            out["intervals"].setdefault(name, []).append([s, e])
    for s, e, corr in device:
        launch = host.get(corr)
        if launch is not None:
            i = threads[launch[0]].innermost(launch[1]) if launch[0] in threads else None
        else:
            i = on_device.innermost((s + e) // 2)
        if i is not None and inside[i]:
            name = spans[i][2]
            out["device_s"][name] = out["device_s"].get(name, 0.0) + (e - s) / 1e9
        elif i is None and e > w0 and s < w1:
            out["device_unspanned_s"] += (min(e, w1) - max(s, w0)) / 1e9
    busy = _union([(max(s, w0), min(e, w1)) for s, e, _ in device if e > w0 and s < w1])
    idle = _complement(busy, w0, w1)
    covered = _union([(max(s, w0), min(e, w1)) for s, e, _, _ in spans if e > w0 and s < w1])
    out["idle_s"] = sum(b - a for a, b in idle) / 1e9
    out["idle_unspanned_s"] = sum(b - a for a, b in _minus(idle, covered)) / 1e9
    out["gaps"] = [
        {"start_ns": a, "end_ns": b, "s": (b - a) / 1e9,
         "open": sorted({spans[i][2] for i in (th.innermost((a + b) // 2) for th in threads.values()) if i is not None})}
        for a, b in sorted(sorted(idle, key=lambda g: g[0] - g[1])[:10])
    ]
    return out


def _complement(intervals, w0: int, w1: int) -> list:
    """[w0, w1) less the sorted, disjoint ``intervals``."""
    out, prev = [], w0
    for s, e in intervals:
        if s > prev:
            out.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        out.append((prev, w1))
    return out


def _minus(a, b) -> list:
    """Sorted, disjoint intervals ``a`` less sorted, disjoint ``b``."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def describe(rec: dict) -> str:
    """The stderr line: the share of device-idle time with no span open."""
    idle = rec["idle_s"]
    share = 100.0 * rec["idle_unspanned_s"] / idle if idle > 0 else 0.0
    return (f"spans: {share} % of the window's device-idle time ({idle} s) had no program span open on any thread; "
            f"{rec['device_unspanned_s']} s of device time launched outside every program span")


def union_s(rec: dict, names) -> float:
    """Seconds in which at least one span of ``names`` that started in the
    window was open, on any thread: overlapping spans count once."""
    return sum(e - s for s, e in _union([iv for name in names for iv in rec["intervals"].get(name, ())])) / 1e9


def per_batch_ms(ctx: dict, names, field: str = "host_s", per: str = BATCH):
    """Milliseconds of ``names`` (host or device) per ``per`` span in the
    window, or None without a record or without one such span."""
    rec = ctx.get("spans")
    n = rec["count"].get(per, 0) if rec else 0
    if n <= 0:
        return None
    return 1e3 * sum(rec[field].get(name, 0.0) for name in names) / n
