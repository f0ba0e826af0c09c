"""Runtime metrics of the port: counters, gauges, host timers and spans.

- ``inc(name, value)``: a counter, always on. ``GET /metrics`` serves them,
  and an operator (or a benchmark reading two snapshots) takes their
  differences over an interval: searches, text-cache hits, scans, and the
  search batcher's ``search_queue_wait_s`` / ``search_queue_waits`` (the
  seconds requests waited in the queue before a batch took them, and how
  many were taken), which tell queueing from service time.
- ``gauge(name, value)``: the last value of a state, always on, served by
  ``GET /metrics``: the corpus size, warm-up done, two-stage state, scan
  progress.
- ``timer(name)``: a host-clock timer, always on, of a whole operation
  (``index_search``, ``image_embed``, ``scan``, ...); ``GET /metrics``
  serves its call count and quantiles over a reservoir of recent samples.
  On the card a block that does not wait for the device times only its
  launches. Every timer is also a span of its name.
- ``span(name)``: a range of the host's work, recorded only while a
  ``torch.profiler`` session runs in the process (as a
  ``torch.profiler.record_function``, on the profiler's clock beside the
  card's kernels, so a trace attributes device time and idle gaps to it).
  With no profiler running it costs one check of the profiler's flag.
  Spans are read from a profiler trace, never from ``GET /metrics``.

Thread-safe.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager, nullcontext
from typing import Dict

from torch.autograd import profiler as _profiler

_NO_SPAN = nullcontext()


def span(name: str):
    """A context manager: a ``record_function(name)`` range while a
    ``torch.profiler`` session runs in the process, else a shared no-op
    (no lock, clock read or allocation)."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _NO_SPAN


class _Latency:
    def __init__(self, window: int = 2048):
        self.samples: deque = deque(maxlen=window)
        self.count = 0
        self.total = 0.0

    def record(self, seconds: float) -> None:
        self.samples.append(seconds)
        self.count += 1
        self.total += seconds

    def snapshot(self) -> Dict[str, float]:
        xs = sorted(self.samples)
        if not xs:
            return {"count": 0}
        q = lambda p: xs[min(len(xs) - 1, int(p * len(xs)))]
        return {
            "count": self.count,
            "mean_ms": round(1e3 * self.total / self.count, 3),
            "p50_ms": round(1e3 * q(0.50), 3),
            "p95_ms": round(1e3 * q(0.95), 3),
            "p99_ms": round(1e3 * q(0.99), 3),
        }


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        self._latencies: Dict[str, _Latency] = defaultdict(_Latency)
        self._gauges: Dict[str, float] = {}
        self._start = time.time()

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            self._latencies[name].record(seconds)

    @contextmanager
    def timer(self, name: str):
        """Host seconds of the block into ``name``'s latencies; the block is
        also ``span(name)``."""
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "uptime_sec": round(time.time() - self._start, 1),
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "latencies": {k: v.snapshot() for k, v in self._latencies.items()},
            }


global_metrics = Metrics()
