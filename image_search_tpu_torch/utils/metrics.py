"""Runtime metrics: counters + latency quantiles.

The reference has logging only (SURVEY.md §5 — env_logger, no counters, no
latency tracking). BASELINE.md makes images/sec and p50/p95 query latency
first-class, so the server tracks them natively and exposes ``GET /metrics``.

Thread-safe; quantiles over a bounded reservoir of recent samples.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import Dict


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
        t0 = time.perf_counter()
        try:
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
