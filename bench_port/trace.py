"""The traced run's reader: ``torch.profiler`` over the measured window.

The window is the wall-clock interval (``time.time_ns``, the profiler's
own time base) that the driver marks around the measured window. The
profiler records every thread's host ops (the server's handlers and
batcher run on threads of their own). Device time is every kernel, copy
and fill the profiler saw on the card inside the window (the union of
their intervals is the busy time; idle is the rest). ``kernel_class`` is a
copy of ``chip_smoke.py::_kernel_class`` (its ``_device_split`` summed the
same classes from ``key_averages``; this reads the profiler's raw events,
which a long window makes too many for ``key_averages``).
"""

from __future__ import annotations

import bisect
import contextlib
import sys
import time

_PROFILER_NOISE = ("Activity Buffer Request",)


def kernel_class(name: str) -> str:
    low = name.lower()
    if "attn_fwd" in low:
        return "B1"
    if "attn_bwd" in low:
        return "B5"
    if "score_int8" in low:
        return "B2"
    if any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "GEMM"
    if "multi_tensor" in low or "adam" in low:
        return "optimizer"
    if "layer_norm" in low:
        return "LayerNorm"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "elementwise"


class Tracer:
    """``start`` before the window, ``window()`` around it, ``stop`` after;
    then ``summary()``. A disabled tracer does nothing."""

    def __init__(self, torch, enabled: bool):
        self.torch = torch
        self.enabled = enabled
        self.prof = None
        self.bounds = None

    def start(self) -> None:
        if not self.enabled:
            return
        from torch._C._profiler import _ExperimentalConfig

        acts = [self.torch.profiler.ProfilerActivity.CPU, self.torch.profiler.ProfilerActivity.CUDA]
        self.prof = self.torch.profiler.profile(
            activities=acts, experimental_config=_ExperimentalConfig(profile_all_threads=True))
        self.prof.__enter__()

    @contextlib.contextmanager
    def window(self):
        w0 = time.time_ns()
        try:
            yield
        finally:
            self.bounds = (w0, time.time_ns())

    def stop(self) -> None:
        if self.prof is not None:
            self.prof.__exit__(None, None, None)

    def summary(self) -> dict | None:
        """{busy_s, window_s, by_class {class: s}, by_kernel {name: s},
        breakdown} or None when the profiler recorded no device time."""
        if self.prof is None or self.bounds is None:
            return None
        events = self.prof.profiler.kineto_results.events()
        out = summarize(events, *self.bounds)
        if out is None:
            print(f"trace: no device time in the window ({len(events)} events)", file=sys.stderr)
        return out


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(events, w0: int, w1: int) -> dict | None:
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name not in _PROFILER_NOISE:
                host.append((e.start_ns(), e.end_ns(), name))
        elif not e.is_user_annotation():
            device.append((e.start_ns(), e.end_ns(), name))
    clipped = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    clipped = [(s, e, n) for s, e, n in clipped if e > s]
    if not clipped:
        return None
    busy = _union([(s, e) for s, e, _ in clipped])
    by_kernel, by_class = {}, {}
    for s, e, n in clipped:
        by_kernel[n] = by_kernel.get(n, 0.0) + (e - s) / 1e9
        c = kernel_class(n)
        by_class[c] = by_class.get(c, 0.0) + (e - s) / 1e9
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    gaps = sorted(sorted(gaps, key=lambda g: g[0] - g[1])[:10])
    labels = _host_labels(gaps, host)
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "by_class": by_class,
        "by_kernel": by_kernel,
        "breakdown": {
            "device_ops": [[n, t] for n, t in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": sorted(([lab, (b - a) / 1e9] for (a, b), lab in zip(gaps, labels)), key=lambda x: -x[1]),
        },
    }


def _host_labels(gaps, host) -> list:
    """What the host was doing in each device gap (gaps sorted, disjoint):
    the innermost host op that covers at least half of it, else the one
    that covers most of it."""
    starts = [a for a, _ in gaps]
    best = [None] * len(gaps)
    for s, e, n in host:
        j = bisect.bisect_left(starts, e) - 1
        while j >= 0 and gaps[j][1] > s:
            a, b = gaps[j]
            overlap = min(e, b) - max(s, a)
            key = (1, -(e - s)) if 2 * overlap >= b - a else (0, overlap)
            if overlap > 0 and (best[j] is None or key > best[j][0]):
                best[j] = (key, n)
            j -= 1
    return [b[1] if b else "no traced host op" for b in best]
