"""Shared by the per-layer readers (``metrics/<name>.py``): deltas of the
program's ``GET /metrics`` counters over the window (``ctx["before"]`` and ``ctx["after"]`` are its snapshots)."""


def delta(ctx: dict, name: str) -> float:
    return ctx["after"]["counters"].get(name, 0.0) - ctx["before"]["counters"].get(name, 0.0)


def timer_calls(ctx: dict, name: str) -> float:
    """Calls of one of the program's timers (its ``count``, which is not a
    reservoir) over the window."""
    count = lambda snap: snap["latencies"].get(name, {}).get("count", 0)
    return count(ctx["after"]) - count(ctx["before"])


def idle_pct(ctx: dict):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def kernel_share(ctx: dict, bound_s: float, klass: str):
    """A kernel's roofline share: its bound over its device time."""
    tr = ctx.get("trace")
    t = tr["by_class"].get(klass, 0.0) if tr else 0.0
    if t <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / t
