"""Searches a batch: the window's ``searches`` over its index passes (the
``index_search`` timer's calls, one a batch). Moves searches_per_s."""

from bench_port.readers import delta, timer_calls


def read(ctx):
    calls = timer_calls(ctx, "index_search")
    return delta(ctx, "searches") / calls if calls > 0 else None
