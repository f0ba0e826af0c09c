"""Mean ms a search waited in the batcher's queue, from ``submit`` to the
worker taking it into a batch: the window's Δ``search_queue_wait_s`` over
Δ``search_queue_waits`` (the program's counters, ``server/app.py::
SearchBatcher``). Moves searches_per_s."""

from bench_port.readers import delta


def read(ctx):
    n = delta(ctx, "search_queue_waits")
    return 1e3 * delta(ctx, "search_queue_wait_s") / n if n > 0 else None
