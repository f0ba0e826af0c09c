"""Kernel B2's roofline share: the bounds of its calls in the window (their
B, live rows and width, recorded around ``stream_scores_int8``) over its
device time in the trace. Moves searches_per_s."""

from bench_port import flops
from bench_port.readers import kernel_share


def read(ctx):
    bound = sum(flops.b2_bound_s(b, rows, d, pen) for b, rows, d, pen in ctx.get("b2_calls", []))
    return kernel_share(ctx, bound, "B2")
