"""Kernel B1's roofline share (the attention forward, here at the vision
tower's head dim): the bounds of its calls in the window (their B, S, heads
and head dim, recorded at the model's attention core) over the forward
family's device time in the trace. Moves scan_img_per_s."""

from bench_port import flops
from bench_port.readers import kernel_share


def read(ctx):
    bound = sum(flops.attn_fwd_bound_s(b, s, h, hd, c) for b, s, h, hd, c, _ in ctx.get("attn_calls", []))
    return kernel_share(ctx, bound, "B1")
