"""Kernel B5's roofline share (the attention backward): the bounds of the
backward of every attention core that ran with a gradient in the window,
over B5's device time in the trace. Moves finetune_pairs_per_s."""

from bench_port import flops
from bench_port.readers import kernel_share


def read(ctx):
    bound = sum(flops.attn_bwd_bound_s(b, s, h, hd, c) for b, s, h, hd, c, grad in ctx.get("attn_calls", []) if grad)
    return kernel_share(ctx, bound, "B5")
