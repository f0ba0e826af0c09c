"""The long-key attention forward's roofline share (B1 past 320 keys, the
vision tower of a 378 px ViT/14): the bounds of its calls in the window
(their B, S, heads and head dim, recorded at the model's attention core,
those past 320 keys) over the device time of its kernels in the trace
(``attn_fwd_long`` in their names). None where the window counted no
launch of it (``long_launches``: a program without the kernel). Moves
searches_per_s."""

from bench_port import flops

MAX_KEYS = 320  # the short kernels' key limit; past it the long-key kernel runs


def read(ctx):
    tr = ctx.get("trace")
    if not ctx.get("long_launches") or not tr:
        return None
    t = sum(s for name, s in tr["by_kernel"].items() if "attn_fwd_long" in name)
    bound = sum(flops.attn_fwd_bound_s(b, s, h, hd, c) for b, s, h, hd, c, _ in ctx.get("attn_calls", [])
                if s > MAX_KEYS)
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t
