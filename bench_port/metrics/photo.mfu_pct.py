"""The query-by-photo step's share of the card's peak: for every request in
the window, the least time the card could take for its device work (the
vision tower's operations at the bf16 peak, ``flops.vision_ops``: every
layer but the last over all tokens, the last at the CLS row; then every
int8 row and its scale read once at the HBM rate, ``flops.b2_bound_s``),
summed, over the seconds in which at least one request was inside its
``image_embed`` or ``index_search`` span (the union of their intervals:
requests that overlap on the handler threads count their shared time
once). Moves searches_per_s."""

from bench_port import flops
from bench_port.spans import union_s


def read(ctx):
    rec, m = ctx.get("spans"), ctx["model"]
    n = rec["count"].get("image_embed", 0) if rec else 0
    wall = union_s(rec, ("image_embed", "index_search")) if rec else 0.0
    if n <= 0 or wall <= 0:
        return None
    least = flops.vision_ops(m) / flops.BF16_FLOP_PER_S + flops.b2_bound_s(1, ctx["corpus_rows"], m["projection_dim"])
    return 100.0 * n * least / wall
