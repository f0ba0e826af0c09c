"""The whole search step's share of the card's roofline: for every
``engine.search_many`` call in the window, the least time the card could
take for it (the text tower at the bf16 peak for the batch's texts that
missed the cache, over their tokens up to EOS, its weights read once; then
every int8 row and its scale read once at the HBM rate), summed, over the
calls' host wall times summed. Moves searches_per_s."""

from bench_port import flops


def _tokens(text: str, context: int) -> int:
    return min(len(text.split()), context - 2) + 2


def read(ctx):
    calls, m = ctx.get("calls"), ctx["model"]
    if not calls:
        return None
    rows, dim = ctx["corpus_rows"], m["projection_dim"]
    least = wall = 0.0
    for c in calls:
        distinct = list(dict.fromkeys(c["queries"]))
        misses = max(0, len(distinct) - int(c["hits"]))
        if misses:
            ops = misses * sum(flops.text_ops(m, _tokens(q, m["text"]["context_length"])) for q in distinct) / len(distinct)
            least += flops.bound_s(flops.tower_weight_bytes(m["text"]), ops)
        b = len(c["queries"])
        least += flops.bound_s(flops.index_bytes(rows, dim), 2 * b * rows * dim, flops.INT8_OP_PER_S)
        wall += c["s"]
    return 100.0 * least / wall if wall > 0 else None
