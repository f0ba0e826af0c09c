"""95th percentile (nearest rank) ms of the window's searches, each from its
due time (open loop; a failed request is infinitely slow). Moves
searches_per_s."""


def read(ctx):
    return (ctx.get("latency_ms") or {}).get("p95")
