"""Share of the window's searches whose text embedding came from the
engine's text cache. Moves searches_per_s."""

from bench_port.readers import delta


def read(ctx):
    n = delta(ctx, "searches")
    return 100.0 * delta(ctx, "text_embed_cache_hits") / n if n > 0 else None
