"""Host ms a query-by-photo request spends decoding its upload: the
program's ``image.decode`` spans (``decode_image_bytes`` in
``engine.search_by_image``), per span, over the spans that start in the
window. Moves searches_per_s."""

from bench_port.spans import per_batch_ms


def read(ctx):
    return per_batch_ms(ctx, ("image.decode",), "host_s", per="image.decode")
