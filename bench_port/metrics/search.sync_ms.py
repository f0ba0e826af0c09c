"""Host ms a batch blocks on the card: the program's ``search.to_host``
spans (``VectorIndex._to_host``) per batch, over the spans that start in
the window (``bench_port/spans.py``). Moves searches_per_s."""

from bench_port.spans import SYNC, per_batch_ms


def read(ctx):
    return per_batch_ms(ctx, SYNC)
