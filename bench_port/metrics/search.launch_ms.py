"""Host ms a batch spends launching its device work: the program's spans
``search.text_tower``, ``search.rocchio``, ``search.scan`` and
``search.topk`` per ``search.to_host`` span, over the spans that start in
the window (``bench_port/spans.py``). Moves searches_per_s."""

from bench_port.spans import LAUNCH, per_batch_ms


def read(ctx):
    return per_batch_ms(ctx, LAUNCH)
