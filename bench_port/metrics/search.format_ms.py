"""Host ms a search spends being formatted and written: the program's
``search.format`` (the batch's 1000-row result lists) and ``http.render``
(the handler's body and send) spans per ``http.render`` span, over the
spans that start in the window (``bench_port/spans.py``). Moves
searches_per_s."""

from bench_port.spans import FORMAT, SEARCH, per_batch_ms


def read(ctx):
    return per_batch_ms(ctx, FORMAT, per=SEARCH)
