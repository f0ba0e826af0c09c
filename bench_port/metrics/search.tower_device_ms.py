"""Device ms a batch spends in the text tower: the kernels that the
program's ``search.text_tower`` spans launched (matched by the profiler's
correlation ids, ``bench_port/spans.py``), per ``search.to_host`` span, over
the spans that start in the window. Moves searches_per_s."""

from bench_port.spans import per_batch_ms


def read(ctx):
    return per_batch_ms(ctx, ("search.text_tower",), "device_s")
