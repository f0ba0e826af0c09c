"""Share of the traced window in which no kernel ran on the card. Moves
scan_img_per_s."""

from bench_port.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
