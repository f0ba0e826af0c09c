"""The scan's share of the card's bf16 peak: the photos appended in the
window times what one needs from the vision tower (``flops.vision_ops``:
the patch embedding, every layer but the last over all 257 tokens, the last
at the CLS row, the projection), over the window's seconds. Moves
scan_img_per_s."""

from bench_port import flops


def read(ctx):
    if ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["appended"] * flops.vision_ops(ctx["model"]) / ctx["window_s"] / flops.BF16_FLOP_PER_S
