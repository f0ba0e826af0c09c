"""The train step's share of the card's bf16 peak: pairs trained in the
window times 3 x (what one image needs from the vision tower + what its
caption needs from the text tower, over its tokens up to EOS), over the
window's seconds; the backward counted as twice the forward, no recompute
counted. Moves finetune_pairs_per_s."""

from bench_port import flops


def read(ctx):
    m, toks = ctx["model"], ctx["text_tokens"]
    if ctx["window_s"] <= 0 or not toks:
        return None
    per_pair = flops.vision_ops(m) + sum(flops.text_ops(m, t) for t in toks) / len(toks)
    return 100.0 * ctx["pairs"] * 3 * per_pair / ctx["window_s"] / flops.BF16_FLOP_PER_S
