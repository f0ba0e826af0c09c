"""Share of the traced window's device time in kernels outside the GEMMs,
the attention kernels, LayerNorm, the optimizer and copies (the
``elementwise`` class of ``trace.kernel_class``). Moves
finetune_pairs_per_s."""


def read(ctx):
    tr = ctx.get("trace")
    total = sum(tr["by_class"].values()) if tr else 0.0
    return 100.0 * tr["by_class"].get("elementwise", 0.0) / total if total > 0 else None
