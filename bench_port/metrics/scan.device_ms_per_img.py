"""Device busy time of the traced window (every kernel, copy and fill on
the card, their union) per photo appended. Moves scan_img_per_s."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or ctx["appended"] <= 0:
        return None
    return 1e3 * tr["busy_s"] * (ctx["window_s"] / tr["window_s"]) / ctx["appended"]
