"""Device ms a query-by-photo request spends in the vision tower: the
kernels launched inside the program's ``image_embed`` spans (the upload's
fused preprocess, in its own ``image.preprocess`` span inside it, and the
tower at B = 1), per ``image_embed`` span, over the spans that start in the
window; none where the window served no upload (the program's
``image_searches`` counter). Moves searches_per_s."""

from bench_port.readers import delta
from bench_port.spans import per_batch_ms


def read(ctx):
    if delta(ctx, "image_searches") <= 0:
        return None
    return per_batch_ms(ctx, ("image_embed", "image.preprocess"), "device_s", per="image_embed")
