"""Device milliseconds of the update: CUDA events at the "backward" and
"update" marks of ``FusedNet.step(..., mark=...)``, the median of a few
steps after the window."""

import statistics


def read(ctx):
    ms = ctx.layer.get("update_ms")
    if ctx.layer.get("kind") != "train" or not ms:
        return None
    return statistics.median(ms)
