"""Device milliseconds of a step's GD update on the timed window path:
the CUDA events of the program's ``fused.update`` span over the count
of ``fused.step``, in the traced segment (``train.update_ms_per_step``
times a separate ``FusedNet.step`` after the window)."""

from harness import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, "fused.update")
