"""Device milliseconds of a step's forward on the timed window path: the
CUDA events of the program's ``fused.forward`` span over the count of
``fused.step``, in the traced segment."""

from harness import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, "fused.forward")
