"""Device milliseconds of a step's backward (the gradient, and a mesh's
all-reduce) on the timed window path: the CUDA events of the program's
``fused.backward`` span over the count of ``fused.step``, in the traced
segment."""

from harness import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, "fused.backward")
