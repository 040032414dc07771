"""Kernel launches a training step: the host's launch calls
(``cudaLaunchKernel*``, ``cuLaunchKernel*``, ``cudaGraphLaunch``) that
start inside the program's ``fused.step`` ranges of the traced segment,
on any thread (autograd's backward launches from its own), over the
count of those ranges."""

import bisect

from harness import spans

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")


def read(ctx):
    tr = ctx.layer.get("trace")
    if ctx.layer.get("kind") != "train" or tr is None:
        return None
    steps = spans.ranges(tr, "fused.step")
    if not steps:
        return None
    starts = sorted(s for s, _, n in tr.host if n.startswith(LAUNCH_CALLS))
    return sum(bisect.bisect_right(starts, e) - bisect.bisect_left(starts, s)
               for s, e in steps) / len(steps)
