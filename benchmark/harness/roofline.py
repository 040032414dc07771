"""Max pooling against its roofline in a traced segment.

The kernels that implement max pooling are found by the name pattern
each metric keeps in its own file.  The same work is counted whatever
runs it (``counts``)."""

from harness import peaks


def pool_share(ctx, kernels):
    """Percent of the roofline, or None where the segment ran no pooling
    kernel or the card has no listed bandwidth."""
    tr = ctx.layer.get("trace")
    nbytes = ctx.layer.get("pool_bytes")
    bw = peaks.peak(ctx.card, "hbm")
    if tr is None or not nbytes or bw is None:
        return None
    seconds, n = tr.seconds_matching(kernels)
    if not n or seconds <= 0:
        return None
    return 100.0 * (nbytes / bw) / seconds
