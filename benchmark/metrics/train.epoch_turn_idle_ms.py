"""Device idle milliseconds an epoch turn: the traced segment's idle
gaps (no kernel, copy or memset, between its busy intervals and at its
ends) that begin while the host is inside the program's
``fused.readback`` (the epoch accumulator's readback) or
``fused.epoch_perm`` (the next epoch's order put on the card), over the
count of ``fused.readback`` ranges in the segment."""

from harness import spans


def read(ctx):
    tr = ctx.layer.get("trace")
    if ctx.layer.get("kind") != "train" or tr is None:
        return None
    turns = spans.ranges(tr, "fused.readback")
    if not turns:
        return None
    holds = turns + spans.ranges(tr, "fused.epoch_perm")
    lo, hi = tr.window_ns
    idle, edge = 0, lo
    for s, e in tr.busy_intervals() + [[hi, hi]]:
        if s > edge and any(hs <= edge <= he for hs, he in holds):
            idle += s - edge
        edge = max(edge, e)
    return idle / 1e6 / len(turns)
