"""The program's spans as the per-layer readers see them: the totals
of its device-timed spans (``telemetry.span_totals()``, booked while a
capture runs, so in a ``--trace 1`` run those of the traced segment
alone) and its ``fused.*`` ranges among the traced segment's host
events.  A program without spans gives nothing to read: no totals and
no ranges, and the readers return None."""


def device_ms_per_step(ctx, name):
    """Device ms of span ``name`` (its ``device_s`` in the program's
    ``telemetry.span_totals()``) over the count of ``fused.step`` in a
    traced training run; None where the program books neither."""
    from znicz_tpu_torch.core import telemetry
    if ctx.layer.get("kind") != "train" or ctx.layer.get("trace") is None \
            or not hasattr(telemetry, "span_totals"):
        return None
    booked = telemetry.span_totals()
    step, part = booked.get("fused.step"), booked.get(name)
    if not step or not step["count"] or not part or \
            part["device_s"] is None:
        return None
    return 1e3 * part["device_s"] / step["count"]


def ranges(tr, name):
    """``[(start_ns, end_ns)]`` of the host's ranges named ``name`` that
    start inside the traced segment, by start."""
    lo, hi = tr.window_ns
    return [(s, e) for s, e, n in tr.host if n == name and lo <= s < hi]
