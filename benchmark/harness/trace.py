"""A traced segment: ``torch.profiler`` over the CPU and the card, read
into device intervals and host events.

The device is busy where a kernel, a copy or a memset runs; the busy
time is the union of those intervals inside the segment, whose length
is that of the benchmark's own ``bench.traced_segment`` annotation.  A
trace with no device event inside the segment fails the run: CUPTI can
drop records, and a share read from an empty trace would be a fault
reported as a measurement.
"""

import bisect
import collections
import time

SEGMENT = "bench.traced_segment"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
#: an idle gap shorter than this is counted, not labelled
SHORT_GAP_NS = 10_000


class TraceError(RuntimeError):
    """The trace cannot give the device's numbers."""


def _ns(ev, what):
    fn = getattr(ev, what + "_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, what + "_us")() * 1000)


def _kind(ev):
    kind = ev.activity_type() if hasattr(ev, "activity_type") else ""
    return str(kind)


class Trace:
    """``device``: ``[(start_ns, end_ns, name)]`` of the device events
    inside the segment, sorted; ``host``: ``[(start_ns, end_ns, name)]``
    of the host's events, sorted by start; ``window_ns``: the segment's
    ``(start, end)``."""

    def __init__(self, device, host, window_ns):
        if not device:
            raise TraceError("the trace holds no device event in the "
                             "traced segment")
        self.device = device
        self.host = host
        self.window_ns = window_ns

    @property
    def window_s(self):
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy_intervals(self):
        """The union of the device intervals, merged, in order."""
        merged = []
        for s, e, _ in self.device:
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1][1] = e
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def seconds_matching(self, regex):
        """Device seconds of the events whose name matches ``regex``
        (a compiled pattern), and how many there were."""
        total, n = 0, 0
        for s, e, name in self.device:
            if regex.search(name):
                total += e - s
                n += 1
        return total / 1e9, n

    def device_ops(self, top=10):
        """The device operations that took the most time:
        ``[[name, seconds]]``."""
        by = collections.Counter()
        for s, e, name in self.device:
            by[name[:160]] += e - s
        return [[name, ns / 1e9] for name, ns in by.most_common(top)]

    def idle_gaps(self, top=10):
        """Idle device time by what the host was doing when each gap
        began (the innermost host event running then):
        ``[[label, seconds]]``, gaps under 10 us counted as one label."""
        starts = [h[0] for h in self.host]
        by = collections.Counter()
        edge = self.window_ns[0]
        gaps = []
        for s, e in self.busy_intervals() + [[self.window_ns[1]] * 2]:
            if s > edge:
                gaps.append((edge, s))
            edge = max(edge, e)
        for s, e in gaps:
            if e - s < SHORT_GAP_NS:
                by["(gaps under 10 us)"] += e - s
                continue
            label = "(no host event)"
            i = bisect.bisect_right(starts, s) - 1
            seen = 0
            while i >= 0 and seen < 400:
                hs, he, name = self.host[i]
                if he >= s:
                    label = name[:160]
                    break
                i -= 1
                seen += 1
            by[label] += e - s
        return [[name, ns / 1e9] for name, ns in by.most_common(top)]


def from_profiler(prof, clock_window):
    """A :class:`Trace` of a finished ``torch.profiler.profile``.  The
    segment is the span of its annotation where the trace holds it,
    else ``clock_window``, the host's wall clock in nanoseconds around
    the segment (the profiler's timestamps are on that clock)."""
    events = prof.profiler.kineto_results.events()
    window = None
    device, host = [], []
    for ev in events:
        kind = _kind(ev)
        name = ev.name()
        on_card = str(ev.device_type()).endswith("CUDA") and \
            "annotation" not in kind
        if name == SEGMENT:
            if not on_card and "gpu" not in kind:
                s = _ns(ev, "start")
                window = (s, s + _ns(ev, "duration"))
            continue
        s = _ns(ev, "start")
        if kind in DEVICE_KINDS or on_card:
            device.append((s, s + _ns(ev, "duration"), name))
        elif "gpu" not in kind and "annotation" not in kind or \
                kind == "user_annotation":
            host.append((s, s + _ns(ev, "duration"), name))
    source = "annotation"
    if window is None:
        window, source = clock_window, "host clock"
    lo, hi = window
    inside = sorted((max(s, lo), min(e, hi), n) for s, e, n in device
                    if e > lo and s < hi)
    if not inside:
        raise TraceError(
            "the trace holds no device event in the traced segment "
            "(%d device events in all, %s; segment by the %s: %s)"
            % (len(device), (min(d[0] for d in device),
                             max(d[1] for d in device)) if device else "-",
               source, window))
    host.sort()
    return Trace(inside, host, window)


def traced(torch, body):
    """``(result, Trace)``: ``body()`` run inside one profiler capture of
    the CPU and the card, under the segment's annotation, with the card
    synchronized at both ends."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SEGMENT):
            t0 = time.time_ns()
            result = body()
            torch.cuda.synchronize()
            t1 = time.time_ns()
    return result, from_profiler(prof, (t0, t1))
