"""Metric time-series — a bounded in-process history of the registry.

Counterpart of ``znicz_tpu/core/timeseries.py``.  The telemetry
registry (:mod:`znicz_tpu_torch.core.telemetry`) is cumulative:
``/metrics`` answers "how many so far", never "how fast right now".
This module keeps the over-time view in process:

* a background sampler (a daemon thread named
  ``znicz:timeseries``, period
  ``root.common.telemetry.timeseries.interval_ms``) snapshots every
  counter and gauge whose family is one of the ``prefixes`` (and the
  ``p50`` / ``p99`` of matching histograms) into bounded timestamped
  rings of ``capacity`` points a series, the oldest dropped first;
* the queries :func:`rate` (the per-second increase of a counter over a
  trailing window) and :func:`windowed_delta` (its absolute increase);
* :func:`snapshot`, what ``GET /debug/timeseries`` serves on every
  :class:`~znicz_tpu_torch.core.status_server.HandlerBase` server, and
  :func:`merge_snapshots`, the step-function merge of several sources'
  rings (SUM for counters and gauges, MAX for quantiles);
* :func:`set_checkpoint_sink` and :func:`last_points`, through which
  the durable blackbox persists the rings' frontier.

The families differ from the JAX package's: it samples a ``jax``
family (its compile counters), which the port has no counterpart of,
and the port adds its profiler's, fault registry's, health monitor's
and launcher's families.  Its registry lock is a ``locksmith`` lock.

Everything gates on ``root.common.telemetry.timeseries.enabled``: off,
:func:`maybe_start` returns without touching anything, no thread
exists and no ring is allocated.  Tests drive :func:`sample_once`
with an injected ``now``, so the math is checked without sleeping.
"""

import collections
import threading
import time

from znicz_tpu_torch.analysis import locksmith
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core import telemetry

#: the config node (stable object identity — config.py declares it)
_cfg = root.common.telemetry.timeseries

telemetry.register_help(
    "timeseries", "metric time-series sampler (core/timeseries.py): "
                  "sweeps completed and series ring count")

_lock = locksmith.lock("timeseries.registry")

#: name -> _Series; created lazily per sampled series
_series = {}

_thread = None
_stop = threading.Event()

#: monotonic count of completed sampler sweeps (tests + /debug view)
_sweeps = 0


def enabled():
    """The one gate — a live read of
    ``root.common.telemetry.timeseries.enabled``."""
    return bool(_cfg.get("enabled", False))


def enable(**overrides):
    for k, v in overrides.items():
        setattr(root.common.telemetry.timeseries, k, v)
    root.common.telemetry.timeseries.enabled = True
    return True


def disable():
    root.common.telemetry.timeseries.enabled = False
    return False


class _Series(object):
    """One bounded timestamped ring: (unix_seconds, value) points."""

    __slots__ = ("name", "kind", "points")

    def __init__(self, name, kind, capacity):
        self.name = name
        self.kind = kind
        self.points = collections.deque(maxlen=capacity)


def _prefixes():
    raw = _cfg.get("prefixes",
                   "serving,slo,trainer,transfer,loader,pyprof,profiler,"
                   "faults,health,launcher")
    return tuple(p.strip() for p in str(raw).split(",") if p.strip())


def _wanted(name, prefixes):
    return name.split(".")[0] in prefixes


def sample_once(now=None):
    """One sampler sweep: append the current value of every selected
    counter/gauge (and matching histograms' p50/p99) to its ring.
    Returns the number of series touched (0 when the gate is off —
    the disabled path reads ONE predicate and nothing else)."""
    if not enabled():
        return 0
    snap = telemetry.snapshot()
    t = float(now if now is not None else time.time())
    prefixes = _prefixes()
    cap = int(_cfg.get("capacity", 512))
    touched = 0
    with _lock:
        for kind_key, kind in (("counters", "counter"),
                               ("gauges", "gauge")):
            for name, value in snap[kind_key].items():
                if not _wanted(name, prefixes):
                    continue
                s = _series.get(name)
                if s is None:
                    s = _series[name] = _Series(name, kind, cap)
                s.points.append((t, float(value)))
                touched += 1
        for name, st in snap["histograms"].items():
            if not _wanted(name, prefixes) or not st.get("count"):
                continue
            for q in ("p50", "p99"):
                if st.get(q) is None:
                    continue
                qname = "%s.%s" % (name, q)
                s = _series.get(qname)
                if s is None:
                    s = _series[qname] = _Series(qname, "quantile", cap)
                s.points.append((t, float(st[q])))
                touched += 1
    global _sweeps
    _sweeps += 1
    if telemetry.enabled():
        telemetry.counter("timeseries.sweeps").inc()
        telemetry.gauge("timeseries.series").set(len(_series))
    sink = _checkpoint_sink
    if sink is not None:
        try:
            sink(_sweeps, t)
        except Exception:  # noqa: BLE001 - never fail the sampler
            pass
    return touched


#: durable-checkpoint sink: the blackbox (core/blackbox.py) installs
#: a ``fn(sweeps, now)`` here when armed and persists
#: :func:`last_points` every Nth sweep, so rate() queries survive
#: process restarts.  None (one pointer compare) when unarmed.
_checkpoint_sink = None


def set_checkpoint_sink(fn):
    """Install (or, with None, remove) the per-sweep checkpoint
    sink."""
    global _checkpoint_sink
    _checkpoint_sink = fn


def last_points():
    """The newest point of every ring —
    ``{name: {"kind", "t", "v"}}`` — the blackbox checkpoint payload
    (a checkpoint needs only the frontier: the previous checkpoints
    already persisted the history)."""
    with _lock:
        return {s.name: {"kind": s.kind,
                         "t": s.points[-1][0], "v": s.points[-1][1]}
                for s in _series.values() if s.points}


def _run():
    while not _stop.is_set():
        if not enabled():
            return  # gate flipped off: the thread retires itself
        try:
            sample_once()
        except Exception:  # noqa: BLE001 - a sampler must never die
            pass
        _stop.wait(float(_cfg.get("interval_ms", 1000.0)) / 1e3)


def maybe_start():
    """Start the background sampler iff the gate is on and no thread
    runs (idempotent; called by ``HttpServerBase.start`` so arming the
    knob before a server starts is all an operator does).  Returns
    True when a sampler is running after the call."""
    if not enabled():
        return False
    global _thread
    with _lock:
        if _thread is not None and _thread.is_alive():
            return True
        _stop.clear()
        _thread = threading.Thread(target=_run,
                                   name="znicz:timeseries",
                                   daemon=True)
        _thread.start()
    return True


def stop():
    """Stop the sampler thread (keeps the collected rings)."""
    global _thread
    with _lock:
        thread, _thread = _thread, None
    _stop.set()
    if thread is not None:
        thread.join(timeout=5)
    _stop.clear()


def reset():
    """Drop every ring and the sweep count (tests)."""
    global _sweeps
    stop()
    with _lock:
        _series.clear()
    _sweeps = 0


def series_names():
    with _lock:
        return sorted(_series)


def points(name):
    """The (t, value) points of one series, oldest first."""
    with _lock:
        s = _series.get(name)
        return list(s.points) if s is not None else []


def _window_points(pts, window_s, now=None):
    if not pts:
        return []
    if window_s is None:
        return pts
    horizon = float(now if now is not None else pts[-1][0]) \
        - float(window_s)
    return [p for p in pts if p[0] >= horizon]


def windowed_delta(name, window_s=None, now=None):
    """Absolute increase of ``name`` across the trailing ``window_s``
    seconds (whole ring when None).  None with fewer than two points
    in the window — no delta is not a zero delta."""
    pts = _window_points(points(name), window_s, now)
    if len(pts) < 2:
        return None
    return pts[-1][1] - pts[0][1]


def rate(name, window_s=None, now=None):
    """Per-second increase of a counter series over the trailing
    window (the PromQL ``rate()`` analogue on the in-process rings).
    None with fewer than two points or zero elapsed time."""
    pts = _window_points(points(name), window_s, now)
    if len(pts) < 2:
        return None
    dt = pts[-1][0] - pts[0][0]
    if dt <= 0:
        return None
    return (pts[-1][1] - pts[0][1]) / dt


def _trailing_rate(pts, window_s):
    """Per-second increase over the trailing window of one counter
    ring (None when underdetermined) — shared by :func:`snapshot` and
    :func:`merge_snapshots` so the router's merged view rates exactly
    like a replica's local one."""
    if len(pts) < 2 or pts[-1][0] <= pts[0][0]:
        return None
    win = [p for p in pts
           if window_s is None or p[0] >= pts[-1][0] - window_s]
    if len(win) < 2 or win[-1][0] <= win[0][0]:
        return None
    return round((win[-1][1] - win[0][1])
                 / (win[-1][0] - win[0][0]), 6)


def snapshot(window_s=None):
    """The JSON payload ``GET /debug/timeseries`` serves: every ring's
    points plus per-counter trailing rates (over ``window_s``, whole
    ring when None) — directly renderable by
    ``tools/profile_summary.py --timeseries``."""
    with _lock:
        items = [(s.name, s.kind, list(s.points))
                 for s in _series.values()]
    out = {"enabled": enabled(), "sweeps": _sweeps,
           "interval_ms": float(_cfg.get("interval_ms", 1000.0)),
           "series": {}, "rates": {}}
    for name, kind, pts in sorted(items):
        out["series"][name] = {
            "kind": kind, "points": [[round(t, 3), v] for t, v in pts]}
        if kind == "counter":
            rate_v = _trailing_rate(pts, window_s)
            if rate_v is not None:
                out["rates"][name] = rate_v
    return out


def _step_merge(sources, use_max=False):
    """Timestamp-merge several (t, value) rings into one: at every
    instant ANY source sampled, the merged value is the sum (max for
    quantile series) of each source's most recent value at-or-before
    that instant — the step-function semantics PromQL uses when
    summing counters across instances.  A source contributes nothing
    before its first point (a replica that joined the fleet late must
    not read as a counter reset)."""
    times = sorted({t for ring in sources.values() for t, _ in ring})
    idx = dict.fromkeys(sources, 0)
    last = dict.fromkeys(sources)
    merged = []
    for t in times:
        for label, ring in sources.items():
            i = idx[label]
            while i < len(ring) and ring[i][0] <= t:
                last[label] = ring[i][1]
                i += 1
            idx[label] = i
        vals = [v for v in last.values() if v is not None]
        if vals:
            merged.append((t, max(vals) if use_max else sum(vals)))
    return merged


def merge_snapshots(payloads, window_s=None):
    """Merge several :func:`snapshot` payloads into one view (the JAX
    fleet router's ``GET /debug/timeseries`` fan-out, and the
    blackbox's cross-restart checkpoints).  ``payloads`` maps a source
    label to its snapshot dict.

    Counters and gauges merge by :func:`_step_merge` SUM (fleet
    request rate = the sum of replica rates; fleet queue depth = the
    sum of replica depths); quantile series merge as the step-wise
    MAX — the conservative tail view, matching the /slo burn-rate
    aggregation.  Each merged series carries a ``sources`` block
    (per-source LAST value) for per-replica attribution, and
    ``rates`` is recomputed over the merged rings so ``rate()``-style
    queries work at the front door."""
    names = {}
    enabled_any = False
    sweeps = 0
    interval = None
    for label in sorted(payloads):
        snap = payloads[label] or {}
        enabled_any = enabled_any or bool(snap.get("enabled"))
        sweeps += int(snap.get("sweeps") or 0)
        if interval is None and snap.get("interval_ms") is not None:
            interval = float(snap["interval_ms"])
        for name, block in (snap.get("series") or {}).items():
            entry = names.setdefault(
                name, {"kind": block.get("kind"), "sources": {}})
            entry["sources"][label] = [
                (float(t), float(v))
                for t, v in (block.get("points") or ())]
    cap = int(_cfg.get("capacity", 512))
    out = {"enabled": enabled_any, "merged": True,
           "sources": sorted(payloads),
           "sweeps": sweeps,
           "interval_ms": interval if interval is not None else 0.0,
           "series": {}, "rates": {}}
    for name in sorted(names):
        entry = names[name]
        pts = _step_merge(entry["sources"],
                          use_max=entry["kind"] == "quantile")[-cap:]
        out["series"][name] = {
            "kind": entry["kind"],
            "points": [[round(t, 3), v] for t, v in pts],
            "sources": {
                label: (ring[-1][1] if ring else None)
                for label, ring in sorted(entry["sources"].items())},
        }
        if entry["kind"] == "counter":
            rate_v = _trailing_rate(pts, window_s)
            if rate_v is not None:
                out["rates"][name] = rate_v
    return out
