"""Per-request trace trees: the rid-stitched view of one prediction.

Counterpart of ``znicz_tpu/serving/reqtrace.py``.  Every head-sampled
request (every ``root.common.serving.trace_sample_n``-th admission; 0,
the default, is off) gets a span tree keyed by its request id:

* ``admission`` — HTTP receipt (or a wire frame's completion) to the
  batcher's submission;
* ``queue_wait`` — queued until a dispatch slot took the request;
* ``assembly`` — the slot's taking of the batch: the engine, the
  bucket and the concatenation;
* ``dispatch`` — the engine call as the batcher saw it;
* ``device`` — the forward on the device, nested in ``dispatch``.  It
  ends when the result is on the host: CUDA runs asynchronously, so
  the span closes after the engine's readback, not when the forward's
  Python call returns;
* ``reply`` — the dispatch's end to the reply's bytes: the batch's
  split, the future's resolution, the handler thread's wake-up and the
  encoding.

The five kinds other than ``device`` partition the request's wall time:
each starts where the one before it ended (``queue_wait`` at the end of
the tree's ``admission``, ``assembly`` where the slot took the batch,
``reply`` at the end of the tree's ``dispatch``, :func:`span_end`), so
the hand-offs between threads, which a loaded host stretches to
milliseconds, land in a span and the parts sum to the wall.
Trees live in a bounded ring (``trace_capacity``), served at ``GET
/debug/trace/<rid>`` with a ``traceEvents`` block in the Chrome-trace
schema.  The fleet router (:mod:`znicz_tpu_torch.serving.router`)
records its own tree per sampled rid — ``route``, ``conn_acquire``,
``relay_send``, ``replica_wait``, ``relay_reply``, ``retry`` for a
failed attempt, ``replica`` for the stitched peer — and propagates its
decision with ``X-Trace-Sampled``; :func:`stitch` aligns the replica's
tree into the router's ``replica_wait`` window.  The binary relay adds
``frame_decode`` (nested in the replica's ``admission``) and
``relay_wait`` (nested in the router's ``relay_reply``).

:func:`set_finish_sink` lets the durable blackbox persist every closed
tree.  Every hook checks :func:`enabled` first; an unsampled rid costs
one dict lookup.  The lock is a ``locksmith`` lock.
"""

import collections
import time

from znicz_tpu_torch.analysis import locksmith
from znicz_tpu_torch.core.config import root

_cfg = root.common.serving

#: the six span kinds of a complete tree (device nests in dispatch)
SPAN_KINDS = ("admission", "queue_wait", "assembly", "dispatch",
              "device", "reply")

#: the non-overlapping kinds whose durations partition the wall time
TOP_LEVEL_KINDS = ("admission", "queue_wait", "assembly", "dispatch",
                   "reply")

#: the seven router-side kinds (serving/router.py — see the module
#: docstring); ``replica`` nests in ``replica_wait``
ROUTER_SPAN_KINDS = ("route", "conn_acquire", "relay_send",
                     "replica_wait", "relay_reply", "retry",
                     "replica")

#: the non-overlapping router kinds whose durations partition the
#: ROUTER's wall time (``retry`` collapses a whole failed attempt,
#: so it never overlaps the final attempt's phase spans)
ROUTER_TOP_LEVEL_KINDS = ("route", "conn_acquire", "relay_send",
                          "replica_wait", "relay_reply", "retry")

#: kinds a COMPLETE router tree must carry — ``retry`` rides only on
#: retried requests and ``replica`` only on stitched payloads
ROUTER_REQUIRED_KINDS = ("route", "conn_acquire", "relay_send",
                         "replica_wait", "relay_reply")

#: binary-relay hop kinds (serving/wire.py).  Both NEST
#: inside existing partition members, so neither joins a required or
#: top-level set and both six-kind partitions stay exact:
#: ``frame_decode`` (the replica's zero-copy ``.npy`` parse) nests in
#: ``admission``; ``relay_wait`` (response frame complete on the mux
#: loop → the relay worker thread resumed) nests in ``relay_reply``.
WIRE_SPAN_KINDS = ("frame_decode", "relay_wait")

#: the full vocabulary — :func:`add_span` stays LOUD on anything else
_ALL_KINDS = (frozenset(SPAN_KINDS) | frozenset(ROUTER_SPAN_KINDS) |
              frozenset(WIRE_SPAN_KINDS))

#: per-origin (required-for-complete, partition) kind sets
_ORIGINS = {
    "serving": (frozenset(SPAN_KINDS), frozenset(TOP_LEVEL_KINDS)),
    "router": (frozenset(ROUTER_REQUIRED_KINDS),
               frozenset(ROUTER_TOP_LEVEL_KINDS)),
}

_lock = locksmith.lock("serving.reqtrace")
#: rid -> _Trace, insertion-ordered (the bounded ring)
_traces = collections.OrderedDict()
#: admissions seen since process start — the head-sampling cursor
_admissions = 0


def enabled():
    """The one gate every hook checks — a live read of
    ``root.common.serving.trace_sample_n``."""
    return int(_cfg.get("trace_sample_n", 0) or 0) > 0


def enable(sample_n=1):
    root.common.serving.trace_sample_n = int(sample_n)
    return True


def disable():
    root.common.serving.trace_sample_n = 0
    return False


class _Trace(object):
    __slots__ = ("rid", "model", "t0", "t_end", "spans", "origin")

    def __init__(self, rid, t0, origin="serving"):
        self.rid = rid
        self.model = None
        self.t0 = t0
        self.t_end = None
        self.spans = []
        self.origin = origin


def begin(rid, now=None, force=False, origin="serving"):
    """Head-sample one admission: every ``trace_sample_n``-th call
    creates a tree for ``rid``.  Returns True when this rid was
    sampled (the caller then owns closing it via :func:`finish`).

    ``force=True`` skips the sampling cursor entirely — the replica
    honoring a router's ``X-Trace-Sampled: 1`` header must trace the
    SAME rid the router picked, and the propagated decision must not
    advance the replica's own cursor (its direct-traffic sampling
    cadence stays untouched).  The :func:`enabled` gate still applies.
    ``origin`` ("serving" | "router") picks the completeness and
    partition vocabulary :func:`get` judges the tree by.

    Request ids come from clients, so reuse is normal (a retry
    resends its ``X-Request-Id``): a FINISHED tree under the same rid
    is replaced (newest wins — the rid is the lookup key), but a
    still-LIVE tree is never clobbered — the in-flight request's
    remaining spans must not land on a stranger's timeline."""
    if not enabled():
        return False
    n = int(_cfg.get("trace_sample_n", 0) or 0)
    if (n <= 0 and not force) or not rid:
        return False
    cap = int(_cfg.get("trace_capacity", 256) or 256)
    t0 = float(now if now is not None else time.monotonic())
    global _admissions
    with _lock:
        if not force:
            _admissions += 1
            if (_admissions - 1) % n:
                return False
        live = _traces.get(rid)
        if live is not None and live.t_end is None:
            return False
        _traces.pop(rid, None)  # replace a finished tree IN ORDER
        _traces[rid] = _Trace(rid, t0, origin=origin)
        while len(_traces) > cap:
            _traces.popitem(last=False)
    return True


def sampled(rid):
    """Is ``rid`` a LIVE sampled trace?  One dict lookup — cheap
    enough for the per-request guards in the batchers/engine.  A
    finished tree answers False: a later request reusing the rid (a
    client retry) must not append spans — timed against the old
    tree's origin — to the stored result."""
    if rid is None:
        return False
    with _lock:
        tr = _traces.get(rid)
        return tr is not None and tr.t_end is None


def add_span(rid, kind, t0, t1, **attrs):
    """Record one span on ``rid``'s tree (no-op for unsampled rids
    and for trees already closed by :func:`finish` — see
    :func:`sampled`).  ``t0``/``t1`` are ``time.monotonic()`` stamps
    — the same clock every component uses, so spans stitch across
    threads."""
    if kind not in _ALL_KINDS:
        raise ValueError("unknown span kind %r (known: %s)"
                         % (kind, ", ".join(sorted(_ALL_KINDS))))
    with _lock:
        tr = _traces.get(rid)
        if tr is None or tr.t_end is not None:
            return False
        tr.spans.append((kind, float(t0), float(t1),
                         attrs or None))
    return True


def span_end(rid, kind):
    """The end stamp of the newest ``kind`` span on ``rid``'s live tree,
    or None (unsampled, closed, or no such span yet): where the next
    span of a partition starts."""
    with _lock:
        tr = _traces.get(rid)
        if tr is None or tr.t_end is not None:
            return None
        ends = [s[2] for s in tr.spans if s[0] == kind]
    return ends[-1] if ends else None


def set_model(rid, model):
    with _lock:
        tr = _traces.get(rid)
        if tr is not None and model is not None:
            tr.model = model


#: trace-persistence sink: the durable blackbox (core/blackbox.py)
#: installs a ``fn(rid, tree)`` here when armed; every closed
#: head-sampled tree is then persisted at finish time, so a SIGKILLed
#: replica's sampled traces survive it.  None (one pointer compare on
#: the finish path) when unarmed.
_finish_sink = None


def set_finish_sink(fn):
    """Install (or, with None, remove) the finish-time trace sink."""
    global _finish_sink
    _finish_sink = fn


def finish(rid, now=None, model=None):
    """Close the tree (stamps the total wall time).  First close
    wins: a caller that knows the true reply stamp closes early with
    ``now=``, and the surrounding safety-net ``finally`` close is a
    no-op — post-reply bookkeeping never inflates the wall."""
    t = float(now if now is not None else time.monotonic())
    with _lock:
        tr = _traces.get(rid)
        if tr is None:
            return False
        if tr.t_end is not None:
            return True
        tr.t_end = t
        if model is not None:
            tr.model = model
    sink = _finish_sink
    if sink is not None:
        try:
            sink(rid, get(rid))
        except Exception:  # noqa: BLE001 - never fail the request
            pass
    return True


def rids():
    """Sampled rids, newest first (the /debug/trace index)."""
    with _lock:
        return list(reversed(_traces))


def get(rid):
    """The span tree for ``rid`` (None when unsampled/evicted):
    relative-millisecond spans, completeness verdict, and a
    ``traceEvents`` block in the telemetry Chrome-trace schema.
    Completeness and the parts-sum partition are judged against the
    tree's ORIGIN vocabulary (a router tree is complete with its five
    hop phases; a serving tree with its six)."""
    with _lock:
        tr = _traces.get(rid)
        if tr is None:
            return None
        spans = list(tr.spans)
        t0, t_end, model = tr.t0, tr.t_end, tr.model
        origin = tr.origin
    required, top_level = _ORIGINS.get(origin, _ORIGINS["serving"])
    out_spans = []
    events = []
    kinds = set()
    for kind, s0, s1, attrs in sorted(spans, key=lambda s: s[1]):
        kinds.add(kind)
        span = {"kind": kind,
                "start_ms": round((s0 - t0) * 1e3, 3),
                "duration_ms": round((s1 - s0) * 1e3, 3)}
        if attrs:
            span["attrs"] = attrs
        out_spans.append(span)
        ev = {"name": kind, "ph": "X", "cat": "znicz.request",
              "ts": round((s0 - t0) * 1e6, 3),
              "dur": round((s1 - s0) * 1e6, 3),
              "pid": 0, "tid": 0}
        if attrs:
            ev["args"] = attrs
        events.append(ev)
    wall_ms = (round((t_end - t0) * 1e3, 3)
               if t_end is not None else None)
    parts_ms = round(sum(s["duration_ms"] for s in out_spans
                         if s["kind"] in top_level), 3)
    return {
        "rid": rid,
        "model": model,
        "origin": origin,
        "complete": kinds >= required and t_end is not None,
        "span_kinds": sorted(kinds),
        "wall_ms": wall_ms,
        "parts_ms": parts_ms,
        "spans": out_spans,
        "traceEvents": events,
    }


def stitch(router_tree, replica_tree, replica=None):
    """Merge a replica's :func:`get` payload into the router's — ONE
    cross-process tree for the rid (the Dapper stitch).

    Clock-alignment rule: both processes time spans in relative
    milliseconds from their own ``time.monotonic()`` origin, and the
    two origins are incomparable.  The router DOES know the window the
    replica worked inside: its ``replica_wait`` span (request fully
    sent → first reply byte).  The replica's origin is therefore
    placed at ``wait.start + max(0, (wait.duration - replica_wall)/2)``
    — the NTP-style midpoint that splits the unexplained slack (the
    two one-way network/scheduling delays) evenly around the replica's
    reported wall time, clamped so a jitter-inflated replica wall
    still starts inside the window.  A synthetic ``replica`` span
    marks the aligned window (nested in ``replica_wait`` exactly the
    way ``device`` nests in ``dispatch``) and carries the alignment
    facts as attrs.

    The merged payload keeps the ROUTER partition: ``parts_ms`` sums
    only router top-level kinds, so parts-sum ≈ router wall survives
    the stitch.  ``traceEvents`` exports ONE Chrome trace with a track
    per process (router pid 0, replica pid 1, named via ``ph: "M"``
    process_name metadata)."""
    waits = [s for s in router_tree.get("spans", ())
             if s["kind"] == "replica_wait"]
    wait = waits[-1] if waits else None
    r_wall = float(replica_tree.get("wall_ms")
                   or replica_tree.get("parts_ms") or 0.0)
    if wait is not None:
        slack = wait["duration_ms"] - r_wall
        offset = wait["start_ms"] + max(0.0, slack / 2.0)
    else:
        offset = 0.0
    spans = [dict(s, process="router")
             for s in router_tree.get("spans", ())]
    spans.append({
        "kind": "replica",
        "start_ms": round(offset, 3),
        "duration_ms": round(r_wall, 3),
        "process": "router",
        "attrs": {"replica": replica,
                  "clock_offset_ms": round(offset, 3),
                  "replica_wall_ms": r_wall},
    })
    for s in replica_tree.get("spans", ()):
        spans.append(dict(s, start_ms=round(s["start_ms"] + offset, 3),
                          process="replica"))
    spans.sort(key=lambda s: s["start_ms"])
    events = [
        {"name": "process_name", "ph": "M", "pid": 0,
         "args": {"name": "router"}},
        {"name": "process_name", "ph": "M", "pid": 1,
         "args": {"name": "replica %s" % (replica or "?")}},
    ]
    for s in spans:
        ev = {"name": s["kind"], "ph": "X", "cat": "znicz.request",
              "ts": round(s["start_ms"] * 1e3, 3),
              "dur": round(s["duration_ms"] * 1e3, 3),
              "pid": 0 if s["process"] == "router" else 1,
              "tid": 0}
        if s.get("attrs"):
            ev["args"] = s["attrs"]
        events.append(ev)
    parts_ms = round(sum(s["duration_ms"] for s in spans
                         if s["process"] == "router"
                         and s["kind"] in ROUTER_TOP_LEVEL_KINDS), 3)
    return {
        "rid": router_tree.get("rid"),
        "model": router_tree.get("model")
        or replica_tree.get("model"),
        "origin": "router",
        "stitched": True,
        "replica": replica,
        "complete": bool(router_tree.get("complete")
                         and replica_tree.get("complete")),
        "span_kinds": sorted({s["kind"] for s in spans}),
        "wall_ms": router_tree.get("wall_ms"),
        "parts_ms": parts_ms,
        "router_wall_ms": router_tree.get("wall_ms"),
        "replica_wall_ms": r_wall,
        "clock_offset_ms": round(offset, 3),
        "spans": spans,
        "traceEvents": events,
    }


def reset():
    """Drop every trace and the sampling cursor (tests)."""
    global _admissions
    with _lock:
        _traces.clear()
        _admissions = 0
