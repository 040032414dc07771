"""Telemetry — the counters, gauges and histograms the serving slice
emits, and their Prometheus text for ``/metrics``.

Counterpart of ``znicz_tpu/core/telemetry.py``, cut to the series the
port's engine, batcher and server record:

* engine: ``serving.predictions.bucket_<n>`` counters,
  ``serving.model_version`` and ``serving.warm_buckets`` gauges;
* batcher: ``serving.queue_depth`` gauge, ``serving.batches`` /
  ``serving.rejected`` / ``serving.timeouts`` / ``serving.errors``
  counters, ``serving.batch_rows`` / ``serving.batch_fill`` /
  ``serving.request_seconds`` / ``serving.queue_wait_seconds`` /
  ``serving.device_seconds`` histograms.

and the training control plane's ``faults.*``, ``health.*`` and
``launcher.restarts`` series.

The flight recorder (JAX :255-440): :func:`record_event` appends
structured milestones (injected faults, retries, restarts, health
violations, skipped snapshots) to a bounded journal and hands each to
the write-through sink of the durable blackbox when one is armed
(:func:`set_journal_sink`), and :func:`write_crash_report` dumps it
with the metrics and the traceback into a fresh directory under
``root.common.health.crash_dir`` (default
``<root.common.dirs.cache>/crash_reports``), its report naming the
blackbox's live segment (``blackbox_segment``); the launcher and the
health monitor's ``halt`` policy call it, and
:func:`install_crash_handler` chains it into ``sys.excepthook`` and
SIGTERM.

Request traces live in :mod:`znicz_tpu_torch.serving.reqtrace` (the
``/debug/trace`` endpoint of the servers and the fleet router); the
JAX package's generic spans have no counterpart here, its zero-length
markers do: :func:`instant` (JAX :198) records one into a bounded ring
(:data:`TRACE_CAPACITY` events), read as
Chrome-trace events by :func:`trace_events`, whose ``pid`` is the
process's rank in the ``torch.distributed`` world (JAX :206-216).
:func:`merged_snapshot` (JAX :665-677) is :func:`snapshot`, reduced
over the world's ranks when it has more than one
(:func:`znicz_tpu_torch.parallel.multihost.aggregate_telemetry`).
:func:`summary` and :func:`serving_summary` (JAX :814, :855) are the
compact why-blocks a report stamps, without the JAX package's compile
counters; :func:`parse_prometheus` (JAX :954) validates an
exposition.
:func:`register_help` / :func:`help_for` keep the one-line help of each
series family (JAX :696-752), which the release plane and the
autoscaler register.

The metrics sit behind one gate, ``root.common.telemetry.enabled``:
when it is off the factories hand out a shared no-op and nothing is
recorded.  The journal records while telemetry, the health monitor,
the fault registry or the blackbox is on (:func:`journal_enabled`).
"""

import collections
import json
import logging
import os
import re
import threading
import time

from znicz_tpu_torch.analysis import locksmith
from znicz_tpu_torch.core.config import root

_cfg = root.common.telemetry
_lock = locksmith.lock("telemetry.registry")
_T0 = time.perf_counter()
logger = logging.getLogger("telemetry")


def enabled():
    """The one gate every hook checks (live config read)."""
    return bool(_cfg.get("enabled", False))


def enable():
    _cfg.enabled = True


def disable():
    _cfg.enabled = False


# -- metrics ----------------------------------------------------------------

class _NullMetric(object):
    __slots__ = ()

    def inc(self, n=1):
        pass

    def set(self, value):
        pass

    def observe(self, value, count=1):
        pass

    count = 0

    def percentile(self, p):
        return None


_NULL_METRIC = _NullMetric()


class Counter(object):
    kind = "counter"

    def __init__(self, name):
        self.name = name
        self.value = 0
        self._lock = locksmith.lock("telemetry.metric")

    def inc(self, n=1):
        with self._lock:
            self.value += n


class Gauge(object):
    kind = "gauge"

    def __init__(self, name):
        self.name = name
        self.value = 0.0

    def set(self, value):
        self.value = value


#: histogram bucket upper bounds — log-spaced seconds
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                   0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                   10.0, 30.0, 60.0)


class Histogram(object):
    """Cumulative-bucket histogram and a bounded reservoir of the
    recent observations for percentiles."""

    kind = "histogram"
    #: observations the reservoir keeps
    WINDOW = 2048

    def __init__(self, name, buckets=DEFAULT_BUCKETS):
        self.name = name
        self.buckets = tuple(sorted(buckets))
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # +Inf last
        self.count = 0
        self.sum = 0.0
        self._recent = collections.deque(maxlen=self.WINDOW)
        self._lock = locksmith.lock("telemetry.metric")

    def observe(self, value, count=1):
        value = float(value)
        i = len(self.buckets)
        for k, bound in enumerate(self.buckets):
            if value <= bound:
                i = k
                break
        with self._lock:
            self.bucket_counts[i] += count
            self.count += count
            self.sum += value * count
            self._recent.extend([value] * min(int(count), 256))

    def percentile(self, p):
        """``p`` in [0, 100] over the recent observations (None when
        there are none)."""
        with self._lock:
            data = sorted(self._recent)
        if not data:
            return None
        return data[max(0, min(len(data) - 1,
                               int(round(p / 100.0 * (len(data) - 1)))))]

    def stats(self):
        st = {"count": self.count, "sum": round(self.sum, 6)}
        if self.count:
            st.update({"p50": self.percentile(50),
                       "p99": self.percentile(99)})
        return st


_metrics = {}


def _get_metric(name, factory):
    if not enabled():
        return _NULL_METRIC
    with _lock:
        m = _metrics.get(name)
        if m is None:
            m = _metrics[name] = factory(name)
    return m


def counter(name):
    return _get_metric(name, Counter)


def gauge(name):
    return _get_metric(name, Gauge)


def histogram(name):
    return _get_metric(name, Histogram)


def labeled(name, **labels):
    """Per-key series naming: labels become sorted ``key_value`` dotted
    suffixes — ``labeled("serving.predictions", bucket=8)`` is
    ``"serving.predictions.bucket_8"``.  For bounded label sets only."""
    if not labels:
        return name
    return name + "." + ".".join(
        "%s_%s" % (k, labels[k]) for k in sorted(labels))


#: one-line help by series-family prefix (the longest dotted prefix
#: of a series name wins), the JAX package's table less its ``jax``
#: compile family; modules register their own families
_HELP = {
    "analysis": "static/runtime analysis layer (graftlint, locksmith)",
    "faults": "deterministic fault injection (core/faults.py)",
    "health": "numeric training-health monitor (core/health.py)",
    "launcher": "supervised-restart lifecycle (launcher.py)",
    "loader": "minibatch loader pipeline",
    "memory": "device-memory ledger (core/profiler.py)",
    "profiler": "performance introspection (core/profiler.py)",
    "registry": "multi-model registry lifecycle "
                "(serving/registry.py)",
    "serving.request_seconds": "end-to-end request latency "
                               "(admission to reply)",
    "serving.queue_wait_seconds": "time queued before a dispatch "
                                  "slot took the request",
    "serving.assembly_seconds": "batch concatenation time",
    "serving.device_seconds": "engine dispatch time per request",
    "serving.batch_rows": "coalesced rows per dispatch",
    "serving.batch_fill": "coalesced rows over the dispatched bucket",
    "serving.pad_overhead": "padding fraction of the dispatched "
                            "bucket",
    "serving.tail_seconds": "per-scenario batch-1 tail latency "
                            "(serving/latency.py)",
    "serving": "online inference serving tier (znicz_tpu/serving/)",
    "snapshotter": "snapshot export/restore (core/snapshotter.py)",
    "trainer": "fused training control plane",
    "transfer": "host<->device transfer meters",
    "unit": "unit-graph execution",
    "workflow": "workflow lifecycle",
}


def register_help(prefix, text):
    """Register (or override) the one-line help of a series family;
    returns ``prefix``."""
    _HELP[str(prefix)] = str(text)
    return prefix


def help_for(name):
    """The help of a dotted series name: the longest registered dotted
    prefix wins, else a generic family line."""
    parts = name.split(".")
    for i in range(len(parts), 0, -1):
        text = _HELP.get(".".join(parts[:i]))
        if text is not None:
            return text
    return "znicz_tpu telemetry series (family %s)" % parts[0]


def _prom_name(name):
    """Sanitize a dotted series name into Prometheus [a-zA-Z0-9_:]."""
    s = "".join(ch if (ch.isalnum() and ch.isascii()) or ch in "_:"
                else "_" for ch in name)
    return "znicz_" + s


def _fmt(v):
    return repr(float(v)) if isinstance(v, float) else str(v)


def prometheus_text():
    """Prometheus text exposition (format 0.0.4) of the registry."""
    with _lock:
        metrics = sorted(_metrics.values(), key=lambda m: m.name)
    lines = []
    for m in metrics:
        name = _prom_name(m.name)
        lines.append("# TYPE %s %s" % (name, m.kind))
        if m.kind != "histogram":
            lines.append("%s %s" % (name, _fmt(m.value)))
            continue
        # one consistent view: +Inf bucket == count
        with m._lock:
            counts, total, count = list(m.bucket_counts), m.sum, m.count
        acc = 0
        for bound, c in zip(m.buckets, counts):
            acc += c
            lines.append('%s_bucket{le="%s"} %d' % (name, _fmt(bound), acc))
        lines.append('%s_bucket{le="+Inf"} %d' % (name, acc + counts[-1]))
        lines.append("%s_sum %s" % (name, _fmt(total)))
        lines.append("%s_count %d" % (name, count))
    return "\n".join(lines) + "\n"


def reset():
    """Drop every metric and the journal (tests: one test's events must
    not reach the next one's crash report)."""
    with _lock:
        _metrics.clear()
    _journal.clear()
    _trace.clear()


def snapshot():
    """A JSON-able view of every registered metric."""
    with _lock:
        metrics = list(_metrics.values())
    snap = {"counters": {}, "gauges": {}, "histograms": {}}
    for m in metrics:
        if m.kind == "histogram":
            snap["histograms"][m.name] = m.stats()
        else:
            snap[m.kind + "s"][m.name] = m.value
    return snap


def add_bytes(direction, nbytes):
    """The host-device transfer meter (``direction`` "d2h" or "h2d";
    JAX :626-631): ``transfer.<direction>_bytes`` and ``_calls``.  Call
    sites guard with :func:`enabled`."""
    counter("transfer.%s_bytes" % direction).inc(int(nbytes))
    counter("transfer.%s_calls" % direction).inc()


def merged_snapshot():
    """:func:`snapshot`, reduced over the ranks of a multi-process run
    (one merged view of the gang; a collective every rank calls); the
    snapshot itself in one process."""
    snap = snapshot()
    from znicz_tpu_torch.parallel.mesh import world
    if world()[1] > 1:
        from znicz_tpu_torch.parallel import multihost
        try:
            snap = multihost.aggregate_telemetry(snap)
        except RuntimeError as e:
            logger.warning("telemetry aggregation failed (%s); "
                           "reporting this rank only", e)
    return snap


def summary():
    """The compact why-block a report stamps: transfer bytes, the fused
    trainer's readbacks and shard extents, step-time percentiles and
    the serving block (:func:`serving_summary`)."""
    snap = snapshot()
    c, h, g = snap["counters"], snap["histograms"], snap["gauges"]
    out = {"d2h_bytes": int(c.get("transfer.d2h_bytes", 0)),
           "d2h_calls": int(c.get("transfer.d2h_calls", 0)),
           "h2d_bytes": int(c.get("transfer.h2d_bytes", 0))}
    if "trainer.readbacks" in c:
        out["readbacks"] = int(c["trainer.readbacks"])
    if "trainer.data_shards" in g:
        out["data_shards"] = int(g["trainer.data_shards"])
        out["model_shards"] = int(g.get("trainer.model_shards", 1))
    steps = h.get("trainer.step_seconds") or h.get("unit.run_seconds")
    if steps and steps.get("count"):
        out["step_seconds"] = {"count": steps["count"],
                               "p50": steps.get("p50"),
                               "p99": steps.get("p99")}
    serving = serving_summary(snap)
    if serving is not None:
        out["serving"] = serving
    return out


def serving_summary(snap=None):
    """The serving tier's why-block (requests, rejections, latency p50
    and p99, batch fill, queue wait and device p50); None when no
    request was served."""
    snap = snap or snapshot()
    c, h = snap["counters"], snap["histograms"]
    lat = h.get("serving.request_seconds")
    if not lat or not lat.get("count"):
        return None
    out = {
        "requests": int(lat["count"]),
        "latency_p50_ms": (round(lat["p50"] * 1e3, 3)
                           if lat.get("p50") is not None else None),
        "latency_p99_ms": (round(lat["p99"] * 1e3, 3)
                           if lat.get("p99") is not None else None),
        "rejected": int(c.get("serving.rejected", 0)),
        "timeouts": int(c.get("serving.timeouts", 0)),
        "batches": int(c.get("serving.batches", 0)),
    }
    fill = h.get("serving.batch_fill")
    if fill and fill.get("count"):
        out["batch_fill_p50"] = fill.get("p50")
    for series, key in (("serving.queue_wait_seconds", "queue_wait_p50_ms"),
                        ("serving.device_seconds", "device_p50_ms")):
        part = h.get(series)
        if part and part.get("count") and part.get("p50") is not None:
            out[key] = round(part["p50"] * 1e3, 3)
    compiles = {name: int(v) for name, v in c.items()
                if name.startswith("serving.compiles.")}
    if compiles:
        out["bucket_compiles"] = compiles
    return out


_PROM_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? [0-9eE+.-]+$")


def parse_prometheus(text):
    """Validate a Prometheus text exposition and return ``{family:
    type}``; a malformed sample line raises ``ValueError``."""
    families = {}
    for line in text.strip().splitlines():
        if line.startswith("# TYPE "):
            _, _, fam, kind = line.split()
            families[fam] = kind
        elif line.startswith("#") or not line:
            continue
        elif not _PROM_SAMPLE_RE.match(line):
            raise ValueError("bad exposition line: %r" % line)
    return families


# -- the flight recorder -----------------------------------------------------

class _Ring(object):
    """Bounded event buffer, oldest dropped first; its capacity is
    ``capacity``, else read from
    ``root.common.telemetry.journal_capacity`` at the first append."""

    def __init__(self, capacity=None):
        self._capacity = capacity
        self._events = None
        self.dropped = 0
        self._lock = locksmith.lock("telemetry.ring")

    def append(self, ev):
        with self._lock:
            if self._events is None:
                self._events = collections.deque(
                    maxlen=self._capacity or
                    int(_cfg.get("journal_capacity", 4096)))
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    def clear(self):
        with self._lock:
            self._events = None
            self.dropped = 0

    def __len__(self):
        return 0 if self._events is None else len(self._events)

    def events(self):
        with self._lock:
            return [] if self._events is None else list(self._events)


_journal = _Ring()
#: the markers of :func:`instant` (JAX's ``trace_capacity`` default)
TRACE_CAPACITY = 65536
_trace = _Ring(TRACE_CAPACITY)


def instant(name, **attrs):
    """A zero-length marker (an epoch's end, a release step), recorded
    while telemetry is on."""
    if not enabled():
        return
    _trace.append(("i", name, (time.perf_counter() - _T0) * 1e6, 0.0,
                   threading.get_ident(), attrs or None))


def trace_events():
    """The recorded markers as Chrome-trace events, ``pid`` the
    process's rank in the ``torch.distributed`` world."""
    from znicz_tpu_torch.parallel.mesh import world
    pid = world()[0]
    out = []
    for ph, name, ts, _, tid, args in _trace.events():
        ev = {"name": name, "ph": ph, "ts": round(ts, 3), "pid": pid,
              "tid": tid, "cat": "znicz", "s": "t"}
        if args:
            ev["args"] = args
        out.append(ev)
    return out


def journal_enabled():
    """The journal records while telemetry, the health monitor, the
    fault registry or the durable blackbox is on: a chaos run must
    journal what it injected and how recovery went, a health-only run
    wants its black box, and an armed blackbox
    (:mod:`znicz_tpu_torch.core.blackbox`) persists the events."""
    return bool(_cfg.get("enabled", False)
                or root.common.health.get("enabled", False)
                or root.common.faults.get("enabled", False)
                or _cfg.blackbox.get("enabled", False))


#: the write-through sink: the armed blackbox installs a callable here
#: and every journal event also lands on disk when it is emitted (a
#: ring dumped at a crash cannot help a SIGKILLed process); None in
#: every process without one
_journal_sink = None


def set_journal_sink(fn):
    """Install (or, with None, remove) the durable write-through
    journal sink.  A sink that raises is swallowed where the event is
    emitted: instrumentation never takes down what it instruments."""
    global _journal_sink
    _journal_sink = fn


def record_event(kind, **fields):
    """Append one event (a dict stamped with wall time and seconds
    since import) to the journal, hand it to the journal sink when one
    is installed, and return it; None, and nothing recorded, when
    :func:`journal_enabled` is false."""
    if not journal_enabled():
        return None
    ev = {"t": round(time.time(), 6),
          "elapsed": round(time.perf_counter() - _T0, 6), "kind": kind}
    ev.update(fields)
    _journal.append(ev)
    sink = _journal_sink
    if sink is not None:
        try:
            sink(ev)
        except Exception:  # noqa: BLE001 - never fail the emitter
            logger.debug("journal sink failed", exc_info=True)
    return ev


def journal_events():
    """The journal's events, oldest first."""
    return _journal.events()


def journal_dropped():
    return _journal.dropped


def export_journal(path):
    """Write the journal as JSON lines, whatever the gate says now (a
    crash dump must not depend on live config); returns ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for ev in _journal.events():
            f.write(json.dumps(ev, default=str) + "\n")
    return path


def write_crash_report(reason="unhandled-exception", exc_info=None,
                       directory=None):
    """Dump the black box into a fresh directory and return its path:
    ``events.jsonl`` (the journal), ``metrics.json``, ``traceback.txt``
    (``exc_info`` or the exception being handled, when there is one)
    and ``report.json`` (reason, time, pid, journal counts).  The
    directory is ``directory``, else ``root.common.health.crash_dir``,
    else ``<root.common.dirs.cache>/crash_reports``."""
    import sys
    import traceback
    base = (directory or root.common.health.get("crash_dir", None)
            or os.path.join(root.common.dirs.cache, "crash_reports"))
    stamp = time.strftime("%Y%m%d_%H%M%S")
    path = os.path.join(base, "crash_%s_pid%d" % (stamp, os.getpid()))
    n = 0
    while os.path.exists(path):   # the same second and pid: keep both
        n += 1
        path = os.path.join(base, "crash_%s_pid%d_%d"
                            % (stamp, os.getpid(), n))
    os.makedirs(path)
    export_journal(os.path.join(path, "events.jsonl"))
    with open(os.path.join(path, "metrics.json"), "w") as f:
        json.dump(snapshot(), f, indent=2, default=str)
    exc_info = exc_info or sys.exc_info()
    if exc_info and exc_info[0] is not None:
        with open(os.path.join(path, "traceback.txt"), "w") as f:
            f.write("".join(traceback.format_exception(*exc_info)))
    try:
        from znicz_tpu_torch.core import blackbox
        blackbox_segment = blackbox.current_segment()
    except Exception:  # noqa: BLE001 - a crash dump must not crash
        blackbox_segment = None
    with open(os.path.join(path, "report.json"), "w") as f:
        json.dump({"reason": str(reason), "time": time.time(),
                   "pid": os.getpid(), "journal_events": len(_journal),
                   "journal_dropped": _journal.dropped,
                   "blackbox_segment": blackbox_segment}, f, indent=2)
    logger.error("crash report -> %s (%s)", path, reason)
    return path


_crash_handler_installed = False


def install_crash_handler():
    """Chain a crash-dumping ``sys.excepthook`` and SIGTERM handler
    (once).  Both dump only when :func:`journal_enabled`; an exception
    that carries its report (``crash_report``) is not dumped twice.
    The SIGTERM handler re-raises the signal under the disposition it
    found, and leaves an ignored SIGTERM ignored."""
    global _crash_handler_installed
    if _crash_handler_installed:
        return True
    import signal
    import sys
    prev_hook = sys.excepthook

    def hook(tp, val, tb):
        try:
            if journal_enabled() and \
                    getattr(val, "crash_report", None) is None:
                write_crash_report(reason=repr(val), exc_info=(tp, val, tb))
        except Exception:  # noqa: BLE001 - never mask the real crash
            pass
        prev_hook(tp, val, tb)

    sys.excepthook = hook
    try:
        prev_term = signal.getsignal(signal.SIGTERM)

        def on_term(signum, frame):
            try:
                if journal_enabled():
                    write_crash_report(reason="fatal signal SIGTERM")
            except Exception:  # noqa: BLE001 - still die properly
                pass
            if prev_term == signal.SIG_IGN:
                return
            signal.signal(signal.SIGTERM, prev_term if prev_term is not None
                          else signal.SIG_DFL)
            os.kill(os.getpid(), signum)

        signal.signal(signal.SIGTERM, on_term)
    except (ValueError, OSError):   # not the main thread
        pass
    _crash_handler_installed = True
    return True
