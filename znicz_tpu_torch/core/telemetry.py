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
violations, skipped snapshots) to a bounded journal, and
:func:`write_crash_report` dumps it with the metrics and the traceback
into a fresh directory under ``root.common.health.crash_dir`` (default
``<root.common.dirs.cache>/crash_reports``); the launcher and the
health monitor's ``halt`` policy call it, and
:func:`install_crash_handler` chains it into ``sys.excepthook`` and
SIGTERM.

The JAX package's spans and their trace ring feed its ``/debug/trace``
endpoint, which this port does not have yet; they come with it.

The metrics sit behind one gate, ``root.common.telemetry.enabled``:
when it is off the factories hand out a shared no-op and nothing is
recorded.  The journal records while telemetry, the health monitor or
the fault registry is on (:func:`journal_enabled`).
"""

import collections
import json
import logging
import os
import threading
import time

from znicz_tpu_torch.core.config import root

_cfg = root.common.telemetry
_lock = threading.Lock()
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
        self._lock = threading.Lock()

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
        self._lock = threading.Lock()

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


# -- the flight recorder -----------------------------------------------------

class _Ring(object):
    """Bounded event buffer, oldest dropped first; its capacity is read
    from ``root.common.telemetry.journal_capacity`` at the first
    append."""

    def __init__(self):
        self._events = None
        self.dropped = 0
        self._lock = threading.Lock()

    def append(self, ev):
        with self._lock:
            if self._events is None:
                self._events = collections.deque(
                    maxlen=int(_cfg.get("journal_capacity", 4096)))
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


def journal_enabled():
    """The journal records while telemetry, the health monitor or the
    fault registry is on: a chaos run must journal what it injected
    and how recovery went, a health-only run wants its black box."""
    return bool(_cfg.get("enabled", False)
                or root.common.health.get("enabled", False)
                or root.common.faults.get("enabled", False))


def record_event(kind, **fields):
    """Append one event (a dict stamped with wall time and seconds
    since import) to the journal and return it; None, and nothing
    recorded, when :func:`journal_enabled` is false."""
    if not journal_enabled():
        return None
    ev = {"t": round(time.time(), 6),
          "elapsed": round(time.perf_counter() - _T0, 6), "kind": kind}
    ev.update(fields)
    _journal.append(ev)
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
    with open(os.path.join(path, "report.json"), "w") as f:
        json.dump({"reason": str(reason), "time": time.time(),
                   "pid": os.getpid(), "journal_events": len(_journal),
                   "journal_dropped": _journal.dropped}, f, indent=2)
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
