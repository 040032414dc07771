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

The JAX package's spans and their trace ring feed its ``/debug/trace``
endpoint, which this port does not have yet; they come with it.

Everything sits behind one gate, ``root.common.telemetry.enabled``:
when it is off the factories hand out a shared no-op and nothing is
recorded.
"""

import threading

from znicz_tpu_torch.core.config import root

_cfg = root.common.telemetry
_lock = threading.Lock()


def enabled():
    """The one gate every hook checks (live config read)."""
    return bool(_cfg.get("enabled", False))


def enable():
    _cfg.enabled = True


# -- metrics ----------------------------------------------------------------

class _NullMetric(object):
    __slots__ = ()

    def inc(self, n=1):
        pass

    def set(self, value):
        pass

    def observe(self, value):
        pass


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
    """Cumulative-bucket histogram."""

    kind = "histogram"

    def __init__(self, name, buckets=DEFAULT_BUCKETS):
        self.name = name
        self.buckets = tuple(sorted(buckets))
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # +Inf last
        self.count = 0
        self.sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value):
        value = float(value)
        i = len(self.buckets)
        for k, bound in enumerate(self.buckets):
            if value <= bound:
                i = k
                break
        with self._lock:
            self.bucket_counts[i] += 1
            self.count += 1
            self.sum += value


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
