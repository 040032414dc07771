"""Tail latency: exact quantiles, per-scenario series and the
adversarial scenario runners.

Counterpart of ``znicz_tpu/serving/latency.py`` (``exact_percentile``
:58, ``quantile_summary`` :82, ``record_scenario`` :107, the runners
:139-257):

* **Exact quantiles** (:func:`exact_percentile`,
  :func:`quantile_summary`): sorted order statistics with linear
  interpolation (``numpy.percentile``'s "linear" method) over retained
  samples — no bucketed approximation;
* **Per-scenario series** (:func:`record_scenario`): each scenario's
  latencies land in their own histogram
  ``serving.tail_seconds.scenario_<name>`` (plus ``model_<name>``);
* **Scenario runners** (:func:`run_steady`, :func:`run_cold_bucket`,
  :func:`run_evict_restore`, :func:`run_breaker_probe`): the
  adversarial mixes, timed around :meth:`InferenceEngine.predict` —
  the path a request pays (pad, breaker admission, the forward and its
  host readback, the slice).
"""

import math
import time

import numpy

from znicz_tpu_torch.core import faults, telemetry
from znicz_tpu_torch.core.config import root

#: the tail quantiles every report carries, in reporting order
QUANTILES = (50.0, 95.0, 99.0, 99.9)

#: the adversarial scenario vocabulary (the bounded ``scenario_<name>``
#: label set of the ``serving.tail_seconds`` series)
SCENARIOS = ("steady", "cold_bucket", "evict_restore", "breaker_probe")

#: the per-scenario histogram family
SERIES = "serving.tail_seconds"


# -- exact quantiles --------------------------------------------------------

def exact_percentile(samples, q):
    """Exact quantile of retained samples: sort, then interpolate
    linearly between the two order statistics around rank
    ``q/100 * (n-1)``.  An empty sequence gives None; one sample is
    every quantile; q <= 0 / q >= 100 give the min / max."""
    data = sorted(float(v) for v in samples)
    if not data:
        return None
    if q <= 0.0:
        return data[0]
    if q >= 100.0:
        return data[-1]
    rank = (q / 100.0) * (len(data) - 1)
    lo = int(math.floor(rank))
    hi = min(lo + 1, len(data) - 1)
    frac = rank - lo
    return data[lo] * (1.0 - frac) + data[hi] * frac


def quantile_summary(samples_s):
    """The tail block over latencies in SECONDS: count, mean, min, max
    and the :data:`QUANTILES` in milliseconds (``p50_ms`` ...
    ``p999_ms``); None-valued keys when there are no samples — a
    consumer must see the hole, not a zero."""
    samples_s = sorted(float(s) for s in samples_s)
    out = {"count": len(samples_s)}
    for q in QUANTILES:
        key = "p%s_ms" % ("%g" % q).replace(".", "")
        v = exact_percentile(samples_s, q)
        out[key] = round(v * 1e3, 4) if v is not None else None
    if samples_s:
        out["mean_ms"] = round(1e3 * sum(samples_s) / len(samples_s), 4)
        out["min_ms"] = round(1e3 * samples_s[0], 4)
        out["max_ms"] = round(1e3 * samples_s[-1], 4)
    else:
        out["mean_ms"] = out["min_ms"] = out["max_ms"] = None
    return out


# -- per-scenario series ----------------------------------------------------

def record_scenario(scenario, seconds, model=None):
    """One scenario latency into its histogram (a no-op while telemetry
    is off).  An unknown scenario name raises: the label set is
    :data:`SCENARIOS`, never free-form."""
    if scenario not in SCENARIOS:
        raise ValueError("unknown tail-latency scenario %r (known: %s)"
                         % (scenario, "/".join(SCENARIOS)))
    if not telemetry.enabled():
        return
    labels = {"scenario": scenario}
    if model:
        labels["model"] = model
    # the label set is bounded by the SCENARIOS check above and the
    # model names
    telemetry.histogram(
        telemetry.labeled(  # graftlint: disable=telemetry-cardinality
            SERIES, **labels)).observe(float(seconds))


def timed_predict(engine, x, scenario):
    """One engine dispatch timed into the scenario's series; returns
    ``(reply, seconds)``."""
    t0 = time.perf_counter()
    y = engine.predict(x)
    dt = time.perf_counter() - t0
    record_scenario(scenario, dt, model=engine.name)
    return y, dt


# -- scenario runners -------------------------------------------------------

def run_steady(engine, x, n=200):
    """Steady state: ``n`` warm dispatches of ``x``.  Returns
    ``(samples_s, elapsed_s)``: the per-request latencies and the wall
    time of the whole loop (the req/s denominator)."""
    engine.predict(x)  # the bucket is warm before timing
    samples = []
    t0 = time.perf_counter()
    for _ in range(int(n)):
        _, dt = timed_predict(engine, x, "steady")
        samples.append(dt)
    return samples, time.perf_counter() - t0


def run_cold_bucket(make_engine, sample_shape, dtype=numpy.float32,
                    trials=2):
    """A bucket's first hit on the request path: a fresh engine a trial
    (``make_engine()`` builds with ``warmup=False``), then the first
    request of every bucket.  Returns those first-hit latencies."""
    samples = []
    for _ in range(int(trials)):
        engine = make_engine()
        for bucket in engine.buckets:
            x = numpy.zeros((int(bucket),) + tuple(sample_shape),
                            dtype=dtype)
            _, dt = timed_predict(engine, x, "cold_bucket")
            samples.append(dt)
    return samples


def run_evict_restore(engine, x, n=3):
    """Evict, then time the next request, which pays the restore (the
    parameters' upload and the re-warm) and its own dispatch.  Returns
    ``(samples_s, replies)`` so a caller can hold the restored answers
    to the right ones."""
    samples, replies = [], []
    for _ in range(int(n)):
        engine.evict()
        y, dt = timed_predict(engine, x, "evict_restore")
        samples.append(dt)
        replies.append(y)
    return samples, replies


def run_breaker_probe(engine, x, trials=2, settle_s=5.0):
    """The breaker's half-open probe: open the request bucket's breaker
    with injected ``serving.forward`` faults (retries off meanwhile),
    wait out the cooldown, then time the probe — the first request
    through a recovering bucket.  Returns ``(samples_s, replies)``; the
    fault is cleared before the probe, so each reply must be right.
    The knobs touched are restored and the fault registry reset on
    exit."""
    cfg = root.common.serving
    saved = {
        "faults_enabled": bool(root.common.faults.get("enabled", False)),
        "retry_attempts": root.common.retry.get("attempts", 3),
        "threshold": cfg.get("breaker_threshold", 5),
        "cooldown_ms": cfg.get("breaker_cooldown_ms", 1000.0),
    }
    threshold, cooldown_ms = 2, 50.0
    samples, replies = [], []
    from znicz_tpu_torch.serving.breaker import CircuitOpenError
    try:
        root.common.retry.attempts = 0
        cfg.breaker_threshold = threshold
        cfg.breaker_cooldown_ms = cooldown_ms
        engine.predict(x)  # warm the bucket and make its breaker
        for _ in range(int(trials)):
            root.common.faults.enabled = True
            faults.install("serving.forward", kind="io", every=1,
                           times=threshold)
            for _ in range(threshold):
                try:
                    engine.predict(x)
                except OSError:
                    pass  # the injected fault, counted by the breaker
            faults.clear("serving.forward")
            root.common.faults.enabled = saved["faults_enabled"]
            deadline = time.monotonic() + settle_s
            while time.monotonic() < deadline:
                time.sleep(cooldown_ms / 1e3)
                try:
                    y, dt = timed_predict(engine, x, "breaker_probe")
                except CircuitOpenError:
                    continue  # still cooling down
                samples.append(dt)
                replies.append(y)
                break
            else:
                raise RuntimeError(
                    "breaker never admitted the half-open probe within "
                    "%.1fs" % settle_s)
    finally:
        faults.clear("serving.forward")
        faults.reset()
        root.common.faults.enabled = saved["faults_enabled"]
        root.common.retry.attempts = saved["retry_attempts"]
        cfg.breaker_threshold = saved["threshold"]
        cfg.breaker_cooldown_ms = saved["cooldown_ms"]
    return samples, replies
