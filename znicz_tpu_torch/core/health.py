"""Numeric training-health monitor — detect failure, do not just log it.

Counterpart of ``znicz_tpu/core/health.py``, with its names and config
keys (``root.common.health``):

* :func:`pytree_health` — per named pytree (params, grads, updates) a
  NaN flag, an Inf flag and the sum of squares, as an ``(n, 3)`` array:
  a plain PyTorch multi-tensor reduction on the trees' device (the JAX
  package's is a jitted XLA reduction, no Pallas) and one small
  readback a clean check;
* :class:`DivergenceDetector` — an EMA and window-slope test over the
  decision's per-epoch training metric: it trips on a non-finite loss,
  on a loss past ``divergence_factor`` times its EMA, and on a rise
  across a full window;
* the policies — every violation is counted and journaled, then
  ``root.common.health.policy`` decides: ``warn`` logs, ``snapshot``
  also exports through the workflow's snapshotter, ``halt`` writes a
  crash report and raises :class:`HealthViolationError`, which the
  supervised launcher never restarts.

The call sites (the fused trainer's windows and steps, the unit
graph's GD units, the decision's TRAIN epoch end) guard with
``if health.enabled():``, one config read.  ``GET /debug/health``
serves :func:`status`.
"""

import collections
import logging
import math
import time

import numpy
import torch

from znicz_tpu_torch.analysis import locksmith
from znicz_tpu_torch.core import telemetry
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.memory import DEV, SYNC, Array, host_fetch

logger = logging.getLogger("health")

_cfg = root.common.health

#: violation policies, mildest first
POLICIES = ("warn", "snapshot", "halt")


class HealthViolationError(RuntimeError):
    """Typed error the ``halt`` policy raises — catch it to distinguish
    "training went numerically bad" from infrastructure failures.
    Carries the violation dict and the crash-report path."""

    def __init__(self, reason, violation=None, crash_report=None):
        super(HealthViolationError, self).__init__(reason)
        self.violation = violation or {}
        self.crash_report = crash_report


def enabled():
    """The one gate every check site tests.  Reads the live config so
    flipping ``root.common.health.enabled`` mid-run takes effect on the
    next step."""
    return bool(_cfg.get("enabled", False))


def enable(**overrides):
    """Turn the monitor on (optionally overriding config knobs)."""
    for k, v in overrides.items():
        setattr(root.common.health, k, v)
    root.common.health.enabled = True
    return True


def disable():
    root.common.health.enabled = False
    return False


# ---------------------------------------------------------------------------
# The pytree health reduction
# ---------------------------------------------------------------------------

def _leaves(tree):
    """The tensor and array leaves of a pytree of dicts, lists and
    tuples (None leaves dropped), in order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _as_float(leaf):
    t = torch.as_tensor(leaf)
    return t if t.is_floating_point() else t.double()


def _leaf_norms(flat):
    """The L2 norm of each leaf in float64 on the host, in one readback:
    one multi-tensor reduction for the float64 leaves and one for the
    rest (in float32, as the JAX reduction squares them)."""
    dev = flat[0].device
    groups = [[i for i, l in enumerate(flat) if l.dtype == torch.float64],
              [i for i, l in enumerate(flat) if l.dtype != torch.float64]]
    stacks = [torch.stack([t.to(dev) for t in torch._foreach_norm(
        [flat[i] for i in idx], 2,
        dtype=torch.float64 if k == 0 else torch.float32)])
        for k, idx in enumerate(groups) if idx]
    norms = numpy.zeros(len(flat))
    for idx, got in zip([g for g in groups if g], host_fetch(stacks)):
        norms[idx] = got
    return norms


def _health_rows(trees):
    """The ``(n, 3)`` float64 rows ``[NaN flag, Inf flag, sum of
    squares]`` of the named trees, sorted by name, as one host array.

    Every leaf's L2 norm comes from one multi-tensor reduction on the
    leaves' device (a few launches for the whole tree, not a few a
    leaf) and crosses in one readback.  A NaN or an Inf makes a leaf's
    norm non-finite, so only such a leaf, or one whose squares
    overflowed, is asked for its NaN and Inf flags, in a second
    readback: a clean check costs one."""
    names = sorted(trees)
    leaves = {n: [_as_float(l) for l in _leaves(trees[n])] for n in names}
    flat = [l for n in names for l in leaves[n] if l.numel()]
    norms = _leaf_norms(flat) if flat else numpy.zeros(0)
    flags = numpy.zeros((len(flat), 2), bool)
    bad = numpy.flatnonzero(~numpy.isfinite(norms))
    if len(bad):
        dev = flat[0].device
        flags[bad] = host_fetch(torch.stack([
            torch.stack([torch.isnan(flat[i]).any(),
                         torch.isinf(flat[i]).any()]).to(dev)
            for i in bad]))
    rows, k = numpy.zeros((len(names), 3)), 0
    for row, n in zip(rows, names):
        m = sum(1 for l in leaves[n] if l.numel())
        row[0], row[1] = flags[k:k + m].any(axis=0)
        row[2] = float(numpy.square(norms[k:k + m]).sum())
        k += m
    return rows


def pytree_health(**trees):
    """Check named pytrees (None values skipped) in one pass on their
    device and one small readback; returns ``{"nan": bool, "inf":
    bool, "norms": {name: l2}, "non_finite": [names]}``."""
    trees = {k: v for k, v in trees.items() if v is not None}
    if not trees:
        return {"nan": False, "inf": False, "norms": {},
                "non_finite": []}
    res = _health_rows(trees)
    names = sorted(trees)
    report = {"norms": {}, "non_finite": []}
    for i, name in enumerate(names):
        nan, inf, sq = (bool(res[i, 0]), bool(res[i, 1]),
                        float(res[i, 2]))
        report["norms"][name] = (float("nan") if math.isnan(sq)
                                 else math.sqrt(max(sq, 0.0)))
        if nan or inf:
            report["non_finite"].append(name)
        report["nan"] = report.get("nan", False) or nan
        report["inf"] = report.get("inf", False) or inf
    report.setdefault("nan", False)
    report.setdefault("inf", False)
    return report


def _peek(arr):
    """The authoritative side of a :class:`memory.Array` (its device
    tensor or its host array) without a transfer either way."""
    if not isinstance(arr, Array) or not arr:
        return None
    if arr._state in (DEV, SYNC) and arr._dev is not None:
        return arr._dev
    return arr._host


# ---------------------------------------------------------------------------
# Loss-divergence detector
# ---------------------------------------------------------------------------

class DivergenceDetector(object):
    """Rolling train-metric watcher: EMA explosion test + window-slope
    test.  Feed it one scalar per epoch (error %, avg mse, loss);
    :meth:`observe` returns a violation string or None."""

    def __init__(self, window=None, ema_alpha=None, factor=None,
                 rise=None):
        self.window = int(window if window is not None
                          else _cfg.get("loss_window", 8))
        self.alpha = float(ema_alpha if ema_alpha is not None
                           else _cfg.get("loss_ema_alpha", 0.3))
        self.factor = float(factor if factor is not None
                            else _cfg.get("divergence_factor", 3.0))
        self.rise = float(rise if rise is not None
                          else _cfg.get("loss_rise", 0.1))
        self.ema = None
        self.history = collections.deque(maxlen=max(self.window, 2))

    def observe(self, value):
        value = float(value)
        if not math.isfinite(value):
            return "non-finite loss %r" % value
        prev_ema = self.ema
        self.history.append(value)
        self.ema = (value if prev_ema is None
                    else self.alpha * value
                    + (1.0 - self.alpha) * prev_ema)
        if prev_ema is not None and value > prev_ema and \
                value > self.factor * max(abs(prev_ema), 1e-12):
            return ("loss %.6g exploded past %.3gx its EMA %.6g"
                    % (value, self.factor, prev_ema))
        if len(self.history) == self.history.maxlen:
            slope = self._slope()
            first, last = self.history[0], self.history[-1]
            if slope > 0 and \
                    last > first + self.rise * max(abs(first), 1e-12):
                return ("loss rising for %d observations "
                        "(%.6g -> %.6g, slope %.3g/step)"
                        % (len(self.history), first, last, slope))
        return None

    def _slope(self):
        """OLS slope of the window against its index."""
        n = len(self.history)
        mx = (n - 1) / 2.0
        my = sum(self.history) / n
        num = sum((i - mx) * (y - my)
                  for i, y in enumerate(self.history))
        den = sum((i - mx) ** 2 for i in range(n))
        return num / den

    def state(self):
        return {"ema": self.ema, "window": list(self.history)}


# ---------------------------------------------------------------------------
# The monitor
# ---------------------------------------------------------------------------

class HealthMonitor(object):
    """Process-global check state: interval bookkeeping, last report,
    bounded violation history, the divergence detector."""

    VIOLATION_HISTORY = 64

    def __init__(self):
        self.detector = DivergenceDetector()
        self.checks = 0
        self.violation_count = 0
        self.last_report = None
        self.last_violation = None
        self.violations = collections.deque(
            maxlen=self.VIOLATION_HISTORY)
        self._steps = 0
        self._next_check = 0
        self._lock = locksmith.lock("health.monitor")

    # -- interval ------------------------------------------------------------
    def due(self, steps=1):
        """Advance the step counter by ``steps``; True when a check is
        due (every ``interval`` steps — a window of K minibatches
        advances K at once and triggers at most one check)."""
        with self._lock:
            self._steps += steps
            if self._steps >= self._next_check:
                interval = max(int(_cfg.get("interval", 1)), 1)
                self._next_check = self._steps + interval
                return True
            return False

    # -- checking ------------------------------------------------------------
    def check(self, unit=None, context="", **trees):
        """Run :func:`pytree_health` over ``trees``; gauge the norms, verify
        the limits, fire the policy on any violation.  Returns the
        report dict."""
        t0 = time.perf_counter()
        report = pytree_health(**trees)
        dt = time.perf_counter() - t0
        self.checks += 1
        self.last_report = dict(report, context=context)
        if telemetry.enabled():
            telemetry.counter("health.checks").inc()
            telemetry.histogram("health.check_seconds").observe(dt)
            for name, norm in report["norms"].items():
                if math.isfinite(norm):
                    telemetry.gauge("health.%s_norm" % name).set(norm)
        if report["nan"] or report["inf"]:
            what = "NaN" if report["nan"] else "Inf"
            self._violate(
                "%s values in %s" % (what,
                                     ", ".join(report["non_finite"])),
                unit=unit, context=context, report=report)
            return report
        for name, limit_key in (("grads", "grad_norm_limit"),
                                ("params", "param_norm_limit"),
                                ("updates", "update_norm_limit")):
            limit = float(_cfg.get(limit_key, 0.0) or 0.0)
            norm = report["norms"].get(name)
            if limit > 0.0 and norm is not None and norm > limit:
                self._violate(
                    "%s norm %.6g exceeds limit %.6g"
                    % (name.rstrip("s"), norm, limit),
                    unit=unit, context=context, report=report)
        return report

    def observe_loss(self, value, unit=None, source="train"):
        """Feed the divergence detector one scalar; fires the policy on
        a detector violation.  Returns the violation string (or None)."""
        why = self.detector.observe(value)
        if telemetry.enabled() and math.isfinite(float(value)):
            telemetry.gauge("health.loss").set(float(value))
        if why is not None:
            self._violate("divergence: " + why, unit=unit,
                          context=source,
                          report={"loss": float(value),
                                  "detector": self.detector.state()})
        return why

    # -- policy --------------------------------------------------------------
    def _violate(self, reason, unit=None, context="", report=None):
        policy = str(_cfg.get("policy", "warn"))
        if policy not in POLICIES:
            logger.warning("unknown health policy %r; using 'warn'",
                           policy)
            policy = "warn"
        violation = {"time": time.time(), "reason": reason,
                     "policy": policy, "context": context,
                     "unit": getattr(unit, "name", None)}
        if report:
            violation["norms"] = report.get("norms")
        self.violation_count += 1
        self.violations.append(violation)
        self.last_violation = violation
        if telemetry.enabled():
            telemetry.counter("health.violations").inc()
        telemetry.record_event("health.violation", **violation)
        logger.warning("health violation (%s policy): %s%s",
                       policy, reason,
                       " [unit %s]" % violation["unit"]
                       if violation["unit"] else "")
        if policy == "snapshot":
            self._emergency_snapshot(unit, reason)
        elif policy == "halt":
            path = telemetry.write_crash_report(
                reason="health halt: " + reason)
            raise HealthViolationError(reason, violation,
                                       crash_report=path)

    def _emergency_snapshot(self, unit, reason):
        """The ``snapshot`` policy: checkpoint the workflow's state at
        the moment of the anomaly (best-effort — a failing snapshotter
        must not turn a warning into a crash)."""
        wf = getattr(unit, "workflow", None)
        snapshotter = getattr(wf, "snapshotter", None) if wf else None
        if snapshotter is None or not hasattr(snapshotter, "export"):
            logger.warning("snapshot policy: no snapshotter reachable "
                           "from %r; state not captured",
                           getattr(unit, "name", unit))
            return None
        try:
            path = snapshotter.export()
            telemetry.record_event("health.snapshot", path=path,
                                   reason=reason)
            return path
        except Exception as e:  # noqa: BLE001 - best-effort capture
            logger.warning("snapshot policy: export failed (%r)", e)
            return None

    # -- introspection -------------------------------------------------------
    def status(self):
        return {
            "enabled": enabled(),
            "ok": self.violation_count == 0,
            "policy": str(_cfg.get("policy", "warn")),
            "interval": int(_cfg.get("interval", 1)),
            "steps": self._steps,
            "checks": self.checks,
            "violations": self.violation_count,
            "last_violation": self.last_violation,
            "last_report": self.last_report,
            "loss": self.detector.state(),
        }


_monitor_lock = locksmith.lock("health.module")
_monitor = None


def monitor():
    """The process-global monitor (created on first use)."""
    global _monitor
    if _monitor is None:
        with _monitor_lock:
            if _monitor is None:
                _monitor = HealthMonitor()
    return _monitor


def reset():
    """Fresh monitor state (tests, bench isolation)."""
    global _monitor
    with _monitor_lock:
        _monitor = None


# ---------------------------------------------------------------------------
# Call-site API (each site guards with enabled() first)
# ---------------------------------------------------------------------------

def check_training_step(unit=None, steps=1, params=None, grads=None,
                        updates=None, context="train_step"):
    """Fused-trainer hook: advance the step counter by ``steps`` (a
    window is K steps) and, when due, run one check over the given
    pytrees.  Returns the report when a check ran, else None.  A due
    check's small readback waits on the window it inspects (armed at
    interval 1 it paces the pipeline to one window); a check not due
    is a counter bump."""
    if not enabled():
        return None
    m = monitor()
    if not m.due(steps):
        return None
    return m.check(unit=unit, context=context, params=params,
                   grads=grads, updates=updates)


def check_gd_unit(unit):
    """Unit-graph hook: check one GD unit's gradient, weight and update
    Arrays, on whichever side each is authoritative (no transfer is
    forced).  The trees are gathered only when a check is due."""
    if not enabled():
        return None
    m = monitor()
    if not m.due(1):
        return None
    grads = [g for g in (_peek(getattr(unit, "gradient_weights", None)),
                         _peek(getattr(unit, "gradient_bias", None)))
             if g is not None]
    params = [p for p in (_peek(getattr(unit, "weights", None)),
                          _peek(getattr(unit, "bias", None)))
              if p is not None]
    updates = [u for u in (
        _peek(getattr(unit, "gradient_weights_with_moment", None)),
        _peek(getattr(unit, "gradient_bias_with_moment", None)))
        if u is not None]
    return m.check(unit=unit, context="gd:" + getattr(unit, "name", "?"),
                   params=params or None, grads=grads or None,
                   updates=updates or None)


def observe_loss(value, unit=None, source="train"):
    """Decision-path hook: feed the divergence detector one per-epoch
    scalar.  Returns the violation string (or None)."""
    if not enabled():
        return None
    return monitor().observe_loss(value, unit=unit, source=source)


def status():
    """The ``GET /debug/health`` payload — safe to call with the
    monitor off (reports enabled=False and zero counts without
    creating a monitor)."""
    if _monitor is None:
        return {"enabled": enabled(), "ok": True,
                "policy": str(_cfg.get("policy", "warn")),
                "interval": int(_cfg.get("interval", 1)),
                "steps": 0, "checks": 0, "violations": 0,
                "last_violation": None, "last_report": None,
                "loss": {"ema": None, "window": []}}
    return monitor().status()


def summary():
    """Checks run, violations and, when telemetry was on too, the
    check's p50 seconds.  The counts come from the monitor (right on
    health-only runs, where the telemetry counters never move)."""
    m = _monitor  # read-only: never allocate a monitor just to report
    out = {"checks": m.checks if m is not None else 0,
           "violations": m.violation_count if m is not None else 0}
    cs = telemetry.histogram("health.check_seconds")
    p50 = cs.percentile(50) if cs.count else None
    if p50 is not None:
        out["check_seconds_p50"] = round(p50, 6)
    return out
