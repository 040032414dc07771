"""Server-side SLO tracking: burn rates and error budgets, in process.

Counterpart of ``znicz_tpu/serving/slo.py`` (``SloTracker`` :131-290).
The HTTP front end (:mod:`znicz_tpu_torch.serving.server`) feeds every
completed ``/predict`` into a per-model :class:`SloTracker`, measured
from request admission (queue, batching, dispatch, retries: what a
client waits for).

Accounting rules (the SRE availability convention):

* **good** — a 200 answered within ``root.common.serving.slo_ms``;
* **bad** — a 200 over the SLO, and every server-fault status: 429,
  503, 504, 500;
* **excluded** — client faults (400/404/413).

Per model the tracker keeps per-second buckets over the slow window and
derives the **burn rate** of each window, ``(bad/total) / (1 -
target)`` with ``target`` = ``slo_target_pct``, over the fast
(``slo_fast_window_s``) and the slow (``slo_slow_window_s``) window;
the **error budget remaining** over the slow window, ``1 - bad / (total
* (1 - target))`` clamped to [0, 1]; and the edge-triggered
**``slo.burn`` journal event** when both windows reach
``slo_burn_threshold`` (the fast window must drop under it before
another can fire), carrying the newest bad request id as its exemplar
(``GET /debug/trace/<rid>``), with ``slo.burn_over`` at the other edge.

Surfaces: ``GET /slo`` and the ``slo`` block of ``/statusz``
(:meth:`SloTracker.status`), and the ``slo.*`` series.  The front end
checks :func:`enabled` (``root.common.serving.slo_enabled``) before it
touches the tracker.  The clock is injectable, so the window math is
testable without sleeping.  The lock is a ``locksmith`` lock.
"""

import collections
import time

from znicz_tpu_torch.analysis import locksmith
from znicz_tpu_torch.core import telemetry
from znicz_tpu_torch.core.config import root

_cfg = root.common.serving

telemetry.register_help(
    "slo", "server-side SLO accounting (serving/slo.py): per-model "
           "good/total, window burn rates, error budget remaining")

#: client-fault statuses excluded from the budget entirely
EXCLUDED_STATUSES = frozenset((400, 404, 413))

def enabled():
    """The one gate the HTTP front end checks per reply — a live read
    of ``root.common.serving.slo_enabled``."""
    return bool(_cfg.get("slo_enabled", False))


def enable(**overrides):
    for k, v in overrides.items():
        setattr(root.common.serving, k, v)
    root.common.serving.slo_enabled = True
    return True


def disable():
    root.common.serving.slo_enabled = False
    return False


class _ModelSlo(object):
    """Per-model accounting: cumulative totals + per-second buckets
    bounded to the slow window."""

    __slots__ = ("good", "bad", "buckets", "burning", "last_bad_rid")

    def __init__(self):
        self.good = 0
        self.bad = 0
        #: deque of [sec, good, bad]; pruned to the slow window
        self.buckets = collections.deque()
        #: hysteresis latch: True while over the burn threshold —
        #: slo.burn fires only on the False -> True edge
        self.burning = False
        self.last_bad_rid = None

    def note(self, ok, now, slow_window_s, rid=None):
        sec = int(now)
        if self.buckets and self.buckets[-1][0] == sec:
            b = self.buckets[-1]
        else:
            b = [sec, 0, 0]
            self.buckets.append(b)
        if ok:
            self.good += 1
            b[1] += 1
        else:
            self.bad += 1
            b[2] += 1
            if rid:
                self.last_bad_rid = rid
        horizon = sec - int(slow_window_s) - 1
        while self.buckets and self.buckets[0][0] < horizon:
            self.buckets.popleft()

    def window(self, window_s, now):
        """(good, bad) across the trailing ``window_s`` seconds."""
        horizon = int(now) - int(window_s)
        good = bad = 0
        for sec, g, b in self.buckets:
            if sec > horizon:
                good += g
                bad += b
        return good, bad


class SloTracker(object):
    """Per-model good/total accounting + multi-window burn rates.

    ``clock`` is injectable (tests drive synthetic timelines with zero
    sleeps); knobs are LIVE config reads, so an operator can retune
    windows/threshold/target at runtime.
    """

    def __init__(self, clock=time.time):
        self._clock = clock
        self._models = {}
        self._lock = locksmith.lock("serving.slo")

    # -- knobs (live reads) -------------------------------------------------
    @staticmethod
    def _knobs():
        return {
            "slo_ms": float(_cfg.get("slo_ms", 100.0)),
            "target_pct": float(_cfg.get("slo_target_pct", 99.0)),
            "fast_s": float(_cfg.get("slo_fast_window_s", 60.0)),
            "slow_s": float(_cfg.get("slo_slow_window_s", 600.0)),
            "threshold": float(_cfg.get("slo_burn_threshold", 2.0)),
        }

    @staticmethod
    def classify(status_code, latency_ms, slo_ms):
        """"good" | "bad" | "excluded" for one completed request."""
        if status_code in EXCLUDED_STATUSES:
            return "excluded"
        if status_code == 200 and latency_ms <= slo_ms:
            return "good"
        return "bad"

    # -- the feed -----------------------------------------------------------
    def record(self, model, status_code, latency_ms, rid=None):
        """Account one completed request (called by the HTTP front end
        behind the :func:`enabled` gate).  Returns the classification,
        and fires one ``slo.burn`` journal event on a threshold
        crossing."""
        k = self._knobs()
        verdict = self.classify(int(status_code), float(latency_ms),
                                k["slo_ms"])
        if verdict == "excluded":
            return verdict
        model = model or "default"
        now = float(self._clock())
        with self._lock:
            m = self._models.get(model)
            if m is None:
                m = self._models[model] = _ModelSlo()
            m.note(verdict == "good", now, k["slow_s"], rid=rid)
            burn_fast = self._burn(m, k["fast_s"], now, k)
            burn_slow = self._burn(m, k["slow_s"], now, k)
            remaining = self._budget_remaining(m, now, k)
            over = (burn_fast is not None and burn_slow is not None
                    and burn_fast >= k["threshold"]
                    and burn_slow >= k["threshold"])
            was_burning = m.burning
            crossed = over and not was_burning
            m.burning = over if over else (
                m.burning and burn_fast is not None
                and burn_fast >= k["threshold"])
            cleared = was_burning and not m.burning
            exemplar = m.last_bad_rid
        if telemetry.enabled():
            telemetry.counter(telemetry.labeled(
                "slo.total", model=model)).inc()
            if verdict == "good":
                telemetry.counter(telemetry.labeled(
                    "slo.good", model=model)).inc()
            telemetry.gauge(telemetry.labeled(
                "slo.error_budget_remaining", model=model)).set(
                    remaining)
            if burn_fast is not None:
                telemetry.gauge(telemetry.labeled(
                    "slo.burn_rate_fast", model=model)).set(burn_fast)
            if burn_slow is not None:
                telemetry.gauge(telemetry.labeled(
                    "slo.burn_rate_slow", model=model)).set(burn_slow)
        if crossed:
            telemetry.record_event(
                "slo.burn", model=model,
                burn_fast=round(burn_fast, 3),
                burn_slow=round(burn_slow, 3),
                threshold=k["threshold"],
                budget_remaining=round(remaining, 4),
                exemplar_rid=exemplar)
        elif cleared:
            # the incident's other edge: without it a durable journal
            # (core/blackbox.py) shows burns that apparently never end
            telemetry.record_event(
                "slo.burn_over", model=model,
                burn_fast=(round(burn_fast, 3)
                           if burn_fast is not None else None),
                threshold=k["threshold"],
                budget_remaining=round(remaining, 4),
                exemplar_rid=exemplar)
        return verdict

    # -- the math -----------------------------------------------------------
    @staticmethod
    def _budget_fraction(k):
        return max(1.0 - k["target_pct"] / 100.0, 1e-9)

    def _burn(self, m, window_s, now, k):
        good, bad = m.window(window_s, now)
        total = good + bad
        if not total:
            return None
        return (bad / float(total)) / self._budget_fraction(k)

    def _budget_remaining(self, m, now, k):
        good, bad = m.window(k["slow_s"], now)
        total = good + bad
        if not total:
            return 1.0
        allowed = total * self._budget_fraction(k)
        return max(0.0, min(1.0, 1.0 - bad / allowed))

    # -- the view -----------------------------------------------------------
    def status(self):
        """The ``GET /slo`` payload / ``/statusz`` slo block."""
        k = self._knobs()
        now = float(self._clock())
        with self._lock:
            items = sorted(self._models.items())
            out_models = {}
            for name, m in items:
                burn_fast = self._burn(m, k["fast_s"], now, k)
                burn_slow = self._burn(m, k["slow_s"], now, k)
                total = m.good + m.bad
                out_models[name] = {
                    "good": m.good,
                    "bad": m.bad,
                    "total": total,
                    "good_pct": (round(100.0 * m.good / total, 3)
                                 if total else None),
                    "error_budget_remaining": round(
                        self._budget_remaining(m, now, k), 4),
                    "burn_rate": {
                        "fast": (round(burn_fast, 3)
                                 if burn_fast is not None else None),
                        "slow": (round(burn_slow, 3)
                                 if burn_slow is not None else None),
                    },
                    "burning": m.burning,
                    "exemplar_rid": m.last_bad_rid,
                }
        return {
            "enabled": enabled(),
            "slo_ms": k["slo_ms"],
            "target_pct": k["target_pct"],
            "windows_s": {"fast": k["fast_s"], "slow": k["slow_s"]},
            "burn_threshold": k["threshold"],
            "models": out_models,
        }

    def reset(self):
        with self._lock:
            self._models.clear()
