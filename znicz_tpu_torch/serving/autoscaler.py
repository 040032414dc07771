"""The fleet's autoscaler: SLO burn and queue depth in, replicas out.

Counterpart of ``znicz_tpu/serving/autoscaler.py`` (``Autoscaler``
:63).  A background controller reads the fleet's aggregated burn rates
and queued rows (:meth:`~znicz_tpu_torch.serving.router.FleetRouter.
aggregate_slo`, ``queued_rows_total``) and drives
``FleetRouter.scale_up()`` and ``FleetRouter.retire()``.  The knobs are
``root.common.serving.fleet.*``, read live:

* **scale up** under ``min_replicas``, or when both burn windows (the
  fleet's max) are at or over ``scale_up_burn_threshold``, or when the
  queued rows a replica exceed ``scale_up_queue_rows``; at most
  ``max_replicas``;
* **scale down** when the budget (the fleet's min) is at or over
  ``scale_down_budget_min``, the fast burn under 1.0 and the queue
  quiet, for ``scale_down_evals`` decisions in a row; never under
  ``min_replicas``.  The retire drains the replica first: no request in
  flight is lost;
* **cooldown**: ``cooldown_s`` at least between two actions.

Every decision is journaled (``autoscaler.decision``), each action too
(``autoscaler.scale_up`` / ``autoscaler.scale_down``, with the signals
behind it), and counted (``fleet.autoscaler_decisions``,
``fleet.autoscaler_scale_ups``, ``fleet.autoscaler_scale_downs``).
:meth:`Autoscaler.decide` is pure (inputs in, ``(action, reason)``
out) and the clock injectable.

One addition to the JAX package's loop: while the fleet's release
plane deploys or runs a release, and for ``cooldown_s`` after one
ended, :meth:`Autoscaler.step` holds a scale-down (the green streak
goes on counting) — retiring a replica mid-release would take a holder
of the candidate out of the fleet the release is judged on, and a
release's end (a promote's reload on every replica) is an action the
cooldown covers as it covers a scale action.  A scale-up goes ahead;
the router deploys the candidate on the new replica before it enters
rotation.
"""

import threading
import time

from znicz_tpu_torch.core import telemetry
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.logger import Logger

_fleet = root.common.serving.fleet

telemetry.register_help(
    "fleet.autoscaler",
    "SLO-burn-driven autoscaler (serving/autoscaler.py): decision "
    "and scale-action counters")

#: decisions
SCALE_UP, SCALE_DOWN, HOLD = "scale_up", "scale_down", "hold"


class Autoscaler(Logger):
    """Burn-rate and queue-depth autoscaling over a
    :class:`~znicz_tpu_torch.serving.router.FleetRouter` (see the
    module's docstring)."""

    def __init__(self, fleet, clock=time.monotonic):
        super(Autoscaler, self).__init__(logger_name="Autoscaler")
        self.fleet = fleet
        self._clock = clock
        self._green_streak = 0
        self._last_action_t = None
        self._last = {}            # the newest decision (status())
        self._thread = None
        self._stop = threading.Event()
        self._lock = threading.Lock()

    @staticmethod
    def knobs():
        return {
            "min": int(_fleet.get("min_replicas", 1)),
            "max": int(_fleet.get("max_replicas", 4)),
            "interval_s": float(_fleet.get("autoscale_interval_s", 5.0)),
            "burn_threshold": float(_fleet.get(
                "scale_up_burn_threshold", 2.0)),
            "queue_rows": float(_fleet.get("scale_up_queue_rows", 256.0)),
            "budget_min": float(_fleet.get("scale_down_budget_min", 0.97)),
            "down_evals": int(_fleet.get("scale_down_evals", 3)),
            "cooldown_s": float(_fleet.get("cooldown_s", 30.0)),
        }

    # -- the policy (pure) --------------------------------------------------
    def decide(self, alive, burn_fast, burn_slow, budget_remaining,
               queue_rows, now=None, exemplar_rid=None):
        """One decision, ``(action, reason)``.  ``alive`` counts the
        replicas that exist (up, spawning or draining out); the burn
        rates and the budget are the fleet's (None: no traffic yet);
        ``queue_rows`` the fleet's queued rows.  ``exemplar_rid`` rides
        into the journal only.  Changes only the green streak."""
        k = self.knobs()
        now = self._clock() if now is None else now
        in_cooldown = (self._last_action_t is not None and
                       now - self._last_action_t < k["cooldown_s"])
        if alive < k["min"]:
            # the floor beats every rule, the cooldown too: a dead
            # replica is replaced at once
            self._green_streak = 0
            return SCALE_UP, "below min_replicas (%d < %d)" % (
                alive, k["min"])
        queue_per_replica = queue_rows / max(alive, 1)
        burning = (burn_fast is not None and burn_slow is not None
                   and burn_fast >= k["burn_threshold"]
                   and burn_slow >= k["burn_threshold"])
        queue_deep = queue_per_replica > k["queue_rows"]
        if burning or queue_deep:
            self._green_streak = 0
            reason = ("burn fast %.2f / slow %.2f over threshold %.2f"
                      % (burn_fast or 0.0, burn_slow or 0.0,
                         k["burn_threshold"]) if burning else
                      "queued rows per replica %.0f over %.0f"
                      % (queue_per_replica, k["queue_rows"]))
            if alive >= k["max"]:
                return HOLD, "overloaded but at max_replicas: " + reason
            if in_cooldown:
                return HOLD, "overloaded but in cooldown: " + reason
            return SCALE_UP, reason
        green = ((budget_remaining is None
                  or budget_remaining >= k["budget_min"])
                 and (burn_fast is None or burn_fast < 1.0)
                 and queue_per_replica < k["queue_rows"] * 0.25)
        if not green:
            self._green_streak = 0
            return HOLD, "inside SLO, not comfortably green"
        self._green_streak += 1
        if alive <= k["min"]:
            return HOLD, "green but at min_replicas"
        if self._green_streak < k["down_evals"]:
            return HOLD, "green streak %d of %d" % (
                self._green_streak, k["down_evals"])
        if in_cooldown:
            return HOLD, "green but in cooldown"
        return SCALE_DOWN, (
            "budget %.3f >= %.3f for %d consecutive decisions"
            % (budget_remaining if budget_remaining is not None
               else 1.0, k["budget_min"], self._green_streak))

    # -- the loop -----------------------------------------------------------
    def _signals(self):
        """The fleet's inputs to one decision: the worst model's burn
        rates (and its newest bad rid), the lowest budget, the queued
        rows."""
        doc = self.fleet.aggregate_slo()
        burn_fast = burn_slow = budget = exemplar = None
        for m in (doc.get("models") or {}).values():
            rates = m.get("burn_rate") or {}
            fast, slow = rates.get("fast"), rates.get("slow")
            if fast is not None and (burn_fast is None or fast > burn_fast):
                burn_fast = fast
                exemplar = m.get("exemplar_rid") or exemplar
            if slow is not None:
                burn_slow = slow if burn_slow is None else max(burn_slow,
                                                               slow)
            b = m.get("error_budget_remaining")
            if b is not None:
                budget = b if budget is None else min(budget, b)
        return {
            "alive": self.fleet.alive_count(),
            "burn_fast": burn_fast,
            "burn_slow": burn_slow,
            "budget_remaining": budget,
            "queue_rows": self.fleet.queued_rows_total(),
            "exemplar_rid": exemplar,
        }

    def _release_busy(self, cooldown_s):
        release = getattr(self.fleet, "release", None)
        return release is not None and release.busy(cooldown_s)

    def step(self):
        """Gather, decide, act; returns the decision's record (also
        ``/statusz``'s ``autoscaler.last_decision``)."""
        signals = self._signals()
        action, reason = self.decide(**signals)
        if action == SCALE_DOWN and \
                self._release_busy(self.knobs()["cooldown_s"]):
            action, reason = HOLD, "release in flight: " + reason
        now = self._clock()
        record = dict(signals, action=action, reason=reason,
                      t=round(now, 3))
        with self._lock:
            self._last = record
        # the journal stamps its own wall-clock "t"
        journal = {k: v for k, v in record.items() if k != "t"}
        if telemetry.enabled():
            telemetry.counter("fleet.autoscaler_decisions").inc()
        telemetry.record_event("autoscaler.decision", **journal)
        if action == SCALE_UP:
            self._last_action_t = now
            telemetry.record_event("autoscaler.scale_up", **journal)
            if telemetry.enabled():
                telemetry.counter("fleet.autoscaler_scale_ups").inc()
            self.info("scaling up: %s", reason)
            try:
                self.fleet.scale_up()
            except Exception as e:  # noqa: BLE001 - keep the loop up
                self.warning("scale-up failed: %r", e)
                record["error"] = repr(e)
        elif action == SCALE_DOWN:
            self._last_action_t = now
            self._green_streak = 0
            telemetry.record_event("autoscaler.scale_down", **journal)
            if telemetry.enabled():
                telemetry.counter("fleet.autoscaler_scale_downs").inc()
            self.info("scaling down: %s", reason)
            try:
                self.fleet.retire()
            except Exception as e:  # noqa: BLE001 - keep the loop up
                self.warning("scale-down failed: %r", e)
                record["error"] = repr(e)
        return record

    def _loop(self):
        while not self._stop.wait(self.knobs()["interval_s"]):
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 - the loop survives
                self.warning("autoscaler step failed: %r", e)

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="znicz:autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10)

    def status(self):
        with self._lock:
            last = dict(self._last)
        return {
            "knobs": self.knobs(),
            "green_streak": self._green_streak,
            "last_action_t": self._last_action_t,
            "last_decision": last,
        }
