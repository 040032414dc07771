"""The port's autoscaler held to ``znicz_tpu``'s, mirroring
``tests/unit/test_autoscaler.py``: a table of ``decide(alive,
burn_fast, burn_slow, budget_remaining, queue_rows, now)`` inputs runs
through both on fake clocks, decision for decision (action and
reason), and ``step()`` gathers, acts and records as the JAX one does
over the same stub fleet.  The port's one addition, a scale-down held
while a release is in flight, is stated at the end."""

import pytest

from znicz_tpu.core import telemetry as jax_telemetry
from znicz_tpu.core.config import root as jax_root
from znicz_tpu.serving import autoscaler as jax_autoscaler
from znicz_tpu_torch.core import telemetry
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.serving.autoscaler import (HOLD, SCALE_DOWN, SCALE_UP,
                                                Autoscaler)


class FakeClock(object):
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class FakeFleet(object):
    """Canned signals and recorded actions: enough of a router for
    ``step()``."""

    def __init__(self, alive=2, slo=None, queued=0, release=None):
        self.alive = alive
        self.slo = slo or {"models": {}}
        self.queued = queued
        self.actions = []
        self.release = release

    def alive_count(self):
        return self.alive

    def aggregate_slo(self):
        return self.slo

    def queued_rows_total(self):
        return self.queued

    def scale_up(self):
        self.alive += 1
        self.actions.append("up")

    def retire(self):
        self.alive -= 1
        self.actions.append("down")


KNOBS = (("min_replicas", 1), ("max_replicas", 4),
         ("scale_up_burn_threshold", 2.0), ("scale_up_queue_rows", 100.0),
         ("scale_down_budget_min", 0.97), ("scale_down_evals", 3),
         ("cooldown_s", 30.0))


@pytest.fixture
def knobs(monkeypatch):
    for cfg in (root, jax_root):
        for key, value in KNOBS:
            monkeypatch.setattr(cfg.common.serving.fleet, key, value)


class Twins(object):
    """The JAX autoscaler and the port's, each on its own fake clock
    and fleet, fed the same inputs."""

    def __init__(self, alive=2, **fleet_kw):
        self.clocks = (FakeClock(), FakeClock())
        self.fleets = (FakeFleet(alive=alive, **fleet_kw),
                       FakeFleet(alive=alive, **fleet_kw))
        self.jax = jax_autoscaler.Autoscaler(self.fleets[0],
                                             clock=self.clocks[0])
        self.port = Autoscaler(self.fleets[1], clock=self.clocks[1])

    def decide(self, **inputs):
        got = (self.jax.decide(**inputs), self.port.decide(**inputs))
        assert got[0] == got[1], inputs
        assert self.jax._green_streak == self.port._green_streak
        return got[1]

    def advance(self, dt):
        for c in self.clocks:
            c.t += dt

    def acted(self):
        for s, c in ((self.jax, self.clocks[0]), (self.port, self.clocks[1])):
            s._last_action_t = c()


GREEN = dict(alive=2, burn_fast=0.1, burn_slow=0.1, budget_remaining=1.0,
             queue_rows=0)
QUIET = dict(alive=3, burn_fast=None, burn_slow=None,
             budget_remaining=None, queue_rows=0)


def test_the_knobs_equal_jaxs_defaults():
    assert Autoscaler.knobs() == jax_autoscaler.Autoscaler.knobs()
    assert (SCALE_UP, SCALE_DOWN, HOLD) == (
        jax_autoscaler.SCALE_UP, jax_autoscaler.SCALE_DOWN,
        jax_autoscaler.HOLD)


@pytest.mark.parametrize("inputs", [
    dict(alive=0, burn_fast=None, burn_slow=None, budget_remaining=None,
         queue_rows=0),
    dict(alive=2, burn_fast=3.0, burn_slow=2.5, budget_remaining=0.4,
         queue_rows=0),
    dict(alive=2, burn_fast=3.0, burn_slow=0.5, budget_remaining=0.9,
         queue_rows=0),
    dict(alive=2, burn_fast=None, burn_slow=None, budget_remaining=None,
         queue_rows=300),
    dict(alive=4, burn_fast=5.0, burn_slow=5.0, budget_remaining=0.0,
         queue_rows=0),
    dict(alive=2, burn_fast=0.5, burn_slow=0.5, budget_remaining=0.5,
         queue_rows=0),
    dict(alive=2, burn_fast=1.5, burn_slow=0.1, budget_remaining=1.0,
         queue_rows=0),
    dict(alive=2, burn_fast=0.1, burn_slow=0.1, budget_remaining=1.0,
         queue_rows=60),
    dict(alive=2, burn_fast=2.0, burn_slow=2.0, budget_remaining=0.9,
         queue_rows=200),
    dict(alive=1, burn_fast=0.0, burn_slow=0.0, budget_remaining=1.0,
         queue_rows=0),
])
def test_one_decision_equals_jaxs(knobs, inputs):
    twins = Twins()
    for _ in range(4):   # the streak grows or resets the same way
        twins.decide(**inputs)


def test_below_min_always_scales_up(knobs):
    twins = Twins()
    inputs = dict(alive=0, burn_fast=None, burn_slow=None,
                  budget_remaining=None, queue_rows=0)
    action, reason = twins.decide(**inputs)
    assert action == SCALE_UP and "min_replicas" in reason
    twins.acted()
    assert twins.decide(**inputs)[0] == SCALE_UP


def test_cooldown_blocks_repeat_scale_up(knobs):
    twins = Twins()
    hot = dict(alive=2, burn_fast=3.0, burn_slow=3.0,
               budget_remaining=0.4, queue_rows=0)
    assert twins.decide(**hot)[0] == SCALE_UP
    twins.acted()
    twins.advance(10.0)
    action, reason = twins.decide(**dict(hot, alive=3))
    assert action == HOLD and "cooldown" in reason
    twins.advance(25.0)
    assert twins.decide(**dict(hot, alive=3))[0] == SCALE_UP


def test_cooldown_holds_a_green_scale_down(knobs):
    twins = Twins()
    twins.acted()
    for _ in range(2):
        twins.decide(**GREEN)
    action, reason = twins.decide(**GREEN)
    assert action == HOLD and "cooldown" in reason
    twins.advance(31.0)
    assert twins.decide(**GREEN)[0] == SCALE_DOWN


def test_scale_down_needs_consecutive_green(knobs):
    twins = Twins()
    assert twins.decide(**GREEN)[0] == HOLD
    assert twins.decide(**GREEN)[0] == HOLD
    action, reason = twins.decide(**GREEN)
    assert action == SCALE_DOWN and "consecutive" in reason
    again = Twins()
    assert again.decide(**GREEN)[0] == HOLD
    assert again.decide(alive=2, burn_fast=3.0, burn_slow=3.0,
                        budget_remaining=0.2, queue_rows=0)[0] == SCALE_UP
    assert again.decide(**GREEN)[0] == HOLD


def test_scale_down_floors_at_min(knobs):
    twins = Twins()
    for _ in range(5):
        action, reason = twins.decide(alive=1, burn_fast=0.0,
                                      burn_slow=0.0, budget_remaining=1.0,
                                      queue_rows=0)
        assert action == HOLD
    assert "min_replicas" in reason


def test_no_traffic_is_green_not_red(knobs):
    twins = Twins()
    assert [twins.decide(**QUIET)[0] for _ in range(3)] == \
        [HOLD, HOLD, SCALE_DOWN]


def test_explicit_now_overrides_the_clock(knobs):
    twins = Twins()
    twins.acted()
    hot = dict(alive=2, burn_fast=3.0, burn_slow=3.0,
               budget_remaining=0.4, queue_rows=0)
    assert twins.decide(now=1010.0, **hot)[0] == HOLD
    assert twins.decide(now=1031.0, **hot)[0] == SCALE_UP


SLO = {"models": {
    "a": {"burn_rate": {"fast": 3.0, "slow": 2.6},
          "error_budget_remaining": 0.3, "exemplar_rid": "bad-a"},
    "b": {"burn_rate": {"fast": 0.2, "slow": 2.9},
          "error_budget_remaining": 1.0, "exemplar_rid": "bad-b"},
    "c": {"burn_rate": {"fast": None, "slow": None},
          "error_budget_remaining": None},
}}


@pytest.fixture
def telemetry_on(monkeypatch):
    for cfg in (root, jax_root):
        monkeypatch.setattr(cfg.common.telemetry, "enabled", True)
    telemetry.reset()
    jax_telemetry.reset()


def _journal(events):
    return [(e["kind"], {k: v for k, v in e.items()
                         if k not in ("t", "elapsed", "kind", "wall")})
            for e in events() if e["kind"].startswith("autoscaler.")]


def test_step_gathers_executes_and_records(knobs, telemetry_on):
    twins = Twins(alive=2, slo=SLO)
    records = (twins.jax.step(), twins.port.step())
    assert records[0] == records[1]
    record = records[1]
    assert record["action"] == SCALE_UP
    assert (record["burn_fast"], record["burn_slow"],
            record["budget_remaining"], record["exemplar_rid"]) == \
        (3.0, 2.9, 0.3, "bad-a")
    assert twins.fleets[1].actions == ["up"] == twins.fleets[0].actions
    assert twins.port.status()["last_decision"] == \
        twins.jax.status()["last_decision"]
    assert twins.port.status()["knobs"] == twins.jax.status()["knobs"]
    assert _journal(telemetry.journal_events) == \
        _journal(jax_telemetry.journal_events)
    counters = telemetry.snapshot()["counters"]
    assert counters["fleet.autoscaler_decisions"] == 1
    assert counters["fleet.autoscaler_scale_ups"] == 1


def test_step_scale_down_executes_retire(knobs, telemetry_on):
    twins = Twins(alive=3)
    for _ in range(2):
        assert twins.jax.step()["action"] == twins.port.step()["action"] \
            == HOLD
    records = (twins.jax.step(), twins.port.step())
    assert records[0] == records[1] and records[1]["action"] == SCALE_DOWN
    assert twins.fleets[1].actions == ["down"]
    assert twins.port._green_streak == twins.jax._green_streak == 0
    kinds = [k for k, _ in _journal(telemetry.journal_events)]
    assert kinds.count("autoscaler.decision") == 3
    assert kinds[-1] == "autoscaler.scale_down"
    assert telemetry.snapshot()["counters"][
        "fleet.autoscaler_scale_downs"] == 1


def test_a_failing_action_is_recorded_and_the_loop_lives(knobs):
    twins = Twins(alive=0)

    def boom():
        raise RuntimeError("no card left")
    for fleet in twins.fleets:
        fleet.scale_up = boom
    records = (twins.jax.step(), twins.port.step())
    assert records[0]["error"] == records[1]["error"] == \
        "RuntimeError('no card left')"


class _Release(object):
    """A release plane whose ``busy(within_s)`` the test sets."""

    def __init__(self, busy):
        self._busy = busy
        self.asked = []

    def busy(self, within_s=0.0):
        self.asked.append(within_s)
        return self._busy


def test_a_release_in_flight_holds_the_scale_down(knobs):
    """The port's addition: green enough to retire, but the fleet's
    release plane is busy (a release deploying, active or ended inside
    the cooldown): HOLD, the streak kept; once it is not, the next
    decision retires."""
    release = _Release(True)
    scaler = Autoscaler(FakeFleet(alive=3, release=release),
                        clock=FakeClock())
    assert [scaler.step()["action"] for _ in range(3)] == [HOLD] * 3
    record = scaler.step()
    assert record["action"] == HOLD
    assert record["reason"].startswith("release in flight: budget")
    assert scaler.fleet.actions == []
    assert scaler._green_streak == 4
    assert release.asked[-1] == 30.0      # the cooldown
    release._busy = False
    assert scaler.step()["action"] == SCALE_DOWN
    assert scaler.fleet.actions == ["down"]
    # a scale-up is never held
    hot = Autoscaler(FakeFleet(alive=0, release=_Release(True)),
                     clock=FakeClock())
    assert hot.step()["action"] == SCALE_UP


def test_the_loop_starts_and_stops(knobs, monkeypatch):
    import threading
    monkeypatch.setattr(root.common.serving.fleet, "autoscale_interval_s",
                        0.01)
    fleet = FakeFleet(alive=0)
    acted = threading.Event()
    real = fleet.scale_up

    def scale_up():
        real()
        acted.set()
    fleet.scale_up = scale_up
    scaler = Autoscaler(fleet)
    assert scaler.start() is scaler.start()
    assert acted.wait(30)
    scaler.stop()
    assert fleet.actions[0] == "up" and scaler._thread is None


def test_cli_autoscale_needs_a_fleet_and_stays_in_the_router(capsys):
    from znicz_tpu_torch.serving import server
    with pytest.raises(SystemExit) as exit_:
        server.main(["m=unused.zip", "--device", "cpu", "--autoscale"])
    assert exit_.value.code == 2
    assert "--autoscale sizes a fleet" in capsys.readouterr().err
    assert server.replica_argv(["m=p.zip", "--fleet", "2", "--autoscale",
                                "--device", "cpu"]) == \
        ["m=p.zip", "--device", "cpu"]
