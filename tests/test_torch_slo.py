"""The port's SLO tracker (``znicz_tpu_torch/serving/slo.py``) held
against ``znicz_tpu/serving/slo.py``: the cases of
``tests/unit/test_slo.py`` on the port, and every record stream of
them driven through both packages' trackers under one injected clock,
whose ``status()`` and ``slo.burn`` / ``slo.burn_over`` journal events
(their fields, less the wall stamps) must be equal exactly.  No sleeps.
"""

import pytest

from znicz_tpu.core import telemetry as jax_telemetry
from znicz_tpu.core.config import root as jax_root
from znicz_tpu.serving import slo as jax_slo
from znicz_tpu_torch.core import telemetry
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.serving import slo

KEYS = ("slo_enabled", "slo_ms", "slo_target_pct", "slo_fast_window_s",
        "slo_slow_window_s", "slo_burn_threshold")
VALUES = (True, 100.0, 99.0, 10.0, 60.0, 2.0)


class FakeClock(object):
    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture
def knobs():
    """Both packages' SLO knobs at hand-computable values (budget
    fraction 0.01), both journals on; restored after."""
    saved = []
    for r in (root, jax_root):
        cfg = r.common.serving
        saved.append((cfg, {k: cfg.get(k) for k in KEYS},
                      r.common.telemetry.get("enabled")))
        for k, v in zip(KEYS, VALUES):
            setattr(cfg, k, v)
        r.common.telemetry.enabled = True
    telemetry.reset()
    jax_telemetry.reset()
    yield root.common.serving
    for (cfg, vals, tel), r in zip(saved, (root, jax_root)):
        for k, v in vals.items():
            setattr(cfg, k, v)
        r.common.telemetry.enabled = tel
    telemetry.reset()
    jax_telemetry.reset()


def _events(tel):
    return [{k: v for k, v in e.items() if k not in ("t", "elapsed")}
            for e in tel.journal_events() if e["kind"].startswith("slo.")]


# -- the record streams, run on both packages --------------------------------

def _burn_rate_hand_computed(t, clock):
    for _ in range(90):
        t.record("m", 200, 10.0)
    for _ in range(10):
        t.record("m", 500, 10.0)


def _fast_forgets_slow_remembers(t, clock):
    for _ in range(10):
        t.record("m", 500, 1.0)
    clock.advance(30.0)
    for _ in range(10):
        t.record("m", 200, 1.0)


def _slow_window_expiry(t, clock):
    for _ in range(5):
        t.record("m", 500, 1.0)
    clock.advance(120.0)
    t.record("m", 200, 1.0)


def _budget_half(t, clock):
    for _ in range(995):
        t.record("m", 200, 1.0)
    for _ in range(5):
        t.record("m", 500, 1.0)


def _per_model(t, clock):
    for _ in range(10):
        t.record("a", 200, 1.0)
        t.record("b", 500, 1.0)
    t.record(None, 200, 1.0)
    t.record("a", 404, 1.0)
    t.record("a", 200, 150.0)


def _burn_refires(t, clock):
    t.record("m", 200, 1.0)
    for i in range(5):
        t.record("m", 500, 1.0, rid="bad-%d" % i)
    for i in range(5):
        t.record("m", 500, 1.0, rid="more-%d" % i)
    clock.advance(15.0)
    for _ in range(50):
        t.record("m", 200, 1.0)
    clock.advance(120.0)
    for i in range(5):
        t.record("m", 503, 1.0, rid="again-%d" % i)


def _seeded_mix(t, clock):
    import numpy
    r = numpy.random.RandomState(7)
    codes = (200, 200, 200, 200, 429, 500, 503, 504, 400, 413)
    for i in range(400):
        t.record(["a", "b", None][int(r.randint(3))],
                 codes[int(r.randint(len(codes)))],
                 float(r.uniform(1.0, 160.0)), rid="s-%d" % i)
        clock.advance(float(r.uniform(0.0, 2.0)))


STREAMS = [_burn_rate_hand_computed, _fast_forgets_slow_remembers,
           _slow_window_expiry, _budget_half, _per_model, _burn_refires,
           _seeded_mix]


@pytest.mark.parametrize("stream", STREAMS, ids=lambda f: f.__name__)
def test_status_and_burn_events_equal_jaxs(knobs, stream):
    clock, jax_clock = FakeClock(5000.0), FakeClock(5000.0)
    mine = slo.SloTracker(clock=clock)
    theirs = jax_slo.SloTracker(clock=jax_clock)
    stream(mine, clock)
    stream(theirs, jax_clock)
    assert mine.status() == theirs.status()
    assert _events(telemetry) == _events(jax_telemetry)


# -- the cases of tests/unit/test_slo.py on the port -------------------------

def test_classification_rules(knobs):
    t = slo.SloTracker(clock=FakeClock())
    assert t.classify(200, 50.0, 100.0) == "good"
    assert t.classify(200, 150.0, 100.0) == "bad"
    for code in (429, 500, 503, 504):
        assert t.classify(code, 1.0, 100.0) == "bad"
    for code in (400, 404, 413):
        assert t.classify(code, 1.0, 100.0) == "excluded"


def test_excluded_statuses_never_recorded(knobs):
    t = slo.SloTracker(clock=FakeClock())
    assert t.record("m", 400, 1.0) == "excluded"
    assert t.record("m", 404, 1.0) == "excluded"
    assert "m" not in t.status()["models"]


def test_burn_rate_hand_computed(knobs):
    t = slo.SloTracker(clock=FakeClock(2000.0))
    _burn_rate_hand_computed(t, None)
    m = t.status()["models"]["m"]
    assert m["good"] == 90 and m["bad"] == 10
    assert m["burn_rate"]["fast"] == pytest.approx(10.0)
    assert m["burn_rate"]["slow"] == pytest.approx(10.0)
    assert m["good_pct"] == pytest.approx(90.0)


def test_fast_window_forgets_slow_window_remembers(knobs):
    clock = FakeClock(3000.0)
    t = slo.SloTracker(clock=clock)
    _fast_forgets_slow_remembers(t, clock)
    m = t.status()["models"]["m"]
    assert m["burn_rate"]["fast"] == pytest.approx(0.0)
    assert m["burn_rate"]["slow"] == pytest.approx(50.0)


def test_slow_window_expiry(knobs):
    clock = FakeClock(5000.0)
    t = slo.SloTracker(clock=clock)
    _slow_window_expiry(t, clock)
    m = t.status()["models"]["m"]
    assert m["bad"] == 5 and m["good"] == 1
    assert m["burn_rate"]["fast"] == pytest.approx(0.0)
    assert m["burn_rate"]["slow"] == pytest.approx(0.0)
    assert m["error_budget_remaining"] == 1.0


def test_no_traffic_means_no_burn_rate(knobs):
    t = slo.SloTracker(clock=FakeClock())
    t.record("m", 200, 1.0)
    assert slo.SloTracker(clock=FakeClock()).status()["models"] == {}
    assert t.status()["models"]["m"]["burn_rate"]["fast"] == 0.0


def test_budget_remaining_hand_computed(knobs):
    t = slo.SloTracker(clock=FakeClock(7000.0))
    _budget_half(t, None)
    assert t.status()["models"]["m"]["error_budget_remaining"] == \
        pytest.approx(0.5)


def test_budget_clamps_at_zero(knobs):
    t = slo.SloTracker(clock=FakeClock(8000.0))
    for _ in range(10):
        t.record("m", 500, 1.0)
    m = t.status()["models"]["m"]
    assert m["error_budget_remaining"] == 0.0
    assert m["burn_rate"]["fast"] == pytest.approx(100.0)


def test_per_model_isolation(knobs):
    t = slo.SloTracker(clock=FakeClock(9000.0))
    for _ in range(10):
        t.record("a", 200, 1.0)
        t.record("b", 500, 1.0)
    models = t.status()["models"]
    assert models["a"]["error_budget_remaining"] == 1.0
    assert models["b"]["error_budget_remaining"] == 0.0
    t.record(None, 200, 1.0)
    assert t.status()["models"]["default"]["good"] == 1


def _burns():
    return [e for e in telemetry.journal_events() if e["kind"] == "slo.burn"]


def test_burn_event_fires_once_per_crossing(knobs):
    t = slo.SloTracker(clock=FakeClock(10000.0))
    t.record("m", 200, 1.0)
    for i in range(5):
        t.record("m", 500, 1.0, rid="bad-%d" % i)
    events = _burns()
    assert len(events) == 1, events
    ev = events[0]
    assert ev["model"] == "m" and ev["threshold"] == 2.0
    assert ev["burn_fast"] >= 2.0 and ev["burn_slow"] >= 2.0
    assert str(ev["exemplar_rid"]).startswith("bad-")
    for i in range(5):
        t.record("m", 500, 1.0, rid="more-%d" % i)
    assert len(_burns()) == 1


def test_burn_event_refires_after_recovery(knobs):
    clock = FakeClock(20000.0)
    t = slo.SloTracker(clock=clock)
    for _ in range(5):
        t.record("m", 500, 1.0)
    assert len(_burns()) == 1
    clock.advance(15.0)
    for _ in range(50):
        t.record("m", 200, 1.0)
    assert t.status()["models"]["m"]["burning"] is False
    clock.advance(120.0)
    for _ in range(5):
        t.record("m", 500, 1.0)
    assert len(_burns()) == 2


def test_status_shape_and_knob_echo(knobs):
    t = slo.SloTracker(clock=FakeClock())
    t.record("m", 200, 1.0)
    st = t.status()
    assert st["enabled"] is True
    assert st["slo_ms"] == 100.0 and st["target_pct"] == 99.0
    assert st["windows_s"] == {"fast": 10.0, "slow": 60.0}
    assert st["burn_threshold"] == 2.0


def test_disabled_gate_is_one_predicate(knobs, monkeypatch):
    root.common.serving.slo_enabled = False
    assert slo.enabled() is False

    def boom(*a, **k):
        raise AssertionError("disabled path touched the SLO tracker")

    monkeypatch.setattr(slo.SloTracker, "record", boom)
    if slo.enabled():
        slo.SloTracker().record("m", 200, 1.0)
