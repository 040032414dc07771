"""The port's numeric training-health monitor
(``znicz_tpu_torch.core.health``) against ``znicz_tpu.core.health``,
and through real training loops.

* :func:`pytree_health` gives JAX's flags and sums of squares on the
  same trees.  JAX squares each leaf in float32 and sums in float32;
  the port takes each leaf's L2 norm in the leaf's precision (here
  float64) and sums their squares in float64: on trees whose values
  lie on a 1/8 grid every partial sum is exact in float32, so the two
  agree within 1e-12 (f64 trees, NaN and Inf among them, in one leaf
  too); on random normal trees they agree within JAX's float32
  rounding (1e-6 relative), and the port holds 1e-12 of a float64
  recompute.
* :class:`DivergenceDetector` trips on the same epochs as JAX's for
  the same seeded loss series (decreasing, noisy, exploding, rising,
  non-finite).
* The rest mirrors ``tests/unit/test_health.py`` and
  ``tests/functional/test_health_workflow.py`` on the port: interval
  gating, the disabled path, the warn / snapshot / halt policies and
  the crash report, the GD-unit check on the device side without a
  transfer, the journal gates, ``/debug/health`` and
  ``/debug/faults`` on the status and serving servers, and the fused
  trainer's and the unit graph's checks in a real run of the MNIST
  MLP (60 / 30 synthetic rows).
"""

import glob
import json
import math
import os
import urllib.request

import numpy
import pytest
import torch

from test_torch_faults import faults_health_isolated  # noqa: F401
from test_torch_units import prng_streams_restored  # noqa: F401
from znicz_tpu.core import health as jax_health
from znicz_tpu_torch.core import health, prng, telemetry
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.memory import DEV, Array


@pytest.fixture(autouse=True)
def _health_knobs():
    for r in (root, jax_health.root):
        r.common.health.policy = "warn"
        r.common.health.interval = 1


def _grid_tree(rand, shapes, dtype=numpy.float64):
    """Values k / 8 for k in [-16, 16]: every partial sum of squares of
    up to 2^18 / 256 values is exact in float32."""
    return [rand.randint(-16, 17, s).astype(dtype) / 8 for s in shapes]


def _both(**trees):
    return health.pytree_health(**trees), jax_health.pytree_health(**trees)


def _assert_reports_close(got, want, rtol):
    assert got["nan"] == want["nan"] and got["inf"] == want["inf"]
    assert got["non_finite"] == want["non_finite"]
    assert sorted(got["norms"]) == sorted(want["norms"])
    for name, norm in want["norms"].items():
        if math.isnan(norm):
            assert math.isnan(got["norms"][name])
        else:
            assert got["norms"][name] == pytest.approx(norm, rel=rtol,
                                                       abs=0), name


@pytest.mark.parametrize("poison", ["clean", "nan", "inf", "both",
                                    "one_leaf"])
def test_pytree_health_matches_jax_on_grid_trees(poison):
    rand = numpy.random.RandomState(11)
    params = {"w": _grid_tree(rand, [(40, 30), (30,)]),
              "b": _grid_tree(rand, [(7, 5, 3)])}
    grads = _grid_tree(rand, [(300,), (2, 3)])
    updates = [{"vel": g} for g in _grid_tree(rand, [(30, 40), (9,)])]
    if poison in ("nan", "both"):
        grads[0][17] = numpy.nan
    if poison in ("inf", "both"):
        updates[1]["vel"][3] = -numpy.inf
    if poison == "one_leaf":
        # a NaN hides an Inf from the leaf's largest magnitude
        grads[0][[4, 9]] = numpy.nan, numpy.inf
    got, want = _both(params=params, grads=grads, updates=updates)
    _assert_reports_close(got, want, 1e-12)
    # against the exact norms (the squares sum to a multiple of 1/64)
    for name, tree in (("params", params), ("grads", grads)):
        if name not in got["non_finite"]:
            leaves = health._leaves(tree)
            exact = math.sqrt(sum(float((l ** 2).sum()) for l in leaves))
            assert got["norms"][name] == pytest.approx(exact, rel=1e-15)


def test_pytree_health_matches_jax_on_random_trees():
    rand = numpy.random.RandomState(5)
    params = [rand.normal(0, s, shape) for s, shape in
              ((0.01, (96, 363)), (1.0, (96,)), (30.0, (10, 4096)))]
    grads = [rand.normal(0, 1e-4, (4096, 17))]
    got, want = _both(params=params, grads=grads)
    _assert_reports_close(got, want, 1e-6)
    for name, tree in (("params", params), ("grads", grads)):
        exact = math.sqrt(sum(float(numpy.square(l).sum()) for l in tree))
        assert got["norms"][name] == pytest.approx(exact, rel=1e-12)


def test_pytree_health_takes_tensors_and_arrays_mixed(monkeypatch):
    """Tensors on the net's device, host arrays and empty leaves in one
    tree; a clean check reads back once, as one array."""
    from znicz_tpu_torch.core import memory
    fetches = []
    monkeypatch.setattr(health, "host_fetch", lambda t: fetches.append(1)
                        or memory.host_fetch(t))
    t = [torch.tensor([3.0, 4.0]), numpy.array([0.0, 0.0, 12.0]),
         torch.zeros(0), torch.tensor([[2, 0]], dtype=torch.int32)]
    report = health.pytree_health(params=t, grads=[torch.zeros(3)])
    assert report["norms"] == {"params": math.sqrt(173.0), "grads": 0.0}
    assert len(fetches) == 1
    rows = health._health_rows({"a": t, "b": [torch.ones(4)], "c": []})
    assert isinstance(rows, numpy.ndarray) and rows.shape == (3, 3)
    assert rows.dtype == numpy.float64 and rows[2].tolist() == [0, 0, 0]


def test_kernel_clean_pytree_reports_norms_exactly():
    report = health.pytree_health(params=[{"w": numpy.array([3.0, 4.0])}],
                                  grads=[numpy.array([0.5])])
    assert report["nan"] is False and report["inf"] is False
    assert report["non_finite"] == []
    assert report["norms"]["params"] == pytest.approx(5.0)
    assert report["norms"]["grads"] == pytest.approx(0.5)


def test_kernel_flags_nan_and_names_the_tree():
    report = health.pytree_health(params=[numpy.array([1.0, 2.0])],
                                  grads={"w": numpy.array([numpy.nan, 1.0])})
    assert report["nan"] is True and report["inf"] is False
    assert report["non_finite"] == ["grads"]
    assert math.isnan(report["norms"]["grads"])
    assert report["norms"]["params"] == pytest.approx(math.sqrt(5.0))


def test_kernel_flags_inf():
    report = health.pytree_health(updates=[numpy.array([numpy.inf, 0.0])])
    assert report["inf"] is True and report["nan"] is False
    assert report["non_finite"] == ["updates"]


def test_kernel_empty_and_none_trees():
    assert health.pytree_health() == {"nan": False, "inf": False,
                                      "norms": {}, "non_finite": []}
    report = health.pytree_health(params=None, grads=[numpy.zeros(2)])
    assert list(report["norms"]) == ["grads"]


def test_disabled_path_does_no_work(monkeypatch):
    health.disable()
    telemetry.enable()
    telemetry.reset()
    monkeypatch.setattr(health, "_health_rows", lambda trees: (
        _ for _ in ()).throw(AssertionError("reduction touched")))
    assert health.check_training_step(
        None, steps=1, params=[numpy.array([numpy.nan])]) is None
    assert health.check_gd_unit(object()) is None
    assert health.observe_loss(float("nan")) is None
    assert health._monitor is None
    snap = telemetry.snapshot()
    assert snap["counters"] == {} and snap["gauges"] == {}


def test_disabled_status_is_safe():
    health.disable()
    st = health.status()
    assert st["enabled"] is False and st["ok"] is True
    assert st["checks"] == 0 and st["violations"] == 0
    assert health.summary() == {"checks": 0, "violations": 0}


def test_interval_gates_checks():
    health.enable(interval=3)
    p = [numpy.ones(4)]
    for _ in range(6):
        health.check_training_step(None, steps=1, params=p)
    assert health.monitor().checks == 2     # steps 1 and 4


def test_window_steps_advance_interval_at_once():
    health.enable(interval=1)
    for _ in range(3):
        health.check_training_step(None, steps=8, params=[numpy.ones(4)])
    assert health.monitor().checks == 3


def test_detector_quiet_on_decreasing_loss():
    d = health.DivergenceDetector(window=5, factor=3.0, rise=0.1)
    assert all(d.observe(v) is None
               for v in (1.0, 0.8, 0.6, 0.5, 0.45, 0.41, 0.40))


def test_detector_trips_on_explosion_and_nan():
    d = health.DivergenceDetector(window=8, ema_alpha=0.5, factor=2.0)
    for v in (1.0, 0.9, 0.8):
        assert d.observe(v) is None
    assert "exploded" in d.observe(50.0)
    assert "non-finite" in health.DivergenceDetector().observe(float("nan"))


def test_detector_trips_on_sustained_rise():
    d = health.DivergenceDetector(window=4, factor=100.0, rise=0.1)
    out = [d.observe(v) for v in (1.0, 1.2, 1.4, 1.6)]
    assert out[:3] == [None, None, None]
    assert "rising" in out[3]


def test_detector_quiet_on_flat_noise():
    d = health.DivergenceDetector(window=4, factor=100.0, rise=0.1)
    assert all(d.observe(v) is None
               for v in (1.0, 1.01, 0.99, 1.02, 1.0, 1.01))


def _series(kind, rand, n=60):
    base = 50.0 * numpy.exp(-numpy.arange(n) / 15.0) + 1.0
    noise = rand.normal(0, 0.05, n)
    if kind == "decreasing":
        return base + noise
    if kind == "noisy":
        return 2.0 + rand.normal(0, 0.3, n)
    if kind == "exploding":
        s = base + noise
        s[rand.randint(10, n, 3)] *= rand.uniform(3, 40, 3)
        return s
    if kind == "rising":
        return 1.0 + numpy.arange(n) * 0.02 + rand.normal(0, 0.01, n)
    s = base + noise
    s[rand.randint(5, n)] = numpy.nan
    s[rand.randint(5, n)] = numpy.inf
    return s


@pytest.mark.parametrize("kind", ["decreasing", "noisy", "exploding",
                                  "rising", "non_finite"])
@pytest.mark.parametrize("knobs", [
    {}, {"window": 4, "ema_alpha": 0.5, "factor": 2.0, "rise": 0.05}])
def test_detector_trips_on_the_same_epochs_as_jax(kind, knobs):
    seeds = {"decreasing": 1, "noisy": 2, "exploding": 3, "rising": 4,
             "non_finite": 5}
    series = _series(kind, numpy.random.RandomState(seeds[kind]))
    dets = [mod.DivergenceDetector(**knobs) for mod in (health, jax_health)]
    trips = [[(i, d.observe(v)) for i, v in enumerate(series)] for d in dets]
    assert trips[0] == trips[1]
    assert dets[0].state() == dets[1].state()
    if kind != "decreasing":
        assert any(why for _, why in trips[0]), "the detector never tripped"


def test_warn_policy_counts_and_journals():
    telemetry.enable()
    telemetry.reset()
    health.enable(policy="warn")
    report = health.check_training_step(
        None, steps=1, params=[numpy.array([numpy.nan])])
    assert report["nan"] is True
    assert telemetry.counter("health.violations").value == 1
    assert "health.violation" in [e["kind"]
                                  for e in telemetry.journal_events()]
    st = health.status()
    assert st["ok"] is False and "NaN" in st["last_violation"]["reason"]
    assert health.summary()["violations"] == 1
    assert health.summary()["check_seconds_p50"] >= 0


def test_halt_policy_raises_typed_error_with_crash_report(tmp_path):
    telemetry.enable()
    health.enable(policy="halt")
    with pytest.raises(health.HealthViolationError) as e:
        health.check_training_step(None, steps=1,
                                   grads=[numpy.array([numpy.inf])])
    crash = e.value.crash_report
    assert crash and os.path.isdir(crash)
    assert crash.startswith(str(tmp_path))
    for fname in ("events.jsonl", "metrics.json", "report.json"):
        assert os.path.isfile(os.path.join(crash, fname)), fname
    with open(os.path.join(crash, "metrics.json")) as f:
        assert json.load(f)["counters"]["health.violations"] == 1
    with open(os.path.join(crash, "events.jsonl")) as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds[-1] == "health.violation"


def test_snapshot_policy_exports_through_the_workflow():
    calls = []

    class Snapshotter(object):
        def export(self):
            calls.append(1)
            return "snap"

    class WF(object):
        snapshotter = Snapshotter()

    class U(object):
        name = "trainer"
        workflow = WF()

    health.enable(policy="snapshot")
    health.check_training_step(U(), steps=1,
                               params=[numpy.array([numpy.nan])])
    assert calls == [1]
    U2 = type("U2", (), {"name": "x", "workflow": None})
    health.check_training_step(U2(), steps=1,
                               params=[numpy.array([numpy.nan])])
    assert health.monitor().violation_count == 2


def test_norm_limits_fire_policy():
    health.enable(policy="warn", grad_norm_limit=1.0)
    report = health.check_training_step(None, steps=1,
                                        grads=[numpy.full(4, 10.0)])
    assert report["norms"]["grads"] == pytest.approx(20.0)
    assert health.monitor().violation_count == 1
    assert "exceeds limit" in health.monitor().last_violation["reason"]


def test_observe_loss_fires_policy_on_divergence():
    health.enable(policy="warn")
    assert health.observe_loss(1.0) is None
    assert health.observe_loss(float("inf")) is not None
    assert health.monitor().violation_count == 1


class _FakeGD(object):
    name = "gd_fake"
    workflow = None

    def __init__(self, grad):
        self.gradient_weights = Array(grad)
        self.weights = Array(numpy.ones((2, 2)))
        self.gradient_weights_with_moment = Array(numpy.zeros((2, 2)))
        self.gradient_bias = None
        self.bias = None
        self.gradient_bias_with_moment = None


def test_check_gd_unit_flags_nan_gradients():
    telemetry.enable()
    telemetry.reset()
    health.enable(policy="warn")
    report = health.check_gd_unit(
        _FakeGD(numpy.array([[numpy.nan, 0.0], [0.0, 0.0]])))
    assert report["nan"] is True and "grads" in report["non_finite"]
    assert health.monitor().violation_count == 1
    clean = health.check_gd_unit(_FakeGD(numpy.ones((2, 2))))
    assert clean["nan"] is False
    assert telemetry.gauge("health.grads_norm").value == pytest.approx(2.0)
    assert telemetry.gauge("health.params_norm").value == pytest.approx(2.0)


def test_check_gd_unit_reads_device_side_without_transfer():
    health.enable(policy="warn")
    unit = _FakeGD(numpy.ones((2, 2)))
    unit.gradient_weights.set_dev(torch.full((2, 2), 3.0))
    report = health.check_gd_unit(unit)
    assert report["norms"]["grads"] == pytest.approx(6.0)
    # the Array was not read back: its device side stays authoritative
    assert unit.gradient_weights._state == DEV


def test_reset_clears_journal():
    telemetry.enable()
    telemetry.record_event("x", n=1)
    assert telemetry.journal_events()
    telemetry.reset()
    assert telemetry.journal_events() == []


def test_journal_gated_on_telemetry_or_health():
    telemetry.disable()
    health.disable()
    assert telemetry.record_event("nope") is None
    assert telemetry.journal_events() == []
    health.enable()
    assert telemetry.record_event("yes", k=1) is not None
    assert telemetry.journal_events()[0]["kind"] == "yes"


def _get(port, path):
    try:
        with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                    timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_debug_endpoints_on_status_server():
    from znicz_tpu_torch.core import faults
    from znicz_tpu_torch.core.status_server import StatusServer
    health.enable(policy="warn")
    faults.install("d.site", kind="io", at=5)
    server = StatusServer(None, port=0).start()
    try:
        code, doc = _get(server.port, "/debug/health")
        assert code == 200 and doc["enabled"] is True and doc["ok"] is True
        health.check_training_step(None, steps=1,
                                   params=[numpy.array([numpy.nan])])
        code, doc = _get(server.port, "/debug/health")
        assert code == 503 and doc["violations"] == 1
        code, doc = _get(server.port, "/debug/faults")
        assert code == 200 and doc["rules"]["d.site"]["at"] == 5
        code, doc = _get(server.port, "/status.json")
        assert code == 200 and doc["workflow"] is None
    finally:
        server.stop()


def test_debug_endpoints_on_serving_server(tmp_path):
    from znicz_tpu_torch.export import write_package
    from znicz_tpu_torch.serving.engine import InferenceEngine
    from znicz_tpu_torch.serving.server import ServingServer
    path = write_package(
        {"format": 1, "input_sample_shape": [4], "layers": [
            {"type": "softmax",
             "arrays": {"weights": "w.npy", "bias": "b.npy"}}]},
        {"w.npy": numpy.ones((2, 4), numpy.float32),
         "b.npy": numpy.zeros(2, numpy.float32)}, str(tmp_path / "m.zip"))
    engine = InferenceEngine(path, device="cpu", buckets=(1,))
    server = ServingServer(engine, port=0).start()
    try:
        code, doc = _get(server.port, "/debug/faults")
        assert code == 200 and doc["enabled"] is False
        code, doc = _get(server.port, "/debug/health")
        assert code == 200 and doc["ok"] is True
    finally:
        server.stop()


# -- through real training loops ---------------------------------------------

def _mlp(tmp_path, max_epochs=2, fused=None, init=True):
    from znicz_tpu_torch.samples import mnist
    prng.get(1).seed(1234)
    prng.get(2).seed(5678)
    kwargs = {} if fused is None else {"fused": fused}
    wf = mnist.build(
        layers=[{"type": "all2all_tanh", "->": {"output_sample_shape": 16}},
                {"type": "softmax", "->": {"output_sample_shape": 10}}],
        loader_config={"synthetic_train": 60, "synthetic_valid": 30,
                       "minibatch_size": 30},
        decision_config={"max_epochs": max_epochs, "fail_iterations": 50},
        snapshotter_config={"prefix": "health", "interval": 10 ** 9,
                            "time_interval": 1e9, "compression": "",
                            "directory": str(tmp_path)},
        **kwargs)
    if init:
        wf.initialize(device="cpu")
    return wf


def _poison_after_first_train_segment(wf, poison):
    """Run ``poison()`` once, at the end of the first TRAIN segment."""
    from znicz_tpu_torch.loader.base import TRAIN
    decision = wf.decision
    real = decision.on_last_minibatch
    done = []

    def on_last_minibatch():
        real()
        if decision.minibatch_class == TRAIN and not done:
            done.append(True)
            poison()

    decision.on_last_minibatch = on_last_minibatch
    return done


@pytest.mark.parametrize("fused", [True, {"window": 1}])
def test_fused_training_runs_checks_and_stays_clean(tmp_path, fused):
    telemetry.enable()
    telemetry.reset()
    health.enable(policy="warn", interval=1)
    wf = _mlp(tmp_path, fused=fused)
    wf.run()
    m = health.monitor()
    # the window of 8 covers a TRAIN segment (2 minibatches) in one
    # window and one check; one step a minibatch checks each
    assert m.checks == (2 if fused is True else 4)
    assert m.violation_count == 0
    assert telemetry.gauge("health.params_norm").value > 0
    assert telemetry.counter("health.checks").value == m.checks
    # the detector took each TRAIN epoch's error percentage
    assert len(m.detector.state()["window"]) == 2
    assert m.detector.state()["window"][-1] == wf.decision.epoch_n_err_pt[2]


def test_fused_nan_params_trip_on_that_step(tmp_path):
    health.enable(policy="warn", interval=1)
    wf = _mlp(tmp_path, max_epochs=3, fused=True)
    trainer = wf.fused_trainer

    def poison():
        trainer.net.params[0]["w"][0, 0] = float("nan")
        health.monitor().violation_count = 0

    done = _poison_after_first_train_segment(wf, poison)
    wf.run()
    m = health.monitor()
    assert done and m.violation_count >= 1
    assert "NaN" in m.last_violation["reason"]
    assert m.last_violation["unit"] == "fused_trainer"


def test_unit_graph_gd_check_and_snapshot_policy(tmp_path):
    health.enable(policy="snapshot", interval=1)
    wf = _mlp(tmp_path, max_epochs=2)

    def poison():
        wf.forwards[0].weights.map_write()
        wf.forwards[0].weights.mem[0, 0] = numpy.nan

    _poison_after_first_train_segment(wf, poison)
    wf.run()
    m = health.monitor()
    assert m.violation_count >= 1
    assert m.last_violation["unit"].startswith("gd")
    assert glob.glob(str(tmp_path / "health_*.pickle")), \
        "the snapshot policy wrote nothing"


def test_halt_in_a_run_writes_one_crash_report(tmp_path):
    """The halt policy's report is the run's: the launcher adds none."""
    from znicz_tpu_torch.launcher import Launcher
    health.enable(policy="halt", interval=1)
    launcher = Launcher(device="cpu")
    wf, _ = launcher.load(lambda: _mlp(tmp_path, max_epochs=2,
                                       fused=True, init=False))
    _poison_after_first_train_segment(
        wf, lambda: wf.fused_trainer.net.params[0]["w"].fill_(
            float("inf")))
    with pytest.raises(health.HealthViolationError) as e:
        launcher.main()
    reports = glob.glob(str(tmp_path / "crash" / "crash_*"))
    assert reports == [e.value.crash_report]
