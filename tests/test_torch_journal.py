"""The port's flight-recorder events and serving series held to the
names and attributes ``znicz_tpu`` records for the same action.

Each case runs one action through the JAX package and through the port
(telemetry on in both configs) and compares the journal events it
left: a workflow's ``config`` and ``workflow.run``, a
``snapshot.restore``, an engine's ``serving.reload`` /
``serving.evict`` / ``serving.restore``, a breaker's
``serving.breaker`` transitions, a registry's ``registry.add`` /
``registry.remove``, and ``serving.slow_request`` from both batchers.
Then the series a continuous batcher records for one request, and the
micro-batcher's ``assembly_seconds`` and ``pad_overhead``.  The pins
of ``tests/functional/test_serving.py`` (the reload event, slow-request
logging) and ``test_model_registry.py`` (``registry.add``) hold on the
port too.
"""

import logging

import numpy
import pytest

from test_torch_mnist import _one_torch_thread  # noqa: F401
from znicz_tpu.core import telemetry as jax_telemetry
from znicz_tpu.core.config import root as jax_root
from znicz_tpu.core.workflow import Workflow as JaxWorkflow
from znicz_tpu.serving.batcher import MicroBatcher as JaxMicroBatcher
from znicz_tpu.serving.breaker import CircuitBreaker as JaxBreaker
from znicz_tpu.serving.continuous import ContinuousBatcher as JaxContinuous
from znicz_tpu.serving.engine import InferenceEngine as JaxEngine
from znicz_tpu.serving.registry import ModelRegistry as JaxRegistry
from znicz_tpu.testing import build_fc_package_zip
from znicz_tpu.units import nn_units as jax_nn_units
from znicz_tpu_torch.core import telemetry
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.workflow import Workflow
from znicz_tpu_torch.serving.batcher import MicroBatcher
from znicz_tpu_torch.serving.breaker import CircuitBreaker
from znicz_tpu_torch.serving.continuous import ContinuousBatcher
from znicz_tpu_torch.serving.engine import InferenceEngine
from znicz_tpu_torch.serving.registry import ModelRegistry
from znicz_tpu_torch.units import nn_units

DIMS = [12, 16, 5]
#: the stamps every event carries (not the action's attributes)
STAMPS = ("t", "elapsed", "kind", "wall", "pid", "role")


@pytest.fixture
def journals(monkeypatch):
    """Telemetry on in both packages, both journals empty."""
    for cfg in (root, jax_root):
        monkeypatch.setattr(cfg.common.telemetry, "enabled", True)
    telemetry.reset()
    jax_telemetry.reset()


@pytest.fixture
def package(tmp_path):
    return build_fc_package_zip(str(tmp_path / "fc.zip"), DIMS, seed=3)


def _events(module, kind):
    return [{k: v for k, v in e.items() if k not in STAMPS}
            for e in module.journal_events() if e["kind"] == kind]


def _both(kind):
    return _events(jax_telemetry, kind), _events(telemetry, kind)


def _x(rows, seed=0):
    return numpy.random.RandomState(seed).uniform(
        -1.0, 1.0, (rows, DIMS[0])).astype(numpy.float32)


def test_workflow_config_and_run(journals):
    for cls in (JaxWorkflow, Workflow):
        wf = cls(None, name="journaled")
        wf.initialize()
        wf.run()
    jax_cfg, cfg = _both("config")
    assert len(jax_cfg) == len(cfg) == 1
    assert set(jax_cfg[0]) == set(cfg[0]) == {"workflow", "config"}
    assert cfg[0]["workflow"] == jax_cfg[0]["workflow"] == "journaled"
    assert cfg[0]["config"]["common"]["telemetry"]["enabled"] is True
    assert _both("workflow.run")[0] == _both("workflow.run")[1] == \
        [{"workflow": "journaled"}]


def test_snapshot_restore(journals):
    class Stub(object):
        name = "restored"
        units = []

    state = {"units": {}, "suffix": "3_epoch"}
    jax_nn_units.load_snapshot_into_workflow(dict(state), Stub())
    nn_units.load_snapshot_into_workflow(dict(state), Stub())
    got = _both("snapshot.restore")
    assert got[0] == got[1] == [{"workflow": "restored",
                                 "suffix": "3_epoch"}]


def test_engine_reload_evict_restore(journals, package, tmp_path):
    other = build_fc_package_zip(str(tmp_path / "other.zip"), DIMS, seed=4)
    engines = (JaxEngine(package, max_batch=4, name="m"),
               InferenceEngine(package, max_batch=4, name="m",
                               device="cpu"))
    for engine in engines:
        engine.load(other)
        assert engine.evict()
        assert engine.restore()
    for kind in ("serving.reload", "serving.evict", "serving.restore"):
        got = _both(kind)
        assert got[0] == got[1], kind
    reloads = _both("serving.reload")[1]
    assert [e["version"] for e in reloads] == [1, 2]
    assert reloads[1] == {"version": 2, "source": other,
                          "topology_changed": False,
                          "serve_dtype": "f32", "model": "m"}
    evict = _both("serving.evict")[1]
    assert evict == [{"version": 2, "model": "m", "released_bytes":
                      engines[1].device_bytes}]


def test_breaker_transitions(journals):
    class Clock(object):
        t = 100.0

        def __call__(self):
            return self.t

    clock = Clock()
    for cls in (JaxBreaker, CircuitBreaker):
        breaker = cls("serving.m.b4", threshold=2, cooldown_s=1.0,
                      clock=clock)
        breaker.record_failure()
        breaker.record_failure()          # closed -> open
        clock.t += 2.0
        assert breaker.allow()            # open -> half_open
        breaker.record_failure()          # half_open -> open
        clock.t += 2.0
        assert breaker.allow()
        breaker.record_success()          # half_open -> closed
        clock.t = 100.0
    got = _both("serving.breaker")
    assert got[0] == got[1]
    assert [(e["previous"], e["state"]) for e in got[1]] == [
        ("closed", "open"), ("open", "half_open"), ("half_open", "open"),
        ("open", "half_open"), ("half_open", "closed")]
    assert got[1][0] == {"name": "serving.m.b4", "state": "open",
                         "previous": "closed", "failures": 2}


def test_registry_add_and_remove(journals, package):
    for registry in (JaxRegistry(max_batch=4, warmup=False),
                     ModelRegistry(max_batch=4, warmup=False,
                                   device="cpu")):
        registry.add("m", package)
        registry.add("n", package)
        registry.remove("m")
    for kind in ("registry.add", "registry.remove"):
        got = _both(kind)
        assert got[0] == got[1], kind
    assert _both("registry.add")[1][0] == {
        "model": "m", "version": 1, "source": package,
        "serve_dtype": "f32"}
    assert _both("registry.remove")[1] == [{"model": "m"}]


@pytest.fixture
def slow_everything(monkeypatch):
    """Every request is a slow one."""
    for cfg in (root, jax_root):
        monkeypatch.setattr(cfg.common.serving, "slow_request_ms", 1e-6)


def _slow_fields(events):
    """The deterministic part of a slow-request event: its keys, and
    the values that do not depend on the clock."""
    return [(sorted(e), {k: e[k] for k in ("rid", "model", "rows",
                                           "batch_rows", "bucket",
                                           "trace_sampled") if k in e})
            for e in events]


def test_slow_request_from_the_continuous_batcher(journals, package,
                                                  slow_everything, caplog):
    for reg_cls, batcher_cls, kw in (
            (JaxRegistry, JaxContinuous, {}),
            (ModelRegistry, ContinuousBatcher, {"device": "cpu"})):
        registry = reg_cls(max_batch=4, warmup=False, **kw)
        registry.add("m", package)
        batcher = batcher_cls(registry, max_inflight=1).start()
        try:
            with caplog.at_level(logging.WARNING):
                batcher.predict(_x(3), model="m", request_id="slow-1")
        finally:
            batcher.stop()
    got = _both("serving.slow_request")
    assert _slow_fields(got[0]) == _slow_fields(got[1])
    assert got[1][0]["rid"] == "slow-1" and got[1][0]["bucket"] == 4
    assert got[1][0]["model"] == "m"
    assert sum("slow request slow-1" in r.getMessage()
               for r in caplog.records) == 2


def test_slow_request_from_the_micro_batcher(journals, package,
                                             slow_everything):
    for engine_cls, batcher_cls, kw in (
            (JaxEngine, JaxMicroBatcher, {}),
            (InferenceEngine, MicroBatcher, {"device": "cpu"})):
        batcher = batcher_cls(engine_cls(package, max_batch=4, **kw),
                              max_delay_ms=0.0).start()
        try:
            batcher.predict(_x(2), request_id="slow-2")
        finally:
            batcher.stop()
    got = _both("serving.slow_request")
    assert _slow_fields(got[0]) == _slow_fields(got[1])
    assert "model" not in got[1][0]


def test_slow_request_off_at_zero(journals, package, monkeypatch):
    monkeypatch.setattr(root.common.serving, "slow_request_ms", 0)
    registry = ModelRegistry(max_batch=4, warmup=False, device="cpu")
    registry.add("m", package)
    batcher = ContinuousBatcher(registry).start()
    try:
        batcher.predict(_x(1), model="m", request_id="fast")
    finally:
        batcher.stop()
    assert _both("serving.slow_request")[1] == []


#: the continuous batcher's series that JAX records and the port did not
CONTINUOUS_SERIES = (
    "serving.batch_rows", "serving.batch_fill",
    "serving.assembly_seconds", "serving.pad_overhead",
    "serving.request_seconds", "serving.request_seconds.priority_normal",
    "serving.request_seconds.priority_high",
    "serving.request_seconds.model_m", "serving.queue_wait_seconds",
    "serving.queue_wait_seconds.model_m", "serving.device_seconds")


def test_continuous_batcher_series(journals, package):
    for reg_cls, batcher_cls, kw in (
            (JaxRegistry, JaxContinuous, {}),
            (ModelRegistry, ContinuousBatcher, {"device": "cpu"})):
        registry = reg_cls(max_batch=4, warmup=False, **kw)
        registry.add("m", package)
        batcher = batcher_cls(registry, max_inflight=1).start()
        try:
            batcher.predict(_x(3), model="m", request_id="s-1")
            batcher.predict(_x(1), model="m", request_id="s-2",
                            priority="high")
        finally:
            batcher.stop()
    jax_snap, snap = jax_telemetry.snapshot(), telemetry.snapshot()
    for name in CONTINUOUS_SERIES:
        assert snap["histograms"][name]["count"] == \
            jax_snap["histograms"][name]["count"], name
    assert snap["histograms"]["serving.pad_overhead"]["sum"] == \
        pytest.approx(jax_snap["histograms"]["serving.pad_overhead"]["sum"])
    assert snap["counters"]["serving.batches"] == \
        jax_snap["counters"]["serving.batches"] == 2
    assert snap["gauges"]["serving.inflight"] == \
        jax_snap["gauges"]["serving.inflight"] == 0


def test_micro_batcher_series(journals, package):
    for engine_cls, batcher_cls, kw in (
            (JaxEngine, JaxMicroBatcher, {}),
            (InferenceEngine, MicroBatcher, {"device": "cpu"})):
        batcher = batcher_cls(engine_cls(package, max_batch=4, **kw),
                              max_delay_ms=0.0).start()
        try:
            batcher.predict(_x(3), request_id="u-1")
        finally:
            batcher.stop()
    jax_snap, snap = jax_telemetry.snapshot(), telemetry.snapshot()
    for name in ("serving.assembly_seconds", "serving.pad_overhead",
                 "serving.batch_fill", "serving.request_seconds"):
        assert snap["histograms"][name]["count"] == \
            jax_snap["histograms"][name]["count"] == 1, name
    assert snap["histograms"]["serving.pad_overhead"]["sum"] == \
        jax_snap["histograms"]["serving.pad_overhead"]["sum"] == 0.25


def test_help_for_equals_jaxs_outside_its_compile_family():
    from znicz_tpu_torch.serving import (autoscaler, release,  # noqa: F401
                                         router)
    from znicz_tpu.serving import autoscaler as ja, release as jr  # noqa
    from znicz_tpu.serving import router as jrouter  # noqa: F401
    for name in ("serving.request_seconds.model_m", "serving.pad_overhead",
                 "registry.add", "release.state.gen_2.model_m",
                 "fleet.autoscaler_scale_ups", "fleet.replicas_up",
                 "router.retries", "slo.burn_rate", "wire.frames_in",
                 "timeseries.sweeps", "pyprof.samples",
                 "health.grad_norm", "faults.injected", "somewhere.else"):
        assert telemetry.help_for(name) == jax_telemetry.help_for(name), \
            name
    assert telemetry.register_help("x.y", "mine") == "x.y"
    assert telemetry.help_for("x.y.z") == "mine"
