"""The port's profiler through real training loops, after
``tests/functional/test_profiler_workflow.py``, beside the JAX
package's on the same workflow (the MNIST MLP 784-16-10 on 60 / 30
synthetic rows at minibatch 30, 2 epochs, both packages' prng streams
1 and 2 seeded alike, the CPU):

* a fused run fills all three pillars: the window and the VALID
  predict registered with FLOPs inside the JAX test's band (0.3-2.5 of
  the analytic count) and within [0.85, 1.0] of the JAX package's count
  of the same entry kind (the port counts the products, XLA adds the
  elementwise work); a balanced ledger whose high water is at least
  its live bytes; a breakdown whose parts sum to wall within 5% and
  whose TRAIN windows and steps are JAX's;
* a unit-graph run records ``note_gd_step`` (a step a GD unit a
  minibatch, as in JAX) and the loader's data wait, and registers the
  GD updates under JAX's names;
* a run with the profiler off never builds profiler state;
* ``GET /debug/profile`` answers a loadable Chrome trace, 409 while
  another capture runs and 400 for a malformed ``seconds``; the other
  ``/debug/*`` views answer;
* ``python -m znicz_tpu_torch profile mnist --device cpu --out DIR``
  writes ``trace.json`` and a ``profiler_report.json`` whose keys are
  JAX's report keys (and ``device_ops``);
* the serving engine registers each bucket's first dispatch under the
  JAX engine's names and meta, and its resident parameters move in the
  ledger through evict and restore.
"""

import json
import urllib.error
import urllib.request

import pytest

from test_torch_workflow import _restored
from znicz_tpu.core import profiler as jax_profiler
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core import telemetry as jax_telemetry
from znicz_tpu.core.backends import JaxDevice
from znicz_tpu.samples import mnist as jax_mnist
from znicz_tpu_torch import __main__ as cli
from znicz_tpu_torch.core import profiler, prng, telemetry
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.status_server import StatusServer
from znicz_tpu_torch.samples import mnist

LAYERS = [{"type": "all2all_tanh", "->": {"output_sample_shape": 16}},
          {"type": "softmax", "->": {"output_sample_shape": 10}}]


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (profiler, telemetry, jax_profiler, jax_telemetry):
        mod.reset()
    yield
    for mod in (profiler, jax_profiler):
        mod.reset()
        mod.disable()
    for mod in (telemetry, jax_telemetry):
        mod.reset()
        mod.disable()
    root.common.profiler.capture_dir = None


def _mlp(pkg, tmp_path, fused=True):
    sample, streams, device = (
        (mnist, prng, "cpu") if pkg == "torch" else
        (jax_mnist, jax_prng, JaxDevice()))
    streams.get(1).seed(1234)
    streams.get(2).seed(5678)
    wf = sample.build(
        layers=LAYERS,
        loader_config={"synthetic_train": 60, "synthetic_valid": 30,
                       "minibatch_size": 30},
        decision_config={"max_epochs": 2, "fail_iterations": 50},
        snapshotter_config={"prefix": "prof", "interval": 10 ** 9,
                            "time_interval": 1e9, "compression": "",
                            "directory": str(tmp_path / pkg)},
        fused=fused)
    wf.initialize(device=device)
    return wf


def _armed_run(tmp_path, fused):
    for tel, prof in ((telemetry, profiler), (jax_telemetry, jax_profiler)):
        tel.enable()
        prof.enable()
    _mlp("jax", tmp_path, fused).run()
    _mlp("torch", tmp_path, fused).run()


def test_fused_run_populates_all_three_pillars(tmp_path):
    _armed_run(tmp_path, fused=True)
    registry = profiler.cost_registry()
    names = [e["name"] for e in registry]
    jax_names = [e["name"] for e in jax_profiler.cost_registry()]
    win = [e for e in registry if e["name"].startswith("fused.window")]
    jax_win = [e for e in jax_profiler.cost_registry()
               if e["name"].startswith("fused.window")]
    assert win and jax_win, (names, jax_names)
    for e, want in zip(win, jax_win):
        assert e["name"].rsplit(".", 1)[1] == want["name"].rsplit(".", 1)[1]
        assert e["meta"] == want["meta"]
        assert e["flops"] > 0 and e["bytes_accessed"] > 0
        assert 0.3 < e["flops_ratio_measured_vs_analytic"] < 2.5
        assert 0.85 <= e["flops"] / want["flops"] <= 1.0
    predicts = [n for n in names if n.startswith("fused.predict")]
    assert predicts == [n for n in jax_names
                        if n.startswith("fused.predict")]
    led = profiler.ledger_summary()
    assert led["allocs"] > 0 and led["balanced"], led
    assert led["high_water_bytes"] >= led["live_bytes"]
    bd, jax_bd = profiler.breakdown_summary(), jax_profiler.breakdown_summary()
    assert bd["verdict"] in profiler.VERDICTS
    assert (bd["windows"], bd["steps"]) == (jax_bd["windows"],
                                            jax_bd["steps"])
    total = sum(bd["parts_seconds"].values())
    assert abs(total - bd["wall_seconds"]) <= \
        max(0.05 * bd["wall_seconds"], 1e-3), bd
    snap = telemetry.snapshot()
    assert snap["gauges"].get("profiler.executables", 0) >= 1
    assert "profiler.device_seconds" in snap["histograms"]


def test_unit_graph_run_records_gd_steps_and_data_wait(tmp_path):
    _armed_run(tmp_path, fused=None)
    bd, jax_bd = profiler.breakdown_summary(), jax_profiler.breakdown_summary()
    assert bd["steps"] == jax_bd["steps"] > 0
    assert bd["windows"] == jax_bd["windows"] == 0
    assert bd["parts_seconds"]["data_wait"] > 0
    assert bd["parts_seconds"]["dispatch"] > 0
    total = sum(bd["parts_seconds"].values())
    assert abs(total - bd["wall_seconds"]) <= 5e-6
    updates = sorted(e["name"] for e in profiler.cost_registry())
    assert updates == sorted(e["name"] for e in jax_profiler.cost_registry()
                             if e["name"].startswith("gd.update"))
    for e in profiler.cost_registry():
        assert e["bytes_accessed"] > 0 and e["meta"]["param_elements"] > 0
    led = profiler.ledger_summary()
    assert led["balanced"] and led["allocs"] > 0
    assert "weights" in led["by_name"]


def test_disabled_profiler_run_touches_nothing(tmp_path, monkeypatch):
    profiler.disable()

    def boom(*args, **kwargs):
        raise AssertionError("profiler state touched while disabled")

    monkeypatch.setattr(profiler, "_prof", boom)
    _mlp("torch", tmp_path).run()
    _mlp("torch", tmp_path, fused=None).run()
    assert profiler._state is None


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_debug_profile_returns_loadable_trace(tmp_path):
    profiler.disable()   # the request is the opt-in
    root.common.profiler.capture_dir = str(tmp_path / "profiles")
    server = StatusServer(None, port=0).start()
    base = "http://127.0.0.1:%d" % server.port
    try:
        status, doc = _get(base, "/debug/profile?seconds=0.2")
        assert status == 200 and doc["files"] == ["trace.json"]
        with open(doc["trace"]) as f:
            trace = json.load(f)
        assert trace["traceEvents"]
        # a concurrent capture is refused, not queued: another device
        # trace (the CLI's) holds the profiler's guard
        with profiler.traced(str(tmp_path / "cli"), cuda=False):
            with pytest.raises(urllib.error.HTTPError) as excinfo:
                urllib.request.urlopen(base + "/debug/profile?seconds=0.1",
                                       timeout=30)
            assert excinfo.value.code == 409
        with pytest.raises(urllib.error.HTTPError) as excinfo:
            urllib.request.urlopen(base + "/debug/profile?seconds=x",
                                   timeout=10)
        assert excinfo.value.code == 400
        status, doc = _get(base, "/debug/profiler")
        assert status == 200 and set(jax_profiler.snapshot()) <= set(doc)
        status, doc = _get(base, "/debug/timeseries")
        assert status == 200 and "series" in doc
        status, doc = _get(base, "/debug/pyprof?seconds=0.1")
        assert doc == {"enabled": False}
        status, doc = _get(base, "/debug/blackbox")
        assert doc == {"enabled": False, "armed": False}
    finally:
        server.stop()


def test_debug_captures_share_one_guard(tmp_path):
    """The two capture endpoints share one guard: while a pyprof
    capture runs, a profile request answers 409."""
    import threading
    from znicz_tpu_torch.core import pyprof, status_server
    root.common.profiler.capture_dir = str(tmp_path / "profiles")
    with _restored(root.common.profiler.pyprof):
        pyprof.enable(gil_probe=False)
        server = StatusServer(None, port=0).start()
        base = "http://127.0.0.1:%d" % server.port
        try:
            assert status_server._capture_guard.acquire(blocking=False)
            try:
                for path in ("/debug/profile?seconds=0.1",
                             "/debug/pyprof?seconds=0.1"):
                    with pytest.raises(urllib.error.HTTPError) as excinfo:
                        urllib.request.urlopen(base + path, timeout=30)
                    assert excinfo.value.code == 409
            finally:
                status_server._capture_guard.release()
            status, doc = _get(base, "/debug/pyprof?seconds=0.1")
            assert status == 200 and doc["enabled"] is True
            with urllib.request.urlopen(
                    base + "/debug/pyprof?seconds=0.1&format=collapsed",
                    timeout=30) as r:
                assert r.headers["Content-Type"].startswith("text/plain")
            assert "znicz:pyprof-sampler" in {
                t.name for t in threading.enumerate()}
        finally:
            server.stop()
            pyprof.reset()


def test_profile_cli_writes_jaxs_report_keys(tmp_path, capsys):
    out = tmp_path / "prof"
    argv = ["profile", "mnist", "--device", "cpu", "--out", str(out),
            "--config", "mnistr.loader.synthetic_train=60",
            "--config", "mnistr.loader.synthetic_valid=30",
            "--config", "mnistr.loader.minibatch_size=30",
            "--config", "mnistr.decision.max_epochs=1",
            "--config", "mnistr.snapshotter.directory=%s" % tmp_path,
            "--fused"]
    with _restored(root.mnistr, root.mnistr.loader, root.mnistr.decision,
                   root.mnistr.snapshotter):
        assert cli.main(argv) == 0
    printed = capsys.readouterr().out
    assert "profiler report ->" in printed and "step breakdown:" in printed
    with open(out / "profiler_report.json") as f:
        doc = json.load(f)
    assert set(doc) == set(jax_profiler.snapshot()) | {"device_ops"}
    assert doc["enabled"] is True and doc["ledger"]["balanced"]
    assert any(e["name"].startswith("fused.window")
               for e in doc["cost_registry"])
    assert doc["breakdown"]["verdict"] in jax_profiler.VERDICTS
    assert doc["device_ops"]["events"] == 0    # the CPU: no device events
    with open(out / "trace.json") as f:
        assert json.load(f)["traceEvents"]


@pytest.mark.parametrize("name,dtype", [(None, "f32"), ("m", "bf16")])
def test_engine_buckets_and_ledger_match_jaxs(name, dtype):
    """The serving engine under the armed profiler, beside the JAX
    package's on the same narrow AlexNet package: each bucket's first
    dispatch registers ``serving.forward[.<name>].b<bucket>[.<dtype>]``
    with JAX's meta (and once only); the port's entries count the
    forward's products, and the ledger holds the resident parameters
    as ``serving.model.<name>`` through evict and restore."""
    import numpy
    from test_torch_engine import NARROW
    from znicz_tpu.serving.engine import InferenceEngine as JaxEngine
    from znicz_tpu_torch.samples import alexnet
    from znicz_tpu_torch.serving.engine import InferenceEngine
    package = alexnet.init_package(7, size=35, layers=NARROW)
    x = numpy.random.RandomState(3).uniform(
        -1, 1, (3, 35, 35, 3)).astype(numpy.float32)
    for prof in (profiler, jax_profiler):
        prof.enable()
    engines = {
        "torch": InferenceEngine(package, max_batch=4, device="cpu",
                                 dtype=dtype, name=name, warmup=False),
        "jax": JaxEngine(package, max_batch=4, dtype=dtype, name=name,
                         warmup=False)}
    for engine in engines.values():
        engine.predict(x)
        engine.predict(x[:1])
        engine.predict(x)
    got, want = profiler.cost_registry(), jax_profiler.cost_registry()
    assert [e["name"] for e in got] == [e["name"] for e in want]
    assert [e["meta"] for e in got] == [e["meta"] for e in want]
    assert all(e["flops"] > 0 and e["bytes_accessed"] > 0 for e in got)
    engine = engines["torch"]
    label = "serving.model.%s" % (name or "default")
    resident = engine.device_bytes
    assert profiler.ledger_summary()["by_name"] == {label: resident}
    engine.evict()
    assert profiler.ledger_summary()["by_name"] == {}
    engine.restore()
    led = profiler.ledger_summary()
    assert led["by_name"] == {label: resident} and led["balanced"]
