"""The public names the port's core lacked, held against ``znicz_tpu``.

* ``Unit.unlink_all`` / ``links_to`` / ``stop``, ``Workflow.del_ref``,
  ``stop`` / ``stopped`` and ``on_workflow_finished``, the launcher's
  ``add_ref`` / ``del_ref`` / ``stop`` (JAX's ``DummyLauncher``): the same graph
  edits and the same runs in both packages; the port's callbacks also
  run when the run raises (the avatar's thread is joined either way).
* The knob registry (``declare``, ``declared_knobs``,
  ``declared_nodes``, ``knob_declared``), ``dtype_map`` and the
  ``common.disable`` node, as JAX's.
* The telemetry functions ``instant``, ``merged_snapshot``,
  ``summary``, ``serving_summary`` and ``parse_prometheus`` against
  JAX's on the same recorded series (JAX's compile counters left out).
* ``get_metric_names`` / ``get_metric_values`` of the decision and the
  evaluator after the same Wine run, in float64.
* ``SnapshotterToDB``, ``DropoutFixer``, the downloader (a ``file://``
  tar: no test reaches the network) and the headless shell, as
  JAX's ``tests/unit/test_observability.py:147-189``.
"""

import os
import tarfile

import numpy
import pytest

import znicz_tpu.loader.loader_wine  # noqa: F401
import znicz_tpu_torch.loader.loader_wine  # noqa: F401
from test_torch_mnist import _restored, f64  # noqa: F401
from znicz_tpu.core import config as jax_config
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core import telemetry as jax_telemetry
from znicz_tpu.core.backends import JaxDevice
from znicz_tpu.core.downloader import Downloader as JaxDownloader
from znicz_tpu.core.interaction import Shell as JaxShell
from znicz_tpu.core.snapshotter import SnapshotterToDB as JaxToDB
from znicz_tpu.core.units import Unit as JaxUnit
from znicz_tpu.core.workflow import DummyWorkflow as JaxWorkflow
from znicz_tpu.standard_workflow import StandardWorkflow as JaxStandard
from znicz_tpu.units.dropout import DropoutFixer as JaxFixer
from znicz_tpu_torch.core import config, prng, telemetry
from znicz_tpu_torch.core.downloader import Downloader
from znicz_tpu_torch.core.interaction import Shell
from znicz_tpu_torch.core.snapshotter import (SnapshotterRegistry,
                                              SnapshotterToDB,
                                              SnapshotterToFile)
from znicz_tpu_torch.core.units import Unit
from znicz_tpu_torch.core.workflow import Workflow
from znicz_tpu_torch.standard_workflow import StandardWorkflow
from znicz_tpu_torch.units.dropout import DropoutFixer, DropoutForward
from znicz_tpu_torch.units.nn_units import load_snapshot_into_workflow

WINE = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 12,
                                    "weights_stddev": 0.05,
                                    "bias_stddev": 0.05},
     "<-": {"learning_rate": 0.3}},
    {"type": "softmax", "->": {"output_sample_shape": 3,
                               "weights_stddev": 0.05,
                               "bias_stddev": 0.05},
     "<-": {"learning_rate": 0.3}},
]
PKGS = {"torch": (Workflow, Unit), "jax": (JaxWorkflow, JaxUnit)}


def _graph(pkg):
    wf_cls, unit_cls = PKGS[pkg]
    wf = wf_cls()
    a, b, c = (unit_cls(wf, name=n) for n in "abc")
    b.link_from(a)
    c.link_from(a, b)
    a.link_from(wf.start_point)
    wf.end_point.link_from(c)
    return wf, a, b, c


def _edges(units):
    return sorted((u.name, d.name) for u in units for d in u.links_to)


# -- units and workflow ------------------------------------------------------

@pytest.mark.parametrize("which", ["a", "b", "c"])
def test_unlink_all_drops_the_same_edges_as_jax(which):
    got, want = [], []
    for pkg, out in (("torch", got), ("jax", want)):
        wf, a, b, c = _graph(pkg)
        unit = {"a": a, "b": b, "c": c}[which]
        assert unit.unlink_all() is unit
        assert not unit.links_from and not unit.links_to
        out.append(_edges(wf.units))
    assert got == want


def test_del_ref_takes_the_unit_out_and_keeps_its_links():
    for pkg in PKGS:
        wf, a, b, c = _graph(pkg)
        wf.del_ref(b)
        assert b not in wf.units and b.workflow is None
        assert a in b.links_from and c in b.links_to
        wf.del_ref(b)   # a second time: nothing to do
        assert [u.name for u in wf.units] == ["start_point", "end_point",
                                              "a", "c"]


class _Counting(object):
    """A unit class whose run counts and, at run ``stop_at``, stops its
    workflow."""

    @staticmethod
    def make(unit_cls):
        class Counter(unit_cls):
            def __init__(self, workflow, **kwargs):
                super(Counter, self).__init__(workflow, **kwargs)
                self.runs = 0
                self.stop_at = kwargs.get("stop_at")

            def run(self):
                self.runs += 1
                if self.runs == self.stop_at:
                    self.workflow.stop()
        return Counter


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_stop_ends_the_run_after_the_unit_firing(pkg):
    wf_cls, unit_cls = PKGS[pkg]
    counter = _Counting.make(unit_cls)
    wf = wf_cls()
    a = counter(wf, name="a", stop_at=1)
    b = counter(wf, name="b")
    a.link_from(wf.start_point)
    b.link_from(a)
    wf.end_point.link_from(b)
    assert wf.stopped()
    wf.run()
    assert (a.runs, b.runs) == (1, 0)
    assert wf.stopped()
    a.stop()   # a unit's stop is a hook that does nothing by default


def test_the_launcher_registers_and_stops_its_workflow():
    from znicz_tpu.core.workflow import DummyLauncher
    from znicz_tpu_torch.launcher import Launcher
    for launcher, wf_cls, unit_cls in ((Launcher(device="cpu"), Workflow,
                                        Unit),
                                       (DummyLauncher(), JaxWorkflow,
                                        JaxUnit)):
        counter = _Counting.make(unit_cls)
        wf = wf_cls()
        launcher.add_ref(wf)
        assert launcher.workflow is wf
        a = counter(wf, name="a")
        a.link_from(wf.start_point)
        a.run = lambda: launcher.stop()   # the launcher stops the run
        b = counter(wf, name="b")
        b.link_from(a)
        wf.run()
        assert b.runs == 0 and wf.stopped()
        launcher.del_ref(wf)
        assert launcher.workflow is wf


def test_on_workflow_finished_runs_once_a_run_as_in_jax():
    calls = {}
    for pkg in PKGS:
        wf, *_ = _graph(pkg)
        calls[pkg] = []
        wf.on_workflow_finished(lambda p=pkg: calls[p].append("done"))
        wf.on_workflow_finished(None)   # ignored, as in JAX
        wf.run()
        wf.run()
    assert calls["torch"] == calls["jax"] == ["done", "done"]


def test_on_workflow_finished_runs_when_the_run_raises():
    class Boom(Unit):
        def run(self):
            raise KeyError("boom")

    wf = Workflow()
    boom = Boom(wf, name="boom")
    boom.link_from(wf.start_point)
    wf.end_point.link_from(boom)
    seen = []

    def failing():
        seen.append("second")
        raise ValueError("a callback's own error")
    wf.on_workflow_finished(lambda: seen.append("first"))
    wf.on_workflow_finished(failing)
    with pytest.raises(KeyError, match="boom"):
        wf.run()
    assert seen == ["first", "second"] and wf.stopped()


# -- config ------------------------------------------------------------------

def test_disable_and_interactive_defaults_as_in_jax():
    assert config.root.common.disable.get("plotting") is True
    assert jax_config.root.common.disable.get("plotting") is True
    assert config.root.common.get("interactive") is False
    for path in ("common.disable.plotting", "common.interactive",
                 "common.dirs.cache", "common.faults.rules",
                 "common.engine.precision_dtype"):
        assert path in config.declared_knobs()
        assert path in jax_config.declared_knobs()
    # JAX declares these and reads them nowhere (its publisher writes
    # whatever disable.publishing says, its trainers follow
    # precision_dtype): the port leaves them out
    for path in ("common.disable.publishing",
                 "common.engine.precision_type"):
        assert path not in config.declared_knobs()
        assert path in jax_config.declared_knobs()
    for path in ("common", "common.disable", "common.serving"):
        assert path in config.declared_nodes()
        assert path in jax_config.declared_nodes()


def test_declare_registers_as_jax_does():
    got, want = [], []
    for mod, out in ((config, got), (jax_config, want)):
        root = mod.root
        root.gaps_test.preset = 7     # an override set before it is declared
        try:
            mod.declare("gaps_test.scalar", 3)
            mod.declare("gaps_test.preset", 5)
            mod.declare("gaps_test.ns", {"a": 1, "b": {"c": 2}, "open": {}})
            mod.declare("gaps_test.payload", {})
            with pytest.raises(ValueError):
                mod.declare("gaps_test.scalar.under", 1)
            with pytest.raises(ValueError):
                mod.declare("gaps_test..x", 1)
            out.append((
                root.gaps_test.scalar, root.gaps_test.preset,
                root.gaps_test.ns.a, root.gaps_test.ns.b.c,
                sorted(k for k in mod.declared_knobs()
                       if k.startswith("gaps_test")),
                sorted(k for k in mod.declared_nodes()
                       if k.startswith("gaps_test")),
                [mod.knob_declared(p) for p in (
                    "gaps_test.ns.b", "gaps_test.ns.b.c",
                    "gaps_test.payload.site.kind", "gaps_test.missing")]))
        finally:
            del root.__dict__["gaps_test"]
            for reg in (mod._KNOBS, mod._NODES):
                for k in [k for k in reg if k.startswith("gaps_test")]:
                    reg.discard(k)
    assert got == want
    assert got[0][:4] == (3, 7, 1, 2)


@pytest.mark.parametrize("spelling,want", [
    ("float", numpy.float32), ("f32", numpy.float32),
    ("float32", numpy.float32), ("double", numpy.float64),
    ("f64", numpy.float64), ("float64", numpy.float64)])
def test_dtype_map_as_in_jax(spelling, want):
    """JAX's spelling of a precision and the port's one knob set to
    that dtype map to the same numpy dtype."""
    with _restored(config.root.common.engine,
                   jax_config.root.common.engine):
        config.root.common.engine.precision_dtype = want
        jax_config.root.common.engine.precision_type = spelling
        assert config.dtype_map() == jax_config.dtype_map() == want


def test_dtype_map_default_and_unknown_value():
    """Unset, the port computes in float32, JAX's default ``float``;
    a value that names no dtype raises in both."""
    with _restored(config.root.common.engine,
                   jax_config.root.common.engine):
        config.root.common.engine.precision_dtype = None
        assert config.dtype_map() is numpy.float32
        assert jax_config.dtype_map() is numpy.float32
        config.root.common.engine.precision_dtype = "half-ish"
        with pytest.raises(TypeError):
            config.dtype_map()
        jax_config.root.common.engine.precision_type = "half-ish"
        with pytest.raises(ValueError, match="accepted"):
            jax_config.dtype_map()


# -- telemetry ---------------------------------------------------------------

@pytest.fixture
def both_telemetry():
    saved = (telemetry.enabled(), jax_telemetry.enabled())
    for mod in (telemetry, jax_telemetry):
        mod.reset()
        mod.enable()
    yield
    for mod, on in zip((telemetry, jax_telemetry), saved):
        mod.reset()
        mod.enable() if on else mod.disable()


def _record(mod):
    mod.counter("transfer.d2h_bytes").inc(4096)
    mod.counter("transfer.d2h_calls").inc(3)
    mod.counter("transfer.h2d_bytes").inc(1 << 20)
    mod.counter("trainer.readbacks").inc(2)
    mod.gauge("trainer.data_shards").set(1)
    mod.counter("serving.rejected").inc(2)
    mod.counter("serving.batches").inc(5)
    mod.counter("serving.compiles.bucket_8").inc(1)
    for i, v in enumerate((0.004, 0.011, 0.002, 0.031, 0.007)):
        mod.histogram("trainer.step_seconds").observe(v)
        mod.histogram("serving.request_seconds").observe(v * 2)
        mod.histogram("serving.batch_fill").observe(0.25 * (i % 4 + 1))
        mod.histogram("serving.queue_wait_seconds").observe(v / 3)
        mod.histogram("serving.device_seconds").observe(v / 2)
    mod.instant("loader.epoch_end", epoch=3)


def test_summaries_equal_jax_on_the_same_series(both_telemetry):
    _record(telemetry)
    _record(jax_telemetry)
    want = jax_telemetry.summary()
    for key in ("backend_compiles", "jaxpr_traces", "compile_seconds_total"):
        want.pop(key, None)   # the JAX package's compile counters
    got = telemetry.summary()
    assert got == want
    assert got["serving"]["bucket_compiles"] == {
        "serving.compiles.bucket_8": 1}
    assert telemetry.serving_summary() == jax_telemetry.serving_summary()
    merged, jax_merged = telemetry.merged_snapshot(), \
        jax_telemetry.merged_snapshot()
    assert merged == telemetry.snapshot()
    for kind in ("counters", "gauges"):
        assert merged[kind] == jax_merged[kind]
    for name, st in merged["histograms"].items():
        assert {k: jax_merged["histograms"][name][k] for k in st} == st


def test_serving_summary_none_without_requests(both_telemetry):
    telemetry.counter("serving.batches").inc()
    assert telemetry.serving_summary() is None
    assert "serving" not in telemetry.summary()


def test_instant_markers_as_in_jax(both_telemetry):
    _record(telemetry)
    _record(jax_telemetry)
    got = [(e["name"], e["ph"], e.get("args")) for e in
           telemetry.trace_events()]
    want = [(e["name"], e["ph"], e.get("args")) for e in
            jax_telemetry.trace_events() if e["ph"] == "i"]
    assert got == want == [("loader.epoch_end", "i", {"epoch": 3})]
    telemetry.disable()
    telemetry.instant("ignored")
    assert len(telemetry.trace_events()) == 1


def test_parse_prometheus_as_in_jax(both_telemetry):
    _record(telemetry)
    _record(jax_telemetry)
    got = telemetry.parse_prometheus(telemetry.prometheus_text())
    want = jax_telemetry.parse_prometheus(jax_telemetry.prometheus_text())
    assert got == {k: v for k, v in want.items() if k in got}
    assert got["znicz_trainer_step_seconds"] == "histogram"
    assert got["znicz_transfer_d2h_bytes"] == "counter"
    for mod in (telemetry, jax_telemetry):
        with pytest.raises(ValueError, match="bad exposition line"):
            mod.parse_prometheus("# TYPE znicz_x counter\nznicz x 1\n")


# -- metrics, snapshots, dropout ----------------------------------------------

def _wine(pkg, tmp_path, **kwargs):
    streams = prng if pkg == "torch" else jax_prng
    streams.get(1).seed(1234)
    streams.get(2).seed(5678)
    cls = StandardWorkflow if pkg == "torch" else JaxStandard
    wf = cls(None, layers=[dict(layer) for layer in WINE],
             loader_name="wine_loader", loader_config={"minibatch_size": 10},
             decision_config={"max_epochs": 3, "fail_iterations": 50},
             snapshotter_config={"prefix": "gaps_" + pkg, "interval": 1,
                                 "time_interval": 0, "compression": "",
                                 "directory": str(tmp_path / pkg)},
             **kwargs)
    wf.initialize(device="cpu" if pkg == "torch" else JaxDevice())
    wf.run()
    return wf


def test_metric_names_and_values_as_in_jax(f64, tmp_path):
    twf, jwf = _wine("torch", tmp_path), _wine("jax", tmp_path)
    for unit in ("decision", "evaluator"):
        t, j = getattr(twf, unit), getattr(jwf, unit)
        assert t.get_metric_names() == j.get_metric_names()
    assert twf.decision.get_metric_values() == \
        jwf.decision.get_metric_values()
    assert twf.evaluator.get_metric_values() == {} == \
        jwf.evaluator.get_metric_values()
    twf.decision.testing = True
    assert twf.decision.get_metric_names() == set() and \
        twf.decision.get_metric_values() == {}


def test_snapshotter_to_db_writes_file_snapshots(f64, tmp_path):
    """A known difference: JAX's ``odbc`` stand-in raises at its first
    export (its base has no ``_forward_topology``); the port's writes
    what the file snapshotter writes, held here against JAX's file
    snapshots of the same run."""
    assert SnapshotterRegistry.mapping["odbc"] is SnapshotterToDB
    assert JaxToDB.MAPPING == SnapshotterToDB.MAPPING == "odbc"
    with pytest.raises(AttributeError, match="_forward_topology"):
        _wine("jax", tmp_path / "odbc", snapshotter_name="odbc")
    got = {}
    for pkg, name in (("torch", "odbc"), ("jax", "nnfile")):
        wf = _wine(pkg, tmp_path, snapshotter_name=name)
        files = sorted(os.listdir(str(tmp_path / pkg)))
        assert files and all(f.startswith("gaps_" + pkg) for f in files)
        got[pkg] = (wf, os.path.join(str(tmp_path / pkg), files[-1]))
    assert type(got["torch"][0].snapshotter) is SnapshotterToDB
    state = SnapshotterToFile.import_(got["torch"][1])
    from znicz_tpu.core.snapshotter import SnapshotterToFile as JaxToFile
    jstate = JaxToFile.import_(got["jax"][1])
    assert len(os.listdir(str(tmp_path / "torch"))) == \
        len(os.listdir(str(tmp_path / "jax")))
    assert state["workflow"] == "StandardWorkflow"
    for name in ("all2all_tanh_0_forward", "softmax_1_forward"):
        for attr in ("weights", "bias"):
            w, j = state["units"][name][attr], jstate["units"][name][attr]
            assert numpy.abs(w - j).max() <= 1e-12 * numpy.abs(j).max()
    fresh = _wine("torch", tmp_path / "fresh")
    load_snapshot_into_workflow(SnapshotterToFile.import_(got["torch"][1]),
                                fresh)
    for fwd in fresh.forwards:
        assert numpy.array_equal(fwd.weights.mem,
                                 state["units"][fwd.name]["weights"])


def test_dropout_fixer_as_in_jax():
    layers = [dict(WINE[0]), {"type": "dropout", "dropout_ratio": 0.5},
              dict(WINE[1])]
    for cls, fixer_cls in ((StandardWorkflow, DropoutFixer),
                           (JaxStandard, JaxFixer)):
        wf = cls(None, layers=[dict(layer) for layer in layers],
                 loader_name="wine_loader",
                 loader_config={"minibatch_size": 10})
        drops = [u for u in wf.forwards
                 if type(u).__name__ == "DropoutForward"]
        assert len(drops) == 1 and not drops[0].forward_mode
        if cls is StandardWorkflow:
            assert isinstance(drops[0], DropoutForward)
        fixer = fixer_cls(wf)
        fixer.fix()
        assert drops[0].forward_mode
        fixer.fix(forward_mode=False)
        assert not drops[0].forward_mode


# -- the downloader and the shell ---------------------------------------------

@pytest.mark.parametrize("cls", [Downloader, JaxDownloader])
def test_downloader_skips_when_the_files_exist(tmp_path, cls):
    (tmp_path / "data.bin").write_bytes(b"x")
    wf = Workflow() if cls is Downloader else JaxWorkflow()
    d = cls(wf, directory=str(tmp_path), files=("data.bin",))
    d.initialize()
    assert d.satisfied
    d.run()   # no url needed


@pytest.mark.parametrize("cls", [Downloader, JaxDownloader])
def test_downloader_fetches_and_extracts_a_file_url_tar(tmp_path, cls):
    src = tmp_path / "src"
    src.mkdir()
    (src / "payload.txt").write_text("hello")
    archive = tmp_path / "data.tar.gz"
    with tarfile.open(archive, "w:gz") as t:
        t.add(str(src / "payload.txt"), arcname="payload.txt")
    dest = tmp_path / "dest"
    wf = Workflow() if cls is Downloader else JaxWorkflow()
    d = cls(wf, url="file://" + str(archive), directory=str(dest),
            files=("payload.txt",))
    d.initialize()
    d.run()
    assert (dest / "payload.txt").read_text() == "hello"
    assert sorted(os.listdir(str(dest))) == ["data.tar.gz", "payload.txt"]
    os.remove(str(archive))
    d.run()   # satisfied: nothing fetched again


@pytest.mark.parametrize("cls", [Downloader, JaxDownloader])
def test_downloader_missing_url_raises(tmp_path, cls):
    wf = Workflow() if cls is Downloader else JaxWorkflow()
    d = cls(wf, directory=str(tmp_path), files=("nope.bin",))
    d.initialize()
    with pytest.raises(ValueError, match="no url"):
        d.run()


def test_downloader_default_directory_is_the_cache(tmp_path):
    with _restored(config.root.common.dirs):
        config.root.common.dirs.cache = str(tmp_path)
        d = Downloader(Workflow(), files=("x",))
        d.initialize()
        assert d.directory == os.path.join(str(tmp_path), "datasets")


@pytest.mark.parametrize("cls", [Shell, JaxShell])
def test_shell_never_interacts_headless(cls, monkeypatch):
    class NoTty(object):
        def isatty(self):
            return False
    monkeypatch.setattr("sys.stdin", NoTty())
    wf = Workflow() if cls is Shell else JaxWorkflow()
    s = cls(wf)
    s.run()
    assert s.interactions == 0 and not s.should_interact
    s2 = cls(wf, enabled=True)
    assert not s2.should_interact
    s2.run()
    assert s2.interactions == 0
