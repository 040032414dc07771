"""Surviving a crash mid-epoch: the port's supervised launcher, mid-epoch
snapshots, ``--auto-resume`` and the injection sites, against
``znicz_tpu`` on the same inputs.

Mirrors ``tests/functional/test_fault_tolerance.py`` and
``tests/functional/test_elastic.py`` case by case.  The chaos module is
JAX's ``_wine_module``: the UCI Wine rows through a fused
``StandardWorkflow`` ([8 tanh, 3 softmax], minibatch 10, 3 epochs,
window 4, so 5 TRAIN windows an epoch, ``window_interval`` 2), both
packages' prng streams 1 and 2 seeded alike, float64.  A
``fused.dispatch`` crash at invocation 8 (epoch 2's third window,
after epoch 2's mid-epoch snapshot) under the port's
``run_supervised`` ends bit-equal to the port's uninterrupted run —
per-epoch n_err, evaluated rows, confusion, max_err_sum and every
parameter — and within 1e-12 of JAX's uninterrupted run (its integer
aggregates equal); so does a ``fused.host_fetch`` fault, the
synchronous windows (``async_windows=False``, whose segment partials
live in the evaluator's accumulators) and ``loader.fill`` I/O faults
absorbed by the retry.  ``--testing`` on a snapshot gives JAX's
weights and epoch count.  The SIGKILL test runs the port's CLI in a
subprocess with ``--device cpu`` (``slow``, as JAX's is); its
in-process counterpart crashes the MNIST CLI through an injected
fault and restarts it with ``--max-restarts``.  Every file is written
under ``tmp_path``.
"""

import os
import pickle
import re
import signal
import subprocess
import sys
import time
import types

import numpy
import pytest

from test_torch_faults import faults_health_isolated  # noqa: F401
from test_torch_units import prng_streams_restored  # noqa: F401
from test_torch_workflow import _restored
from znicz_tpu import launcher as jax_launcher
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.config import root as jax_root
from znicz_tpu.standard_workflow import StandardWorkflow as JaxStandardWorkflow
from znicz_tpu_torch import __main__ as cli
from znicz_tpu_torch import launcher
from znicz_tpu_torch.core import faults, prng, telemetry
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.health import HealthViolationError
from znicz_tpu_torch.standard_workflow import StandardWorkflow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-12
FC_LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 8},
     "<-": {"learning_rate": 0.1}},
    {"type": "softmax", "->": {"output_sample_shape": 3},
     "<-": {"learning_rate": 0.1}},
]


@pytest.fixture(autouse=True)
def f64():
    with _restored(root.common.engine, jax_root.common.engine):
        root.common.engine.precision_dtype = numpy.float64
        jax_root.common.engine.precision_type = "double"
        jax_root.common.engine.precision_dtype = numpy.float64
        yield


def _wine_module(pkg, snapshot_dir, fused_cfg, max_epochs=3,
                 window_interval=2):
    """JAX's chaos module for either package: a ``run(load, main)``
    module, built afresh on every restart as a process coming back up
    would be."""
    mod = types.ModuleType("wine_chaos")
    mod.__file__ = __file__

    def run(load, main):
        if pkg == "jax":
            import znicz_tpu.loader.loader_wine  # noqa: F401 (registry)
            p, workflow = jax_prng, JaxStandardWorkflow
        else:
            import znicz_tpu_torch.loader.loader_wine  # noqa: F401
            p, workflow = prng, StandardWorkflow
        p.get(1).seed(1234)
        p.get(2).seed(5678)
        load(workflow, layers=[dict(layer) for layer in FC_LAYERS],
             loader_name="wine_loader", loader_config={"minibatch_size": 10},
             loss_function="softmax",
             decision_config={"max_epochs": max_epochs,
                              "fail_iterations": 100},
             snapshotter_config={"prefix": "chaos", "interval": 1,
                                 "time_interval": 0, "compression": "",
                                 "directory": str(snapshot_dir),
                                 "window_interval": window_interval},
             fused=dict(fused_cfg))
        main()

    mod.run = run
    return mod


def _run(pkg, snapshot_dir, fused_cfg, supervised=False, **kwargs):
    os.makedirs(str(snapshot_dir), exist_ok=True)
    mod = _wine_module(pkg, snapshot_dir, fused_cfg,
                       **{k: kwargs.pop(k) for k in ("max_epochs",)
                          if k in kwargs})
    if pkg == "jax":
        return jax_launcher.run_workflow(mod, **kwargs)
    if supervised:
        return launcher.run_supervised(mod, device="cpu", **kwargs)
    return launcher.run_workflow(mod, device="cpu", **kwargs)


def _aggregates(wf):
    d = wf.decision
    return (list(d.epoch_n_err), list(d.epoch_n_evaluated_samples),
            [None if c is None else numpy.asarray(c).tolist()
             for c in d.confusion_matrixes], list(d.max_err_y_sums))


def _assert_same_final_state(wf, want, exact=True):
    """Integer aggregates equal; ``max_err_y_sums`` and every parameter
    bit-equal (``exact``) or within ``RTOL`` of each tensor's largest
    magnitude (the port against JAX)."""
    got_n, got_rows, got_conf, got_mx = _aggregates(wf)
    want_n, want_rows, want_conf, want_mx = _aggregates(want)
    assert (got_n, got_rows, got_conf) == (want_n, want_rows, want_conf)
    if exact:
        assert got_mx == want_mx
    else:
        numpy.testing.assert_allclose(got_mx, want_mx, rtol=RTOL)
    pa = wf.fused_trainer.host_params()
    pb = want.fused_trainer.host_params()
    assert len(pa) == len(pb)
    for i, (la, lb) in enumerate(zip(pa, pb)):
        assert sorted(la) == sorted(lb)
        for k in la:
            if exact:
                numpy.testing.assert_array_equal(la[k], lb[k],
                                                 "layer %d %s" % (i, k))
            else:
                scale = float(numpy.abs(lb[k]).max()) or 1.0
                assert float(numpy.abs(la[k] - lb[k]).max()) <= \
                    RTOL * scale, "layer %d %s" % (i, k)


@pytest.fixture
def segments(monkeypatch):
    """Each package's TRAIN segment ends, as (epoch, n_err, rows,
    confusion, max_err_sum), recorded by wrapping the decisions."""
    from znicz_tpu.units import decision as jax_decision
    from znicz_tpu_torch.loader.base import TRAIN
    from znicz_tpu_torch.units import decision
    seen = {"torch": [], "jax": []}
    for pkg, mod in (("torch", decision), ("jax", jax_decision)):
        real = mod.DecisionGD.on_last_minibatch

        def on_last_minibatch(d, real=real, out=seen[pkg]):
            real(d)
            if d.minibatch_class == TRAIN:
                out.append((d.epoch_number, d.epoch_n_err[TRAIN],
                            d.epoch_n_evaluated_samples[TRAIN],
                            numpy.asarray(
                                d.confusion_matrixes[TRAIN]).tolist(),
                            d.max_err_y_sums[TRAIN]))

        monkeypatch.setattr(mod.DecisionGD, "on_last_minibatch",
                            on_last_minibatch)
    return seen


def _chaos(tmp_path, segments, fused_cfg, site, rule):
    """The port's uninterrupted run, JAX's, and the port's supervised
    run under ``rule`` at ``site``: the supervised run's every TRAIN
    segment and final state bit-equal to the port's run, and the port's
    within 1e-12 of JAX's (its integer aggregates equal)."""
    wf_ref = _run("torch", tmp_path / "ref", fused_cfg)
    ref_segs = list(segments["torch"])
    wf_jax = _run("jax", tmp_path / "jax", fused_cfg)
    _assert_same_final_state(wf_ref, wf_jax, exact=False)
    assert [s[:4] for s in ref_segs] == [s[:4] for s in segments["jax"]]
    numpy.testing.assert_allclose([s[4] for s in ref_segs],
                                  [s[4] for s in segments["jax"]], rtol=RTOL)
    faults.install(site, **rule)
    root.common.faults.enabled = True
    del segments["torch"][:]
    wf = _run("torch", tmp_path / "chaos", fused_cfg, supervised=True,
              max_restarts=2, restart_backoff_ms=0.0)
    assert faults.status()["sites"][site]["injected"] == 1
    assert segments["torch"] == ref_segs
    _assert_same_final_state(wf, wf_ref)
    return wf


def _restored_paths(monkeypatch):
    """Record the snapshot each auto-resume restores."""
    restored = []
    real = launcher.Launcher._find_resume_state

    def find(self, wf):
        state = real(self, wf)
        restored.append(None if state is None else
                        (state["suffix"],
                         state["units"]["loader"]["epoch_number"]))
        return state

    monkeypatch.setattr(launcher.Launcher, "_find_resume_state", find)
    return restored


@pytest.mark.parametrize("fused_cfg", [
    {"window": 4}, {"window": 4, "async_windows": False},
    {"window": 4, "pipeline_depth": 1}],
    ids=["async", "sync_windows", "pipeline_depth_1"])
def test_kill_resume_equivalence(tmp_path, monkeypatch, segments,
                                 fused_cfg):
    """wine: 18 TRAIN minibatches in windows of 4 are 5 dispatches an
    epoch; invocation 8 is epoch 2's third window, after the
    ``window_interval=2`` snapshot at its second.  The restart resumes
    from that ``midepoch`` snapshot (loader epoch 1, counted from 0)."""
    restored = _restored_paths(monkeypatch)
    _chaos(tmp_path, segments, fused_cfg, "fused.dispatch",
           {"kind": "crash", "at": 8})
    assert restored == [("midepoch", 1)]
    assert any("midepoch" in f for f in os.listdir(str(tmp_path / "chaos")))
    assert faults.status()["sites"]["fused.dispatch"]["invocations"] == 16


def test_sync_windows_snapshot_carries_the_evaluator_partials(tmp_path):
    """``async_windows=False`` reads each window back into the
    evaluator, whose accumulators a mid-epoch snapshot holds."""
    _run("torch", tmp_path / "s", {"window": 4, "async_windows": False},
         max_epochs=1)
    from znicz_tpu_torch.core.snapshotter import SnapshotterToFile
    path = os.path.join(str(tmp_path / "s"), [
        f for f in os.listdir(str(tmp_path / "s")) if "midepoch" in f][0])
    ev = SnapshotterToFile.import_(path)["units"]["evaluator"]
    # the capture after window 4 of 5: 16 of the 18 minibatches' rows
    assert int(ev["n_err"][1]) == 160


def test_host_fetch_fault_also_recovered(tmp_path, segments):
    """A transient fault at epoch 2's segment readback (readbacks are
    one a segment plus one a mid-epoch capture, so invocation 4)
    crashes the attempt; the restart resumes and ends as the run."""
    _chaos(tmp_path, segments, {"window": 4}, "fused.host_fetch",
           {"kind": "xla", "at": 4})


def test_loader_retry_absorbs_transient_io(tmp_path):
    """``window=1`` keeps a host fill a TRAIN minibatch; three I/O
    faults are retried and the run equals a clean one, and JAX's."""
    wf_clean = _run("torch", tmp_path / "a", {"window": 1}, max_epochs=2)
    wf_jax = _run("jax", tmp_path / "j", {"window": 1}, max_epochs=2)
    faults.install("loader.fill", kind="io", every=7, times=3)
    root.common.faults.enabled = True
    wf = _run("torch", tmp_path / "b", {"window": 1}, max_epochs=2)
    st = faults.status()
    assert st["sites"]["loader.fill"]["injected"] == 3
    assert st["retries"] == 3
    _assert_same_final_state(wf, wf_clean)
    _assert_same_final_state(wf, wf_jax, exact=False)


def test_supervised_never_restarts_health_halt():
    attempts = []
    mod = types.ModuleType("halting")
    mod.__file__ = __file__

    def run(load, main):
        attempts.append(1)
        raise HealthViolationError("loss diverged")

    mod.run = run
    with pytest.raises(HealthViolationError):
        launcher.run_supervised(mod, max_restarts=5, restart_backoff_ms=0.0,
                                device="cpu")
    assert len(attempts) == 1


def test_supervised_restart_is_bounded_with_capped_backoff(monkeypatch):
    import time as time_mod
    slept = []
    monkeypatch.setattr(time_mod, "sleep", lambda s: slept.append(s))
    attempts = []
    mod = types.ModuleType("crashing")
    mod.__file__ = __file__

    def run(load, main):
        attempts.append(1)
        raise RuntimeError("crash %d" % len(attempts))

    mod.run = run
    root.common.telemetry.enabled = True
    with pytest.raises(RuntimeError, match="crash 4"):
        launcher.run_supervised(mod, max_restarts=3, restart_backoff_ms=20e3,
                                device="cpu")
    assert len(attempts) == 4
    assert slept == [20.0, 30.0, 30.0]      # doubling, capped at 30 s
    assert telemetry.counter("launcher.restarts").value == 3
    events = [e for e in telemetry.journal_events()
              if e["kind"] == "launcher.restart"]
    assert [e["attempt"] for e in events] == [1, 2, 3]


def test_supervised_without_cuda_raises_at_once(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    attempts = []
    mod = types.ModuleType("never")
    mod.__file__ = __file__
    mod.run = lambda load, main: attempts.append(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.run_supervised(mod, max_restarts=3, restart_backoff_ms=0.0)
    assert attempts == []


def test_supervised_restart_falls_back_to_explicit_snapshot(tmp_path):
    """A crash before the first new snapshot: the restart finds nothing
    to resume in its directory and re-enters the ``--snapshot`` warm
    start, ending as the uninterrupted continuation."""
    _run("torch", tmp_path / "seed", {"window": 4})
    seed_dir = str(tmp_path / "seed")
    seed_snap = max((os.path.join(seed_dir, f) for f in os.listdir(seed_dir)),
                    key=os.path.getmtime)
    wf_ref = _run("torch", tmp_path / "ref", {"window": 4}, max_epochs=6,
                  snapshot=seed_snap)
    faults.install("fused.dispatch", kind="crash", at=1)
    root.common.faults.enabled = True
    wf = _run("torch", tmp_path / "chaos", {"window": 4}, supervised=True,
              max_epochs=6, max_restarts=1, restart_backoff_ms=0.0,
              snapshot=seed_snap)
    assert faults.status()["sites"]["fused.dispatch"]["injected"] == 1
    _assert_same_final_state(wf, wf_ref)


def test_testing_on_a_snapshot_trains_one_epoch_as_jax(tmp_path):
    """``--testing`` sets ``testing`` after ``initialize``, as the JAX
    launcher does: the decision completes after one more epoch, which
    the GD path still trains, and the evaluator merges nothing."""
    seeds = {}
    for pkg in ("torch", "jax"):
        _run(pkg, tmp_path / pkg, {"window": 4})
        d = str(tmp_path / pkg)
        seeds[pkg] = max((os.path.join(d, f) for f in os.listdir(d)
                          if "midepoch" not in f), key=os.path.getmtime)
    wfs = {pkg: _run(pkg, tmp_path / (pkg + "_t"), {"window": 4},
                     snapshot=seeds[pkg], testing=True)
           for pkg in ("torch", "jax")}
    assert wfs["torch"].loader.epoch_number == 4 == \
        wfs["jax"].loader.epoch_number
    assert bool(wfs["torch"].decision.complete)
    assert wfs["torch"].evaluator.merged_output is None
    assert wfs["jax"].evaluator.merged_output is None
    _assert_same_final_state(wfs["torch"], wfs["jax"], exact=False)


@pytest.mark.parametrize("fused", [None, {"window": 4}],
                         ids=["units", "fused"])
@pytest.mark.parametrize("opts", [{"mean": False}, {"testing": True},
                                  {"mean": False, "testing": True}],
                         ids=["mean_false", "testing", "both"])
def test_evaluator_options_match_jax(tmp_path, fused, opts):
    """An evaluator built with ``mean=False`` (``err_output`` not
    divided by the batch: the unit graph's gradients grow with it, the
    fused windows' ``max_err_sum`` too) or ``testing=True`` (every
    minibatch's output merged at the loader's offset) gives JAX's
    outputs: the merged output, the aggregates and the weights."""
    wfs = {}
    for pkg, p, workflow in (("torch", prng, StandardWorkflow),
                             ("jax", jax_prng, JaxStandardWorkflow)):
        if pkg == "jax":
            import znicz_tpu.loader.loader_wine  # noqa: F401
        else:
            import znicz_tpu_torch.loader.loader_wine  # noqa: F401
        p.get(1).seed(1234)
        p.get(2).seed(5678)
        kwargs = {} if fused is None else {"fused": dict(fused)}
        wf = workflow(None, layers=[dict(layer) for layer in FC_LAYERS],
                      loader_name="wine_loader",
                      loader_config={"minibatch_size": 10},
                      evaluator_config=dict(opts),
                      decision_config={"max_epochs": 2,
                                       "fail_iterations": 100},
                      snapshotter_config={"prefix": "ev", "compression": "",
                                          "directory": str(tmp_path / pkg)},
                      **kwargs)
        if pkg == "jax":
            from znicz_tpu.core.backends import JaxDevice
            wf.initialize(device=JaxDevice())
        else:
            wf.initialize(device="cpu")
        wfs[pkg] = wf.run()
    got, want = wfs["torch"], wfs["jax"]
    if fused is None:
        for fg, fw in zip(got.forwards, want.forwards):
            fw.weights.map_read()
            fg.weights.map_read()
            numpy.testing.assert_allclose(fg.weights.mem, fw.weights.mem,
                                          rtol=0, atol=RTOL)
        assert _aggregates(got)[:3] == _aggregates(want)[:3]
        numpy.testing.assert_allclose(_aggregates(got)[3],
                                      _aggregates(want)[3], rtol=RTOL)
    else:
        _assert_same_final_state(got, want, exact=False)
    if opts.get("testing"):
        assert got.evaluator.merged_output.shape == \
            want.evaluator.merged_output.shape == (178, 3)
        numpy.testing.assert_allclose(got.evaluator.merged_output,
                                      want.evaluator.merged_output,
                                      rtol=0, atol=RTOL)
        assert numpy.abs(got.evaluator.merged_output).sum() > 0
    else:
        assert got.evaluator.merged_output is None


# -- snapshotter satellites ---------------------------------------------------

class _StubWorkflow(object):
    units = ()
    forwards = ()

    def add_unit(self, unit):
        unit.workflow = self


def _snapshotter(tmp_path, **kwargs):
    from znicz_tpu_torch.core.snapshotter import SnapshotterToFile
    kwargs.setdefault("prefix", "sat")
    kwargs.setdefault("compression", "")
    kwargs.setdefault("directory", str(tmp_path))
    snap = SnapshotterToFile(_StubWorkflow(), **kwargs)
    snap.initialize()
    return snap


def test_snapshot_publish_is_fsynced(tmp_path, monkeypatch):
    """The ``.part`` file's blocks and then the directory entry are
    fsynced around the atomic rename."""
    synced = []
    real_fsync = os.fsync

    def fsync(fd):
        synced.append(os.path.realpath("/proc/self/fd/%d" % fd)
                      if os.path.exists("/proc/self/fd") else fd)
        return real_fsync(fd)

    monkeypatch.setattr(os, "fsync", fsync)
    path = _snapshotter(tmp_path).export()
    assert path and os.path.exists(path)
    assert not os.path.exists(path + ".part")
    assert len(synced) >= 2
    if os.path.exists("/proc/self/fd"):
        assert synced[0] == os.path.realpath(path + ".part")
        assert synced[-1] == os.path.realpath(str(tmp_path))


def test_failed_export_does_not_push_interval(tmp_path):
    snap = _snapshotter(tmp_path, interval=1, time_interval=3600.0)
    faults.install("snapshot.write", kind="crash", at=1)
    root.common.faults.enabled = True
    with pytest.raises(faults.InjectedCrashError):
        snap.run()
    assert not [f for f in os.listdir(str(tmp_path))
                if f.endswith(".pickle")]
    snap.run()
    assert [f for f in os.listdir(str(tmp_path)) if f.endswith(".pickle")]


def test_window_tick_interval_and_retry_after_failure(tmp_path):
    snap = _snapshotter(tmp_path, window_interval=2)
    assert snap.window_tick() is None
    faults.install("snapshot.write", kind="io", at=1)
    root.common.faults.enabled = True
    with pytest.raises(faults.InjectedIOError):
        snap.window_tick()
    wrote = snap.window_tick()
    assert wrote and "midepoch" in wrote
    assert snap.suffix is None
    assert snap.window_tick() is None


def test_auto_resume_skips_corrupt_and_incompatible(tmp_path):
    snap_dir = tmp_path / "snaps"
    wf = _run("torch", snap_dir, {"window": 4}, max_epochs=1)
    assert wf.snapshotter.export()
    wrong = os.path.join(str(snap_dir), "chaos_wrongwf.999.pickle")
    with open(wrong, "wb") as f:
        pickle.dump({"format": 1, "workflow": "SomethingElse",
                     "units": {}}, f)
    truncated = os.path.join(str(snap_dir), "chaos_trunc.999.pickle")
    with open(truncated, "wb") as f:
        f.write(b"\x80\x04not a pickle at all")
    now = time.time()
    os.utime(wrong, (now + 10, now + 10))
    os.utime(truncated, (now + 20, now + 20))
    root.common.telemetry.enabled = True
    telemetry.reset()
    state = launcher.Launcher(auto_resume=True)._find_resume_state(wf)
    assert state is not None and state["workflow"] == type(wf).__name__
    whys = sorted(e["why"] for e in telemetry.journal_events()
                  if e["kind"] == "resume.skipped")
    assert whys == ["incompatible", "unreadable"]


def test_auto_resume_rejects_mismatched_epoch_acc(tmp_path):
    """A mid-epoch accumulator of another layout is incompatible, the
    matching one passes; so are fused parameters of another shape."""
    wf = _run("torch", tmp_path / "snaps", {"window": 4}, max_epochs=1)
    lau = launcher.Launcher(auto_resume=True)
    good = lau._find_resume_state(wf)
    assert good is not None
    ustate = good["units"][wf.fused_trainer.name]
    zeros = wf.fused_trainer.net.window_acc_zeros()
    ustate["epoch_acc"] = {k: numpy.zeros((4,) + v.shape, v.dtype)
                           for k, v in zeros.items()}
    reason = lau._snapshot_incompatible(good, wf)
    assert reason and "epoch_acc" in reason
    ustate["epoch_acc"] = zeros
    assert lau._snapshot_incompatible(good, wf) is None
    w = ustate["fused_state"]["params"][0]["w"]
    ustate["fused_state"]["params"][0]["w"] = w[:, :-1]
    assert "fused param shape" in lau._snapshot_incompatible(good, wf)
    ustate["fused_state"]["params"] = ustate["fused_state"]["params"][:1]
    assert "layer count" in lau._snapshot_incompatible(good, wf)


def test_auto_resume_rejects_another_topology(tmp_path):
    """A unit-graph snapshot whose unit names cover none of the
    workflow's layers is refused, as one without trainable weights."""
    wf = _run("torch", tmp_path / "snaps", {"window": 4}, max_epochs=1)
    lau = launcher.Launcher(auto_resume=True)
    state = {"workflow": type(wf).__name__,
             "units": {"other_forward": {"weights": numpy.ones((2, 2))}}}
    assert "cover none" in lau._snapshot_incompatible(state, wf)
    state["units"] = {"loader": {"epoch_number": 1}}
    assert "no trainable weights" in lau._snapshot_incompatible(state, wf)


# -- the CLI: an in-process crash and a SIGKILL -------------------------------

_EPOCH_RE = re.compile(r"Epoch (\d+) class (\w+) n_err (\d+) of (\d+)")


def _mnist_argv(snapdir, *extra):
    argv = ["mnist", "--device", "cpu"]
    for kv in ("loader.synthetic_train=200", "loader.synthetic_valid=40",
               "loader.minibatch_size=20", "decision.max_epochs=4",
               "decision.fail_iterations=50",
               "snapshotter.directory=%s" % snapdir,
               "snapshotter.compression="):
        argv += ["--config", "mnistr." + kv]
    return argv + list(extra)


def _trajectory(text):
    return [tuple(int(g) if g.isdigit() else g for g in m.groups())
            for m in _EPOCH_RE.finditer(text)]


def _seeded_cli(argv):
    prng.get(1).seed(1234)
    prng.get(2).seed(5678)
    cli.main(argv)


def test_cli_crash_then_supervised_resume_matches_straight(tmp_path, capsys,
                                                          caplog):
    """The in-process counterpart of the SIGKILL test: the MNIST CLI
    through the unit graph (12 fills an epoch), crashed by a
    ``loader.fill`` crash fault in epoch 3's TRAIN segment and
    restarted by ``--max-restarts`` from the newest snapshot, ends with
    the straight run's trajectory."""
    import logging
    from znicz_tpu_torch.samples import mnist  # noqa: F401 (root.mnistr)
    caplog.set_level(logging.INFO)
    with _restored(root.mnistr):
        _seeded_cli(_mnist_argv(str(tmp_path / "straight")))
    straight = _trajectory(caplog.text)
    best = capsys.readouterr().out
    caplog.clear()
    with _restored(root.mnistr):
        _seeded_cli(_mnist_argv(
            str(tmp_path / "chaos"), "--max-restarts", "2",
            "--restart-backoff-ms", "0",
            "--config", "common.faults.enabled=True",
            "--config", "common.faults.rules={'loader.fill': "
                        "{'kind': 'crash', 'at': 30}}"))
    assert faults.status()["sites"]["loader.fill"]["injected"] == 1
    assert "restart 1/2" in caplog.text
    assert "auto-resume: restoring" in caplog.text
    resumed = _trajectory(caplog.text)
    assert len(straight) == 8
    # the restart re-runs from the newest snapshot's epoch on: every
    # segment it logs is the straight run's, and it ends as that run
    assert set(resumed) == set(straight)
    assert resumed[-4:] == straight[-4:]
    assert capsys.readouterr().out == best


def _cli_cmd(snapdir, extra=()):
    return [sys.executable, "-m", "znicz_tpu_torch"] + \
        _mnist_argv(snapdir, "--config", "mnistr.loader.synthetic_train=2000",
                    "--config", "mnistr.decision.max_epochs=5") + list(extra)


def _env():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.slow
def test_sigkill_mid_training_then_auto_resume_matches_straight(tmp_path):
    straight_dir = str(tmp_path / "straight")
    killed_dir = str(tmp_path / "killed")
    os.makedirs(killed_dir)
    ref = subprocess.run(_cli_cmd(straight_dir), env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert ref.returncode == 0, ref.stderr[-2000:]
    proc = subprocess.Popen(_cli_cmd(killed_dir), env=_env(), cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    deadline = time.time() + 300
    while time.time() < deadline and proc.poll() is None:
        if any(f.endswith(".pickle") for f in os.listdir(killed_dir)):
            break
        time.sleep(0.02)
    assert proc.poll() is None, "the run ended before the kill"
    proc.send_signal(signal.SIGKILL)
    proc.communicate(timeout=60)
    assert proc.returncode != 0
    junk = os.path.join(killed_dir, "mnist_zzz.9999.pickle")
    with open(junk, "wb") as f:
        f.write(b"truncated-garbage")
    now = time.time() + 10
    os.utime(junk, (now, now))
    res = subprocess.run(_cli_cmd(killed_dir, ["--auto-resume"]), env=_env(),
                         cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    out = res.stdout + res.stderr
    assert "auto-resume: restoring" in out
    assert "skipping unreadable snapshot" in out
    best = [line for line in res.stdout.splitlines()
            if line.startswith("best val/train err%")]
    assert best and best == [line for line in ref.stdout.splitlines()
                             if line.startswith("best val/train err%")]
    want = {(e, c): (n, t) for e, c, n, t in
            _trajectory(ref.stdout + ref.stderr)}
    got = _trajectory(out)
    assert got
    for e, c, n, t in got:
        assert want.get((e, c)) == (n, t), (e, c)


def test_auto_resume_without_snapshots_starts_fresh(tmp_path, capsys,
                                                    caplog):
    import logging
    from znicz_tpu_torch.samples import mnist  # noqa: F401 (root.mnistr)
    caplog.set_level(logging.INFO)
    with _restored(root.mnistr):
        _seeded_cli(_mnist_argv(
            str(tmp_path / "fresh"), "--auto-resume",
            "--config", "mnistr.loader.synthetic_train=100",
            "--config", "mnistr.decision.max_epochs=1"))
    assert "best val/train err%" in capsys.readouterr().out
    assert "restoring" not in caplog.text
    assert len(_trajectory(caplog.text)) == 2
