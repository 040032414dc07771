"""The port's fused training workflow (``alexnet.build`` ->
StandardWorkflow -> FusedForwardBackward -> FusedNet) against the JAX
package's, on the CPU, and its CLI.

The setup: ``test_torch_fused.narrow_alexnet`` (dropout off) on
67x67x3 prototype images, 48 TRAIN and 16 VALID rows in minibatches of
8, ``fused={"pool_impl": "offsets"}``, float64, 3 epochs, both
packages' prng streams 1 and 2 seeded alike:

* every epoch's ``epoch_n_err`` (VALID and TRAIN) and the evaluator's
  confusion matrix are equal, and the final parameters agree within
  1e-10 of each tensor's largest magnitude (the runs read about 1e-15);
* in the port, ``window=1`` (one step a minibatch) equals the default
  window of 8 steps bit for bit, and resuming from the snapshot of
  epoch 1 or 2 equals the uninterrupted run bit for bit, and so does
  resuming a snapshot taken inside a TRAIN segment (the trainer's
  ``epoch_acc``);
* ``python -m znicz_tpu_torch WORKFLOW.py --device cpu`` trains and
  prints the best error; without CUDA and without ``--device cpu`` it
  raises; the MSE loss builds in either mode, and a mesh of more ranks
  than the world has raises with the launch recipe.
"""

import contextlib
import copy
import os

import numpy
import pytest
import torch

from test_torch_fused import narrow_alexnet
from test_torch_units import prng_streams_restored  # noqa: F401
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.config import root as jax_root
from znicz_tpu.samples.research import alexnet as jax_alexnet
from znicz_tpu_torch import __main__ as cli
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.snapshotter import SnapshotterToFile
from znicz_tpu_torch.loader.base import TRAIN, VALID
from znicz_tpu_torch.samples import alexnet, mnist7
from znicz_tpu_torch.units.decision import DecisionMSE
from znicz_tpu_torch.units.evaluator import EvaluatorMSE
from znicz_tpu_torch.units.fused_trainer import DEFERRED_WINDOW_STATS
from znicz_tpu_torch.units.nn_units import load_snapshot_into_workflow

RTOL = 1e-10
LOADER = {"n_train": 48, "n_valid": 16, "minibatch_size": 8, "size": 67}
EPOCHS = 3


@contextlib.contextmanager
def _restored(*nodes):
    """Put config nodes back as they were (overrides add keys)."""
    saved = [(n, copy.deepcopy(n.__dict__)) for n in nodes]
    try:
        yield
    finally:
        for n, d in saved:
            n.__dict__.clear()
            n.__dict__.update(d)


@pytest.fixture
def f64():
    with _restored(root.common.engine, jax_root.common.engine,
                   root.alexnet):
        root.common.engine.precision_dtype = numpy.float64
        jax_root.common.engine.precision_dtype = numpy.float64
        yield


def _seed(*prng_mods):
    for p in prng_mods:
        p.get(1).seed(numpy.arange(7, dtype=numpy.int32))
        p.get(2).seed(numpy.arange(9, dtype=numpy.int32))


def _recorded(wf):
    """Record ``(epoch, class, epoch_n_err, confusion)`` at every
    segment end of ``wf``'s decision."""
    hist, d = [], wf.decision
    real = d.on_last_minibatch

    def on_last_minibatch():
        real()
        c = d.minibatch_class
        hist.append((d.epoch_number, c, d.epoch_n_err[c],
                     numpy.array(d.confusion_matrixes[c])))
    d.on_last_minibatch = on_last_minibatch
    return hist


def _train(module, snapdir, device, epochs=EPOCHS, fused=None, state=None):
    """Build, initialize (restore ``state``) and run; returns (workflow,
    segment history)."""
    wf = module.build(
        layers=narrow_alexnet(), loader_config=dict(LOADER),
        decision_config={"max_epochs": epochs},
        snapshotter_config={"directory": str(snapdir)},
        fused=dict(fused or {"pool_impl": "offsets"}))
    hist = _recorded(wf)
    wf.initialize(device=device)
    if state is not None:
        load_snapshot_into_workflow(state, wf)
    wf.run()
    return wf, hist


def _params(wf):
    return wf.fused_trainer.net.host_params()


def test_workflow_matches_jax(f64, tmp_path):
    _seed(jax_prng, prng)
    jwf, jhist = _train(jax_alexnet, tmp_path / "jax", None)
    twf, thist = _train(alexnet, tmp_path / "torch", "cpu")
    assert [h[:3] for h in thist] == [h[:3] for h in jhist]
    # the loader counts the epoch as served before VALID's decision
    assert [h[:2] for h in thist] == [
        p for e in range(EPOCHS) for p in ((e, TRAIN), (e + 1, VALID))]
    for t, j in zip(thist, jhist):
        assert t[3].dtype == j[3].dtype and (t[3] == j[3]).all()
    assert thist[0][3].sum() == LOADER["n_train"]
    assert twf.decision.best_n_err_pt == jwf.decision.best_n_err_pt
    want = jwf.fused_trainer.host_params()
    got = _params(twf)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            w_k = numpy.asarray(w[k])
            assert g[k].dtype == w_k.dtype == numpy.float64
            assert numpy.abs(g[k] - w_k).max() <= RTOL * numpy.abs(w_k).max()


def test_window_1_equals_window_8(f64, tmp_path):
    runs = []
    for window in (8, 1):
        _seed(prng)
        wf, hist = _train(alexnet, tmp_path / str(window), "cpu",
                          fused={"pool_impl": "offsets", "window": window})
        assert wf.fused_trainer.window == window
        assert wf.loader.skip_fill == (window > 1)
        runs.append((wf, hist))
    (w8, h8), (w1, h1) = runs
    assert [h[:3] for h in h8] == [h[:3] for h in h1]
    for a, b in zip(h8, h1):
        assert (a[3] == b[3]).all()
    for g, w in zip(_params(w1), _params(w8)):
        for k in w:
            assert (g[k] == w[k]).all()


@pytest.mark.parametrize("epoch", [1, 2])
def test_resume_from_snapshot_is_exact(f64, tmp_path, epoch):
    """Resume the snapshot written after ``epoch`` and train to the end:
    bit for bit the uninterrupted run.  The snapshotter writes only
    after an epoch that improved, which here is epoch 1 alone; its gate
    is lifted so every epoch end writes one."""
    _seed(prng)
    wf = alexnet.build(
        layers=narrow_alexnet(), loader_config=dict(LOADER),
        decision_config={"max_epochs": EPOCHS},
        snapshotter_config={"directory": str(tmp_path)},
        fused={"pool_impl": "offsets"})
    wf.snapshotter.skip = None
    written = {}
    export = wf.snapshotter.export

    def recorded_export():
        # a name of its own: epochs with the same errors share a suffix
        epoch_done = wf.loader.epoch_number
        wf.snapshotter.prefix = "alexnet_epoch%d" % epoch_done
        written[epoch_done] = export()
        return written[epoch_done]
    wf.snapshotter.export = recorded_export
    wf.initialize(device="cpu")
    wf.run()
    assert sorted(written) == list(range(1, EPOCHS + 1))
    state = SnapshotterToFile.import_(written[epoch])
    for unit_state in state["units"].values():
        for value in unit_state.values():
            assert not isinstance(value, torch.Tensor)
    assert state["units"]["loader"]["epoch_number"] == epoch
    _seed(prng)   # a fresh process's streams; the snapshot restores them
    resumed, hist = _train(alexnet, tmp_path / "resumed", "cpu",
                           state=state)
    assert [h[0] for h in hist] == [
        e for e in range(epoch, EPOCHS) for e in (e, e + 1)]
    assert resumed.decision.epoch_n_err == wf.decision.epoch_n_err
    assert resumed.decision.best_n_err_pt == wf.decision.best_n_err_pt
    for g, w in zip(_params(resumed), _params(wf)):
        for k in w:
            assert (g[k].view(numpy.uint64) == w[k].view(numpy.uint64)).all()
    sd_r = resumed.fused_trainer.net.state_dict()
    sd_f = wf.fused_trainer.net.state_dict()
    assert (sd_r["key"] == sd_f["key"]).all()
    for g, w in zip(sd_r["opt"], sd_f["opt"]):
        for k in w:
            for slot in w[k]:
                assert (g[k][slot] == w[k][slot]).all()


def test_mid_segment_accumulator_resumes(f64, tmp_path):
    """The trainer's ``epoch_acc`` export carries the device accumulator
    of a TRAIN segment in flight: a fresh workflow that loads a snapshot
    written after the first window of 2 steps (16 rows) ends the segment
    with the uninterrupted run's stats and parameters, bit for bit.
    Mid-epoch snapshots are not in this slice, so the loader and the
    trainer are driven by hand and the snapshot is written directly."""
    def started():
        _seed(prng)
        wf = alexnet.build(
            layers=narrow_alexnet(), loader_config=dict(LOADER),
            decision_config={"max_epochs": EPOCHS},
            snapshotter_config={"directory": str(tmp_path)},
            fused={"pool_impl": "offsets", "window": 2})
        wf.initialize(device="cpu")
        return wf

    def window(wf):
        wf.loader.run()
        wf.fused_trainer.run()
        return wf.fused_trainer.window_stats

    def segment_end(wf):
        while True:
            stats = window(wf)
            if stats is not DEFERRED_WINDOW_STATS:
                return stats

    run = started()
    assert window(run) is DEFERRED_WINDOW_STATS
    state = SnapshotterToFile.import_(run.snapshotter.export())
    acc = state["units"]["fused_trainer"]["epoch_acc"]
    assert isinstance(acc["n_err"], numpy.ndarray)
    assert acc["n_err"][1] == 16
    want = segment_end(run)
    assert want["n_err"][1] == LOADER["n_train"]

    resumed = started()
    load_snapshot_into_workflow(state, resumed)
    got = segment_end(resumed)
    assert (got["n_err"] == want["n_err"]).all()
    assert (got["confusion"] == want["confusion"]).all()
    assert got["max_err_sum"] == want["max_err_sum"]
    for g, w in zip(_params(resumed), _params(run)):
        for k in w:
            assert (g[k].view(numpy.uint64) == w[k].view(numpy.uint64)).all()


_WORKFLOW_PY = """
from test_torch_fused import narrow_alexnet
from znicz_tpu_torch.samples import alexnet, mnist7


def run(load, main):
    load(alexnet.build, layers=narrow_alexnet())
    main()
"""


def _cli_args(tmp_path, *extra):
    path = tmp_path / "narrow_alexnet_wf.py"
    path.write_text(_WORKFLOW_PY)
    args = [str(path), "--fused", "pool_impl=offsets"]
    for key, value in dict(LOADER, **{"snapshotter.directory":
                                      str(tmp_path)}).items():
        if key in LOADER:
            key = "loader." + key
        args += ["--config", "alexnet.%s=%s" % (key, value)]
    return args + ["--config", "alexnet.decision.max_epochs=2"] + list(extra)


def test_cli_trains_on_cpu(tmp_path, capsys):
    with _restored(root.alexnet, root.alexnet.loader, root.alexnet.decision,
                   root.alexnet.snapshotter):
        assert cli.main(_cli_args(tmp_path, "--device", "cpu")) == 0
    out = capsys.readouterr().out
    assert "best val/train err%: [None, " in out
    assert any(f.startswith("alexnet_") for f in os.listdir(tmp_path))
    assert root.alexnet.loader.get("n_train") is None


def test_cli_needs_cuda_unless_cpu_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with _restored(root.alexnet, root.alexnet.loader, root.alexnet.decision,
                   root.alexnet.snapshotter):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(_cli_args(tmp_path, "--dry-run"))
        assert cli.main(_cli_args(tmp_path, "--dry-run", "--device",
                                  "cpu")) == 0


@pytest.mark.parametrize("kwargs", [
    {"fused": None, "loss_function": "mse"}, {"fused": {"mesh": 2}},
    {"fused": True, "loss_function": "mse"}])
def test_left_out_modes_raise(kwargs):
    """The modes once left out now build: ``loss_function="mse"`` the
    MSE evaluator and decision in both modes (the mnist7 sample), and a
    ``mesh`` of 2 ranks a mesh over the ``torch.distributed`` world,
    which in a process without one raises and says how to launch."""
    if kwargs.get("loss_function") == "mse":
        wf = mnist7.build(loader_config={"minibatch_size": 8}, **kwargs)
        assert isinstance(wf.evaluator, EvaluatorMSE)
        assert isinstance(wf.decision, DecisionMSE)
        assert (wf.fused_trainer is None) == (kwargs["fused"] is None)
        return
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        alexnet.build(layers=narrow_alexnet(), loader_config=dict(LOADER),
                      **kwargs)


@pytest.mark.parametrize("argv", [["alexnet", "--parity"],
                                  ["alexnet", "--max-restarts", "2"],
                                  ["alexnet", "--optimize", "2x2"],
                                  ["profile", "alexnet"],
                                  ["obs", "--rid", "r1"]])
def test_left_out_cli_options_raise(argv, monkeypatch, tmp_path, capsys):
    """Left-out options raise, naming ROADMAP.md; ``--max-restarts`` and
    the ``profile`` subcommand, once among them, now supervise and
    profile the run, and without CUDA (and without ``--device cpu``)
    they raise at once instead of running; ``obs --rid``, once among
    them too, now follows a request's persisted traces (an empty
    directory answers no event and no tree); ``--parity``, once among
    them too, now reaches ``parity.run_parity`` with the sample's name
    (JAX's ``test_cli_parity_flag_is_wired``); ``--optimize``, once
    among them too, now runs the genetic optimizer, which asks for the
    config's Range values first (``test_torch_genetics.py`` runs it)."""
    if "--optimize" in argv:
        from znicz_tpu_torch import launcher
        calls = []
        monkeypatch.setattr(launcher, "run_workflow",
                            lambda *a, **k: calls.append(1))
        with pytest.raises(SystemExit, match="needs Range"):
            cli.main(argv)
        assert calls == []
        return
    if "--parity" in argv:
        from znicz_tpu_torch import parity
        called = {}

        def fake(sample, device=None, fused="auto", **kwargs):
            called.update(sample=sample, device=device, fused=fused)
            return []
        monkeypatch.setattr(parity, "run_parity", fake)
        assert cli.main(argv) == 0
        assert called == {"sample": "alexnet", "device": None,
                          "fused": "auto"}
        return
    if argv[0] == "obs":
        monkeypatch.setattr(root.common.telemetry.blackbox, "dir",
                            str(tmp_path))
        assert cli.main(argv + ["--json"]) == 0
        assert '"stitched": null' in capsys.readouterr().out
        return
    if argv[0] == "profile":
        from znicz_tpu_torch import launcher
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        calls = []
        monkeypatch.setattr(launcher, "run_workflow",
                            lambda *a, **k: calls.append(1))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)
        assert calls == []
        return
    if "--max-restarts" in argv:
        from znicz_tpu_torch import launcher
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        calls = []
        real = launcher.run_workflow
        monkeypatch.setattr(launcher, "run_workflow",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)
        assert calls == []
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cli.main(argv)
