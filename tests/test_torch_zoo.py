"""The port's classification zoo (``samples/research/{stl10,mnist_simple,
wine_relu,hands,tv_channels}.py``, ``samples/wine.py``,
``samples/yale_faces.py``) and the launcher's research tier against the
JAX package's, on the CPU.

* The JAX package's pinned trajectories (``tests/functional/
  test_research_models.py``: seeds 1234 / 5678, its configs): the port
  reproduces ``GOLDEN_ZOO`` for mnist_simple, wine_relu and stl10 and
  ``GOLDEN_ZOO2`` for hands and tv_channels, (class, n_err) for
  (class, n_err), in float32 as pinned and in float64.
* STL-10 in float64 (20 TRAIN and 8 VALID images, minibatch 10): every
  weight and bias within 1e-12 of ``znicz_tpu``'s largest after a
  run, and the fused graph (``pool_impl="offsets"``) within 1e-12 of
  the unit graph with equal n_err; the graph's shapes (pool1 96 -> 48
  and pool2 48 -> 24, each overhanging the edge) and the head's width,
  the loader's label count as in JAX (4 on the synthetic set, over the
  configured 10).
* The MLP samples in float64 against ``znicz_tpu``: per-epoch n_err
  equal, weights within 1e-12.
* Wine converges as in ``tests/functional/test_wine.py`` and runs
  through the launcher contract as in ``tests/functional/
  test_cli.py``; yale_faces as in ``tests/functional/
  test_samples.py:60-75``, also fused.
* ``python -m znicz_tpu_torch research.stl10 --device cpu`` trains
  with and without ``--fused pool_impl=offsets``; ``--list`` prints the
  JAX package's names for the samples the port has;
  ``research.alexnet`` / ``mnist7`` / ``mnist_ae`` name the port's flat
  modules; without CUDA and without ``--device cpu`` the CLI raises.
"""

import os

import numpy
import pytest
import torch

from test_torch_autoencoder import RESEARCH, _close, f64  # noqa: F401
from test_torch_mnist import _restored
from test_torch_units import prng_streams_restored  # noqa: F401
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.backends import JaxDevice
from znicz_tpu.core.config import root as jax_root
from znicz_tpu.launcher import list_samples as jax_list_samples
from znicz_tpu.samples import wine as jax_wine
from znicz_tpu.samples import yale_faces as jax_yale_faces
from znicz_tpu.samples.research import hands as jax_hands
from znicz_tpu.samples.research import mnist_simple as jax_mnist_simple
from znicz_tpu.samples.research import stl10 as jax_stl10
from znicz_tpu.samples.research import tv_channels as jax_tv_channels
from znicz_tpu.samples.research import wine_relu as jax_wine_relu
from znicz_tpu_torch import __main__ as cli
from znicz_tpu_torch import launcher
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader.base import TRAIN, VALID
from znicz_tpu_torch.samples import alexnet, mnist7, mnist_ae
from znicz_tpu_torch.samples import wine, yale_faces
from znicz_tpu_torch.samples.research import (
    hands, mnist_simple, stl10, tv_channels, wine_relu)

RTOL = 1e-12
PORT = {"stl10": stl10, "mnist_simple": mnist_simple,
        "wine_relu": wine_relu, "hands": hands, "tv_channels": tv_channels,
        "yale_faces": yale_faces}
JAX = {"stl10": jax_stl10, "mnist_simple": jax_mnist_simple,
       "wine_relu": jax_wine_relu, "hands": jax_hands,
       "tv_channels": jax_tv_channels, "yale_faces": jax_yale_faces}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes,
    and their thread pools would otherwise contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Each sample's synthetic set, written once (by the port's
    writers; the loader tests hold them to the JAX writers' bytes)."""
    base = tmp_path_factory.mktemp("zoo")
    return {"stl10": stl10.materialize_synthetic(
                str(base / "stl"), n_train=20, n_valid=8),
            "hands": hands.materialize_synthetic(str(base / "hands")),
            "tv_channels": tv_channels.materialize_synthetic(
                str(base / "ch")),
            "yale_faces": yale_faces.materialize_synthetic(
                str(base / "yale"))}


def _config(name, data):
    """The JAX test's loader and decision config of each sample
    (``tests/functional/test_research_models.py:257-305``, ``:388-405``;
    ``test_samples.py:60-75``)."""
    if name == "mnist_simple":
        return dict(loader_config=dict(RESEARCH.MNIST_SYNTH),
                    decision_config={"max_epochs": 2, "fail_iterations": 20})
    if name == "wine_relu":
        return dict(decision_config={"max_epochs": 3})
    if name == "stl10":
        return dict(loader_config={"directory": data["stl10"],
                                   "minibatch_size": 10},
                    decision_config={"max_epochs": 1, "fail_iterations": 5})
    if name == "yale_faces":
        return dict(loader_config={"minibatch_size": 20,
                                   "train_paths": [data["yale_faces"]]},
                    decision_config={"max_epochs": 3,
                                     "fail_iterations": 100})
    return dict(loader_config={"train_paths": [data[name]]},
                decision_config={"max_epochs": 3, "fail_iterations": 10})


def _train(module, device, snapdir, seeds=(1234, 5678), **kwargs):
    """Seed both streams, build, initialize and run; returns the
    workflow and its (class, n_err) at every segment end."""
    for p in (prng, jax_prng):
        p.get(1).seed(seeds[0])
        p.get(2).seed(seeds[1])
    if module in PORT.values():
        kwargs["snapshotter_config"] = {"directory": str(snapdir)}
    wf = module.build(**kwargs)
    seq, d = [], wf.decision
    real = d.on_last_minibatch

    def on_last_minibatch():
        real()
        c = d.minibatch_class
        seq.append((int(c), int(d.epoch_n_err[c])))
    d.on_last_minibatch = on_last_minibatch
    wf.initialize(device=device)
    wf.run()
    return wf, seq


def _params(wf):
    if getattr(wf, "fused_trainer", None) is not None:
        return [(numpy.array(p["w"]), numpy.array(p["b"]))
                for p in wf.fused_trainer.net.host_params() if p]
    return [(numpy.array(f.weights.mem), numpy.array(f.bias.mem))
            for f in wf.forwards if f.weights]


def _golden(name):
    if name in RESEARCH.GOLDEN_ZOO:
        return RESEARCH.GOLDEN_ZOO[name]
    return [s[:2] for s in RESEARCH.GOLDEN_ZOO2[name]]


# -- the pinned trajectories --------------------------------------------------

@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("name", ["mnist_simple", "wine_relu", "stl10",
                                  "hands", "tv_channels"])
def test_reproduces_the_golden_trajectory(data, tmp_path, name, precision):
    with _restored(root.common.engine):
        if precision == "f64":
            root.common.engine.precision_dtype = numpy.float64
        wf, seq = _train(PORT[name], "cpu", tmp_path, **_config(name, data))
    assert seq == _golden(name)
    dtype = numpy.float64 if precision == "f64" else numpy.float32
    assert wf.forwards[0].weights.mem.dtype == dtype


# -- float64 against znicz_tpu -------------------------------------------------

@pytest.mark.parametrize("name", ["mnist_simple", "wine_relu", "stl10",
                                  "hands", "tv_channels", "yale_faces"])
def test_matches_jax_float64(f64, data, tmp_path, monkeypatch, name):
    monkeypatch.setattr(jax_root.common.dirs, "snapshots", str(tmp_path))
    jwf, jseq = _train(JAX[name], JaxDevice(), tmp_path,
                       **_config(name, data))
    twf, tseq = _train(PORT[name], "cpu", tmp_path, **_config(name, data))
    assert tseq == jseq
    assert twf.loader.class_lengths == list(jwf.loader.class_lengths)
    assert [tuple(f.output.shape) for f in twf.forwards] == \
        [tuple(f.output.shape) for f in jwf.forwards]
    got, want = _params(twf), _params(jwf)
    assert len(got) == len(want) > 0
    for (gw, gb), (ww, wb) in zip(got, want):
        assert gw.dtype == numpy.float64
        _close(gw, ww, RTOL, "weights")
        _close(gb, wb, RTOL, "bias")


def test_stl10_graph_and_head(data, tmp_path):
    wf = stl10.build(**_config("stl10", data),
                     snapshotter_config={"directory": str(tmp_path)})
    assert root.stl.layers[-1]["->"]["output_sample_shape"] == 10
    wf.initialize(device="cpu")
    assert [tuple(f.output.shape) for f in wf.forwards] == [
        (10, 96, 96, 32), (10, 48, 48, 32), (10, 48, 48, 32),
        (10, 48, 48, 32), (10, 48, 48, 32), (10, 48, 48, 32),
        (10, 24, 24, 32), (10, 24, 24, 32), (10, 4)]
    # the JAX package's head: the loader's label count wins
    assert wf.forwards[-1].output_sample_shape == (4,)
    assert wf.loader.labels_mapping == {"airplane": 0, "bird": 1, "car": 2,
                                        "cat": 3}
    gds = {g.name: g for g in wf.gds}
    assert gds["gd_fc_softmax"].weights_decay == 1.0
    assert gds["gd_conv1"].factor_ortho == gds["gd_conv2"].factor_ortho \
        == 0.001
    assert wf.loader.normalization_type == "internal_mean"
    assert type(wf.forwards[6]).__name__ == "AvgPooling"
    assert not hasattr(wf, "lr_adjuster")


def test_stl10_fused_matches_unit_graph_float64(f64, data, tmp_path):
    uwf, useq = _train(stl10, "cpu", tmp_path / "u", **_config("stl10", data))
    fwf, fseq = _train(stl10, "cpu", tmp_path / "f",
                       fused={"pool_impl": "offsets"},
                       **_config("stl10", data))
    assert fwf.fused_trainer is not None
    assert fseq == useq == RESEARCH.GOLDEN_ZOO["stl10"]
    got, want = _params(fwf), _params(uwf)
    assert len(got) == len(want) == 3
    for (gw, gb), (ww, wb) in zip(got, want):
        assert gw.dtype == numpy.float64
        _close(gw, ww, RTOL, "weights")
        _close(gb, wb, RTOL, "bias")


def test_stl10_fused_windows_where_jax_steps(f64, data, tmp_path,
                                             monkeypatch):
    """A known difference: the port's full-batch image loaders fill
    with ``FullBatchLoader``'s own function, so its fused trainer runs
    STL-10 in windows of 8 over the rows on the device; the JAX
    trainer's check misses its delegating fill and steps a minibatch at
    a time from the host.  The same steps give the same run: n_err
    equal and every parameter within 1e-12 of the JAX fused graph's."""
    monkeypatch.setattr(jax_root.common.dirs, "snapshots", str(tmp_path))
    jwf, jseq = _train(jax_stl10, JaxDevice(), tmp_path,
                       fused={"pool_impl": "gather"},
                       **_config("stl10", data))
    twf, tseq = _train(stl10, "cpu", tmp_path, fused={"pool_impl": "offsets"},
                       **_config("stl10", data))
    assert jwf.fused_trainer.window == 1
    assert twf.fused_trainer.window == 8 and twf.loader.skip_fill
    assert tseq == jseq
    for (gw, gb), (ww, wb) in zip(_params(twf), _params(jwf)):
        _close(gw, ww, RTOL, "weights")
        _close(gb, wb, RTOL, "bias")


# -- Wine and yale_faces ------------------------------------------------------

@pytest.fixture
def port_snapshots(tmp_path, monkeypatch):
    monkeypatch.setattr(root.common.dirs, "snapshots", str(tmp_path))


def test_wine_converges(port_snapshots):
    """``tests/functional/test_wine.py:8-24``."""
    prng.get(1).seed(1024)
    prng.get(2).seed(1025)
    wf = wine.WineWorkflow()
    wf.decision.max_epochs = 40
    wf.initialize(device="cpu")
    wf.run()
    assert wf.loader.epoch_number <= 40
    assert wf.decision.best_n_err_pt[2] is not None
    assert wf.decision.best_n_err_pt[2] < 2.0, wf.decision.best_n_err_pt
    assert wf.snapshotter.destination is None or \
        "train" in wf.snapshotter.destination
    assert [type(f).__name__ for f in wf.forwards] == ["All2AllTanh",
                                                       "All2AllSoftmax"]
    assert [type(g).__name__ for g in wf.gds] == ["GDTanh", "GDSoftmax"]
    assert wf.gds[0].need_err_input is False


def test_wine_matches_jax_float64(f64, port_snapshots, tmp_path,
                                  monkeypatch):
    monkeypatch.setattr(jax_root.common.dirs, "snapshots", str(tmp_path))
    with _restored(root.wine.decision, jax_root.wine.decision):
        root.wine.decision.max_epochs = jax_root.wine.decision.max_epochs = 5
        out = {}
        for key, mod, dev in (("jax", jax_wine, JaxDevice()),
                              ("torch", wine, "cpu")):
            for p in (prng, jax_prng):
                p.get(1).seed(77)
                p.get(2).seed(78)
            wf = mod.WineWorkflow()
            wf.initialize(device=dev)
            wf.run()
            out[key] = (list(wf.decision.epoch_n_err), _params(wf))
    assert out["torch"][0] == out["jax"][0]
    for (gw, gb), (ww, wb) in zip(out["torch"][1], out["jax"][1]):
        _close(gw, ww, RTOL, "weights")
        _close(gb, wb, RTOL, "bias")


def test_wine_through_the_launcher_contract(port_snapshots):
    """``tests/functional/test_cli.py:34-50``."""
    with _restored(root.wine.decision):
        root.wine.decision.max_epochs = 15
        wf = launcher.run_workflow("wine", device="cpu")
    assert wf.decision.epoch_ended
    wf = launcher.run_workflow("wine", dry_run=True, device="cpu")
    assert not wf.decision.complete
    assert launcher.resolve_workflow_module("wine") is \
        launcher.resolve_workflow_module("znicz_tpu_torch.samples.wine")


@pytest.mark.parametrize("fused", [None, {"pool_impl": "offsets"}],
                         ids=["units", "fused"])
def test_yale_faces_trains_with_validation_split(tmp_path, fused):
    """``tests/functional/test_samples.py:60-75``, in both graphs."""
    kwargs = {} if fused is None else {"fused": fused}
    wf = yale_faces.run_sample(
        device="cpu",
        loader_config={"minibatch_size": 20,
                       "train_paths": [str(tmp_path / "CroppedYale")]},
        decision_config={"max_epochs": 15, "fail_iterations": 100},
        snapshotter_config={"directory": str(tmp_path / "snap")}, **kwargs)
    n_train = wf.loader.class_lengths[TRAIN]
    n_valid = wf.loader.class_lengths[VALID]
    assert n_valid == int(0.15 * (n_train + n_valid))
    assert wf.forwards[-1].output.shape[1] == 8
    assert wf.decision.best_n_err_pt[TRAIN] < 20.0, \
        wf.decision.best_n_err_pt


# -- the CLI ------------------------------------------------------------------

def _stl_args(tmp_path, data, *extra):
    return ["research.stl10",
            "--config", "stl.loader.directory=%s" % data["stl10"],
            "--config", "stl.loader.minibatch_size=10",
            "--config", "stl.decision.max_epochs=1",
            "--config", "stl.snapshotter.directory=%s" % tmp_path
            ] + list(extra)


def _stl_config():
    return _restored(root.stl, root.stl.loader, root.stl.decision,
                     root.stl.snapshotter)


@pytest.mark.parametrize("extra", [(), ("--fused", "pool_impl=offsets")],
                         ids=["units", "fused"])
def test_cli_trains_stl10_on_cpu(tmp_path, capsys, data, extra):
    with _stl_config():
        assert cli.main(_stl_args(tmp_path, data, "--device", "cpu",
                                  *extra)) == 0
    out = capsys.readouterr().out
    assert "best val/train err%: [None, " in out
    assert any(f.startswith("stl10_") for f in os.listdir(tmp_path))


def test_cli_needs_cuda_unless_cpu_asked(tmp_path, monkeypatch, data):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with _stl_config():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(_stl_args(tmp_path, data, "--dry-run"))
        assert cli.main(_stl_args(tmp_path, data, "--dry-run", "--device",
                                  "cpu")) == 0


def test_list_prints_the_jax_names(capsys):
    assert cli.main(["--list"]) == 0
    names = capsys.readouterr().out.split()
    assert names == launcher.list_samples()
    jax_names = jax_list_samples()
    assert [n for n in jax_names if n in names] == names
    for name in ("wine", "yale_faces", "cifar", "mnist", "lines",
                 "research.stl10",
                 "research.mnist_simple", "research.wine_relu",
                 "research.hands", "research.tv_channels",
                 "research.alexnet", "research.mnist7",
                 "research.mnist_ae", "demo_kohonen",
                 "research.spam_kohonen", "mnist_rbm", "sequence",
                 "research.long_context"):
        assert name in names
    assert names == jax_names and len(names) == 22


@pytest.mark.parametrize("name,module", [
    ("research.alexnet", alexnet), ("alexnet", alexnet),
    ("research.mnist7", mnist7), ("mnist7", mnist7),
    ("research.mnist_ae", mnist_ae), ("mnist_ae", mnist_ae),
    ("research.stl10", stl10), ("research.hands", hands),
    ("yale_faces", yale_faces)])
def test_research_names_resolve(name, module):
    assert launcher.resolve_workflow_module(name) is module


def test_unknown_research_name_raises():
    with pytest.raises(ImportError):
        launcher.resolve_workflow_module("research.no_such_sample")
