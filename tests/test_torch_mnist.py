"""The port's unit-at-a-time training graph (``mnist.build`` ->
StandardWorkflow -> forwards, evaluator, decision, snapshotter, GD
units, with ``fused=None``) against the JAX package's, on the CPU.

* The MNIST MLP and conv samples, float64, 120 TRAIN and 60 VALID
  synthetic rows in minibatches of 30, 3 epochs, both packages' prng
  streams seeded alike: every epoch's ``epoch_n_err`` per class and the
  confusion matrices are equal, and the final weights agree within
  1e-10 of each tensor's largest magnitude (the runs read about
  1e-15); the conv graph's output shapes are those of
  ``tests/functional/test_mnist.py``.
* Seeded alike, both packages draw the same initial weights; from
  other seeds, ``params.unit_params_from_numpy`` starts the port from
  the JAX package's state.
* The MLP at the JAX package's golden setup (600 / 200 rows,
  minibatch 60, seeds 1234 / 5678) reproduces its golden n_err
  sequence and first-layer checksum (``tests/functional/
  test_golden_jax.py``).
* The MNIST loader's synthetic rows and labels equal the JAX loader's
  bit for bit at the default sizes.
* Resuming from the epoch-1 snapshot equals the uninterrupted run bit
  for bit.
* A fused snapshot loaded into the unit graph, and a unit-graph
  snapshot into the fused graph, give the weights the JAX package's
  mapping gives, and warn that momentum restarts cold.
* ``python -m znicz_tpu_torch mnist --device cpu`` trains, a workflow
  file that builds the conv topology trains, and without CUDA and
  without ``--device cpu`` the CLI raises.
"""

import contextlib
import copy
import os

import numpy
import pytest
import torch

from test_torch_units import prng_streams_restored  # noqa: F401
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.backends import JaxDevice
from znicz_tpu.core.config import Config as JaxConfig
from znicz_tpu.core.config import root as jax_root
from znicz_tpu.loader import loader_mnist as jax_loader_mnist
from znicz_tpu.samples import mnist as jax_mnist
from znicz_tpu.units import nn_units as jax_nn_units
from znicz_tpu_torch import __main__ as cli
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.config import Config, root
from znicz_tpu_torch.core.snapshotter import SnapshotterToFile
from znicz_tpu_torch.loader import loader_mnist
from znicz_tpu_torch.loader.base import TRAIN, VALID
from znicz_tpu_torch.params import unit_params_from_numpy
from znicz_tpu_torch.samples import mnist
from znicz_tpu_torch.units import nn_units

RTOL = 1e-10
LOADER = {"synthetic_train": 120, "synthetic_valid": 60,
          "minibatch_size": 30}
EPOCHS = 3
#: the JAX package's golden unit-graph MNIST MLP (float64, synthetic
#: 600 / 200 rows, minibatch 60, seeds 1234 / 5678): (class, n_err) at
#: each segment end over 3 epochs, and the first layer's sum of |w|
#: (tests/functional/test_golden_jax.py:56-61)
GOLDEN_MLP_SEQUENCE = [(2, 393), (1, 86), (2, 105), (1, 12), (2, 18), (1, 4)]
GOLDEN_MLP_W0_ABSSUM = 1965.9344969151437


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes,
    and their thread pools would otherwise contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _node_values(node):
    """A config node's values, a child node's as a dict of its own."""
    return {k: (_node_values(v) if isinstance(v, (Config, JaxConfig))
                else copy.deepcopy(v))
            for k, v in node.__dict__.items()
            if not (k.startswith("_") and k.endswith("_"))}


def _put_node_back(node, values):
    """:func:`_node_values` back into the same node objects: modules
    hold references to nodes (``_cfg = root.common.serving``), so a
    node is never replaced by a copy."""
    for k in [k for k in node.__dict__
              if k not in values and not (k.startswith("_")
                                          and k.endswith("_"))]:
        del node.__dict__[k]
    for k, v in values.items():
        child = node.__dict__.get(k)
        if isinstance(v, dict) and isinstance(child, (Config, JaxConfig)):
            _put_node_back(child, v)
        else:
            object.__setattr__(node, k, v)


@contextlib.contextmanager
def _restored(*nodes):
    """Put config nodes back as they were (overrides add keys), in
    place."""
    saved = [(n, _node_values(n)) for n in nodes]
    try:
        yield
    finally:
        for n, values in saved:
            _put_node_back(n, values)


@pytest.fixture
def f64():
    with _restored(root.common.engine, jax_root.common.engine):
        root.common.engine.precision_dtype = numpy.float64
        jax_root.common.engine.precision_dtype = numpy.float64
        jax_root.common.engine.precision_type = "double"
        yield


def _seed(*prng_mods):
    for p in prng_mods:
        p.get(1).seed(1234)
        p.get(2).seed(5678)


def _recorded(wf):
    """``(class, epoch_n_err, confusion)`` at every segment end."""
    hist, d = [], wf.decision
    real = d.on_last_minibatch

    def on_last_minibatch():
        real()
        c = d.minibatch_class
        hist.append((c, d.epoch_n_err[c],
                     numpy.array(d.confusion_matrixes[c])))
    d.on_last_minibatch = on_last_minibatch
    return hist


def _train(module, snapdir, device, layers=None, loader=LOADER,
           epochs=EPOCHS, state=None, **kwargs):
    """Build, initialize (restore ``state``) and run; returns (workflow,
    segment history)."""
    wf = module.build(
        layers=layers, loader_config=dict(loader),
        decision_config={"max_epochs": epochs},
        snapshotter_config={"directory": str(snapdir)}, **kwargs)
    hist = _recorded(wf)
    wf.initialize(device=device)
    if state is not None:
        load_snapshot = nn_units.load_snapshot_into_workflow \
            if module is mnist else jax_nn_units.load_snapshot_into_workflow
        load_snapshot(state, wf)
    wf.run()
    return wf, hist


def _weights(wf):
    return [(numpy.array(f.weights.mem), numpy.array(f.bias.mem))
            for f in wf.forwards if f.weights]


@pytest.mark.parametrize("topology", ["mlp", "conv"])
def test_unit_graph_matches_jax(f64, tmp_path, topology):
    layers = {"mlp": (None, None),
              "conv": (jax_root.mnistr_conv.layers,
                       root.mnistr_conv.layers)}[topology]
    _seed(jax_prng, prng)
    jwf, jhist = _train(jax_mnist, tmp_path / "jax", JaxDevice(), layers[0])
    twf, thist = _train(mnist, tmp_path / "torch", "cpu", layers[1])
    assert [h[:2] for h in thist] == [h[:2] for h in jhist]
    assert [h[0] for h in thist] == [TRAIN, VALID] * EPOCHS
    for t, j in zip(thist, jhist):
        assert (t[2] == j[2]).all()
    assert twf.decision.best_n_err_pt == jwf.decision.best_n_err_pt
    assert twf.fused_trainer is None and len(twf.gds) == len(twf.forwards)
    assert twf.gds[0].need_err_input is False
    for (tw, tb), (jw, jb) in zip(_weights(twf), _weights(jwf)):
        for got, want in ((tw, jw), (tb, jb)):
            assert got.dtype == want.dtype == numpy.float64
            assert numpy.abs(got - want).max() <= \
                RTOL * numpy.abs(want).max()
    if topology == "conv":
        assert [tuple(f.output.shape) for f in twf.forwards] == [
            (30, 24, 24, 64), (30, 12, 12, 64), (30, 8, 8, 87),
            (30, 4, 4, 87), (30, 791), (30, 10)]
        assert [type(g).__name__ for g in twf.gds] == [
            "GradientDescentConv", "GDMaxPooling", "GradientDescentConv",
            "GDMaxPooling", "GDRELU", "GDSoftmax"]
        assert twf.gds[1].name == "gd_pool1"


def test_initial_weights_equal_jax_and_carry_over(f64, tmp_path):
    """Seeded alike, both packages draw the same initial weights, bit
    for bit; from other seeds, ``unit_params_from_numpy`` starts the
    port from the JAX package's state."""
    wfs = {}
    for name, module, rt, dev in (("jax", jax_mnist, jax_root, JaxDevice()),
                                  ("torch", mnist, root, "cpu")):
        _seed(jax_prng, prng)
        wfs[name] = module.build(
            layers=rt.mnistr_conv.layers, loader_config=dict(LOADER),
            snapshotter_config={"directory": str(tmp_path)})
        wfs[name].initialize(device=dev)
    want = _weights(wfs["jax"])
    for (tw, tb), (jw, jb) in zip(_weights(wfs["torch"]), want):
        assert numpy.array_equal(tw.view(numpy.uint64), jw.view(numpy.uint64))
        assert numpy.array_equal(tb.view(numpy.uint64), jb.view(numpy.uint64))
    prng.get(1).seed(99)
    other = mnist.build(layers=root.mnistr_conv.layers,
                        loader_config=dict(LOADER),
                        snapshotter_config={"directory": str(tmp_path)})
    other.initialize(device="cpu")
    assert not numpy.array_equal(_weights(other)[0][0], want[0][0])
    pairs = iter(want)
    unit_params_from_numpy(other.forwards, [
        next(pairs) if f.weights else None for f in other.forwards])
    for (tw, tb), (jw, jb) in zip(_weights(other), want):
        assert numpy.array_equal(tw, jw) and numpy.array_equal(tb, jb)


def test_mlp_reproduces_the_jax_golden_run(f64, tmp_path):
    _seed(prng)
    wf, hist = _train(mnist, tmp_path, "cpu", loader={
        "synthetic_train": 600, "synthetic_valid": 200,
        "minibatch_size": 60})
    assert [(c, n) for c, n, _ in hist] == GOLDEN_MLP_SEQUENCE
    w0 = float(numpy.abs(wf.forwards[0].weights.mem).sum())
    assert abs(w0 - GOLDEN_MLP_W0_ABSSUM) < 1e-9


def test_loader_synthetic_rows_equal_jax():
    from znicz_tpu.core.workflow import Workflow as JaxWorkflow
    from znicz_tpu_torch.core.workflow import Workflow
    j = jax_loader_mnist.MnistLoader(JaxWorkflow(None), synthetic=True)
    t = loader_mnist.MnistLoader(Workflow(None), synthetic=True)
    j.load_data()
    t.load_data()
    assert (t.synthetic_train, t.synthetic_valid) == (2000, 500)
    assert t.class_lengths == j.class_lengths == [0, 500, 2000]
    got, want = t.original_data.mem, numpy.asarray(j.original_data.mem)
    assert got.dtype == want.dtype == numpy.float32
    assert numpy.array_equal(got.view(numpy.uint32), want.view(numpy.uint32))
    assert t.original_labels == list(j.original_labels)


def test_resume_from_epoch_1_snapshot_is_exact(f64, tmp_path):
    _seed(prng)
    wf = mnist.build(layers=root.mnistr_conv.layers,
                     loader_config=dict(LOADER),
                     decision_config={"max_epochs": EPOCHS},
                     snapshotter_config={"directory": str(tmp_path)})
    wf.snapshotter.skip = None   # a snapshot after every epoch
    written = {}
    export = wf.snapshotter.export

    def recorded_export():
        epoch_done = wf.loader.epoch_number
        wf.snapshotter.prefix = "mnist_epoch%d" % epoch_done
        written[epoch_done] = export()
        return written[epoch_done]
    wf.snapshotter.export = recorded_export
    wf.initialize(device="cpu")
    wf.run()
    state = SnapshotterToFile.import_(written[1])
    assert state["units"]["gd_conv1"]["gradient_weights_with_moment"] \
        is not None
    _seed(prng)
    resumed, hist = _train(mnist, tmp_path / "resumed", "cpu",
                           root.mnistr_conv.layers, state=state)
    assert [h[0] for h in hist] == [TRAIN, VALID] * (EPOCHS - 1)
    assert resumed.decision.epoch_n_err == wf.decision.epoch_n_err
    for (rw, rb), (ww, wb) in zip(_weights(resumed), _weights(wf)):
        assert numpy.array_equal(rw.view(numpy.uint64), ww.view(numpy.uint64))
        assert numpy.array_equal(rb.view(numpy.uint64), wb.view(numpy.uint64))
    for rg, wg in zip(resumed.gds, wf.gds):
        for attr in ("gradient_weights_with_moment",
                     "gradient_bias_with_moment"):
            a, b = getattr(rg, attr), getattr(wg, attr)
            assert bool(a) == bool(b)
            if a:
                assert numpy.array_equal(a.mem, b.mem)


def _warnings(wf):
    said = []
    wf.warning = lambda msg, *args: said.append(msg % args)
    return said


def _fused_params(rng, wf):
    """Random parameters in the fused layout of ``wf``'s layers."""
    params = []
    for f in wf.forwards:
        params.append({} if not f.weights else {
            "w": rng.normal(size=f.weights.shape),
            "b": rng.normal(size=f.bias.shape)})
    return params


def test_fused_snapshot_into_the_unit_graph_maps_like_jax(f64, tmp_path):
    wfs = {}
    for name, module, rt, dev in (("jax", jax_mnist, jax_root, JaxDevice()),
                                  ("torch", mnist, root, "cpu")):
        wf = module.build(layers=rt.mnistr_conv.layers,
                          loader_config=dict(LOADER),
                          snapshotter_config={"directory": str(tmp_path)})
        wf.initialize(device=dev)
        wfs[name] = wf
    params = _fused_params(numpy.random.RandomState(3), wfs["torch"])
    state = {"units": {"fused_trainer": {"fused_state": {"params": params}}}}
    said = _warnings(wfs["torch"])
    jax_nn_units._map_cross_mode_state(copy.deepcopy(state), wfs["jax"])
    nn_units.load_snapshot_into_workflow(copy.deepcopy(state), wfs["torch"])
    assert len(said) == 1 and "momentum restarts cold" in said[0]
    got, want = _weights(wfs["torch"]), _weights(wfs["jax"])
    assert len(got) == len(want) == 4
    for (gw, gb), (ww, wb), p in zip(got, want,
                                     [p for p in params if p]):
        assert numpy.array_equal(gw, ww) and numpy.array_equal(gb, wb)
        assert numpy.array_equal(gw, p["w"])


def test_unit_graph_snapshot_into_fused_maps_like_jax(f64, tmp_path):
    _seed(prng)
    unit_wf, _ = _train(mnist, tmp_path / "unit", "cpu",
                        root.mnistr_conv.layers, epochs=1)
    snap = unit_wf.snapshotter.destination
    state = SnapshotterToFile.import_(snap)
    fused = {}
    for name, module, rt, dev, cfg in (
            ("jax", jax_mnist, jax_root, JaxDevice(),
             {"pool_impl": "gather"}),
            ("torch", mnist, root, "cpu", {"pool_impl": "offsets"})):
        wf = module.build(layers=rt.mnistr_conv.layers,
                          loader_config=dict(LOADER),
                          snapshotter_config={"directory": str(tmp_path)},
                          fused=cfg)
        wf.initialize(device=dev)
        fused[name] = wf
    said = _warnings(fused["torch"])
    jax_nn_units._map_cross_mode_state(copy.deepcopy(state), fused["jax"])
    nn_units.load_snapshot_into_workflow(copy.deepcopy(state), fused["torch"])
    assert len(said) == 1 and "momentum restarts cold" in said[0]
    got = fused["torch"].fused_trainer.fused_state["params"]
    want = fused["jax"].fused_trainer.fused_state["params"]
    units = [w for w in _weights(unit_wf)]
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert numpy.array_equal(g[k], numpy.asarray(w[k]))
    with_weights = [g for g in got if g]
    assert len(with_weights) == len(units) == 4
    for g, (uw, ub) in zip(with_weights, units):
        assert numpy.array_equal(g["w"], uw) and numpy.array_equal(g["b"], ub)


def _cli_args(tmp_path, *extra):
    return ["mnist", "--config", "mnistr.decision.max_epochs=2",
            "--config", "mnistr.loader.synthetic_train=120",
            "--config", "mnistr.loader.synthetic_valid=60",
            "--config", "mnistr.snapshotter.directory=%s" % tmp_path
            ] + list(extra)


def test_cli_trains_mnist_on_cpu(tmp_path, capsys):
    with _restored(root.mnistr, root.mnistr.loader, root.mnistr.decision,
                   root.mnistr.snapshotter):
        assert cli.main(_cli_args(tmp_path, "--device", "cpu")) == 0
    out = capsys.readouterr().out
    assert "best val/train err%: [None, " in out
    assert any(f.startswith("mnist_") for f in os.listdir(tmp_path))


def test_workflow_file_trains_the_conv_topology(tmp_path, capsys):
    wf_file = tmp_path / "mnist_conv_wf.py"
    wf_file.write_text(
        "from znicz_tpu_torch.core.config import root\n"
        "from znicz_tpu_torch.samples import mnist\n\n\n"
        "def run(load, main):\n"
        "    load(mnist.build, layers=root.mnistr_conv.layers)\n"
        "    main()\n")
    with _restored(root.mnistr, root.mnistr.loader, root.mnistr.decision,
                   root.mnistr.snapshotter):
        argv = _cli_args(tmp_path, "--device", "cpu")
        argv[0] = str(wf_file)
        argv[2] = "mnistr.decision.max_epochs=1"
        assert cli.main(argv) == 0
    assert "best val/train err%: [None, " in capsys.readouterr().out


def test_cli_needs_cuda_unless_cpu_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with _restored(root.mnistr, root.mnistr.loader, root.mnistr.decision,
                   root.mnistr.snapshotter):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(_cli_args(tmp_path, "--dry-run"))
        assert cli.main(_cli_args(tmp_path, "--dry-run", "--device",
                                  "cpu")) == 0
