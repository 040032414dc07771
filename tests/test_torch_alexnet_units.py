"""AlexNet through the port's unit-at-a-time graph (``alexnet.build``
with ``fused=None``: a forward and a GD unit a layer, the four
``zero_filter`` units masking the next layer's weights) against the JAX
package's, on the CPU.

* Full width (227x227x3 input, every published width, the sample's
  10-class head), float64, 8 TRAIN and 4 VALID rows in minibatches of
  4, 2 epochs: the port starts from the JAX run's initial weights,
  carried across layer by layer with ``params.unit_params_from_numpy``
  (its own streams seeded otherwise), and its dropout units are handed
  the masks the JAX units drew.  Each epoch's per-class n_err and
  confusion matrices are equal, and every weight and bias is within
  1e-10 of its tensor's largest magnitude (the run reads 1.8e-15).
  ``unit_params_to_numpy`` gives the carried pairs back, None at each
  filler.
* The JAX package's golden AlexNet run (``tests/functional/
  test_research_models.py:120-147``: float32, 16 / 8 rows, minibatch 4,
  seeds 1234 / 5678) is reproduced: its (class, n_err) sequence and
  first-layer sum of |w| within 1e-3, as pinned.  The dropout units
  draw the JAX units' masks: the JAX formula on the port's copy of the
  same host stream.
* The graph has 4 ``ZeroFiller`` and 5 ``ConvStrictRELU`` forwards and
  no filler among the GD units.
* The fused graph and the unit graph train a grouped conv alike
  (``tests/functional/test_fused_workflow.py:288``), the grouped
  weights compared through the mask.
* A narrow unit-graph snapshot whose grouped weights were moved off
  the mask, served by ``serve --latest alexnet``, answers what the
  unit graph's forward computes: the engine folds each mask in.
* ``python -m znicz_tpu_torch alexnet --device cpu`` (no ``--fused``)
  trains.
"""

import contextlib
import copy

import numpy
import pytest
import torch

from test_torch_fused import narrow_alexnet
from test_torch_serving_engine import _call
from test_torch_units import prng_streams_restored  # noqa: F401
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.backends import JaxDevice
from znicz_tpu.core.config import root as jax_root
from znicz_tpu.samples.research import alexnet as jax_alexnet
from znicz_tpu_torch import __main__ as cli
from znicz_tpu_torch import launcher
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.loader.base import TRAIN, VALID
from znicz_tpu_torch.params import (unit_params_from_numpy,
                                    unit_params_to_numpy)
from znicz_tpu_torch.samples import alexnet
from znicz_tpu_torch.serving import server as server_mod
from znicz_tpu_torch.standard_workflow import StandardWorkflow
from znicz_tpu_torch.units.dropout import DropoutForward
from znicz_tpu_torch.units.zerofilling import ZeroFiller
import znicz_tpu_torch.loader.loader_mnist  # noqa: F401

RTOL = 1e-10
LOADER = {"n_train": 8, "n_valid": 4, "minibatch_size": 4}
EPOCHS = 2
#: the JAX package's golden AlexNet run (tests/functional/
#: test_research_models.py:113-114)
GOLDEN_ALEXNET_SEQUENCE = [(2, 15), (1, 7), (2, 16), (1, 7)]
GOLDEN_ALEXNET_W0_ABSSUM = 277.9935607910156


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes,
    and their thread pools would otherwise contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    with _restored(root.common.engine, jax_root.common.engine):
        root.common.engine.precision_dtype = numpy.float64
        jax_root.common.engine.precision_dtype = numpy.float64
        jax_root.common.engine.precision_type = "double"
        yield


def _seed(*prng_mods, first=1234):
    for p in prng_mods:
        p.get(1).seed(first)
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


def _build(module, snapdir, loader=LOADER, epochs=EPOCHS, **kwargs):
    return module.build(
        loader_config=dict(loader),
        decision_config={"max_epochs": epochs, "fail_iterations": 50},
        snapshotter_config={"directory": str(snapdir), "interval": 1000,
                            "time_interval": 1e9}, **kwargs)


def _jax_pairs(wf):
    """The JAX forwards' ``(weights, bias)`` host pairs, layer by layer,
    None where a unit has none of its own (a filler's are the next
    layer's)."""
    return [None if getattr(f, "LINKS_NEXT_WEIGHTS", False) or
            not f.weights else
            (numpy.array(f.weights.mem), numpy.array(f.bias.mem))
            for f in wf.forwards]


def _record_jax_masks(wf):
    """Each JAX dropout unit's masks, in the order it drew them."""
    masks = {}
    for f in wf.forwards:
        if type(f).__name__ == "DropoutForward":
            real = f.calc_mask

            def calc_mask(f=f, real=real):
                real()
                masks.setdefault(f.name, []).append(numpy.array(f.mask.mem))
            f.calc_mask = calc_mask
    return masks


def _hand_masks(wf, masks):
    """The port's dropout units take ``masks`` (by unit name) in turn."""
    for f in wf.forwards:
        if isinstance(f, DropoutForward):
            queue = iter(masks[f.name])
            f.calc_mask = lambda f=f, queue=queue: f.mask.set_dev(
                torch.from_numpy(next(queue).copy()).to(f.device))


def _host_stream_masks(wf, rand):
    """The port's dropout units draw the JAX units' masks: the JAX
    formula (``znicz_tpu/units/dropout.py:62-69``) on ``rand``, the
    port's copy of the JAX units' host stream."""
    for f in wf.forwards:
        if isinstance(f, DropoutForward):
            def calc_mask(f=f):
                leave = 1.0 - f.dropout_ratio
                m = numpy.zeros(f.input.shape, f.input.dtype)
                rand.fill(m, -f.dropout_ratio, leave)
                m = numpy.ceil(numpy.maximum(m, 0)) / leave
                f.mask.set_dev(torch.from_numpy(
                    m.astype(f.input.dtype)).to(f.device))
            f.calc_mask = calc_mask


def test_unit_graph_matches_jax_at_full_width(f64, tmp_path):
    _seed(jax_prng)
    jwf = _build(jax_alexnet, tmp_path / "jax")
    jhist = _recorded(jwf)
    jwf.initialize(device=JaxDevice())
    pairs0 = _jax_pairs(jwf)
    masks = _record_jax_masks(jwf)
    jwf.run()

    _seed(prng, first=99)   # other initial weights, carried over below
    twf = _build(alexnet, tmp_path / "torch")
    thist = _recorded(twf)
    twf.initialize(device="cpu")
    assert not numpy.array_equal(unit_params_to_numpy(twf.forwards)[0][0],
                                 pairs0[0][0])
    unit_params_from_numpy(twf.forwards, pairs0)
    carried = unit_params_to_numpy(twf.forwards)
    assert [p is None for p in carried] == [p is None for p in pairs0]
    for got, want in zip(carried, pairs0):
        if want is not None:
            assert all(numpy.array_equal(g, w) for g, w in zip(got, want))
    _hand_masks(twf, masks)
    twf.run()

    assert [h[:2] for h in thist] == [h[:2] for h in jhist]
    assert [h[0] for h in thist] == [TRAIN, VALID] * EPOCHS
    for t, j in zip(thist, jhist):
        assert (t[2] == j[2]).all()
    assert len(masks["drop6_forward"]) == 2 * EPOCHS
    worst = 0.0
    for got, want in zip(unit_params_to_numpy(twf.forwards),
                         _jax_pairs(jwf)):
        if want is None:
            continue
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == numpy.float64
            worst = max(worst, numpy.abs(g - w).max() / numpy.abs(w).max())
    print("the port's weights and biases within %.3g of the JAX "
          "package's, relative to each tensor's largest" % worst)
    assert worst <= RTOL, worst


def test_reproduces_the_jax_golden_run(tmp_path):
    _seed(prng)
    wf = _build(alexnet, tmp_path, loader={"n_train": 16, "n_valid": 8,
                                           "minibatch_size": 4})
    hist = _recorded(wf)
    wf.initialize(device="cpu")
    _host_stream_masks(wf, prng.get(1))
    wf.run()
    assert [(c, n) for c, n, _ in hist] == GOLDEN_ALEXNET_SEQUENCE
    w0 = float(numpy.abs(wf.forwards[0].weights.mem).sum())
    assert abs(w0 - GOLDEN_ALEXNET_W0_ABSSUM) < 1e-3


def test_graph_structure(tmp_path):
    wf = _build(alexnet, tmp_path)
    names = [type(f).__name__ for f in wf.forwards]
    assert names.count("ConvStrictRELU") == 5
    assert names.count("ZeroFiller") == 4
    assert len(wf.forwards) == 21 and len(wf.gds) == 17
    assert not any(isinstance(g, ZeroFiller) for g in wf.gds)
    # each filler holds the next forward's weights; each grouped conv
    # reads the LRN's or the pool's output, never the filler's
    for i, f in enumerate(wf.forwards):
        if isinstance(f, ZeroFiller):
            nxt, prev = wf.forwards[i + 1], wf.forwards[i - 1]
            assert f.weights is nxt.weights
            assert nxt.input is prev.output
    assert wf.gds[0].need_err_input is False
    # no learning-rate adjuster: the JAX sample links none
    assert not hasattr(wf, "lr_adjuster")
    assert wf.gds[-1].name == "gd_fc_softmax8"
    assert wf.snapshotter in wf.gds[-1].links_from
    # a filler holds no weights of its own to carry
    pairs = [None] * len(wf.forwards)
    pairs[3] = (numpy.zeros((256, 2400)), None)
    with pytest.raises(ValueError, match="links the next layer's weights"):
        unit_params_from_numpy(wf.forwards, pairs)


@pytest.mark.parametrize("fused", [None, {"pool_impl": "offsets"}],
                         ids=["units", "fused"])
def test_no_learning_rate_adjuster_as_in_jax(tmp_path, fused):
    """The port's AlexNet links no learning-rate adjuster in either
    graph, as ``znicz_tpu/samples/research/alexnet.py:145-163`` links
    none: its units are the JAX build's, name for name, and every run
    trains at the config's base rates whatever its length (the
    ``lr_adjuster`` block is written, as in JAX, and not read)."""
    loader = dict(LOADER, size=67)
    wf = _build(alexnet, tmp_path / "torch", loader=loader, fused=fused)
    jwf = _build(jax_alexnet, tmp_path / "jax", loader=loader, fused=fused)
    assert [(type(u).__name__, u.name) for u in wf.units] == \
        [(type(u).__name__, u.name) for u in jwf.units]
    assert not hasattr(wf, "lr_adjuster") and \
        not hasattr(jwf, "lr_adjuster")
    assert not any(type(u).__name__ == "LearningRateAdjust"
                   for u in wf.units)
    assert root.alexnet.lr_adjuster.do is True
    if fused is None:
        assert [(g.learning_rate, g.learning_rate_bias)
                for g in wf.gds] == [(g.learning_rate, g.learning_rate_bias)
                                     for g in jwf.gds]
        assert (wf.gds[-1].learning_rate,
                wf.gds[-1].learning_rate_bias) == (0.01, 0.02)
    else:
        assert wf.fused_trainer.hyper_tick is None
        assert wf.loader in wf.fused_trainer.links_from


#: tests/functional/test_fused_workflow.py:297-315
GROUPED_LAYERS = [
    {"name": "c1", "type": "conv_tanh",
     "->": {"n_kernels": 4, "kx": 3, "ky": 3},
     "<-": {"learning_rate": 0.1, "weights_decay": 0.001,
            "gradient_moment": 0.9}},
    {"name": "mp", "type": "max_pooling", "->": {"kx": 2, "ky": 2}},
    {"name": "zf", "type": "zero_filter", "grouping": 2},
    {"name": "c2", "type": "conv_tanh",
     "->": {"n_kernels": 6, "kx": 3, "ky": 3},
     "<-": {"learning_rate": 0.1, "weights_decay": 0.001,
            "gradient_moment": 0.9}},
    {"name": "sm", "type": "softmax",
     "->": {"output_sample_shape": 10},
     "<-": {"learning_rate": 0.1}},
]


@pytest.mark.parametrize("pool_impl", ["gather", "offsets"])
def test_fused_zero_filter_matches_unit_graph(f64, tmp_path, pool_impl):
    """The grouped conv trains alike in both graphs: the fused graph
    masks before every step, the unit graph's filler before every
    forward, so the used (masked) weights agree within 1e-12; the
    unit graph lets the masked entries drift between a TRAIN update and
    the next forward, so they are compared through the mask.  The other
    layers agree within 1e-12 of their largest magnitude, but for the
    first conv: its tanh saturates to equal values in float64, which
    the fused graph's max pool (before the tanh) tells apart and the
    unit graph's (after it) does not, so a tie sends a gradient of about
    1e-10 to another cell; it is held within 1e-8."""
    def run(fused):
        _seed(prng)
        wf = StandardWorkflow(
            None, layers=GROUPED_LAYERS, loader_name="mnist_loader",
            loader_config={"synthetic_train": 60, "synthetic_valid": 30,
                           "minibatch_size": 30},
            decision_config={"max_epochs": 2, "fail_iterations": 20},
            snapshotter_config={"directory": str(tmp_path),
                                "interval": 100, "time_interval": 1e9},
            fused=fused)
        wf.initialize(device="cpu")
        wf.run()
        return wf

    wf_f = run({"pool_impl": pool_impl})
    wf_u = run(None)
    assert list(wf_f.decision.epoch_n_err) == \
        list(wf_u.decision.epoch_n_err)
    params = wf_f.fused_trainer.net.host_params()
    mask = wf_f.fused_trainer.net.specs[3].weight_mask
    for i, tol in ((3, 1e-12), (4, 1e-12), (0, 1e-8)):
        fwd = wf_u.forwards[i]
        w_mask = mask if i == 3 else 1.0
        for got, want in ((params[i]["w"] * w_mask,
                           fwd.weights.mem * w_mask),
                          (params[i]["b"], fwd.bias.mem)):
            assert numpy.abs(got - want).max() <= tol * numpy.abs(
                want).max()


def test_served_snapshot_folds_the_masks(tmp_path):
    """``serve --latest alexnet`` of a narrow unit-graph snapshot whose
    grouped weights hold values off the mask (as a GD update leaves
    them) answers the unit graph's forward: filler, then conv."""
    _seed(prng)
    wf = _build(alexnet, tmp_path, layers=narrow_alexnet(dropout=True),
                loader={"n_train": 8, "n_valid": 4, "minibatch_size": 4,
                        "size": 67}, epochs=1)
    wf.initialize(device="cpu")
    wf.run()
    fillers = [i for i, f in enumerate(wf.forwards)
               if isinstance(f, ZeroFiller)]
    assert len(fillers) == 3
    r = numpy.random.RandomState(4)
    for i in fillers:
        nxt = wf.forwards[i + 1]
        w = numpy.array(nxt.weights.mem)
        nxt.weights.reset(w + r.uniform(0.1, 0.2, w.shape).astype(w.dtype))
    wf.snapshotter.suffix = "moved"
    wf.snapshotter.export()
    snapshot = launcher.newest_snapshot(str(tmp_path), "alexnet")
    assert snapshot is not None and "moved" in snapshot

    x = r.uniform(-1, 1, (4, 67, 67, 3)).astype(numpy.float32)
    loader = wf.loader
    loader.minibatch_data.reset(x.copy())
    loader.minibatch_class = VALID
    for f in wf.forwards:
        f.run()
    want = numpy.array(wf.forwards[-1].output.mem)
    for i in fillers:
        assert (numpy.array(wf.forwards[i + 1].weights.mem) *
                (1 - wf.forwards[i].mask.mem) == 0).all()

    srv, label = server_mod.serve([
        "alexnet", "--latest", "--directory", str(tmp_path),
        "--device", "cpu", "--port", "0", "--max-batch", "4"])
    try:
        assert label == snapshot
        status, doc = _call(srv.port, "POST", "/predict",
                            {"inputs": x.tolist()})
    finally:
        srv.drain()
    assert status == 200
    got = numpy.asarray(doc["outputs"], numpy.float32)
    numpy.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert doc["argmax"] == want.argmax(axis=1).tolist()


def test_cli_trains_alexnet_through_the_unit_graph(tmp_path, capsys):
    """``python -m znicz_tpu_torch alexnet --device cpu`` with small
    rows and a narrow input trains one epoch through the unit graph."""
    with _restored(root.alexnet):
        assert cli.main([
            "alexnet", "--device", "cpu",
            "--config", "alexnet.loader.n_train=8",
            "--config", "alexnet.loader.n_valid=4",
            "--config", "alexnet.loader.size=67",
            "--config", "alexnet.decision.max_epochs=1",
            "--config", "alexnet.snapshotter.directory=%s" % tmp_path]) == 0
    assert launcher.newest_snapshot(str(tmp_path), "alexnet") is not None
