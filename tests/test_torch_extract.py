"""The port's forward-workflow extraction (``StandardWorkflow.
extract_forward_workflow``, ``StandardWorkflowBase.create_workflow`` /
``run``), the interactive loader (``loader/interactive.py``), the
forwards' weight broadcast and the loader's ``has_labels`` /
``labels_mapping`` / ``shuffled_indices``, against the JAX package's,
on the CPU, in float64.

* ``test_train_extract_serve_pipeline`` and
  ``test_serving_workflow_is_reusable``, ports of
  ``tests/functional/test_package_export.py:145-276``: a Wine MLP
  trained in either package, its forward workflow extracted with an
  ``InteractiveLoader`` and fed samples; the outputs within 1e-5 of a
  direct numpy forward with the trainer's weights (JAX's check) and
  within ``TOL`` = 1e-10 of the JAX workflow's on the same samples; a
  second session serves new rows.
* A fused extraction, after ``tests/functional/test_fused_workflow.py:
  199``: MNIST conv trained through ``fused={"pool_impl": "offsets"}``,
  extracted with an MNIST loader factory and run over the loader's
  epoch: the same classes as ``FusedNet.predict``, and within ``TOL``
  of the JAX fused workflow's extraction.
* The weight broadcast, the interactive loader's contract and the
  loader's label and order properties, name for name against JAX's.
"""

import numpy
import pytest

from test_torch_autoencoder import f64  # noqa: F401
from test_torch_mnist import _one_torch_thread  # noqa: F401
from test_torch_units import prng_streams_restored  # noqa: F401
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.backends import JaxDevice
from znicz_tpu.core.config import root as jax_root
from znicz_tpu.core.workflow import Workflow as JaxWorkflow
from znicz_tpu.loader.base import UserLoaderRegistry as JaxRegistry
from znicz_tpu.loader.interactive import \
    InteractiveLoader as JaxInteractiveLoader
from znicz_tpu.loader.loader_mnist import MnistLoader as JaxMnistLoader
from znicz_tpu.samples import mnist as jax_mnist
from znicz_tpu.standard_workflow import StandardWorkflow as JaxWorkflowStd
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.workflow import Workflow
from znicz_tpu_torch.loader.base import TEST, UserLoaderRegistry
from znicz_tpu_torch.loader.interactive import InteractiveLoader
from znicz_tpu_torch.loader.loader_mnist import MnistLoader
from znicz_tpu_torch.samples import mnist
from znicz_tpu_torch.standard_workflow import StandardWorkflow
from znicz_tpu_torch.units.all2all import All2AllTanh
from znicz_tpu_torch.units.pooling import MaxPooling
import znicz_tpu.loader.loader_wine  # noqa: F401 (the JAX wine_loader)
import znicz_tpu_torch.loader.loader_wine  # noqa: F401 (the port's)

TOL = 1e-10
PORT = {"cls": StandardWorkflow, "loader": InteractiveLoader,
        "prng": prng, "device": "cpu"}
JAX = {"cls": JaxWorkflowStd, "loader": JaxInteractiveLoader,
       "prng": jax_prng, "device": None}
MNIST_LOADER = {"synthetic_train": 120, "synthetic_valid": 60,
                "minibatch_size": 30}


def _wine_mlp(side, tmp_path, hidden, epochs, prefix):
    for p in (prng, jax_prng):
        p.get(1).seed(1234)
        p.get(2).seed(5678)
    wf = side["cls"](
        None,
        layers=[
            {"type": "all2all_tanh", "->": {"output_sample_shape": hidden},
             "<-": {"learning_rate": 0.3}},
            {"type": "softmax", "->": {"output_sample_shape": 3},
             "<-": {"learning_rate": 0.3}},
        ],
        loader_name="wine_loader",
        loader_config={"minibatch_size": 10},
        decision_config={"max_epochs": epochs, "fail_iterations": 20},
        snapshotter_config={"prefix": prefix, "interval": 100,
                            "time_interval": 1e9,
                            "directory": str(tmp_path)})
    wf.initialize(**({"device": side["device"]} if side["device"] else {}))
    wf.run()
    return wf


def _extract(side, wf, minibatch_size=4):
    held = []

    def loader_factory(fwd_wf, **kwargs):
        held.append(side["loader"](fwd_wf, sample_shape=(13,),
                                   minibatch_size=minibatch_size))
        return held[-1]
    fwd_wf = wf.extract_forward_workflow(loader_factory=loader_factory)
    fwd_wf.initialize(**({"device": side["device"]} if side["device"]
                         else {}))
    return fwd_wf, held[0]


def _serve(fwd_wf, ldr, batch):
    for s in batch:
        ldr.feed(s)
    ldr.finish()
    fwd_wf.run()
    fwd_wf.forwards[-1].output.map_read()
    return numpy.array(fwd_wf.forwards[-1].output.mem[:int(
        ldr.minibatch_size)])


def test_train_extract_serve_pipeline(f64, tmp_path):
    samples = numpy.random.RandomState(0).uniform(
        -1, 1, (6, 13)).astype(numpy.float32)
    got = {}
    for key, side in (("jax", JAX), ("torch", PORT)):
        wf = _wine_mlp(side, tmp_path / key, 12, 5, "serve")
        fwd_wf, ldr = _extract(side, wf)
        out = _serve(fwd_wf, ldr, samples)
        # the weights really were copied: a direct numpy forward with
        # the trainer's weights
        w0, b0, w1, b1 = (numpy.array(a.mem) for a in (
            wf.forwards[0].weights, wf.forwards[0].bias,
            wf.forwards[1].weights, wf.forwards[1].bias))
        h = 1.7159 * numpy.tanh(0.6666 * (samples @ w0.T + b0))
        logits = h @ w1.T + b1
        e = numpy.exp(logits - logits.max(axis=1, keepdims=True))
        want = e / e.sum(axis=1, keepdims=True)
        # batches of 4: the last minibatch holds samples 4 and 5
        assert numpy.abs(out[:2] - want[4:6]).max() < 1e-5
        assert ldr.minibatch_class == TEST and ldr.class_lengths[TEST] == 6
        got[key] = (out, [numpy.array(f.weights.mem)
                          for f in fwd_wf.forwards])
    assert got["torch"][0].shape == got["jax"][0].shape == (2, 3)
    assert numpy.abs(got["torch"][0] - got["jax"][0]).max() < TOL
    for gw, ww in zip(got["torch"][1], got["jax"][1]):
        assert gw.dtype == numpy.float64
        assert numpy.abs(gw - ww).max() < TOL


def test_serving_workflow_is_reusable(f64, tmp_path):
    """A second feed() + run() session serves new predictions."""
    r = numpy.random.RandomState(1)
    first = r.uniform(-1, 1, (2, 13)).astype(numpy.float32)
    second = r.uniform(-1, 1, (2, 13)).astype(numpy.float32)
    got = {}
    for key, side in (("jax", JAX), ("torch", PORT)):
        wf = _wine_mlp(side, tmp_path / key, 8, 2, "reuse")
        fwd_wf, ldr = _extract(side, wf)
        a = _serve(fwd_wf, ldr, first)
        b = _serve(fwd_wf, ldr, second)
        assert a.shape == (2, 3) and b.shape == (2, 3)
        assert numpy.abs(a - b).max() > 1e-9   # fresh outputs, not stale
        assert len(ldr._queue) == 0 and ldr.epoch_number == 2
        got[key] = (a, b)
    for g, w in zip(got["torch"], got["jax"]):
        assert numpy.abs(g - w).max() < TOL


def test_fused_extract_forward_workflow(f64, tmp_path, monkeypatch):
    """A fused workflow's parameters reach a forward-only unit graph
    through the broadcast; the pools' empty dicts are skipped."""
    monkeypatch.setattr(jax_root.common.dirs, "snapshots", str(tmp_path))
    outs = {}
    for key, module, device, loader_cls, fused in (
            ("jax", jax_mnist, JaxDevice(), JaxMnistLoader,
             {"pool_impl": "gather"}),
            ("torch", mnist, "cpu", MnistLoader, {"pool_impl": "offsets"})):
        for p in (prng, jax_prng):
            p.get(1).seed(1234)
            p.get(2).seed(5678)
        cfg = root if key == "torch" else jax_root
        wf = module.build(
            layers=cfg.mnistr_conv.layers, loader_config=dict(MNIST_LOADER),
            decision_config={"max_epochs": 1, "fail_iterations": 50},
            snapshotter_config={"prefix": "fusedwf", "interval": 1,
                                "time_interval": 0, "compression": "",
                                "directory": str(tmp_path / key)},
            fused=fused)
        wf.initialize(device=device)
        wf.run()
        fwd_wf = wf.extract_forward_workflow(
            loader_factory=lambda w, cls=loader_cls: cls(
                w, name="loader", **dict(MNIST_LOADER)))
        fwd_wf.initialize(device=device)
        fwd_wf.run()
        out_unit = numpy.array(fwd_wf.forwards[-1].output.mem)
        x = numpy.array(fwd_wf.loader.minibatch_data.mem)
        out_fused = numpy.asarray(wf.fused_trainer.net.predict(x))
        assert out_unit.shape == out_fused.shape
        assert numpy.argmax(out_unit, 1).tolist() == \
            numpy.argmax(out_fused, 1).tolist()
        assert all(f.forward_mode for f in fwd_wf.forwards)
        outs[key] = (out_unit, fwd_wf)
    assert numpy.abs(outs["torch"][0] - outs["jax"][0]).max() < TOL
    pools = [f for f in outs["torch"][1].forwards
             if isinstance(f, MaxPooling)]
    assert len(pools) == 2 and not any(p.weights for p in pools)
    for g, w in zip(outs["torch"][1].forwards, outs["jax"][1].forwards):
        if w.weights:
            assert numpy.abs(numpy.array(g.weights.mem) -
                             numpy.array(w.weights.mem)).max() < TOL


# -- the weight broadcast -----------------------------------------------------

def test_weight_broadcast():
    wf = Workflow(None)
    src = All2AllTanh(wf, output_sample_shape=4, weights_stddev=0.1)
    src.input = Array(numpy.ones((2, 3)))
    src.initialize(device="cpu")
    data = src.generate_data_for_slave()
    assert [d.shape for d in data] == [(4, 3), (4,)]
    dst = All2AllTanh(wf, output_sample_shape=4)
    dst.apply_data_from_master(data)      # adopted before initialize
    dst.input = Array(numpy.zeros((2, 3)))
    dst.initialize(device="cpu")
    assert numpy.array_equal(dst.weights.mem, data[0])
    again = [d * 2 for d in data]
    dst.apply_data_from_master(again)     # copied into the allocation
    assert numpy.array_equal(dst.bias.mem, again[1])
    dst.apply_data_from_master([None, data[1]])
    assert numpy.array_equal(dst.weights.mem, again[0])
    dst.forward_mode = src.forward_mode = True
    assert src.generate_data_for_slave() is None
    dst.apply_data_from_master(data)
    assert numpy.array_equal(dst.bias.mem, data[1])
    pool = MaxPooling(wf, kx=2, ky=2)
    assert pool.generate_data_for_slave() is None
    pool.apply_data_from_master([numpy.ones(1), None])
    assert not pool.weights


# -- the interactive loader ---------------------------------------------------

@pytest.mark.parametrize("key", ["jax", "torch"])
def test_interactive_loader_contract(key):
    side = JAX if key == "jax" else PORT
    registry = JaxRegistry if key == "jax" else UserLoaderRegistry
    assert registry.get_factory("interactive") is side["loader"]
    wf = JaxWorkflow(None) if key == "jax" else Workflow(None)
    ldr = side["loader"](wf, sample_shape=(2, 3), minibatch_size=3,
                         unique_labels_count=5)
    ldr.initialize(**({"device": "cpu"} if key == "torch" else {}))
    assert ldr.minibatch_data.shape == (3, 2, 3)
    assert ldr.unique_labels_count == 5 and ldr.minibatch_class == TEST
    with pytest.raises(ValueError, match="sample shape"):
        ldr.feed(numpy.zeros(6))
    with pytest.raises(RuntimeError, match="empty queue"):
        ldr.run()
    rows = numpy.arange(24, dtype=numpy.float32).reshape(4, 2, 3)
    seen = []
    for i, r in enumerate(rows):
        ldr.feed(r, label=i)
    ldr.finish()
    while not ldr.complete:
        ldr.run()
        seen.append((int(ldr.minibatch_size), int(ldr.minibatch_offset),
                     bool(ldr.last_minibatch), bool(ldr.epoch_ended),
                     ldr.minibatch_labels.mem[:ldr.minibatch_size].tolist()))
    assert seen == [(3, 3, False, False, [0, 1, 2]),
                    (1, 4, True, True, [3])]
    assert numpy.array_equal(ldr.minibatch_data.mem[0], rows[3])
    assert ldr.epoch_number == 1 and ldr.class_lengths == [4, 0, 0]
    ldr.feed(rows[0])     # re-arms
    assert not ldr.complete and not ldr.epoch_ended


# -- the loader's labels and order -------------------------------------------

def test_loader_labels_and_order():
    """``has_labels``, ``labels_mapping`` and ``shuffled_indices`` of
    the Wine loader (integer labels, TRAIN shuffled from prng 2) and
    their base values, against JAX's from the same seed."""
    out = {}
    for key, registry, wf, p in (
            ("jax", JaxRegistry, JaxWorkflow(None), jax_prng),
            ("torch", UserLoaderRegistry, Workflow(None), prng)):
        p.get(2).seed(99)
        ldr = registry.get_factory("wine_loader")(wf, minibatch_size=10)
        before = (ldr.has_labels, dict(ldr.labels_mapping))
        ldr.initialize(**({"device": "cpu"} if key == "torch" else {}))
        out[key] = (before, ldr.has_labels, dict(ldr.labels_mapping),
                    ldr.shuffled_indices.tolist())
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == (False, {}) and out["torch"][1] is True
    assert sorted(out["torch"][3]) == list(range(178))
