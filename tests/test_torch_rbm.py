"""The port's Bernoulli RBM (``units/rbm_units.py``,
``samples/mnist_rbm.py``) against the JAX package's, on the CPU:

* ``Binarization`` bit-equal to JAX's for the same seed, 2-D over part
  of the batch (the rest copied) and 1-D with ``n`` trials, float32 and
  float64: the port draws JAX's uniforms on the host and compares them
  on the device;
* the twins of ``tests/unit/test_kohonen_rbm_lstm.py``'s
  ``test_rbm_gradient_workflow_runs_cd1`` (the CD-1 chain: ``v1``
  equal, ``h1`` within 1e-12) and ``test_rbm_cd_units_pipeline`` (the
  statistics, gradients and update within 1e-12);
* ``mnist_rbm`` at the small config of ``tests/functional/
  test_samples.py:91-110`` (256 samples, minibatch 64, ``h_size`` 64,
  seeds 1024 / 1025) for 6 epochs: each epoch's reconstruction MSE
  within 1e-6 relative of JAX's in float32 and 1e-12 in float64, the
  last below the first;
* one full-width step (784 -> 1000, minibatch 128) equal to JAX's:
  weights, hbias and vbias within 1e-6 (float32), the reconstruction
  MSE within 1e-6 relative;
* ``params.rbm_params_from_numpy`` / ``rbm_params_to_numpy``.
"""

import numpy
import pytest
import torch

from test_torch_mnist import _one_torch_thread, f64  # noqa: F401
from test_torch_units import prng_streams_restored  # noqa: F401
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.backends import NumpyDevice
from znicz_tpu.core.memory import Array as JaxArray
from znicz_tpu.core.workflow import DummyWorkflow
from znicz_tpu.samples import mnist_rbm as jax_mnist_rbm
from znicz_tpu.units import rbm_units as jax_rbm
from znicz_tpu_torch import params
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.workflow import Workflow
from znicz_tpu_torch.samples import mnist_rbm
from znicz_tpu_torch.units import rbm_units

CPU = torch.device("cpu")
SMALL = {"synthetic_train": 256, "minibatch_size": 64}


def _array(a):
    arr = Array(numpy.array(a))
    arr.device = CPU
    return arr


@pytest.mark.parametrize("dtype", [numpy.float32, numpy.float64])
def test_binarization_bit_equal_to_jax(dtype):
    p = numpy.random.RandomState(8).uniform(0, 1, (9, 13)).astype(dtype)
    b = rbm_units.Binarization(Workflow(None),
                               rand=prng.RandomGenerator().seed(7))
    b.input, b.batch_size = _array(p), 6
    b.initialize(device="cpu")
    jb = jax_rbm.Binarization(DummyWorkflow(),
                              rand=jax_prng.RandomGenerator().seed(7))
    jb.input, jb.batch_size = JaxArray(p.copy()), 6
    jb.initialize(device=NumpyDevice())
    for _ in range(2):
        b.run()
        jb.run()
        got, want = b.output.mem, numpy.asarray(jb.output.mem)
        assert got.dtype == want.dtype == dtype
        assert numpy.array_equal(got, want)
        assert numpy.array_equal(got[6:], p[6:])
        assert set(numpy.unique(got[:6])) <= {0.0, 1.0}
    q = numpy.random.RandomState(9).uniform(0, 1, 17).astype(dtype)
    assert numpy.array_equal(b.matlab_binornd(3, torch.from_numpy(q)),
                             jb.matlab_binornd(3, q))


def test_gradient_rbm_cd1_equals_jax():
    r = numpy.random.RandomState(3)
    v_size, h_size, batch = 12, 6, 8
    h0 = r.uniform(0, 1, (batch, h_size))
    w = r.uniform(-0.1, 0.1, (h_size, v_size))
    out = {}
    for pkg, wf_cls, arr, units, kw in (
            ("jax", DummyWorkflow, JaxArray, jax_rbm,
             {"device": NumpyDevice()}),
            ("torch", lambda: Workflow(None), _array, rbm_units,
             {"device": "cpu"})):
        rand = jax_prng if pkg == "jax" else prng
        grad = units.GradientRBM(
            wf_cls(), stddev=0.1, cd_k=1, v_size=v_size, h_size=h_size,
            rand_h=rand.RandomGenerator().seed(1),
            rand_v=rand.RandomGenerator().seed(2))
        grad.input = arr(h0.copy())
        grad.weights = arr(w.copy())
        grad.hbias = arr(numpy.zeros((1, h_size)))
        grad.vbias = arr(numpy.zeros((1, v_size)))
        grad.batch_size = batch
        grad.initialize(**kw)
        grad.run()
        out[pkg] = (numpy.array(grad.v1.mem), numpy.array(grad.h1.mem))
    assert out["torch"][0].shape == (batch, v_size)
    assert out["torch"][1].shape == (batch, h_size)
    assert numpy.array_equal(out["torch"][0], out["jax"][0])
    assert numpy.abs(out["torch"][1] - out["jax"][1]).max() < 1e-12
    h1 = out["torch"][1]
    assert ((h1 >= 0) & (h1 <= 1)).all()


def test_cd_units_pipeline_equals_jax():
    r = numpy.random.RandomState(4)
    batch, v_size, h_size = 5, 4, 3
    v0, h0, v1, h1 = (r.uniform(0, 1, (batch, n))
                      for n in (v_size, h_size, v_size, h_size))
    got, want = {}, {}
    for pkg, out in (("jax", want), ("torch", got)):
        units = jax_rbm if pkg == "jax" else rbm_units
        wf = DummyWorkflow() if pkg == "jax" else Workflow(None)
        arr = JaxArray if pkg == "jax" else _array
        kw = {"device": NumpyDevice()} if pkg == "jax" else {"device": "cpu"}
        bw0 = units.BatchWeights(wf)
        bw0.v, bw0.h, bw0.batch_size = arr(v0), arr(h0), batch
        bw0.initialize(**kw)
        bw0.run()
        bw1 = units.BatchWeights2(wf)
        bw1.v, bw1.h, bw1.batch_size = arr(v1), arr(h1), batch
        bw1.initialize(**kw)
        bw1.run()
        gc = units.GradientsCalculator(wf)
        gc.hbias0, gc.vbias0, gc.weights0 = (
            bw0.hbias_batch, bw0.vbias_batch, bw0.weights_batch)
        gc.hbias1, gc.vbias1, gc.weights1 = (
            bw1.hbias_batch, bw1.vbias_batch, bw1.weights_batch)
        gc.initialize(**kw)
        gc.run()
        wu = units.WeightsUpdater(wf, learning_rate=0.5)
        wu.weights = arr(numpy.zeros((h_size, v_size)))
        wu.hbias = arr(numpy.zeros((1, h_size)))
        wu.vbias = arr(numpy.zeros((1, v_size)))
        wu.hbias_grad, wu.vbias_grad, wu.weights_grad = (
            gc.hbias_grad, gc.vbias_grad, gc.weights_grad)
        wu.initialize()
        wu.run()
        for name, a in (("weights_batch", bw0.weights_batch),
                        ("hbias_batch", bw1.hbias_batch),
                        ("weights_grad", gc.weights_grad),
                        ("vbias_grad", gc.vbias_grad),
                        ("weights", wu.weights), ("hbias", wu.hbias),
                        ("vbias", wu.vbias)):
            out[name] = numpy.array(a.mem)
    assert numpy.allclose(got["weights_batch"], v0.T @ h0 / batch,
                          rtol=0, atol=1e-15)
    assert numpy.allclose(got["weights_grad"],
                          (v0.T @ h0 - v1.T @ h1) / batch, rtol=0,
                          atol=1e-15)
    for name, value in want.items():
        assert got[name].shape == value.shape, name
        assert numpy.abs(got[name] - value).max() < 1e-12, name
    assert numpy.allclose(got["weights"], 0.5 * got["weights_grad"].T)


def _rbm_mses(module, device, epochs, **kwargs):
    """Build and run ``module``'s RBM workflow; returns it and each
    epoch's reconstruction MSE (of its last minibatch)."""
    wf = module.MnistRBMWorkflow(max_epochs=epochs, **kwargs)
    mses = []
    real = wf.decision._on_last_minibatch

    def on_last_minibatch():
        mses.append(wf.reconstruction_mse())
        real()
    wf.decision._on_last_minibatch = on_last_minibatch
    wf.initialize(**device)
    wf.run()
    return wf, mses


def _seed(pkg):
    pkg.get(1).seed(1024)
    pkg.get(2).seed(1025)


def _small_run(module, pkg, device):
    _seed(pkg)
    return _rbm_mses(module, device, 6, loader_config=dict(SMALL),
                     rbm_config={"h_size": 64})


def test_mnist_rbm_small_config_per_epoch_mse_f32():
    wf, got = _small_run(mnist_rbm, prng, {"device": "cpu"})
    _, want = _small_run(jax_mnist_rbm, jax_prng, {})
    assert wf.hidden.weights.mem.dtype == numpy.float32
    assert len(got) == len(want) == 6
    numpy.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert numpy.isfinite(got).all() and got[-1] < got[0]


def test_mnist_rbm_small_config_per_epoch_mse_f64(f64):
    wf, got = _small_run(mnist_rbm, prng, {"device": "cpu"})
    jwf, want = _small_run(jax_mnist_rbm, jax_prng, {})
    assert wf.hidden.weights.mem.dtype == numpy.float64
    numpy.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert got[-1] < got[0]
    got_p, want_p = params.rbm_params_to_numpy(wf), {
        "weights": jwf.hidden.weights.mem, "hbias": jwf.hidden.bias.mem,
        "vbias": jwf.vbias.mem}
    for key, value in want_p.items():
        assert numpy.abs(got_p[key] - numpy.asarray(value)).max() < 1e-12


def test_full_width_step_equals_jax():
    """784 -> 1000 at minibatch 128: one CD-1 step."""
    one = {"synthetic_train": 128, "minibatch_size": 128}
    _seed(prng)
    wf, got = _rbm_mses(mnist_rbm, {"device": "cpu"}, 1,
                        loader_config=dict(one))
    _seed(jax_prng)
    jwf, want = _rbm_mses(jax_mnist_rbm, {}, 1, loader_config=dict(one))
    assert wf.hidden.weights.shape == (1000, 784)
    assert wf.vbias.mem.shape == (1, 784)
    got_p = params.rbm_params_to_numpy(wf)
    for key, value in (("weights", jwf.hidden.weights.mem),
                       ("hbias", jwf.hidden.bias.mem),
                       ("vbias", jwf.vbias.mem)):
        assert got_p[key].dtype == numpy.asarray(value).dtype, key
        assert numpy.abs(got_p[key] - numpy.asarray(value)).max() < 1e-6
    numpy.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_rbm_params_round_trip():
    wf = mnist_rbm.MnistRBMWorkflow(
        loader_config=dict(SMALL), rbm_config={"h_size": 16})
    wf.initialize(device="cpu")
    r = numpy.random.RandomState(5)
    want = {"weights": r.uniform(-1, 1, (16, 784)).astype(numpy.float32),
            "hbias": r.uniform(-1, 1, 16).astype(numpy.float32),
            "vbias": r.uniform(-1, 1, (1, 784))}
    params.rbm_params_from_numpy(wf, want)
    got = params.rbm_params_to_numpy(wf)
    for key in want:
        assert numpy.array_equal(got[key], want[key])
    # the chain shares them: its visible layer reads the same vbias
    assert numpy.array_equal(wf.grad_rbm.make_v.bias.mem, want["vbias"])
    assert numpy.array_equal(params.rbm_params_to_numpy(wf.grad_rbm)[
        "weights"], want["weights"])
