"""The port's package runner (``export.run_package_numpy``) and its
numpy twins (``ops.dense`` / ``conv`` / ``pooling`` / ``normalization``
/ ``activations``), and the port's packages through the C++ runtime
(``cpp/``), on the CPU.

* Packages the port trains and exports (the MNIST MLP, the CIFAR
  caffe topology with its LRN and average pooling, ``activation_mul``,
  the log / tanhlog / sincos activations, dropout, the small Lines
  topology), in float64: the port's ``run_package_numpy`` within
  ``JAX_TOL`` = 1e-12 of JAX's on the same package and input, and
  within ``OWN_TOL`` = 1e-10 of the port's own forward (the trained
  workflow's forward units on the CPU).
* Each numpy twin against JAX's on random input, ties in the max pools
  included: bit-equal values and offsets.
* The C++ runtime, built into the test's own directory (``make -C cpp
  BUILD=<tmp>``; skipped only where ``make`` itself is missing, as
  JAX's ``_build_cpp``): the ports of ``test_cpp_cli_matches_python``
  (the MLP, within 1e-5 of the port's forward, equal argmax),
  ``test_cpp_conv_cli_matches_python`` (the MNIST caffe convnet and the
  Lines package, within 1e-4 of ``run_package_numpy``, equal argmax)
  and ``test_cpp_cifar_topology`` (within 1e-4), float32 as in JAX
  (``tests/functional/test_package_export.py:80-355``).
"""

import os
import subprocess

import numpy
import pytest

from test_torch_autoencoder import f64  # noqa: F401
from test_torch_mnist import _one_torch_thread  # noqa: F401
from test_torch_units import prng_streams_restored  # noqa: F401
from znicz_tpu import export as jax_export
from znicz_tpu.ops import activations as jax_act
from znicz_tpu.ops import conv as jax_conv
from znicz_tpu.ops import dense as jax_dense
from znicz_tpu.ops import normalization as jax_norm
from znicz_tpu.ops import pooling as jax_pool
from znicz_tpu_torch import export
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.ops import activations, conv, dense, normalization
from znicz_tpu_torch.ops import pooling
from znicz_tpu_torch.samples import cifar, lines, mnist
from znicz_tpu_torch.standard_workflow import StandardWorkflow
import znicz_tpu_torch.loader.loader_cifar  # noqa: F401
import znicz_tpu_torch.loader.loader_wine  # noqa: F401

JAX_TOL, OWN_TOL = 1e-12, 1e-10
CPP_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cpp")


def _seed():
    prng.get(1).seed(1234)
    prng.get(2).seed(5678)


def _snap(tmp_path):
    return {"interval": 100, "time_interval": 1e9,
            "directory": str(tmp_path / "snap")}


def _wine(tmp_path, middle):
    """A Wine MLP with ``middle`` layers between its tanh layer and
    its softmax head, 1 epoch."""
    layers = [{"type": "all2all_tanh", "->": {"output_sample_shape": 8},
               "<-": {"learning_rate": 0.3}}] + middle + [
        {"type": "softmax", "->": {"output_sample_shape": 3},
         "<-": {"learning_rate": 0.3}}]
    return StandardWorkflow(
        None, layers=layers, loader_name="wine_loader",
        loader_config={"minibatch_size": 10},
        decision_config={"max_epochs": 1, "fail_iterations": 5},
        snapshotter_config=_snap(tmp_path))


def _lines_data(tmp_path):
    return lines.materialize_synthetic(str(tmp_path / "lines"), size=32)


#: name -> (builder(tmp_path), input sample shape)
PACKAGES = {
    "mlp": (lambda t: mnist.build(
        loader_config={"synthetic_train": 300, "synthetic_valid": 100,
                       "minibatch_size": 50},
        decision_config={"max_epochs": 2, "fail_iterations": 10},
        snapshotter_config=_snap(t)), (784,)),
    "mnist_caffe": (lambda t: mnist.build(
        layers=root.mnistr_caffe.layers,
        loader_config={"synthetic_train": 60, "synthetic_valid": 30,
                       "minibatch_size": 30},
        decision_config={"max_epochs": 1, "fail_iterations": 5},
        snapshotter_config=_snap(t)), (28, 28, 1)),
    "cifar": (lambda t: cifar.build(
        loader_config={"synthetic_train": 60, "synthetic_valid": 30,
                       "minibatch_size": 30},
        decision_config={"max_epochs": 1, "fail_iterations": 5},
        snapshotter_config=_snap(t)), (32, 32, 3)),
    "mul": (lambda t: _wine(t, [{"type": "activation_mul",
                                 "factor": 0.5}]), (13,)),
    "ext": (lambda t: _wine(t, [{"type": "activation_log"},
                                {"type": "activation_tanhlog"},
                                {"type": "activation_sincos"}]), (13,)),
    "dropout": (lambda t: _wine(t, [{"type": "dropout",
                                     "dropout_ratio": 0.5}]), (13,)),
    "lines": (lambda t: lines.build(
        mcdnnic_topology="8x32x32-6C4-MP2-6C4-MP3-16N-4N",
        loader_config={
            "train_paths": [os.path.join(_lines_data(t), "learn")],
            "validation_paths": [os.path.join(_lines_data(t), "test")]},
        decision_config={"max_epochs": 2},
        snapshotter_config=_snap(t)), (32, 32, 1)),
}


def _trained(name, tmp_path):
    """The named workflow trained on the CPU and its package."""
    _seed()
    wf = PACKAGES[name][0](tmp_path)
    wf.initialize(device="cpu")
    wf.run()
    pkg = str(tmp_path / ("%s.zip" % name))
    export.export_package(wf, pkg)
    return wf, pkg


def _own_forward(wf, x):
    """The trained workflow's forward units on ``x`` (the loader's
    minibatch size of rows), dropout in ``forward_mode``."""
    for fwd in wf.forwards:
        if type(fwd).__name__.startswith("Dropout"):
            fwd.forward_mode = True
    wf.forwards[0].input.reset(x.astype(wf.forwards[0].weights.mem.dtype))
    for fwd in wf.forwards:
        fwd.run()
    return numpy.array(wf.forwards[-1].output.mem)


def _input(name, wf, seed):
    n = wf.loader.max_minibatch_size
    return numpy.random.RandomState(seed).uniform(
        -1, 1, (n,) + PACKAGES[name][1])


@pytest.mark.parametrize("name", sorted(PACKAGES))
def test_matches_jax_runner_and_own_forward(f64, tmp_path, name):
    wf, pkg = _trained(name, tmp_path)
    manifest, _ = export.load_package(pkg)
    types = [e["type"] for e in manifest["layers"]]
    x = _input(name, wf, 0)
    got = export.run_package_numpy(pkg, x)
    want = jax_export.run_package_numpy(pkg, x)
    assert got.dtype == numpy.float64 and got.shape == want.shape
    assert numpy.abs(got - want).max() <= JAX_TOL
    own = _own_forward(wf, x)
    assert own.dtype == numpy.float64
    assert numpy.abs(got - own).max() <= OWN_TOL
    expected = {"cifar": "norm", "mul": "activation_mul",
                "ext": "activation_sincos", "dropout": "dropout",
                "lines": "max_pooling"}
    if name in expected:
        assert expected[name] in types
    if name == "cifar":
        assert "avg_pooling" in types


def test_runner_refuses_an_unknown_type(tmp_path):
    manifest = {"format": 1, "layers": [{"type": "kohonen", "arrays": {}}]}
    pkg = export.write_package(manifest, {}, str(tmp_path / "k.zip"))
    with pytest.raises(ValueError, match="unsupported type 'kohonen'"):
        export.run_package_numpy(pkg, numpy.zeros((1, 2)))


# -- the numpy twins ----------------------------------------------------------

@pytest.mark.parametrize("shape,k,sliding", [
    ((2, 7, 9, 3), 2, (2, 2)), ((2, 10, 10, 2), 3, (3, 3)),
    ((1, 5, 5, 2), 3, (2, 1)), ((2, 11, 8, 3), 2, (1, 2)),
    ((1, 13, 13, 4), 3, (2, 2))])
def test_pooling_twins_equal_jax(shape, k, sliding):
    r = numpy.random.RandomState(sum(shape))
    for x in (r.randint(-3, 3, shape).astype(numpy.float64),
              r.randn(*shape)):
        for use_abs in (False, True):
            got = pooling.max_pooling_numpy(x, k, k, sliding, use_abs)
            want = jax_pool.max_pooling_numpy(x, k, k, sliding, use_abs)
            assert numpy.array_equal(got[0], want[0])
            assert numpy.array_equal(got[1], want[1])
            assert got[1].dtype == numpy.int32
        avg = pooling.avg_pooling_numpy(x, k, k, sliding)
        assert numpy.abs(avg - jax_pool.avg_pooling_numpy(
            x, k, k, sliding)).max() <= JAX_TOL


def test_dense_conv_lrn_activation_twins_equal_jax():
    r = numpy.random.RandomState(3)
    x = r.randn(2, 9, 8, 3)
    w, b = r.randn(4, 3 * 2 * 3), r.randn(4)
    for padding, sliding in (((0, 0, 0, 0), (1, 1)), ((1, 2, 1, 0), (2, 2))):
        for act in ("linear", "tanh", "relu", "strict_relu", "sigmoid"):
            assert numpy.array_equal(
                conv.forward_numpy(x, w, b, 3, 2, padding, sliding, act),
                jax_conv.forward_numpy(x, w, b, 3, 2, padding, sliding,
                                       act))
    assert numpy.array_equal(normalization.lrn_forward_numpy(x),
                             jax_norm.lrn_forward_numpy(x))
    x2, w2 = r.randn(5, 7), r.randn(3, 7)
    for transposed in (False, True):
        ww = w2.T.copy() if transposed else w2
        assert numpy.array_equal(
            dense.forward_numpy(x2, ww, b[:3], "tanh", transposed),
            jax_dense.forward_numpy(x2, ww, b[:3], "tanh", transposed))
    for got, want in zip(dense.softmax_numpy(x2),
                         jax_dense.softmax_numpy(x2)):
        assert numpy.array_equal(got, want)
    z = r.randn(4, 6) * 5
    for name in ("log", "tanhlog", "sincos"):
        assert numpy.array_equal(activations.ext_apply_numpy(name, z),
                                 jax_act.ext_apply_numpy(name, z))


# -- the C++ runtime ----------------------------------------------------------

@pytest.fixture(scope="module")
def cpp_build(tmp_path_factory):
    """The C++ runtime built into this module's own directory (never
    ``cpp/build``, which the JAX tests' ``make`` writes)."""
    build = str(tmp_path_factory.mktemp("cpp"))
    try:
        res = subprocess.run(["make", "-j4", "-C", CPP_DIR,
                              "BUILD=%s" % build], check=False,
                             capture_output=True, text=True, timeout=600)
    except OSError as e:   # make itself missing
        pytest.skip("C++ toolchain unavailable: %s" % e)
    assert res.returncode == 0, \
        "C++ build failed (a compile error is a test failure, not a " \
        "skip):\n%s" % res.stderr
    return build


def _cpp(build, pkg, x, tmp_path):
    in_npy, out_npy = str(tmp_path / "in.npy"), str(tmp_path / "out.npy")
    numpy.save(in_npy, x)
    res = subprocess.run([os.path.join(build, "znicz_infer"), pkg, in_npy,
                          out_npy], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    return numpy.load(out_npy)


def test_cpp_cli_matches_python(cpp_build, tmp_path):
    wf, pkg = _trained("mlp", tmp_path)
    x = _input("mlp", wf, 1).astype(numpy.float32)
    y_cpp = _cpp(cpp_build, pkg, x, tmp_path)
    y_py = _own_forward(wf, x)
    assert y_cpp.shape == y_py.shape
    assert numpy.abs(y_cpp - y_py).max() < 1e-5
    assert numpy.array_equal(y_cpp.argmax(1), y_py.argmax(1))


@pytest.mark.parametrize("name", ["mnist_caffe", "lines"])
def test_cpp_conv_cli_matches_python(cpp_build, tmp_path, name):
    wf, pkg = _trained(name, tmp_path)
    x = _input(name, wf, 1)[:10].astype(numpy.float32)
    y_cpp = _cpp(cpp_build, pkg, x, tmp_path)
    y_py = export.run_package_numpy(pkg, x)
    assert y_cpp.shape == y_py.shape == (len(x), y_py.shape[1])
    assert numpy.abs(y_cpp - y_py).max() < 1e-4
    assert numpy.array_equal(y_cpp.argmax(1), y_py.argmax(1))


def test_cpp_cifar_topology(cpp_build, tmp_path):
    wf, pkg = _trained("cifar", tmp_path)
    x = _input("cifar", wf, 2)[:4].astype(numpy.float32)
    y_cpp = _cpp(cpp_build, pkg, x, tmp_path)
    y_py = export.run_package_numpy(pkg, x)
    assert y_cpp.shape == y_py.shape
    assert numpy.abs(y_cpp - y_py).max() < 1e-4
