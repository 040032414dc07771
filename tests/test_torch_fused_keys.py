"""The fused trainer's keys ``defaults`` and ``rand`` in the port against
the JAX package's: the MNIST MLP 784-16-10 (no per-layer hypers, so
``defaults`` governs every layer) on 60 / 30 synthetic rows at
minibatch 30 through ``--fused``-style config ``{"window": 2,
"defaults": {...}, "rand": <a prng stream seeded 77>}``, in float64,
two epochs: two TRAIN windows of 2 steps.  The weights the net draws
from ``rand`` and the parameters after the two windows agree with the
JAX run's within 1e-12 of each tensor's largest magnitude; the proxies
carry the defaults; and ``rand`` is the stream drawn from (another seed
gives other weights).
"""

import numpy
import pytest

from test_torch_workflow import _restored
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.backends import JaxDevice
from znicz_tpu.core.config import root as jax_root
from znicz_tpu.samples import mnist as jax_mnist
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.samples import mnist

LAYERS = [{"type": "all2all_tanh", "->": {"output_sample_shape": 16}},
          {"type": "softmax", "->": {"output_sample_shape": 10}}]
DEFAULTS = {"lr": 0.05, "moment": 0.9, "wd": 0.0005}
RTOL = 1e-12


def _run(pkg, tmp_path, seed=77, epochs=2):
    sample, streams, device = (
        (mnist, prng, "cpu") if pkg == "torch" else
        (jax_mnist, jax_prng, JaxDevice()))
    streams.get(1).seed(1234)
    streams.get(2).seed(5678)
    wf = sample.build(
        layers=LAYERS,
        loader_config={"synthetic_train": 60, "synthetic_valid": 30,
                       "minibatch_size": 30},
        decision_config={"max_epochs": epochs, "fail_iterations": 50},
        snapshotter_config={"prefix": "keys", "interval": 10 ** 9,
                            "time_interval": 1e9, "compression": "",
                            "directory": str(tmp_path / pkg)},
        fused={"window": 2, "defaults": dict(DEFAULTS),
               "rand": streams.RandomGenerator().seed(seed)})
    wf.initialize(device=device)
    params0 = [{k: numpy.array(v) for k, v in p.items()}
               for p in wf.fused_trainer.host_params()]
    wf.run()
    params = [{k: numpy.array(v) for k, v in p.items()}
              for p in wf.fused_trainer.host_params()]
    return wf, params0, params


@pytest.fixture
def f64():
    with _restored(root.common.engine, jax_root.common.engine):
        root.common.engine.precision_dtype = numpy.float64
        jax_root.common.engine.precision_dtype = numpy.float64
        yield


def _close(got, want):
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            scale = max(float(numpy.abs(w[k]).max()), 1e-300)
            assert float(numpy.abs(g[k] - w[k]).max()) <= RTOL * scale, k


def test_defaults_and_rand_match_jax_in_f64(tmp_path, f64):
    wf, p0, p = _run("torch", tmp_path)
    jwf, jp0, jp = _run("jax", tmp_path)
    _close(p0, jp0)          # the weights drawn from ``rand``
    _close(p, jp)            # after two windows of two steps
    trainer = wf.fused_trainer
    assert trainer.defaults == DEFAULTS
    for proxy in trainer.gd_proxies:
        assert proxy.learning_rate == DEFAULTS["lr"]
        assert proxy.gradient_moment == DEFAULTS["moment"]
        assert proxy.weights_decay == DEFAULTS["wd"]
    assert wf.decision.epoch_n_err == jwf.decision.epoch_n_err


def test_rand_is_the_stream_the_weights_come_from(tmp_path, f64):
    _, p77, _ = _run("torch", tmp_path, epochs=1)
    _, again, _ = _run("torch", tmp_path, epochs=1)
    _, p78, _ = _run("torch", tmp_path, seed=78, epochs=1)
    for a, b in zip(p77, again):
        for k in a:
            assert (a[k] == b[k]).all()
    assert any((a["w"] != b["w"]).any() for a, b in zip(p77, p78))
