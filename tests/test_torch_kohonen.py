"""The port's Kohonen maps (``ops/kohonen.py``, ``units/kohonen.py``,
``samples/demo_kohonen.py``, ``samples/research/spam_kohonen.py``)
against the JAX package's, on the CPU:

* ``make_coords`` equal; ``winners`` / ``train_step`` against
  ``winners_jax`` / ``train_step_jax`` in float64 (weights within
  1e-12, the histogram and the argmins equal) and against the numpy
  twins (weights within 1e-10); a tie, over more than 25 rows, goes to
  the first neuron in both packages;
* the trainer twin of ``tests/unit/test_kohonen_rbm_lstm.py``'s
  ``test_kohonen_trainer_organizes``, from the same initial weights
  (set through ``params.kohonen_params_from_numpy``; the JAX test draws
  them from the process-global stream, so it depends on the order of
  the tests): weights within 1e-12 relative after 30 steps (the
  default schedule overshoots, and some grow to hundreds), the winners
  equal, the clusters pure; the validator's twin;
* ``demo_kohonen`` for 30 epochs in float64 over the checkout's
  ``kohonen.txt.gz``: weights within 1e-10 of JAX's, ``total``
  identical, ``weights_diff`` within 1e-10;
* ``research.spam_kohonen`` at the golden test's seeds (1234 / 5678)
  for 6 epochs in float32: the fitness equals ``GOLDEN_SPAM_FITNESS``
  (``tests/functional/test_research_models.py:94``) and
  ``classified.txt`` holds 400 lines, the same as JAX's.
"""

import numpy
import pytest
import torch

from test_torch_mnist import _one_torch_thread, f64  # noqa: F401
from test_torch_units import prng_streams_restored  # noqa: F401
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.backends import JaxDevice
from znicz_tpu.core.memory import Array as JaxArray
from znicz_tpu.core.workflow import DummyWorkflow
from znicz_tpu.ops import kohonen as jax_ops
from znicz_tpu.samples import demo_kohonen as jax_demo
from znicz_tpu.samples.research import spam_kohonen as jax_spam
from znicz_tpu.units import kohonen as jax_units
from znicz_tpu_torch import params
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.workflow import Workflow
from znicz_tpu_torch.ops import kohonen as ops
from znicz_tpu_torch.samples import demo_kohonen
from znicz_tpu_torch.samples.research import spam_kohonen
from znicz_tpu_torch.units import kohonen as units

CPU = torch.device("cpu")
#: tests/functional/test_research_models.py:94
GOLDEN_SPAM_FITNESS = 2.7375


def _blobs(n=60, seed=0, dims=2):
    """Three separated clusters (in 2-D those of the JAX test)."""
    r = numpy.random.RandomState(seed)
    centers = numpy.array([[2.0, 2.0], [-2.0, 2.0], [0.0, -2.0]]) \
        if dims == 2 else r.uniform(-2.5, 2.5, (3, dims))
    labels = r.randint(0, 3, n)
    return centers[labels] + r.normal(0, 0.2, (n, dims)), labels


def _t(a):
    return torch.from_numpy(numpy.array(a))


@pytest.mark.parametrize("n", [1, 2, 4, 9, 10, 30, 64, 65])
def test_make_coords_equal(n):
    assert numpy.array_equal(ops.make_coords(n), jax_ops.make_coords(n))


@pytest.mark.parametrize("batch,dims,neurons", [
    (60, 2, 9), (80, 24, 64), (7, 5, 16)])
def test_train_step_matches_jax_and_numpy(batch, dims, neurons):
    x, _ = _blobs(batch, 1, dims)
    w = numpy.random.RandomState(2).uniform(-0.05, 0.05, (neurons, dims))
    coords = ops.make_coords(neurons)
    got_w, got_h, got_a = ops.train_step(_t(x), _t(w), _t(coords), 2.84,
                                         0.1)
    want_w, want_h, want_a = jax_ops.train_step_jax(x, w.copy(), coords,
                                                    2.84, 0.1)
    assert got_h.dtype == got_a.dtype == torch.int32
    assert numpy.abs(got_w.numpy() - numpy.asarray(want_w)).max() < 1e-12
    assert numpy.array_equal(got_h.numpy(), numpy.asarray(want_h))
    assert numpy.array_equal(got_a.numpy(), numpy.asarray(want_a))
    np_w, np_h, np_a = ops.train_step_numpy(x, w.copy(), coords, 2.84, 0.1)
    assert numpy.abs(got_w.numpy() - np_w).max() < 1e-10
    assert numpy.array_equal(got_h.numpy(), np_h)
    assert numpy.array_equal(got_a.numpy(), np_a)
    assert numpy.array_equal(ops.winners(_t(x), _t(w)).numpy(),
                             numpy.asarray(jax_ops.winners_jax(x, w)))
    assert numpy.array_equal(ops.winners_numpy(x, w),
                             jax_ops.winners_numpy(x, w))


def test_a_tie_goes_to_the_first_neuron():
    """Neurons 3 and 5 are one point and every sample is nearest to
    it; 40 rows (``torch.cdist`` would take its product expansion)."""
    r = numpy.random.RandomState(3)
    w = r.uniform(-1, 1, (8, 6))
    w[5] = w[3]
    x = w[3] + r.uniform(-1e-3, 1e-3, (40, 6))
    got = ops.winners(_t(x), _t(w)).numpy()
    assert (got == 3).all()
    assert numpy.array_equal(got, numpy.asarray(jax_ops.winners_jax(x, w)))
    _, hist, argmins = ops.train_step(_t(x), _t(w), _t(ops.make_coords(8)),
                                      1.0, 0.05)
    assert (argmins.numpy() == 3).all() and hist.numpy()[3] == 40
    assert hist.numpy().sum() == 40


def test_trainer_organizes_like_jax():
    x, labels = _blobs()
    w0 = numpy.random.RandomState(4).uniform(-0.05, 0.05, (9, 2))
    jwf = DummyWorkflow()
    jt = jax_units.KohonenTrainer(jwf, shape=(3, 3))
    jt.input = JaxArray(x.copy())
    jt.weights = JaxArray(w0.copy())
    jt.initialize(device=JaxDevice())
    wf = Workflow(None)
    trainer = units.KohonenTrainer(wf, shape=(3, 3))
    trainer.input = Array(x.copy())
    trainer.input.device = CPU
    trainer.initialize(device="cpu")
    params.kohonen_params_from_numpy(trainer, w0)
    for _ in range(30):
        jt.run()
        trainer.run()
    assert trainer.time == jt.time == 30
    got = params.kohonen_params_to_numpy(trainer)
    want = numpy.asarray(jt.weights.mem)
    # the default schedule overshoots: some weights grow to hundreds
    assert (numpy.abs(got - want) / numpy.maximum(numpy.abs(want), 1.0)
            ).max() < 1e-12
    assert numpy.array_equal(trainer.winners.mem, jt.winners.mem)
    fwd = units.KohonenForward(wf)
    fwd.input = trainer.input
    fwd.link_attrs(trainer, "weights")
    fwd.initialize(device="cpu")
    fwd.run()
    winners = fwd.output.mem
    jf = jax_units.KohonenForward(jwf)
    jf.input = JaxArray(x.copy())
    jf.link_attrs(jt, "weights")
    jf.initialize(device=JaxDevice())
    jf.run()
    assert numpy.array_equal(winners, numpy.asarray(jf.output.mem))
    purity = sum(numpy.unique(winners[labels == c],
                              return_counts=True)[1].max()
                 for c in range(3))
    assert purity / len(x) > 0.9


def test_trainer_draws_jax_initial_weights():
    x, _ = _blobs(20, 5, 3)
    for pkg in (jax_prng, prng):
        pkg.get(1).seed(77)
    jt = jax_units.KohonenTrainer(DummyWorkflow(), shape=(2, 3),
                                  weights_filling="gaussian")
    jt.input = JaxArray(x.copy())
    jt.initialize(device=JaxDevice())
    trainer = units.KohonenTrainer(Workflow(None), shape=(2, 3),
                                   weights_filling="gaussian")
    trainer.input = Array(x.copy())
    trainer.initialize(device="cpu")
    assert trainer.weights_stddev == jt.weights_stddev == 0.05
    assert numpy.array_equal(trainer.weights.mem, jt.weights.mem)
    assert trainer.gravity_radius == jt.gravity_radius


def test_validator_matches_jax():
    samples_by_label = {"a": {0, 1, 2}, "b": {3, 4, 5}}
    winners = numpy.array([1, 1, 1, 2, 2, 2], dtype=numpy.int32)
    v = units.KohonenValidator(Workflow(None))
    v.shape = (2, 2)
    v.samples_by_label = samples_by_label
    v.input = Array(winners)
    v.minibatch_indices = Array(numpy.arange(6, dtype=numpy.int32))
    v.input.device = v.minibatch_indices.device = CPU
    v.minibatch_size = 6
    v.initialize(device="cpu")
    v.run()
    jv = jax_units.KohonenValidator(DummyWorkflow())
    jv.shape = (2, 2)
    jv.samples_by_label = samples_by_label
    jv.input = JaxArray(winners)
    jv.minibatch_indices = JaxArray(numpy.arange(6, dtype=numpy.int32))
    jv.minibatch_size = 6
    jv.initialize()
    jv.run()
    assert v.fitness == jv.fitness == 1.0
    assert v.result == jv.result == {"a": {1}, "b": {2}}
    assert v.fitness_by_label == jv.fitness_by_label
    assert v.fitness_by_neuron == jv.fitness_by_neuron
    assert v.accumulated_input == jv.accumulated_input
    v.reset()
    assert v.accumulated_input == [set()] * 4


def _seed(*pkgs, a=1234, b=5678):
    for pkg in pkgs:
        pkg.get(1).seed(a)
        pkg.get(2).seed(b)


def test_demo_kohonen_30_epochs_equals_jax(f64):
    _seed(jax_prng)
    want = jax_demo.run_sample(epochs=30)
    _seed(prng)
    got = demo_kohonen.run_sample(device="cpu", epochs=30)
    assert got.loader.epoch_number == want.loader.epoch_number == 30
    assert got.loader.dataset_file == demo_kohonen.DATASET_FILE
    w = numpy.asarray(want.trainer.weights.mem)
    assert got.trainer.weights.mem.dtype == numpy.float64
    assert numpy.abs(got.trainer.weights.mem - w).max() < 1e-10
    total = got.forward.total.mem
    assert numpy.array_equal(total, numpy.asarray(want.forward.total.mem))
    assert len(set(total.tolist())) >= 4
    assert abs(got.decision.weights_diff - want.decision.weights_diff) \
        < 1e-10
    assert got.decision.weights_diff < 1.0
    assert numpy.array_equal(got.decision.winners_mem,
                             want.decision.winners_mem)


def test_spam_kohonen_golden_fitness(tmp_path):
    _seed(prng)
    wf = spam_kohonen.run_sample(
        device="cpu", epochs=6,
        exporter_file=str(tmp_path / "classified.txt"))
    assert wf.trainer.weights.dev.device.type == "cpu"
    assert round(float(wf.validator.fitness), 9) == GOLDEN_SPAM_FITNESS
    lines = (tmp_path / "classified.txt").read_text().splitlines()
    assert len(lines) == 400 and len(set(lines)) > 1
    _seed(jax_prng)
    want = jax_spam.run_sample(
        epochs=6, exporter_file=str(tmp_path / "jax.txt"))
    assert round(float(want.validator.fitness), 9) == GOLDEN_SPAM_FITNESS
    assert lines == (tmp_path / "jax.txt").read_text().splitlines()
    assert wf.validator.result == want.validator.result
