"""The port's MSE objective (``ops/evaluator.mse``, the MSE loader
mixins, ``EvaluatorMSE``, ``DecisionMSE``, ``StandardWorkflow``'s
``loss_function="mse"`` in both modes, ``samples/mnist7.py`` and
``FusedNet(objective="mse")`` on a regression head) against the JAX
package's, on the CPU.

* ``mse`` equals ``mse_jax`` (f64 to 1e-12, f32 to 1e-6 of the largest
  value) with and without ``root`` and ``mean``, on a padded tail
  minibatch.
* ``EvaluatorMSE`` (``root`` both ways, ``squared_mse``, with and
  without class targets) and ``DecisionMSE`` (epoch metrics,
  ``improved``, ``complete``, the snapshot suffix) behave as the JAX
  units on the same inputs.
* The seven-segment loader serves the JAX loader's targets.
* ``mnist7`` at the JAX package's pinned setup (120 / 60 synthetic rows,
  minibatch 30, seeds 1234 / 5678, f32) reproduces
  ``GOLDEN_ZOO2["mnist7"]`` (``tests/functional/
  test_research_models.py``): n_err exactly, the MSE within its
  ``MSE_RTOL``.  In f64 the unit graph and the fused graph give
  ``znicz_tpu``'s per-epoch n_err exactly and its metrics and final
  weights within 1e-12.
* ``FusedNet(objective="mse")`` on the FC regression head of
  ``tests/unit/test_fused_mse_ae.py`` matches JAX ``FusedNet`` in f64,
  refuses a softmax head, and its windows (host-stacked and indexed,
  with the nearest-class-target ``n_err``) equal per-step steps.
* The MSE window reads ``mse_root`` and ``class_targets`` at every
  window: changed after a window, the next one follows the new values
  (the JAX package keys its compiled window on whether class targets
  exist only).
"""

import numpy
import pytest
import torch

import jax.numpy as jnp
from test_torch_autoencoder import RESEARCH, _close, f64  # noqa: F401
from test_torch_mnist import _restored
from test_torch_units import prng_streams_restored  # noqa: F401
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.accelerated_units import \
    AcceleratedWorkflow as JaxWorkflow
from znicz_tpu.core.backends import JaxDevice
from znicz_tpu.core.config import root as jax_root
from znicz_tpu.core.memory import Array as JaxArray
from znicz_tpu.ops import evaluator as jax_ev
from znicz_tpu.parallel import FusedNet as JaxFusedNet
from znicz_tpu.samples.research import mnist7 as jax_mnist7
from znicz_tpu.units import decision as jax_decision
from znicz_tpu.units import evaluator as jax_evaluator
from znicz_tpu_torch import __main__ as cli
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.accelerated_units import AcceleratedWorkflow
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.loader.base import TRAIN, VALID
from znicz_tpu_torch.ops import evaluator as ev_ops
from znicz_tpu_torch.parallel import fused
from znicz_tpu_torch.samples import mnist7
from znicz_tpu_torch.units import decision, evaluator

RTOL64, RTOL32 = 1e-12, 1e-6
FC_LAYERS = [
    {"type": "all2all_tanh",
     "->": {"output_sample_shape": 7, "weights_stddev": 0.1,
            "bias_stddev": 0.1},
     "<-": {"learning_rate": 0.1, "weights_decay": 0.0}},
    {"type": "all2all",
     "->": {"output_sample_shape": 3, "weights_stddev": 0.1,
            "bias_stddev": 0.1},
     "<-": {"learning_rate": 0.1, "weights_decay": 0.0}}]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes,
    and their thread pools would otherwise contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the op and the units -----------------------------------------------------

@pytest.mark.parametrize("dtype,rtol", [(numpy.float64, RTOL64),
                                        (numpy.float32, RTOL32)])
@pytest.mark.parametrize("root_", [False, True])
@pytest.mark.parametrize("batch_size", [4, 6])
def test_mse_op_matches_jax(dtype, rtol, root_, batch_size):
    r = numpy.random.RandomState(2)
    out = r.uniform(-1, 1, (6, 4, 3)).astype(dtype)
    tgt = r.uniform(-1, 1, (6, 12)).astype(dtype)
    want = jax_ev.mse_jax(jnp.asarray(out), jnp.asarray(tgt.reshape(
        out.shape)), batch_size, mean=True, root=root_)
    got = ev_ops.mse(torch.from_numpy(out), torch.from_numpy(tgt),
                     batch_size, root=root_)
    for g, w, what in zip(got, want, ("err", "metrics", "mse_per")):
        _close(g.numpy(), numpy.asarray(w), rtol, what)
    assert numpy.array_equal(got[0].numpy()[batch_size:],
                             numpy.zeros((6 - batch_size, 4, 3)))


def _array(pkg, value):
    if pkg == "jax":
        return JaxArray(value.copy())
    arr = Array(value.copy())
    arr.device = torch.device("cpu")
    return arr


@pytest.mark.parametrize("root_", [False, True])
@pytest.mark.parametrize("with_targets", [False, True])
def test_evaluator_mse_matches_jax(f64, root_, with_targets):
    """Two minibatches, the second a tail of 3 rows in 5: err_output,
    the accumulated ``[sum, max, min]`` (min from inf), the per-sample
    MSE and the nearest-class-target n_err."""
    r = numpy.random.RandomState(4)
    ct = r.uniform(-1, 1, (4, 6))
    batches = [(r.uniform(-1, 1, (5, 2, 3)), r.uniform(-1, 1, (5, 6)),
                r.randint(0, 4, 5).astype(numpy.int32), n) for n in (5, 3)]
    got = {}
    for pkg, wf, mod in (("jax", JaxWorkflow(None), jax_evaluator),
                         ("torch", AcceleratedWorkflow(None), evaluator)):
        ev = mod.EvaluatorMSE(wf, root=root_, squared_mse=True)
        ev.output = _array(pkg, batches[0][0])
        ev.target = _array(pkg, batches[0][1])
        ev.batch_size = 5
        if with_targets:
            ev.class_targets = _array(pkg, ct)
            ev.labels = _array(pkg, batches[0][2])
        ev.initialize(device=JaxDevice() if pkg == "jax" else "cpu")
        assert ev.squared_mse and numpy.isinf(ev.metrics.mem[2])
        rows = []
        for out, tgt, lbl, n in batches:
            ev.output = _array(pkg, out)
            ev.target = _array(pkg, tgt)
            ev.batch_size = n
            if with_targets:
                ev.labels = _array(pkg, lbl)
            ev.run()
            rows += [numpy.array(a.mem) for a in (
                ev.err_output, ev.metrics, ev.mse, ev.n_err)]
        got[pkg] = rows
    for i, (g, w) in enumerate(zip(got["torch"], got["jax"])):
        if w.dtype.kind in "iu":
            assert numpy.array_equal(g, w), i
        else:
            _close(g, w, RTOL64, "array %d" % i)
    assert got["torch"][-1][1] == (8 if with_targets else 0)


def test_decision_mse_matches_jax():
    """Three epochs of a TRAIN and a VALID segment whose evaluator
    metrics are given: each class's epoch metrics (sum over the class
    length, max, min), ``improved`` on the VALID average, ``gd_skip``,
    the suffix, and ``complete`` once ``fail_iterations`` epochs passed
    without improvement."""
    valid_sums = [5.0, 4.0, 4.5, 4.8]
    got = {}
    for pkg, wf, mod, arr in (
            ("jax", JaxWorkflow(None), jax_decision, JaxArray),
            ("torch", AcceleratedWorkflow(None), decision, Array)):
        d = mod.DecisionMSE(wf, fail_iterations=1, max_epochs=10)
        d.minibatch_metrics = arr(numpy.array([0.0, 0.0, numpy.inf]))
        d.class_lengths = [0, 10, 20]
        d.minibatch_n_err = None
        d.epoch_number = 0
        d.last_minibatch = True
        d.initialize()
        rows = []
        for epoch, vsum in enumerate(valid_sums):
            for clazz, m, ended in ((TRAIN, [8.0 - epoch, 0.9, 0.1], False),
                                    (VALID, [vsum, 0.7, 0.2], True)):
                d.minibatch_class = clazz
                d.epoch_ended = ended
                d.epoch_number = epoch + ended
                d.minibatch_metrics.mem[:] = m
                d.run()
                rows.append((list(d.epoch_metrics), bool(d.improved),
                             bool(d.complete), bool(d.gd_skip),
                             d.snapshot_suffix,
                             list(d.minibatch_metrics.mem)))
        got[pkg] = rows
    assert got["torch"] == got["jax"]
    assert [r[1] for r in got["torch"][1::2]] == [True, True, False, False]
    assert [r[2] for r in got["torch"][1::2]] == [False, False, False, True]
    assert got["torch"][1][0][VALID] == (0.5, 0.7, 0.2)


def test_mnist7_loader_serves_the_jax_targets(tmp_path):
    out = {}
    for pkg, mod, p, dev in (("jax", jax_mnist7, jax_prng, JaxDevice()),
                             ("torch", mnist7, prng, "cpu")):
        p.get(2).seed(5678)
        wf = (JaxWorkflow if pkg == "jax" else AcceleratedWorkflow)(None)
        loader = mod.Mnist7Loader(wf, **dict(RESEARCH.MNIST_SYNTH))
        loader.initialize(device=dev)
        assert loader.targets_shape == (7,)
        rows = [numpy.array(loader.class_targets.mem)]
        for _ in range(7):
            loader.run()
            rows += [numpy.array(loader.minibatch_targets.mem),
                     numpy.array(loader.minibatch_labels.mem)]
        out[pkg] = rows
    for g, w in zip(out["torch"], out["jax"]):
        assert numpy.array_equal(g, w)


# -- mnist7, both modes -------------------------------------------------------

def _train_mnist7(module, device, snapdir, epochs=2, fused_cfg=None):
    for p in (prng, jax_prng):
        p.get(1).seed(1234)
        p.get(2).seed(5678)
    kwargs = dict(loader_config=dict(RESEARCH.MNIST_SYNTH),
                  decision_config={"max_epochs": epochs,
                                   "fail_iterations": 20},
                  fused=fused_cfg)
    if module is mnist7:
        kwargs["snapshotter_config"] = {"directory": str(snapdir)}
    wf = module.build(**kwargs)
    seq, metrics, d = [], [], wf.decision
    real = d.on_last_minibatch

    def on_last_minibatch():
        real()
        c = d.minibatch_class
        seq.append((int(c), int(d.epoch_n_err[c]),
                    round(float(d.epoch_metrics[c][0]), 9)))
        metrics.append(d.epoch_metrics[c])
    d.on_last_minibatch = on_last_minibatch
    wf.initialize(device=device)
    wf.run()
    return wf, seq, metrics


def _final_weights(wf):
    if wf.fused_trainer is not None:
        return [(p["w"], p["b"]) for p in wf.fused_trainer.net.host_params()]
    return [(numpy.array(f.weights.mem), numpy.array(f.bias.mem))
            for f in wf.forwards]


def test_mnist7_reproduces_the_golden_trajectory(tmp_path):
    wf, seq, _ = _train_mnist7(mnist7, "cpu", tmp_path)
    RESEARCH._assert_trajectory("mnist7", seq, RESEARCH.GOLDEN_ZOO2["mnist7"])
    assert wf.forwards[-1].output_sample_shape == (7,)


@pytest.mark.parametrize("fused_cfg", [None, {}], ids=["units", "fused"])
def test_mnist7_matches_jax_float64(f64, tmp_path, monkeypatch, fused_cfg):
    monkeypatch.setattr(jax_root.common.dirs, "snapshots", str(tmp_path))
    jwf, jseq, jmet = _train_mnist7(jax_mnist7, JaxDevice(), tmp_path,
                                    epochs=3, fused_cfg=fused_cfg)
    twf, tseq, tmet = _train_mnist7(mnist7, "cpu", tmp_path, epochs=3,
                                    fused_cfg=fused_cfg)
    assert [s[:2] for s in tseq] == [s[:2] for s in jseq]
    for got, want in zip(tmet, jmet):
        _close(numpy.array(got), numpy.array(want), RTOL64, "metrics")
    if fused_cfg is not None:
        assert twf.fused_trainer.window == jwf.fused_trainer.window == 8
    for (gw, gb), (ww, wb) in zip(_final_weights(twf), _final_weights(jwf)):
        assert gw.dtype == numpy.float64
        _close(gw, numpy.asarray(ww), RTOL64, "weights")
        _close(gb, numpy.asarray(wb), RTOL64, "bias")


@pytest.mark.parametrize("fused_flag", [[], ["--fused"]],
                         ids=["units", "fused"])
def test_mnist7_cli(tmp_path, fused_flag):
    """``python -m znicz_tpu_torch mnist7 [--fused] --device cpu``."""
    argv = ["mnist7", "--device", "cpu"] + fused_flag
    for key, value in (("loader.synthetic_train", 60),
                       ("loader.synthetic_valid", 30),
                       ("loader.minibatch_size", 30),
                       ("decision.max_epochs", 1),
                       ("snapshotter.directory", tmp_path)):
        argv += ["--config", "mnist7.%s=%s" % (key, value)]
    with _restored(root.mnist7, root.mnist7.loader, root.mnist7.decision,
                   root.mnist7.snapshotter):
        assert cli.main(argv) == 0


# -- FusedNet, objective="mse", on a regression head --------------------------

def _fc_nets():
    net = fused.FusedNet(FC_LAYERS, 10, rand=prng.RandomGenerator().seed(21),
                         dtype=numpy.float64, objective="mse", device="cpu")
    jnet = JaxFusedNet(FC_LAYERS, 10,
                       rand=jax_prng.RandomGenerator().seed(21),
                       dtype=numpy.float64, objective="mse")
    return net, jnet


def test_fused_mse_fc_matches_jax_float64():
    r = numpy.random.RandomState(11)
    x = r.uniform(-1, 1, (6, 10))
    t = r.uniform(-1, 1, (6, 3))
    net, jnet = _fc_nets()
    for bs in (6, 4):
        m, jm = net.step_mse(x, t, bs), jnet.step_mse(x, t, bs)
        _close(float(m["loss"]), float(jm["loss"]), RTOL64, "loss")
        _close(m["output"].numpy(), numpy.asarray(jm["output"]), RTOL64,
               "output")
    for p, jp in zip(net.host_params(), jnet.host_params()):
        for key in p:
            _close(p[key], jp[key], RTOL64, key)


def test_fused_mse_rejects_softmax_head():
    layers = [{"type": "softmax", "->": {"output_sample_shape": 3}}]
    with pytest.raises(ValueError, match="softmax"):
        fused.FusedNet(layers, 5, objective="mse", device="cpu")
    with pytest.raises(ValueError, match="objective='mse'"):
        fused.FusedNet(FC_LAYERS, 10, device="cpu")
    net, _ = _fc_nets()
    with pytest.raises(ValueError, match="softmax objective"):
        net.step(numpy.zeros((2, 10)), numpy.zeros(2, numpy.int32))


def test_fused_mse_windows_equal_steps():
    """Indexed windows over the same rows, a padded tail step included,
    with the indices given on the host or already as a tensor, give the
    per-step steps' parameters, the evaluator's folded metrics and the
    nearest-class-target n_err."""
    r = numpy.random.RandomState(6)
    data = r.uniform(-1, 1, (10, 10))
    ct = r.uniform(-1, 1, (4, 3))
    labels = r.randint(0, 4, 10).astype(numpy.int32)
    targets = ct[labels] + r.normal(scale=0.3, size=(10, 3))
    perm = r.permutation(10)
    starts, sizes = [0, 4, 8], [4, 4, 2]
    idx = numpy.full((3, 4), -1, numpy.int64)
    for k, (s, n) in enumerate(zip(starts, sizes)):
        idx[k, :n] = perm[s:s + n]
    safe = numpy.maximum(idx, 0)
    lbl_s = numpy.where(idx < 0, -1, labels[safe])

    steps, _ = _fc_nets()
    want = numpy.array([0.0, 0.0, numpy.inf])
    n_err = numpy.zeros(2, numpy.int64)
    for k in range(3):
        m = steps.step_mse(data[safe[k]], targets[safe[k]], sizes[k])
        _, md, _ = ev_ops.mse(m["output"], torch.from_numpy(
            targets[safe[k]]), sizes[k], root=True)
        md = md.numpy()
        want = numpy.array([want[0] + md[0], max(want[1], md[1]),
                            min(want[2], md[2])])
        n_err += ev_ops.nearest_target_errors(
            m["output"], torch.from_numpy(ct), torch.from_numpy(lbl_s[k]),
            sizes[k]).numpy()
    assert n_err[1] == 10 and 0 < n_err[0] < 10
    for mode in ("host", "tensor"):
        net, _ = _fc_nets()
        net.class_targets = ct
        hy = fused.stack_hypers(net.hypers, 3)
        net.set_dataset(data, labels, targets)
        stats = net.run_window_mse_indexed(
            idx if mode == "host" else torch.from_numpy(idx), sizes, hy)
        for p, s in zip(net.host_params(), steps.host_params()):
            for key in p:
                _close(p[key], s[key], RTOL64, "%s %s" % (mode, key))
        _close(stats["metrics"].numpy(), want, RTOL64, mode)
        assert numpy.array_equal(stats["n_err"].numpy(), n_err), mode
        acc = net.window_acc_host()
        assert numpy.array_equal(acc["n_err"], n_err)


def test_mse_window_follows_flags_changed_between_windows():
    """Changed after the first window, ``mse_root`` and
    ``class_targets`` rule the next window's stats (the JAX package's
    cached window keeps the first ones for ``mse_root``)."""
    r = numpy.random.RandomState(8)
    x = r.uniform(-1, 1, (8, 10))
    t = r.uniform(-1, 1, (8, 3))
    lbl = numpy.array([0, 1, 2, 0, 1, 1, 0, 2], numpy.int32)
    net, _ = _fc_nets()
    net.set_dataset(x, lbl, t)
    hy = fused.stack_hypers(net.hypers, 1)
    idx = numpy.arange(8).reshape(2, 1, 4)
    first = net.run_window_mse_indexed(idx[0], [4], hy)
    assert first["n_err"].tolist() == [0, 0]
    net.mse_root = False
    net.class_targets = r.uniform(-1, 1, (3, 3))
    second = net.run_window_mse_indexed(idx[1], [4], hy)
    out = second["output"]
    for root_, same in ((False, True), (True, False)):
        md = ev_ops.mse(out, torch.from_numpy(t[4:]), 4, root=root_)[1]
        assert torch.equal(second["metrics"], md) == same
    assert second["n_err"].tolist()[1] == 4
    assert torch.equal(second["n_err"], ev_ops.nearest_target_errors(
        out, torch.from_numpy(net.class_targets), torch.from_numpy(lbl[4:]),
        4))
