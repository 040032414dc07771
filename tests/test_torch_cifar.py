"""The port's CIFAR-10 slice (``znicz_tpu_torch.samples.cifar``: the
CIFAR loader, ``internal_mean``, the learning-rate adjuster in both
graphs) against the JAX package's, on the CPU.

* The loader's synthetic rows and labels, and the rows after
  ``internal_mean``, equal the JAX loader's bit for bit; the pickle
  path reads three-row ``cifar-10-batches-py`` pickles written here
  (CHW bytes to NHWC, [VALID test_batch | TRAIN data_batch_1..5]) as
  the JAX loader does, and ``synthetic=False`` without them raises
  ``OSError``.
* The caffe config through the unit graph in float64 (200 TRAIN and 80
  VALID rows, minibatch 40, 2 epochs, the published schedule): every
  epoch's per-class n_err and confusion matrix equal ``znicz_tpu``'s,
  and every weight and bias within 1e-12 of the tensor's largest; the
  adjuster feeds the GD chain (``lr_adjuster in gds[-1].links_from``).
* The fused graph (``pool_impl="offsets"``, windows of 8) against the
  unit graph, in float64, with a schedule that drops the rate 10x after
  3 TRAIN minibatches — inside the first window of 5: equal n_err and
  confusion matrices, parameters within 1e-12, the same rates at every
  step, and the JAX package's fused graph on the same schedule.
* A run resumed from its epoch-1 snapshot, in the middle of a schedule
  whose boundary comes in epoch 2, ends bit-equal to the uninterrupted
  run, its rates and the adjuster's count included (both graphs).
* The ``mlp`` and ``nin`` variants build and train as in
  ``tests/functional/test_cifar.py``.
* ``python -m znicz_tpu_torch cifar`` trains on the CPU with
  ``--device cpu`` (and ``--fused pool_impl=offsets``), ``--list``
  names it, and without CUDA and without ``--device cpu`` it raises.
"""

import os
import pickle

import numpy
import pytest
import torch

from test_torch_mnist import (  # noqa: F401 (fixtures)
    _one_torch_thread, _recorded, _restored, _seed, f64)
from test_torch_units import prng_streams_restored  # noqa: F401
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.backends import JaxDevice
from znicz_tpu.core.workflow import Workflow as JaxWorkflow
from znicz_tpu.loader import loader_cifar as jax_loader_cifar
from znicz_tpu.samples import cifar as jax_cifar
from znicz_tpu_torch import __main__ as cli
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.snapshotter import SnapshotterToFile
from znicz_tpu_torch.core.workflow import Workflow
from znicz_tpu_torch.loader import loader_cifar
from znicz_tpu_torch.loader.base import TRAIN, VALID
from znicz_tpu_torch.samples import cifar
from znicz_tpu_torch.units import nn_units

RTOL = 1e-12
LOADER = {"synthetic_train": 200, "synthetic_valid": 80,
          "minibatch_size": 40}
EPOCHS = 2


def _schedule(first):
    """An ``arbitrary_step`` schedule at 1x for ``first`` TRAIN
    minibatches, then 0.1x."""
    steps = [(1, first), (0.1, 100000)]
    return {"do": True, "lr_policy_name": "arbitrary_step",
            "bias_lr_policy_name": "arbitrary_step",
            "lr_parameters": {"lrs_with_lengths": steps},
            "bias_lr_parameters": {"lrs_with_lengths": steps}}


def _bits_equal(a, b):
    a, b = numpy.ascontiguousarray(a), numpy.ascontiguousarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        numpy.array_equal(a.view(numpy.uint8), b.view(numpy.uint8))


def _loaders(**kwargs):
    j = jax_loader_cifar.CifarLoader(JaxWorkflow(None), **kwargs)
    t = loader_cifar.CifarLoader(Workflow(None), **kwargs)
    return j, t


def test_loader_synthetic_rows_and_internal_mean_equal_jax():
    j, t = _loaders(synthetic=True, minibatch_size=50,
                    normalization_type="internal_mean")
    j.load_data()
    t.load_data()
    assert (t.synthetic_train, t.synthetic_valid) == (1000, 250)
    assert t.class_lengths == j.class_lengths == [0, 250, 1000]
    assert t.original_data.shape == (1250, 32, 32, 3)
    assert _bits_equal(t.original_data.mem, j.original_data.mem)
    assert t.original_labels == list(j.original_labels)
    assert sorted(set(t.original_labels)) == list(range(10))
    # initialize fits internal_mean on the TRAIN rows and applies it
    for loader, dev in ((j, JaxDevice()), (t, "cpu")):
        loader.initialize(device=dev)
    assert _bits_equal(t.original_data.mem, j.original_data.mem)
    assert _bits_equal(t.normalizer.state["mean"],
                       j.normalizer.state["mean"])
    assert abs(float(t.original_data.mem[250:].mean())) < 1e-3
    assert t.unique_labels_count == 10


def _write_pickles(path, rng):
    """Three-row pickles in the ``cifar-10-batches-py`` layout."""
    os.makedirs(path)
    for name in ["data_batch_%d" % i for i in range(1, 6)] + ["test_batch"]:
        with open(os.path.join(path, name), "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (3, 3072)).astype(
                numpy.uint8), b"labels": list(rng.randint(0, 10, 3))}, f)


def test_loader_reads_the_pickles_as_jax(tmp_path, monkeypatch):
    path = str(tmp_path / "cifar-10-batches-py")
    _write_pickles(path, numpy.random.RandomState(5))
    with open(os.path.join(path, "data_batch_2"), "rb") as f:
        raw = pickle.load(f, encoding="bytes")
    data, labels = loader_cifar.CifarLoader._read_batch(
        os.path.join(path, "data_batch_2"))
    assert data.dtype == numpy.float32 and data.shape == (3, 32, 32, 3)
    # CHW bytes: channel 1 of row 2 at pixel (4, 7)
    assert data[2, 4, 7, 1] == raw[b"data"][2, 1024 + 4 * 32 + 7]
    assert labels.tolist() == list(raw[b"labels"])
    # the real path lays the files out [VALID 10,000 | TRAIN 50,000]:
    # each file's three rows padded to its 10,000-row block
    for mod in (loader_cifar, jax_loader_cifar):
        real = mod.CifarLoader._read_batch

        def padded(fname, real=real):
            d, lbl = real(fname)
            block = numpy.zeros((10000,) + d.shape[1:], d.dtype)
            block[:3] = d
            return block, numpy.pad(lbl, (0, 9997))
        monkeypatch.setattr(mod.CifarLoader, "_read_batch",
                            staticmethod(padded))
    j, t = _loaders(data_path=path)
    j.load_data()
    t.load_data()
    assert t.class_lengths == j.class_lengths == [0, 10000, 50000]
    assert _bits_equal(t.original_data.mem, j.original_data.mem)
    assert t.original_labels == list(j.original_labels)
    first = loader_cifar.CifarLoader._read_batch(
        os.path.join(path, "data_batch_1"))
    test = loader_cifar.CifarLoader._read_batch(
        os.path.join(path, "test_batch"))
    assert _bits_equal(t.original_data.mem[10000:10003], first[0][:3])
    assert _bits_equal(t.original_data.mem[:3], test[0][:3])
    assert _bits_equal(t.original_data.mem[20000:20003], data)
    missing = loader_cifar.CifarLoader(
        Workflow(None), data_path=str(tmp_path / "none"), synthetic=False)
    with pytest.raises(OSError, match="cifar-10-batches-py"):
        missing.load_data()


def _train(module, snapdir, device, schedule=None, epochs=EPOCHS,
           state=None, fused=None, layers=None):
    kwargs = {} if fused is None else {"fused": fused}
    if schedule is not None:
        kwargs["lr_adjuster_config"] = schedule
    wf = module.build(
        layers=layers, loader_config=dict(LOADER),
        decision_config={"max_epochs": epochs, "fail_iterations": 100},
        snapshotter_config={"directory": str(snapdir)}, **kwargs)
    hist = _recorded(wf)
    rates = _rate_log(wf)
    wf.initialize(device=device)
    if state is not None:
        nn_units.load_snapshot_into_workflow(state, wf)
    wf.run()
    return wf, hist, rates


def _rate_log(wf):
    """The (weights, bias) rates of the first GD unit (or proxy) after
    every tick of the adjuster that a TRAIN minibatch let through."""
    log, adj = [], wf.lr_adjuster
    gd = adj._gd_units[0]
    real = adj.run

    def run():
        count = adj._minibatches_count
        real()
        if adj._minibatches_count != count:   # not gated off
            log.append((gd.learning_rate, gd.learning_rate_bias))
    adj.run = run
    if wf.fused_trainer is not None:
        wf.fused_trainer.hyper_tick = run
    return log


def _params(wf):
    """``[(w, b)]`` of the layers with weights, host copies."""
    if wf.fused_trainer is not None:
        return [(numpy.array(p["w"]), numpy.array(p["b"]))
                for p in wf.fused_trainer.net.host_params() if p]
    return [(numpy.array(f.weights.mem), numpy.array(f.bias.mem))
            for f in wf.forwards if f.weights]


def _assert_close(got, want, rtol=RTOL):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype == numpy.float64
            assert numpy.abs(a - b).max() <= rtol * numpy.abs(b).max()


def _same_history(got, want):
    assert [h[:2] for h in got] == [h[:2] for h in want]
    for g, w in zip(got, want):
        assert (g[2] == w[2]).all()


def test_caffe_unit_graph_matches_jax(f64, tmp_path):
    _seed(jax_prng, prng)
    jwf, jhist, _ = _train(jax_cifar, tmp_path / "jax", JaxDevice())
    twf, thist, trates = _train(cifar, tmp_path / "torch", "cpu")
    assert [h[0] for h in thist] == [TRAIN, VALID] * EPOCHS
    _same_history(thist, jhist)
    assert twf.decision.best_n_err_pt == jwf.decision.best_n_err_pt
    _assert_close(_params(twf), _params(jwf))
    assert twf.lr_adjuster in twf.gds[-1].links_from
    assert twf.snapshotter not in twf.gds[-1].links_from
    assert twf.lr_adjuster._minibatches_count == \
        jwf.lr_adjuster._minibatches_count == 10
    assert [(g.learning_rate, g.learning_rate_bias) for g in twf.gds] == \
        [(g.learning_rate, g.learning_rate_bias) for g in jwf.gds]
    # the published schedule: 1x for the first 60,000 minibatches
    assert trates == [(0.001, 0.002)] * 10
    assert [tuple(f.output.shape) for f in twf.forwards] == [
        (40, 32, 32, 32), (40, 16, 16, 32), (40, 16, 16, 32),
        (40, 16, 16, 32), (40, 16, 16, 32), (40, 16, 16, 32),
        (40, 8, 8, 32), (40, 8, 8, 32), (40, 8, 8, 64), (40, 8, 8, 64),
        (40, 4, 4, 64), (40, 10)]
    assert twf.loader.normalization_type == "internal_mean"


def test_fused_matches_unit_graph_with_a_boundary_inside_a_window(
        f64, tmp_path):
    schedule = _schedule(3)
    _seed(prng)
    uwf, uhist, urates = _train(cifar, tmp_path / "u", "cpu", schedule)
    _seed(prng)
    fwf, fhist, frates = _train(cifar, tmp_path / "f", "cpu", schedule,
                                fused={"pool_impl": "offsets"})
    assert fwf.fused_trainer.window == 8
    assert fwf.fused_trainer.hyper_tick is not None
    assert fwf.lr_adjuster in fwf.fused_trainer.links_from
    assert fwf.loader not in fwf.fused_trainer.links_from
    # 5 TRAIN minibatches an epoch: the 10x drop after the third
    want = [(0.001, 0.002)] * 3 + [(0.0001, 0.0002)] * 7
    assert [tuple(numpy.round(r, 12)) for r in urates] == want
    assert frates == urates
    _same_history(fhist, uhist)
    _assert_close(_params(fwf), _params(uwf))
    gds = {g.name: g for g in uwf.gds}
    proxies = fwf.fused_trainer.gd_proxies
    assert [p.name for p in proxies] == ["gd_conv1", "gd_conv2", "gd_conv3",
                                         "gd_fc_softmax4"]
    assert [(p.learning_rate, p.learning_rate_bias) for p in proxies] == [
        (gds[p.name].learning_rate, gds[p.name].learning_rate_bias)
        for p in proxies]
    # the JAX package's fused graph on the same schedule
    _seed(jax_prng)
    jwf, jhist, _ = _train(jax_cifar, tmp_path / "j", JaxDevice(),
                           schedule, fused={"pool_impl": "gather"})
    _same_history(fhist, jhist)
    _assert_close(_params(fwf), _params(jwf))


def test_fused_window_stacks_the_hypers_step_by_step(f64, tmp_path):
    """The window's per-step hypers hold policy(k) at step k; windows in
    which no rate changed reuse one stack."""
    _seed(prng)
    wf = cifar.build(loader_config=dict(LOADER),
                     decision_config={"max_epochs": EPOCHS},
                     snapshotter_config={"directory": str(tmp_path)},
                     lr_adjuster_config=_schedule(3),
                     fused={"pool_impl": "offsets"})
    seen = []
    real = wf.fused_trainer._stacked_hypers

    def stacked(hyper_steps):
        out = real(hyper_steps)
        seen.append(out)
        return out
    wf.fused_trainer._stacked_hypers = stacked
    wf.initialize(device="cpu")
    wf.run()
    assert len(seen) == EPOCHS
    assert seen[0][0]["w"]["lr"].tolist() == [0.001] * 3 + [0.0001] * 2
    assert seen[0][0]["b"]["lr"].tolist() == [0.002] * 3 + [0.0002] * 2
    assert seen[1][0]["w"]["lr"].tolist() == [0.0001] * 5
    assert seen[0][0]["w"]["lr"].dtype == numpy.float64
    # epoch 2's window: one tree every step, cached
    assert wf.fused_trainer._hyper_stacked[5] is seen[1]


@pytest.mark.parametrize("fused", [None, {"pool_impl": "offsets"}],
                         ids=["units", "fused"])
def test_resume_mid_schedule_is_exact(f64, tmp_path, fused):
    schedule = _schedule(7)   # the boundary at epoch 2's third minibatch
    _seed(prng)
    wf = cifar.build(loader_config=dict(LOADER),
                     decision_config={"max_epochs": EPOCHS},
                     snapshotter_config={"directory": str(tmp_path)},
                     lr_adjuster_config=schedule, fused=fused)
    wf.snapshotter.skip = None   # a snapshot after every epoch
    written = {}
    export = wf.snapshotter.export

    def recorded_export():
        epoch = wf.loader.epoch_number
        wf.snapshotter.prefix = "cifar_epoch%d" % epoch
        written[epoch] = export()
        return written[epoch]
    wf.snapshotter.export = recorded_export
    wf.initialize(device="cpu")
    wf.run()
    state = SnapshotterToFile.import_(written[1])
    assert state["units"]["lr_adjuster"] == {"_minibatches_count": 5}
    _seed(prng)
    resumed, hist, rates = _train(cifar, tmp_path / "resumed", "cpu",
                                  schedule, state=state, fused=fused)
    assert [h[0] for h in hist] == [TRAIN, VALID] * (EPOCHS - 1)
    assert [tuple(numpy.round(r, 12)) for r in rates] == \
        [(0.001, 0.002)] * 2 + [(0.0001, 0.0002)] * 3
    assert resumed.decision.epoch_n_err == wf.decision.epoch_n_err
    assert resumed.lr_adjuster._minibatches_count == \
        wf.lr_adjuster._minibatches_count == 10
    for (rw, rb), (ww, wb) in zip(_params(resumed), _params(wf)):
        assert _bits_equal(rw, ww) and _bits_equal(rb, wb)
    units = resumed.fused_trainer.gd_proxies if fused else resumed.gds
    want = wf.fused_trainer.gd_proxies if fused else wf.gds
    assert [(g.learning_rate, g.learning_rate_bias) for g in units] == \
        [(g.learning_rate, g.learning_rate_bias) for g in want]


def test_mlp_variant_trains():
    wf = cifar.build_variant(
        "mlp",
        loader_config={"synthetic_train": 60, "synthetic_valid": 30,
                       "minibatch_size": 30},
        decision_config={"max_epochs": 3, "fail_iterations": 10})
    assert getattr(wf, "lr_adjuster", None) is None
    assert wf.snapshotter.prefix == "cifar_mlp"
    wf.initialize(device="cpu")
    wf.run()
    types = [type(f).__name__ for f in wf.forwards]
    assert types.count("ForwardSinCos") == 2
    assert wf.decision.epoch_number >= 3


def test_nin_variant_trains():
    wf = cifar.build_variant(
        "nin",
        loader_config={"synthetic_train": 30, "synthetic_valid": 10,
                       "minibatch_size": 10},
        decision_config={"max_epochs": 1, "fail_iterations": 5})
    wf.initialize(device="cpu")
    convs = [f for f in wf.forwards if type(f).__name__ == "Conv"]
    assert len(convs) == 9
    assert sum(1 for c in convs if c.kx == 1) == 6
    assert tuple(wf.forwards[6].output.shape) == (10, 16, 16, 96)
    wf.run()
    assert wf.decision.epoch_number >= 1


def test_a_label_past_the_head_counts_as_jax_counts_it():
    """The head's width is the count of distinct labels, which a label
    can exceed (the nin run above: 9 distinct labels, one of them 9):
    the softmax-CE gradient, n_err, confusion and max error sum equal
    ``znicz_tpu``'s, whose one-hot row of such a label is zero."""
    from znicz_tpu.ops.evaluator import softmax_ce_jax
    from znicz_tpu_torch.ops.evaluator import softmax_ce
    rng = numpy.random.RandomState(11)
    out = rng.dirichlet(numpy.ones(9), 6)
    idx = out.argmax(1).astype(numpy.int32)
    labels = numpy.array([0, 9, 3, 9, -1, 8], numpy.int32)
    got = softmax_ce(torch.from_numpy(out), torch.from_numpy(idx),
                     torch.from_numpy(labels), 5, 9)
    want = softmax_ce_jax(out, idx, labels, 5, 9)
    for g, w in zip(got, want):
        w = numpy.asarray(w)
        assert numpy.array_equal(g.numpy().astype(w.dtype), w)
    assert got[1].tolist()[1] == 4


def _cli_args(tmp_path, *extra):
    return ["cifar", "--config", "cifar.decision.max_epochs=1",
            "--config", "cifar.loader.synthetic_train=40",
            "--config", "cifar.loader.synthetic_valid=20",
            "--config", "cifar.loader.minibatch_size=20",
            "--config", "cifar.snapshotter.directory=%s" % tmp_path
            ] + list(extra)


def _cifar_config():
    return _restored(root.cifar, root.cifar.loader, root.cifar.decision,
                     root.cifar.snapshotter)


@pytest.mark.parametrize("extra", [(), ("--fused", "pool_impl=offsets")],
                         ids=["units", "fused"])
def test_cli_trains_cifar_on_cpu(tmp_path, capsys, extra):
    with _cifar_config():
        assert cli.main(_cli_args(tmp_path, "--device", "cpu",
                                  *extra)) == 0
        assert cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert "best val/train err%: [None, " in out
    assert "cifar" in out.split()
    assert any(f.startswith("cifar_caffe_") for f in os.listdir(tmp_path))


def test_cli_needs_cuda_unless_cpu_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with _cifar_config():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(_cli_args(tmp_path, "--dry-run"))
        assert cli.main(_cli_args(tmp_path, "--dry-run", "--device",
                                  "cpu")) == 0
