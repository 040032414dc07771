"""``FusedNet(compute_dtype=...)``: bfloat16 products over float32
master weights, against the JAX package's ``FusedNet(compute_dtype=
jnp.bfloat16)``, on the CPU.

The net is AlexNet's layer kinds at narrow widths on a 35x35x3 input
(conv, a 3x3/s2 max pool on "offsets", LRN, a second conv and pool,
FC, softmax), batch 8, 4 steps, both packages from one weight draw:

* the losses agree within ``LOSS_RTOL`` (1e-3; the runs read 2e-4),
  which a control that takes the loss in bfloat16 exceeds (it reads up
  to 5e-3); the master parameters agree within ``PARAM_RTOL`` (4e-3 of
  each tensor's largest magnitude; the runs read 2.4e-3), which a
  control that keeps the master parameters in bfloat16 exceeds (it
  reads 8e-3); the error counts are equal.  The two packages round
  their bfloat16 convolutions and their gradients differently, so no
  tighter reading is to be had;
* the dtypes: master parameters and optimizer state float32, the
  accumulators and ``predict`` float32, the device dataset bfloat16,
  the MSE targets float32 (also under float64 masters);
* a window of K steps equals K windows of one step bit for bit, and a
  window over the bfloat16 dataset equals one over the same rows
  stacked in float32 on the host (the cast commutes with the gather);
* the backward kernel's plain version in bfloat16 is bit-equal to
  ``_maxpool_bwd_dense`` in bfloat16 where windows overlap (each add
  rounded, dy then dx ascending); where they do not, JAX's one-hot
  product leaves -0.0 where the plain version leaves +0.0, equal as
  values;
* the workflow CLI's ``--fused compute_dtype=bfloat16,pool_impl=offsets``
  trains the narrow AlexNet through the fused trainer.
"""

import numpy
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from test_torch_fused import _conv, _fc
from test_torch_units import prng_streams_restored  # noqa: F401
from test_torch_workflow import LOADER, _restored
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.ops import pooling as jax_pooling
from znicz_tpu.parallel import fused as jax_fused
from znicz_tpu_torch import __main__ as cli
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.ops import pooling
from znicz_tpu_torch.parallel import fused
from znicz_tpu_torch.samples import alexnet  # noqa: F401 (root.alexnet)

LOSS_RTOL = 1e-3
PARAM_RTOL = 4e-3
SHAPE = (35, 35, 3)
STEPS = 4


def layers():
    pool = {"type": "max_pooling", "->": {"kx": 3, "ky": 3,
                                         "sliding": (2, 2)}}
    lrn = {"type": "norm", "n": 5, "alpha": 0.0001, "beta": 0.75}
    return [_conv("conv_str", 8, 5, 0, 2, 0.1), pool, lrn,
            _conv("conv_tanh", 12, 3, 1, 1, 0.1), pool,
            _fc("all2all", 16, 1), {"type": "activation_str"},
            _fc("softmax", 5, 0)]


def _port(**kwargs):
    kwargs.setdefault("compute_dtype", "bfloat16")
    return fused.FusedNet(layers(), SHAPE, rand=prng.RandomGenerator().seed(5),
                          pool_impl="offsets", device="cpu", **kwargs)


def _batches():
    r = numpy.random.RandomState(3)
    return [(r.uniform(-1, 1, (8,) + SHAPE).astype(numpy.float32),
             r.randint(0, 5, 8).astype(numpy.int32)) for _ in range(STEPS)]


def _rel(got, want):
    got = numpy.asarray(got, numpy.float64)
    want = numpy.asarray(want, numpy.float64)
    return numpy.abs(got - want).max() / numpy.abs(want).max()


def _loss_in_bf16(params, x, labels, specs, generator=None,
                  compute_dtype=None):
    """The control: ``fused._loss_and_stats`` with the softmax and the
    loss left in the compute dtype."""
    y = fused.forward(params, x, specs, return_logits=True,
                      generator=generator, train=True,
                      compute_dtype=compute_dtype)
    logp = F.log_softmax(y, dim=1)
    ce = -torch.gather(logp, 1, labels[:, None].long())[:, 0]
    max_idx = torch.argmax(y, dim=1).to(torch.int32)
    return (ce.sum() / labels.shape[0]).float(), (
        (max_idx != labels).sum(), torch.exp(logp.detach().float()),
        max_idx)


def _jax_run():
    net = jax_fused.FusedNet(layers(), SHAPE,
                             rand=jax_prng.RandomGenerator().seed(5),
                             pool_impl="offsets",
                             compute_dtype=jnp.bfloat16)
    metrics = [net.step(x, lbl) for x, lbl in _batches()]
    return metrics, net.state_dict()


def _params_rel(net, want):
    got = net.state_dict()["params"]
    return max(_rel(got[i][k], want[i][k])
               for i in range(len(want)) for k in want[i])


def test_bf16_steps_match_jax_within_tolerance(monkeypatch):
    jm, jsd = _jax_run()
    net = _port()
    masters_bf16 = _port()
    for (x, lbl), mj in zip(_batches(), jm):
        m = net.step(x, lbl)
        masters_bf16.step(x, lbl)
        with torch.no_grad():
            masters_bf16.params = [
                {k: v.to(torch.bfloat16).float() for k, v in p.items()}
                for p in masters_bf16.params]
        assert m["loss"].dtype == torch.float32
        assert _rel(m["loss"].numpy(), mj["loss"]) <= LOSS_RTOL
        assert int(m["n_err"]) == int(mj["n_err"])
    assert _params_rel(net, jsd["params"]) <= PARAM_RTOL
    assert _params_rel(masters_bf16, jsd["params"]) > PARAM_RTOL
    monkeypatch.setattr(fused, "_loss_and_stats", _loss_in_bf16)
    loss_bf16 = _port()
    worst = max(_rel(loss_bf16.step(x, lbl)["loss"].numpy(), mj["loss"])
                for (x, lbl), mj in zip(_batches(), jm))
    assert worst > LOSS_RTOL


@pytest.mark.parametrize("dtype", [numpy.float32, numpy.float64])
def test_bf16_dtypes(dtype):
    net = _port(dtype=dtype)
    want = fused._TORCH_DTYPES[numpy.dtype(dtype)]
    x, lbl = _batches()[0]
    net.set_dataset(numpy.concatenate([x, x]), numpy.concatenate([lbl, lbl]))
    assert net._data_d.dtype == torch.bfloat16
    assert net._labels_d.dtype == torch.int32
    win = net.run_window_indexed(numpy.arange(16).reshape(2, 8), [8, 8],
                                 fused.stack_hypers(net.hypers, 2))
    for p, st in zip(net.params, net.state):
        for k in p:
            assert p[k].dtype == want
            assert all(t.dtype == want for t in st[k].values())
    assert win["max_err_sum"].dtype == win["loss"].dtype == torch.float32
    assert net.window_acc["max_err_sum"].dtype == torch.float32
    assert net.window_acc_zeros()["max_err_sum"].dtype == numpy.float32
    assert net.predict(x).dtype == torch.float32
    probs, idx = net.predict_with_idx(x)
    assert probs.dtype == torch.float32 and idx.dtype == torch.int32
    net.set_window_acc(net.window_acc_host())
    assert net.window_acc["max_err_sum"].dtype == torch.float32
    mse_layers = layers()
    mse_layers[-1]["type"] = "all2all"
    mse = fused.FusedNet(mse_layers, SHAPE, objective="mse",
                         compute_dtype="bfloat16", dtype=dtype, device="cpu")
    mse.set_dataset(x, lbl, numpy.ones((8, 5), dtype))
    assert mse._data_d.dtype == torch.bfloat16
    assert mse._targets_d.dtype == torch.float32
    out = mse.run_window_mse_indexed(numpy.arange(8)[None], [8],
                                     fused.stack_hypers(mse.hypers, 1))
    assert out["metrics"].dtype == out["output"].dtype == torch.float32
    assert mse.predict(x).dtype == torch.float32


@pytest.mark.parametrize("name", ["bfloat16", numpy.float16,
                                  torch.bfloat16, "float32", None])
def test_compute_dtype_names(name):
    want = {"bfloat16": torch.bfloat16, numpy.float16: torch.float16,
            torch.bfloat16: torch.bfloat16, "float32": torch.float32,
            None: None}[name]
    assert fused.compute_dtype_of(name) is want
    for bad in ("bf16", "int8", numpy.int32, torch.int32, 3):
        with pytest.raises(TypeError):
            fused.compute_dtype_of(bad)


def _bits(tree):
    return [numpy.asarray(t.detach().float().numpy() if isinstance(
        t, torch.Tensor) else t).tobytes() for t in tree]


def _flat(net):
    return _bits([t for p in net.params for t in p.values()] +
                 [t for s in net.state for d in s.values()
                  for t in d.values()])


def test_bf16_windows_equal_window_1_steps():
    r = numpy.random.RandomState(4)
    data = r.uniform(-1, 1, (24,) + SHAPE).astype(numpy.float32)
    labels = r.randint(0, 5, 24).astype(numpy.int32)
    idx = r.permutation(24).reshape(3, 8)
    whole, ones, stacked = _port(), _port(), _port()
    for net in (whole, ones):
        net.set_dataset(data, labels)
    w = whole.run_window_indexed(idx, [8, 8, 8],
                                 fused.stack_hypers(whole.hypers, 3))
    losses = [ones.run_window_indexed(idx[k:k + 1], [8],
                                      fused.stack_hypers(ones.hypers, 1))
              ["loss"] for k in range(3)]
    s = stacked.run_window(data[idx], labels[idx], [8, 8, 8],
                           fused.stack_hypers(stacked.hypers, 3))
    assert _bits([w["loss"]]) == _bits([torch.cat(losses)]) == \
        _bits([s["loss"]])
    assert _flat(whole) == _flat(ones) == _flat(stacked)
    for key in ("n_err", "confusion", "max_err_sum"):
        assert _bits([whole.window_acc[key]]) == \
            _bits([ones.window_acc[key]]) == _bits([stacked.window_acc[key]])


@pytest.mark.parametrize("geometry", [
    (2, 13, 13, 8, 3, 3, (2, 2)), (3, 9, 10, 4, 3, 2, (1, 2)),
    (2, 14, 14, 16, 3, 3, (1, 1)), (2, 12, 11, 5, 2, 2, (2, 2))])
def test_backward_plain_bf16_bit_equal_jax(geometry):
    b, h, w, c, ky, kx, sliding = geometry
    r = numpy.random.RandomState(0)
    x = torch.from_numpy(r.uniform(-1, 1, (b, h, w, c)).astype(
        numpy.float32)).to(torch.bfloat16)
    _, offsets = pooling.max_pooling_plain(x, ky, kx, sliding)
    err = torch.from_numpy(r.uniform(-3, 3, tuple(offsets.shape)).astype(
        numpy.float32)).to(torch.bfloat16)
    got = pooling.max_pooling_backward_plain(err, offsets, (b, h, w, c),
                                             ky, kx, sliding)
    want = jax_pooling._maxpool_bwd_dense(
        jnp.asarray(err.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(offsets.numpy()), (b, h, w, c), ky, kx, sliding)
    assert got.dtype == torch.bfloat16
    values = numpy.asarray(want.astype(jnp.float32))
    assert (got.float().numpy() == values).all()
    if tuple(sliding) != (kx, ky):
        assert (got.view(torch.int16).numpy() ==
                numpy.asarray(want).view(numpy.int16)).all()


def test_cli_trains_fused_bf16(tmp_path, prng_streams_restored):  # noqa: F811
    """``--fused compute_dtype=bfloat16,pool_impl=offsets`` through the
    workflow CLI, on a narrow AlexNet: float32 masters, a bfloat16
    dataset on the device, every window's loss finite."""
    wf_file = tmp_path / "wf.py"
    wf_file.write_text(
        "from test_torch_fused import narrow_alexnet\n"
        "from znicz_tpu_torch.samples import alexnet\n\n\n"
        "def run(load, main):\n"
        "    load(alexnet.build, layers=narrow_alexnet())\n"
        "    main()\n")
    argv = [str(wf_file), "--device", "cpu", "--fused",
            "compute_dtype=bfloat16,pool_impl=offsets"]
    for key, value in LOADER.items():
        argv += ["--config", "alexnet.loader.%s=%r" % (key, value)]
    argv += ["--config", "alexnet.decision.max_epochs=2",
             "--config", "alexnet.snapshotter.directory=%s" % tmp_path]
    with _restored(root.alexnet):
        wf = cli.run_workflow_cli(argv)
    net = wf.fused_trainer.net
    assert net.compute_dtype == torch.bfloat16
    assert net._data_d.dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for p in net.params
               for t in p.values())
    assert wf.decision.epoch_number == 2
    assert wf.fused_trainer.output.mem.dtype == numpy.float32
