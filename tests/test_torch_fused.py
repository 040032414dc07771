"""The port's fused trainer (znicz_tpu_torch.parallel.fused) against the
JAX package's (znicz_tpu.parallel.fused), on the CPU.

* ``build_specs`` gives the JAX package's specs for AlexNet and the
  MNIST conv flagship; ``init_params`` draws the same bits.
* ``forward`` on a narrow AlexNet-shaped net (67x67x3 input, narrow
  channels, grouping, LRN, three overlapping 3x3/s2 pools) in float64,
  rtol 1e-10, under the three max-pool lowerings.
* The whole trainer: JAX ``FusedNet`` against the port's in float64,
  weights carried across by ``params.train_state_from_numpy``, on the
  narrow MNIST-conv and AlexNet-shaped nets, under "offsets" and
  "gather": 4 steps, then 2 sliced windows after ``set_epoch_perm``.
  Losses, parameters, optimizer state and the accumulators' float agree
  within rtol 1e-9, counts exactly.  Only summation order differs, in
  the products and convolutions: the runs read about 4e-16.
* Dropout (statistics: the two packages draw different numbers),
  exact resume through ``state_dict``, and the device rule.
"""

import copy

import jax
import numpy
import pytest
import torch

from znicz_tpu.core import prng as jax_prng
from znicz_tpu.parallel import fused as jax_fused
from znicz_tpu.samples import mnist as jax_mnist
from znicz_tpu.samples.research import alexnet as jax_alexnet
from znicz_tpu_torch import params as port_params
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.ops import evaluator
from znicz_tpu_torch.parallel import fused
from znicz_tpu_torch.samples import alexnet

RTOL = 1e-9

_BWD = {"learning_rate": 0.01, "learning_rate_bias": 0.02,
        "weights_decay": 0.0005, "weights_decay_bias": 0,
        "gradient_moment": 0.9, "gradient_moment_bias": 0.9}


def _conv(tpe, k, ksize, pad, stride, bias, bwd=_BWD):
    return {"type": tpe, "->": {
        "n_kernels": k, "kx": ksize, "ky": ksize, "padding": (pad,) * 4,
        "sliding": (stride, stride), "weights_filling": "gaussian",
        "weights_stddev": 0.1, "bias_filling": "constant",
        "bias_stddev": bias}, "<-": bwd}


def _fc(tpe, n, bias):
    return {"type": tpe, "->": {
        "output_sample_shape": n, "weights_filling": "gaussian",
        "weights_stddev": 0.05, "bias_filling": "constant",
        "bias_stddev": bias}, "<-": _BWD}


def narrow_alexnet(dropout=False):
    """AlexNet's layer kinds at narrow widths on a 67x67x3 input: the
    three overlapping 3x3/s2 pools (after strict relu, after tanh
    applied past the pool, and after an LRN'd conv), two LRNs, grouping
    masks on convs and on an FC, ortho on the first conv."""
    pool = {"type": "max_pooling", "->": {"kx": 3, "ky": 3,
                                         "sliding": (2, 2)}}
    lrn = {"type": "norm", "n": 5, "alpha": 0.0001, "beta": 0.75}
    group = {"type": "zero_filter", "grouping": 2}
    layers = [
        _conv("conv_str", 8, 5, 0, 2, 0.1,
              dict(_BWD, factor_ortho=0.001)), pool, lrn, group,
        _conv("conv_str", 12, 3, 1, 1, 1), pool, lrn, group,
        _conv("conv_tanh", 8, 3, 1, 1, 0.1), pool, group,
        _fc("all2all", 16, 1), {"type": "activation_str"}]
    if dropout:
        layers.append({"type": "dropout", "dropout_ratio": 0.5})
    return layers + [_fc("softmax", 5, 0)]


def narrow_mnist_conv():
    """The MNIST conv flagship (znicz_tpu/samples/mnist.py:43) with its
    hypers, at 6 / 7 / 20 units instead of 64 / 87 / 791."""
    layers = copy.deepcopy(list(jax_mnist.root.mnistr_conv.layers))
    for layer, n in zip(layers, (6, None, 7, None, 20, None)):
        if n is None:
            continue
        key = "n_kernels" if "n_kernels" in layer["->"] else \
            "output_sample_shape"
        layer["->"][key] = n
    return layers


NETS = {"alexnet": (narrow_alexnet, (67, 67, 3), 5),
        "mnist_conv": (narrow_mnist_conv, (28, 28), 10)}


def _assert_close(got, want, rtol=RTOL):
    numpy.testing.assert_allclose(numpy.asarray(got), numpy.asarray(want),
                                  rtol=rtol, atol=0)


def _assert_tree_close(got, want, rtol=RTOL):
    """Two pytrees of arrays, leaf by leaf: floats to ``rtol`` of the
    tensor's largest magnitude, everything else exactly."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree_close(got[k], want[k], rtol)
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_close(g, w, rtol)
        return
    g, w = numpy.asarray(got), numpy.asarray(want)
    assert g.shape == w.shape
    if numpy.issubdtype(w.dtype, numpy.floating):
        scale = numpy.abs(w).max() if w.size else 0
        assert numpy.abs(g - w).max(initial=0) <= rtol * scale
    else:
        assert (g == w).all()


def _spec_fields(spec):
    d = {k: v for k, v in vars(spec).items()
         if not k.startswith("_") and k not in ("weight_mask",
                                                "prefer_pallas")}
    return spec.kind, d, getattr(spec, "weight_mask", None)


@pytest.mark.parametrize("name", ["alexnet_full", "mnist_conv_full",
                                  "alexnet_narrow"])
def test_build_specs_match_jax(name):
    layers, shape = {
        "alexnet_full": (alexnet.make_layers(), (227, 227, 3)),
        "mnist_conv_full": (list(jax_mnist.root.mnistr_conv.layers),
                            (28, 28)),
        "alexnet_narrow": (narrow_alexnet(True), (67, 67, 3))}[name]
    got = fused.build_specs(layers, shape)
    want = jax_fused.build_specs(layers, shape)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gk, gd, gm = _spec_fields(g)
        wk, wd, wm = _spec_fields(w)
        assert gk == wk and gd == wd
        assert (gm is None) == (wm is None)
        if wm is not None:
            assert (gm == wm).all()
        if g.kind in ("fc", "conv"):
            assert g.init_stddev() == w.init_stddev()
    assert fused.flops_per_image(got) == jax_fused.flops_per_image(want)


def test_alexnet_layers_are_the_jax_sample():
    assert alexnet.make_layers() == jax_alexnet.make_layers()
    assert alexnet.make_layers(10) == jax_alexnet.make_layers(10)


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("dtype", [numpy.float32, numpy.float64])
def test_init_params_bit_equal(net, dtype):
    make, shape, _ = NETS[net]
    specs = fused.build_specs(make(), shape)
    got = fused.init_params(specs, prng.RandomGenerator().seed(11), dtype)
    want = jax_fused.init_params(jax_fused.build_specs(make(), shape),
                                 jax_prng.RandomGenerator().seed(11), dtype)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            assert (g[k].view(numpy.uint8) == w[k].view(numpy.uint8)).all()


def test_prng_draws_and_state_match_jax():
    a = prng.RandomGenerator().seed(numpy.arange(5, dtype=numpy.int32))
    b = jax_prng.RandomGenerator().seed(numpy.arange(5, dtype=numpy.int32))
    for fn in ("rand", "permutation"):
        assert (getattr(a, fn)(7) == getattr(b, fn)(7)).all()
    st = a.get_state()
    x = a.normal(0, 1, 9)
    a.set_state(st)
    assert (a.normal(0, 1, 9) == x).all() and (x == b.normal(0, 1, 9)).all()
    assert prng.get(3) is prng.get(3)


def _jax_specs(layers, shape, impl):
    specs = jax_fused.build_specs(layers, shape)
    for spec in specs:
        if spec.kind == "pool":
            spec.impl = impl
    return specs


@pytest.mark.parametrize("impl", ["offsets", "gather", "reduce_window"])
def test_forward_matches_jax(impl):
    """Float64, rtol 1e-10: logits and the softmax output.  Random
    inputs tie nowhere but in the zeros of a strict relu, where every
    lowering gives the same value."""
    layers, shape = narrow_alexnet(), (67, 67, 3)
    specs = fused.build_specs(layers, shape)
    for spec in specs:
        if spec.kind == "pool":
            spec.impl = impl
    host = fused.init_params(specs, prng.RandomGenerator().seed(2),
                             numpy.float64)
    x = numpy.random.RandomState(9).uniform(-1, 1, (3,) + shape)
    jspecs = _jax_specs(layers, shape, impl)
    params = [{k: torch.from_numpy(v) for k, v in p.items()} for p in host]
    for logits in (True, False):
        got = fused.forward(params, torch.from_numpy(x), specs,
                            return_logits=logits)
        want = jax_fused.forward(host, x, jspecs, return_logits=logits)
        _assert_close(got.numpy(), want, rtol=1e-10)


def _pair(net, impl, dropout_seed=0):
    make, shape, n_classes = NETS[net]
    jnet = jax_fused.FusedNet(make(), shape,
                              rand=jax_prng.RandomGenerator().seed(5),
                              dtype=numpy.float64, pool_impl=impl)
    pnet = fused.FusedNet(make(), shape, rand=prng.RandomGenerator().seed(6),
                          dtype=numpy.float64, pool_impl=impl,
                          dropout_seed=dropout_seed, device="cpu")
    sd = jnet.state_dict()
    pnet.load_state_dict({k: sd[k] for k in ("params", "opt", "hypers")})
    return jnet, pnet, pnet.input_sample_shape, n_classes


@pytest.mark.parametrize("impl", ["offsets", "gather"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_trainer_matches_jax(net, impl):
    jnet, pnet, shape, n_classes = _pair(net, impl)
    r = numpy.random.RandomState(3)
    for i in range(4):
        x = r.uniform(-1, 1, (6,) + shape)
        labels = r.randint(0, n_classes, 6).astype(numpy.int32)
        if i == 2:
            labels[-2:] = -1   # unlabelled rows count nowhere
        mj, mp = jnet.step(x, labels), pnet.step(x, labels)
        _assert_close(mp["loss"].numpy(), mj["loss"])
        assert int(mp["n_err"]) == int(mj["n_err"])
        _assert_close(mp["output"].numpy(), mj["output"])
        assert (mp["max_idx"].numpy() == numpy.asarray(mj["max_idx"])).all()
    n = 20
    data = r.uniform(-1, 1, (n,) + shape)
    labels = r.randint(0, n_classes, n).astype(numpy.int32)
    perm = r.permutation(n)
    for trainer in (jnet, pnet):
        trainer.set_dataset(data, labels)
        trainer.set_epoch_perm(perm, 4)
    hypers_s = jax.tree.map(
        lambda *leaves: numpy.asarray(leaves, numpy.float64),
        *([jnet.hypers] * 3))
    # the second window's last step is a padded tail (no row counts)
    for starts, sizes in (([0, 4, 8], [4, 4, 4]), ([12, 16, 20], [4, 4, 0])):
        sj = jnet.run_window_sliced(starts, 4, sizes, hypers_s)
        sp = pnet.run_window_sliced(starts, 4, sizes, hypers_s)
        _assert_close(sp["loss"].numpy(), sj["loss"])
        for key in ("n_err", "confusion"):
            assert (sp[key].numpy() == numpy.asarray(sj[key])).all()
        _assert_close(sp["max_err_sum"].numpy(), sj["max_err_sum"])
        _assert_tree_close(pnet.window_acc_host(),
                           jnet.host_fetch(sj["acc"]))
    assert int(pnet.window_acc_host()["n_err"][1]) == 20
    want = jnet.state_dict()
    got = pnet.state_dict()
    _assert_tree_close(got["params"], want["params"])
    _assert_tree_close(got["opt"], want["opt"])
    assert got["hypers"] == jax.tree.map(float, want["hypers"])
    _assert_close(pnet.predict(data[:5]).numpy(), jnet.predict(data[:5]))


def test_run_window_indexed_equals_sliced():
    """The two device-data paths give the same window from the same
    rows, bit for bit."""
    make, shape, _ = NETS["mnist_conv"]
    r = numpy.random.RandomState(8)
    data = r.uniform(-1, 1, (12,) + (28, 28))
    labels = r.randint(0, 10, 12).astype(numpy.int32)
    perm = r.permutation(12)
    nets = [fused.FusedNet(make(), shape, device="cpu",
                           rand=prng.RandomGenerator().seed(1),
                           dtype=numpy.float64) for _ in range(2)]
    for net in nets:
        net.set_dataset(data, labels)
    nets[0].set_epoch_perm(perm, 0)
    hypers_s = fused.stack_hypers(nets[0].hypers, 3)
    sliced = nets[0].run_window_sliced([0, 4, 8], 4, [4, 4, 4], hypers_s)
    indexed = nets[1].run_window_indexed(perm.reshape(3, 4), [4, 4, 4],
                                         hypers_s)
    assert torch.equal(indexed["loss"], sliced["loss"])
    assert torch.equal(indexed["confusion"], sliced["confusion"])
    _assert_tree_close(nets[1].host_params(), nets[0].host_params(), 0)


def test_eval_stats_matches_jax():
    """The in-window stats of a minibatch, a full one and one with two
    padded rows, with a row labelled -1: counts equal, max_err_sum
    within 1e-15."""
    r = numpy.random.RandomState(4)
    logits = r.uniform(-2, 2, (9, 6))
    probs = numpy.exp(logits) / numpy.exp(logits).sum(1, keepdims=True)
    max_idx = probs.argmax(1).astype(numpy.int32)
    labels = r.randint(0, 6, 9).astype(numpy.int32)
    labels[3] = -1
    for bs in (9, 7):
        got = evaluator.eval_stats(torch.from_numpy(probs),
                                   torch.from_numpy(max_idx),
                                   torch.from_numpy(labels), bs, 6)
        want = jax_fused._eval_stats(probs, max_idx, labels, bs, 6, True)
        for g, w in ((got[0], want[0]), (got[1], want[1])):
            assert g.dtype == torch.int32
            assert (g.numpy() == numpy.asarray(w)).all()
        _assert_close(got[2].numpy(), want[2], 1e-15)


def _dropout_net(seed):
    return fused.FusedNet(narrow_alexnet(dropout=True), (67, 67, 3),
                          rand=prng.RandomGenerator().seed(1),
                          dtype=numpy.float64, pool_impl="offsets",
                          dropout_seed=seed, device="cpu")


def test_dropout_keep_rate_scale_and_seed():
    """keep = rand >= ratio, scaled by 1/(1 - ratio), from the net's
    generator: the keep rate of 200,000 draws lies within 5 sigma of
    the binomial's, kept values are exactly doubled, the same seed
    draws the same mask, and inference leaves dropout out."""
    spec = fused.DropoutSpec("dropout", (200000,), (200000,), ratio=0.5)
    x = torch.full((1, 200000), 3.0, dtype=torch.float64)

    def mask(seed):
        gen = torch.Generator().manual_seed(seed)
        return fused.forward([{}], x, [spec], generator=gen, train=True)
    y = mask(4)
    kept = (y != 0).double().mean().item()
    assert abs(kept - 0.5) < 5 * (0.25 / 200000) ** 0.5
    assert set(torch.unique(y).tolist()) == {0.0, 6.0}
    assert torch.equal(y, mask(4)) and not torch.equal(y, mask(5))
    assert torch.equal(fused.forward([{}], x, [spec]), x)


def test_state_dict_resumes_bit_identically():
    """Two steps, a state_dict, a fresh net loaded from it: the next
    steps (dropout included) give the same bits as the first net's."""
    r = numpy.random.RandomState(2)
    batches = [(r.uniform(-1, 1, (4, 67, 67, 3)),
                r.randint(0, 5, 4).astype(numpy.int32)) for _ in range(4)]
    a = _dropout_net(7)
    for x, lbl in batches[:2]:
        a.step(x, lbl)
    b = _dropout_net(99)
    b.load_state_dict(a.state_dict())
    for x, lbl in batches[2:]:
        ma, mb = a.step(x, lbl), b.step(x, lbl)
        assert torch.equal(ma["loss"], mb["loss"])
    _assert_tree_close(b.host_params(), a.host_params(), 0)
    _assert_tree_close(b.state_dict()["opt"], a.state_dict()["opt"], 0)
    with pytest.raises(ValueError, match="generator state"):
        b.load_state_dict(dict(a.state_dict(),
                               key=numpy.zeros(2, numpy.uint32)))


def test_train_state_round_trip():
    _, pnet, _, _ = _pair("mnist_conv", "offsets")
    sd = port_params.train_state_to_numpy(pnet.params, pnet.state,
                                          pnet.hypers)
    params, opt, hypers = port_params.train_state_from_numpy(
        sd, "cpu", torch.float32)
    assert params[0]["w"].dtype == torch.float32
    assert hypers == pnet.hypers
    _assert_tree_close(port_params.train_state_to_numpy(params, opt)["opt"],
                       sd["opt"], 1e-7)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_fused_net_needs_cuda_unless_cpu_asked(no_cuda):
    make, shape, _ = NETS["mnist_conv"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fused.FusedNet(make(), shape)
    assert fused.FusedNet(make(), shape, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kwargs,match", [
    ({"mesh": 1}, "mesh"),
    pytest.param({"objective": "mse"}, None, id="kwargs1-mse"),
    ({"compute_dtype": "bfloat16"}, "compute_dtype"),
    ({"pool_impl": "reshape"}, "reshape")])
def test_later_options_raise(kwargs, match):
    """The options once left for later build and step: the MSE
    objective (``match`` None) on the net with a linear head;
    ``compute_dtype`` (bfloat16 products under float32 masters and a
    float32 loss); ``pool_impl="reshape"`` (every pool of the net,
    whose windows do not overlap, on the reshape lowering); and a
    ``mesh``, here of the one rank of a process without a
    ``torch.distributed`` world, whose step is the net's without one,
    bit for bit."""
    make, shape, _ = NETS["mnist_conv"]
    x = numpy.random.RandomState(3).uniform(-1, 1, (2, 28, 28))
    if match == "mesh":
        from znicz_tpu_torch.parallel.mesh import make_mesh
        labels = numpy.array([1, 2], numpy.int32)
        nets = [fused.FusedNet(make(), shape, device="cpu",
                               rand=prng.RandomGenerator().seed(5), **kw)
                for kw in ({"mesh": make_mesh(kwargs["mesh"])}, {})]
        steps = [net.step(x, labels) for net in nets]
        assert float(steps[0]["loss"]) == float(steps[1]["loss"])
        for pa, pb in zip(*[net.host_params() for net in nets]):
            for k in pa:
                numpy.testing.assert_array_equal(pa[k], pb[k])
        assert nets[0].data_shards == 1 and not nets[0].mesh.counts
        return
    if match is None:
        layers = make()
        layers[-1]["type"] = "all2all"
        net = fused.FusedNet(layers, shape, device="cpu", **kwargs)
        m = net.step_mse(x, numpy.zeros((2, 10)))
        assert net.objective == "mse" and numpy.isfinite(float(m["loss"]))
        return
    if match != "mesh":
        net = fused.FusedNet(make(), shape, device="cpu", **kwargs)
        m = net.step(x, numpy.array([1, 2], numpy.int32))
        assert numpy.isfinite(float(m["loss"]))
        assert m["loss"].dtype == m["output"].dtype == torch.float32
        assert all(t.dtype == torch.float32 for p in net.params
                   for t in p.values())
        if match == "compute_dtype":
            assert net.compute_dtype == torch.bfloat16
        else:
            assert {s.impl for s in net.specs if s.kind == "pool"} == \
                {"reshape"}
        return
    with pytest.raises(NotImplementedError, match=match):
        fused.FusedNet(make(), shape, device="cpu", **kwargs)


@pytest.mark.parametrize("tpe", ["stochastic_pooling",
                                 "stochastic_abs_pooling",
                                 "stochastic_pool_depool",
                                 "stochastic_abs_pool_depool"])
def test_later_layers_raise(tpe):
    """The four stochastic pooling types, once left for later (they
    raised, naming ROADMAP.md), now build and train: the JAX package's
    specs, and a step that draws the pool's winners on the net's
    generator, moves the weights and keeps every value finite."""
    layers = [_conv("conv", 2, 3, 0, 1, 0.0),
              {"type": tpe, "->": {"kx": 2, "ky": 2}},
              _fc("softmax", 3, 0)]
    spec = fused.build_specs(layers, (6, 6, 1))[1]
    jspec = jax_fused.build_specs(layers, (6, 6, 1))[1]
    assert (spec.mode, spec.out_shape, spec.sliding) == \
        (jspec.mode, jspec.out_shape, jspec.sliding)
    net = fused.FusedNet(layers, (6, 6, 1), rand=prng.RandomGenerator().seed(
        2), dtype=numpy.float64, device="cpu")
    r = numpy.random.RandomState(1)
    before = net.host_params()
    key = net.state_dict()["key"]
    m = net.step(r.uniform(-1, 1, (4, 6, 6, 1)),
                 numpy.array([0, 1, 2, 1], numpy.int32))
    assert numpy.isfinite(float(m["loss"]))
    assert not numpy.array_equal(net.state_dict()["key"], key)
    after = net.host_params()
    assert numpy.abs(after[0]["w"] - before[0]["w"]).max() > 0
    assert all(numpy.isfinite(v).all() for p in after for v in p.values())


@pytest.mark.parametrize("tpe", ["deconv", "depooling"])
def test_tied_layers_need_tied_to(tpe):
    """A deconv or depooling without ``tied_to``, or tied to a layer of
    the wrong kind, is refused, as the JAX package refuses it."""
    layers = [{"name": "c", "type": "conv",
               "->": {"n_kernels": 2, "kx": 3, "ky": 3}},
              {"name": "p", "type": "avg_pooling", "->": {"kx": 2, "ky": 2}},
              {"type": tpe, "->": {}}]
    with pytest.raises(ValueError, match="tied_to"):
        fused.build_specs(layers, (8, 8, 1))
    layers[2]["->"]["tied_to"] = "p" if tpe == "depooling" else "c"
    with pytest.raises(ValueError, match="tied_to|input"):
        fused.build_specs(layers, (8, 8, 1))


def test_synthetic_images():
    """The sample's prototype-class images: labels cycle through the
    classes, the set spans [-1, 1] exactly, the same seed gives the
    same images, and images of a class are closer to each other than to
    another class."""
    data, labels = alexnet.synthetic_images(12, n_classes=4, size=9)
    assert data.shape == (12, 9, 9, 3) and data.dtype == numpy.float32
    assert (labels == numpy.arange(12) % 4).all()
    assert data.min() == -1.0 and abs(data.max() - 1.0) < 1e-6
    assert (alexnet.synthetic_images(12, n_classes=4, size=9)[0] == data
            ).all()
    same = numpy.abs(data[0] - data[4]).mean()
    other = numpy.abs(data[0] - data[1]).mean()
    assert same < other


# -- the fully-connected forms (build_fc_specs, FusedMLP) --------------------

MLP_LAYERS = [
    {"type": "all2all_tanh", "->": {"output_sample_shape": 8,
                                    "weights_stddev": 0.05,
                                    "bias_stddev": 0.05},
     "<-": {"learning_rate": 0.3, "weights_decay": 0.0}},
    {"type": "softmax", "->": {"output_sample_shape": 4,
                               "weights_stddev": 0.05,
                               "bias_stddev": 0.05},
     "<-": {"learning_rate": 0.3, "weights_decay": 0.0}},
]


def _separable(n=16, f=13, c=4, seed=3):
    """``tests/unit/test_fused.py``'s batch: labels are the argmax of a
    fixed random linear map."""
    r = numpy.random.RandomState(seed)
    x = r.uniform(-1, 1, (n, f))
    labels = numpy.argmax(x @ r.uniform(-1, 1, (f, c)), axis=1)
    return x, labels.astype(numpy.int32)


def test_fused_mlp_matches_jax_float64():
    """``tests/unit/test_fused.py:82-100``: one step of the MLP from
    the same seed, every parameter within 1e-10 of JAX's."""
    x, labels = _separable()
    jt = jax_fused.FusedMLP(MLP_LAYERS, input_sample_size=13,
                            rand=jax_prng.RandomGenerator().seed(1234),
                            dtype=numpy.float64)
    tt = fused.FusedMLP(MLP_LAYERS, input_sample_size=13,
                        rand=prng.RandomGenerator().seed(1234),
                        dtype=numpy.float64, device="cpu")
    jt.step(x, labels)
    tt.step(x, labels)
    for got, want in zip(tt.host_params(), jt.host_params()):
        for key in ("w", "b"):
            assert numpy.abs(numpy.asarray(got[key]) -
                             numpy.asarray(want[key])).max() < 1e-10


def test_build_fc_specs_and_init_match_jax():
    """``tests/unit/test_fused.py:103-122``: the same seed draws the
    same initial weights; a non-FC layer is refused before any draw."""
    layers = [{"type": "all2all_tanh", "->": {"output_sample_shape": 8}}]
    specs = fused.build_fc_specs(layers, 13)
    jspecs = jax_fused.build_fc_specs(layers, 13)
    assert [(s.kind, s.n_in, s.n_out) for s in specs] == \
        [(s.kind, s.n_in, s.n_out) for s in jspecs] == [("fc", 13, 8)]
    got = fused.init_params(specs, prng.RandomGenerator().seed(7),
                            dtype=numpy.float64)
    want = jax_fused.init_params(jspecs, jax_prng.RandomGenerator().seed(7),
                                 dtype=numpy.float64)
    for key in ("w", "b"):
        assert numpy.array_equal(got[0][key], want[0][key])
    mixed = MLP_LAYERS[:1] + [{"type": "activation_tanh"}] + MLP_LAYERS[1:]
    for mod in (fused, jax_fused):
        with pytest.raises(ValueError, match="does not support layer type "
                                             "'activation_tanh'"):
            mod.build_fc_specs(mixed, 13)
    rand = prng.RandomGenerator().seed(7)
    with pytest.raises(ValueError, match="'activation_tanh'"):
        fused.FusedMLP(mixed, 13, rand=rand, device="cpu")
    assert rand.get_state()["np"][2] == \
        prng.RandomGenerator().seed(7).get_state()["np"][2]


def test_fused_mlp_momentum_and_solvers_run():
    """``tests/unit/test_fused.py:139-146``."""
    x, labels = _separable()
    layers = copy.deepcopy(MLP_LAYERS)
    layers[0]["<-"] = {"learning_rate": 0.1, "gradient_moment": 0.9,
                       "solvers": ("adagrad",)}
    trainer = fused.FusedMLP(layers, input_sample_size=13,
                             rand=prng.RandomGenerator().seed(5),
                             device="cpu")
    for _ in range(3):
        m = trainer.step(x, labels)
    assert numpy.isfinite(float(m["loss"]))
