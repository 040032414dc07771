"""The port's autoencoder stage (stochastic pooling, depooling, deconv,
``samples/mnist_ae.py`` and ``FusedNet(objective="mse")`` on the
autoencoder layers) against the JAX package's, on the CPU.

* Ops: stochastic pooling and pool-depool equal ``stochastic_*_jax``
  bit for bit, values and offsets, for the same uint16 stream, in f32
  and f64, max and abs, with zero-sum windows and overhanging windows;
  every winner lies in its window's in-bounds cells.  The depooling
  (``max_pooling_backward_plain`` on stochastic offsets, 3x3/s2, cells
  that won up to four windows) equals ``max_pooling_backward_jax``'s
  scatter-add bit for bit.  ``deconv_forward``, ``deconv_hits`` and
  ``deconv_backward`` agree with JAX within 1e-12 of the largest value
  in f64 and 1e-5 in f32, MNIST's 24 -> 28 geometry included.
* Units: the stochastic poolings and their GD routing, ``Depooling``
  and ``Deconv`` / ``GDDeconv`` against the JAX units in f64.
* The MNIST autoencoder sample at the JAX package's pinned setup
  (120 / 60 synthetic rows, minibatch 30, seeds 1234 / 5678, f32)
  reproduces ``GOLDEN_ZOO2["mnist_ae"]``
  (``tests/functional/test_research_models.py``): the integer columns
  exactly, the MSE within its ``MSE_RTOL``; in f64 its per-epoch
  metrics and final weights are within 1e-12 of ``znicz_tpu``'s, and
  resuming from the epoch-1 snapshot ends bit-equal.
* ``FusedNet(objective="mse")`` on the autoencoder layers of
  ``tests/unit/test_fused_mse_ae.py``: three steps against the JAX unit
  graph and against JAX ``FusedNet`` in f64, its forward against the
  unit forward, a window against per-step steps; the tied pool records
  offsets whatever the ``pool_impl``.
* ``params.unit_params_from_numpy`` / ``unit_params_to_numpy`` carry
  the conv's weights once, the deconv sharing them.
"""

import importlib.util
import os

import numpy
import pytest
import torch

import jax.numpy as jnp
from test_torch_units import prng_streams_restored  # noqa: F401
from test_torch_mnist import _restored
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.accelerated_units import \
    AcceleratedWorkflow as JaxWorkflow
from znicz_tpu.core.backends import JaxDevice
from znicz_tpu.core.config import root as jax_root
from znicz_tpu.core.memory import Array as JaxArray
from znicz_tpu.ops import conv as jax_conv
from znicz_tpu.ops import pooling as jax_pool
from znicz_tpu.parallel import FusedNet as JaxFusedNet
from znicz_tpu.samples.research import mnist_ae as jax_mnist_ae
from znicz_tpu.units import nn_units as jax_nn_units
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.accelerated_units import AcceleratedWorkflow
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.ops import conv as conv_ops
from znicz_tpu_torch.ops import pooling as pool_ops
from znicz_tpu_torch.parallel import fused
from znicz_tpu_torch.params import (unit_params_from_numpy,
                                    unit_params_to_numpy)
from znicz_tpu_torch.samples import mnist_ae
from znicz_tpu_torch.units import nn_units
import znicz_tpu.units  # noqa: F401  (registers the JAX layer types)
import znicz_tpu_torch.standard_workflow_base  # noqa: F401  (the port's)

HERE = os.path.dirname(os.path.abspath(__file__))
RTOL64, RTOL32 = 1e-12, 1e-5


def _reference(relpath, name):
    """A module of the JAX package's tests, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


RESEARCH = _reference("functional/test_research_models.py",
                      "_research_models_reference")
FUSED_AE = _reference("unit/test_fused_mse_ae.py", "_fused_mse_ae_reference")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes,
    and their thread pools would otherwise contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def f64():
    with _restored(root.common.engine, jax_root.common.engine):
        root.common.engine.precision_dtype = numpy.float64
        jax_root.common.engine.precision_dtype = numpy.float64
        jax_root.common.engine.precision_type = "double"
        yield


def _close(got, want, rtol, what=""):
    got, want = numpy.asarray(got), numpy.asarray(want)
    assert got.shape == want.shape, what
    scale = max(numpy.abs(want).max(), 1e-300)
    err = numpy.abs(got.astype(numpy.float64) - want).max() / scale
    assert err <= rtol, "%s: %.3g relative" % (what, err)


def _bits(a):
    a = numpy.ascontiguousarray(a)
    return a.view(numpy.uint8)


# -- ops ----------------------------------------------------------------------

#: (x shape, ky, kx, sliding): the MNIST autoencoder's pool at batch 3,
#: an overhanging 3x2 window at stride (2, 3), disjoint 2x2
STOCHASTIC_GEOMS = [((3, 24, 24, 5), 3, 3, (2, 2)),
                    ((2, 7, 9, 3), 3, 2, (2, 3)),
                    ((2, 8, 8, 2), 2, 2, (2, 2))]


def _stochastic_input(shape, dtype, use_abs, seed):
    """Gaussian values, a zero-sum corner in every image, and one image
    all negative (zero-sum windows for the max keys)."""
    r = numpy.random.RandomState(seed)
    x = r.randn(*shape).astype(dtype)
    x[:, :3, :3, :] = 0
    if not use_abs:
        x[1] = -numpy.abs(x[1])
    return x


def _stream(n, seed):
    return numpy.random.RandomState(seed).randint(
        0, 65536, size=n).astype(numpy.uint16)


@pytest.mark.parametrize("dtype", [numpy.float32, numpy.float64])
@pytest.mark.parametrize("use_abs", [False, True])
@pytest.mark.parametrize("geom", STOCHASTIC_GEOMS,
                         ids=["ae", "overhang", "disjoint"])
def test_stochastic_pooling_matches_jax(dtype, use_abs, geom):
    shape, ky, kx, sliding = geom
    x = _stochastic_input(shape, dtype, use_abs, 3)
    ny, nx = pool_ops.output_spatial(shape[1], shape[2], ky, kx, sliding)
    u16 = _stream(shape[0] * ny * nx * shape[3], 4)
    jv, jo = jax_pool.stochastic_pooling_jax(
        jnp.asarray(x), jnp.asarray(u16), ky, kx, sliding, use_abs=use_abs)
    tv, to = pool_ops.stochastic_pooling(
        torch.from_numpy(x), torch.from_numpy(u16.astype(numpy.int32)), ky,
        kx, sliding, use_abs)
    assert numpy.array_equal(_bits(numpy.asarray(jv)), _bits(tv.numpy()))
    assert to.dtype == torch.int32
    assert numpy.array_equal(numpy.asarray(jo), to.numpy())
    # every winner lies in its window's in-bounds cells
    offs = to.numpy().astype(numpy.int64)
    b, h, w, c = shape
    wy, wx = offs // (w * c) % h, offs // c % w
    oy = numpy.arange(ny).reshape(1, ny, 1, 1) * sliding[1]
    ox = numpy.arange(nx).reshape(1, 1, nx, 1) * sliding[0]
    assert ((wy >= oy) & (wy < oy + ky) & (wy < h)).all()
    assert ((wx >= ox) & (wx < ox + kx) & (wx < w)).all()
    assert (offs // (h * w * c) ==
            numpy.arange(b).reshape(b, 1, 1, 1)).all()
    assert (offs % c == numpy.arange(c)).all()


@pytest.mark.parametrize("dtype", [numpy.float32, numpy.float64])
@pytest.mark.parametrize("use_abs", [False, True])
def test_stochastic_pool_depool_matches_jax(dtype, use_abs):
    shape, ky, kx = (2, 7, 9, 3), 3, 2
    x = _stochastic_input(shape, dtype, use_abs, 5)
    ny, nx = pool_ops.output_spatial(7, 9, ky, kx, (kx, ky))
    u16 = _stream(2 * ny * nx * 3, 6)
    jy, jo = jax_pool.stochastic_pool_depool_jax(
        jnp.asarray(x), jnp.asarray(u16), ky, kx, use_abs=use_abs)
    ty, to = pool_ops.stochastic_pool_depool(
        torch.from_numpy(x), torch.from_numpy(u16.astype(numpy.int32)), ky,
        kx, use_abs)
    assert numpy.array_equal(_bits(numpy.asarray(jy)), _bits(ty.numpy()))
    assert numpy.array_equal(numpy.asarray(jo), to.numpy())


@pytest.mark.parametrize("dtype", [numpy.float32, numpy.float64])
def test_depooling_matches_jax_scatter(dtype):
    """The depooling of the autoencoder (3x3/s2 over stochastic abs
    winners, the pooled values scattered back): the plain backward
    equals the JAX scatter-add bit for bit, though a cell adds the same
    value once for each of up to four windows it won."""
    shape, ky, kx, sliding = (3, 24, 24, 5), 3, 3, (2, 2)
    x = numpy.random.RandomState(7).uniform(-1, 1, shape).astype(dtype)
    u16 = _stream(3 * 12 * 12 * 5, 8)
    values, offs = pool_ops.stochastic_pooling(
        torch.from_numpy(x), torch.from_numpy(u16.astype(numpy.int32)), ky,
        kx, sliding, True)
    wins = numpy.bincount(offs.numpy().ravel())
    assert wins.max() >= 3
    want = jax_pool.max_pooling_backward_jax(
        jnp.asarray(values.numpy()), jnp.asarray(offs.numpy()),
        int(numpy.prod(shape)), shape)
    got = pool_ops.depooling(values, offs, shape, ky, kx, sliding)
    assert numpy.array_equal(_bits(numpy.asarray(want)), _bits(got.numpy()))
    # and at the kernel's own maxabs winners (the fused autoencoder)
    values, offs = pool_ops.max_pooling_plain(torch.from_numpy(x), ky, kx,
                                              sliding, True)
    want = jax_pool.max_pooling_backward_jax(
        jnp.asarray(values.numpy()), jnp.asarray(offs.numpy()),
        int(numpy.prod(shape)), shape)
    got = pool_ops.depooling(values, offs, shape, ky, kx, sliding)
    assert numpy.array_equal(_bits(numpy.asarray(want)), _bits(got.numpy()))


#: (input shape (B, ny, nx, K), ky, kx, padding, sliding, output shape):
#: MNIST's autoencoder with the conv's padding and with the padding
#: ``Deconv.compute_padding`` gives (the canvas zero-extended), and a
#: strided, unevenly padded one
DECONV_GEOMS = [((2, 24, 24, 5), 5, 5, (0, 0, 0, 0), (1, 1), (2, 28, 28, 1)),
                ((2, 24, 24, 5), 5, 5, (4, 4, 4, 4), (1, 1), (2, 28, 28, 1)),
                ((2, 4, 5, 3), 4, 3, (1, 2, 2, 1), (2, 2), (2, 9, 10, 2))]


@pytest.mark.parametrize("dtype,rtol", [(numpy.float64, RTOL64),
                                        (numpy.float32, RTOL32)])
@pytest.mark.parametrize("geom", DECONV_GEOMS,
                         ids=["mnist_ae", "mnist_ae_padded", "strided"])
def test_deconv_ops_match_jax(dtype, rtol, geom):
    in_shape, ky, kx, padding, sliding, out_shape = geom
    r = numpy.random.RandomState(9)
    x = r.uniform(-1, 1, in_shape).astype(dtype)
    w = r.uniform(-1, 1, (in_shape[3], ky * kx * out_shape[3])).astype(dtype)
    err = r.uniform(-1, 1, out_shape).astype(dtype)
    want = jax_conv.deconv_forward_jax(jnp.asarray(x), jnp.asarray(w), ky,
                                       kx, padding, sliding, out_shape)
    got = conv_ops.deconv_forward(torch.from_numpy(x), torch.from_numpy(w),
                                  ky, kx, padding, sliding, out_shape)
    _close(got.numpy(), numpy.asarray(want), rtol, "forward")
    want = jax_conv.deconv_hits_jax(in_shape[:3], ky, kx, padding, sliding,
                                    out_shape)
    got = conv_ops.deconv_hits(in_shape[:3], ky, kx, padding, sliding,
                               out_shape)
    assert numpy.array_equal(got.numpy(), numpy.asarray(want))
    want = jax_conv.deconv_backward_jax(jnp.asarray(x), jnp.asarray(err),
                                        jnp.asarray(w), ky, kx, padding,
                                        sliding)
    got = conv_ops.deconv_backward(torch.from_numpy(x),
                                   torch.from_numpy(err),
                                   torch.from_numpy(w), ky, kx, padding,
                                   sliding)
    for g, j, what in zip(got, want, ("err_input", "grad_weights")):
        _close(g.numpy(), numpy.asarray(j), rtol, what)


# -- units --------------------------------------------------------------------

def _array(pkg, value):
    if pkg == "jax":
        return JaxArray(value.copy())
    arr = Array(value.copy())
    arr.device = torch.device("cpu")
    return arr


@pytest.mark.parametrize("tpe", ["stochastic_pooling",
                                 "stochastic_abs_pooling",
                                 "stochastic_pool_depool",
                                 "stochastic_abs_pool_depool"])
def test_stochastic_units_match_jax(f64, tpe):
    """Seeded alike, the units draw the same stream and pick the same
    winners over two runs; the plain stochastic pools' GD units route
    an output gradient to them as the JAX units do."""
    r = numpy.random.RandomState(len(tpe))
    x = r.uniform(-2, 2, (3, 9, 8, 4))
    kw = {"kx": 3, "ky": 3, "sliding": (2, 2)} if "depool" not in tpe \
        else {"kx": 2, "ky": 2}
    err = r.normal(size=(3, 4, 4, 4))
    out = {}
    for pkg, wf, mapping, rng in (
            ("jax", JaxWorkflow(None), jax_nn_units.mapping, jax_prng),
            ("torch", AcceleratedWorkflow(None), nn_units.mapping, prng)):
        fwd = mapping[tpe].forward(
            wf, name="pool", uniform=rng.RandomGenerator().seed(12), **kw)
        fwd.input = _array(pkg, x)
        fwd.initialize(device=JaxDevice() if pkg == "jax" else "cpu")
        got = []
        for _ in range(2):
            fwd.run()
            got += [numpy.array(fwd.output.mem),
                    numpy.array(fwd.input_offset.mem)]
        if "depool" not in tpe:
            gd = next(mapping[tpe].backwards)(wf, name="gd", **kw)
            gd.link_attrs(fwd, "input", "input_offset")
            gd.err_output = _array(pkg, err)
            gd.initialize(device=JaxDevice() if pkg == "jax" else "cpu")
            gd.run()
            got.append(numpy.array(gd.err_input.mem))
        out[pkg] = got
    for i, (g, w) in enumerate(zip(out["torch"], out["jax"])):
        if w.dtype.kind in "iu" or i < 4:
            assert numpy.array_equal(g, w), i
        else:
            _close(g, w, RTOL64, "err_input")


def _ae_units(pkg, x, kw):
    """conv -> maxabs pool -> Depooling -> Deconv (the conv's weights)
    -> GDDeconv, one package's units, as ``samples/mnist_ae.py`` links
    them but with the registered depooling unit."""
    if pkg == "jax":
        wf, mapping = JaxWorkflow(None), jax_nn_units.mapping
        rand = jax_prng.RandomGenerator().seed(21)
    else:
        wf, mapping = AcceleratedWorkflow(None), nn_units.mapping
        rand = prng.RandomGenerator().seed(21)
    conv = mapping["conv"].forward(wf, name="conv", n_kernels=4, kx=3, ky=3,
                                   include_bias=False, rand=rand)
    conv.input = _array(pkg, x)
    pool = mapping["maxabs_pooling"].forward(wf, name="pool", **kw)
    pool.link_attrs(conv, ("input", "output"))
    depool = mapping["depooling"].forward(wf, name="depool")
    depool.link_attrs(pool, ("input", "output"),
                      ("output_offset", "input_offset"))
    depool.link_attrs(conv, ("output_shape_source", "output"))
    if pkg == "torch":
        depool.link_attrs(pool, "kx", "ky", "sliding")
    deconv = mapping["deconv"].forward(wf, name="deconv",
                                       unsafe_padding=True)
    deconv.link_attrs(conv, "weights")
    deconv.link_conv_attrs(conv)
    deconv.link_attrs(depool, ("input", "output"))
    deconv.link_attrs(conv, ("output_shape_source", "input"))
    gd = next(mapping["deconv"].backwards)(
        wf, name="gd", learning_rate=0.05, weights_decay=0.01,
        gradient_moment=0.9)
    gd.link_attrs(deconv, "weights", "input", "n_kernels", "kx", "ky",
                  "sliding", "padding")
    return conv, pool, depool, deconv, gd


def test_deconv_units_match_jax(f64):
    """The registered ``Depooling`` and ``Deconv`` / ``GDDeconv`` over a
    maxabs pool, two steps in f64: the deconv's output and hits, the
    GD's input gradient and the shared weights and velocity."""
    r = numpy.random.RandomState(13)
    x = r.uniform(-1, 1, (2, 11, 11, 2))
    kw = {"kx": 3, "ky": 3, "sliding": (2, 2)}
    errs = [r.normal(size=(2, 11, 11, 2)) for _ in range(2)]
    out = {}
    for pkg in ("jax", "torch"):
        units = _ae_units(pkg, x, kw)
        conv, _, depool, deconv, gd = units
        dev = JaxDevice() if pkg == "jax" else "cpu"
        got = []
        for step, err in enumerate(errs):
            for u in units[:4]:
                if step == 0:
                    u.initialize(device=dev)
                u.run()
            gd.err_output = _array(pkg, err)
            if step == 0:
                gd.initialize(device=dev)
            gd.run()
            got += [numpy.array(a.mem) for a in (
                depool.output, deconv.output, deconv.hits, gd.err_input,
                conv.weights, gd.gradient_weights_with_moment)]
        assert deconv.weights is conv.weights
        out[pkg] = got
    for i, (g, w) in enumerate(zip(out["torch"], out["jax"])):
        _close(g, w, RTOL64, "array %d" % i)


# -- the MNIST autoencoder sample ---------------------------------------------

def _trajectory(wf):
    """``(class, n_err or -1, round(avg MSE, 9))`` at every segment end,
    as ``GOLDEN_ZOO2`` records them, and each segment's metrics."""
    seq, metrics, d = [], [], wf.decision
    real = d.on_last_minibatch

    def on_last_minibatch():
        real()
        c = d.minibatch_class
        err, met = d.epoch_n_err[c], d.epoch_metrics[c]
        seq.append((int(c), -1 if err is None else int(err),
                    None if met is None else round(float(met[0]), 9)))
        metrics.append(met)
    d.on_last_minibatch = on_last_minibatch
    return seq, metrics


def _train_ae(module, device, snapdir, epochs=2, state=None):
    for p in (prng, jax_prng):
        p.get(1).seed(1234)
        p.get(2).seed(5678)
    kwargs = dict(loader_config=dict(RESEARCH.MNIST_SYNTH),
                  decision_config={"max_epochs": epochs,
                                   "fail_iterations": 10})
    if module is mnist_ae:
        kwargs["snapshotter_config"] = {"directory": str(snapdir)}
    wf = module.build(**kwargs)
    seq, metrics = _trajectory(wf)
    wf.initialize(device=device)
    if state is not None:
        nn_units.load_snapshot_into_workflow(state, wf)
    wf.run()
    return wf, seq, metrics


def test_mnist_ae_reproduces_the_golden_trajectory(tmp_path):
    wf, seq, _ = _train_ae(mnist_ae, "cpu", tmp_path)
    RESEARCH._assert_trajectory("mnist_ae", seq,
                                RESEARCH.GOLDEN_ZOO2["mnist_ae"])
    assert wf.deconv.weights is wf.conv.weights
    assert [tuple(a.shape) for a in (
        wf.conv.output, wf.pool.output, wf.depool.err_input,
        wf.deconv.output)] == [(30, 24, 24, 5), (30, 12, 12, 5),
                               (30, 24, 24, 5), (30, 28, 28, 1)]


def test_mnist_ae_matches_jax_float64(f64, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_root.common.dirs, "snapshots", str(tmp_path))
    jwf, jseq, jmet = _train_ae(jax_mnist_ae, JaxDevice(), tmp_path)
    twf, tseq, tmet = _train_ae(mnist_ae, "cpu", tmp_path)
    assert [s[:2] for s in tseq] == [s[:2] for s in jseq]
    for got, want in zip(tmet, jmet):
        _close(numpy.array(got), numpy.array(want), RTOL64, "metrics")
    assert twf.conv.weights.mem.dtype == numpy.float64
    _close(twf.conv.weights.mem, numpy.array(jwf.conv.weights.mem), RTOL64,
           "weights")
    _close(twf.gd_deconv.gradient_weights_with_moment.mem,
           numpy.array(jwf.gd_deconv.gradient_weights_with_moment.mem),
           RTOL64, "velocity")


def test_mnist_ae_resumes_bit_for_bit(tmp_path):
    """The epoch-1 snapshot carries the weights, the optimizer Arrays and
    the prng stream the stochastic pool draws from: resumed, epoch 2
    ends as the uninterrupted run did."""
    from znicz_tpu_torch.core.snapshotter import SnapshotterToFile
    wf, seq, _ = _train_ae(mnist_ae, "cpu", tmp_path / "run")
    snaps = sorted(os.listdir(tmp_path / "run"))
    first = [s for s in snaps if "0.310541" in s]
    assert first, snaps
    state = SnapshotterToFile.import_(str(tmp_path / "run" / first[0]))
    rwf, rseq, _ = _train_ae(mnist_ae, "cpu", tmp_path / "resumed",
                             state=state)
    assert rseq == seq[2:]
    for a, b in ((rwf.conv.weights, wf.conv.weights),
                 (rwf.gd_deconv.gradient_weights_with_moment,
                  wf.gd_deconv.gradient_weights_with_moment)):
        assert numpy.array_equal(_bits(a.mem), _bits(b.mem))


def test_mnist_ae_cli(tmp_path):
    """``python -m znicz_tpu_torch mnist_ae --device cpu`` trains."""
    from znicz_tpu_torch import __main__ as cli
    argv = ["mnist_ae", "--device", "cpu"]
    for key, value in (("loader.synthetic_train", 60),
                       ("loader.synthetic_valid", 30),
                       ("loader.minibatch_size", 30),
                       ("decision.max_epochs", 1),
                       ("snapshotter.directory", tmp_path)):
        argv += ["--config", "mnist_ae.%s=%s" % (key, value)]
    with _restored(root.mnist_ae, root.mnist_ae.loader,
                   root.mnist_ae.decision, root.mnist_ae.snapshotter):
        assert cli.main(argv) == 0


def test_params_carry_the_tied_weights_once(tmp_path):
    """``unit_params_to_numpy`` gives the conv's weights once (None for
    the pool and the deconv, which applies them), and
    ``unit_params_from_numpy`` sets them from the JAX package's arrays,
    the deconv seeing them too; a pair for the deconv is refused."""
    wf = mnist_ae.build(loader_config=dict(RESEARCH.MNIST_SYNTH),
                        snapshotter_config={"directory": str(tmp_path)})
    wf.initialize(device="cpu")
    pairs = unit_params_to_numpy(wf.forwards)
    assert pairs[0][0].shape == (5, 25) and pairs[0][1] is None
    assert pairs[1:] == [None, None]
    w = numpy.random.RandomState(3).uniform(-1, 1, (5, 25)).astype(
        numpy.float32)
    unit_params_from_numpy(wf.forwards, [(w, None), None, None])
    assert numpy.array_equal(wf.deconv.weights.mem, w)
    with pytest.raises(ValueError, match="shares its weights"):
        unit_params_from_numpy(wf.forwards, [None, None, (w, None)])


# -- FusedNet, objective="mse" ------------------------------------------------

def _fused_ae(dtype=numpy.float64, **kwargs):
    return fused.FusedNet(FUSED_AE.AE_LAYERS, (12, 12, 1),
                          rand=prng.RandomGenerator().seed(99), dtype=dtype,
                          objective="mse", device="cpu", **kwargs)


def test_fused_ae_matches_jax_unit_graph_and_fused_float64():
    r = numpy.random.RandomState(5)
    x = r.uniform(-1, 1, (4, 12, 12, 1))
    cv, dc_unit = FUSED_AE._ae_unit_graph(x, steps=3)
    jnet = JaxFusedNet(FUSED_AE.AE_LAYERS, (12, 12, 1),
                       rand=jax_prng.RandomGenerator().seed(99),
                       dtype=numpy.float64, objective="mse")
    net = _fused_ae()
    assert net.specs[3].padding == tuple(dc_unit.padding)
    assert [s.kind for s in net.specs] == ["conv", "pool", "depool",
                                           "deconv"]
    assert net.specs[0].stop_gradient and net.specs[1].record_offsets
    for _ in range(3):
        m = net.step_mse(x, x, len(x))
        jm = jnet.step_mse(x, x, len(x))
        _close(float(m["loss"]), float(jm["loss"]), RTOL64, "loss")
    params = net.host_params()
    assert params[3] == {}
    _close(params[0]["w"], cv.weights.mem, RTOL64, "against the unit graph")
    _close(params[0]["w"], jnet.host_params()[0]["w"], RTOL64,
           "against JAX FusedNet")
    _close(net.state[0]["w"]["vel"].numpy(),
           numpy.asarray(jnet.state[0]["w"]["vel"]), RTOL64, "velocity")


def test_fused_ae_output_matches_unit_forward():
    r = numpy.random.RandomState(7)
    x = r.uniform(-1, 1, (2, 12, 12, 1))
    _, dc_unit = FUSED_AE._ae_unit_graph(x, steps=1)
    net = _fused_ae()
    y = fused.forward(net.params, torch.from_numpy(x), net.specs)
    assert tuple(y.shape) == x.shape
    _close(y.numpy(), numpy.array(dc_unit.output.mem), RTOL64, "forward")


@pytest.mark.parametrize("pool_impl", [None, "offsets", "gather"])
def test_fused_ae_tied_pool_records_offsets_whatever_the_impl(pool_impl):
    """The tied pool's lowering is not ``pool_impl``'s: on the CPU it is
    the kernel's plain version, never the reduce_window lowering."""
    x = numpy.random.RandomState(1).uniform(-1, 1, (2, 12, 12, 1))
    net = _fused_ae(pool_impl=pool_impl)
    assert net.specs[1].impl == "reduce_window"   # untouched, unused
    ref = _fused_ae()
    for n in (net, ref):
        n.step_mse(x, x)
    assert numpy.array_equal(net.host_params()[0]["w"],
                             ref.host_params()[0]["w"])


def test_fused_ae_window_equals_steps_and_jax():
    """``run_window_mse_indexed`` (K steps over the device dataset, stats
    folded on the device) equals K ``step_mse`` calls and the JAX window:
    parameters and the evaluator metrics, with the per-sample MSE of the
    last step."""
    import jax
    from znicz_tpu.ops import evaluator as jax_ev
    r = numpy.random.RandomState(5)
    k, b = 4, 4
    xs = r.uniform(-1, 1, (k, b, 12, 12, 1))
    steps = _fused_ae()
    want = numpy.array([0.0, 0.0, numpy.inf])
    for i in range(k):
        m = steps.step_mse(xs[i], xs[i], b)
        _, md, _ = jax_ev.mse_jax(jnp.asarray(m["output"].numpy()),
                                  jnp.asarray(xs[i].reshape(b, -1)), b,
                                  mean=True, root=True)
        md = numpy.asarray(md)
        want = numpy.array([want[0] + md[0], max(want[1], md[1]),
                            min(want[2], md[2])])
    net = _fused_ae()
    rows = xs.reshape((k * b,) + xs.shape[2:])
    net.set_dataset(rows, None, rows)
    stats = net.run_window_mse_indexed(numpy.arange(k * b).reshape(k, b),
                                       [b] * k,
                                       fused.stack_hypers(net.hypers, k))
    lbl = numpy.full((k, b), -1, numpy.int32)
    jnet = JaxFusedNet(FUSED_AE.AE_LAYERS, (12, 12, 1),
                       rand=jax_prng.RandomGenerator().seed(99),
                       dtype=numpy.float64, objective="mse")
    jstats = jnet.run_window_mse(
        xs, xs, lbl, [b] * k, jax.tree.map(
            lambda *v: numpy.asarray(v, numpy.float64), *[jnet.hypers] * k))
    for a, s, j in zip(net.host_params(), steps.host_params(),
                       jnet.host_params()):
        for key in a:
            _close(a[key], s[key], RTOL64, "window vs steps")
            _close(a[key], j[key], RTOL64, "window vs JAX")
    _close(stats["metrics"].numpy(), want, RTOL64, "metrics")
    _close(stats["metrics"].numpy(), numpy.asarray(jstats["metrics"]),
           RTOL64, "metrics vs JAX")
    assert tuple(stats["mse_per"].shape) == (b,)
    assert numpy.array_equal(net.window_acc_host()["metrics"],
                             stats["metrics"].numpy())


def test_kernel_plans_at_the_autoencoder_shape():
    """At (100, 24, 24, 5) f32, 3x3/s2, both kernels take one channel a
    thread (5 channels make no 16-byte vector) and a staged plan, the
    backward its stride-2 instantiation: nothing refuses the
    autoencoder's maxabs pool or its depooling."""
    from znicz_tpu_torch.ops import cuda_pooling, cuda_pooling_backward
    shape, grid = (100, 24, 24, 5), (100, 12, 12, 5)
    assert cuda_pooling.vector_width(torch.zeros(shape)) == 1
    assert cuda_pooling.launch_plan(shape, 4, 1, 3, 3, (2, 2)).staged
    assert cuda_pooling_backward.vector_width(
        torch.zeros(grid), torch.zeros(grid, dtype=torch.int32),
        torch.zeros(shape)) == 1
    plan = cuda_pooling_backward.launch_plan(shape, 4, 1, 3, 3, (2, 2))
    assert plan.staged and plan.stride2
