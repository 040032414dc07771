"""The port's layer units (``znicz_tpu_torch.units``: all2all, conv,
pooling, gd, gd_conv, gd_pooling, activation, dropout, normalization)
against the JAX package's, on the CPU.

Each layer type runs its forward unit and then its GD unit in both
packages, from the same numpy input and output gradient (made from a
seed) and the same initial weights (both packages' host streams seeded
alike), with ``jax_run`` on the JAX CPU device; in float64 every
output, input gradient, updated weight, bias and velocity agrees
within 1e-12 of the tensor's largest magnitude, two steps running so
that the momentum enters.  The dropout pair is handed the JAX unit's
mask (the port draws its own on the device).

The max-pooling units in float32: ``MaxPooling`` / ``MaxAbsPooling``
equal the JAX units (the Pallas kernel in interpret mode, what
``max_pooling_jax`` takes on the CPU) bit for bit, values and offsets,
at the MNIST sample's two pool shapes (batch 4) and at an overhanging
3x3/s2 pool; ``GDMaxPooling`` equals the JAX unit's scatter-add bit
for bit at 2x2/s2, and at 3x3/s2 (where a cell can win up to four
windows and the kernel adds in another order) within 1e-6 of the
largest magnitude in float32 and 1e-12 in float64.
"""

import numpy
import pytest
import torch

from test_torch_units import prng_streams_restored  # noqa: F401
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.core.accelerated_units import \
    AcceleratedWorkflow as JaxWorkflow
from znicz_tpu.core.backends import JaxDevice
from znicz_tpu.core.memory import Array as JaxArray
from znicz_tpu.units import nn_units as jax_nn_units
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.accelerated_units import AcceleratedWorkflow
from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.loader.base import TRAIN, VALID
from znicz_tpu_torch.ops import cuda_pooling, cuda_pooling_backward
from znicz_tpu_torch.params import unit_params_from_numpy
from znicz_tpu_torch.units import nn_units
from znicz_tpu_torch.units.conv import ConvolutionalBase
from znicz_tpu_torch.units.gd_pooling import GDPooling
import znicz_tpu.units  # noqa: F401  (registers the JAX layer types)
import znicz_tpu_torch.standard_workflow_base  # noqa: F401  (the port's)

RTOL = 1e-12
GD = {"learning_rate": 0.1, "learning_rate_bias": 0.2,
      "weights_decay": 0.01, "weights_decay_bias": 0.001,
      "gradient_moment": 0.9, "gradient_moment_bias": 0.5,
      "factor_ortho": 0.001}

#: (type, forward kwargs, backward kwargs, input shape)
LAYERS = [
    ("all2all", {"output_sample_shape": 7}, GD, (5, 4, 3)),
    ("all2all_tanh", {"output_sample_shape": 6}, GD, (5, 9)),
    ("all2all_relu", {"output_sample_shape": 6}, GD, (5, 9)),
    ("all2all_str", {"output_sample_shape": 6}, GD, (5, 9)),
    ("all2all_sigmoid", {"output_sample_shape": 6}, GD, (5, 9)),
    ("softmax", {"output_sample_shape": 4}, GD, (5, 9)),
    ("conv", {"n_kernels": 5, "kx": 3, "ky": 3}, GD, (3, 9, 8, 2)),
    ("conv_tanh", {"n_kernels": 4, "kx": 2, "ky": 3, "sliding": (2, 1),
                   "padding": (1, 0, 2, 1)}, GD, (3, 9, 8, 2)),
    ("conv_relu", {"n_kernels": 4, "kx": 3, "ky": 3,
                   "padding": (1, 1, 1, 1)}, GD, (3, 7, 7)),
    ("conv_str", {"n_kernels": 4, "kx": 3, "ky": 3, "sliding": (2, 2)},
     GD, (3, 9, 9, 2)),
    ("conv_sigmoid", {"n_kernels": 3, "kx": 2, "ky": 2}, GD, (2, 6, 6, 3)),
    ("max_pooling", {"kx": 2, "ky": 2, "sliding": (2, 2)}, {}, (3, 8, 8, 4)),
    ("maxabs_pooling", {"kx": 3, "ky": 3, "sliding": (2, 2)}, {},
     (3, 9, 8, 4)),
    ("max_pooling", {"kx": 3, "ky": 2, "sliding": (2, 3)}, {}, (2, 7, 7)),
    ("avg_pooling", {"kx": 3, "ky": 3, "sliding": (2, 2)}, {},
     (3, 9, 8, 4)),
    ("activation_tanh", {}, {}, (4, 6)),
    ("activation_sigmoid", {}, {}, (4, 6)),
    ("activation_relu", {}, {}, (4, 3, 3, 2)),
    ("activation_str", {}, {}, (4, 6)),
    ("activation_log", {}, {}, (4, 6)),
    ("activation_tanhlog", {}, {}, (4, 6)),
    ("activation_sincos", {}, {}, (4, 3, 2)),
    ("activation_mul", {}, {"factor": 0.3}, (4, 6)),
    ("dropout", {"dropout_ratio": 0.4}, {"dropout_ratio": 0.4}, (4, 10)),
    ("norm", {"n": 3, "alpha": 0.01, "beta": 0.75, "k": 2}, {},
     (2, 3, 3, 7)),
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes,
    and their thread pools would otherwise contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _array(pkg, value):
    """An Array of the package holding ``value`` (on the CPU)."""
    if pkg == "jax":
        return JaxArray(value.copy())
    arr = Array(value.copy())
    arr.device = torch.device("cpu")
    return arr


def _build(pkg, tpe, fkw, bkw, x):
    """A forward unit and its GD unit of layer type ``tpe`` in one
    package, linked as ``StandardWorkflow.link_gds`` links them."""
    if pkg == "jax":
        wf, mapping = JaxWorkflow(None), jax_nn_units.mapping
        rand = jax_prng.RandomGenerator().seed(11)
    else:
        wf, mapping = AcceleratedWorkflow(None), nn_units.mapping
        rand = prng.RandomGenerator().seed(11)
    fwd = mapping[tpe].forward(wf, name="fwd", rand=rand, **fkw)
    gd = next(mapping[tpe].backwards)(wf, name="gd", **bkw)
    fwd.input = _array(pkg, x)
    fwd.minibatch_class = TRAIN
    try_link = {"input", "weights", "bias", "input_offset", "mask",
                "output"}
    if isinstance(gd, ConvolutionalBase) or hasattr(gd, "CONV_ATTRS"):
        try_link.update(ConvolutionalBase.CONV_ATTRS)
    if isinstance(gd, GDPooling) or hasattr(gd, "POOL_ATTRS"):
        try_link.update(GDPooling.POOL_ATTRS)
    gd.link_attrs(fwd, *[a for a in sorted(try_link)
                         if getattr(fwd, a, None) is not None])
    gd.minibatch_class = TRAIN
    return fwd, gd


def _host(a):
    return None if a is None or not a else numpy.array(a.mem)


def _run(pkg, tpe, fkw, bkw, x, errs, mask=None):
    """Two forward + GD steps; the host copies of what each produced."""
    fwd, gd = _build(pkg, tpe, fkw, bkw, x)
    dev = JaxDevice() if pkg == "jax" else "cpu"
    fwd.initialize(device=dev)
    out = {}
    for step, err in enumerate(errs):
        if mask is not None:
            fwd.calc_mask = lambda: fwd.mask.set_dev(torch.from_numpy(
                mask[step]))
        fwd.run()
        out["output%d" % step] = _host(fwd.output)
        for extra in ("input_offset", "mask", "max_idx"):
            if getattr(fwd, extra, None) is not None:
                out["%s%d" % (extra, step)] = _host(getattr(fwd, extra))
        gd.err_output = _array(pkg, err.reshape(fwd.output.shape))
        if step == 0:
            gd.initialize(device=dev)
        gd.run()
        out["err_input%d" % step] = _host(gd.err_input)
        for attr in ("weights", "bias", "gradient_weights_with_moment",
                     "gradient_bias_with_moment"):
            out["%s%d" % (attr, step)] = _host(getattr(gd, attr, None))
    return out


def _close(got, want, rtol, what):
    assert got.shape == want.shape, what
    scale = max(numpy.abs(want).max(), 1e-300)
    err = numpy.abs(got.astype(numpy.float64) - want).max() / scale
    assert err <= rtol, "%s: %.3g relative" % (what, err)


@pytest.mark.parametrize("tpe,fkw,bkw,shape", LAYERS,
                         ids=["%s-%d" % (layer[0], i)
                              for i, layer in enumerate(LAYERS)])
def test_layer_unit_pair_matches_jax(tpe, fkw, bkw, shape):
    rng = numpy.random.RandomState(sum(map(ord, tpe)) + len(shape))
    x = rng.uniform(-2, 2, shape)
    if tpe == "activation_log":
        x = x * 3
    fwd, _ = _build("jax", tpe, fkw, bkw, x)
    fwd.initialize(device=JaxDevice())
    out_shape = tuple(fwd.output.shape)
    errs = [rng.normal(size=out_shape) for _ in range(2)]
    want = _run("jax", tpe, fkw, bkw, x, errs)
    mask = [want["mask0"], want["mask1"]] if tpe == "dropout" else None
    got = _run("torch", tpe, fkw, bkw, x, errs, mask)
    assert sorted(k for k, v in got.items() if v is not None) == \
        sorted(k for k, v in want.items() if v is not None)
    for key, w in want.items():
        if w is None:
            continue
        if w.dtype.kind in "iu":
            assert numpy.array_equal(got[key], w), key
        else:
            _close(got[key], w, RTOL, key)


def test_dropout_mask_from_the_units_generator():
    """The port's own mask: 0 or 1 / (1 - ratio), about the ratio of
    zeros, a new one each TRAIN minibatch from the unit's generator, and
    VALID passes the input through."""
    x = numpy.random.RandomState(0).uniform(1, 2, (64, 50))
    fwd, _ = _build("torch", "dropout", {"dropout_ratio": 0.25}, {}, x)
    fwd.initialize(device="cpu")
    state = fwd.generator_state
    fwd.run()
    m1 = _host(fwd.mask)
    assert set(numpy.unique(m1)) == {0.0, 1 / 0.75}
    assert abs((m1 == 0).mean() - 0.25) < 0.03
    fwd.run()
    assert not numpy.array_equal(_host(fwd.mask), m1)
    fwd.generator_state = state
    fwd.run()
    assert numpy.array_equal(_host(fwd.mask), m1)
    numpy.testing.assert_array_equal(_host(fwd.output), x * m1)
    fwd.minibatch_class = VALID
    fwd.run()
    numpy.testing.assert_array_equal(_host(fwd.output), x)


#: (input shape, kx, ky, sliding): the MNIST conv sample's pools at
#: batch 4, and an overlapping 3x3/s2 pool whose windows overhang
POOLS = [((4, 24, 24, 64), 2, 2, (2, 2)), ((4, 8, 8, 87), 2, 2, (2, 2)),
         ((3, 9, 10, 5), 3, 3, (2, 2))]


@pytest.mark.parametrize("shape,kx,ky,sliding", POOLS)
@pytest.mark.parametrize("tpe", ["max_pooling", "maxabs_pooling"])
def test_max_pooling_units_bit_equal_to_pallas(shape, kx, ky, sliding, tpe):
    rng = numpy.random.RandomState(shape[-1])
    # few distinct values: ties in every window, and |x| ties for maxabs
    x = rng.randint(-4, 5, shape).astype(numpy.float32)
    kw = {"kx": kx, "ky": ky, "sliding": sliding}
    j, _ = _build("jax", tpe, kw, {}, x)
    t, _ = _build("torch", tpe, kw, {}, x)
    j.initialize(device=JaxDevice())
    t.initialize(device="cpu")
    j.run()
    t.run()
    assert _host(t.output).dtype == numpy.float32
    assert numpy.array_equal(_host(t.output).view(numpy.int32),
                             _host(j.output).view(numpy.int32))
    assert numpy.array_equal(_host(t.input_offset), _host(j.input_offset))


@pytest.mark.parametrize("shape,kx,ky,sliding", POOLS)
@pytest.mark.parametrize("dtype", [numpy.float32, numpy.float64])
def test_gd_max_pooling_matches_jax(shape, kx, ky, sliding, dtype):
    """Bit-equal where the windows are disjoint (2x2/s2); at 3x3/s2 a
    cell shared by windows sums in another order, so within 1e-6 of the
    largest magnitude in float32 and 1e-12 in float64."""
    rng = numpy.random.RandomState(7)
    x = rng.randint(-4, 5, shape).astype(dtype)
    kw = {"kx": kx, "ky": ky, "sliding": sliding}
    j, _ = _build("jax", "max_pooling", kw, {}, x)
    j.initialize(device=JaxDevice())
    err = rng.normal(size=j.output.shape).astype(dtype)
    got = _run("torch", "max_pooling", kw, {}, x, [err])["err_input0"]
    want = _run("jax", "max_pooling", kw, {}, x, [err])["err_input0"]
    assert got.dtype == dtype
    if (kx, ky) == tuple(sliding):
        assert numpy.array_equal(got, want)
    else:
        _close(got, want, 1e-6 if dtype == numpy.float32 else RTOL,
               "err_input")


def test_unit_params_from_numpy_sets_the_forwards():
    """Weights and bias from JAX-layout host pairs, in the unit's dtype;
    a None leaves its Array."""
    x = numpy.random.RandomState(1).uniform(size=(3, 5))
    a, _ = _build("torch", "all2all", {"output_sample_shape": 2}, {}, x)
    p, _ = _build("torch", "max_pooling", {"kx": 2, "ky": 2}, {},
                  x.reshape(3, 5, 1))
    a.initialize(device="cpu")
    b0 = _host(a.bias)
    w = numpy.arange(10, dtype=numpy.float32).reshape(2, 5)
    unit_params_from_numpy([a, p], [(w, None), None])
    assert _host(a.weights).dtype == numpy.float64
    numpy.testing.assert_array_equal(_host(a.weights), w)
    numpy.testing.assert_array_equal(_host(a.bias), b0)


def test_kernel_guards_take_float64():
    """float64: 16-byte vectors of 2 channels, plans within shared
    memory at the MNIST shapes (the forward's and the backward's), and
    the backward's guards let it through to the device check."""
    for shape in ((60, 24, 24, 64), (60, 8, 8, 87)):
        x = torch.zeros(shape, dtype=torch.float64)
        vec = cuda_pooling.vector_width(x)
        assert vec == (2 if shape[3] % 2 == 0 else 1)
        plan = cuda_pooling.launch_plan(shape, 8, vec, 2, 2, (2, 2))
        assert plan.staged and plan.smem <= cuda_pooling.MAX_SMEM
        assert plan.lanes * vec * 8 <= cuda_pooling.SLAB_BYTES
        b, h, w, c = shape
        err = torch.zeros((b, h // 2, w // 2, c), dtype=torch.float64)
        offs = torch.zeros(err.shape, dtype=torch.int32)
        bvec = cuda_pooling_backward.vector_width(
            err, offs, torch.zeros(shape, dtype=torch.float64))
        assert bvec == vec
        plan = cuda_pooling_backward.launch_plan(shape, 8, bvec, 2, 2,
                                                 (2, 2))
        assert plan.staged and plan.stride2
        assert plan.smem <= cuda_pooling_backward.TILE_BYTES
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda_pooling_backward.max_pooling_offsets_backward(
                err, offs, shape, 2, 2, (2, 2))


def test_oversized_windows_plan_the_unstaged_kernels():
    """The windows no shared memory holds take the unstaged
    instantiations instead of raising: the forward's global 128x128
    pool over (2, 128, 128, 4) f32 (128 rows x 2,048 B) and the
    backward's 96x96/s1 windows over (1, 191, 191, 4) f32 (294,912 B
    of err and offsets cover one cell)."""
    plan = cuda_pooling.launch_plan((2, 128, 128, 4), 4, 4, 128, 128,
                                    (128, 128))
    assert not plan.staged and plan.smem == 0 and plan.lanes == 1
    assert 128 * 2048 > cuda_pooling.MAX_SMEM
    plan = cuda_pooling_backward.launch_plan((1, 191, 191, 4), 4, 4, 96, 96,
                                             (1, 1))
    assert not plan.staged and plan.smem == 0
    assert cuda_pooling_backward.variant(plan) == 2
    assert plan.block[0] * plan.block[1] * plan.block[2] <= 256
    assert 96 * 96 * 32 > cuda_pooling_backward.MAX_SMEM
