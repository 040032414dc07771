"""Numeric differentiation of the port's analytic gradients (float64),
after ``tests/unit/test_gd_numdiff.py`` and ``test_gd_numdiff_conv.py``.

Every weight, bias and input element is perturbed with the five-point
stencil of the port's ``core.memory.NumDiff``; the loss is composed
independently from the port's numpy twins (``ops.dense`` / ``conv`` /
``pooling`` ``*_numpy``); each analytic gradient is within ``TOL`` =
1e-5 of the numeric one, JAX's bound:

* the GD units ``GDSoftmax`` / ``GDTanh`` of a two-layer net (their
  ``gradient_weights``, ``gradient_bias`` and ``err_input``);
* a whole conv chain: ``GDTanhConv`` (``units/gd_conv.py``) after
  ``GDMaxPooling``, ``GDTanh`` and ``GDSoftmax`` after the evaluator;
* the ops the units run: the conv backward (padded, strided), the
  deconv backward and the max, maxabs and average pooling backwards on
  ceil-mode windows.

It also checks the memory helpers ``roundup``, ``reshape``, ``ravel``
and ``interleave`` against JAX's.
"""

import numpy
import pytest
import torch

from test_torch_mnist import _one_torch_thread  # noqa: F401
from znicz_tpu.core import memory as jax_memory
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.memory import (Array, NumDiff, interleave, ravel,
                                         reshape, roundup)
from znicz_tpu_torch.core.workflow import Workflow
from znicz_tpu_torch.ops import activations
from znicz_tpu_torch.ops import conv as conv_ops
from znicz_tpu_torch.ops import dense
from znicz_tpu_torch.ops import pooling as pool_ops
from znicz_tpu_torch.units import (all2all, conv, evaluator, gd, gd_conv,
                                   gd_pooling, pooling)

TOL = 1e-5
#: the conv geometry: asymmetric padding (left, top, right, bottom) and
#: non-unit sliding
PAD = (1, 2, 1, 0)
SLIDE = (2, 2)


def numdiff(f, arr):
    """The five-point numeric gradient of the scalar ``f()`` with
    respect to every element of ``arr`` (perturbed in place)."""
    nd = NumDiff()
    g = numpy.zeros_like(arr)
    flat, gf = arr.reshape(-1), g.reshape(-1)
    for i in range(flat.size):
        orig = flat[i]
        for j, p in enumerate(NumDiff.points):
            flat[i] = orig + p * NumDiff.h
            nd.errs[j] = f()
        flat[i] = orig
        gf[i] = nd.derivative
    return g


def _t(a):
    return torch.as_tensor(numpy.array(a))


def _array(a):
    """A copy of ``a`` in an Array on the CPU."""
    arr = Array(numpy.array(a))
    arr.device = torch.device("cpu")
    return arr


def _ce(probs, labels):
    n = len(labels)
    return -numpy.log(probs[numpy.arange(n), labels]).sum() / n


def test_numdiff_is_jax_stencil():
    assert NumDiff.points == jax_memory.NumDiff.points
    assert numpy.array_equal(NumDiff.coeffs, jax_memory.NumDiff.coeffs)
    assert (NumDiff.divizor, NumDiff.h) == (jax_memory.NumDiff.divizor,
                                            jax_memory.NumDiff.h)
    x = numpy.array([0.3])
    assert abs(numdiff(lambda: numpy.sin(x[0]) ** 3, x)[0] -
               3 * numpy.sin(0.3) ** 2 * numpy.cos(0.3)) < 1e-11


def test_memory_helpers_equal_jax():
    for n, m in ((7, 4), (8, 4), (0, 3), (13, 1)):
        assert roundup(n, m) == jax_memory.roundup(n, m)
    chw = numpy.arange(24.0).reshape(2, 3, 4)
    assert numpy.array_equal(interleave(chw), jax_memory.interleave(chw))
    assert numpy.array_equal(interleave(chw[None]),
                             jax_memory.interleave(chw[None]))
    with pytest.raises(ValueError):
        interleave(chw[0])
    arr = Array(numpy.arange(6.0).reshape(2, 3))
    assert reshape(arr, (3, 2)).shape == (3, 2) and arr.shape == (3, 2)
    assert ravel(arr).tolist() == list(range(6))


def _fc_net():
    rng = numpy.random.RandomState(11)
    x = rng.uniform(-1, 1, (4, 5))
    labels = rng.randint(0, 3, 4).astype(numpy.int32)
    wf = Workflow(None)
    f1 = all2all.All2AllTanh(wf, output_sample_shape=(6,),
                             weights_stddev=0.3, bias_stddev=0.3,
                             rand=prng.RandomGenerator().seed(5))
    f1.input = _array(x)
    f2 = all2all.All2AllSoftmax(wf, output_sample_shape=(3,),
                                weights_stddev=0.3, bias_stddev=0.3,
                                rand=prng.RandomGenerator().seed(6))
    f2.link_attrs(f1, ("input", "output"))
    for f in (f1, f2):
        f.link_from(wf.start_point)
        f.initialize(device="cpu")
        assert f.weights.mem.dtype == numpy.float64
    return wf, x, labels, f1, f2


def test_gradients_match_numdiff():
    """``tests/unit/test_gd_numdiff.py``: the GD units of a two-layer
    net against the numeric gradient of the mean cross-entropy."""
    wf, x, labels, f1, f2 = _fc_net()
    f1.run()
    f2.run()
    n = len(x)
    err = numpy.array(f2.output.mem)
    err[numpy.arange(n), labels] -= 1.0
    err /= n
    g2 = gd.GDSoftmax(wf, apply_gradient=False)
    g2.err_output = _array(err)
    g2.link_attrs(f2, "output", "input", "weights", "bias")
    g2.batch_size = n
    g2.initialize(device="cpu")
    g2.run()
    g1 = gd.GDTanh(wf, apply_gradient=False)
    g1.link_attrs(g2, ("err_output", "err_input"))
    g1.link_attrs(f1, "output", "input", "weights", "bias")
    g1.batch_size = n
    g1.initialize(device="cpu")
    g1.run()
    params = [(numpy.array(f.weights.mem), numpy.array(f.bias.mem))
              for f in (f1, f2)]
    xin = x.copy()

    def loss():
        h = dense.forward_numpy(xin, *params[0], activation="tanh")
        y = dense.forward_numpy(h, *params[1])
        return _ce(dense.softmax_numpy(y)[0], labels)

    for unit, (w, b), tag in ((g2, params[1], "softmax"),
                              (g1, params[0], "tanh")):
        assert numpy.abs(unit.gradient_weights.mem -
                         numdiff(loss, w)).max() < TOL, tag
        assert numpy.abs(unit.gradient_bias.mem -
                         numdiff(loss, b)).max() < TOL, tag
    assert numpy.abs(g1.err_input.mem - numdiff(loss, xin)).max() < TOL
    assert g2.err_input.mem.shape == f1.output.shape


def test_conv_workflow_gradients_match_numdiff():
    """``test_gd_numdiff_conv.py``'s whole chain: conv tanh -> max pool
    -> FC tanh -> softmax -> evaluator, and back through GDSoftmax,
    GDTanh, GDMaxPooling and GDTanhConv."""
    r = numpy.random.RandomState(7)
    x = r.uniform(-1, 1, (3, 8, 8, 1))
    labels = r.randint(0, 3, 3).astype(numpy.int32)
    n = len(x)
    wf = Workflow(None)
    rand = prng.RandomGenerator().seed(321)
    f0 = conv.ConvTanh(wf, n_kernels=2, kx=3, ky=3, sliding=(1, 1),
                       weights_stddev=0.3, bias_stddev=0.3, rand=rand)
    f0.input = _array(x)
    f1 = pooling.MaxPooling(wf, kx=2, ky=2)
    f1.link_attrs(f0, ("input", "output"))
    f2 = all2all.All2AllTanh(wf, output_sample_shape=(5,),
                             weights_stddev=0.3, bias_stddev=0.3, rand=rand)
    f2.link_attrs(f1, ("input", "output"))
    f3 = all2all.All2AllSoftmax(wf, output_sample_shape=(3,),
                                weights_stddev=0.3, bias_stddev=0.3,
                                rand=rand)
    f3.link_attrs(f2, ("input", "output"))
    ev = evaluator.EvaluatorSoftmax(wf)
    ev.link_attrs(f3, "output", "max_idx")
    ev.labels = _array(labels)
    ev.batch_size = n
    g3 = gd.GDSoftmax(wf, apply_gradient=False)
    g3.link_attrs(ev, "err_output")
    g3.link_attrs(f3, "output", "input", "weights", "bias")
    g2 = gd.GDTanh(wf, apply_gradient=False)
    g2.link_attrs(g3, ("err_output", "err_input"))
    g2.link_attrs(f2, "output", "input", "weights", "bias")
    gp = gd_pooling.GDMaxPooling(wf, kx=2, ky=2, sliding=(2, 2))
    gp.link_attrs(g2, ("err_output", "err_input"))
    gp.link_attrs(f1, "input", "input_offset", "output")
    g0 = gd_conv.GDTanhConv(wf, apply_gradient=False)
    g0.link_attrs(gp, ("err_output", "err_input"))
    g0.link_attrs(f0, "output", "input", "weights", "bias", "n_kernels",
                  "kx", "ky", "padding", "sliding")
    units = (f0, f1, f2, f3, ev, g3, g2, gp, g0)
    for u in (g3, g2, gp, g0):
        u.batch_size = n
    for u in units:
        u.initialize(device="cpu")
    for u in units:
        u.run()
    params = [(numpy.array(f.weights.mem), numpy.array(f.bias.mem))
              for f in (f0, f2, f3)]
    xin = x.copy()

    def loss():
        h = conv_ops.forward_numpy(xin, *params[0], 3, 3, (0, 0, 0, 0),
                                   (1, 1), activation="tanh")
        p, _ = pool_ops.max_pooling_numpy(h, 2, 2, (2, 2))
        f = dense.forward_numpy(p.reshape(n, -1), *params[1],
                                activation="tanh")
        y = dense.forward_numpy(f, *params[2])
        return _ce(dense.softmax_numpy(y)[0], labels)

    for unit, (w, b), tag in ((g0, params[0], "conv"),
                              (g2, params[1], "fc"),
                              (g3, params[2], "softmax")):
        dw = numpy.abs(unit.gradient_weights.mem - numdiff(loss, w)).max()
        db = numpy.abs(unit.gradient_bias.mem - numdiff(loss, b)).max()
        assert dw < TOL, "%s weights: %g" % (tag, dw)
        assert db < TOL, "%s bias: %g" % (tag, db)
    assert numpy.abs(g0.err_input.mem - numdiff(loss, xin)).max() < TOL


# -- the ops the units run ----------------------------------------------------

def test_conv_backward_numdiff_padding_sliding():
    r = numpy.random.RandomState(3)
    x = r.uniform(-1, 1, (2, 6, 7, 2))
    w = r.uniform(-0.5, 0.5, (3, 3 * 3 * 2))
    b = r.uniform(-0.5, 0.5, 3)
    ny, nx = conv_ops.output_spatial(6, 7, 3, 3, PAD, SLIDE)
    proj = r.uniform(-1, 1, (2, ny, nx, 3))

    def loss():
        y = conv_ops.forward_numpy(x, w, b, 3, 3, PAD, SLIDE,
                                   activation="tanh")
        return (y * proj).sum()

    y = conv_ops.forward_numpy(x, w, b, 3, 3, PAD, SLIDE, activation="tanh")
    err = proj * activations.derivative("tanh", _t(y)).numpy()
    err_in, gw, gb = (t.numpy() for t in conv_ops.backward(
        _t(x), _t(err), _t(w), 3, 3, PAD, SLIDE))
    assert numpy.abs(gw - numdiff(loss, w)).max() < TOL
    assert numpy.abs(gb - numdiff(loss, b)).max() < TOL
    assert numpy.abs(err_in - numdiff(loss, x)).max() < TOL


def test_deconv_backward_numdiff():
    r = numpy.random.RandomState(4)
    out_shape = (2, 6, 6, 2)
    ny, nx = conv_ops.output_spatial(6, 6, 3, 3, (0, 0, 0, 0), (1, 1))
    x = r.uniform(-1, 1, (2, ny, nx, 3))
    w = r.uniform(-0.5, 0.5, (3, 3 * 3 * 2))
    proj = r.uniform(-1, 1, out_shape)

    def loss():
        y = conv_ops.deconv_forward(_t(x), _t(w), 3, 3, (0, 0, 0, 0),
                                    (1, 1), out_shape)
        return float((y.numpy() * proj).sum())

    err_in, gw = (t.numpy() for t in conv_ops.deconv_backward(
        _t(x), _t(proj), _t(w), 3, 3, (0, 0, 0, 0), (1, 1)))
    assert numpy.abs(gw - numdiff(loss, w)).max() < TOL
    assert numpy.abs(err_in - numdiff(loss, x)).max() < TOL


@pytest.mark.parametrize("mode", ["max", "maxabs", "avg"])
def test_pooling_backward_numdiff(mode):
    """Ceil-mode truncated windows: a 5x5 input, 2x2 windows, sliding
    2."""
    r = numpy.random.RandomState(5)
    x = r.uniform(-1, 1, (2, 5, 5, 2))
    ny, nx = pool_ops.output_spatial(5, 5, 2, 2, (2, 2))
    proj = r.uniform(-1, 1, (2, ny, nx, 2))
    if mode == "avg":
        def loss():
            return (pool_ops.avg_pooling_numpy(x, 2, 2, (2, 2)) *
                    proj).sum()
        err_in = pool_ops.avg_pooling_backward(_t(proj), 2, 2, (2, 2),
                                               x.shape).numpy()
    else:
        use_abs = mode == "maxabs"

        def loss():
            out, _ = pool_ops.max_pooling_numpy(x, 2, 2, (2, 2), use_abs)
            return (out * proj).sum()
        _, offs = pool_ops.max_pooling_plain(_t(x), 2, 2, (2, 2), use_abs)
        err_in = pool_ops.max_pooling_backward_plain(
            _t(proj), offs, x.shape, 2, 2, (2, 2)).numpy()
    assert numpy.abs(err_in - numdiff(loss, x)).max() < TOL
