"""``pool_impl="reshape"``: the non-overlapping pooling lowering
(``pooling.max_pooling_reshape`` / ``avg_pooling_reshape``) against the
JAX package's ``max_pooling_reshape_jax`` / ``avg_pooling_reshape_jax``
(``znicz_tpu/ops/pooling.py:214-311``), on the CPU.

* Forward and VJP of max, maxabs and avg in float32 and float64, on
  inputs drawn from a few integers (ties in most windows, |x| ties of
  opposite signs for maxabs) and on odd edges (ceil-mode overhang):
  max and maxabs bit-equal, the first winner of the row-major scan
  taking a tie; avg within two units in the last place (XLA divides
  by the truncated window size as a product by its reciprocal).
* The one known difference: the port's backward never routes to a
  pad cell.  In an overhanging window whose largest |x| is 0 the pad's
  fill ties it, but the window's first cell is real and scanned first,
  so both packages route the gradient to it (the test states it on
  such a window).
* ``FusedNet(pool_impl="reshape")`` raises ``ValueError`` where windows
  overlap, as JAX's does, and trains within 1e-10 of JAX's in float64
  on a net of 2x2/s2 and 3x3/s3 pools (max, maxabs and avg), and bit
  for bit like ``pool_impl="offsets"`` in float32 on its max pools.
"""

import jax
import jax.numpy as jnp
import numpy
import pytest
import torch

from test_torch_fused import _conv, _fc
from znicz_tpu.core import prng as jax_prng
from znicz_tpu.ops import pooling as jax_pooling
from znicz_tpu.parallel import fused as jax_fused
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.ops import pooling
from znicz_tpu_torch.parallel import fused

GEOMETRIES = [(2, 8, 8, 3, 2, 2), (2, 9, 7, 4, 2, 2), (1, 10, 11, 2, 3, 3),
              (2, 7, 5, 3, 3, 2), (1, 5, 4, 2, 3, 3)]


def _port(x, err, mode, ky, kx):
    xt = torch.from_numpy(x).requires_grad_()
    if mode == "avg":
        y = pooling.avg_pooling_reshape(xt, ky, kx)
    else:
        y = pooling.max_pooling_reshape(xt, ky, kx, mode == "maxabs")
    g, = torch.autograd.grad(y, xt, torch.from_numpy(err))
    return y.detach().numpy(), g.numpy()


def _jax(x, err, mode, ky, kx):
    if mode == "avg":
        def f(t):
            return jax_pooling.avg_pooling_reshape_jax(t, ky, kx)
    else:
        def f(t):
            return jax_pooling.max_pooling_reshape_jax(t, ky, kx,
                                                      mode == "maxabs")
    y, vjp = jax.vjp(f, jnp.asarray(x))
    g, = vjp(jnp.asarray(err))
    return numpy.asarray(y), numpy.asarray(g)


@pytest.mark.parametrize("dtype", [numpy.float32, numpy.float64])
@pytest.mark.parametrize("mode", ["max", "maxabs", "avg"])
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_forward_and_vjp_bit_equal_jax(geometry, mode, dtype):
    b, h, w, c, ky, kx = geometry
    r = numpy.random.RandomState(sum(geometry))
    x = r.randint(-2, 3, (b, h, w, c)).astype(dtype)
    ny, nx = pooling.output_spatial(h, w, ky, kx, (kx, ky))
    err = r.uniform(-1, 1, (b, ny, nx, c)).astype(dtype)
    y, g = _port(x, err, mode, ky, kx)
    jy, jg = _jax(x, err, mode, ky, kx)
    assert y.dtype == jy.dtype and g.dtype == jg.dtype
    if mode == "avg":
        # XLA folds the constant divisor into a product by its
        # reciprocal: one rounding apart
        eps = numpy.finfo(dtype).eps
        numpy.testing.assert_allclose(y, jy, rtol=2 * eps, atol=0)
        numpy.testing.assert_allclose(g, jg, rtol=2 * eps, atol=0)
    else:
        assert y.tobytes() == jy.tobytes()
        assert g.tobytes() == jg.tobytes()
        # each window's gradient lands on exactly one cell, its first
        # winner: the cell the plain max-pool kernel version records
        _, offsets = pooling.max_pooling_plain(
            torch.from_numpy(x), ky, kx, (kx, ky), mode == "maxabs")
        want = numpy.zeros(x.size, dtype)
        want[offsets.numpy().ravel()] = err.ravel()
        assert (g.ravel() == want).all()


def test_degenerate_maxabs_tie_routes_to_the_first_real_cell():
    """An overhanging 3x3 window over a 4x4 input whose real cells are
    all 0: its pad cells (|0| too) tie the winner.  The port excludes
    them from the backward's search; JAX compares them too, but the
    first real cell comes first, so both route the gradient there."""
    x = numpy.zeros((1, 4, 4, 1))
    x[0, :3, :3, 0] = numpy.arange(1, 10).reshape(3, 3)
    err = numpy.array([1.0, 2.0, 3.0, 4.0]).reshape(1, 2, 2, 1)
    y, g = _port(x, err, "maxabs", 3, 3)
    jy, jg = _jax(x, err, "maxabs", 3, 3)
    assert (y == jy).all() and (y[0, :, :, 0] == [[9, 0], [0, 0]]).all()
    want = numpy.zeros((4, 4))
    want[2, 2], want[0, 3], want[3, 0], want[3, 3] = 1.0, 2.0, 3.0, 4.0
    assert (g[0, :, :, 0] == want).all()
    assert (jg[0, :, :, 0] == want).all()


def _pool(tpe, k):
    return {"type": tpe, "->": {"kx": k, "ky": k, "sliding": (k, k)}}


def _layers():
    return [_conv("conv_tanh", 6, 3, 1, 1, 0.1), _pool("max_pooling", 2),
            _conv("conv_str", 8, 3, 0, 1, 0.1),
            _pool("maxabs_pooling", 3),
            _conv("conv", 6, 1, 0, 1, 0.1), _pool("avg_pooling", 2),
            _fc("softmax", 4, 0)]


def test_overlapping_windows_raise():
    layers = _layers() + []
    layers[1] = {"type": "max_pooling",
                 "->": {"kx": 3, "ky": 3, "sliding": (2, 2)}}
    for build in (fused.FusedNet, jax_fused.FusedNet):
        kwargs = {"device": "cpu"} if build is fused.FusedNet else {}
        with pytest.raises(ValueError, match="sliding == kernel"):
            build(layers, (21, 21, 3), pool_impl="reshape", **kwargs)


def test_fused_reshape_steps_match_jax_f64():
    shape = (21, 21, 3)
    jnet = jax_fused.FusedNet(_layers(), shape, dtype=numpy.float64,
                              rand=jax_prng.RandomGenerator().seed(5),
                              pool_impl="reshape")
    pnet = fused.FusedNet(_layers(), shape, dtype=numpy.float64,
                          rand=prng.RandomGenerator().seed(5),
                          pool_impl="reshape", device="cpu")
    assert {s.impl for s in pnet.specs if s.kind == "pool"} == {"reshape"}
    r = numpy.random.RandomState(6)
    for _ in range(3):
        x = r.uniform(-1, 1, (5,) + shape)
        lbl = r.randint(0, 4, 5).astype(numpy.int32)
        mj, mp = jnet.step(x, lbl), pnet.step(x, lbl)
        assert abs(float(mp["loss"]) - float(mj["loss"])) <= \
            1e-10 * abs(float(mj["loss"]))
        assert int(mp["n_err"]) == int(mj["n_err"])
    want, got = jnet.state_dict(), pnet.state_dict()
    for section in ("params", "opt"):
        for gl, wl in zip(jax.tree.leaves(got[section]),
                          jax.tree.leaves(want[section])):
            wl = numpy.asarray(wl)
            assert numpy.abs(numpy.asarray(gl) - wl).max() <= \
                1e-10 * numpy.abs(wl).max()


def test_reshape_equals_offsets_on_max_pools_f32():
    """On max pools (2x2/s2, 3x3/s3) the reshape lowering trains bit for
    bit like the kernels' lowering in float32: the same first winners,
    the same routed gradients."""
    layers = [_conv("conv_tanh", 6, 3, 1, 1, 0.1), _pool("max_pooling", 2),
              _conv("conv_str", 8, 3, 0, 1, 0.1), _pool("max_pooling", 3),
              _fc("softmax", 4, 0)]
    nets = [fused.FusedNet(layers, (21, 21, 3), pool_impl=impl,
                           rand=prng.RandomGenerator().seed(5), device="cpu")
            for impl in ("reshape", "offsets")]
    r = numpy.random.RandomState(7)
    for _ in range(3):
        x = r.uniform(-1, 1, (5, 21, 21, 3)).astype(numpy.float32)
        lbl = r.randint(0, 4, 5).astype(numpy.int32)
        a, b = (net.step(x, lbl) for net in nets)
        assert a["loss"].numpy().tobytes() == b["loss"].numpy().tobytes()
    for pa, pb in zip(nets[0].params, nets[1].params):
        for k in pa:
            assert pa[k].numpy().tobytes() == pb[k].numpy().tobytes()
