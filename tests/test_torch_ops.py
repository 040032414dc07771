"""The port's dense, conv, LRN and activation ops against the JAX
package's ``*_jax`` functions on the CPU, float32, rtol 1e-5 / atol
1e-6: the tolerance covers a different summation order in the
products, nothing else."""

import numpy
import pytest
import torch

from znicz_tpu.ops import activations as jax_act
from znicz_tpu.ops import conv as jax_conv
from znicz_tpu.ops import dense as jax_dense
from znicz_tpu.ops import normalization as jax_norm
from znicz_tpu_torch.ops import activations, conv, dense, normalization

TOL = dict(rtol=1e-5, atol=1e-6)


def _close(got, want):
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want), **TOL)


def _x(shape, seed, scale=1.0):
    return (numpy.random.RandomState(seed).uniform(-1, 1, shape) *
            scale).astype(numpy.float32)


@pytest.mark.parametrize("name", ["linear", "tanh", "relu", "strict_relu",
                                  "sigmoid"])
def test_activation_matches_jax(name):
    # the softplus seam at 15 and both sides of it, plus a wide spread
    x = numpy.concatenate([
        numpy.array([-20, -1e-3, 0, 1e-3, 14.9, 15, 15.1, 30],
                    numpy.float32), _x(64, 1, 20)]).reshape(8, 9)
    _close(activations.apply(name, torch.from_numpy(x)),
           jax_act.apply_jax(name, x))


def test_tanh_is_scaled_and_relu_is_softplus():
    x = torch.tensor([-2.0, 0.5, 3.0, 15.0, 16.0])
    torch.testing.assert_close(activations.apply("tanh", x),
                               1.7159 * torch.tanh(0.6666 * x))
    relu = activations.apply("relu", x)
    torch.testing.assert_close(relu[:4], torch.log1p(torch.exp(x[:4])))
    assert relu[4].item() == 16.0  # identity past the seam


@pytest.mark.parametrize("name", ["log", "tanhlog", "sincos"])
def test_ext_activation_matches_jax(name):
    x = _x((4, 3, 5), 2, 6)  # spans tanhlog's |x| > 3 branches
    _close(activations.ext_apply(name, torch.from_numpy(x)),
           jax_act.ext_apply_jax(name, x))


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("act", ["linear", "tanh", "strict_relu"])
def test_dense_forward_and_softmax_match_jax(transposed, act):
    x = _x((5, 2, 3, 4), 3)  # flattened to (5, 24) like a conv output
    w = _x((24, 7) if transposed else (7, 24), 4)
    b = _x((7,), 5)
    y = dense.forward(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b), activation=act,
                      weights_transposed=transposed)
    yj = jax_dense.forward_jax(x, w, b, activation=act,
                               weights_transposed=transposed)
    _close(y, yj)
    s, idx = dense.softmax(y)
    sj, idxj = jax_dense.softmax_jax(numpy.asarray(yj))
    _close(s, sj)
    assert idx.dtype == torch.int32
    assert (idx.numpy() == numpy.asarray(idxj)).all()


@pytest.mark.parametrize("padding,sliding", [
    ((1, 2, 0, 1), (2, 1)),    # asymmetric padding, strides (x=2, y=1)
    ((1, 1, 1, 1), (1, 1)),
    ((0, 0, 0, 0), (2, 3)),
])
@pytest.mark.parametrize("act", ["linear", "relu", "strict_relu"])
def test_conv_forward_matches_jax(padding, sliding, act):
    ky, kx, c, k = 3, 2, 3, 4
    x = _x((2, 7, 6, c), 6)
    w = _x((k, ky * kx * c), 7)
    b = _x((k,), 8)
    y = conv.forward(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b), ky, kx, padding, sliding,
                     activation=act)
    yj = jax_conv.forward_jax(x, w, b, ky, kx, padding, sliding,
                              activation=act)
    assert tuple(y.shape) == tuple(yj.shape) == \
        (2,) + conv.output_spatial(7, 6, ky, kx, padding, sliding) + (k,)
    assert y.is_contiguous()
    _close(y, yj)


@pytest.mark.parametrize("c,n,k", [(8, 5, 2.0), (7, 3, 1.0)])
def test_lrn_forward_matches_jax(c, n, k):
    x = _x((2, 3, 4, c), 9, 10)
    y = normalization.lrn_forward(torch.from_numpy(x), alpha=1e-4,
                                  beta=0.75, k=k, n=n)
    _close(y, jax_norm.lrn_forward_jax(x, alpha=1e-4, beta=0.75, k=k, n=n))


# -- gradients, float64: autograd of the port against jax.vjp ----------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

GRAD_TOL = dict(rtol=1e-12, atol=1e-15)


def _vjp_pair(port_fn, jax_fn, args, seed):
    """Port autograd and jax.vjp of the same function, same float64
    inputs and cotangent; returns (port grads, jax grads)."""
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y = port_fn(*ts)
    ct = numpy.random.RandomState(seed).uniform(-1, 1, tuple(y.shape))
    got = torch.autograd.grad(y, ts, torch.from_numpy(ct))
    yj, vjp = jax.vjp(jax_fn, *[jnp.asarray(a) for a in args])
    numpy.testing.assert_allclose(y.detach().numpy(), numpy.asarray(yj),
                                  **GRAD_TOL)
    return [g.numpy() for g in got], [numpy.asarray(g) for g in vjp(ct)]


@pytest.mark.parametrize("name", ["linear", "tanh", "relu", "strict_relu",
                                  "sigmoid"])
def test_activation_gradient_matches_jax(name):
    """Through the output, with the reference's rounded constants (tanh's
    derivative cancels to ~1e-10 at |x| = 20, where the 1-ulp difference
    of the two libraries' tanh shows: hence the atol); strict relu's
    gradient at 0 is 0, as the JAX package pins it."""
    x = numpy.concatenate([[-20.0, -1e-3, 0.0, 0.0, 1e-3, 14.9, 15.0, 15.1],
                           numpy.random.RandomState(1).uniform(-20, 20, 64)])
    got, want = _vjp_pair(lambda t: activations.apply(name, t),
                          lambda a: jax_act.apply_jax(name, a), [x], 2)
    numpy.testing.assert_allclose(got[0], want[0], **GRAD_TOL)
    if name == "strict_relu":
        assert (got[0][2:4] == 0).all()


@pytest.mark.parametrize("padding,sliding", [
    ((1, 2, 0, 1), (2, 1)), ((2, 2, 2, 2), (1, 1)), ((0, 0, 0, 0), (4, 4))])
def test_conv_gradients_match_jax(padding, sliding):
    """Input, weights ``(K, ky*kx*C)`` and bias gradients of the conv in
    the JAX package's layouts."""
    ky, kx, c, k = 3, 3, 4, 6
    r = numpy.random.RandomState(3)
    args = [r.uniform(-1, 1, (2, 9, 8, c)), r.uniform(-1, 1, (k, ky * kx * c)),
            r.uniform(-1, 1, (k,))]
    got, want = _vjp_pair(
        lambda x, w, b: conv.forward(x, w, b, ky, kx, padding, sliding),
        lambda x, w, b: jax_conv.forward_jax(x, w, b, ky, kx, padding,
                                             sliding), args, 4)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        numpy.testing.assert_allclose(g, w, **GRAD_TOL)


@pytest.mark.parametrize("c,n", [(12, 5), (7, 3)])
def test_lrn_gradient_matches_jax_autodiff(c, n):
    """The fused path differentiates ``lrn_forward_jax`` by autodiff;
    the port's autograd of the same band-matrix product agrees."""
    x = numpy.random.RandomState(5).uniform(-3, 3, (2, 3, 4, c))
    got, want = _vjp_pair(
        lambda t: normalization.lrn_forward(t, 1e-4, 0.75, 2, n),
        lambda a: jax_norm.lrn_forward_jax(a, alpha=1e-4, beta=0.75, k=2,
                                           n=n), [x], 6)
    numpy.testing.assert_allclose(got[0], want[0], **GRAD_TOL)


def test_dense_gradients_match_jax():
    r = numpy.random.RandomState(7)
    args = [r.uniform(-1, 1, (5, 2, 3, 4)), r.uniform(-1, 1, (7, 24)),
            r.uniform(-1, 1, (7,))]
    got, want = _vjp_pair(
        lambda x, w, b: dense.forward(x, w, b, activation="tanh"),
        lambda x, w, b: jax_dense.forward_jax(x, w, b, activation="tanh"),
        args, 8)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        numpy.testing.assert_allclose(g, w, **GRAD_TOL)
