"""Local response normalization (AlexNet/Caffe cross-channel LRN),
forward and backward, on NHWC tensors.

Counterpart of ``znicz_tpu/ops/normalization.py`` (``lrn_forward_jax``
:21-50, ``lrn_backward_jax`` :53): with
``s_i = k + alpha * sum_{j in window(i)} x_j^2`` over the channel
window ``[i - n//2, i + n//2]``, ``y_i = x_i / s_i^beta``.  The
windowed channel sum is one product with a (C, C) 0/1 band matrix on
the channel axis, as in the JAX package.  :func:`lrn_forward_numpy`
(JAX :62-77) is the numpy twin that ``export.run_package_numpy`` runs.
"""

import numpy
import torch


def _band_matrix(c, n, dtype, device):
    """(c, c) 0/1 band: M[i, j] = 1 iff j is inside i's channel window."""
    idx = torch.arange(c, device=device)
    return ((idx[:, None] - idx[None, :]).abs() <= n // 2).to(dtype)


def _subsums_numpy(src, n):
    c = src.shape[3]
    out = numpy.empty_like(src)
    half = n // 2
    for i in range(c):
        lo = max(0, i - half)
        hi = min(i + half, c - 1)
        out[:, :, :, i] = src[:, :, :, lo:hi + 1].sum(axis=3)
    return out


def lrn_forward_numpy(x, alpha=1e-4, beta=0.75, k=2, n=5):
    """:func:`lrn_forward` on a numpy array."""
    s = k + alpha * _subsums_numpy(numpy.square(x), n)
    return x / numpy.power(s, beta)


def lrn_forward(x, alpha=1e-4, beta=0.75, k=2, n=5):
    m = _band_matrix(x.shape[3], n, x.dtype, x.device)
    s = k + alpha * (torch.square(x) @ m)
    return x / torch.pow(s, beta)


def lrn_backward(x, err_output, alpha=1e-4, beta=0.75, k=2, n=5):
    """The input gradient of :func:`lrn_forward` (autograd over it)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        y = lrn_forward(xg, alpha, beta, k, n)
        return torch.autograd.grad(y, xg, err_output)[0]
