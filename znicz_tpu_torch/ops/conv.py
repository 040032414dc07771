"""Convolution forward and backward on NHWC tensors.

Counterpart of ``znicz_tpu/ops/conv.py`` (``forward_jax`` :56-64,
``backward_jax`` :67-83, ``deconv_forward_jax`` :87, ``deconv_hits_jax``
:121, ``deconv_backward_jax`` :149), which lowers through
``lax.conv_general_dilated`` and its VJP outside any Pallas kernel;
here the products are ``torch.nn.functional.conv2d`` and the
convolution's own backward (``aten.convolution_backward``, what
autograd and ``torch.nn.grad`` call), and the transposed convolution
``conv_transpose2d``.

Geometry (reference conv.py:57-140):

* ``x`` NHWC ``(batch, sy, sx, n_channels)``;
* ``weights`` ``(n_kernels, ky*kx*n_channels)``, flattened from
  ``(ky, kx, C)``;
* ``padding`` ``(left, top, right, bottom)``, zero padding;
* ``sliding`` ``(x, y)`` strides;
* output NHWC ``(batch, ny, nx, n_kernels)``.

Layout: an NHWC tensor permuted to NCHW is a ``channels_last`` view,
and so is ``weights`` reshaped to ``(K, ky, kx, C)`` and permuted to
``(K, C, ky, kx)``.  conv2d then runs in ``channels_last`` and its
output, permuted back, is NHWC again: no layout copies on the way in
or out.

:func:`forward_numpy` (JAX :176-203, with ``_pad_numpy`` and
``_patches_numpy``) is the numpy twin that ``export.run_package_numpy``
runs: the same patches in the same ``(ky, kx, C)`` order and one
product with the weights.
"""

import numpy
import torch
import torch.nn.functional as F

from znicz_tpu_torch.ops import activations


def output_spatial(sy, sx, ky, kx, padding, sliding):
    left, top, right, bottom = padding
    nx = (left + sx + right - kx) // sliding[0] + 1
    ny = (top + sy + bottom - ky) // sliding[1] + 1
    return ny, nx


def _pad_numpy(x, padding):
    left, top, right, bottom = padding
    return numpy.pad(x, ((0, 0), (top, bottom), (left, right), (0, 0)))


def _patches_numpy(xp, ky, kx, sliding, ny, nx):
    """im2col: ``(B, ny, nx, ky*kx*C)`` from the padded input, one
    strided slice a window cell."""
    b, _, _, c = xp.shape
    sx, sy = sliding
    cells = [xp[:, dy:dy + (ny - 1) * sy + 1:sy,
                dx:dx + (nx - 1) * sx + 1:sx, :]
             for dy in range(ky) for dx in range(kx)]
    return numpy.stack(cells, axis=3).reshape(b, ny, nx, ky * kx * c)


def forward_numpy(x, weights, bias, ky, kx, padding, sliding,
                  activation="linear", include_bias=True):
    """:func:`forward` on numpy arrays."""
    ny, nx = output_spatial(x.shape[1], x.shape[2], ky, kx, padding, sliding)
    patches = _patches_numpy(_pad_numpy(x, padding), ky, kx, sliding, ny, nx)
    y = patches @ weights.T
    if include_bias:
        y = y + bias
    return activations.apply_numpy(activation, y)


def _nchw(x, weights, ky, kx, padding):
    """``(x, w, pad)``: the channels_last NCHW views of NHWC ``x`` and of
    ``weights``, ``x`` padded when the padding is not symmetric (conv2d
    pads symmetrically only), and conv2d's own padding."""
    w = weights.reshape(weights.shape[0], ky, kx, x.shape[3]).permute(
        0, 3, 1, 2)
    xn = x.permute(0, 3, 1, 2)
    left, top, right, bottom = padding
    if left == right and top == bottom:
        return xn, w, (top, left)
    return F.pad(xn, (left, right, top, bottom)), w, (0, 0)


def forward(x, weights, bias, ky, kx, padding, sliding,
            activation="linear", include_bias=True):
    """NHWC conv + bias + activation; returns a contiguous NHWC tensor."""
    xn, w, pad = _nchw(x, weights, ky, kx, padding)
    y = F.conv2d(xn, w, bias if include_bias else None,
                 stride=(sliding[1], sliding[0]), padding=pad)
    # a no-op when conv2d kept channels_last (the expected case)
    return activations.apply(activation, y.permute(0, 2, 3, 1)).contiguous()


def backward(inp, err_output, weights, ky, kx, padding, sliding,
             need_err_input=True, include_bias=True):
    """``(err_input, grad_weights, grad_bias)`` of the linear conv: the
    input gradient in NHWC (None unless ``need_err_input``), the
    weights' gradient ``(K, ky*kx*C)`` and the bias's (None unless
    ``include_bias``), as the JAX package's VJP gives them."""
    xn, w, pad = _nchw(inp, weights, ky, kx, padding)
    en = err_output.permute(0, 3, 1, 2)
    gx, gw, _ = torch.ops.aten.convolution_backward(
        en, xn, w, None, [sliding[1], sliding[0]], list(pad), [1, 1], False,
        [0, 0], 1, [bool(need_err_input), True, False])
    if gx is not None:
        left, top, right, bottom = padding
        if (left, top) != (right, bottom):
            gx = gx[:, :, top:top + inp.shape[1], left:left + inp.shape[2]]
        gx = gx.permute(0, 2, 3, 1).contiguous()
    grad_w = gw.permute(0, 2, 3, 1).reshape(weights.shape)
    grad_b = err_output.sum(dim=(0, 1, 2)) if include_bias else None
    return gx, grad_w, grad_b


def deconv_forward(x, weights, ky, kx, padding, sliding, out_shape):
    """The transposed convolution of NHWC ``x (B, ny, nx, K)`` with the
    conv weights ``(K, ky*kx*C)``, as scatter-then-crop: window
    ``(i, j)`` adds ``x[i, j] @ W`` at ``(i*sy, j*sx)`` of a
    ``((ny-1)*sy + ky, (nx-1)*sx + kx)`` canvas, zero-extended
    right/bottom where ``padding`` asks for more, and the canvas is
    cropped to ``out_shape[1:3]`` from ``(top, left)``.  A
    ``conv_transpose2d`` with ``output_padding`` would refuse some
    autoencoder geometries (MNIST's 24 -> 28 with padding 4); the canvas
    takes any."""
    b, ny, nx, k = x.shape
    left, top = padding[0], padding[1]
    c, h, w = out_shape[3], out_shape[1], out_shape[2]
    w4 = weights.reshape(k, ky, kx, c).permute(0, 3, 1, 2)
    canvas = F.conv_transpose2d(x.permute(0, 3, 1, 2), w4,
                                stride=(sliding[1], sliding[0]))
    pad_y = max(0, top + h - canvas.shape[2])
    pad_x = max(0, left + w - canvas.shape[3])
    if pad_y or pad_x:
        canvas = F.pad(canvas, (0, pad_x, 0, pad_y))
    return canvas[:, :, top:top + h, left:left + w].permute(
        0, 2, 3, 1).contiguous()


def deconv_hits(batch_ny_nx, ky, kx, padding, sliding, out_shape,
                dtype=torch.float32, device=None):
    """``(B, H, W)``: how many windows of :func:`deconv_forward` add into
    each output cell (the reference Deconv's ``hits``)."""
    b, ny, nx = batch_ny_nx
    ones = torch.ones((b, ny, nx, 1), dtype=dtype, device=device)
    w1 = torch.ones((1, ky * kx), dtype=dtype, device=device)
    return deconv_forward(ones, w1, ky, kx, padding, sliding,
                          (b, out_shape[1], out_shape[2], 1))[..., 0]


def deconv_backward(inp, err_output, weights, ky, kx, padding, sliding):
    """``(err_input, grad_weights)``: the gradient of
    :func:`deconv_forward` (undivided by any hits) with respect to its
    input ``inp (B, ny, nx, K)`` and to the weights, for the output
    gradient ``err_output (B, H, W, C)``."""
    with torch.enable_grad():
        x = inp.detach().requires_grad_()
        w = weights.detach().requires_grad_()
        y = deconv_forward(x, w, ky, kx, padding, sliding,
                           tuple(err_output.shape))
        gx, gw = torch.autograd.grad(y, (x, w), err_output)
    return gx, gw
