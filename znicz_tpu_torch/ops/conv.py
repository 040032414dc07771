"""Convolution forward on NHWC tensors.

Counterpart of ``znicz_tpu/ops/conv.py`` (``forward_jax`` :56-64),
which lowers through ``lax.conv_general_dilated`` outside any Pallas
kernel; here the product is ``torch.nn.functional.conv2d``.

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
"""

import torch.nn.functional as F

from znicz_tpu_torch.ops import activations


def output_spatial(sy, sx, ky, kx, padding, sliding):
    left, top, right, bottom = padding
    nx = (left + sx + right - kx) // sliding[0] + 1
    ny = (top + sy + bottom - ky) // sliding[1] + 1
    return ny, nx


def forward(x, weights, bias, ky, kx, padding, sliding,
            activation="linear", include_bias=True):
    """NHWC conv + bias + activation; returns a contiguous NHWC tensor."""
    w = weights.reshape(weights.shape[0], ky, kx, x.shape[3]).permute(
        0, 3, 1, 2)
    xn = x.permute(0, 3, 1, 2)
    left, top, right, bottom = padding
    if left == right and top == bottom:
        pad = (top, left)
    else:
        # conv2d pads symmetrically only
        xn = F.pad(xn, (left, right, top, bottom))
        pad = 0
    y = F.conv2d(xn, w, bias if include_bias else None,
                 stride=(sliding[1], sliding[0]), padding=pad)
    # a no-op when conv2d kept channels_last (the expected case)
    return activations.apply(activation, y.permute(0, 2, 3, 1)).contiguous()
