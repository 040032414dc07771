"""Pooling forward on NHWC tensors: max / maxabs with winner offsets,
and avg.

Counterpart of ``znicz_tpu/ops/pooling.py`` (``output_spatial`` :29,
``max_pooling_jax`` :77-94, ``pooling_fwd_jax`` :313-351), with the
reference semantics:

* ``sliding`` is ``(x, y)``; the output size is ceil-mode,
  ``out = ceil((s - k) / stride) + 1``, so windows may overhang the
  right/bottom edge and are then truncated;
* max/maxabs return the window value (signed for maxabs) and the
  winner's FLAT NHWC input offset ``((b*H + wy)*W + wx)*C + c`` as
  int32.  Ties go to the FIRST cell in row-major window order (dy
  outer, dx inner); overhanging cells never win;
* avg divides by the TRUNCATED window size.

:func:`max_pooling` launches the hand-written CUDA kernel
(:mod:`znicz_tpu_torch.ops.cuda_pooling`) for a CUDA tensor and runs
:func:`max_pooling_plain` for a CPU tensor.  There is no fallback from
the kernel to the plain version: on the card it launches or raises.
"""

import torch
import torch.nn.functional as F


def output_spatial(sy, sx, ky, kx, sliding):
    """Ceil-mode output geometry ``(ny, nx)`` (reference
    pooling.py:96-105)."""
    outs = []
    for last, stride in ((sx - kx, sliding[0]), (sy - ky, sliding[1])):
        o = last // stride + 1
        if last % stride != 0:
            o += 1
        outs.append(o)
    return outs[1], outs[0]


def _windows(x, ky, kx, sliding, fill):
    """``(B, ny, nx, C, ky*kx)`` window view of ``x`` padded
    right/bottom with ``fill`` so every ceil-mode window exists; the
    last axis is in row-major window order (dy outer, dx inner)."""
    b, h, w, c = x.shape
    ny, nx = output_spatial(h, w, ky, kx, sliding)
    pad_y = (ny - 1) * sliding[1] + ky - h
    pad_x = (nx - 1) * sliding[0] + kx - w
    xp = F.pad(x, (0, 0, 0, pad_x, 0, pad_y), value=fill)
    win = xp.unfold(1, ky, sliding[1]).unfold(2, kx, sliding[0])
    return win.reshape(b, ny, nx, c, ky * kx), ny, nx


def _flat_offsets(shape, ny, nx, kx, sliding, q):
    """Flat NHWC input offset (int64) of window cell ``q`` of each
    output ``(B, ny, nx, C)``."""
    b, h, w, c = shape
    dev = q.device
    wy = torch.arange(ny, device=dev).view(1, ny, 1, 1) * sliding[1] + \
        torch.div(q, kx, rounding_mode="floor")
    wx = torch.arange(nx, device=dev).view(1, 1, nx, 1) * sliding[0] + \
        q % kx
    bi = torch.arange(b, device=dev).view(b, 1, 1, 1)
    ci = torch.arange(c, device=dev).view(1, 1, 1, c)
    return ((bi * h + wy) * w + wx) * c + ci


def max_pooling_plain(x, ky, kx, sliding, use_abs=False):
    """The plain PyTorch version of the max-pooling kernel:
    ``(values, int32 offsets)``.

    Keys (``|x|`` for maxabs) are compared in at least float32 — exact
    for f16/bf16 inputs — with overhanging cells masked to ``-inf``;
    ``argmax`` returns the first maximal cell, which is the
    first-winner tie rule.  A window wholly past the edge (only when
    the stride exceeds the window) yields 0 at its origin offset, as
    the TPU kernel does."""
    key = torch.abs(x) if use_abs else x
    key = key.to(torch.promote_types(x.dtype, torch.float32))
    kwin, ny, nx = _windows(key, ky, kx, sliding, float("-inf"))
    q = torch.argmax(kwin, dim=4)
    vwin, _, _ = _windows(x, ky, kx, sliding, 0.0)
    values = torch.gather(vwin, 4, q.unsqueeze(4)).squeeze(4)
    offsets = _flat_offsets(x.shape, ny, nx, kx, sliding, q)
    return values, offsets.to(torch.int32)


def max_pooling(x, ky, kx, sliding, use_abs=False):
    """``(values, int32 flat winner offsets)`` — the kernel for a CUDA
    tensor, :func:`max_pooling_plain` for a CPU tensor."""
    if x.is_cuda:
        from znicz_tpu_torch.ops import cuda_pooling
        return cuda_pooling.max_pooling_offsets(x, ky, kx, sliding,
                                                use_abs)
    if x.device.type != "cpu":
        raise ValueError("max_pooling: no path for device %s" % x.device)
    return max_pooling_plain(x, ky, kx, sliding, use_abs)


def _trunc_divisor(sy, sx, ky, kx, sliding, ny, nx, dtype, device):
    """Truncated-window element counts ``(ny, nx)`` — the reference's
    avg divisor (pooling.py:548)."""
    t_y = torch.clamp(sy - torch.arange(ny, device=device) * sliding[1],
                      max=ky)
    t_x = torch.clamp(sx - torch.arange(nx, device=device) * sliding[0],
                      max=kx)
    return (t_y[:, None] * t_x[None, :]).to(dtype)


def avg_pooling(x, ky, kx, sliding):
    """Ceil-mode avg pooling with the truncated-window divisor."""
    b, h, w, c = x.shape
    win, ny, nx = _windows(x, ky, kx, sliding, 0.0)
    cnt = _trunc_divisor(h, w, ky, kx, sliding, ny, nx, x.dtype, x.device)
    return win.sum(dim=4) / cnt[None, :, :, None]
