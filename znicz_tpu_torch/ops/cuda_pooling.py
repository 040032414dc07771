"""Wrapper of the hand-written Hopper max-pooling kernel
(``znicz_tpu_torch/csrc/max_pooling_offsets.cu``).

Replaces the TPU kernel
``znicz_tpu/ops/pallas_pooling.py::max_pooling_offsets_pallas``
(``pl.pallas_call`` at :97, body ``_kernel`` :24-80): ceil-mode max or
maxabs pooling over NHWC returning the window value and the int32
flat NHWC winner offset, first winner on ties.

Bound: memory — the input read once plus values and offsets written
once, over the H100's 3.35 TB/s.  Design: one thread per output
element with channels fastest (coalesced NHWC loads), a loop over the
truncated window seeded by its origin cell, a strict ``>`` on float32
keys; see the source for details.  Its plain PyTorch version is
:func:`znicz_tpu_torch.ops.pooling.max_pooling_plain`.

The library is built by :mod:`znicz_tpu_torch.ops.cuda_build` at the
first launch and loaded with ``ctypes``.  ``LAUNCHES`` counts the
kernel's launches; nothing else adds to it.
"""

import ctypes
import threading

import torch

from znicz_tpu_torch.ops import cuda_build
from znicz_tpu_torch.ops.pooling import output_spatial

SOURCE = "max_pooling_offsets.cu"
#: TPU kernel this one replaces (file:line of its pl.pallas_call)
REPLACES = "znicz_tpu/ops/pallas_pooling.py:97"

#: launches of the kernel since the counter was last set to 0
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_lib = None
_lock = threading.Lock()


def load():
    """Build (at first use) and load the kernel's library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(cuda_build.build(SOURCE))
            lib.max_pooling_offsets.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12 +
                [ctypes.c_void_p])
            lib.max_pooling_offsets.restype = ctypes.c_int
            lib.max_pooling_offsets_error_string.argtypes = [ctypes.c_int]
            lib.max_pooling_offsets_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def max_pooling_offsets(x, ky, kx, sliding, use_abs=False):
    """``(values, int32 offsets)`` of ``x`` (B, H, W, C) on the card.

    ``x`` must be a contiguous 4-D CUDA tensor of float32, float16 or
    bfloat16 with fewer than 2^31 elements (int32 offsets).  Launches
    on the current stream without synchronising; raises if the launch
    is refused."""
    global LAUNCHES
    if not x.is_cuda:
        raise ValueError("max_pooling_offsets needs a CUDA tensor, got %s"
                         % x.device)
    if x.dtype not in _DTYPES:
        raise TypeError("max_pooling_offsets takes float32, float16 or "
                        "bfloat16, got %s" % x.dtype)
    if x.dim() != 4:
        raise ValueError("max_pooling_offsets takes NHWC (4-D) input, "
                         "got shape %s" % (tuple(x.shape),))
    if not x.is_contiguous():
        raise ValueError("max_pooling_offsets needs a contiguous NHWC "
                         "tensor")
    if x.numel() >= 2 ** 31:
        raise ValueError("max_pooling_offsets: %d elements overflow the "
                         "int32 offsets" % x.numel())
    ky, kx = int(ky), int(kx)
    sx, sy = int(sliding[0]), int(sliding[1])
    if min(ky, kx, sx, sy) < 1:
        raise ValueError("window %dx%d and sliding %s must be positive"
                         % (ky, kx, tuple(sliding)))
    b, h, w, c = x.shape
    ny, nx = output_spatial(h, w, ky, kx, (sx, sy))
    values = torch.empty((b, ny, nx, c), dtype=x.dtype, device=x.device)
    offsets = torch.empty((b, ny, nx, c), dtype=torch.int32,
                          device=x.device)
    if values.numel() == 0:
        return values, offsets
    lib = load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.max_pooling_offsets(
            x.data_ptr(), values.data_ptr(), offsets.data_ptr(),
            _DTYPES[x.dtype], b, h, w, c, ny, nx, ky, kx, sy, sx,
            int(bool(use_abs)), stream)
    if err:
        raise RuntimeError(
            "max_pooling_offsets launch failed: %s"
            % lib.max_pooling_offsets_error_string(err).decode())
    LAUNCHES += 1
    return values, offsets
