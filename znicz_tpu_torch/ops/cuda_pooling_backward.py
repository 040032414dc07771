"""Wrapper of the hand-written Hopper max-pooling backward kernel
(``znicz_tpu_torch/csrc/max_pooling_offsets_backward.cu``).

Counterpart of ``znicz_tpu/ops/pooling.py::_maxpool_bwd_dense`` (:118),
the backward of the fused path's "offsets" pooling: each input cell
receives the gradients of the windows whose recorded winner it is,
summed from +0.0 over the window offsets dy then dx ascending.  Each
thread owns one cell (and a 16-byte vector of channels where C and the
three addresses allow it, one channel otherwise) and writes it once,
so there are no atomics and the bits are the same on every run; they
equal those of its plain PyTorch version,
:func:`znicz_tpu_torch.ops.pooling.max_pooling_backward_plain`.

Bound: memory — the gradient and the offsets read once plus the input
gradient written once, over the H100's 3.35 TB/s.

The library is built by :mod:`znicz_tpu_torch.ops.cuda_build` at the
first launch and loaded with ``ctypes``.  ``LAUNCHES`` counts the
kernel's launches; nothing else adds to it.
"""

import ctypes
import threading

import torch

from znicz_tpu_torch.ops import cuda_build
from znicz_tpu_torch.ops.pooling import output_spatial

SOURCE = "max_pooling_offsets_backward.cu"
#: the JAX function this kernel takes the place of (file:line)
REPLACES = "znicz_tpu/ops/pooling.py:118"

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
            lib.max_pooling_offsets_backward.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12 +
                [ctypes.c_void_p])
            lib.max_pooling_offsets_backward.restype = ctypes.c_int
            fn = lib.max_pooling_offsets_backward_error_string
            fn.argtypes = [ctypes.c_int]
            fn.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def vector_width(err, offsets, grad):
    """Channels each thread owns: a 16-byte vector of ``err``'s type (4
    in float32, 8 in float16/bfloat16) when C and the three tensors'
    addresses allow 16-byte accesses to both ``err``/``grad`` and the
    int32 offsets, else 1."""
    vec = 16 // err.element_size()
    if err.shape[-1] % vec == 0 and all(
            t.data_ptr() % 16 == 0 for t in (err, offsets, grad)):
        return vec
    return 1


def _check(err, offsets, x_shape, ky, kx, sliding):
    """Raise on what the kernel does not take (the device last, so that
    the other guards are testable on the CPU)."""
    if err.dtype not in _DTYPES:
        raise TypeError("max_pooling_offsets_backward takes float32, "
                        "float16 or bfloat16, got %s" % err.dtype)
    if offsets.dtype != torch.int32:
        raise TypeError("offsets must be int32, got %s" % offsets.dtype)
    if err.dim() != 4 or offsets.shape != err.shape or len(x_shape) != 4:
        raise ValueError("err and offsets must be one NHWC (4-D) shape and "
                         "x_shape 4-D, got %s, %s and %s"
                         % (tuple(err.shape), tuple(offsets.shape),
                            tuple(x_shape)))
    n = 1
    for s in x_shape:
        n *= int(s)
    if max(n, err.numel()) >= 2 ** 31:
        raise ValueError("max_pooling_offsets_backward: %d elements "
                         "overflow the int32 offsets" % max(n, err.numel()))
    if not (err.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("max_pooling_offsets_backward needs contiguous "
                         "NHWC tensors")
    if min(ky, kx, sliding[0], sliding[1]) < 1:
        raise ValueError("window %dx%d and sliding %s must be positive"
                         % (ky, kx, tuple(sliding)))
    b, h, w, c = x_shape
    if (err.shape[0], err.shape[3]) != (b, c) or tuple(err.shape[1:3]) != \
            output_spatial(h, w, ky, kx, sliding):
        raise ValueError("err %s is not the %dx%d/%s pooling of %s"
                         % (tuple(err.shape), ky, kx, tuple(sliding),
                            tuple(x_shape)))
    if not (err.is_cuda and offsets.is_cuda):
        raise ValueError("max_pooling_offsets_backward needs CUDA tensors, "
                         "got %s and %s" % (err.device, offsets.device))
    if err.device != offsets.device:
        raise ValueError("err and offsets lie on different devices")


def max_pooling_offsets_backward(err, offsets, x_shape, ky, kx, sliding):
    """The input gradient ``(B, H, W, C)`` = ``x_shape`` of a max pool
    whose forward recorded ``offsets``, on the card.

    ``err`` and ``offsets`` are contiguous ``(B, ny, nx, C)`` CUDA
    tensors, ``err`` float32, float16 or bfloat16 and ``offsets``
    int32, with fewer than 2^31 elements in the input.  Launches on the
    current stream without synchronising; raises if the launch is
    refused."""
    global LAUNCHES
    ky, kx = int(ky), int(kx)
    sx, sy = int(sliding[0]), int(sliding[1])
    b, h, w, c = (int(s) for s in x_shape)
    _check(err, offsets, (b, h, w, c), ky, kx, (sx, sy))
    grad = torch.empty((b, h, w, c), dtype=err.dtype, device=err.device)
    if grad.numel() == 0:
        return grad
    vec = vector_width(err, offsets, grad)
    lib = _lib or load()
    with torch.cuda.device(err.device):
        stream = torch.cuda.current_stream(err.device).cuda_stream
        code = lib.max_pooling_offsets_backward(
            err.data_ptr(), offsets.data_ptr(), grad.data_ptr(),
            _DTYPES[err.dtype], vec, b, h, w, c, err.shape[1], err.shape[2],
            ky, kx, sy, sx, stream)
    if code:
        raise RuntimeError(
            "max_pooling_offsets_backward launch failed: %s"
            % lib.max_pooling_offsets_backward_error_string(code).decode())
    LAUNCHES += 1
    return grad
