"""Wrapper of the hand-written Hopper max-pooling kernel
(``znicz_tpu_torch/csrc/max_pooling_offsets.cu``).

Replaces the TPU kernel
``znicz_tpu/ops/pallas_pooling.py::max_pooling_offsets_pallas``
(``pl.pallas_call`` at :97, body ``_kernel`` :24-80): ceil-mode max or
maxabs pooling over NHWC returning the window value and the int32
flat NHWC winner offset, first winner on ties.

Bound: memory — the input read once plus values and offsets written
once, over the H100's 3.35 TB/s.  Design (details in the source): a
3-D grid of channel slab x tile of output rows x batch row, with int32
index arithmetic and no division; each block stages its input rows
once in shared memory with 16-byte ``cp.async`` and every overlapping
window reads them there; each thread owns a 16-byte vector of channels
and stores values and offsets as 16-byte vectors.  A window too large
for shared memory runs the kernel's unstaged instantiation, which reads
each window from device memory.  float64 compares its keys in double.
Its plain PyTorch version is
:func:`znicz_tpu_torch.ops.pooling.max_pooling_plain`.

Before each launch the wrapper chooses, from shape and alignment
alone, the vector width (:func:`vector_width`) and the tiles
(:func:`launch_plan`); nothing is chosen on a failed launch, which
raises.  The library is built by :mod:`znicz_tpu_torch.ops.cuda_build`
at the first launch and loaded with ``ctypes``.  ``LAUNCHES_WIDE``
(16-byte vectors) and ``LAUNCHES_NARROW`` (one channel a thread) count
the kernel's launches by width, ``LAUNCHES`` their sum and
``LAUNCHES_BY_DTYPE`` by the values' dtype; nothing else adds to them.
Each launch reports its work (:func:`work`) to the
profiler's cost registry, which cannot see a ctypes launch.
"""

import collections
import ctypes
import functools

import torch

from znicz_tpu_torch.analysis import locksmith
from znicz_tpu_torch.core import profiler
from znicz_tpu_torch.ops import cuda_build
from znicz_tpu_torch.ops.pooling import output_spatial

SOURCE = "max_pooling_offsets.cu"
#: TPU kernel this one replaces (file:line of its pl.pallas_call)
REPLACES = "znicz_tpu/ops/pallas_pooling.py:97"

#: launches of the kernel since the counters were last set to 0: at
#: 16-byte vectors, at one channel a thread, and both together
LAUNCHES_WIDE = 0
LAUNCHES_NARROW = 0
LAUNCHES = 0
#: the same launches by the values' dtype ("float32", "bfloat16", ...)
LAUNCHES_BY_DTYPE = collections.Counter()

#: shared memory a block's tile takes at most, so that the 227 KB an
#: H100 SM gives its blocks never limits how many share it (registers
#: do); chip_smoke.py times the kernel at 16-64 KB
TILE_BYTES = 32 * 1024
#: the most shared memory a block may take (the kernel's kMaxSmem)
MAX_SMEM = 227 * 1024
#: bytes of channels one block spans: a 128-byte line of each cell
SLAB_BYTES = 128

#: one launch's tiles: ``lanes`` threads across a channel slab, ``ti``
#: output rows and ``tj`` output columns a tile, ``smem`` bytes of it;
#: ``staged`` False for a window that no shared memory holds, which the
#: unstaged instantiation reads from device memory (``smem`` 0)
Plan = collections.namedtuple("Plan", "lanes ti tj smem staged",
                              defaults=(True,))

_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
           torch.float64: 3}
_lib = None
_lock = locksmith.lock("ops.cuda_pooling.build")


def load():
    """Build (at first use) and load the kernel's library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(cuda_build.build(SOURCE))
            lib.max_pooling_offsets.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 17 +
                [ctypes.c_void_p])
            lib.max_pooling_offsets.restype = ctypes.c_int
            lib.max_pooling_offsets_error_string.argtypes = [ctypes.c_int]
            lib.max_pooling_offsets_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def vector_width(x):
    """Channels each thread owns for NHWC ``x``: a 16-byte vector (2 in
    float64, 4 in float32, 8 in float16/bfloat16) when the channel count and the
    storage's address are both multiples of 16 bytes, else 1."""
    nbytes = x.element_size()
    if x.shape[-1] * nbytes % 16 == 0 and x.data_ptr() % 16 == 0:
        return 16 // nbytes
    return 1


@functools.lru_cache(maxsize=256)
def launch_plan(shape, itemsize, vec, ky, kx, sliding):
    """The :data:`Plan` of one launch on NHWC ``shape``.

    A slab spans ``SLAB_BYTES`` of channels (fewer when C is small); a
    tile spans all output columns unless one row of windows overflows
    ``TILE_BYTES``, and as many output rows as fit in it, evened out
    over the tiles.  Where even one window does not fit in shared
    memory, the plan is the unstaged instantiation's: a slab of
    ``SLAB_BYTES``, one output row and all output columns a block."""
    _, h, w, c = shape
    ny, nx = output_spatial(h, w, ky, kx, sliding)
    sx, sy = sliding
    pack = vec * itemsize
    lanes = min(SLAB_BYTES // pack, -(-c // vec))

    def row_bytes(tj, lanes):  # one input row of a tile
        return min(w, (tj - 1) * sx + kx) * lanes * pack
    window_rows = min(h, ky)
    tj = nx
    while tj > 1 and window_rows * row_bytes(tj, lanes) > TILE_BYTES:
        tj = -(-tj // 2)
    while lanes > 1 and window_rows * row_bytes(tj, lanes) > TILE_BYTES:
        lanes //= 2
    rows = TILE_BYTES // row_bytes(tj, lanes)
    ti = ny if rows >= h else max(1, (rows - ky) // sy + 1)
    ti = -(-ny // -(-ny // min(ti, ny)))  # the same rows in every tile
    smem = min(h, (ti - 1) * sy + ky) * row_bytes(tj, lanes)
    if smem > MAX_SMEM:
        return Plan(min(SLAB_BYTES // pack, -(-c // vec)), 1, nx, 0, False)
    return Plan(lanes, ti, tj, smem)


def max_pooling_offsets(x, ky, kx, sliding, use_abs=False):
    """``(values, int32 offsets)`` of ``x`` (B, H, W, C) on the card.

    ``x`` must be a contiguous 4-D CUDA tensor of float32, float64,
    float16 or bfloat16 with fewer than 2^31 elements (int32 offsets).  Launches
    on the current stream without synchronising; raises if the launch
    is refused."""
    global LAUNCHES, LAUNCHES_WIDE, LAUNCHES_NARROW
    if not x.is_cuda:
        raise ValueError("max_pooling_offsets needs a CUDA tensor, got %s"
                         % x.device)
    if x.dtype not in _DTYPES:
        raise TypeError("max_pooling_offsets takes float32, float64, "
                        "float16 or bfloat16, got %s" % x.dtype)
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
    vec = vector_width(x)
    plan = launch_plan(tuple(x.shape), x.element_size(), vec, ky, kx,
                       (sx, sy))
    lib = _lib or load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with profiler.launch_range("max_pooling_offsets", stream):
            err = lib.max_pooling_offsets(
                x.data_ptr(), values.data_ptr(), offsets.data_ptr(),
                _DTYPES[x.dtype], vec, int(plan.staged), b, h, w, c, ny, nx,
                ky, kx, sy, sx,
                plan.lanes, plan.ti, plan.tj, int(bool(use_abs)), stream)
    if err:
        raise RuntimeError(
            "max_pooling_offsets launch failed: %s"
            % lib.max_pooling_offsets_error_string(err).decode())
    if vec == 1:
        LAUNCHES_NARROW += 1
    else:
        LAUNCHES_WIDE += 1
    LAUNCHES += 1
    LAUNCHES_BY_DTYPE[str(x.dtype).replace("torch.", "")] += 1
    profiler.kernel_cost("max_pooling_offsets",
                         *work(x.numel(), values.numel(), x.element_size(),
                               ky, kx))
    return values, offsets


def work(n_in, n_out, itemsize, ky, kx):
    """``(operations, bytes)`` of one launch, as its bound counts them:
    each window's ``ky * kx`` compares; the input read once, the values
    and the int32 offsets written once."""
    return n_out * ky * kx, n_in * itemsize + n_out * (itemsize + 4)
