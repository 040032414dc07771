"""Wrapper of the hand-written Hopper max-pooling backward kernel
(``znicz_tpu_torch/csrc/max_pooling_offsets_backward.cu``).

Counterpart of ``znicz_tpu/ops/pooling.py::_maxpool_bwd_dense`` (:118),
the backward of the fused path's "offsets" pooling: each input cell
receives the gradients of the windows whose recorded winner it is,
summed from +0.0 over the window offsets dy then dx ascending, and is
written once (cells no window covers as +0.0), so there are no atomics
and the bits are the same on every run; they equal those of its plain
PyTorch version,
:func:`znicz_tpu_torch.ops.pooling.max_pooling_backward_plain`.

Bound: memory — the gradient and the offsets read once plus the input
gradient written once, over the H100's 3.35 TB/s.  Design (details in
the source): a 3-D grid of channel slab x tile of input rows x batch
row, with int32 index arithmetic and no division per cell; each block
stages the err and offsets of the windows that touch its tile once in
shared memory with 16-byte ``cp.async``, and every cell reads its
covering windows there instead of through L1/L2 once for each cell a
window covers; each thread owns a 16-byte vector of channels and stores
it as one; float64 sums in double.  The kernel is instantiated with the
stride as the constant 2 (every pool on the port's paths), where the
window walk shifts instead of dividing, and once with runtime strides
for every other geometry, and once more with runtime strides and nothing
staged, for windows too large for shared memory, which it reads from
device memory.  Tiles stage at most ``TILE_BYTES`` = 24 KB, the budget
that timed fastest on the H100: 4, 9 and 13 input rows at AlexNet's
three training pools.  Each pool still takes one launch, a floor that at
max_pool5 is about half the bound.

Before each launch the wrapper chooses, from shape and alignment
alone, the vector width (:func:`vector_width`), the tiles, the block
and grid shapes and the instantiation (:func:`launch_plan`); nothing
is chosen on a failed launch, which raises.  The library is built by
:mod:`znicz_tpu_torch.ops.cuda_build` at the first launch and loaded
with ``ctypes``.  ``LAUNCHES_WIDE`` (16-byte vectors) and
``LAUNCHES_NARROW`` (one channel a thread) count the kernel's launches
by width, ``LAUNCHES`` their sum, both instantiations alike, and
``LAUNCHES_BY_DTYPE`` by the gradient's dtype; nothing else adds to
them.  Each launch reports its work (:func:`work`) to the
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

SOURCE = "max_pooling_offsets_backward.cu"
#: the JAX function this kernel takes the place of (file:line)
REPLACES = "znicz_tpu/ops/pooling.py:118"

#: launches of the kernel since the counters were last set to 0: at
#: 16-byte vectors, at one channel a thread, and both together
LAUNCHES_WIDE = 0
LAUNCHES_NARROW = 0
LAUNCHES = 0
#: the same launches by the values' dtype ("float32", "bfloat16", ...)
LAUNCHES_BY_DTYPE = collections.Counter()

#: shared memory a block's staged windows take at most, so that the
#: 227 KB an H100 SM gives its blocks never limits how many share it;
#: chip_smoke.py times the kernel at 16-64 KB, and on the H100 24 KB
#: beat the forward's 32 KB by 2-3% at AlexNet's two larger pools
TILE_BYTES = 24 * 1024
#: the most shared memory a block may take (the kernel's kMaxSmem)
MAX_SMEM = 227 * 1024
#: bytes of channels one block spans: a 128-byte line of each cell
SLAB_BYTES = 128
#: threads of a block (the kernel's launch bounds); the most blocks of
#: the grid's y and z dimensions (both stride on past it)
MAX_THREADS = 256
MAX_GRID_YZ = 65535

#: one launch: ``lanes`` threads across a channel slab; ``ti`` input
#: rows and ``tj`` input columns a tile; ``rows`` x ``cols`` windows
#: staged for it at most, ``smem`` bytes; ``block`` = (lanes, input
#: columns, input rows) threads and ``grid`` = (slabs, row tiles, batch
#: rows) blocks; ``stride2``: the instantiation with the stride as the
#: constant 2 (else runtime strides); ``staged`` False for windows that
#: no shared memory holds, which the unstaged instantiation (runtime
#: strides) reads from device memory (``smem`` 0)
Plan = collections.namedtuple(
    "Plan", "lanes ti tj rows cols smem block grid stride2 staged",
    defaults=(True,))

_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
           torch.float64: 3}
_lib = None
_lock = locksmith.lock("ops.cuda_pooling_backward.build")


def load():
    """Build (at first use) and load the kernel's library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(cuda_build.build(SOURCE))
            lib.max_pooling_offsets_backward.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 23 +
                [ctypes.c_void_p])
            lib.max_pooling_offsets_backward.restype = ctypes.c_int
            fn = lib.max_pooling_offsets_backward_error_string
            fn.argtypes = [ctypes.c_int]
            fn.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def vector_width(err, offsets, grad):
    """Channels each thread owns: a 16-byte vector of ``err``'s type (2
    in float64, 4 in float32, 8 in float16/bfloat16) when C and the three
    tensors' addresses allow 16-byte accesses to both ``err``/``grad`` and the
    int32 offsets, else 1."""
    vec = 16 // err.element_size()
    if err.shape[-1] % vec == 0 and all(
            t.data_ptr() % 16 == 0 for t in (err, offsets, grad)):
        return vec
    return 1


def _staged(n, k, s, n_out):
    """The most windows (size ``k``, stride ``s``, ``n_out`` of them)
    that touch ``n`` neighbouring input cells: the windows a tile of
    ``n`` rows (or columns) stages, wherever it starts."""
    return min(n_out, (n + k - 2) // s + 1)


def _even(n, most):
    """The least ``m <= most`` that cuts ``n`` into as few parts."""
    return -(-n // -(-n // min(most, n)))


@functools.lru_cache(maxsize=256)
def launch_plan(shape, itemsize, vec, ky, kx, sliding):
    """The :data:`Plan` of one launch that makes the input gradient of
    NHWC ``shape``.

    A slab spans ``SLAB_BYTES`` of channels (fewer when C is small); a
    tile spans all input columns unless the windows of one row overflow
    ``TILE_BYTES``, and as many input rows as keep its staged windows
    (err and offsets) within it, evened out over the tiles.  The
    block's columns are evened out over as few passes as
    ``MAX_THREADS`` allows, and its rows take the threads left.  Where
    even the windows of one input cell do not fit in shared memory, the
    plan is the unstaged instantiation's: a slab of ``SLAB_BYTES``, one
    input row and all input columns a block."""
    b, h, w, c = shape
    ny, nx = output_spatial(h, w, ky, kx, sliding)
    sx, sy = sliding
    pack = vec * itemsize
    cell = pack + 4 * vec  # a staged window of one lane: err and offsets
    lanes = min(SLAB_BYTES // pack, -(-c // vec))

    def row_bytes(tj, lanes):  # the windows of one output row a tile stages
        return _staged(tj, kx, sx, nx) * lanes * cell
    window_rows = _staged(1, ky, sy, ny)
    tj = w
    while tj > 1 and window_rows * row_bytes(tj, lanes) > TILE_BYTES:
        tj = -(-tj // 2)
    while lanes > 1 and window_rows * row_bytes(tj, lanes) > TILE_BYTES:
        lanes //= 2
    fit = TILE_BYTES // row_bytes(tj, lanes)
    ti = _even(h, h if fit >= ny else max(1, fit * sy - ky + 1))
    rows, cols = _staged(ti, ky, sy, ny), _staged(tj, kx, sx, nx)
    # the offsets tile is padded to the alignment of the err tile after it
    # (which only f64's wider packs need)
    align = min(pack, 16)
    smem = -(-rows * cols * lanes * 4 * vec // align) * align + \
        rows * cols * lanes * pack
    staged = smem <= MAX_SMEM
    if not staged:
        lanes, ti, tj, smem = min(SLAB_BYTES // pack, -(-c // vec)), 1, w, 0
        rows, cols = _staged(ti, ky, sy, ny), _staged(tj, kx, sx, nx)
    by = _even(tj, MAX_THREADS // lanes)
    bz = _even(ti, MAX_THREADS // (lanes * by))
    grid = (-(-(-(-c // vec)) // lanes), min(-(-h // ti), MAX_GRID_YZ),
            min(b, MAX_GRID_YZ))
    return Plan(lanes, ti, tj, rows, cols, smem, (lanes, by, bz), grid,
                staged and (sx, sy) == (2, 2), staged)


def variant(plan):
    """The kernel's instantiation for ``plan``: 1 stride 2, 0 runtime
    strides, 2 runtime strides unstaged."""
    return int(plan.stride2) if plan.staged else 2


def _check(err, offsets, x_shape, ky, kx, sliding):
    """Raise on what the kernel does not take (the device last, so that
    the other guards are testable on the CPU)."""
    if err.dtype not in _DTYPES:
        raise TypeError("max_pooling_offsets_backward takes float32, "
                        "float64, float16 or bfloat16, got %s" % err.dtype)
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
    tensors, ``err`` float32, float64, float16 or bfloat16 and ``offsets``
    int32, with fewer than 2^31 elements in the input.  Launches on the
    current stream without synchronising; raises if the launch is
    refused."""
    global LAUNCHES, LAUNCHES_WIDE, LAUNCHES_NARROW
    ky, kx = int(ky), int(kx)
    sx, sy = int(sliding[0]), int(sliding[1])
    b, h, w, c = (int(s) for s in x_shape)
    _check(err, offsets, (b, h, w, c), ky, kx, (sx, sy))
    grad = torch.empty((b, h, w, c), dtype=err.dtype, device=err.device)
    if grad.numel() == 0:
        return grad
    vec = vector_width(err, offsets, grad)
    plan = launch_plan((b, h, w, c), err.element_size(), vec, ky, kx,
                       (sx, sy))
    lib = _lib or load()
    with torch.cuda.device(err.device):
        stream = torch.cuda.current_stream(err.device).cuda_stream
        with profiler.launch_range("max_pooling_offsets_backward", stream):
            code = lib.max_pooling_offsets_backward(
                err.data_ptr(), offsets.data_ptr(), grad.data_ptr(),
                _DTYPES[err.dtype], vec, variant(plan), b, h, w, c,
                err.shape[1], err.shape[2], ky, kx, sy, sx, plan.ti, plan.tj,
                plan.rows, plan.cols, *plan.block, *plan.grid, stream)
    if code:
        raise RuntimeError(
            "max_pooling_offsets_backward launch failed: %s"
            % lib.max_pooling_offsets_backward_error_string(code).decode())
    if vec == 1:
        LAUNCHES_NARROW += 1
    else:
        LAUNCHES_WIDE += 1
    LAUNCHES += 1
    LAUNCHES_BY_DTYPE[str(err.dtype).replace("torch.", "")] += 1
    profiler.kernel_cost("max_pooling_offsets_backward",
                         *work(grad.numel(), err.numel(), err.element_size(),
                               ky, kx))
    return grad


def work(n_in, n_out, itemsize, ky, kx):
    """``(operations, bytes)`` of one launch, as its bound counts them:
    each window's offsets compared by its ``ky * kx`` cells and its err
    added once; the err and the int32 offsets read once, the input
    gradient written once."""
    return n_out * (ky * kx + 1), n_out * (itemsize + 4) + n_in * itemsize
