"""Pooling on NHWC tensors: max / maxabs with winner offsets, and avg,
forward and, for training, backward.

Counterpart of ``znicz_tpu/ops/pooling.py`` (``output_spatial`` :29,
``max_pooling_jax`` :77-94, ``_maxpool_bwd_dense`` :118,
``max_pooling_train_jax`` :158-191, ``pooling_fwd_jax`` :313-351,
``stochastic_pooling_jax`` :360, ``stochastic_pool_depool_jax`` :395,
``avg_pooling_backward_jax`` :441),
with the reference semantics:

* ``sliding`` is ``(x, y)``; the output size is ceil-mode,
  ``out = ceil((s - k) / stride) + 1``, so windows may overhang the
  right/bottom edge and are then truncated;
* max/maxabs return the window value (signed for maxabs) and the
  winner's FLAT NHWC input offset ``((b*H + wy)*W + wx)*C + c`` as
  int32.  Ties go to the FIRST cell in row-major window order (dy
  outer, dx inner); overhanging cells never win;
* avg divides by the TRUNCATED window size;
* stochastic pooling picks each window's winner with probability
  proportional to its (abs) positive value from a uint16 stream drawn on
  the host, uniformly over the truncated window when it sums to zero.

:func:`max_pooling` launches the hand-written CUDA kernel
(:mod:`znicz_tpu_torch.ops.cuda_pooling`) for a CUDA tensor and runs
:func:`max_pooling_plain` for a CPU tensor; :func:`max_pooling_backward`
does the same with the backward kernel
(:mod:`znicz_tpu_torch.ops.cuda_pooling_backward`) and
:func:`max_pooling_backward_plain`; :func:`depooling`, the
autoencoders' scatter of pooled values back to their winners, is that
backward.  There is no fallback from a
kernel to its plain version: on the card it launches or raises.

Training lowerings of a max pool (the fused path's ``PoolSpec.impl``,
``znicz_tpu/parallel/fused.py:210-250``):

* "offsets" — :func:`max_pooling_train`, an autograd function over the
  two kernels (their plain versions on the CPU);
* "gather" — :func:`max_pooling_gather`: the plain argmax, then a
  gather whose autograd backward is a scatter-add;
* "reduce_window" — :func:`pooling_reduce_window`: ``F.max_pool2d`` on
  the channels_last view; the JAX package leaves this one to XLA;
* "reshape" — :func:`max_pooling_reshape` and :func:`avg_pooling_reshape`
  (JAX :214-311), for windows that do not overlap: the cell planes of
  the disjoint windows and a compare/select chain, plain PyTorch as
  the JAX package leaves them to XLA.  One known difference: the
  backward's winner search skips the pad cells of an overhanging
  window, where JAX's compares them too (a window's first cell is
  always real and scanned first, so no input has shown the two apart).

``PLAIN_CUDA_CALLS`` counts calls of the plain max-pool versions on
CUDA tensors (the card's path runs the kernels; the plain versions
run there only as a reference).

:func:`max_pooling_numpy` and :func:`avg_pooling_numpy` (JAX :452,
:474) are the numpy twins that ``export.run_package_numpy`` runs: the
same ceil-mode windows, walked one window cell at a time over every
window at once (the first cell wins a tie, as numpy's ``argmax``).
"""

import numpy
import torch
import torch.nn.functional as F

#: calls of max_pooling_plain / max_pooling_backward_plain on CUDA
#: tensors since the counter was last set to 0
PLAIN_CUDA_CALLS = 0


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
    global PLAIN_CUDA_CALLS
    if x.is_cuda:
        PLAIN_CUDA_CALLS += 1
    q, ny, nx = _winners(x, ky, kx, sliding, use_abs)
    vwin, _, _ = _windows(x, ky, kx, sliding, 0.0)
    values = torch.gather(vwin, 4, q.unsqueeze(4)).squeeze(4)
    offsets = _flat_offsets(x.shape, ny, nx, kx, sliding, q)
    return values, offsets.to(torch.int32)


def _winners(x, ky, kx, sliding, use_abs):
    """Window cell index of each output's winner ``(B, ny, nx, C)``."""
    key = torch.abs(x) if use_abs else x
    key = key.detach().to(torch.promote_types(x.dtype, torch.float32))
    kwin, ny, nx = _windows(key, ky, kx, sliding, float("-inf"))
    return torch.argmax(kwin, dim=4), ny, nx


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


def max_pooling_backward_plain(err, offsets, x_shape, ky, kx, sliding):
    """The plain PyTorch version of the max-pooling backward kernel:
    the input gradient ``x_shape`` of a max pool whose forward recorded
    ``offsets``.

    A gather that visits, for each input cell, the windows covering it:
    for dy ascending, then dx ascending, window ``((y - dy) / sy,
    (x - dx) / sx)`` adds its ``err`` where it covers the cell and its
    offset is the cell's flat index.  The sum starts from +0.0 and is
    taken in ``err``'s type, in the order of the JAX package's
    ``_maxpool_bwd_dense`` shifted accumulation."""
    global PLAIN_CUDA_CALLS
    if err.is_cuda:
        PLAIN_CUDA_CALLS += 1
    b, h, w, c = x_shape
    ny, nx = err.shape[1], err.shape[2]
    sx, sy = sliding
    dev = err.device
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    cell = ((torch.arange(b, device=dev).view(b, 1, 1, 1) * h +
             ys.view(1, h, 1, 1)) * w + xs.view(1, 1, w, 1)) * c + \
        torch.arange(c, device=dev).view(1, 1, 1, c)
    zero = torch.zeros((), dtype=err.dtype, device=dev)
    grad = torch.zeros(tuple(x_shape), dtype=err.dtype, device=dev)

    def covering(pos, d, stride, n):
        """Window index along one axis, and whether it covers ``pos``."""
        o = pos - d
        ok = (o >= 0) & (o % stride == 0) & (o // stride < n)
        return torch.where(ok, o // stride, 0), ok

    for dy in range(ky):
        iy, oky = covering(ys, dy, sy, ny)
        err_y = err.index_select(1, iy)
        offs_y = offsets.index_select(1, iy)
        for dx in range(kx):
            ix, okx = covering(xs, dx, sx, nx)
            hit = (oky.view(1, h, 1, 1) & okx.view(1, 1, w, 1) &
                   (offs_y.index_select(2, ix) == cell))
            grad = grad + torch.where(hit, err_y.index_select(2, ix), zero)
    return grad


def max_pooling_backward(err, offsets, x_shape, ky, kx, sliding):
    """The input gradient of a max pool from its winner offsets — the
    kernel for CUDA tensors, :func:`max_pooling_backward_plain` for CPU
    tensors."""
    if err.is_cuda:
        from znicz_tpu_torch.ops import cuda_pooling_backward
        return cuda_pooling_backward.max_pooling_offsets_backward(
            err, offsets, x_shape, ky, kx, sliding)
    if err.device.type != "cpu":
        raise ValueError("max_pooling_backward: no path for device %s"
                         % err.device)
    return max_pooling_backward_plain(err, offsets, x_shape, ky, kx,
                                      sliding)


def depooling(values, offsets, x_shape, ky, kx, sliding):
    """Pooled ``values`` put back at their winners' ``offsets`` in a
    zero ``x_shape`` tensor, summed where a cell won several windows:
    :func:`max_pooling_backward` with the values as the gradient (the
    backward kernel on the card)."""
    return max_pooling_backward(values, offsets, x_shape, ky, kx, sliding)


def _stochastic_keys(x, ky, kx, sliding, use_abs):
    """``(window values, keys, in-bounds mask, ny, nx)``: the
    ``(B, ny, nx, C, ky*kx)`` windows (overhang 0), their sampling
    weights, ``|x|`` or ``max(x, 0)``, 0 on overhanging cells, and the
    ``(ny, nx, 1, ky*kx)`` mask of in-bounds cells in ``x``'s type."""
    win, ny, nx = _windows(x, ky, kx, sliding, 0.0)
    key = torch.abs(win) if use_abs else torch.clamp(win, min=0)
    b, h, w, c = x.shape
    rows = torch.arange(ny, device=x.device).view(ny, 1, 1) * sliding[1] + \
        torch.arange(ky, device=x.device).view(1, ky, 1)
    cols = torch.arange(nx, device=x.device).view(nx, 1, 1) * sliding[0] + \
        torch.arange(kx, device=x.device).view(1, 1, kx)
    valid = ((rows < h).view(ny, 1, ky, 1) &
             (cols < w).view(1, nx, 1, kx)).reshape(ny, nx, 1, ky * kx).to(
                 key.dtype)
    return win, key * valid, valid, ny, nx


def _first_hit(key, position):
    """The first window cell whose running sum of ``key`` reaches
    ``position`` (cell 0 where none does).  The sums run one cell at a
    time in window order, so every device adds alike."""
    n = key.shape[-1]
    acc = torch.zeros_like(position)
    q = torch.full(position.shape, n, dtype=torch.int64,
                   device=position.device)
    for i in range(n):
        acc = acc + key[..., i]
        q = torch.where((q == n) & (position <= acc), i, q)
    return torch.where(q == n, 0, q)


def _window_sum(key):
    """The sum of ``key`` over its last axis, one cell at a time."""
    acc = torch.zeros_like(key[..., 0])
    for i in range(key.shape[-1]):
        acc = acc + key[..., i]
    return acc


def stochastic_pooling(x, rand, ky, kx, sliding, use_abs=False):
    """``(values, int32 offsets)`` of stochastic pooling: window ``w``
    draws ``r = rand[w]`` (uint16 values in an integer tensor on ``x``'s
    device, row-major over the output) and wins at the first cell whose
    running sum of keys reaches ``r * sum / 65536``; a window whose keys
    sum to zero wins at cell ``k = r * n >> 16`` of its truncated
    ``ty x tx`` window of ``n`` cells.  The values keep their sign."""
    b, h, w, c = x.shape
    win, key, _, ny, nx = _stochastic_keys(x, ky, kx, sliding, use_abs)
    r = rand.reshape(-1)[:b * ny * nx * c].reshape(b, ny, nx, c).long()
    vsum = _window_sum(key)
    q_prop = _first_hit(key, r.to(x.dtype) * vsum / 65536.0)
    ty = torch.clamp(h - torch.arange(ny, device=x.device) * sliding[1],
                     max=ky).view(1, ny, 1, 1)
    tx = torch.clamp(w - torch.arange(nx, device=x.device) * sliding[0],
                     max=kx).view(1, 1, nx, 1)
    k_trunc = (r * (ty * tx)) >> 16
    q_unif = torch.div(k_trunc, tx, rounding_mode="floor") * kx + k_trunc % tx
    q = torch.where(vsum > 0, q_prop, q_unif)
    values = torch.gather(win, 4, q.unsqueeze(4)).squeeze(4)
    return values, _flat_offsets(x.shape, ny, nx, kx, sliding, q).to(
        torch.int32)


def stochastic_pool_depool(x, rand, ky, kx, use_abs=False):
    """``(y, int32 offsets)`` of stochastic pooling and depooling in one
    (non-overlapping ``ky x kx`` windows): ``y`` has ``x``'s shape, each
    window's winner keeps its value and every other cell is 0; a window
    whose keys sum to zero draws over a key of 1 on its in-bounds
    cells."""
    sliding = (kx, ky)
    win, key, valid, ny, nx = _stochastic_keys(x, ky, kx, sliding, use_abs)
    b, h, w, c = x.shape
    r = rand.reshape(-1)[:b * ny * nx * c].reshape(b, ny, nx, c)
    vsum = _window_sum(key)
    nonzero = vsum > 0
    total = torch.where(nonzero, vsum, _window_sum(valid))
    q = _first_hit(torch.where(nonzero[..., None], key, valid.expand_as(
        key)), r.to(x.dtype) * total / 65536.0)
    values = torch.gather(win, 4, q.unsqueeze(4)).squeeze(4)
    offsets = _flat_offsets(x.shape, ny, nx, kx, sliding, q)
    # a set, as the reference's: :func:`depooling` sums from +0.0 and
    # would turn a -0.0 winner of a zero-sum window into +0.0
    y = torch.zeros(x.numel(), dtype=x.dtype, device=x.device).scatter(
        0, offsets.reshape(-1), values.reshape(-1))
    return y.reshape(x.shape), offsets.to(torch.int32)


class _MaxPoolingTrain(torch.autograd.Function):
    """Max pooling whose backward routes each window's gradient to its
    recorded winner; the offsets take no gradient."""

    @staticmethod
    def forward(ctx, x, ky, kx, sliding, use_abs):
        values, offsets = max_pooling(x.contiguous(), ky, kx, sliding,
                                      use_abs)
        ctx.mark_non_differentiable(offsets)
        ctx.save_for_backward(offsets)
        ctx.geometry = (tuple(x.shape), ky, kx, sliding)
        return values, offsets

    @staticmethod
    def backward(ctx, err, _):
        offsets, = ctx.saved_tensors
        x_shape, ky, kx, sliding = ctx.geometry
        return (max_pooling_backward(err.contiguous(), offsets, x_shape,
                                     ky, kx, sliding),
                None, None, None, None)


def max_pooling_train(x, ky, kx, sliding, use_abs=False):
    """Differentiable max/maxabs pooling: ``(values, int32 offsets)``
    with the first-winner rule, forward and backward on the kernels for
    a CUDA tensor (counterpart of ``max_pooling_train_jax``)."""
    return _MaxPoolingTrain.apply(x, int(ky), int(kx), tuple(sliding),
                                  bool(use_abs))


def max_pooling_gather(x, ky, kx, sliding, use_abs=False):
    """Differentiable max/maxabs pooling values by the plain argmax and a
    gather (the "gather" lowering): its backward is autograd's
    scatter-add to the first winners."""
    global PLAIN_CUDA_CALLS
    if x.is_cuda:
        PLAIN_CUDA_CALLS += 1
    q, _, _ = _winners(x, ky, kx, sliding, use_abs)
    vwin, _, _ = _windows(x, ky, kx, sliding, 0.0)
    return torch.gather(vwin, 4, q.unsqueeze(4)).squeeze(4)


def pooling_reduce_window(x, ky, kx, sliding, mode="max"):
    """Offset-free pooling (the "reduce_window" lowering, counterpart of
    ``pooling_fwd_jax``): ``F.max_pool2d`` in ceil mode on the
    channels_last view for max, the larger-magnitude of the window max
    and min for maxabs, :func:`avg_pooling` for avg.  Ties route as
    ``max_pool2d``'s backward routes them."""
    if mode == "avg":
        return avg_pooling(x, ky, kx, sliding)
    if mode not in ("max", "maxabs"):
        raise ValueError(mode)
    ny, nx = output_spatial(x.shape[1], x.shape[2], ky, kx, sliding)
    xn = x.permute(0, 3, 1, 2)

    def pool(t):
        y = F.max_pool2d(t, (ky, kx), (sliding[1], sliding[0]),
                         ceil_mode=True)
        if tuple(y.shape[2:]) != (ny, nx):
            # max_pool2d drops a last window that starts past the edge
            raise ValueError("pooling_reduce_window: a %dx%d window at "
                             "stride %s leaves windows past the edge"
                             % (ky, kx, tuple(sliding)))
        return y.permute(0, 2, 3, 1)
    mx = pool(xn)
    if mode == "max":
        return mx
    mn = -pool(-xn)
    return torch.where(torch.abs(mx) >= torch.abs(mn), mx, mn)


# -- the non-overlapping "reshape" lowering ----------------------------------

def _pad_nonoverlap(x, ky, kx, fill):
    """``x`` padded right/bottom with ``fill`` to multiples of the
    kernel: with ``sliding == kernel`` that is the ceil-mode geometry."""
    py, px = (-x.shape[1]) % ky, (-x.shape[2]) % kx
    if py or px:
        x = F.pad(x, (0, 0, 0, px, 0, py), value=fill)
    return x


def _nonoverlap_slices(xp, ky, kx):
    """The ``ky*kx`` cell planes of the disjoint windows, in row-major
    window order (dy outer, dx inner): the order of first-winner ties."""
    return [xp[:, dy::ky, dx::kx, :] for dy in range(ky) for dx in range(kx)]


def _reshape_max_val(x, ky, kx, use_abs):
    """The window values: a strict compare/select chain over the cell
    planes, so an earlier cell keeps a tie."""
    xp = _pad_nonoverlap(x, ky, kx, 0.0 if use_abs else float("-inf"))
    slices = _nonoverlap_slices(xp, ky, kx)
    val = slices[0]
    key = torch.abs(val) if use_abs else val
    for s in slices[1:]:
        k = torch.abs(s) if use_abs else s
        take = k > key
        val = torch.where(take, s, val)
        key = torch.where(take, k, key)
    return val


class _MaxPoolingReshape(torch.autograd.Function):
    """Non-overlapping max/maxabs pooling whose backward recomputes the
    winner of each window from the saved input and output and routes
    the window's gradient to it by interleaving reshapes."""

    @staticmethod
    def forward(ctx, x, ky, kx, use_abs):
        y = _reshape_max_val(x, ky, kx, use_abs)
        ctx.save_for_backward(x, y)
        ctx.geometry = (ky, kx, use_abs)
        return y

    @staticmethod
    def backward(ctx, err):
        x, y = ctx.saved_tensors
        ky, kx, use_abs = ctx.geometry
        b, sy, sx, c = x.shape
        ny, nx = y.shape[1], y.shape[2]
        xp = _pad_nonoverlap(x, ky, kx, 0.0 if use_abs else float("-inf"))
        wkey = torch.abs(y) if use_abs else y
        zero = torch.zeros((), dtype=err.dtype, device=err.device)
        seen = torch.zeros(y.shape, dtype=torch.bool, device=y.device)
        rows = torch.arange(ny, device=x.device) * ky
        cols = torch.arange(nx, device=x.device) * kx
        parts = []
        for q, s in enumerate(_nonoverlap_slices(xp, ky, kx)):
            dy, dx = divmod(q, kx)
            # a pad cell never wins, not even where the window's largest
            # |x| is 0 and the pad's fill ties it
            real = (((rows + dy) < sy).view(1, ny, 1, 1) &
                    ((cols + dx) < sx).view(1, 1, nx, 1))
            k = torch.abs(s) if use_abs else s
            win = (k == wkey) & ~seen & real
            seen = seen | win
            parts.append(torch.where(win, err, zero))
        full = torch.stack(parts, dim=3).reshape(b, ny, nx, ky, kx, c)
        full = full.permute(0, 1, 3, 2, 4, 5).reshape(b, ny * ky, nx * kx, c)
        return full[:, :sy, :sx, :], None, None, None


def max_pooling_reshape(x, ky, kx, use_abs=False):
    """Non-overlapping (``sliding == (kx, ky)``) max or maxabs pooling as
    strided cell planes and a compare/select chain, first winner on a
    tie, its gradient routed elementwise (counterpart of
    ``max_pooling_reshape_jax``).  Plain PyTorch, as the JAX package
    leaves it to XLA."""
    return _MaxPoolingReshape.apply(x, int(ky), int(kx), bool(use_abs))


def avg_pooling_reshape(x, ky, kx):
    """Non-overlapping avg pooling as the sum of the cell planes over the
    truncated window size (counterpart of ``avg_pooling_reshape_jax``);
    its gradient is autograd's."""
    b, sy, sx, c = x.shape
    ny, nx = output_spatial(sy, sx, ky, kx, (kx, ky))
    total = None
    for s in _nonoverlap_slices(_pad_nonoverlap(x, ky, kx, 0.0), ky, kx):
        total = s if total is None else total + s
    cnt = _trunc_divisor(sy, sx, ky, kx, (kx, ky), ny, nx, torch.float32,
                         x.device).to(x.dtype)
    return total / cnt[None, :, :, None]


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


def avg_pooling_backward(err, ky, kx, sliding, x_shape):
    """The input gradient ``x_shape`` of :func:`avg_pooling` (autograd
    over it): each window's err over its truncated size, spread on its
    cells."""
    with torch.enable_grad():
        x = torch.zeros(tuple(x_shape), dtype=err.dtype, device=err.device,
                        requires_grad=True)
        return torch.autograd.grad(avg_pooling(x, ky, kx, sliding), x,
                                   err)[0]


# -- the numpy twins (the package runner's executable spec) -------------------

def _cells_numpy(x, ky, kx, sliding, fill):
    """Each window cell ``(dy, dx)`` in row-major order with the
    ``(B, ny, nx, C)`` slice of ``x`` it covers (``fill`` where a
    ceil-mode window overhangs the edge) and its input row and
    column."""
    b, sy, sx, c = x.shape
    ny, nx = output_spatial(sy, sx, ky, kx, sliding)
    stx, sty = sliding
    py = max((ny - 1) * sty + ky - sy, 0)
    px = max((nx - 1) * stx + kx - sx, 0)
    xp = numpy.pad(x, ((0, 0), (0, py), (0, px), (0, 0)),
                   constant_values=fill)
    rows = numpy.arange(ny) * sty
    cols = numpy.arange(nx) * stx
    for dy in range(ky):
        for dx in range(kx):
            yield (xp[:, dy:dy + (ny - 1) * sty + 1:sty,
                      dx:dx + (nx - 1) * stx + 1:stx, :],
                   rows + dy, cols + dx)


def max_pooling_numpy(x, ky, kx, sliding, use_abs=False):
    """``(values, offsets)`` of the ceil-mode max (or maxabs) pool of
    NHWC ``x``: each window's first largest cell (by magnitude under
    ``use_abs``) and its flat NHWC input offset, int32."""
    b, sy, sx, c = x.shape
    out = key = offs = None
    for cell, r, q in _cells_numpy(x, ky, kx, sliding, numpy.nan):
        ck = numpy.abs(cell) if use_abs else cell
        off = ((numpy.arange(b)[:, None, None, None] * sy +
                r[None, :, None, None]) * sx +
               q[None, None, :, None]) * c + numpy.arange(c)
        if out is None:
            out, key = cell.copy(), ck.copy()
            offs = numpy.broadcast_to(off, cell.shape).astype(numpy.int32)
            continue
        # NaN marks a cell past the edge: it never wins
        win = ck > key
        out = numpy.where(win, cell, out)
        key = numpy.where(win, ck, key)
        offs = numpy.where(win, off, offs).astype(numpy.int32)
    return out, offs


def avg_pooling_numpy(x, ky, kx, sliding):
    """The ceil-mode average pool of NHWC ``x``, each window's sum over
    its cells inside the input divided by their count."""
    total = count = None
    for cell, _, _ in _cells_numpy(x, ky, kx, sliding, numpy.nan):
        inside = ~numpy.isnan(cell)
        value = numpy.where(inside, cell, 0)
        total = value if total is None else total + value
        count = inside.astype(x.dtype) if count is None else count + inside
    return total / count
