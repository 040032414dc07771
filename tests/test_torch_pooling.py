"""The port's pooling (znicz_tpu_torch.ops.pooling) against the JAX
package: max/maxabs values and winner offsets BIT-equal to the Pallas
kernel (interpret mode on the CPU, as the JAX package's own tests run
it) and to the numpy twin; avg pooling against ``pooling_fwd_jax``; the
Hopper kernel's choices made before a launch (vector width, tiles)."""

import numpy
import pytest
import jax.numpy as jnp
import torch

from znicz_tpu.ops import pooling as jax_pool
from znicz_tpu.ops.pallas_pooling import max_pooling_offsets_pallas
from znicz_tpu_torch.ops import cuda_pooling
from znicz_tpu_torch.ops import pooling

#: (sy, sx, c, ky, kx, sliding): the JAX package's GEOMS (the second and
#: third overhang the edge), an AlexNet-like overlapping 3x3/s2 pool,
#: and the Hopper kernel's tile edges that chip_smoke.py checks on the
#: card (TILE_EDGES there): 28 tiles of one output row; 13 output rows
#: in tiles of 4 over 36 channels (a multiple of the 16-byte vector, not
#: of the slab); the MNIST pool's 87 channels at 2x2/s2; rows wider
#: than a tile (column tiles)
GEOMS = [
    (6, 6, 3, 2, 2, (2, 2)),
    (5, 7, 2, 3, 2, (2, 3)),
    (4, 4, 1, 3, 3, (3, 3)),
    (13, 13, 8, 3, 3, (2, 2)),
    (57, 57, 96, 3, 3, (2, 2)),
    (27, 27, 36, 3, 3, (2, 2)),
    (24, 24, 87, 2, 2, (2, 2)),
    (7, 700, 32, 3, 3, (2, 2)),
]


def _bits(a):
    """float32 bit pattern (bf16 -> f32 is exact, so equal f32 bits are
    equal bf16 bits)."""
    return numpy.ascontiguousarray(a, dtype=numpy.float32).view(numpy.int32)


def _tied_input(geom, seed):
    sy, sx, c = geom[:3]
    x = numpy.random.RandomState(seed).uniform(
        -1, 1, (2, sy, sx, c)).astype(numpy.float32)
    # exact ties inside windows pin the first-winner rule; the second
    # row ties the first in |x| only, which pins it for maxabs
    x[:, 0, :2, :] = 0.5
    x[:, 1, :2, :] = -0.5
    return x


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("use_abs", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_pooling_plain_bit_equal_to_pallas_and_numpy(geom, use_abs,
                                                         dtype):
    _, _, _, ky, kx, sliding = geom
    x32 = _tied_input(geom, 11)
    if dtype == "bfloat16":
        xt = torch.from_numpy(x32).to(torch.bfloat16)
        xj = jnp.asarray(x32).astype(jnp.bfloat16)
        xn = xt.float().numpy()  # the bf16 values, exactly, in f32
    else:
        xt, xj, xn = torch.from_numpy(x32), x32, x32
    v, o = pooling.max_pooling_plain(xt, ky, kx, sliding, use_abs)
    jv, jo = max_pooling_offsets_pallas(xj, ky, kx, sliding, use_abs)
    nv, no = jax_pool.max_pooling_numpy(xn, ky, kx, sliding, use_abs)
    assert v.dtype == xt.dtype and o.dtype == torch.int32
    assert v.shape == tuple(jv.shape)
    assert (_bits(v.float().numpy()) ==
            _bits(numpy.asarray(jv.astype(jnp.float32)))).all()
    assert (_bits(v.float().numpy()) == _bits(nv)).all()
    assert (o.numpy() == numpy.asarray(jo)).all()
    assert (o.numpy() == no).all()


@pytest.mark.parametrize("use_abs", [False, True])
def test_max_pooling_plain_minus_inf_inputs(use_abs):
    """A real -inf wins its window (an all -inf window yields -inf at the
    window origin) — bit-equal to the Pallas kernel and the numpy twin."""
    x = numpy.random.RandomState(5).uniform(
        -1, 1, (2, 5, 7, 3)).astype(numpy.float32)
    x[0, :3, :3, 0] = -numpy.inf
    x[1, 2, 4, :] = -numpy.inf
    v, o = pooling.max_pooling_plain(torch.from_numpy(x), 3, 2, (2, 3),
                                     use_abs)
    jv, jo = max_pooling_offsets_pallas(x, 3, 2, (2, 3), use_abs)
    nv, no = jax_pool.max_pooling_numpy(x, 3, 2, (2, 3), use_abs)
    assert (_bits(v.numpy()) == _bits(numpy.asarray(jv))).all()
    assert (_bits(v.numpy()) == _bits(nv)).all()
    assert (o.numpy() == numpy.asarray(jo)).all() and (o.numpy() == no).all()
    assert numpy.isneginf(v.numpy()[0, 0, 0, 0])


def test_max_pooling_dispatch_runs_plain_on_cpu_and_kernel_refuses_cpu():
    """On a CPU tensor ``max_pooling`` is the plain version; the kernel's
    wrapper never falls back — it refuses a CPU tensor, and counts no
    launch."""
    x = torch.from_numpy(_tied_input(GEOMS[3], 3))
    v, o = pooling.max_pooling(x, 3, 3, (2, 2))
    pv, po = pooling.max_pooling_plain(x, 3, 3, (2, 2))
    assert torch.equal(v, pv) and torch.equal(o, po)
    counts = (cuda_pooling.LAUNCHES, cuda_pooling.LAUNCHES_WIDE,
              cuda_pooling.LAUNCHES_NARROW)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_pooling.max_pooling_offsets(x, 3, 3, (2, 2))
    assert (cuda_pooling.LAUNCHES, cuda_pooling.LAUNCHES_WIDE,
            cuda_pooling.LAUNCHES_NARROW) == counts


#: channels each thread owns, by dtype and C, on 16-byte-aligned storage
WIDTHS = {
    torch.float32: {1: 1, 3: 1, 36: 4, 87: 1, 96: 4, 256: 4},
    torch.float16: {1: 1, 3: 1, 36: 1, 87: 1, 96: 8, 256: 8},
    torch.bfloat16: {1: 1, 3: 1, 36: 1, 87: 1, 96: 8, 256: 8},
}


@pytest.mark.parametrize("dtype", list(WIDTHS))
@pytest.mark.parametrize("c", [1, 3, 36, 87, 96, 256])
@pytest.mark.parametrize("aligned", [True, False])
def test_vector_width_from_shape_and_alignment(dtype, c, aligned):
    """16-byte vectors only where C and the storage's address are both
    multiples of 16 bytes; storage one element past a 16-byte boundary
    (a contiguous slice) takes one channel a thread."""
    n = 2 * 5 * 5 * c
    buf = torch.zeros(n + 1, dtype=dtype)
    x = (buf[:n] if aligned else buf[1:]).view(2, 5, 5, c)
    assert x.is_contiguous() and (x.data_ptr() % 16 == 0) == aligned
    assert cuda_pooling.vector_width(x) == \
        (WIDTHS[dtype][c] if aligned else 1)


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_plan_tiles_cover_the_output(geom, dtype):
    """The plan's tile fits its budget (or, for a window larger than the
    budget, shared memory), its slab spans at most 128 bytes and its
    threads at most 256 (the kernel's launch bounds)."""
    sy, sx, c, ky, kx, sliding = geom
    itemsize = torch.empty((), dtype=dtype).element_size()
    wide = 16 // itemsize
    for vec in (1, wide) if c % wide == 0 else (1,):
        plan = cuda_pooling.launch_plan((2, sy, sx, c), itemsize, vec, ky,
                                        kx, sliding)
        ny, nx = pooling.output_spatial(sy, sx, ky, kx, sliding)
        rows = min(sy, (plan.ti - 1) * sliding[1] + ky)
        cols = min(sx, (plan.tj - 1) * sliding[0] + kx)
        pack = vec * itemsize
        assert plan.smem == rows * cols * plan.lanes * pack
        assert plan.smem <= cuda_pooling.TILE_BYTES
        assert 1 <= plan.ti <= ny and 1 <= plan.tj <= nx
        assert plan.lanes * pack <= cuda_pooling.SLAB_BYTES
        assert plan.lanes * vec < c + vec  # no lane wholly past C


def test_launch_plan_alexnet_and_tile_edges():
    """AlexNet's pools take 16-byte vectors in tiles of at most 32 KB;
    the tile-edge geometries really reach their edges."""
    for shape in ((64, 55, 55, 96), (64, 27, 27, 256), (64, 13, 13, 256)):
        x = torch.zeros(shape)
        assert cuda_pooling.vector_width(x) == 4
        plan = cuda_pooling.launch_plan(shape, 4, 4, 3, 3, (2, 2))
        assert plan.smem <= 32 * 1024 and plan.lanes == 8
    # 13 output rows in tiles that do not divide them; 9 packs of 4
    # channels over slabs of 8
    plan = cuda_pooling.launch_plan((2, 27, 27, 36), 4, 4, 3, 3, (2, 2))
    assert 13 % plan.ti != 0 and 9 % plan.lanes != 0
    # a row wider than a tile: column tiles, the last one partial
    plan = cuda_pooling.launch_plan((2, 7, 700, 32), 4, 4, 3, 3, (2, 2))
    assert plan.tj < 350 and 350 % plan.tj != 0 and 3 % plan.ti != 0
    # a window that no 128-byte slab fits narrows the slab; one that no
    # shared memory fits takes the unstaged instantiation, a whole slab
    # of lanes, one output row and all output columns a block
    plan = cuda_pooling.launch_plan((1, 100, 100, 64), 4, 4, 64, 64,
                                    (1, 1))
    assert plan.lanes == 1 and plan.smem == 64 * 64 * 16 and plan.staged
    plan = cuda_pooling.launch_plan((1, 300, 300, 64), 4, 4, 200, 200, (1, 1))
    assert plan == cuda_pooling.Plan(8, 1, 101, 0, False)


@pytest.mark.parametrize("sy", range(1, 9))
def test_output_spatial_matches_jax(sy):
    for sx, ky, kx, sliding in ((7, 3, 2, (2, 3)), (5, 2, 2, (2, 2)),
                                (sy + 1, 1, 3, (3, 1))):
        assert pooling.output_spatial(sy, sx, ky, kx, sliding) == \
            tuple(jax_pool.output_spatial(sy, sx, ky, kx, sliding))


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("dtype", [numpy.float32, numpy.float64])
def test_avg_pooling_matches_jax(geom, dtype):
    """Truncated-window divisor; rtol 1e-6 (f32: atol 1e-7 covers the
    different summation order of the window sums)."""
    sy, sx, c, ky, kx, sliding = geom
    x = numpy.random.RandomState(2).uniform(
        -1, 1, (3, sy, sx, c)).astype(dtype)
    got = pooling.avg_pooling(torch.from_numpy(x), ky, kx, sliding)
    want = jax_pool.pooling_fwd_jax(x, ky, kx, sliding, mode="avg")
    numpy.testing.assert_allclose(
        got.numpy(), numpy.asarray(want), rtol=1e-6,
        atol=1e-7 if dtype == numpy.float32 else 0)


# -- the training side: backward, autograd, the lowerings ---------------

from znicz_tpu_torch.ops import cuda_pooling_backward  # noqa: E402


def _zero_signs_differ_only(got, want):
    """``got`` equals ``want`` as numbers, and bit for bit wherever
    ``want`` is not zero; a zero of ``got`` is +0.0."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert (got == want).all()
    ints = {4: numpy.int32, 8: numpy.int64}[got.itemsize]
    nz = want != 0
    assert (got.view(ints)[nz] == want.view(ints)[nz]).all()
    assert (got.view(ints)[~nz] == 0).all()


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("use_abs", [False, True])
@pytest.mark.parametrize("dtype", [numpy.float32, numpy.float64])
def test_max_pooling_backward_plain_bit_equal_to_jax(geom, use_abs, dtype):
    """The plain backward against ``_maxpool_bwd_dense`` on the JAX
    package's winner offsets: bit-equal.  The one difference is the
    sign of a zero where windows do not overlap: there the JAX function
    multiplies each gradient by a 0/1 one-hot (a negative gradient
    times 0 is -0.0), while the plain version, like the kernel, sums
    from +0.0."""
    _, _, _, ky, kx, sliding = geom
    x = _tied_input(geom, 13).astype(dtype)
    _, offs = jax_pool.max_pooling_gather_jax(x, ky, kx, sliding, use_abs)
    offs = numpy.array(offs)
    err = numpy.random.RandomState(17).uniform(-1, 1, offs.shape).astype(
        dtype)
    want = numpy.asarray(jax_pool._maxpool_bwd_dense(
        jnp.asarray(err), jnp.asarray(offs), x.shape, ky, kx, sliding))
    got = pooling.max_pooling_backward_plain(
        torch.from_numpy(err), torch.from_numpy(offs), x.shape, ky, kx,
        sliding).numpy()
    _zero_signs_differ_only(got, want)
    if tuple(sliding) != (kx, ky):  # overlapping: the very same bits
        assert (got.view(numpy.uint8) == want.view(numpy.uint8)).all()


@pytest.mark.parametrize("geom", [GEOMS[0], GEOMS[1],
                                  (7, 7, 3, 3, 3, (2, 2))])
@pytest.mark.parametrize("use_abs", [False, True])
def test_max_pooling_train_gradcheck(geom, use_abs):
    """Numerical gradients of the autograd function in float64 (untied
    inputs: a small step moves no winner); the offsets take none."""
    sy, sx, c, ky, kx, sliding = geom
    x = torch.from_numpy(numpy.random.RandomState(3).uniform(
        -1, 1, (2, sy, sx, c))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda t: pooling.max_pooling_train(t, ky, kx, sliding,
                                            use_abs)[0], (x,))
    _, offs = pooling.max_pooling_train(x, ky, kx, sliding, use_abs)
    assert not offs.requires_grad and offs.dtype == torch.int32


@pytest.mark.parametrize("geom", [GEOMS[1], GEOMS[3], GEOMS[6]])
@pytest.mark.parametrize("use_abs", [False, True])
def test_lowerings_agree_on_cpu(geom, use_abs):
    """On the CPU the "offsets" function runs the plain versions: its
    values and input gradient equal the plain forward and backward bit
    for bit, and the "gather" and "reduce_window" lowerings give the
    same values and (untied data) the same gradient."""
    sy, sx, c, ky, kx, sliding = geom
    x0 = torch.from_numpy(numpy.random.RandomState(4).uniform(
        -1, 1, (2, sy, sx, c)))
    err = torch.from_numpy(numpy.random.RandomState(5).uniform(
        -1, 1, (2,) + pooling.output_spatial(sy, sx, ky, kx, sliding) +
        (c,)))
    mode = "maxabs" if use_abs else "max"
    results = []
    for fn in (lambda t: pooling.max_pooling_train(t, ky, kx, sliding,
                                                   use_abs)[0],
               lambda t: pooling.max_pooling_gather(t, ky, kx, sliding,
                                                    use_abs),
               lambda t: pooling.pooling_reduce_window(t, ky, kx, sliding,
                                                       mode)):
        x = x0.clone().requires_grad_()
        y = fn(x)
        y.backward(err)
        results.append((y.detach(), x.grad))
    pv, po = pooling.max_pooling_plain(x0, ky, kx, sliding, use_abs)
    assert torch.equal(results[0][0], pv)
    assert torch.equal(results[0][1], pooling.max_pooling_backward_plain(
        err, po, x0.shape, ky, kx, sliding))
    for y, g in results[1:]:
        assert torch.equal(y, pv)
        torch.testing.assert_close(g, results[0][1], rtol=1e-15, atol=0)


def _backward_counts():
    return (cuda_pooling_backward.LAUNCHES,
            cuda_pooling_backward.LAUNCHES_WIDE,
            cuda_pooling_backward.LAUNCHES_NARROW)


def test_backward_dispatch_runs_plain_on_cpu_and_kernel_refuses_cpu():
    x = torch.from_numpy(_tied_input(GEOMS[3], 3))
    _, o = pooling.max_pooling_plain(x, 3, 3, (2, 2))
    err = torch.randn(o.shape, generator=torch.Generator().manual_seed(0))
    counts = _backward_counts()
    got = pooling.max_pooling_backward(err, o, x.shape, 3, 3, (2, 2))
    assert torch.equal(got, pooling.max_pooling_backward_plain(
        err, o, x.shape, 3, 3, (2, 2)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_pooling_backward.max_pooling_offsets_backward(
            err, o, x.shape, 3, 3, (2, 2))
    assert _backward_counts() == counts


def test_backward_kernel_guards():
    """Everything the kernel does not take is refused before the launch
    (and before the device is looked at), and counts no launch."""
    f = cuda_pooling_backward.max_pooling_offsets_backward
    err = torch.zeros(2, 3, 3, 4)
    offs = torch.zeros(2, 3, 3, 4, dtype=torch.int32)
    x_shape = (2, 7, 7, 4)
    counts = _backward_counts()
    with pytest.raises(TypeError,
                       match="float32, float64, float16 or bfloat16"):
        f(err.long(), offs, x_shape, 3, 3, (2, 2))
    with pytest.raises(TypeError, match="int32"):
        f(err, offs.long(), x_shape, 3, 3, (2, 2))
    with pytest.raises(ValueError, match="4-D"):
        f(err[0], offs[0], x_shape, 3, 3, (2, 2))
    with pytest.raises(ValueError, match="overflow"):
        shape = (2, 3, 3, 2 ** 28)  # views of one element: no memory
        f(torch.zeros(1).expand(shape),
          torch.zeros(1, dtype=torch.int32).expand(shape),
          (2, 7, 7, 2 ** 28), 3, 3, (2, 2))
    with pytest.raises(ValueError, match="contiguous"):
        f(err.transpose(1, 2), offs, x_shape, 3, 3, (2, 2))
    with pytest.raises(ValueError, match="positive"):
        f(err, offs, x_shape, 3, 0, (2, 2))
    for bad in ((3, 7, 7, 4), (2, 9, 9, 4), (2, 7, 7, 5)):
        with pytest.raises(ValueError, match="pooling of"):
            f(err, offs, bad, 3, 3, (2, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        f(err, offs, x_shape, 3, 3, (2, 2))
    # windows whose staged err and offsets no shared memory holds take
    # the unstaged instantiation (runtime strides)
    plan = cuda_pooling_backward.launch_plan((1, 300, 300, 64), 4, 4, 200,
                                             200, (1, 1))
    assert not plan.staged and plan.smem == 0 and not plan.stride2
    assert cuda_pooling_backward.variant(plan) == 2
    assert _backward_counts() == counts


@pytest.mark.parametrize("dtype,c,want", [
    (torch.float32, 96, 4), (torch.float32, 87, 1), (torch.float32, 36, 4),
    (torch.bfloat16, 96, 8), (torch.float16, 36, 1)])
@pytest.mark.parametrize("aligned", [True, False])
def test_backward_vector_width(dtype, c, want, aligned):
    """16-byte vectors where C and all three addresses allow them."""
    n = 2 * 3 * 3 * c
    buf = torch.zeros(n + 4, dtype=dtype)
    err = (buf[:n] if aligned else buf[1:n + 1]).view(2, 3, 3, c)
    offs = torch.zeros((2, 3, 3, c), dtype=torch.int32)
    grad = torch.zeros((2, 7, 7, c), dtype=dtype)
    assert cuda_pooling_backward.vector_width(err, offs, grad) == \
        (want if aligned else 1)


# -- the backward kernel's launch plan (chosen before the launch) --------

#: (b, h, w, c, ky, kx, sliding) of the backward kernel's tile edges that
#: chip_smoke.py checks on the card (BACKWARD_TILE_EDGES there)
BACKWARD_TILE_EDGES = [
    (2, 57, 57, 96, 2, 2, (2, 2)),  # 2x2/s2 in odd tiles: windows straddle
    (2, 41, 41, 64, 3, 3, (2, 2)),  # 3x3/s2 in odd tiles: alternating halo
    (2, 7, 700, 32, 3, 3, (2, 2)),  # column tiles
    (3, 24, 24, 87, 2, 2, (2, 2)),  # the MNIST pool, one channel a thread
    (2, 60, 150, 32, 3, 3, (3, 3)),  # runtime stride, 15 row tiles
    (2, 5, 1200, 16, 3, 3, (3, 3)),  # runtime stride, column tiles
    (2, 20, 20, 8, 2, 2, (3, 3)),  # stride past the window: uncovered cells
]
#: the batch-128 AlexNet training shapes and their plans in float32 at
#: 16-byte vectors
TRAIN_PLANS = {
    (128, 55, 55, 96): cuda_pooling_backward.Plan(
        8, 4, 55, 3, 27, 20736, (8, 28, 1), (3, 14, 128), True),
    (128, 27, 27, 256): cuda_pooling_backward.Plan(
        8, 9, 27, 6, 13, 19968, (8, 27, 1), (8, 3, 128), True),
    (128, 13, 13, 256): cuda_pooling_backward.Plan(
        8, 13, 13, 6, 6, 9216, (8, 13, 2), (8, 1, 128), True),
}
BACKWARD_PLAN_CASES = ([(2,) + g for g in GEOMS] + BACKWARD_TILE_EDGES +
                       [s + (3, 3, (2, 2)) for s in TRAIN_PLANS])


def _window_span(lo, hi, k, s, n_out):
    """``(first, last)`` window touching input cells ``[lo, hi)`` along
    one axis, as the kernel works them out for a tile (``first_window``
    and ``oy_hi`` in the source)."""
    t = lo - k + 1
    return (0 if t <= 0 else -(-t // s)), min(n_out - 1, (hi - 1) // s)


def _walk(pos, k, s, n_out):
    """The windows a cell at ``pos`` visits, in the kernel's order: from
    ``min(n_out - 1, pos // s)`` down while ``pos - o*s < k``."""
    o = min(n_out - 1, pos // s)
    out = []
    while o >= 0 and pos - o * s < k:
        out.append(o)
        o -= 1
    return out


def _tiles_of_axis(n, tile, n_blocks):
    """``(lo, hi)`` of the tiles a grid of ``n_blocks`` walks over ``n``
    cells in steps of ``tile`` (the kernel's strided loop)."""
    return [(lo, min(n, lo + tile)) for blk in range(n_blocks)
            for lo in range(blk * tile, n, n_blocks * tile)]


@pytest.mark.parametrize("case", BACKWARD_PLAN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_launch_plan_covers_the_input(case, dtype):
    """The grid's tiles cover every input cell exactly once; the windows
    staged for a tile are exactly those that touch it, no more than the
    plan's rows x columns, and hold every window each of its cells walks
    (dy then dx ascending); the staged tile stays within ``TILE_BYTES``,
    the block within the launch bounds, and the stride-2 instantiation
    is chosen exactly for sliding (2, 2)."""
    b, h, w, c, ky, kx, sliding = case
    sx, sy = sliding
    ny, nx = pooling.output_spatial(h, w, ky, kx, sliding)
    itemsize = torch.empty((), dtype=dtype).element_size()
    wide = 16 // itemsize
    for vec in (1, wide) if c % wide == 0 else (1,):
        plan = cuda_pooling_backward.launch_plan((b, h, w, c), itemsize, vec,
                                                 ky, kx, sliding)
        lanes, by, bz = plan.block
        gx, gy, gz = plan.grid
        assert lanes == plan.lanes and lanes * by * bz <= 256
        assert gy <= 65535 and gz <= 65535
        assert plan.smem == plan.rows * plan.cols * lanes * (
            vec * itemsize + 4 * vec)
        assert plan.smem <= cuda_pooling_backward.TILE_BYTES
        assert plan.stride2 == (tuple(sliding) == (2, 2))
        channels = sorted(ch for blk in range(gx) for lane in range(lanes)
                          for ch in range((blk * lanes + lane) * vec,
                                          (blk * lanes + lane + 1) * vec)
                          if (blk * lanes + lane) * vec < c)
        assert channels == list(range(c))
        assert sorted(i for z in range(gz) for i in range(z, b, gz)) == \
            list(range(b))
        for n, tile, n_blocks, k, s, n_out, most in (
                (h, plan.ti, gy, ky, sy, ny, plan.rows),
                (w, plan.tj, 1, kx, sx, nx, plan.cols)):
            tiles = _tiles_of_axis(n, tile, n_blocks)
            assert sorted(i for lo, hi in tiles for i in range(lo, hi)) == \
                list(range(n))
            for lo, hi in tiles:
                first, last = _window_span(lo, hi, k, s, n_out)
                touch = [o for o in range(n_out)
                         if o * s <= hi - 1 and o * s + k - 1 >= lo]
                assert list(range(first, last + 1)) == touch
                assert len(touch) <= most
                for pos in range(lo, hi):
                    covering = [o for o in touch if o * s <= pos < o * s + k]
                    assert _walk(pos, k, s, n_out) == covering[::-1]


def test_backward_launch_plans_at_alexnet_training_shapes():
    """The plans of the batch-128 training step's three backward launches
    (float32, 16-byte vectors): the stride-2 instantiation, tiles of 4,
    9 and 13 input rows within 24 KB; other strides take the runtime
    one."""
    for shape, plan in TRAIN_PLANS.items():
        c = shape[3]
        assert cuda_pooling_backward.vector_width(
            torch.zeros(2, 3, 3, c), torch.zeros(2, 3, 3, c,
                                                 dtype=torch.int32),
            torch.zeros(2, 7, 7, c)) == 4
        assert cuda_pooling_backward.launch_plan(shape, 4, 4, 3, 3,
                                                 (2, 2)) == plan
    assert cuda_pooling_backward.launch_plan(
        (2, 24, 24, 87), 4, 1, 2, 2, (2, 2)).stride2
    for ky, kx, sliding in ((3, 2, (2, 3)), (3, 3, (3, 3)), (3, 3, (1, 2))):
        assert not cuda_pooling_backward.launch_plan(
            (2, 13, 13, 8), 4, 4, ky, kx, sliding).stride2


class _StubLibrary:
    """Stands in for the kernel's library: records each launch's
    arguments and returns ``code``."""

    def __init__(self, code=0):
        self.code = code
        self.calls = []

    def max_pooling_offsets_backward(self, *args):
        self.calls.append(args)
        return self.code

    def max_pooling_offsets_backward_error_string(self, code):
        return b"stub error %d" % code


def test_backward_launch_counters_only_count(monkeypatch):
    """The wrapper's launch path with the card's library stood in for:
    the library receives the plan's tiles, block, grid and
    instantiation; each launch it accepts adds one to ``LAUNCHES`` and
    to the counter of its width, whatever they held, and a refused one
    raises and adds to none."""
    import contextlib
    import types
    stub = _StubLibrary()
    monkeypatch.setattr(cuda_pooling_backward, "_lib", stub)
    monkeypatch.setattr(cuda_pooling_backward, "_check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=7))
    for name, start in (("LAUNCHES", 5), ("LAUNCHES_WIDE", 3),
                        ("LAUNCHES_NARROW", 2)):
        monkeypatch.setattr(cuda_pooling_backward, name, start)
    f = cuda_pooling_backward.max_pooling_offsets_backward

    def run(c, aligned=True):
        n = 2 * 13 * 13 * c
        buf = torch.zeros(n + 1)
        err = (buf[:n] if aligned else buf[1:]).view(2, 13, 13, c)
        offs = torch.zeros((2, 13, 13, c), dtype=torch.int32)
        return f(err, offs, (2, 27, 27, c), 3, 3, (2, 2))
    grad = run(96)
    assert grad.shape == (2, 27, 27, 96) and _backward_counts() == (6, 4, 2)
    plan = cuda_pooling_backward.launch_plan((2, 27, 27, 96), 4, 4, 3, 3,
                                             (2, 2))
    assert stub.calls[0][3:] == (
        0, 4, 1, 2, 27, 27, 96, 13, 13, 3, 3, 2, 2, plan.ti, plan.tj,
        plan.rows, plan.cols) + plan.block + plan.grid + (7,)
    run(87)
    assert _backward_counts() == (7, 4, 3) and stub.calls[1][4] == 1
    run(96, aligned=False)
    assert _backward_counts() == (8, 4, 4) and stub.calls[2][4] == 1
    stub.code = 9
    with pytest.raises(RuntimeError, match="stub error 9"):
        run(96)
    assert _backward_counts() == (8, 4, 4) and len(stub.calls) == 4
