// Max / maxabs pooling backward over NHWC: routes each window's
// gradient to the winner its forward recorded.  For Hopper (sm_90a);
// plain C interface, loaded with ctypes by
// znicz_tpu_torch/ops/cuda_pooling_backward.py, which also plans the
// launch.
//
// Counterpart of znicz_tpu/ops/pooling.py::_maxpool_bwd_dense (:118),
// the backward of max_pooling_train_jax (the fused path's "offsets"
// pooling), which the JAX package computes outside Pallas.  Given
// err (B, ny, nx, C) and the forward's int32 flat NHWC winner offsets
// of the same shape, input cell (b, y, x, c) receives the sum of
// err[b, oy, ox, c] over the windows (oy, ox) that cover it and whose
// offset is the cell's own flat index ((b*H + y)*W + x)*C + c.
//
// Order of the sum: from +0.0, over the window's row offset dy
// ascending (outer) and column offset dx ascending (inner), with
// oy = (y - dy) / sy and ox = (x - dx) / sx -- the order of
// pooling.py::max_pooling_backward_plain and of the JAX function's
// shifted accumulation.  f16 and bf16 sums are rounded to their type
// after every add, as a sum in that type is; f64 sums in double.  So the result is
// bit-equal to the plain version.  Each thread writes its cells once,
// those no window covers (+0.0) and ceil mode's overhang included: no
// atomics, and the same bits on every run.
//
// Bound: memory.  err and the offsets are read once and the input
// gradient written once at best: B*ny*nx*C*(sizeof(T) + 4) +
// B*H*W*C*sizeof(T) bytes over 3.35 TB/s; the compares and adds are
// far below the card's compute rate.  The first version of this kernel
// (a 1-D grid-stride loop, one thread per cell) reached 41-53% of that
// bound: it decoded its cell from a flat index with three divide /
// remainder pairs and divided again for each covering window, about a
// dozen divisions by runtime values per cell, and read each window
// through L1/L2 once for every cell it covers (9 for 3x3/s2).
//
// Design, after the forward kernel's (max_pooling_offsets.cu):
//  * grid without division: blockIdx.x is a 128-byte slab of channels,
//    blockIdx.y a tile of TI input rows, blockIdx.z the batch row (each
//    strides on past 65535); the block walks the row's column tiles of
//    TJ input columns (all of W unless a row does not fit).
//    threadIdx.x is the vector lane of the slab, threadIdx.y an input
//    column and threadIdx.z an input row of the tile, so a thread's
//    (b, y, x, c0) comes from the grid.  The wrapper chooses the tiles
//    and the block and grid shapes, from shape and alignment alone,
//    before the launch.  All index arithmetic is int32, exact because
//    the wrapper refuses 2^31 elements or more;
//  * the windows a tile needs are staged once: the block works out the
//    output rows [oy_lo, oy_hi] and columns [ox_lo, ox_hi] whose
//    windows touch its tile (once per tile, not per cell), copies their
//    err and offsets for its slab into shared memory with 16-byte
//    cp.async.cg (bypassing L1), and every cell then reads its covering
//    windows there.  A window comes from device memory once, plus the
//    halo row shared with the next tile (ky - sy rows for an
//    overlapping pool), instead of once per covering cell;
//  * no division in the window walk: a cell walks oy from
//    min(ny - 1, y / sy) down while y - oy*sy < ky, and ox likewise,
//    which visits dy, then dx, ascending, and only the windows that
//    cover it (at most 2 x 2 for 3x3/s2).  Every pool on the port's
//    paths has stride 2 (AlexNet's 3x3/s2, the MNIST 2x2/s2), so the
//    kernel is instantiated with the stride as the constant 2, where
//    y / 2 is a shift and nothing divides by a runtime value; one
//    instantiation with runtime strides serves every other geometry,
//    dividing once per row and once per cell of a thread (y / sy,
//    x / sx), never per window.  The window stays a runtime value in
//    both: the walk already visits only the covering windows, and a
//    constant window would double the instantiations for the 2x2 pool
//    alone.  The wrapper picks the instantiation; both are the kernel.
//    chip_smoke.py times the runtime-stride instantiation beside the
//    stride-2 one at AlexNet's training shapes: on the H100 it is
//    slower at all three pools, the more so the smaller the pool
//    (PERF.md has the times), so the constant stride stays;
//  * 16-byte vectors along C: a thread owns VEC neighbouring channels
//    (2 in f64, 4 in f32, 8 in f16/bf16) where C and all three base addresses
//    allow, compares each lane's offset on its own, and stores its cell
//    as one 16-byte vector, neighbouring lanes at neighbouring
//    addresses.  VEC = 1 serves the rest, with plain loads to stage;
//  * tiles: a block's staged windows take at most 24 KB (the wrapper's
//    TILE_BYTES), so shared memory never limits how many blocks share
//    an SM (registers and threads do: 29-48 registers, 208-224 threads
//    a block at AlexNet's pools), and one block's loads overlap the
//    others' compares and stores (a block stages, then computes, then
//    stores).
//    On the H100 24 KB timed 2-3% faster than the forward's 32 KB at
//    max_pool1 and max_pool2 (chip_smoke.py's tile sweep), although
//    its shorter tiles stage more halo rows.  At AlexNet's training
//    shapes in f32 (32 bytes a staged window and lane, err and
//    offsets):
//      max_pool1 (55x55x96):  TI = 4 input rows, all 55 columns,
//        3 output rows x 27 x 8 lanes staged = 20 KB, 5376 blocks of
//        8 x 28 x 1 threads (55 columns in two passes);
//      max_pool2 (27x27x256): TI = 9, 6 x 13 x 8 lanes = 20 KB, 3072
//        blocks of 8 x 27 x 1;
//      max_pool5 (13x13x256): all 13 rows, 6 x 6 x 8 lanes = 9 KB,
//        1024 blocks of 8 x 13 x 2;
//  * windows that no shared memory holds (the err and offsets of the
//    windows covering one input cell past the 227 KB a block may take)
//    run the UNSTAGED instantiation: the same grid and the same window
//    walk at runtime strides, reading each window's err and offset from
//    device memory (through L1/L2) instead of a staged tile.  The
//    wrapper's plan picks it, before the launch;
//  * the launch: one per pool and step, as before.  At max_pool5 an
//    empty launch between the timing events already reads about half
//    the 0.0094 ms byte bound, and its 1024 blocks run as one wave
//    that stages, computes and stores in step; nothing inside the
//    kernel takes that away (a CUDA graph of the train step could).

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// the most dynamic shared memory a block may ask for, and the threads
// of a block (the kernel's launch bounds)
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxThreads = 256;

// a + b rounded to T: exact in float for f16 and bf16 (then rounded
// once), the type's own add for f32 and f64
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ double add(double a, double b) { return a + b; }
__device__ __forceinline__ __half add(__half a, __half b) {
    return __float2half_rn(__half2float(a) + __half2float(b));
}
__device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a,
                                             __nv_bfloat16 b) {
    return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
}

template <typename T> __device__ __forceinline__ T zero_value();
template <> __device__ __forceinline__ float zero_value<float>() {
    return 0.0f;
}
template <> __device__ __forceinline__ double zero_value<double>() {
    return 0.0;
}
template <> __device__ __forceinline__ __half zero_value<__half>() {
    return __float2half_rn(0.0f);
}
template <> __device__ __forceinline__ __nv_bfloat16
zero_value<__nv_bfloat16>() {
    return __float2bfloat16_rn(0.0f);
}

// VEC neighbouring channels, moved as one access of VEC*sizeof(T) bytes
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
    T v[VEC];
};

// their VEC int32 offsets, moved as one access of 4*VEC bytes (16-byte
// aligned from 4 channels up, 8-byte for the two of an f64 vector)
template <int VEC>
struct alignas(VEC >= 4 ? 16 : 4 * VEC) Offsets {
    int32_t v[VEC];
};

// bytes of the staged offsets tile of n windows, rounded up to the
// alignment of the err tile after it (a whole number of them except for
// f64, whose err packs are wider than their offsets)
template <typename T, int VEC>
__host__ __device__ __forceinline__ size_t offsets_tile_bytes(size_t n) {
    constexpr size_t align = alignof(Pack<T, VEC>);
    return (n * sizeof(Offsets<VEC>) + align - 1) / align * align;
}

// a / s for a >= 0: a shift where s is the constant 2
__device__ __forceinline__ int div_nonneg(int a, int s) {
    return static_cast<int>(static_cast<unsigned>(a) /
                            static_cast<unsigned>(s));
}

// the first of the windows (size k, stride s) that covers index lo
__device__ __forceinline__ int first_window(int lo, int k, int s) {
    const int t = lo - k + 1;
    return t <= 0 ? 0 : div_nonneg(t + s - 1, s);
}

// one staged element: 16-byte cp.async.cg copies where it is a whole
// number of 16-byte vectors, a plain copy otherwise
template <typename X>
__device__ __forceinline__ void stage(X* dst, const X* src) {
    if constexpr (sizeof(X) % 16 == 0 && alignof(X) == 16) {
#pragma unroll
        for (int i = 0; i < (int)sizeof(X); i += 16) {
            const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(
                reinterpret_cast<unsigned char*>(dst) + i));
            const unsigned char* g =
                reinterpret_cast<const unsigned char*>(src) + i;
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                         :: "r"(s), "l"(g));
        }
    } else {
        *dst = *src;
    }
}

// STRIDE: 2 for sy = sx = 2 as constants, 0 for runtime strides;
// STAGED: the windows of a tile go through shared memory (else each is
// read from device memory)
template <typename T, int VEC, int STRIDE, bool STAGED>
__global__ void __launch_bounds__(kMaxThreads) max_pooling_backward_kernel(
        const T* __restrict__ err, const int32_t* __restrict__ offsets,
        T* __restrict__ grad, int nb, int h, int w, int c, int ny, int nx,
        int ky, int kx, int sy_arg, int sx_arg, int ti, int tj,
        int tile_rows, int tile_cols) {
    using P = Pack<T, VEC>;
    using O = Offsets<VEC>;
    const int sy = STRIDE ? STRIDE : sy_arg;
    const int sx = STRIDE ? STRIDE : sx_arg;
    extern __shared__ __align__(16) unsigned char smem[];
    const int lanes = blockDim.x;
    const int lane = threadIdx.x;
    // offsets first, their tile padded to the err tile's alignment
    O* s_off = reinterpret_cast<O*>(smem);
    P* s_err = reinterpret_cast<P*>(
        smem + offsets_tile_bytes<T, VEC>((size_t)tile_rows * tile_cols *
                                          lanes));
    const int c0 = (blockIdx.x * lanes + lane) * VEC;
    // VEC divides C when VEC > 1: a lane is wholly in or wholly out
    const bool active = c0 < c;
    for (int b = blockIdx.z; b < nb; b += gridDim.z) {
        for (int y0 = blockIdx.y * ti; y0 < h; y0 += gridDim.y * ti) {
            const int y1 = min(h, y0 + ti);
            const int oy_lo = first_window(y0, ky, sy);
            const int oy_hi = min(ny - 1, div_nonneg(y1 - 1, sy));
            const int rows = active ? oy_hi - oy_lo + 1 : 0;
            for (int x0 = 0; x0 < w; x0 += tj) {
                const int x1 = min(w, x0 + tj);
                const int ox_lo = first_window(x0, kx, sx);
                const int cols = min(nx - 1, div_nonneg(x1 - 1, sx)) -
                                 ox_lo + 1;
                // window (oy, ox) of this lane: its err and offsets at
                // [oy * row_step + ox * col_step] of win_err / win_off,
                // in the staged tile or in device memory
                const int batch = b * ny * nx * c + c0;
                const O* win_off = reinterpret_cast<const O*>(offsets +
                                                              batch);
                const P* win_err = reinterpret_cast<const P*>(err + batch);
                int row_step = nx * (c / VEC), col_step = c / VEC;
                if constexpr (STAGED) {
                    // stage the windows that touch the tile
                    for (int r = threadIdx.z; r < rows; r += blockDim.z) {
                        const int src =
                            ((b * ny + oy_lo + r) * nx + ox_lo) * c + c0;
                        const int dst = r * tile_cols * lanes + lane;
                        for (int q = threadIdx.y; q < cols;
                             q += blockDim.y) {
                            stage(s_off + dst + q * lanes,
                                  reinterpret_cast<const O*>(offsets + src +
                                                             q * c));
                            stage(s_err + dst + q * lanes,
                                  reinterpret_cast<const P*>(err + src +
                                                             q * c));
                        }
                    }
                    if constexpr (VEC > 1)
                        asm volatile("cp.async.wait_all;\n" ::: "memory");
                    __syncthreads();
                    row_step = tile_cols * lanes;
                    col_step = lanes;
                    const int origin = oy_lo * row_step + ox_lo * col_step;
                    win_off = s_off + lane - origin;
                    win_err = s_err + lane - origin;
                }
                if (active) {
                    for (int y = y0 + threadIdx.z; y < y1; y += blockDim.z) {
                        const int oy_top = min(ny - 1, div_nonneg(y, sy));
                        const int row = (b * h + y) * w;
                        for (int x = x0 + threadIdx.y; x < x1;
                             x += blockDim.y) {
                            const int ox_top = min(nx - 1, div_nonneg(x, sx));
                            const int cell = (row + x) * c + c0;
                            T acc[VEC];
#pragma unroll
                            for (int k = 0; k < VEC; ++k)
                                acc[k] = zero_value<T>();
                            // dy ascending (oy down), then dx ascending
                            for (int oy = oy_top; oy >= 0 && y - oy * sy < ky;
                                 --oy) {
                                const int srow = oy * row_step;
                                for (int ox = ox_top;
                                     ox >= 0 && x - ox * sx < kx; --ox) {
                                    const O o = win_off[srow + ox * col_step];
                                    const P e = win_err[srow + ox * col_step];
#pragma unroll
                                    for (int k = 0; k < VEC; ++k)
                                        if (o.v[k] == cell + k)
                                            acc[k] = add(acc[k], e.v[k]);
                                }
                            }
                            P res;
#pragma unroll
                            for (int k = 0; k < VEC; ++k) res.v[k] = acc[k];
                            *reinterpret_cast<P*>(grad + cell) = res;
                        }
                    }
                }
                // the tile is read before it is refilled
                if constexpr (STAGED) __syncthreads();
            }
        }
    }
}

template <typename T, int VEC, int STRIDE, bool STAGED>
int launch(const void* err, const void* offsets, void* grad, int b, int h,
           int w, int c, int ny, int nx, int ky, int kx, int sy, int sx,
           int ti, int tj, int rows, int cols, dim3 block, dim3 grid,
           cudaStream_t stream) {
    auto kernel = max_pooling_backward_kernel<T, VEC, STRIDE, STAGED>;
    const size_t n = (size_t)rows * cols * block.x;
    const size_t smem = STAGED ?
        offsets_tile_bytes<T, VEC>(n) + n * sizeof(Pack<T, VEC>) : 0;
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {  // the default limit of dynamic shared memory
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<grid, block, smem, stream>>>(
        static_cast<const T*>(err), static_cast<const int32_t*>(offsets),
        static_cast<T*>(grad), b, h, w, c, ny, nx, ky, kx, sy, sx, ti, tj,
        rows, cols);
    return (int)cudaGetLastError();
}

// the instantiations: 1 = stride 2, staged; 0 = runtime strides,
// staged; 2 = runtime strides, unstaged
template <typename T, int VEC>
int launch_variant(int variant, const void* err, const void* offsets,
                   void* grad, int b, int h, int w, int c, int ny, int nx,
                   int ky, int kx, int sy, int sx, int ti, int tj, int rows,
                   int cols, dim3 block, dim3 grid, cudaStream_t s) {
    if (variant == 1)
        return launch<T, VEC, 2, true>(err, offsets, grad, b, h, w, c, ny,
                                       nx, ky, kx, sy, sx, ti, tj, rows, cols,
                                       block, grid, s);
    if (variant == 2)
        return launch<T, VEC, 0, false>(err, offsets, grad, b, h, w, c, ny,
                                        nx, ky, kx, sy, sx, ti, tj, rows,
                                        cols, block, grid, s);
    return launch<T, VEC, 0, true>(err, offsets, grad, b, h, w, c, ny, nx,
                                   ky, kx, sy, sx, ti, tj, rows, cols, block,
                                   grid, s);
}

template <typename T>
int launch_width(int vec, int variant, const void* err, const void* offsets,
                 void* grad, int b, int h, int w, int c, int ny, int nx,
                 int ky, int kx, int sy, int sx, int ti, int tj, int rows,
                 int cols, dim3 block, dim3 grid, cudaStream_t s) {
    constexpr int kWide = 16 / sizeof(T);
    if (vec == kWide && c % kWide == 0)
        return launch_variant<T, kWide>(variant, err, offsets, grad, b, h, w,
                                        c, ny, nx, ky, kx, sy, sx, ti, tj,
                                        rows, cols, block, grid, s);
    if (vec == 1)
        return launch_variant<T, 1>(variant, err, offsets, grad, b, h, w, c,
                                    ny, nx, ky, kx, sy, sx, ti, tj, rows,
                                    cols, block, grid, s);
    return (int)cudaErrorInvalidValue;
}

// the most windows (size k, stride s, n_out of them) that touch n
// neighbouring cells
int staged(int n, int k, int s, int n_out) {
    const int m = (n + k - 2) / s + 1;
    return m < n_out ? m : n_out;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16, 3 = float64; vec:
// 16 / sizeof(T) (C and all three pointers 16-byte aligned) or 1;
// variant: the instantiation, 1 with sy = sx = 2 as constants, 0 with
// runtime strides, 2 with runtime strides and nothing staged.  err and
// offsets are (b, ny, nx, c), grad (b, h, w, c), all contiguous.
// ti x tj input cells a tile, rows x cols staged windows (at least as
// many as touch a tile), block = (lanes, by, bz) threads and grid =
// (gx, gy, gz) blocks: the wrapper's launch plan.  Launches on ``stream`` and does
// not synchronise; returns the launch's cudaError_t (0 = success).
extern "C" int max_pooling_offsets_backward(
        const void* err, const void* offsets, void* grad, int dtype,
        int vec, int variant, int b, int h, int w, int c, int ny, int nx,
        int ky, int kx, int sy, int sx, int ti, int tj, int rows, int cols,
        int lanes, int by, int bz, int gx, int gy, int gz, void* stream) {
    if (b < 1 || h < 1 || w < 1 || c < 1 || ny < 1 || nx < 1 || ky < 1 ||
        kx < 1 || sy < 1 || sx < 1 || ti < 1 || tj < 1 || lanes < 1 ||
        by < 1 || bz < 1 || lanes * by * bz > kMaxThreads || gx < 1 ||
        (long long)gx * lanes * vec < c || gy < 1 || gy > 65535 || gz < 1 ||
        gz > 65535 || variant < 0 || variant > 2 ||
        (variant == 1 && (sy != 2 || sx != 2)) ||
        rows < staged(ti, ky, sy, ny) || cols < staged(tj, kx, sx, nx))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 block(lanes, by, bz), grid(gx, gy, gz);
    switch (dtype) {
        case 0:
            return launch_width<float>(vec, variant, err, offsets, grad, b, h,
                                       w, c, ny, nx, ky, kx, sy, sx, ti, tj,
                                       rows, cols, block, grid, s);
        case 1:
            return launch_width<__half>(vec, variant, err, offsets, grad, b,
                                        h, w, c, ny, nx, ky, kx, sy, sx, ti,
                                        tj, rows, cols, block, grid, s);
        case 2:
            return launch_width<__nv_bfloat16>(
                vec, variant, err, offsets, grad, b, h, w, c, ny, nx, ky, kx,
                sy, sx, ti, tj, rows, cols, block, grid, s);
        case 3:
            return launch_width<double>(vec, variant, err, offsets, grad, b,
                                        h, w, c, ny, nx, ky, kx, sy, sx, ti,
                                        tj, rows, cols, block, grid, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* max_pooling_offsets_backward_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
