// Max / maxabs pooling over NHWC with flat winner offsets, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// znicz_tpu_torch/ops/cuda_pooling.py, which also plans the launch.
//
// Replaces the TPU kernel
//   znicz_tpu/ops/pallas_pooling.py::max_pooling_offsets_pallas
//   (body _kernel :24-80, pl.pallas_call :97).
// Same function, not the same blocks: for each output (b, i, j, c) it
// returns the window's value (signed for maxabs) and the FLAT NHWC
// offset of the winner, ((b*H + wy)*W + wx)*C + c, as int32.  The
// window is ceil-mode and truncated at the right/bottom edge; ties go
// to the FIRST cell in row-major window order (dy outer, dx inner)
// through a strict '>' compare on the key (|x| for maxabs): in float32
// for f32/f16/bf16 (exact for the narrower types), in double for f64,
// where a float key could round two values to one and flip a winner.
//
// Bound: memory.  Each input byte is read once and each output written
// once at best: B*H*W*C*sizeof(T) + B*ny*nx*C*(sizeof(T) + 4) bytes
// over 3.35 TB/s; the ky*kx compares per output are far below the
// card's compute rate.
//
// Design:
//  * grid without division: blockIdx.x is a slab of channels,
//    blockIdx.y a tile of TI output rows, blockIdx.z the batch row
//    (each strides on past 65535); threadIdx.x is the vector lane of
//    the slab, threadIdx.y an output column, threadIdx.z an output row
//    of the tile.  All index and offset arithmetic is int32, exact
//    because the wrapper refuses 2^31 elements or more;
//  * the block stages the input rows [i0*sy, min(H, (i0+TI-1)*sy+ky))
//    x its columns x its channel slab into shared memory once, with
//    16-byte cp.async.cg (bypassing L1), and every window then reads
//    shared memory: the 2.25 reads per input cell of an overlapping
//    3x3/s2 pool cost one trip to device memory, plus the halo rows
//    shared with the next tile.  Rows and columns past the input are
//    not staged;
//  * 16-byte vectors along C: a thread owns VEC neighbouring channels
//    (2 in f64, 4 in f32, 8 in f16/bf16), compares each lane on its own (so the
//    tie rule holds per lane), and stores the values as one 16-byte
//    vector and the offsets as 16-byte int4 vectors.  VEC = 1 serves
//    channel counts or base pointers that 16 bytes do not divide (the
//    wrapper chooses before the launch), with plain loads to stage;
//  * the slab is 128 bytes of channels (8 lanes of 16 bytes, or 32 or
//    64 scalar lanes) or less when C is small.  TI (and a column tile
//    TJ, all of nx unless a row does not fit) is chosen by the wrapper
//    so that a tile takes at most 32 KB: shared memory then never
//    limits how many blocks share an SM (registers do, at 4-5 for
//    AlexNet's pools), and one block's loads overlap the others'
//    compares and stores (a block loads, then computes, then stores).
//    Tiles of 16-32 KB timed faster on the H100 than 64 KB
//    (chip_smoke.py's tile sweep): the halo rows a smaller tile reads
//    again come from L2.
//    max_pool1 (55x55x96 f32): TI = 1, 3 rows x 55 x 128 B = 21 KB,
//    5184 blocks of 216 threads; max_pool2 (27x27x256): TI = 4, 31 KB;
//    max_pool5 (13x13x256): all 13 rows, 21 KB, 512 blocks in one
//    wave;
//  * a window that no shared memory holds (its rows x columns x one
//    lane of the slab past the 227 KB a block may take) runs the
//    UNSTAGED instantiation: the same grid and the same window walk,
//    reading each window from device memory (through L1/L2) instead of
//    a staged tile.  The wrapper's plan picks it, before the launch;
//  * the loop runs over the TRUNCATED window, so overhanging cells
//    never win; the window origin seeds the running best, so a real
//    -inf input wins its window without a sentinel.  A window wholly
//    past the edge (stride > window only) yields 0 at its origin
//    offset, as the TPU kernel's zero padding does.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

// the most dynamic shared memory a block may ask for (the wrapper's
// plan stays far below it)
constexpr int kMaxSmem = 227 * 1024;

// the key a window compares: float for f32/f16/bf16, double for f64
__device__ __forceinline__ float to_key(float v) { return v; }
__device__ __forceinline__ float to_key(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_key(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ double to_key(double v) { return v; }
__device__ __forceinline__ float key_abs(float v) { return fabsf(v); }
__device__ __forceinline__ double key_abs(double v) { return fabs(v); }
template <typename T> struct KeyOf { using type = float; };
template <> struct KeyOf<double> { using type = double; };
template <typename T>
using Key = typename KeyOf<T>::type;

template <typename T> __device__ __forceinline__ T zero_value();
template <> __device__ __forceinline__ float zero_value<float>() {
    return 0.0f;
}
template <> __device__ __forceinline__ __half zero_value<__half>() {
    return __float2half(0.0f);
}
template <> __device__ __forceinline__ __nv_bfloat16
zero_value<__nv_bfloat16>() {
    return __float2bfloat16(0.0f);
}
template <> __device__ __forceinline__ double zero_value<double>() {
    return 0.0;
}

// VEC neighbouring channels, moved as one access of VEC*sizeof(T) bytes
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
    T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void stage(Pack<T, VEC>* dst,
                                      const Pack<T, VEC>* src) {
    if constexpr (sizeof(Pack<T, VEC>) == 16) {
        const unsigned s =
            static_cast<unsigned>(__cvta_generic_to_shared(dst));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(s), "l"(src));
    } else {
        *dst = *src;
    }
}

// Output pack (b, i, j, channels c0..c0+VEC) from the input cells
// ``cells[wy * row_step + wx * col_step]``: this lane's pack of input
// cell (wy, wx) of batch row b, in the staged tile or in device memory.
template <typename T, int VEC>
__device__ __forceinline__ void pool_window(
        const Pack<T, VEC>* cells, int row_step, int col_step, T* values,
        int32_t* offsets, int b, int i, int j, int c0, int h, int w, int c,
        int ny, int nx, int ky, int kx, int sy, int sx, int use_abs) {
    using P = Pack<T, VEC>;
    const int y0 = i * sy;
    const int x0 = j * sx;
    const int origin = ((b * h + y0) * w + x0) * c + c0;
    P best;
    Key<T> key[VEC];
    int32_t off[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) off[k] = origin + k;
    if (y0 >= h || x0 >= w) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) best.v[k] = zero_value<T>();
    } else {
        const int y1 = min(y0 + ky, h);
        const int x1 = min(x0 + kx, w);
        best = cells[y0 * row_step + x0 * col_step];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            key[k] = to_key(best.v[k]);
            if (use_abs) key[k] = key_abs(key[k]);
        }
        for (int wy = y0; wy < y1; ++wy) {
            const P* row = cells + wy * row_step;
            const int row_off = (b * h + wy) * w * c + c0;
            for (int wx = (wy == y0 ? x0 + 1 : x0); wx < x1; ++wx) {
                const P v = row[wx * col_step];
#pragma unroll
                for (int k = 0; k < VEC; ++k) {
                    Key<T> kk = to_key(v.v[k]);
                    if (use_abs) kk = key_abs(kk);
                    if (kk > key[k]) {  // strict: the first winner stays
                        key[k] = kk;
                        best.v[k] = v.v[k];
                        off[k] = row_off + wx * c + k;
                    }
                }
            }
        }
    }
    const int out = ((b * ny + i) * nx + j) * c + c0;
    *reinterpret_cast<P*>(values + out) = best;
    if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int k = 0; k < VEC; k += 4)
            *reinterpret_cast<int4*>(offsets + out + k) =
                make_int4(off[k], off[k + 1], off[k + 2], off[k + 3]);
    } else if constexpr (VEC == 2) {
        *reinterpret_cast<int2*>(offsets + out) = make_int2(off[0], off[1]);
    } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) offsets[out + k] = off[k];
    }
}

// STAGED: the block's input rows go through shared memory (else each
// window reads device memory)
template <typename T, int VEC, bool STAGED>
__global__ void __launch_bounds__(256) max_pooling_offsets_kernel(
        const T* __restrict__ x, T* __restrict__ values,
        int32_t* __restrict__ offsets, int nb, int h, int w, int c, int ny,
        int nx, int ky, int kx, int sy, int sx, int ti, int tj,
        int tile_rows, int tile_cols, int use_abs) {
    using P = Pack<T, VEC>;
    extern __shared__ __align__(16) unsigned char smem[];
    const int lanes = blockDim.x;
    const P* lane_tile = reinterpret_cast<const P*>(smem) + threadIdx.x;
    P* stage_row = reinterpret_cast<P*>(smem) + threadIdx.x;
    const int c0 = (blockIdx.x * lanes + threadIdx.x) * VEC;
    const int c_packs = c / VEC;  // packs from one column to the next
    // VEC divides C when VEC > 1: a lane is wholly in or wholly out
    const bool active = c0 < c;
    for (int b = blockIdx.z; b < nb; b += gridDim.z) {
        for (int i0 = blockIdx.y * ti; i0 < ny; i0 += gridDim.y * ti) {
            const int row0 = i0 * sy;
            const int i1 = min(ny, i0 + ti);
            for (int j0 = 0; j0 < nx; j0 += tj) {
                const int col0 = j0 * sx;
                const int j1 = min(nx, j0 + tj);
                // input cell (wy, wx) of this lane: staged tile cell
                // (wy - row0, wx - col0), or the cell in device memory
                const P* cells = reinterpret_cast<const P*>(
                    x + b * h * w * c + c0);
                int row_step = w * c_packs, col_step = c_packs;
                if constexpr (STAGED) {
                    // stage rows/columns of the tile that lie in the input
                    const int rows = active ? min(tile_rows, h - row0) : 0;
                    const int cols = min(tile_cols, w - col0);
                    for (int r = threadIdx.z; r < rows; r += blockDim.z) {
                        const P* src = reinterpret_cast<const P*>(
                            x + ((b * h + row0 + r) * w + col0) * c + c0);
                        P* dst = stage_row + r * tile_cols * lanes;
                        for (int q = threadIdx.y; q < cols; q += blockDim.y)
                            stage<T, VEC>(dst + q * lanes,
                                          src + q * c_packs);
                    }
                    if constexpr (sizeof(P) == 16)
                        asm volatile("cp.async.wait_all;\n" ::: "memory");
                    __syncthreads();
                    row_step = tile_cols * lanes;
                    col_step = lanes;
                    cells = lane_tile - row0 * row_step - col0 * col_step;
                }
                if (active) {
                    for (int i = i0 + threadIdx.z; i < i1; i += blockDim.z)
                        for (int j = j0 + threadIdx.y; j < j1;
                             j += blockDim.y)
                            pool_window<T, VEC>(
                                cells, row_step, col_step, values, offsets,
                                b, i, j, c0, h, w, c, ny, nx, ky, kx, sy, sx,
                                use_abs);
                }
                // the tile is read before it is refilled
                if constexpr (STAGED) __syncthreads();
            }
        }
    }
}

template <typename T, int VEC, bool STAGED>
int launch(const void* x, void* values, void* offsets, int b, int h, int w,
           int c, int ny, int nx, int ky, int kx, int sy, int sx, int lanes,
           int ti, int tj, int use_abs, cudaStream_t stream) {
    auto kernel = max_pooling_offsets_kernel<T, VEC, STAGED>;
    const int tile_rows = std::min(h, (ti - 1) * sy + ky);
    const int tile_cols = std::min(w, (tj - 1) * sx + kx);
    const size_t smem = STAGED ?
        (size_t)tile_rows * tile_cols * lanes * sizeof(Pack<T, VEC>) : 0;
    if (lanes < 1 || lanes > 256 || ti < 1 || tj < 1 ||
        smem > (size_t)kMaxSmem)
        return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {  // the default limit of dynamic shared memory
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    // lanes x output columns x output rows of the tile, at most 256
    const int by = std::max(1, std::min(tj, 256 / lanes));
    const int bz = std::max(1, std::min({ti, 64, 256 / (lanes * by)}));
    const int slabs = ((c + VEC - 1) / VEC + lanes - 1) / lanes;
    const dim3 grid(slabs, std::min((ny + ti - 1) / ti, 65535),
                    std::min(b, 65535));
    kernel<<<grid, dim3(lanes, by, bz), smem, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(values),
        static_cast<int32_t*>(offsets), b, h, w, c, ny, nx, ky, kx, sy, sx,
        ti, tj, tile_rows, tile_cols, use_abs);
    return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_staged(int staged, const void* x, void* values, void* offsets,
                  int b, int h, int w, int c, int ny, int nx, int ky, int kx,
                  int sy, int sx, int lanes, int ti, int tj, int use_abs,
                  cudaStream_t s) {
    if (staged)
        return launch<T, VEC, true>(x, values, offsets, b, h, w, c, ny, nx,
                                    ky, kx, sy, sx, lanes, ti, tj, use_abs,
                                    s);
    return launch<T, VEC, false>(x, values, offsets, b, h, w, c, ny, nx, ky,
                                 kx, sy, sx, lanes, ti, tj, use_abs, s);
}

template <typename T>
int launch_width(int vec, int staged, const void* x, void* values,
                 void* offsets, int b, int h, int w, int c, int ny, int nx,
                 int ky, int kx, int sy, int sx, int lanes, int ti, int tj,
                 int use_abs, cudaStream_t s) {
    constexpr int kWide = 16 / sizeof(T);
    if (vec == kWide && c % kWide == 0)
        return launch_staged<T, kWide>(staged, x, values, offsets, b, h, w,
                                       c, ny, nx, ky, kx, sy, sx, lanes, ti,
                                       tj, use_abs, s);
    if (vec == 1)
        return launch_staged<T, 1>(staged, x, values, offsets, b, h, w, c,
                                   ny, nx, ky, kx, sy, sx, lanes, ti, tj,
                                   use_abs, s);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16, 3 = float64; vec:
// 16 / sizeof(T) (C and x 16-byte aligned) or 1; staged: 1 to stage the
// tiles in shared memory, 0 for the unstaged instantiation; lanes, ti,
// tj: the wrapper's launch plan.  Launches on ``stream`` and does not
// synchronise; returns the launch's cudaError_t (0 = success).
extern "C" int max_pooling_offsets(const void* x, void* values,
                                   void* offsets, int dtype, int vec,
                                   int staged, int b, int h, int w, int c,
                                   int ny, int nx, int ky, int kx, int sy,
                                   int sx, int lanes, int ti, int tj,
                                   int use_abs, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0:
            return launch_width<float>(vec, staged, x, values, offsets, b, h,
                                       w, c, ny, nx, ky, kx, sy, sx, lanes,
                                       ti, tj, use_abs, s);
        case 1:
            return launch_width<__half>(vec, staged, x, values, offsets, b,
                                        h, w, c, ny, nx, ky, kx, sy, sx,
                                        lanes, ti, tj, use_abs, s);
        case 2:
            return launch_width<__nv_bfloat16>(vec, staged, x, values,
                                               offsets, b, h, w, c, ny, nx,
                                               ky, kx, sy, sx, lanes, ti, tj,
                                               use_abs, s);
        case 3:
            return launch_width<double>(vec, staged, x, values, offsets, b,
                                        h, w, c, ny, nx, ky, kx, sy, sx,
                                        lanes, ti, tj, use_abs, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* max_pooling_offsets_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
