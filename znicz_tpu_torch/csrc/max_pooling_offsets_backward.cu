// Max / maxabs pooling backward over NHWC: routes each window's
// gradient to the winner its forward recorded.  For Hopper (sm_90a);
// plain C interface, loaded with ctypes by
// znicz_tpu_torch/ops/cuda_pooling_backward.py.
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
// after every add, as a sum in that type is.  So the result is
// bit-equal to the plain version.  Each thread writes its cells once:
// no atomics, and the same bits on every run.
//
// Bound: memory.  err and the offsets are read once and the input
// gradient written once at best: B*ny*nx*C*(sizeof(T) + 4) +
// B*H*W*C*sizeof(T) bytes over 3.35 TB/s; the compares and adds are
// far below the card's compute rate.
//
// Design (simple first): a 1-D grid-stride loop over the input cells,
// one thread per cell and vector of channels.  A thread owns VEC
// neighbouring channels (4 in f32, 8 in f16/bf16) where C and all
// three base addresses allow 16-byte accesses, else one channel; the
// wrapper chooses before the launch.  It visits only the windows that
// cover its cell: dy runs over y % sy, y % sy + sy, ... (< ky, <= y),
// so an overlapping 3x3/s2 pool costs at most 2x2 window reads per
// cell, each a 16-byte load of err and of the offsets.  A window's
// err and offsets are read by every cell it covers (9 for 3x3); those
// repeats are served from L1/L2, not device memory.  All index
// arithmetic is int32, exact because the wrapper refuses 2^31
// elements or more.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
    return v;
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
    return __float2half_rn(v);
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// VEC neighbouring channels, moved as one access of VEC*sizeof(T) bytes
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
    T v[VEC];
};

template <int VEC>
struct alignas(4 * VEC) Offsets {
    int32_t v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(256) max_pooling_backward_kernel(
        const T* __restrict__ err, const int32_t* __restrict__ offsets,
        T* __restrict__ grad, int n_packs, int h, int w, int c, int ny,
        int nx, int ky, int kx, int sy, int sx) {
    using P = Pack<T, VEC>;
    using O = Offsets<VEC>;
    const int c_packs = c / VEC;
    for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n_packs;
         idx += gridDim.x * blockDim.x) {
        const int c0 = (idx % c_packs) * VEC;
        int rest = idx / c_packs;
        const int x = rest % w;
        rest /= w;
        const int y = rest % h;
        const int b = rest / h;
        const int cell = ((b * h + y) * w + x) * c + c0;
        T acc[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = from_float<T>(0.0f);
        for (int dy = y % sy; dy < ky && dy <= y; dy += sy) {
            const int oy = (y - dy) / sy;
            if (oy >= ny) continue;  // a later dy has a smaller oy
            for (int dx = x % sx; dx < kx && dx <= x; dx += sx) {
                const int ox = (x - dx) / sx;
                if (ox >= nx) continue;
                const int out = ((b * ny + oy) * nx + ox) * c + c0;
                const O o = *reinterpret_cast<const O*>(offsets + out);
                const P e = *reinterpret_cast<const P*>(err + out);
#pragma unroll
                for (int k = 0; k < VEC; ++k)
                    if (o.v[k] == cell + k)
                        acc[k] = from_float<T>(to_float(acc[k]) +
                                               to_float(e.v[k]));
            }
        }
        P res;
#pragma unroll
        for (int k = 0; k < VEC; ++k) res.v[k] = acc[k];
        *reinterpret_cast<P*>(grad + cell) = res;
    }
}

template <typename T, int VEC>
int launch(const void* err, const void* offsets, void* grad, int b, int h,
           int w, int c, int ny, int nx, int ky, int kx, int sy, int sx,
           cudaStream_t stream) {
    const int n_packs = b * h * w * (c / VEC);
    const int threads = 256;
    const int blocks = (n_packs + threads - 1) / threads;
    max_pooling_backward_kernel<T, VEC><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(err), static_cast<const int32_t*>(offsets),
        static_cast<T*>(grad), n_packs, h, w, c, ny, nx, ky, kx, sy, sx);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_width(int vec, const void* err, const void* offsets, void* grad,
                 int b, int h, int w, int c, int ny, int nx, int ky, int kx,
                 int sy, int sx, cudaStream_t s) {
    constexpr int kWide = 16 / sizeof(T);
    if (vec == kWide && c % kWide == 0)
        return launch<T, kWide>(err, offsets, grad, b, h, w, c, ny, nx, ky,
                                kx, sy, sx, s);
    if (vec == 1)
        return launch<T, 1>(err, offsets, grad, b, h, w, c, ny, nx, ky, kx,
                            sy, sx, s);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16; vec: 16 / sizeof(T)
// (C and all three pointers 16-byte aligned) or 1.  err and offsets
// are (b, ny, nx, c), grad (b, h, w, c), all contiguous.  Launches on
// ``stream`` and does not synchronise; returns the launch's
// cudaError_t (0 = success).
extern "C" int max_pooling_offsets_backward(
        const void* err, const void* offsets, void* grad, int dtype,
        int vec, int b, int h, int w, int c, int ny, int nx, int ky, int kx,
        int sy, int sx, void* stream) {
    if (b < 1 || h < 1 || w < 1 || c < 1 || ky < 1 || kx < 1 || sy < 1 ||
        sx < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0:
            return launch_width<float>(vec, err, offsets, grad, b, h, w, c,
                                       ny, nx, ky, kx, sy, sx, s);
        case 1:
            return launch_width<__half>(vec, err, offsets, grad, b, h, w, c,
                                        ny, nx, ky, kx, sy, sx, s);
        case 2:
            return launch_width<__nv_bfloat16>(vec, err, offsets, grad, b, h,
                                               w, c, ny, nx, ky, kx, sy, sx,
                                               s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* max_pooling_offsets_backward_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
