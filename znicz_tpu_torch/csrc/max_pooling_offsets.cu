// Max / maxabs pooling over NHWC with flat winner offsets, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// znicz_tpu_torch/ops/cuda_pooling.py.
//
// Replaces the TPU kernel
//   znicz_tpu/ops/pallas_pooling.py::max_pooling_offsets_pallas
//   (body _kernel :24-80, pl.pallas_call :97).
// Same function, not the same blocks: for each output (b, i, j, c) it
// returns the window's value (signed for maxabs) and the FLAT NHWC
// offset of the winner, ((b*H + wy)*W + wx)*C + c, as int32.  The
// window is ceil-mode and truncated at the right/bottom edge; ties go
// to the FIRST cell in row-major window order (dy outer, dx inner)
// through a strict '>' compare on the key (|x| for maxabs).
//
// Bound: memory.  Each input byte is read once and each output written
// once at best: B*H*W*C*sizeof(T) + B*ny*nx*C*(sizeof(T) + 4) bytes
// over 3.35 TB/s; the ky*kx compares per output are far below the
// card's compute rate.
//
// Design (simple and right first):
//  * one thread per output element, c fastest, so a warp's loads of
//    one window cell are 32 neighbouring channels of NHWC memory;
//  * a loop over the TRUNCATED window — overhanging cells are never
//    visited, so they never win;
//  * the window origin, always inside the input when the stride does
//    not exceed the window, seeds the running best, so a real -inf
//    input wins its window without any padding sentinel.  A window
//    wholly past the edge (stride > window only) yields 0 at its
//    origin offset, as the TPU kernel's zero padding does;
//  * keys are compared in float32; f16/bf16 convert only through the
//    intrinsics, which is exact;
//  * offsets are computed in int64 and stored as int32 (the wrapper
//    refuses inputs of 2^31 elements or more).
// Shared-memory tiles and vector loads are later work.

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

template <typename T>
__global__ void max_pooling_offsets_kernel(
        const T* __restrict__ x, T* __restrict__ values,
        int32_t* __restrict__ offsets, int h, int w, int c, int ny, int nx,
        int ky, int kx, int sy, int sx, bool use_abs, int64_t total) {
    const int64_t idx =
        (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const int ch = (int)(idx % c);
    int64_t rest = idx / c;
    const int j = (int)(rest % nx);
    rest /= nx;
    const int i = (int)(rest % ny);
    const int64_t b = rest / ny;
    const int y0 = i * sy;
    const int x0 = j * sx;
    int64_t best_off = ((b * h + y0) * w + x0) * c + ch;
    T best_val;
    if (y0 >= h || x0 >= w) {
        best_val = zero_value<T>();
    } else {
        const int y1 = min(y0 + ky, h);
        const int x1 = min(x0 + kx, w);
        best_val = x[best_off];
        float best_key = to_float(best_val);
        if (use_abs) best_key = fabsf(best_key);
        for (int wy = y0; wy < y1; ++wy) {
            const int64_t row = (b * h + wy) * w;
            for (int wx = (wy == y0 ? x0 + 1 : x0); wx < x1; ++wx) {
                const int64_t off = (row + wx) * c + ch;
                const T v = x[off];
                float key = to_float(v);
                if (use_abs) key = fabsf(key);
                if (key > best_key) {  // strict: the first winner stays
                    best_key = key;
                    best_val = v;
                    best_off = off;
                }
            }
        }
    }
    values[idx] = best_val;
    offsets[idx] = (int32_t)best_off;
}

template <typename T>
int launch(const void* x, void* values, void* offsets, int b, int h, int w,
           int c, int ny, int nx, int ky, int kx, int sy, int sx,
           int use_abs, cudaStream_t stream) {
    const int64_t total = (int64_t)b * ny * nx * c;
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    max_pooling_offsets_kernel<T><<<(unsigned int)blocks, threads, 0,
                                     stream>>>(
        static_cast<const T*>(x), static_cast<T*>(values),
        static_cast<int32_t*>(offsets), h, w, c, ny, nx, ky, kx, sy, sx,
        use_abs != 0, total);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  Launches on
// ``stream`` and does not synchronise; returns the launch's
// cudaError_t (0 = success).
extern "C" int max_pooling_offsets(const void* x, void* values,
                                   void* offsets, int dtype, int b, int h,
                                   int w, int c, int ny, int nx, int ky,
                                   int kx, int sy, int sx, int use_abs,
                                   void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0:
            return launch<float>(x, values, offsets, b, h, w, c, ny, nx, ky,
                                 kx, sy, sx, use_abs, s);
        case 1:
            return launch<__half>(x, values, offsets, b, h, w, c, ny, nx,
                                  ky, kx, sy, sx, use_abs, s);
        case 2:
            return launch<__nv_bfloat16>(x, values, offsets, b, h, w, c, ny,
                                         nx, ky, kx, sy, sx, use_abs, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* max_pooling_offsets_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
