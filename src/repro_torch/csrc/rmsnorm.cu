// Row-wise RMS normalisation, y = x * rsqrt(mean(x^2) + eps) * w, for
// Hopper.
//
// A kernel of the port's own: the reference package computes rmsnorm in
// plain jnp (src/repro/models/layers.py: rmsnorm), so no TPU kernel stands
// behind it.  It exists for one guarantee the library reductions do not
// give: a row's result depends on that row alone, never on how many rows
// the call holds.  PyTorch's mean over the last axis picks its reduction
// layout from the whole tensor's shape, so on the card a verify round's 40
// rows and a decode step's 8 rows normalised the same row with sums taken
// in different orders (last-bit differences that flip bf16 argmaxes and
// made speculation-on differ from speculation-off).
//
// Design: one block per row, kThreads threads whatever the row count (the
// grid alone grows with rows).  Thread t accumulates x[t], x[t + kThreads],
// ... in float32, in that order; the warp combines its 32 partial sums with
// a fixed xor-shuffle tree (16, 8, 4, 2, 1), warp 0 combines the warps'
// sums in shared memory with the same tree, and every thread reads the
// row's sum back.  Then each thread writes its columns as
// (x * rsqrt(sum / D + eps)) * w in float32, cast to x's dtype (the plain
// version's order of operations).  Every step is fixed by D alone, so rows
// 0..7 of an 8-row call equal the same rows inside 40 or 512 bit for bit.
//
// What bounds it: the bytes, x read twice (the second read mostly from L1 /
// L2), y written once, w read per block from L2; two flops a byte.  At the
// decode shapes (8 rows of 896) a call is a launch, not a stream of bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float warp_tree(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w,
                   T* __restrict__ y, int D, long long x_rs, long long y_rs,
                   float eps) {
  __shared__ float warp_sums[kWarps];
  const T* xr = x + (long long)blockIdx.x * x_rs;
  T* yr = y + (long long)blockIdx.x * y_rs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float acc = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float v = to_f32(xr[i]);
    acc = fmaf(v, v, acc);
  }
  acc = warp_tree(acc);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    float s = lane < kWarps ? warp_sums[lane] : 0.f;
    s = warp_tree(s);
    if (lane == 0) warp_sums[0] = s;
  }
  __syncthreads();
  const float r = rsqrtf(warp_sums[0] / (float)D + eps);
  for (int i = threadIdx.x; i < D; i += kThreads)
    yr[i] = from_f32<T>((to_f32(xr[i]) * r) * to_f32(w[i]));
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int D,
                   long long x_rs, long long y_rs, float eps,
                   cudaStream_t st) {
  if (rows == 0) return cudaSuccess;
  rmsnorm_kernel<T, W><<<rows, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y),
      D, x_rs, y_rs, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16.  x and y are [rows, D] with
// a contiguous last axis and row strides x_rs / y_rs (in elements); w is a
// contiguous [D].
int rmsnorm_launch(const void* x, const void* w, void* y, int rows, int D,
                   int x_dtype, int w_dtype, long long x_rs, long long y_rs,
                   float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 0 || D < 1) return (int)cudaErrorInvalidValue;
  if (x_dtype == 0 && w_dtype == 0)
    return (int)launch<float, float>(x, w, y, rows, D, x_rs, y_rs, eps, st);
  if (x_dtype == 0 && w_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(x, w, y, rows, D, x_rs, y_rs,
                                             eps, st);
  if (x_dtype == 1 && w_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(x, w, y, rows, D, x_rs, y_rs,
                                             eps, st);
  if (x_dtype == 1 && w_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, D, x_rs,
                                                     y_rs, eps, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
