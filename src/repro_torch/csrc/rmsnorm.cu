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
// Design.  A row is cut into chunks of E elements, E = 16 bytes / element
// (8 bf16, 4 float32); the last chunk may be partial.  The row's T threads
// own chunks round robin: thread t holds chunks t, t + T, ..., at most NV of
// them, in registers, read once with one 16-byte load each (element loads
// where the row's base, stride or D rule vectors out; the chunks, and so
// the sums, are the same either way).  Thread t accumulates its squares in
// float32 in the order (chunk, element), the warp combines its 32 partial
// sums with a fixed xor-shuffle tree (16, 8, 4, 2, 1), and with more than
// one warp a row, warp 0 combines the warps' sums with the same tree.  Then
// each thread scales the chunks it holds as (x * rsqrt(sum / D + eps)) * w
// in float32, cast to x's dtype (the plain version's order of operations).
//   * up to 256 chunks a row (D <= 2048 in bf16, 1024 in float32; 896 in
//     qwen2-0.5b): one warp a row, T = 32, four rows a block;
//   * more: one block a row, T = the smallest multiple of 32 that leaves a
//     thread at most 4 chunks (at most 1024 threads, then 8 chunks), e.g.
//     256 threads at D 8192 in bf16 (llama-3.2-vision-90b).
// T and the chunk layout follow from D and x's dtype alone, so rows 0..7 of
// an 8-row call equal the same rows inside 40 or 512 bit for bit.
//
// What bounds it: the bytes, x read once, y written once, w read per row
// from L1 / L2; two flops a byte.  At the decode shapes (8 rows of 896) a
// call is a launch, not a stream of bytes: the wrapper's host path is the
// cost (kernels/rmsnorm.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpRows = 4;          // rows (warps) a block in the warp path
constexpr int kWarpChunks = 256;      // chunks a row the warp path takes
constexpr int kMaxChunks = 8192;      // 1024 threads x 8 chunks

template <typename T>
struct Elt;
template <>
struct Elt<float> {
  using Bits = uint32_t;
  __device__ static float to_f32(Bits b) { return __uint_as_float(b); }
  __device__ static Bits from_f32(float v) { return __float_as_uint(v); }
};
template <>
struct Elt<__nv_bfloat16> {
  using Bits = uint16_t;
  __device__ static float to_f32(Bits b) {
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  __device__ static Bits from_f32(float v) {
    // round to nearest even, as torch's .to()
    return __bfloat16_as_ushort(__float2bfloat16(v));
  }
};

// The E elements of w under one chunk of x, as raw bits (zeros past D),
// loaded with the vector width that E elements of W take (8, 16 or 32
// bytes) where the row allows vectors.
template <typename W, int E>
struct WChunk {
  using B = typename Elt<W>::Bits;
  static constexpr int kBytes = E * (int)sizeof(W);
  alignas(kBytes >= 16 ? 16 : 8) uint32_t u[kBytes / 4];

  __device__ __forceinline__ void load(const W* __restrict__ w, int c, int D,
                                       bool vec) {
    const int base = c * E;
    if (vec && base + E <= D) {
      if constexpr (kBytes >= 16) {
#pragma unroll
        for (int j = 0; j < kBytes / 16; ++j)
          reinterpret_cast<uint4*>(u)[j] =
              reinterpret_cast<const uint4*>(w + base)[j];
      } else {
        *reinterpret_cast<uint2*>(u) =
            *reinterpret_cast<const uint2*>(w + base);
      }
      return;
    }
    B* b = reinterpret_cast<B*>(u);
    const B* wb = reinterpret_cast<const B*>(w);
#pragma unroll
    for (int e = 0; e < E; ++e) b[e] = base + e < D ? wb[base + e] : B(0);
  }
  __device__ __forceinline__ float get(int e) const {
    return Elt<W>::to_f32(reinterpret_cast<const B*>(u)[e]);
  }
};

__device__ __forceinline__ float warp_tree(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// WARP_ROWS: one warp a row (T = 32); else one block a row (T = blockDim.x).
// NV: the most chunks a thread holds (a bound; the layout depends on T).
// In the warp path a thread loads its w chunks beside its x chunks, before
// the reduction, so their latency hides behind it; in the block path (up to
// 1024 threads, so at most 64 registers) it loads them after.
template <typename T, typename W, int NV, bool WARP_ROWS>
__global__ void __launch_bounds__(WARP_ROWS ? 32 * kWarpRows : 1024)
    rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w,
                   T* __restrict__ y, int rows, int D, long long x_rs,
                   float eps, bool vec) {
  using B = typename Elt<T>::Bits;
  constexpr int E = 16 / (int)sizeof(T);
  __shared__ float warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = WARP_ROWS ? blockIdx.x * kWarpRows + warp : blockIdx.x;
  if (WARP_ROWS && row >= rows) return;        // whole warps only
  const int tid = WARP_ROWS ? lane : threadIdx.x;
  const int nthr = WARP_ROWS ? 32 : blockDim.x;
  const T* xr = x + (long long)row * x_rs;
  T* yr = y + (long long)row * D;

  constexpr bool kPrefetchW = WARP_ROWS;
  uint4 raw[NV];
  WChunk<W, E> wc[kPrefetchW ? NV : 1];
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int base = (k * nthr + tid) * E;
    if constexpr (kPrefetchW) wc[k].load(w, k * nthr + tid, D, vec);
    if (vec && base + E <= D) {
      raw[k] = *reinterpret_cast<const uint4*>(xr + base);
    } else {
      B* b = reinterpret_cast<B*>(&raw[k]);
      const B* xb = reinterpret_cast<const B*>(xr);
#pragma unroll
      for (int e = 0; e < E; ++e) b[e] = base + e < D ? xb[base + e] : B(0);
    }
    const B* b = reinterpret_cast<const B*>(&raw[k]);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float v = Elt<T>::to_f32(b[e]);
      acc = fmaf(v, v, acc);        // zeros past D leave acc as it is
    }
  }
  acc = warp_tree(acc);
  if (!WARP_ROWS && nthr > 32) {
    if (lane == 0) warp_sums[warp] = acc;
    __syncthreads();
    if (warp == 0) {
      float s = lane < (nthr >> 5) ? warp_sums[lane] : 0.f;
      s = warp_tree(s);
      if (lane == 0) warp_sums[0] = s;
    }
    __syncthreads();
    acc = warp_sums[0];
  }
  const float r = rsqrtf(acc / (float)D + eps);

#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = k * nthr + tid;
    const int base = c * E;
    if (base >= D) break;
    WChunk<W, E> wk;
    if constexpr (kPrefetchW)
      wk = wc[k];
    else
      wk.load(w, c, D, vec);
    const B* b = reinterpret_cast<const B*>(&raw[k]);
    uint4 o;
    B* ob = reinterpret_cast<B*>(&o);
#pragma unroll
    for (int e = 0; e < E; ++e)
      ob[e] = Elt<T>::from_f32((Elt<T>::to_f32(b[e]) * r) * wk.get(e));
    if (vec && base + E <= D) {
      *reinterpret_cast<uint4*>(yr + base) = o;
    } else {
      B* yb = reinterpret_cast<B*>(yr);
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (base + e < D) yb[base + e] = ob[e];
    }
  }
}

template <typename T, typename W, bool WARP_ROWS>
cudaError_t launch_nv(int nv, dim3 grid, int threads, const void* x,
                      const void* w, void* y, int rows, int D, long long x_rs,
                      float eps, bool vec, cudaStream_t st) {
  auto* xt = static_cast<const T*>(x);
  auto* wt = static_cast<const W*>(w);
  auto* yt = static_cast<T*>(y);
  switch (nv) {
#define CASE(N)                                                              \
  case N:                                                                    \
    rmsnorm_kernel<T, W, N, WARP_ROWS>                                       \
        <<<grid, threads, 0, st>>>(xt, wt, yt, rows, D, x_rs, eps, vec);     \
    break;
    CASE(1) CASE(2) CASE(4) CASE(8)
#undef CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* y, int rows, int D,
                   long long x_rs, float eps, cudaStream_t st) {
  constexpr int E = 16 / (int)sizeof(T);
  const int chunks = (D + E - 1) / E;
  if (chunks > kMaxChunks) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const bool vec = D % E == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   (x_rs * (long long)sizeof(T)) % 16 == 0;
  if (chunks <= kWarpChunks) {
    const int nv = pow2_at_least((chunks + 31) / 32);
    return launch_nv<T, W, true>(nv, dim3((rows + kWarpRows - 1) / kWarpRows),
                                 32 * kWarpRows, x, w, y, rows, D, x_rs, eps,
                                 vec, st);
  }
  int threads = ((chunks + 3) / 4 + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  const int nv = (chunks + threads - 1) / threads <= 4 ? 4 : 8;
  return launch_nv<T, W, false>(nv, dim3(rows), threads, x, w, y, rows, D,
                                x_rs, eps, vec, st);
}

}  // namespace

extern "C" {

// One launch's arguments, packed by the wrapper with Python's struct
// module in native layout ("@PPPqqqqfP"): one pointer crosses ctypes
// instead of nine converted arguments.
struct RmsnormArgs {
  const void* x;     // [rows, D], last axis contiguous, row stride x_rs
  const void* w;     // contiguous [D]
  void* y;           // contiguous [rows, D]
  long long rows, D;
  long long dtypes;  // 0 = float32 x and w, 1 = float32 x, bf16 w,
                     // 2 = bf16 x, float32 w, 3 = bf16 x and w
  long long x_rs;    // in elements
  float eps;
  void* stream;
};

// D may hold at most 8192 chunks of 16 bytes (65536 bf16, 32768 float32).
int rmsnorm_launch(const RmsnormArgs* a) {
  cudaStream_t st = static_cast<cudaStream_t>(a->stream);
  if (a->rows < 0 || a->rows > 0x7FFFFFFF || a->D < 1 || a->D > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  const int rows = (int)a->rows, D = (int)a->D;
  switch (a->dtypes) {
    case 0:
      return (int)launch<float, float>(a->x, a->w, a->y, rows, D, a->x_rs,
                                       a->eps, st);
    case 1:
      return (int)launch<float, __nv_bfloat16>(a->x, a->w, a->y, rows, D,
                                               a->x_rs, a->eps, st);
    case 2:
      return (int)launch<__nv_bfloat16, float>(a->x, a->w, a->y, rows, D,
                                               a->x_rs, a->eps, st);
    case 3:
      return (int)launch<__nv_bfloat16, __nv_bfloat16>(a->x, a->w, a->y, rows,
                                                       D, a->x_rs, a->eps, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
