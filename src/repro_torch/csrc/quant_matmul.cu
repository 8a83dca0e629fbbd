// int8-weight matrix product with per-output-channel scales, for Hopper:
//     out[m, n] = (sum_k x[m, k] * w_q[k, n]) * scales[n]
// with f32 accumulation and the output in x's dtype (float32 or bfloat16).
//
// Replaces the reference package's Pallas TPU kernel
// src/repro/kernels/quant_matmul.py: quant_matmul_pallas (body _qmm_kernel).
// That kernel pads x and w_q to (bm, bn, bk) blocks and carries an f32 VMEM
// accumulator across a sequential K grid axis.  Here nothing is padded or
// copied: one block owns an output tile and walks K itself, masking the
// ragged edges of M, N and K.  As in _qmm_kernel, the scales are applied
// once, after the K loop (the reference's quant_matmul_ref scales the
// weights before the sum, which rounds differently: ~1e-6 relative in f32).
//
// What bounds it: at decode widths (M <= 8 rows) the int8 weight bytes
// (K*N, read once); at prefill widths (M of 512 and up) the 2*M*K*N
// operations.  This first version multiplies in f32 on the CUDA cores,
// so the float32 path matches the plain version to ~1e-6; int8 or bf16
// tensor-core products (mma / wgmma) are later work.  Two kernels:
//  * skinny (M <= 8, the bytes-bound case): a block owns 64 output
//    columns; each of its 256 threads reads 16 int8 weights of one K row
//    with one 16-byte load (4 threads cover a row's 64 columns, coalesced
//    along N), widens them to f32 in registers and multiplies them with
//    the up-to-8 activation rows staged in shared memory, keeping an
//    8 x 16 accumulator; four K rows are loaded before any is used, so
//    each thread has 64 bytes in flight.  The 64 threads of a column group
//    sum their partial results by shuffles and through shared memory.
//  * tiled (M > 8, the operations-bound case): a 64 x 128 output tile per
//    block, K in steps of 32: x tile and the widened w tile in shared
//    memory (the w tile read as 16 bytes per thread along N), each thread
//    a 4 x 8 register tile (rows ty + 16i, columns 4tx + {0..3} and
//    64 + 4tx + {0..3}, conflict-free float4 reads).
// Without a 16-byte aligned w_q or with N % 16 != 0 the weight loads go
// element by element (same arithmetic).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 int8 weights w[k, c .. c+15] as four packed words; entries past N (or
// the whole row past K) read as 0.
__device__ __forceinline__ int4 load_w16(const int8_t* __restrict__ w, int K,
                                         int N, int k, int c, bool vec) {
  if (k < K && vec && c + 16 <= N)
    return *reinterpret_cast<const int4*>(w + (long long)k * N + c);
  uint32_t words[4] = {0u, 0u, 0u, 0u};
  if (k < K) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (c + j < N)
        words[j / 4] |= (uint32_t)(uint8_t)w[(long long)k * N + c + j]
                        << (8 * (j % 4));
  }
  return make_int4((int)words[0], (int)words[1], (int)words[2],
                   (int)words[3]);
}

// the 16 packed int8 weights of load_w16, widened to f32
__device__ __forceinline__ void widen16(int4 v, float* out) {
  const int32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] = (float)(int8_t)((words[i] >> (8 * j)) & 0xff);
}

// ---------------------------------------------------------------------------
// skinny: M <= 8
// ---------------------------------------------------------------------------
constexpr int kSkinnyM = 8;
constexpr int kSkinnyN = 64;                 // output columns per block
constexpr int kSkinnyRows = kThreads / 4;    // K rows per pass (64)
constexpr int kSkinnyUnroll = 4;             // passes per staged chunk
constexpr int kSkinnyChunk = kSkinnyRows * kSkinnyUnroll;   // 256 K rows

template <typename T>
__global__ void __launch_bounds__(kThreads)
qmm_skinny_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scales, T* __restrict__ out,
                  int M, int K, int N, int vec) {
  __shared__ __align__(16) float xs[kSkinnyChunk][kSkinnyM];   // [k][m]
  __shared__ float red[kThreads / 32][kSkinnyM][kSkinnyN];

  const int t = threadIdx.x;
  const int cg = t % 4;                      // column group: 16 columns
  const int kr = t / 4;                      // K row within a pass
  const int c0 = blockIdx.x * kSkinnyN + cg * 16;

  float acc[kSkinnyM][16];
#pragma unroll
  for (int m = 0; m < kSkinnyM; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kSkinnyChunk) {
    __syncthreads();
    for (int idx = t; idx < kSkinnyChunk * kSkinnyM; idx += kThreads) {
      const int m = idx / kSkinnyChunk, kk = idx % kSkinnyChunk;
      const int k = k0 + kk;
      xs[kk][m] = (m < M && k < K) ? to_f32(x[(long long)m * K + k]) : 0.f;
    }
    __syncthreads();
    int4 raw[kSkinnyUnroll];                 // all loads issued first
#pragma unroll
    for (int u = 0; u < kSkinnyUnroll; ++u)
      raw[u] = load_w16(w, K, N, k0 + u * kSkinnyRows + kr, c0, vec);
#pragma unroll
    for (int u = 0; u < kSkinnyUnroll; ++u) {
      const int kk = u * kSkinnyRows + kr;
      float wr[16];
      widen16(raw[u], wr);
      const float4 xa = *reinterpret_cast<const float4*>(&xs[kk][0]);
      const float4 xb = *reinterpret_cast<const float4*>(&xs[kk][4]);
      const float xv[kSkinnyM] = {xa.x, xa.y, xa.z, xa.w,
                                  xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int m = 0; m < kSkinnyM; ++m)
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[m][j] += xv[m] * wr[j];
    }
  }

  // sum over the 8 K rows of this warp that share the column group
#pragma unroll
  for (int off = 4; off < 32; off *= 2)
#pragma unroll
    for (int m = 0; m < kSkinnyM; ++m)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], off);
  const int warp = t / 32, lane = t % 32;
  if (lane < 4) {
#pragma unroll
    for (int m = 0; m < kSkinnyM; ++m)
#pragma unroll
      for (int j = 0; j < 16; ++j) red[warp][m][lane * 16 + j] = acc[m][j];
  }
  __syncthreads();
  // then over the 8 warps, scale once, store
  for (int idx = t; idx < kSkinnyM * kSkinnyN; idx += kThreads) {
    const int m = idx / kSkinnyN, c = idx % kSkinnyN;
    const int n = blockIdx.x * kSkinnyN + c;
    if (m >= M || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kThreads / 32; ++wi) s += red[wi][m][c];
    store(out + (long long)m * N + n, s * scales[n]);
  }
}

// ---------------------------------------------------------------------------
// tiled: M > 8
// ---------------------------------------------------------------------------
constexpr int kBM = 64, kBN = 128, kBK = 32;
constexpr int kAP = kBK + 4;                 // x tile pitch (floats)
constexpr int kBP = kBN + 4;                 // w tile pitch (floats)

template <typename T>
__global__ void __launch_bounds__(kThreads)
qmm_tiled_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scales, T* __restrict__ out,
                 int M, int K, int N, int vec) {
  __shared__ __align__(16) float as[kBM * kAP];    // [m][k]
  __shared__ __align__(16) float bs[kBK * kBP];    // [k][n]

  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int wk = t / 8, wc = (t % 8) * 16;   // this thread's w tile slice

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    float wr[16];
    widen16(load_w16(w, K, N, k0 + wk, n0 + wc, vec), wr);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 16; j += 4)
      *reinterpret_cast<float4*>(&bs[wk * kBP + wc + j]) =
          make_float4(wr[j], wr[j + 1], wr[j + 2], wr[j + 3]);
    for (int idx = t; idx < kBM * kBK; idx += kThreads) {
      const int m = idx / kBK, kk = idx % kBK;
      const int gm = m0 + m, gk = k0 + kk;
      as[m * kAP + kk] =
          (gm < M && gk < K) ? to_f32(x[(long long)gm * K + gk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&as[(ty + 16 * i) * kAP + kk]);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(&bs[(kk + s) * kBP + tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&bs[(kk + s) * kBP + 64 + tx * 4]);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = s == 0 ? a[i].x : s == 1 ? a[i].y
                                   : s == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += av * bv[j];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N) store(out + (long long)m * N + n, acc[i][j] * scales[n]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* scales,
                   void* out, int M, int K, int N, int vec,
                   cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scales);
  T* op = static_cast<T*>(out);
  if (M <= kSkinnyM) {
    const dim3 grid((N + kSkinnyN - 1) / kSkinnyN);
    qmm_skinny_kernel<T><<<grid, kThreads, 0, stream>>>(xp, wp, sp, op, M, K,
                                                        N, vec);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    qmm_tiled_kernel<T><<<grid, kThreads, 0, stream>>>(xp, wp, sp, op, M, K,
                                                       N, vec);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out).  x [M, K], w_q int8 [K, N],
// scales float32 [N] and out [M, N] are contiguous; vec = 1 when w_q is
// 16-byte aligned and N % 16 == 0.
int quant_matmul_launch(const void* x, const void* w, const void* scales,
                        void* out, int M, int K, int N, int dtype, int vec,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch<float>(x, w, scales, out, M, K, N, vec, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, scales, out, M, K, N, vec, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
