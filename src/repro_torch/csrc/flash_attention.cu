// Blocked flash attention (prefill) for Hopper: causal / sliding-window /
// GQA, with q_offset, per-row query positions and per-key liveness.
//
// Replaces the reference package's Pallas TPU kernel
// src/repro/kernels/flash_attention.py: flash_attention_pallas (body
// _flash_kernel), extended to the whole ops.flash_attention contract so the
// engine's resume prefill runs it too: q_positions [B, Sq] (absolute query
// positions over a ring cache) and kv_valid [B, Skv].  A key at cache index
// kpos is live for a query at position qpos iff
//     kpos < Skv && kv_valid[kpos] && (kpos <= qpos if causal)
//                && (kpos > qpos - window if window > 0).
// Masked keys contribute exactly 0.  A row with no live key at all (never
// produced by the engine) is outside the contract; here it yields 0.
//
// What bounds it: at prefill widths the 4*D multiply-adds per live
// (query, key) pair, i.e. operations, not bytes.  This first version runs
// them on the CUDA cores in f32 (the float32 path must match the plain
// version to ~1e-5, which TF32 tensor cores cannot), so it is far from the
// bf16 tensor-core peak; wgmma/TMA is later work.  Design:
//  * one block of 256 threads per (q tile of 64 rows, head, batch row);
//    the kv head is head / G, read in place (no repeated heads in memory);
//  * per KV tile of 64 keys: K, V and the tile's liveness go to shared
//    memory as f32, each thread computes a 4x4 block of scores (rows
//    tr + 16i, columns tc + 16j: conflict-free float4 reads), row max and
//    sum reduce over the 16 threads of a row by shuffles, the running
//    (m, l) live in registers, P goes through shared memory for P @ V;
//  * a KV tile that no row of the q tile can see (past the tile's largest
//    query position under causal, or before the smallest one's window) is
//    skipped whole, as _flash_kernel does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Stage `rows` rows of D elements (row r at base + r * row_stride) into
// shared memory as f32 with a row pitch of `pitch` floats; rows past `n`
// are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* base,
                                      long long row_stride, int rows, int n) {
  constexpr int EPL = 16 / sizeof(T);
  constexpr int PER_ROW = D / EPL;
  for (int idx = threadIdx.x; idx < rows * PER_ROW; idx += kThreads) {
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * EPL;
    float buf[EPL];
    if (r < n) {
      load16(base + r * row_stride + c, buf);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) buf[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < EPL; e += 4)
      *reinterpret_cast<float4*>(dst + r * pitch + c + e) =
          make_float4(buf[e], buf[e + 1], buf[e + 2], buf[e + 3]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int32_t* __restrict__ q_positions,
                       const uint8_t* __restrict__ kv_valid,
                       T* __restrict__ out, int Sq, int Skv, int H, int G,
                       int causal, int window, int q_offset, long long k_sb,
                       long long k_ss, long long k_sh, long long v_sb,
                       long long v_ss, long long v_sh, float scale) {
  constexpr int QP = D + 4;          // Q/K row pitch (floats): conflict-free
  constexpr int NC = D / 16;         // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                  // [kBQ][QP]
  float* ks = qs + kBQ * QP;         // [kBK][QP]
  float* vs = ks + kBK * QP;         // [kBK][D]
  float* ps = vs + kBK * D;          // [kBQ][kBK + 1]
  int* qpos = reinterpret_cast<int*>(ps + kBQ * (kBK + 1));   // [kBQ]
  uint8_t* klive = reinterpret_cast<uint8_t*>(qpos + kBQ);    // [kBK]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const int tr = threadIdx.x / 16;
  const int tc = threadIdx.x % 16;
  const int nq = min(kBQ, Sq - q0);

  const long long q_row = (long long)H * D;   // q / out: [B, Sq, H, D]
  const T* qb = q + ((long long)b * Sq + q0) * q_row + (long long)h * D;
  stage<T, D>(qs, QP, qb, q_row, kBQ, nq);
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const int rr = min(r, nq - 1);    // padding rows copy the last real row
    qpos[r] = q_positions ? q_positions[(long long)b * Sq + q0 + rr]
                          : q_offset + q0 + rr;
  }
  __syncthreads();
  int qmin = qpos[0], qmax = qpos[0];
  for (int r = 1; r < nq; ++r) {
    qmin = min(qmin, qpos[r]);
    qmax = max(qmax, qpos[r]);
  }
  int myq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) myq[i] = qpos[tr + 16 * i];

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  for (int k0 = 0; k0 < Skv; k0 += kBK) {
    if (causal && k0 > qmax) break;                       // later tiles too
    if (window > 0 && k0 + kBK - 1 <= qmin - window) continue;
    const int nk = min(kBK, Skv - k0);
    stage<T, D>(ks, QP, kb + k0 * k_ss, k_ss, kBK, nk);
    stage<T, D>(vs, D, vb + k0 * v_ss, v_ss, kBK, nk);
    for (int c = threadIdx.x; c < kBK; c += kThreads)
      klive[c] = c < nk && (kv_valid == nullptr ||
                            kv_valid[(long long)b * Skv + k0 + c]);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (tr + 16 * i) * QP + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bb[j] = *reinterpret_cast<const float4*>(ks + (tc + 16 * j) * QP + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += a[i].x * bb[j].x + a[i].y * bb[j].y + a[i].z * bb[j].z +
                     a[i].w * bb[j].w;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rmax = kNegInf;
      bool ok[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        const int kpos = k0 + c;
        ok[j] = klive[c] && (!causal || kpos <= myq[i]) &&
                (window <= 0 || kpos > myq[i] - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(tr + 16 * i) * (kBK + 1) + tc + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float vr[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vr[c] = vs[kk * D + tc * NC + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(tr + 16 * i) * (kBK + 1) + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] += p * vr[c];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    if (r >= nq) continue;
    T* o = out + ((long long)b * Sq + q0 + r) * q_row + (long long)h * D + tc * NC;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) store(o + c, acc[i][c] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_positions, const void* kv_valid, void* out,
                   int B, int Sq, int Skv, int H, int Hkv, int causal,
                   int window, int q_offset, long long k_sb, long long k_ss,
                   long long k_sh, long long v_sb, long long v_ss,
                   long long v_sh, cudaStream_t stream) {
  constexpr int QP = D + 4;
  const size_t smem = sizeof(float) * ((size_t)(kBQ + kBK) * QP + kBK * D +
                                       kBQ * (kBK + 1)) +
                      sizeof(int) * kBQ + kBK;
  auto kern = flash_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(q_positions),
      static_cast<const uint8_t*>(kv_valid), static_cast<T*>(out), Sq, Skv,
      H, H / Hkv, causal, window, q_offset, k_sb, k_ss, k_sh, v_sb, v_ss,
      v_sh, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q and out are contiguous [B, Sq, H, D];
// k and v are [B, Skv, Hkv, D] with the given element strides and a
// contiguous last axis.  q_positions (int32 [B, Sq]) and kv_valid
// (bool [B, Skv]) are contiguous or null.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           const void* q_positions, const void* kv_valid,
                           void* out, int B, int Sq, int Skv, int H, int Hkv,
                           int D, int dtype, int causal, int window,
                           int q_offset, long long k_sb, long long k_ss,
                           long long k_sh, long long v_sb, long long v_ss,
                           long long v_sh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DISPATCH(T, DD)                                                      \
  return (int)launch<T, DD>(q, k, v, q_positions, kv_valid, out, B, Sq, Skv, \
                            H, Hkv, causal, window, q_offset, k_sb, k_ss,    \
                            k_sh, v_sb, v_ss, v_sh, st)
  if (dtype == 0) {
    if (D == 32) DISPATCH(float, 32);
    if (D == 64) DISPATCH(float, 64);
    if (D == 128) DISPATCH(float, 128);
  } else if (dtype == 1) {
    if (D == 32) DISPATCH(__nv_bfloat16, 32);
    if (D == 64) DISPATCH(__nv_bfloat16, 64);
    if (D == 128) DISPATCH(__nv_bfloat16, 128);
  }
#undef DISPATCH
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
