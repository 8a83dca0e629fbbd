// Flash-attention backward for Hopper: dQ, dK and dV of the training form
// of ops.flash_attention (causal or not, an optional sliding window,
// q_offset 0, GQA, no per-row positions and no kv_valid).
//
// Replaces no TPU kernel.  The reference trains through
// src/repro/kernels/flash_attention.py: flash_attention_pallas on a TPU,
// but jax's pallas_call has a JVP rule and no transpose rule, so jax.grad
// of that path has no backward kernel to port; on the CPU the reference's
// gradient is XLA's autodiff of ops._flash_jnp.  The port's forward on the
// card is the hand-written flash kernel (csrc/flash_attention.cu), and a
// torch.autograd.Function around it needs a backward of its own: this one.
//
// A key at kpos is live for the query at qpos iff
//     kpos < Skv && (kpos <= qpos if causal) && (kpos > qpos - window if
//     window > 0),
// the forward's mask with q_positions = arange(Sq).  The wrapper
// (kernels/flash_attention.py: flash_attention_bwd_cuda) refuses a call
// where a row has no live key (training never makes one: each causal row
// sees itself).
//
// Three kernels, launched in order on one stream, no atomics, so every
// gradient is the same bit for bit from call to call:
//  (a) bwd_prepass_kernel, one block per (query tile, head, batch row):
//      each row's log-sum-exp of its scaled scores (the forward's online
//      max / sum over the live keys) and delta = rowsum(dO * O);
//  (b) bwd_dkdv_kernel, one block per (KV tile, kv head, batch row): dK and
//      dV of its 64 keys in registers, over the G query heads of the kv
//      head in order and, for each, the query tiles that can see the tile
//      (from the tile holding its first key under causal, to the last one
//      its window reaches);
//  (c) bwd_dq_kernel, one block per (query tile, head, batch row): dQ over
//      the KV tiles its rows can see, skipped as the forward skips them.
// Per (query tile, KV tile) pair both recompute S = Q K^T * scale and
// P = exp(S - lse) (0 where masked), dP = dO V^T and dS = P * (dP - delta);
// then dV += P^T dO and dK += dS^T Q (b), dQ += dS K (c); dK and dQ take
// the softmax scale once at the end.
//
// What bounds it: the five S-sized products (S in (a), S and dP twice, the
// three accumulations), i.e. operations, at training widths.  This first
// kernel runs them on the CUDA cores in float32 for both dtypes: tiles of
// 64 x 64, K/V/Q/dO staged in shared memory as float32 (bf16 widened on
// load), each of 256 threads owning a 4 x 4 block of scores (rows tr + 16i,
// keys tc + 16j: conflict-free float4 reads at a pitch of D + 4) and a
// 4 x (D / 16) block of its accumulator (columns tc + 16c).  Outputs are
// rounded to the input dtype once, at the store.  wgmma, TMA and the LSE
// written by the forward are later work (ROADMAP.md, queue 2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;            // query rows a tile
constexpr int kBK = 64;            // keys a tile
constexpr int kThreads = 256;
constexpr int kPP = kBK + 1;       // pitch of the P / dS tiles (floats)

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);      // round to nearest even, as torch's .to()
}

// Stage `rows` rows of D elements (row r at base + r * row_stride) into
// shared memory as float32 with a row pitch of `pitch` floats; rows past
// `n` are zero-filled.
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

__device__ __forceinline__ bool live(int qpos, int kpos, int Sq, int Skv,
                                     int causal, int window) {
  return qpos < Sq && kpos < Skv && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// s[i][j] = a[tr + 16i] . b[tc + 16j] over D, both tiles at pitch D + 4.
template <int D>
__device__ __forceinline__ void dot_tile(const float* a, const float* b,
                                         float s[4][4]) {
  constexpr int QP = D + 4;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (tr + 16 * i) * QP + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tc + 16 * j) * QP + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] += av[i].x * bv[j].x + av[i].y * bv[j].y +
                   av[i].z * bv[j].z + av[i].w * bv[j].w;
  }
}

// (a) lse [B, H, Sq] of the scaled scores and delta [B, H, Sq] =
// rowsum(dO * O), both float32.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_prepass_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ o, const T* __restrict__ dout,
                   float* __restrict__ lse, float* __restrict__ delta, int Sq,
                   int Skv, int H, int G, int causal, int window,
                   float scale) {
  constexpr int QP = D + 4;
  constexpr int EPL = 16 / sizeof(T);
  extern __shared__ float smem[];
  float* qs = smem;                  // [kBQ][QP]
  float* ks = qs + kBQ * QP;         // [kBK][QP]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G, Hkv = H / G;
  const int nq = min(kBQ, Sq - q0);
  const long long q_row = (long long)H * D, k_row = (long long)Hkv * D;
  const long long q_base = ((long long)b * Sq + q0) * q_row + (long long)h * D;
  const long long stat = ((long long)b * H + h) * Sq + q0;

  stage<T, D>(qs, QP, q + q_base, q_row, kBQ, nq);
  {  // delta: four threads a row, each over a quarter of D, in one order
    const int r = threadIdx.x / 4, part = threadIdx.x % 4;
    float acc = 0.f;
    if (r < nq) {
      const T* orow = o + q_base + r * q_row;
      const T* drow = dout + q_base + r * q_row;
      for (int c = part * (D / 4); c < (part + 1) * (D / 4); c += EPL) {
        float ob[EPL], db[EPL];
        load16(orow + c, ob);
        load16(drow + c, db);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc += ob[e] * db[e];
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0 && r < nq) delta[stat + r] = acc;
  }

  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int qmin = q0, qmax = q0 + nq - 1;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  const T* kb = k + (long long)b * Skv * k_row + (long long)kvh * D;
  for (int k0 = 0; k0 < Skv; k0 += kBK) {
    if (causal && k0 > qmax) break;                       // later tiles too
    if (window > 0 && k0 + kBK - 1 <= qmin - window) continue;
    const int nk = min(kBK, Skv - k0);
    __syncthreads();                 // the last tile's reads are done
    stage<T, D>(ks, QP, kb + k0 * k_row, k_row, kBK, nk);
    __syncthreads();
    float s[4][4];
    dot_tile<D>(qs, ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + tr + 16 * i;
      bool ok[4];
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = live(qpos, k0 + tc + 16 * j, Sq, Skv, causal, window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        rsum += ok[j] ? expf(s[i][j] - m_new) : 0.f;
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * expf(m[i] - m_new) + rsum;
      m[i] = m_new;
    }
  }
  if (tc == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
      if (r < nq) lse[stat + r] = m[i] + logf(l[i]);
    }
  }
}

// P (the probabilities) and dS of one (query tile, KV tile) pair into
// ps / dss ([kBQ][kPP], row = query, column = key), from the staged Q, dO,
// K, V tiles and the rows' lse / delta.
template <int D>
__device__ __forceinline__ void p_and_ds(const float* qs, const float* dos,
                                         const float* ks, const float* vs,
                                         const float* lse_s,
                                         const float* delta_s, float* ps,
                                         float* dss, int q0, int k0, int Sq,
                                         int Skv, int causal, int window,
                                         float scale) {
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float s[4][4], dp[4][4];
  dot_tile<D>(qs, ks, s);
  dot_tile<D>(dos, vs, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tc + 16 * j;
      const float p = live(q0 + r, k0 + c, Sq, Skv, causal, window)
                          ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
      if (ps != nullptr) ps[r * kPP + c] = p;
      dss[r * kPP + c] = p * (dp[i][j] - delta_s[r]);
    }
  }
}

// (b) dK and dV of one KV tile of one kv head.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int Sq, int Skv, int H, int G, int causal,
                int window, float scale) {
  constexpr int QP = D + 4;
  constexpr int NC = D / 16;         // accumulator columns a thread
  extern __shared__ float smem[];
  float* ks = smem;                  // [kBK][QP]
  float* vs = ks + kBK * QP;         // [kBK][QP]
  float* qs = vs + kBK * QP;         // [kBQ][QP]
  float* dos = qs + kBQ * QP;        // [kBQ][QP]
  float* ps = dos + kBQ * QP;        // [kBQ][kPP]
  float* dss = ps + kBQ * kPP;       // [kBQ][kPP]
  float* lse_s = dss + kBQ * kPP;    // [kBQ]
  float* delta_s = lse_s + kBQ;      // [kBQ]

  const int k0 = blockIdx.x * kBK, kvh = blockIdx.y, b = blockIdx.z;
  const int Hkv = H / G;
  const int nk = min(kBK, Skv - k0);
  const long long q_row = (long long)H * D, k_row = (long long)Hkv * D;
  const long long k_base = ((long long)b * Skv + k0) * k_row +
                           (long long)kvh * D;
  stage<T, D>(ks, QP, k + k_base, k_row, kBK, nk);
  stage<T, D>(vs, QP, v + k_base, k_row, kBK, nk);

  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // the query tiles that can see a key of this tile: from the tile of its
  // first key (causal), to the tile of the last query its last key's
  // window reaches (qpos < kpos + window)
  const int nqt = (Sq + kBQ - 1) / kBQ;
  const int qt0 = causal ? k0 / kBQ : 0;
  const int qt1 = window > 0 ? min(nqt, (k0 + nk - 1 + window - 1) / kBQ + 1)
                             : nqt;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * kBQ, nq = min(kBQ, Sq - q0);
      const long long q_base = ((long long)b * Sq + q0) * q_row +
                               (long long)h * D;
      const long long stat = ((long long)b * H + h) * Sq + q0;
      __syncthreads();               // the last pair's reads are done
      stage<T, D>(qs, QP, q + q_base, q_row, kBQ, nq);
      stage<T, D>(dos, QP, dout + q_base, q_row, kBQ, nq);
      for (int r = threadIdx.x; r < kBQ; r += kThreads) {
        lse_s[r] = r < nq ? lse[stat + r] : 0.f;
        delta_s[r] = r < nq ? delta[stat + r] : 0.f;
      }
      __syncthreads();
      p_and_ds<D>(qs, dos, ks, vs, lse_s, delta_s, ps, dss, q0, k0, Sq, Skv,
                  causal, window, scale);
      __syncthreads();
      for (int r = 0; r < nq; ++r) {
        float dor[NC], qr[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dor[c] = dos[r * QP + tc + 16 * c];
          qr[c] = qs[r * QP + tc + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = ps[r * kPP + tr + 16 * i];
          const float ds = dss[r * kPP + tr + 16 * i];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv_acc[i][c] += p * dor[c];
            dk_acc[i][c] += ds * qr[c];
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    if (r >= nk) continue;
    const long long row = k_base + r * k_row;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store(dk + row + tc + 16 * c, dk_acc[i][c] * scale);
      store(dv + row + tc + 16 * c, dv_acc[i][c]);
    }
  }
}

// (c) dQ of one query tile of one head.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int Sq, int Skv, int H, int G, int causal,
              int window, float scale) {
  constexpr int QP = D + 4;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;                  // [kBQ][QP]
  float* dos = qs + kBQ * QP;        // [kBQ][QP]
  float* ks = dos + kBQ * QP;        // [kBK][QP]
  float* vs = ks + kBK * QP;         // [kBK][QP]
  float* dss = vs + kBK * QP;        // [kBQ][kPP]
  float* lse_s = dss + kBQ * kPP;    // [kBQ]
  float* delta_s = lse_s + kBQ;      // [kBQ]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G, Hkv = H / G;
  const int nq = min(kBQ, Sq - q0);
  const long long q_row = (long long)H * D, k_row = (long long)Hkv * D;
  const long long q_base = ((long long)b * Sq + q0) * q_row + (long long)h * D;
  const long long stat = ((long long)b * H + h) * Sq + q0;
  stage<T, D>(qs, QP, q + q_base, q_row, kBQ, nq);
  stage<T, D>(dos, QP, dout + q_base, q_row, kBQ, nq);
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    lse_s[r] = r < nq ? lse[stat + r] : 0.f;
    delta_s[r] = r < nq ? delta[stat + r] : 0.f;
  }

  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int qmin = q0, qmax = q0 + nq - 1;
  float dq_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq_acc[i][c] = 0.f;
  const T* kb = k + (long long)b * Skv * k_row + (long long)kvh * D;
  const T* vb = v + (long long)b * Skv * k_row + (long long)kvh * D;
  for (int k0 = 0; k0 < Skv; k0 += kBK) {
    if (causal && k0 > qmax) break;                       // later tiles too
    if (window > 0 && k0 + kBK - 1 <= qmin - window) continue;
    const int nk = min(kBK, Skv - k0);
    __syncthreads();                 // the last tile's reads are done
    stage<T, D>(ks, QP, kb + k0 * k_row, k_row, kBK, nk);
    stage<T, D>(vs, QP, vb + k0 * k_row, k_row, kBK, nk);
    __syncthreads();
    p_and_ds<D>(qs, dos, ks, vs, lse_s, delta_s, nullptr, dss, q0, k0, Sq,
                Skv, causal, window, scale);
    __syncthreads();
    for (int kk = 0; kk < nk; ++kk) {
      float kr[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kr[c] = ks[kk * QP + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dss[(tr + 16 * i) * kPP + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) dq_acc[i][c] += ds * kr[c];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    if (r >= nq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store(dq + q_base + r * q_row + tc + 16 * c, dq_acc[i][c] * scale);
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, void* dq, void* dk, void* dv, void* lse,
                   void* delta, int B, int Sq, int Skv, int H, int Hkv,
                   int causal, int window, cudaStream_t stream) {
  constexpr int QP = D + 4;
  const int G = H / Hkv;
  const float scale = 1.0f / sqrtf((float)D);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  float* lse_f = static_cast<float*>(lse);
  float* delta_f = static_cast<float*>(delta);

  const size_t smem_a = sizeof(float) * 2 * kBQ * QP;
  const size_t smem_bc = sizeof(float) * (4 * kBQ * QP + 2 * kBQ);
  const size_t smem_b = smem_bc + sizeof(float) * 2 * kBQ * kPP;
  const size_t smem_c = smem_bc + sizeof(float) * kBQ * kPP;
  auto ka = bwd_prepass_kernel<T, D>;
  auto kb = bwd_dkdv_kernel<T, D>;
  auto kc = bwd_dq_kernel<T, D>;
  cudaError_t err = allow_smem(ka, smem_a);
  if (err == cudaSuccess) err = allow_smem(kb, smem_b);
  if (err == cudaSuccess) err = allow_smem(kc, smem_c);
  if (err != cudaSuccess) return err;

  const dim3 grid_q((Sq + kBQ - 1) / kBQ, H, B);
  ka<<<grid_q, kThreads, smem_a, stream>>>(
      qt, kt, static_cast<const T*>(o), dot, lse_f, delta_f, Sq, Skv, H, G,
      causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kb<<<dim3((Skv + kBK - 1) / kBK, Hkv, B), kThreads, smem_b, stream>>>(
      qt, kt, vt, dot, lse_f, delta_f, static_cast<T*>(dk),
      static_cast<T*>(dv), Sq, Skv, H, G, causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kc<<<grid_q, kThreads, smem_c, stream>>>(
      qt, kt, vt, dot, lse_f, delta_f, static_cast<T*>(dq), Sq, Skv, H, G,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q, o, dout and dq are contiguous
// [B, Sq, H, D]; k, v, dk and dv contiguous [B, Skv, Hkv, D]; lse and delta
// float32 scratch of [B, H, Sq].  Returns cudaGetLastError() of the first
// launch that failed, or of the last.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout, void* dq,
                               void* dk, void* dv, void* lse, void* delta,
                               int B, int Sq, int Skv, int H, int Hkv, int D,
                               int dtype, int causal, int window,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BWD_ARGS q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Skv, H, Hkv, \
                 causal, window, st
  if (dtype == 0) {
    if (D == 32) return (int)launch<float, 32>(BWD_ARGS);
    if (D == 64) return (int)launch<float, 64>(BWD_ARGS);
    if (D == 128) return (int)launch<float, 128>(BWD_ARGS);
  } else if (dtype == 1) {
    if (D == 32) return (int)launch<__nv_bfloat16, 32>(BWD_ARGS);
    if (D == 64) return (int)launch<__nv_bfloat16, 64>(BWD_ARGS);
    if (D == 128) return (int)launch<__nv_bfloat16, 128>(BWD_ARGS);
  }
#undef BWD_ARGS
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
