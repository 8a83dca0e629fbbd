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
// Masked keys contribute exactly 0.  A row with no live key at all yields 0
// here; the wrapper (kernels/flash_attention.py) replaces it with the mean
// of V, the reference's value (the sliding-window prefill makes such rows).
// Given a non-null lse (float32 [B, H, Sq]), both kernels also write each
// row's log-sum-exp of its scaled live scores in their epilogue, from the
// running (m, l) they already keep: the training form's forward
// (kernels/ops.py FlashAttentionFn) hands it to the backward
// (flash_attention_bwd.cu), which then recomputes no softmax statistics.
// Serving passes null; the key loop and the output do not change.
//
// What bounds it: at prefill widths the 4*D multiply-adds per live
// (query, key) pair, i.e. operations, not bytes.  Two kernels, chosen by
// dtype in flash_attention_launch (a documented dispatch, not a fallback):
//
// bfloat16 (the serving dtype): flash_attention_tc_kernel, on the tensor
// cores.
//  * Packed GQA rows: a CTA owns one (batch row, kv head) and 128 packed
//    rows, floor(128 / G) query tokens x the G query heads of that kv head
//    (row r = token t0 + r / G, head kvh * G + r % G; rows past that are
//    padding).  Each K/V tile is read once for all G heads.  Grid
//    (ceil(Sq / floor(128 / G)), Hkv, B).
//  * K and V tiles of 64 keys arrive by TMA (a 4-D tensor map over the
//    strided [B, Skv, Hkv, D] view, built on the host per launch, so one
//    layer of a stacked cache loads in place) into a ring of 2-3 stages
//    with full/empty mbarriers; one producer warp keeps the loads in flight
//    and stages each tile's kv_valid as a 64-bit mask beside it.  Q is
//    loaded once with 16-byte loads into the same swizzled layout.
//  * Two consumer warpgroups of 64 rows each: S = Q K^T with
//    wgmma.m64n64k16 (both operands in shared memory, K-major), liveness
//    and the online softmax in registers on the accumulator fragment, P
//    converted to bf16 in registers and fed as the A operand of
//    O += P V (wgmma.m64nDk16, V MN-major), so P never touches shared
//    memory.  The epilogue divides by max(l, 1e-30) and stores bf16.
//  * A KV tile that no row of the CTA can see (past its largest query
//    position under causal, or before its smallest one's window) is
//    skipped whole, as _flash_kernel does; the non-causal path skips none
//    and relies on kv_valid.
//
// float32: flash_attention_kernel, on the CUDA cores.  TF32 tensor cores
// would not hold the float32 parity the model checks need (~1e-5 against
// the plain version).  Design:
//  * one block of 256 threads per (q tile of 64 rows, head, batch row);
//    the kv head is head / G, read in place (no repeated heads in memory);
//  * per KV tile of 64 keys: K, V and the tile's liveness go to shared
//    memory as f32, each thread computes a 4x4 block of scores (rows
//    tr + 16i, columns tc + 16j: conflict-free float4 reads), row max and
//    sum reduce over the 16 threads of a row by shuffles, the running
//    (m, l) live in registers, P goes through shared memory for P @ V;
//  * tiles are skipped as in the bf16 kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"   // TMA, mbarriers, wgmma forms, the tensor-map encoder

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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
                       T* __restrict__ out, float* __restrict__ lse, int Sq,
                       int Skv, int H, int G, int causal, int window,
                       int q_offset, long long k_sb, long long k_ss,
                       long long k_sh, long long v_sb, long long v_ss,
                       long long v_sh, float scale) {
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
    // the training form's log-sum-exp of the row's scaled scores
    if (lse != nullptr && tc == 0)
      lse[((long long)b * H + h) * Sq + q0 + r] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_positions, const void* kv_valid, void* out,
                   void* lse, int B, int Sq, int Skv, int H, int Hkv,
                   int causal, int window, int q_offset, long long k_sb,
                   long long k_ss, long long k_sh, long long v_sb,
                   long long v_ss, long long v_sh, cudaStream_t stream) {
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
      static_cast<const uint8_t*>(kv_valid), static_cast<T*>(out),
      static_cast<float*>(lse), Sq, Skv, H, H / Hkv, causal, window,
      q_offset, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma), K/V by TMA, packed GQA rows
// --------------------------------------------------------------------------
namespace tc {

using namespace wg;

constexpr int kBM = 128;                  // packed (token, head) rows a CTA
constexpr int kBN = 64;                   // keys a KV tile
constexpr int kConsumerWarps = 8;         // two warpgroups of 64 rows
constexpr int kThreads = (kConsumerWarps + 1) * 32;   // + the producer warp

template <int D>
struct Cfg {
  static constexpr int SW = Swz<D>::SW;
  static constexpr int STAGES = D == 128 ? 2 : 3;
  static constexpr int Q_BYTES = kBM * D * 2;
  static constexpr int KV_BYTES = kBN * D * 2;           // K or V, one stage
  // Q, the K and V rings, the liveness masks, token positions, barriers,
  // and 1 KB to align the tiles to the swizzle pattern's period
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES +
                              STAGES * 8 + kBM * 4 + 2 * STAGES * 8;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc_kernel(__grid_constant__ const CUtensorMap tm_k,
                          __grid_constant__ const CUtensorMap tm_v,
                          const __nv_bfloat16* __restrict__ q,
                          const int32_t* __restrict__ q_positions,
                          const uint8_t* __restrict__ kv_valid,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int Sq, int Skv, int H,
                          int G, int causal, int window, int q_offset,
                          float scale_log2) {
  using C = Cfg<D>;
  constexpr int CPR = D / 8;                // 16-byte chunks a row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                                   // [ATOMS][kBM][SW]
  uint8_t* ks = qs + C::Q_BYTES;                        // [STAGES][ATOMS][kBN][SW]
  uint8_t* vs = ks + C::STAGES * C::KV_BYTES;           // the same for V
  uint64_t* live = reinterpret_cast<uint64_t*>(vs + C::STAGES * C::KV_BYTES);
  int* tpos = reinterpret_cast<int*>(live + C::STAGES); // [kBM] token positions
  uint64_t* full = reinterpret_cast<uint64_t*>(tpos + kBM);
  uint64_t* empty = full + C::STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tpb = kBM / G;                  // query tokens a CTA
  const int t0 = blockIdx.x * tpb;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int nt = min(tpb, Sq - t0);
  const int nrows = nt * G;
  const long long q_row = (long long)H * D;   // q / out: [B, Sq, H, D]

  for (int i = tid; i < tpb; i += kThreads) {
    const int t = t0 + min(i, nt - 1);     // padding repeats the last token
    tpos[i] = q_positions ? q_positions[(long long)b * Sq + t] : q_offset + t;
  }
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 32);              // the producer's lanes
      mbar_init(smem_u32(&empty[s]), kConsumerWarps); // one lane a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Q, packed, in the swizzled K-major layout the first product reads
  for (int idx = tid; idx < kBM * CPR; idx += kThreads) {
    const int r = idx / CPR, c = idx % CPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows)
      val = *reinterpret_cast<const uint4*>(
          q + ((long long)b * Sq + t0 + r / G) * q_row +
          (long long)(kvh * G + r % G) * D + c * 8);
    *reinterpret_cast<uint4*>(qs + Swz<D>::offset(kBM, r, c)) = val;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // the KV tiles some row of this CTA can see
  int qmin = tpos[0], qmax = tpos[0];
  for (int i = 1; i < nt; ++i) {
    qmin = min(qmin, tpos[i]);
    qmax = max(qmax, tpos[i]);
  }
  int kt0 = 0, kt1 = (Skv + kBN - 1) / kBN;
  if (causal) kt1 = min(kt1, qmax < 0 ? 0 : qmax / kBN + 1);
  if (window > 0 && qmin - window + 1 > 0) kt0 = (qmin - window + 1) / kBN;
  const int ntiles = max(0, kt1 - kt0);

  if (warp == kConsumerWarps) {
    // ---- producer warp: K/V tiles by TMA, liveness mask by the lanes ----
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % C::STAGES;
      mbar_wait(smem_u32(&empty[s]), ((i / C::STAGES) & 1) ^ 1);
      const int k0 = (kt0 + i) * kBN;
      bool ok[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kp = k0 + lane + 32 * h;
        ok[h] = kp < Skv &&
                (kv_valid == nullptr || kv_valid[(long long)b * Skv + kp]);
      }
      const uint32_t lo = __ballot_sync(0xffffffffu, ok[0]);
      const uint32_t hi = __ballot_sync(0xffffffffu, ok[1]);
      const uint32_t bar = smem_u32(&full[s]);
      if (lane == 0) {
        live[s] = ((uint64_t)hi << 32) | lo;
        mbar_arrive_tx(bar, 2 * C::KV_BYTES);
        tma_tile<D>(ks + s * C::KV_BYTES, &tm_k, bar, kBN, kvh, k0, b);
        tma_tile<D>(vs + s * C::KV_BYTES, &tm_v, bar, kBN, kvh, k0, b);
      } else {
        mbar_arrive(bar);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 packed rows each ----
    const int wg = warp / 4, w = warp % 4;
    // the two rows this thread holds in every accumulator fragment
    int qp[2], row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = wg * 64 + w * 16 + lane / 4 + 8 * h;
      qp[h] = tpos[min(row[h] / G, nt - 1)];
    }
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const uint32_t q_base = smem_u32(qs) + wg * 64 * C::SW;

    for (int i = 0; i < ntiles; ++i) {
      const int s = i % C::STAGES;
      const int k0 = (kt0 + i) * kBN;
      mbar_wait(smem_u32(&full[s]), (i / C::STAGES) & 1);
      const uint32_t k_base = smem_u32(ks + s * C::KV_BYTES);
      const uint32_t v_base = smem_u32(vs + s * C::KV_BYTES);

      // S = Q K^T: 64 rows x 64 keys a warpgroup
      float sc[kBN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(sc, kmajor_desc<D>(q_base, kBM, kk),
                     kmajor_desc<D>(k_base, kBN, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // liveness and the online softmax on the fragment: element
      // sc[4j + 2h + e] is row row[h], key k0 + 8j + 2 (lane % 4) + e
      const uint64_t lv = live[s];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int last = causal ? qp[h] - k0 : (1 << 30);   // keys <= last
        const int first = window > 0 ? qp[h] - window - k0 : -1;  // > first
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * (lane % 4) + e;
            const bool ok = ((lv >> c) & 1ull) && c <= last && c > first;
            float& x = sc[4 * j + 2 * h + e];
            x = ok ? x * scale_log2 : -INFINITY;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[h] - m_use);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * h + e];
            x = exp2f(x - m_use);
            rs += x;
          }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l[h] = l[h] * alpha + rs;
        m[h] = m_new;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j + 2 * h] *= alpha;
          o[4 * j + 2 * h + 1] *= alpha;
        }
      }

      // P as bf16 A fragments
      uint32_t pa[kBN / 4];
      pack_a(sc, pa);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<D>(o, pa + 4 * kk, mn_desc<D>(v_base, kBN, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] >= nrows) continue;
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
      __nv_bfloat16* dst = out + ((long long)b * Sq + t0 + row[h] / G) * q_row +
                           (long long)(kvh * G + row[h] % G) * D +
                           2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
            o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
      // the training form's log-sum-exp of the row's scaled scores, in
      // natural units (m is in log2 units)
      if (lse != nullptr && lane % 4 == 0)
        lse[((long long)b * H + kvh * G + row[h] % G) * Sq + t0 + row[h] / G] =
            (m[h] + log2f(l[h])) * 0.6931471805599453f;
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_positions, const void* kv_valid, void* out,
                   void* lse, int B, int Sq, int Skv, int H, int Hkv,
                   int causal, int window, int q_offset, long long k_sb,
                   long long k_ss, long long k_sh, long long v_sb,
                   long long v_ss, long long v_sh, cudaStream_t stream) {
  const int G = H / Hkv;
  if (G > kBM) return cudaErrorInvalidValue;
  CUtensorMap tm_k, tm_v;
  cudaError_t err = tile_map<D>(&tm_k, k, B, Skv, Hkv, k_sb, k_ss, k_sh, kBN);
  if (err == cudaSuccess)
    err = tile_map<D>(&tm_v, v, B, Skv, Hkv, v_sb, v_ss, v_sh, kBN);
  if (err != cudaSuccess) return err;
  auto kern = flash_attention_tc_kernel<D>;
  static bool smem_set = false;
  if (!smem_set) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Cfg<D>::SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int tpb = kBM / G;
  const dim3 grid((Sq + tpb - 1) / tpb, Hkv, B);
  kern<<<grid, kThreads, Cfg<D>::SMEM, stream>>>(
      tm_k, tm_v, static_cast<const __nv_bfloat16*>(q),
      static_cast<const int32_t*>(q_positions),
      static_cast<const uint8_t*>(kv_valid), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), Sq, Skv, H, G, causal, window, q_offset,
      1.4426950408889634f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core kernel).
// q and out are contiguous [B, Sq, H, D]; k and v are [B, Skv, Hkv, D] with
// the given element strides, a contiguous last axis and 16-byte aligned
// rows.  q_positions (int32 [B, Sq]) and kv_valid (bool [B, Skv]) are
// contiguous or null.  lse (float32 [B, H, Sq], contiguous) is null, or
// takes each row's log-sum-exp of its scaled live scores (the training
// form's, for the backward); the output is the same either way.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           const void* q_positions, const void* kv_valid,
                           void* out, void* lse, int B, int Sq, int Skv, int H, int Hkv,
                           int D, int dtype, int causal, int window,
                           int q_offset, long long k_sb, long long k_ss,
                           long long k_sh, long long v_sb, long long v_ss,
                           long long v_sh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS q, k, v, q_positions, kv_valid, out, lse, B, Sq, Skv, H, Hkv, \
                   causal, window, q_offset, k_sb, k_ss, k_sh, v_sb, v_ss,  \
                   v_sh, st
  if (dtype == 0) {
    if (D == 32) return (int)launch<float, 32>(FLASH_ARGS);
    if (D == 64) return (int)launch<float, 64>(FLASH_ARGS);
    if (D == 128) return (int)launch<float, 128>(FLASH_ARGS);
  } else if (dtype == 1) {
    if (D == 32) return (int)tc::launch<32>(FLASH_ARGS);
    if (D == 64) return (int)tc::launch<64>(FLASH_ARGS);
    if (D == 128) return (int)tc::launch<128>(FLASH_ARGS);
  }
#undef FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
