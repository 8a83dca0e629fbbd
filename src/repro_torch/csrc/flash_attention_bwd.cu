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
// The softmax statistics come from the forward: lse [B, H, Sq] is each
// row's log-sum-exp of its scaled live scores, written by the forward
// kernel's epilogue (FlashAttentionFn saves it).  Three kernels, launched
// in order on one stream:
//  (a) bwd_delta_kernel: delta = rowsum(dO * O), float32 [B, H, Sq], a
//      pass over memory with no product;
//  (b) dK and dV, one CTA per (64-key tile, kv head, batch row), over the
//      G query heads of the kv head and, for each, the query tiles that can
//      see the tile (from the tile holding its first key under causal, to
//      the last one its window reaches);
//  (c) dQ over the KV tiles its rows can see, skipped as the forward skips
//      them.
// Per (query tile, key tile) pair both recompute S = Q K^T and
// P = exp(S * scale - lse) (0 where masked), dP = dO V^T and
// dS = P * (dP - delta); then dV += P^T dO and dK += dS^T Q (b), dQ += dS K
// (c); dK and dQ take the softmax scale once, at the store.
//
// No atomics: every gradient is written once, by the one CTA that owns it,
// so two calls are the same bit for bit, and remat on is bit for bit remat
// off.  The price is seven score-sized products where five suffice: S and
// dP are computed in both (b) and (c).  A single pass adding dQ across the
// key tiles' CTAs with atomics would skip the second S and dP, but its sum
// would change order from run to run.
//
// What bounds it: at 6a's shape (B 8, S 512, 14/2 heads, D 64, causal) the
// bytes of q, k, v, out, dout read and dq, dk, dv written once (0.0100 ms at
// 3.35 TB/s), just above the five products at the bf16 tensor-core rate
// (0.0095 ms); the seven this design runs take 0.013 ms.  bf16 (the
// training dtype) therefore runs every product on the tensor cores
// (tc::, wgmma) and keeps the score tiles in registers; float32 keeps PR
// 24's CUDA-core kernels, since TF32 would not hold the 1e-5 float32
// parity the model checks need (the forward keeps a CUDA-core float32
// kernel for the same reason).
//
// bf16 on the tensor cores (the forms of csrc/wgmma.cuh, shared with the
// forward):
//  * (b) tc::dkdv_kernel: K and V of the CTA's 64 keys come once by TMA
//    into 128/64-byte-swizzled shared memory.  A work item is (query head
//    g, query tile of QN queries: 128 below D 128, 64 at D 128).  Rows are
//    keys: S^T = K Q^T and dP^T = V dO^T (wgmma m64nQNk16, both operands
//    in shared memory, K-major, two commit groups so that P^T is formed
//    while dP^T still runs), P^T and dS^T in registers on the accumulator
//    fragment (lse and delta indexed by column; a tile whose every pair
//    is live skips the mask), packed to bf16 as the A operand of
//    dV += P^T dO and dK += dS^T Q (m64nDk16, dO and Q read MN-major from
//    the same tiles): the forward's own P V form, so P and dS never touch
//    shared memory.  P and dS are rounded to bf16 before their products,
//    as SDPA's backward does; every sum is float32.
//  * No producer warp.  A ninth warp would put three warps on one of the
//    SM's four register files and cap every thread at 168 registers
//    (the forward's 9-warp CTA sits at that cap); with 4 or 8 warps a
//    thread may take 255, which the dK / dV accumulators and the 64 x QN
//    score tiles need (phase 1 of chip_smoke.py prints each
//    instantiation's registers and spills).  Each consumer warpgroup
//    feeds its own ring of SPW stages: one of its threads asks TMA for an
//    item's Q and dO tiles, and all its threads copy the item's lse and
//    delta with cp.async, SPW items ahead; a named barrier of the
//    warpgroup frees a stage.
//  * The GQA heads: NW consumer warpgroups split the items, warpgroup w
//    taking items w, w + NW, ... in order (the mirror is
//    kernels/flash_attention.py: bwd_tile_plan), each with its own float32
//    dK / dV of the 64 keys; at the end warpgroup 1 hands its sums to
//    warpgroup 0 through shared memory, which adds them (its own first)
//    and stores.  The order is fixed, so the sum is the same on every
//    call.  Why split: at 6a's shape the grid is 8 key tiles x 2 kv heads
//    x 8 rows = 128 CTAs for 132 SMs, one CTA an SM (registers), and the
//    longest CTA (key tile 0) walks 7 heads x 4 query tiles; two
//    warpgroups halve that walk and let one warpgroup's softmax arithmetic
//    overlap the other's products.  At D 128 the dK and dV accumulators
//    alone take 128 registers a thread, so D 128 runs one warpgroup (NW 1)
//    and items of 64 queries; D 32 / 64 run two (NW 2).
//  * (c) tc::dq_kernel: the forward's packed GQA rows (a CTA owns 128
//    packed (token, head) rows of one kv head, two warpgroups of 64 rows),
//    so each K / V tile, brought by a TMA ring as in the forward, is read
//    once for all G heads; Q and dO arrive as one TMA box each (tokens x
//    the G heads land in the packed order).  S = Q K^T and dP = dO V^T
//    (ss, two groups), dS in registers, dQ += dS K (rs, K read MN-major).
//    Thread 0 refills the K / V ring once all eight warps have released a
//    stage (no producer warp, for the registers as above).
//  * Masks and shapes: TMA fills rows past Sq or Skv with zeros and the
//    mask (qpos < Sq, kpos < Skv, causal, window) zeroes P there; G from 1
//    to 128, D 32 / 64 / 128, Sq != Skv.
//
// float32 on the CUDA cores (PR 24's kernels): tiles of 64 x 64, K/V/Q/dO
// staged in shared memory as float32, each of 256 threads owning a 4 x 4
// block of scores (rows tr + 16i, keys tc + 16j: conflict-free float4
// reads at a pitch of D + 4) and a 4 x (D / 16) block of its accumulator
// (columns tc + 16c); (b) walks the G query heads one after another.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "ptx.cuh"     // cp.async
#include "wgmma.cuh"   // TMA, mbarriers, wgmma forms, the tensor-map encoder

namespace {

constexpr int kBQ = 64;            // query rows a tile
constexpr int kBK = 64;            // keys a tile
constexpr int kThreads = 256;
constexpr int kPP = kBK + 1;       // pitch of the P / dS tiles (floats)
constexpr float kLog2e = 1.4426950408889634f;

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

// (a) delta [B, H, Sq] = rowsum(dO * O) in float32, four threads a row
// (each over a quarter of D, then two shuffles: one order on every call);
// rows are the [B, Sq, H] rows of o and dout.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int rows, int Sq, int H) {
  constexpr int EPL = 16 / sizeof(T);
  const int row = blockIdx.x * (kThreads / 4) + threadIdx.x / 4;
  const int part = threadIdx.x % 4;
  float acc = 0.f;
  if (row < rows) {
    const T* orow = o + (long long)row * D;
    const T* drow = dout + (long long)row * D;
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
  if (part == 0 && row < rows) {
    const int h = row % H, t = (row / H) % Sq, b = row / H / Sq;
    delta[((long long)b * H + h) * Sq + t] = acc;
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
// --------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma), tiles by TMA
// --------------------------------------------------------------------------
namespace tc {

using namespace wg;

constexpr int kRows = 64;          // keys a dK/dV tile; rows a dQ K/V tile

template <int D>
struct DkdvCfg {
  static constexpr int NW = D == 128 ? 1 : 2;     // consumer warpgroups
  // no producer warp: a 9-warp block puts three warps on one of the SM's
  // four register files and so caps every thread at 168 registers, where
  // 4 or 8 warps may take 255
  static constexpr int THREADS = NW * 128;
  // queries an item: 128 below D 128 (S^T and dP^T 64 x 128, 128
  // registers a thread beside the 2 x D / 2 of dK and dV), 64 at D 128
  static constexpr int QN = D == 128 ? 64 : 128;
  static constexpr int SPW = D == 128 ? 3 : 2;    // ring stages a warpgroup
  static constexpr int STAGES = NW * SPW;
  static constexpr int KTILE = kRows * D * 2;     // K or V, bf16
  static constexpr int QTILE = QN * D * 2;        // Q or dO of an item
  static constexpr int PART = NW > 1 ? 2 * kRows * D * 4 : 0;  // wg 1's sums
  // K, V, the Q / dO ring, warpgroup 1's float32 dK / dV, the ring's lse
  // and delta, barriers (kv and full a stage), 1 KB of alignment
  static constexpr int SMEM = 1024 + 2 * KTILE + 2 * STAGES * QTILE + PART +
                              STAGES * 2 * QN * 4 + (1 + STAGES) * 8;
};

// bar.sync on named barrier `id` for `n` threads (the 128 of a warpgroup)
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// the query tiles [qt0, qt1) of qn queries that can see keys k0 .. k0 +
// nk - 1 (the mirror in kernels/flash_attention.py is bwd_tile_plan)
__device__ __forceinline__ void query_tiles(int k0, int nk, int Sq, int causal,
                                            int window, int qn, int* qt0,
                                            int* qt1) {
  const int nqt = (Sq + qn - 1) / qn;
  *qt0 = causal ? k0 / qn : 0;
  *qt1 = window > 0 ? min(nqt, (k0 + nk - 1 + window - 1) / qn + 1) : nqt;
}

// (b) dK and dV of one 64-key tile of one kv head
template <int D>
__global__ void __launch_bounds__(DkdvCfg<D>::THREADS, 1)
dkdv_kernel(__grid_constant__ const CUtensorMap tm_q,
            __grid_constant__ const CUtensorMap tm_k,
            __grid_constant__ const CUtensorMap tm_v,
            __grid_constant__ const CUtensorMap tm_do,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
            int Sq, int Skv, int H, int G, int causal, int window,
            float scale) {
  using C = DkdvCfg<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = smem;                                  // [ATOMS][64][SW]
  uint8_t* vs = ks + C::KTILE;
  uint8_t* qs = vs + C::KTILE;                         // [STAGES][ATOMS][QN][SW]
  uint8_t* dos = qs + C::STAGES * C::QTILE;            // the same for dO
  float* part = reinterpret_cast<float*>(dos + C::STAGES * C::QTILE);
  float* stat = part + C::PART / 4;                    // [STAGES][2][QN]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stat + C::STAGES * 2 * C::QN);
  uint64_t* full = kv_full + 1;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wgi = warp / 4, w = warp % 4, wt = tid % 128;
  const int k0 = blockIdx.x * kRows, kvh = blockIdx.y, b = blockIdx.z;
  const int nk = min(kRows, Skv - k0);
  int qt0, qt1;
  query_tiles(k0, nk, Sq, causal, window, C::QN, &qt0, &qt1);
  const int per_head = max(0, qt1 - qt0);
  const int items = G * per_head;                      // (head g, tile qt)

  if (tid == 0) {
    mbar_init(smem_u32(kv_full), 1);
    for (int s = 0; s < C::STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {   // K and V of the 64 keys, once
    const uint32_t bar = smem_u32(kv_full);
    mbar_arrive_tx(bar, 2 * C::KTILE);
    tma_tile<D>(ks, &tm_k, bar, kRows, kvh, k0, b);
    tma_tile<D>(vs, &tm_v, bar, kRows, kvh, k0, b);
  }

  // Each warpgroup feeds its own SPW stages: item `it` (warpgroup it % NW,
  // its (it / NW)-th) goes to stage wgi * SPW + (it / NW) % SPW.  One of
  // its threads asks TMA for the Q and dO tiles; all 128 copy the item's
  // QN lse and QN delta values with cp.async (zeros past Sq), one
  // cp.async group a thread per item, committed whether or not the item
  // exists, so that group li is always item li's
  auto load = [&](int it) {
    if (it < items) {
      const int st = wgi * C::SPW + (it / C::NW) % C::SPW;
      const int h = kvh * G + it / per_head;
      const int q0 = (qt0 + it % per_head) * C::QN;
      const long long row = ((long long)b * H + h) * Sq + q0;
#pragma unroll
      for (int i = wt; i < 2 * C::QN; i += 128) {
        const int r = i % C::QN;
        const bool in = q0 + r < Sq;
        ptx::cp_async4(stat + st * 2 * C::QN + i,
                       (i < C::QN ? lse : delta) + (in ? row + r : 0), in);
      }
      if (wt == 0) {
        const uint32_t bar = smem_u32(&full[st]);
        mbar_arrive_tx(bar, 2 * C::QTILE);
        tma_tile<D>(qs + st * C::QTILE, &tm_q, bar, C::QN, h, q0, b);
        tma_tile<D>(dos + st * C::QTILE, &tm_do, bar, C::QN, h, q0, b);
      }
    }
    ptx::cp_async_commit();
  };
  for (int k = 0; k < C::SPW; ++k) load(wgi + k * C::NW);

  // ---- the 64 keys are the rows ----
  int kpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) kpos[h] = k0 + w * 16 + lane / 4 + 8 * h;
  const float scale_log2 = scale * kLog2e;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint32_t k_base = smem_u32(ks), v_base = smem_u32(vs);
  mbar_wait(smem_u32(kv_full), 0);

  for (int it = wgi; it < items; it += C::NW) {
    const int li = it / C::NW;                 // the warpgroup's li-th item
    const int s = wgi * C::SPW + li % C::SPW;
    const int q0 = (qt0 + it % per_head) * C::QN;
    // this thread's copies of the item's stats are in; after the barrier,
    // every thread's
    ptx::cp_async_wait<C::SPW - 1>();
    named_sync(1 + wgi, 128);
    mbar_wait(smem_u32(&full[s]), (li / C::SPW) & 1);
    const uint32_t q_base = smem_u32(qs + s * C::QTILE);
    const uint32_t do_base = smem_u32(dos + s * C::QTILE);
    const float* lse_s = stat + s * 2 * C::QN;
    const float* delta_s = lse_s + C::QN;
    // a tile whose every (key, query) pair is live skips the mask
    const bool all_live = q0 + C::QN <= Sq && k0 + kRows <= Skv &&
                          (!causal || k0 + kRows - 1 <= q0) &&
                          (window <= 0 || k0 > q0 + C::QN - 1 - window);

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x QN queries, two groups so
    // that P^T is formed while dP^T is still running
    float st[C::QN / 2], dpt[C::QN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<C::QN>(st, kmajor_desc<D>(k_base, kRows, kk),
                      kmajor_desc<D>(q_base, C::QN, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<C::QN>(dpt, kmajor_desc<D>(v_base, kRows, kk),
                      kmajor_desc<D>(do_base, C::QN, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // P^T on the fragment: element [4j + 2h + e] is key kpos[h], query
    // q0 + 8j + 2 (lane % 4) + e
    auto form_p = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < C::QN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * (lane % 4) + e;
          const float l2 = lse_s[c] * kLog2e;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int x = 4 * j + 2 * h + e;
            st[x] = !decltype(masked)::value ||
                            live(q0 + c, kpos[h], Sq, Skv, causal, window)
                        ? exp2f(st[x] * scale_log2 - l2) : 0.f;
          }
        }
    };
    if (all_live) form_p(std::false_type{});
    else form_p(std::true_type{});
    wgmma_wait<0>();
    fence_regs(dpt);
    // dS^T = P^T (dP^T - delta), delta by column
#pragma unroll
    for (int j = 0; j < C::QN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = delta_s[8 * j + 2 * (lane % 4) + e];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = 4 * j + 2 * h + e;
          dpt[x] = st[x] * (dpt[x] - dl);
        }
      }
    uint32_t pa[C::QN / 4], da[C::QN / 4];
    pack_a<C::QN>(st, pa);
    pack_a<C::QN>(dpt, da);

    // dV += P^T dO and dK += dS^T Q (dO and Q MN-major)
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::QN / 16; ++kk)
      wgmma_rs<D>(dv_acc, pa + 4 * kk, mn_desc<D>(do_base, C::QN, kk));
#pragma unroll
    for (int kk = 0; kk < C::QN / 16; ++kk)
      wgmma_rs<D>(dk_acc, da + 4 * kk, mn_desc<D>(q_base, C::QN, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pa);
    fence_regs(da);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    // every warp of the warpgroup is done with stage s: refill it
    named_sync(1 + wgi, 128);
    load(it + C::NW * C::SPW);
  }

  if constexpr (C::NW > 1) {
    // warpgroup 1's sums to warpgroup 0, which adds them after its own
    const int t = tid % 128;
    if (wgi == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        part[i * 128 + t] = dk_acc[i];
        part[(D / 2 + i) * 128 + t] = dv_acc[i];
      }
    }
    __syncthreads();
    if (wgi == 1) return;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dk_acc[i] += part[i * 128 + t];
      dv_acc[i] += part[(D / 2 + i) * 128 + t];
    }
  }
  const int Hkv = H / G;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kpos[h] >= Skv) continue;
    const long long off = (((long long)b * Skv + kpos[h]) * Hkv + kvh) * D +
                          2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
          __floats2bfloat162_rn(dk_acc[4 * j + 2 * h] * scale,
                                dk_acc[4 * j + 2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2 * h],
                                dv_acc[4 * j + 2 * h + 1]);
    }
  }
}

constexpr int kBM = 128;                  // packed (token, head) rows a CTA
constexpr int kDqThreads = 256;          // two warpgroups, no producer warp

template <int D>
struct DqCfg {
  static constexpr int STAGES = D == 128 ? 2 : 3;
  static constexpr int ROWS = kBM * D * 2;        // Q or dO, packed
  static constexpr int KV = kRows * D * 2;        // K or V, one stage
  static constexpr int SMEM = 1024 + 2 * ROWS + 2 * STAGES * KV +
                              (1 + 2 * STAGES) * 8;
};

// (c) dQ of 128 packed rows (floor(128 / G) tokens x the G query heads of
// one kv head)
template <int D>
__global__ void __launch_bounds__(kDqThreads, 1)
dq_kernel(__grid_constant__ const CUtensorMap tm_q,
          __grid_constant__ const CUtensorMap tm_k,
          __grid_constant__ const CUtensorMap tm_v,
          __grid_constant__ const CUtensorMap tm_do,
          const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H, int G,
          int causal, int window, float scale) {
  using C = DqCfg<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                                  // [ATOMS][kBM][SW]
  uint8_t* dos = qs + C::ROWS;
  uint8_t* ks = dos + C::ROWS;                         // [STAGES] tiles
  uint8_t* vs = ks + C::STAGES * C::KV;
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + C::STAGES * C::KV);
  uint64_t* empty = full + C::STAGES;
  uint64_t* qdo_full = empty + C::STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tpb = kBM / G;                  // query tokens a CTA
  const int t0 = blockIdx.x * tpb;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int nt = min(tpb, Sq - t0);
  const int nrows = nt * G;

  if (tid == 0) {
    mbar_init(smem_u32(qdo_full), 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 8);      // one lane a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Q and dO, packed, by TMA: one box of tpb tokens x the G heads of the kv
  // head lands as rows token * G + head, the packed order (rows past
  // tpb * G stay unwritten: they are padding, masked, and never stored)
  if (tid == 0) {
    const uint32_t bar = smem_u32(qdo_full);
    mbar_arrive_tx(bar, 2 * tpb * G * D * 2);
    tma_tile<D>(qs, &tm_q, bar, kBM, kvh * G, t0, b);
    tma_tile<D>(dos, &tm_do, bar, kBM, kvh * G, t0, b);
  }

  // the KV tiles some row of this CTA can see (the forward's tile_range)
  const int qmin = t0, qmax = t0 + nt - 1;
  int kt0 = 0, kt1 = (Skv + kRows - 1) / kRows;
  if (causal) kt1 = min(kt1, qmax / kRows + 1);
  if (window > 0 && qmin - window + 1 > 0) kt0 = (qmin - window + 1) / kRows;
  const int ntiles = max(0, kt1 - kt0);

  // K / V tile i into stage i % STAGES by TMA: thread 0 fills the ring,
  // then refills a stage once all eight warps have released it (no
  // producer warp, so that a thread may take 255 registers)
  auto load = [&](int i) {
    const int s = i % C::STAGES, k0 = (kt0 + i) * kRows;
    const uint32_t bar = smem_u32(&full[s]);
    mbar_arrive_tx(bar, 2 * C::KV);
    tma_tile<D>(ks + s * C::KV, &tm_k, bar, kRows, kvh, k0, b);
    tma_tile<D>(vs + s * C::KV, &tm_v, bar, kRows, kvh, k0, b);
  };
  if (tid == 0)
    for (int i = 0; i < min(ntiles, C::STAGES); ++i) load(i);

  // ---- two warpgroups of 64 packed rows each ----
  const int wgi = warp / 4, w = warp % 4;
  const float scale_log2 = scale * kLog2e;
  const long long q_row = (long long)H * D;   // dq: [B, Sq, H, D]
  int row[2], qp[2];
  float l2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = wgi * 64 + w * 16 + lane / 4 + 8 * h;
    const bool in = row[h] < nrows;
    // a padding row gets an impossible position: every key is masked
    qp[h] = in ? t0 + row[h] / G : Sq;
    const long long st = ((long long)b * H + kvh * G + row[h] % G) * Sq +
                         t0 + row[h] / G;
    l2[h] = in ? lse[st] * kLog2e : 0.f;
    dl[h] = in ? delta[st] : 0.f;
  }
  // the token positions of this warpgroup's 64 rows, and whether all of
  // them are real rows
  const bool rows_full = wgi * 64 + 63 < nrows;
  const int tmin = t0 + wgi * 64 / G;
  const int tmax = t0 + min(wgi * 64 + 63, nrows - 1) / G;
  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
  const uint32_t q_base = smem_u32(qs) + wgi * 64 * Swz<D>::SW;
  const uint32_t do_base = smem_u32(dos) + wgi * 64 * Swz<D>::SW;
  mbar_wait(smem_u32(qdo_full), 0);

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % C::STAGES;
    const int k0 = (kt0 + i) * kRows;
    mbar_wait(smem_u32(&full[s]), (i / C::STAGES) & 1);
    const uint32_t k_base = smem_u32(ks + s * C::KV);
    const uint32_t v_base = smem_u32(vs + s * C::KV);

    // S = Q K^T and dP = dO V^T: 64 rows x 64 keys a warpgroup, two
    // groups so that P is formed while dP is still running
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sc, kmajor_desc<D>(q_base, kBM, kk),
                   kmajor_desc<D>(k_base, kRows, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, kmajor_desc<D>(do_base, kBM, kk),
                   kmajor_desc<D>(v_base, kRows, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P, then dS, on the fragment: element [4j + 2h + e] is row row[h],
    // key k0 + 8j + 2 (lane % 4) + e; a tile every row of the warpgroup
    // sees whole skips the mask
    const bool all_live = rows_full && k0 + kRows <= Skv &&
                          (!causal || k0 + kRows - 1 <= tmin) &&
                          (window <= 0 || k0 > tmax - window);
    auto form_p = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + 2 * (lane % 4) + e;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int x = 4 * j + 2 * h + e;
            sc[x] = !decltype(masked)::value ||
                            live(qp[h], kp, Sq, Skv, causal, window)
                        ? exp2f(sc[x] * scale_log2 - l2[h]) : 0.f;
          }
        }
    };
    if (all_live) form_p(std::false_type{});
    else form_p(std::true_type{});
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int x = 0; x < 32; ++x) dp[x] = sc[x] * (dp[x] - dl[(x / 2) % 2]);
    uint32_t da[16];
    pack_a(dp, da);

    // dQ += dS K (K MN-major)
    fence_regs(dq_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(dq_acc, da + 4 * kk, mn_desc<D>(k_base, kRows, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(da);
    fence_regs(dq_acc);
    if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
    if (tid == 0 && i + C::STAGES < ntiles) {
      mbar_wait(smem_u32(&empty[s]), (i / C::STAGES) & 1);
      load(i + C::STAGES);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= nrows) continue;
    __nv_bfloat16* dst = dq + ((long long)b * Sq + t0 + row[h] / G) * q_row +
                         (long long)(kvh * G + row[h] % G) * D +
                         2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          dq_acc[4 * j + 2 * h] * scale, dq_acc[4 * j + 2 * h + 1] * scale);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, void* dq, void* dk, void* dv,
                   const float* lse, const float* delta, int B, int Sq,
                   int Skv, int H, int Hkv, int causal, int window,
                   cudaStream_t stream) {
  const int G = H / Hkv;
  if (G > kBM) return cudaErrorInvalidValue;
  const long long qs = (long long)H * D, ks = (long long)Hkv * D;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  constexpr int QN = DkdvCfg<D>::QN;
  cudaError_t err = tile_map<D>(&tm_q, q, B, Sq, H, Sq * qs, qs, D, QN);
  if (err == cudaSuccess)
    err = tile_map<D>(&tm_do, dout, B, Sq, H, Sq * qs, qs, D, QN);
  if (err == cudaSuccess)
    err = tile_map<D>(&tm_k, k, B, Skv, Hkv, Skv * ks, ks, D, kRows);
  if (err == cudaSuccess)
    err = tile_map<D>(&tm_v, v, B, Skv, Hkv, Skv * ks, ks, D, kRows);
  // the dQ kernel's packed boxes: floor(128 / G) tokens x G heads
  const int tpb = kBM / G;
  CUtensorMap tm_qp, tm_dop;
  if (err == cudaSuccess)
    err = tile_map<D>(&tm_qp, q, B, Sq, H, Sq * qs, qs, D, tpb, G);
  if (err == cudaSuccess)
    err = tile_map<D>(&tm_dop, dout, B, Sq, H, Sq * qs, qs, D, tpb, G);
  if (err != cudaSuccess) return err;
  auto kb = dkdv_kernel<D>;
  auto kc = dq_kernel<D>;
  static bool smem_set = false;
  if (!smem_set) {
    err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DkdvCfg<D>::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kc, cudaFuncAttributeMaxDynamicSharedMemorySize, DqCfg<D>::SMEM);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const float scale = 1.0f / sqrtf((float)D);
  kb<<<dim3((Skv + kRows - 1) / kRows, Hkv, B), DkdvCfg<D>::THREADS,
       DkdvCfg<D>::SMEM, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Sq, Skv, H, G, causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kc<<<dim3((Sq + tpb - 1) / tpb, Hkv, B), kDqThreads, DqCfg<D>::SMEM,
       stream>>>(
      tm_qp, tm_k, tm_v, tm_dop, lse, delta,
      static_cast<__nv_bfloat16*>(dq), Sq, Skv, H, G, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace tc

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int D>
cudaError_t launch_delta(const void* o, const void* dout, float* delta, int B,
                         int Sq, int H, cudaStream_t stream) {
  const int rows = B * Sq * H;
  bwd_delta_kernel<T, D><<<(rows + kThreads / 4 - 1) / (kThreads / 4),
                           kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, Sq,
      H);
  return cudaGetLastError();
}

// float32: PR 24's CUDA-core dK/dV and dQ kernels
template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* dout, void* dq, void* dk, void* dv,
                       const float* lse, const float* delta, int B, int Sq,
                       int Skv, int H, int Hkv, int causal, int window,
                       cudaStream_t stream) {
  constexpr int QP = D + 4;
  const int G = H / Hkv;
  const float scale = 1.0f / sqrtf((float)D);
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  const size_t smem_bc = sizeof(float) * (4 * kBQ * QP + 2 * kBQ);
  const size_t smem_b = smem_bc + sizeof(float) * 2 * kBQ * kPP;
  const size_t smem_c = smem_bc + sizeof(float) * kBQ * kPP;
  auto kb = bwd_dkdv_kernel<float, D>;
  auto kc = bwd_dq_kernel<float, D>;
  cudaError_t err = allow_smem(kb, smem_b);
  if (err == cudaSuccess) err = allow_smem(kc, smem_c);
  if (err != cudaSuccess) return err;
  kb<<<dim3((Skv + kBK - 1) / kBK, Hkv, B), kThreads, smem_b, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), Sq, Skv, H, G, causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kc<<<dim3((Sq + kBQ - 1) / kBQ, H, B), kThreads, smem_c, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dq), Sq, Skv, H, G,
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, void* dq, void* dk, void* dv,
                   const void* lse, void* delta, int B, int Sq, int Skv,
                   int H, int Hkv, int causal, int window,
                   cudaStream_t stream) {
  float* delta_f = static_cast<float*>(delta);
  const float* lse_f = static_cast<const float*>(lse);
  cudaError_t err = launch_delta<T, D>(o, dout, delta_f, B, Sq, H, stream);
  if (err != cudaSuccess) return err;
  if constexpr (sizeof(T) == 2)
    return tc::launch<D>(q, k, v, dout, dq, dk, dv, lse_f, delta_f, B, Sq,
                         Skv, H, Hkv, causal, window, stream);
  else
    return launch_f32<D>(q, k, v, dout, dq, dk, dv, lse_f, delta_f, B, Sq,
                         Skv, H, Hkv, causal, window, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q, o, dout and dq are contiguous
// [B, Sq, H, D]; k, v, dk and dv contiguous [B, Skv, Hkv, D]; lse the
// forward's float32 [B, H, Sq] (contiguous); delta float32 scratch of
// [B, H, Sq].  Returns cudaGetLastError() of the first launch that failed,
// or of the last.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout, void* dq,
                               void* dk, void* dv, const void* lse,
                               void* delta, int B, int Sq, int Skv, int H,
                               int Hkv, int D, int dtype, int causal,
                               int window, void* stream) {
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
