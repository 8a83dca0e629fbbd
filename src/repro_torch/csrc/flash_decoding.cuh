// Split-S (flash-decoding) building blocks shared by the one-token
// attention kernels: the dense ring (decode_attention.cu) and the page
// table (paged_attention.cu).  Both cut a row's keys into splits, one block
// each, stream every split in 32-key tiles double-buffered in shared memory
// by cp.async, and update their (m, l, acc) state tile by tile with the
// bodies below; only the key-row addresses and the liveness test differ
// between them, and those stay in the callers' tile loaders.
//
// A kernel with n_splits > 1 writes each split's unnormalised state to a
// float32 scratch buffer laid out [B, Hkv, n_splits, G, D + 2]:
//     [0, D)  acc = sum over the split's live keys of p * v
//     D       m   = the split's largest live score (-1e30 if it has none)
//     D + 1   l   = sum of p = exp(score - m)      (0 if it has none)
// and combine_splits_kernel merges the splits of each query row in index
// order: out = sum_i acc_i e^(m_i - M) / max(sum_i l_i e^(m_i - M), 1e-30)
// with M = max_i m_i, so a row with no live key in any split gives 0.  With
// one split the kernel writes the output itself.
//
// Keys with a per-key scale (int8 K/V: k = sk * k_int8, v = sv * v_int8)
// take kScaled: the score is sk * (q . k_int8) * scale and sv is folded
// into p after the row sum, which equals dequantise-then-dot up to the
// order of the sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"

namespace flash_decoding {

constexpr float kNoKey = -1e30f;   // m of a split with no live key
constexpr int kThreads = 128;      // 4 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kTK = 32;            // keys a tile

// Which kernel launched a combine: a template argument of
// combine_splits_kernel, so that a profile tells the callers' combines apart.
struct DecodeCaller {};
struct PagedCaller {};

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Offset of split `split`'s row `g` in the scratch buffer.
__host__ __device__ __forceinline__ long long partial_row(
    int b, int kvh, int split, int g, int Hkv, int n_splits, int G, int D) {
  return ((((long long)b * Hkv + kvh) * n_splits + split) * G + g) *
         (long long)(D + 2);
}

// Elements a 16-byte chunk of a K/V row holds, and the padded row pitch
// (16 bytes more than a row) that keeps the tiles' reads conflict-free.
template <typename KV>
struct TileRow {
  static constexpr int kEpc = 16 / (int)sizeof(KV);
  template <int D>
  __host__ __device__ static constexpr int pitch() { return D + kEpc; }
};

// ---- float32 q: the products on the CUDA cores ----
//
// Scoring: a lane a key, the 4 warps over the query rows (q broadcast from
// shared memory); all G x 32 scores of a tile first, one max per row per
// tile.  P V: a thread a pair of head_dim columns, four keys a step.
template <int D, int MAXG>
struct F32Shape {
  static constexpr int RG = 2 * kThreads / D;       // row groups in P V
  static constexpr int GPT = (MAXG + RG - 1) / RG;  // rows a thread in P V
  static constexpr int SG = (MAXG + kWarps - 1) / kWarps;  // rows a warp scores
  static_assert((2 * kThreads) % D == 0, "bad D");
};

// a 16-byte chunk of a K row as floats
__device__ __forceinline__ void chunk_to_f32(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void chunk_to_f32(const int8_t* p, float* out) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const int32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] = (float)(int8_t)((w[i] >> (8 * j)) & 0xff);
}
// two neighbouring V columns as floats
__device__ __forceinline__ float2 pair_to_f32(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_to_f32(const int8_t* p) {
  const short s = *reinterpret_cast<const short*>(p);
  return make_float2((float)(int8_t)(s & 0xff), (float)(int8_t)(s >> 8));
}

// One tile of 32 keys (rows kt / vt of pitch TileRow<KV>::pitch<D>(),
// liveness `live`, per-key scales ksc / vsc when kScaled) into the running
// state: m_r / l_r of rows warp + kWarps j, acc of rows rg + RG j, columns
// 2 dcol and 2 dcol + 1.  qs is the kv head's [G][D] query rows, ps a
// [MAXG][kTK] and row_a a [MAXG] scratch in shared memory.  Two block
// barriers inside; every thread of the block calls it.
template <int D, int MAXG, typename KV, bool kScaled>
__device__ __forceinline__ void f32_tile_update(
    const KV* kt, const KV* vt, const uint8_t* live_t, const float* ksc,
    const float* vsc, const float* qs, float* ps, float* row_a, int G,
    float scale, float (&m_r)[F32Shape<D, MAXG>::SG],
    float (&l_r)[F32Shape<D, MAXG>::SG],
    float (&acc)[F32Shape<D, MAXG>::GPT][2]) {
  using S = F32Shape<D, MAXG>;
  constexpr int EPC = TileRow<KV>::kEpc;
  constexpr int PITCH = TileRow<KV>::template pitch<D>();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int dcol = tid % (D / 2), rg = tid / (D / 2);

  // scores of all G rows for the tile's keys: lane = key
  {
    const bool live = live_t[lane];
    const KV* krow = kt + lane * PITCH;
    float sc[S::SG][4];   // four independent partial sums a row
#pragma unroll
    for (int j = 0; j < S::SG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D / EPC; ++c) {
      float kf[EPC];
      chunk_to_f32(krow + c * EPC, kf);
#pragma unroll
      for (int j = 0; j < S::SG; ++j) {
        const int g = warp + kWarps * j;
        if (g >= G) break;
        const float* qr = qs + g * D + c * EPC;
#pragma unroll
        for (int e = 0; e < EPC; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + e);
          sc[j][0] = fmaf(qv.x, kf[e], sc[j][0]);
          sc[j][1] = fmaf(qv.y, kf[e + 1], sc[j][1]);
          sc[j][2] = fmaf(qv.z, kf[e + 2], sc[j][2]);
          sc[j][3] = fmaf(qv.w, kf[e + 3], sc[j][3]);
        }
      }
    }
    const float sk = kScaled ? ksc[lane] : 1.f;
    const float sv = kScaled ? vsc[lane] : 1.f;
#pragma unroll
    for (int j = 0; j < S::SG; ++j) {
      const int g = warp + kWarps * j;
      if (g >= G) break;
      float dot = (sc[j][0] + sc[j][1]) + (sc[j][2] + sc[j][3]);
      if (kScaled) dot *= sk;
      const float s = live ? dot * scale : -INFINITY;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_r[j], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float p = live ? expf(s - m_use) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m_r[j] - m_use);
      l_r[j] = l_r[j] * alpha + sum;
      m_r[j] = m_new;
      ps[g * kTK + lane] = kScaled ? p * sv : p;
      if (lane == 0) row_a[g] = alpha;
    }
  }
  __syncthreads();

  // P V over the tile: columns 2 dcol, 2 dcol + 1 of rows rg + RG j, four
  // keys a step (p as float4, V as column pairs)
#pragma unroll
  for (int j = 0; j < S::GPT; ++j) {
    const int g = rg + S::RG * j;
    if (g < G) {
      const float a = row_a[g];
      acc[j][0] *= a;
      acc[j][1] *= a;
    }
  }
  const KV* vcol = vt + 2 * dcol;
#pragma unroll 2
  for (int kk = 0; kk < kTK; kk += 4) {
    float2 vv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) vv[u] = pair_to_f32(vcol + (kk + u) * PITCH);
#pragma unroll
    for (int j = 0; j < S::GPT; ++j) {
      const int g = rg + S::RG * j;
      if (g >= G) break;
      const float4 p = *reinterpret_cast<const float4*>(ps + g * kTK + kk);
      acc[j][0] += p.x * vv[0].x + p.y * vv[1].x + p.z * vv[2].x +
                   p.w * vv[3].x;
      acc[j][1] += p.x * vv[0].y + p.y * vv[1].y + p.z * vv[2].y +
                   p.w * vv[3].y;
    }
  }
  __syncthreads();   // the buffer is refilled two tiles on
}

// The split's result: the output itself (one split) or its partial state.
// row_a / row_l are [MAXG] shared scratch.
template <int D, int MAXG, typename T>
__device__ __forceinline__ void f32_store(
    const float (&m_r)[F32Shape<D, MAXG>::SG],
    const float (&l_r)[F32Shape<D, MAXG>::SG],
    const float (&acc)[F32Shape<D, MAXG>::GPT][2], float* row_a,
    float* row_l, T* out, float* part, int b, int kvh, int split, int Hkv,
    int n_splits, int H, int G) {
  using S = F32Shape<D, MAXG>;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int dcol = tid % (D / 2), rg = tid / (D / 2);
#pragma unroll
  for (int j = 0; j < S::SG; ++j) {
    const int g = warp + kWarps * j;
    if (g < G && lane == 0) {
      row_a[g] = m_r[j] == -INFINITY ? kNoKey : m_r[j];
      row_l[g] = l_r[j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < S::GPT; ++j) {
    const int g = rg + S::RG * j;
    if (g >= G) continue;
    if (n_splits == 1) {
      T* o = out + ((long long)b * H + (long long)kvh * G + g) * D + 2 * dcol;
      const float inv = 1.f / fmaxf(row_l[g], 1e-30f);
      store_out(o, acc[j][0] * inv);
      store_out(o + 1, acc[j][1] * inv);
    } else {
      float* row = part + partial_row(b, kvh, split, g, Hkv, n_splits, G, D);
      row[2 * dcol] = acc[j][0];
      row[2 * dcol + 1] = acc[j][1];
      if (dcol == 0) {
        row[D] = row_a[g];
        row[D + 1] = row_l[g];
      }
    }
  }
}

// ---- bfloat16 q: the two products on the tensor cores (mma.sync) ----
//
// The G <= 16 query rows of a kv head fill one m16 tile (rows past G are
// zeros).  Every warp scores the whole 32-key tile (S = Q K^T, 4 n8 blocks
// x D/16 k16 steps; exact, the inputs being bf16 or int8), so each warp
// holds every row's scores in registers: the row max and sum take two quad
// shuffles, and P, split into two bf16 parts in registers, is the A operand
// of O += P V (the m16n8k16 A layout is the accumulator layout of two
// neighbouring n8 blocks).  Each warp owns a quarter of the head_dim
// columns of O.  The scores are computed four times over (once a warp):
// cheap next to the shared-memory round trip and the two block barriers a
// split of the scores would cost.

using ptx::bf16x2_bits;
using ptx::ldmatrix_x4;
using ptx::ldmatrix_x4_trans;
using ptx::mma_bf16;

// (a, b) ~= hi + lo with both parts bf16 pairs: P keeps ~16 bits through
// the second product, so the bf16 kernels sum like the float32 plain
// versions (a P rounded once to bf16 would move outputs by up to ~1e-2)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// Fragment sources of a K/V tile, each the register image of the
// ldmatrix it stands for.  k_frag: matrices j = 0..3 are keys 8 nb .. 8 nb
// + 7 x head_dim 16 kk + 8 j ..; v_frag (transposed): keys 8 j .. 8 j + 7 x
// head_dim col .. col + 7.
template <int D>
struct Bf16Tile {
  static constexpr int PITCH = TileRow<__nv_bfloat16>::pitch<D>();
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __device__ __forceinline__ void k_frag(uint32_t* r, int nb, int kk,
                                         int lane) const {
    ldmatrix_x4(r, k + (8 * nb + lane % 8) * PITCH + 16 * kk + 8 * (lane / 8));
  }
  __device__ __forceinline__ void v_frag(uint32_t* r, int col,
                                         int lane) const {
    ldmatrix_x4_trans(r, v + lane * PITCH + col);
  }
};

// int8 rows (1 byte an element in shared memory), widened to bf16 as the
// fragments are formed: every int8 value is exact in bf16.  Thread `lane`
// of ldmatrix gets row lane / 4, columns 2 (lane % 4) and + 1 of each
// matrix; .trans gives it rows 2 (lane % 4) and + 1 of column lane / 4.
__device__ __forceinline__ uint32_t widen_pair(int lo, int hi) {
  return bf16x2_bits(__floats2bfloat162_rn((float)lo, (float)hi));
}

template <int D>
struct Int8Tile {
  static constexpr int PITCH = TileRow<int8_t>::pitch<D>();
  const int8_t* k;
  const int8_t* v;
  __device__ __forceinline__ void k_frag(uint32_t* r, int nb, int kk,
                                         int lane) const {
    const int8_t* row = k + (8 * nb + lane / 4) * PITCH + 16 * kk +
                        2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const short s = *reinterpret_cast<const short*>(row + 8 * j);
      r[j] = widen_pair((int8_t)(s & 0xff), (int8_t)(s >> 8));
    }
  }
  __device__ __forceinline__ void v_frag(uint32_t* r, int col,
                                         int lane) const {
    const int8_t* c = v + 2 * (lane % 4) * PITCH + col + lane / 4;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[j] = widen_pair(c[8 * j * PITCH], c[(8 * j + 1) * PITCH]);
  }
};

// Q as m16k16 A fragments: rows lane / 4 and lane / 4 + 8 (zero past G)
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[D / 16][4],
                                             const __nv_bfloat16* qb, int G,
                                             int lane) {
  qb += 2 * (lane % 4);
  const int r0 = lane / 4, r1 = lane / 4 + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (i & 1) ? r1 : r0;
      qa[kk][i] = r < G ? *reinterpret_cast<const uint32_t*>(
                              qb + (long long)r * D + 16 * kk + 8 * (i / 2))
                        : 0u;
    }
}

// One 32-key tile into the running state of rows lane / 4 (h = 0) and
// lane / 4 + 8 (h = 1): m, l in log2 units, o[nb] the columns
// warp * D/4 + 8 nb + 2 (lane % 4) + {0, 1}.  No barrier inside.
template <int D, bool kScaled, class Tile>
__device__ __forceinline__ void mma_tile_update(
    const uint32_t (&qa)[D / 16][4], const Tile& tile,
    const uint8_t* live_t, const float* ksc, const float* vsc,
    float scale_log2, float (&m)[2], float (&l)[2], float (&o)[D / 32][4]) {
  constexpr int KS = D / 16;              // k16 steps of S = Q K^T
  constexpr int NB = D / 32;              // n8 blocks of O a warp owns
  static_assert(kTK == 32, "the score tile is 4 n8 blocks");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // S = Q K^T for the tile's 32 keys: sc[nb] is keys 8 nb .. 8 nb + 7
  float sc[4][4];
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[nb][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 2) {
      uint32_t bk[4];
      tile.k_frag(bk, nb, kk, lane);
      mma_bf16(sc[nb], qa[kk], bk[0], bk[1]);
      mma_bf16(sc[nb], qa[kk + 1], bk[2], bk[3]);
    }
  }

  // liveness, online softmax on the fragment (element sc[nb][2h + e] is
  // row lane / 4 + 8 h, key 8 nb + 2 (lane % 4) + e)
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = 8 * nb + 2 * (lane % 4) + e;
        float& x = sc[nb][2 * h + e];
        if (kScaled) x *= ksc[key];
        x = live_t[key] ? x * scale_log2 : -INFINITY;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    alpha[h] = exp2f(m[h] - m_use);
    float rs = 0.f;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[nb][2 * h + e];
        x = exp2f(x - m_use);
        rs += x;
        if (kScaled) x *= vsc[8 * nb + 2 * (lane % 4) + e];
      }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l[h] = l[h] * alpha[h] + rs;
    m[h] = m_new;
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    o[nb][0] *= alpha[0];
    o[nb][1] *= alpha[0];
    o[nb][2] *= alpha[1];
    o[nb][3] *= alpha[1];
  }

  // O += P V: P as bf16 A fragments, high and low parts (keys 0-15, then
  // 16-31)
  uint32_t ph[2][4], pl[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    split_bf16(sc[2 * kk][0], sc[2 * kk][1], ph[kk][0], pl[kk][0]);
    split_bf16(sc[2 * kk][2], sc[2 * kk][3], ph[kk][1], pl[kk][1]);
    split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[kk][2], pl[kk][2]);
    split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[kk][3], pl[kk][3]);
  }
  const int col0 = warp * (D / 4);        // this warp's columns of O
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    // matrices: keys 0-7, 8-15, 16-23, 24-31 x columns col0 + 8 nb ..
    uint32_t bv[4];
    tile.v_frag(bv, col0 + 8 * nb, lane);
    mma_bf16(o[nb], ph[0], bv[0], bv[1]);
    mma_bf16(o[nb], pl[0], bv[0], bv[1]);
    mma_bf16(o[nb], ph[1], bv[2], bv[3]);
    mma_bf16(o[nb], pl[1], bv[2], bv[3]);
  }
}

// The split's result from the fragments of mma_tile_update: the output
// itself (one split) or its partial state.
template <int D>
__device__ __forceinline__ void mma_store(const float (&m)[2],
                                          const float (&l)[2],
                                          const float (&o)[D / 32][4],
                                          __nv_bfloat16* out, float* part,
                                          int b, int kvh, int split, int Hkv,
                                          int n_splits, int H, int G) {
  constexpr int NB = D / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = warp * (D / 4);
  // rows lane / 4 and lane / 4 + 8, columns col0 + 8 nb + 2 (lane % 4) + e
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = lane / 4 + 8 * h;
    if (g >= G) continue;
    if (n_splits == 1) {
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
      __nv_bfloat16* orow = out + ((long long)b * H + (long long)kvh * G + g) *
                                      D + col0 + 2 * (lane % 4);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * nb) =
            __floats2bfloat162_rn(o[nb][2 * h] * inv, o[nb][2 * h + 1] * inv);
    } else {
      float* row = part + partial_row(b, kvh, split, g, Hkv, n_splits, G, D);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        *reinterpret_cast<float2*>(row + col0 + 8 * nb + 2 * (lane % 4)) =
            make_float2(o[nb][2 * h], o[nb][2 * h + 1]);
      if (warp == 0 && lane % 4 == 0) {
        row[D] = m[h] == -INFINITY ? kNoKey : m[h] / 1.4426950408889634f;
        row[D + 1] = l[h];
      }
    }
  }
}

// ---- the combine ----
// Grid (G, Hkv, B), D threads: one output row of D elements a block.
template <typename T, typename Caller>
__global__ void combine_splits_kernel(const float* __restrict__ part,
                                      T* __restrict__ out, int H, int Hkv,
                                      int n_splits, int D) {
  const int g = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = gridDim.x, d = threadIdx.x;
  const float* row = part + partial_row(b, kvh, 0, g, Hkv, n_splits, G, D);
  const long long stride = (long long)G * (D + 2);   // next split, same row
  float mx = kNoKey;
  for (int i = 0; i < n_splits; ++i) mx = fmaxf(mx, row[i * stride + D]);
  float num = 0.f, den = 0.f;
  for (int i = 0; i < n_splits; ++i) {
    const float* p = row + i * stride;
    const float c = expf(p[D] - mx);
    num += p[d] * c;
    den += p[D + 1] * c;
  }
  store_out(out + ((long long)b * H + kvh * G + g) * D + d,
            num / fmaxf(den, 1e-30f));
}

template <typename Caller, typename T>
cudaError_t launch_combine(const float* part, T* out, int B, int H, int Hkv,
                           int n_splits, int D, cudaStream_t stream) {
  combine_splits_kernel<T, Caller><<<dim3(H / Hkv, Hkv, B), D, 0, stream>>>(
      part, out, H, Hkv, n_splits, D);
  return cudaGetLastError();
}

}  // namespace flash_decoding
