// One-token GQA decode attention over a dense (ring) KV cache, for Hopper,
// as split-S flash-decoding.
//
// Replaces the reference package's Pallas TPU kernel
// src/repro/kernels/decode_attention.py: decode_attention_pallas (body
// _decode_kernel).  Same contract as _decode_jnp / decode_attention_ref:
// scale 1/sqrt(D), f32 accumulation, masked keys contribute nothing, the
// softmax denominator is clamped at 1e-30 (an all-masked row yields 0), and
// the output has the input dtype.
//
// What bounds it: the K and V bytes read, once per decode step per layer
// (2*B*S*Hkv*D*sizeof(T)); the arithmetic is ~G*D FMAs per key, far below
// the card's compute rate.  What held the first version back was latency:
// B*Hkv blocks (16 at the text serving shape) on 132 SMs, each waiting on a
// chain of one online-softmax update per key.  The design:
//  * split S across blocks: grid (n_splits, Hkv, B), n_splits chosen by the
//    wrapper (kernels/decode_attention.py: plan_splits) so the grid holds at
//    least four blocks per SM, each split a balanced slice
//    [i*S/n, (i+1)*S/n) of at least 64 keys; each split writes its
//    unnormalised (m, l, acc[G][D]) to a float32 scratch buffer and
//    flash_decoding.cuh's combine kernel, launched right after by the same
//    C entry point, merges the splits in index order.  With one split the
//    kernel writes the output itself;
//  * inside a split, tiles of 32 keys are double-buffered in shared memory
//    with cp.async (16-byte copies, a padded row pitch so the score loop's
//    row reads are conflict-free); a key whose kv_valid bit is off is not
//    read (the copy zero-fills) and not counted, and a tile with no live
//    key is skipped whole;
//  * per tile, all G x 32 scores first, one max per query row per tile,
//    then exp and P V over the tile - no chain of per-key softmax updates.
//    bfloat16 (the serving dtype) runs both products on the tensor cores
//    (decode_attention_mma_kernel: mma.sync m16n8k16, the G <= 16 rows in
//    one m16 tile, P kept in registers); float32 on the CUDA cores
//    (decode_attention_kernel: a lane a key when scoring, the 4 warps over
//    the query rows, q broadcast from shared memory; a thread a pair of
//    head_dim columns, four keys a step, in P V), as tensor cores would not
//    hold float32 to its 1e-4 parity;
//  * the G query rows of a kv head share every K/V tile (GQA by kv-head
//    indexing, no repeated heads in memory).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_decoding.cuh"

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTK = 32;         // keys a tile (a lane a key when scoring)

// 16-byte global -> shared copy; with `live` false nothing is read and the
// destination is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

// Copy keys s0 .. s0 + kTK - 1 of the split [s_begin, s_end) into shared
// buffer `buf` (rows of PITCH = D + 16 bytes), those past s_end or dead
// zero-filled without a read, and their liveness beside them; one cp.async
// group.
template <typename T, int D>
__device__ __forceinline__ void load_kv_tile(T* ks, T* vs, uint8_t* live_s,
                                             const T* kb, const T* vb,
                                             const uint8_t* lv, long long k_ss,
                                             long long v_ss, int s0,
                                             int s_begin, int s_end, int buf) {
  constexpr int EPC = 16 / sizeof(T);
  constexpr int CPR = D / EPC;
  constexpr int PITCH = D + EPC;
  for (int idx = threadIdx.x; idx < kTK * CPR; idx += kThreads) {
    const int r = idx / CPR, c = idx % CPR;
    const int s = s0 + r;
    const bool ok = s < s_end && lv[s];
    const long long src = ok ? s : s_begin;
    cp_async16(ks + (buf * kTK + r) * PITCH + c * EPC,
               kb + src * k_ss + c * EPC, ok);
    cp_async16(vs + (buf * kTK + r) * PITCH + c * EPC,
               vb + src * v_ss + c * EPC, ok);
    if (c == 0) live_s[buf * kTK + r] = ok;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// ---- float32: the products on the CUDA cores ----
template <int D, int MAXG>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const uint8_t* __restrict__ valid,
                        float* __restrict__ out, float* __restrict__ part,
                        int H, int S, int G, int n_splits, long long k_sb,
                        long long k_ss, long long k_sh, long long v_sb,
                        long long v_ss, long long v_sh, long long valid_sb,
                        float scale) {
  using T = float;
  constexpr int EPC = 4;                    // elements a 16-byte chunk
  constexpr int CPR = D / EPC;              // chunks a key row
  constexpr int PITCH = D + EPC;            // smem row pitch: +16 bytes
  constexpr int RG = 2 * kThreads / D;      // row groups in P V (2, 4, 8)
  constexpr int GPT = (MAXG + RG - 1) / RG; // query rows a thread in P V
  constexpr int SG = (MAXG + kWarps - 1) / kWarps;   // rows a warp scores
  static_assert((2 * kThreads) % D == 0, "bad D");

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                   // [2][kTK][PITCH]
  T* vs = ks + 2 * kTK * PITCH;                         // [2][kTK][PITCH]
  float* qs = reinterpret_cast<float*>(vs + 2 * kTK * PITCH);   // [G][D]
  float* ps = qs + MAXG * D;                            // [G][kTK]
  float* row_a = ps + MAXG * kTK;                       // [G]: alpha, then m
  float* row_l = row_a + MAXG;                          // [G]: l at the end
  uint8_t* live_s = reinterpret_cast<uint8_t*>(row_l + MAXG);   // [2][kTK]

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int s_begin = (int)((long long)split * S / n_splits);
  const int s_end = (int)((long long)(split + 1) * S / n_splits);
  const int ntile = (s_end - s_begin + kTK - 1) / kTK;

  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  const uint8_t* lv = valid + b * valid_sb;

  // the kv head's G query rows, as f32
  const T* qb = q + ((long long)b * H + (long long)kvh * G) * D;
  for (int idx = tid * EPC; idx < G * D; idx += kThreads * EPC)
    *reinterpret_cast<float4*>(qs + idx) =
        *reinterpret_cast<const float4*>(qb + idx);

  auto load_tile = [&](int buf, int s0) {
    load_kv_tile<T, D>(ks, vs, live_s, kb, vb, lv, k_ss, v_ss, s0, s_begin,
                       s_end, buf);
  };

  // running (m, l) of query row g = warp + kWarps j live in warp g % kWarps;
  // acc of rows g = rg + RG j, columns 2 dcol and 2 dcol + 1, here
  float m_r[SG], l_r[SG], acc[GPT][2];
#pragma unroll
  for (int j = 0; j < SG; ++j) { m_r[j] = -INFINITY; l_r[j] = 0.f; }
#pragma unroll
  for (int j = 0; j < GPT; ++j) acc[j][0] = acc[j][1] = 0.f;
  const int dcol = tid % (D / 2), rg = tid / (D / 2);

  if (ntile > 0) load_tile(0, s_begin);
  for (int t = 0; t < ntile; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntile) {
      load_tile(buf ^ 1, s_begin + (t + 1) * kTK);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    // tile t (and, the first time, q) visible; skip a tile with no live key
    if (!__syncthreads_or(tid < kTK && live_s[buf * kTK + tid])) continue;

    // scores of all G rows for the tile's keys: lane = key
    {
      const bool live = live_s[buf * kTK + lane];
      const T* krow = ks + (buf * kTK + lane) * PITCH;
      float sc[SG][4];   // four independent partial sums a row
#pragma unroll
      for (int j = 0; j < SG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll 4
      for (int c = 0; c < CPR; ++c) {
        const float4 k4 = *reinterpret_cast<const float4*>(krow + c * EPC);
        const float kf[EPC] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int j = 0; j < SG; ++j) {
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
#pragma unroll
      for (int j = 0; j < SG; ++j) {
        const int g = warp + kWarps * j;
        if (g >= G) break;
        const float dot = (sc[j][0] + sc[j][1]) + (sc[j][2] + sc[j][3]);
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
        ps[g * kTK + lane] = p;
        if (lane == 0) row_a[g] = alpha;
      }
    }
    __syncthreads();

    // P V over the tile: columns 2 dcol, 2 dcol + 1 of rows rg + RG j,
    // four keys a step (p as float4, V as column pairs)
#pragma unroll
    for (int j = 0; j < GPT; ++j) {
      const int g = rg + RG * j;
      if (g < G) {
        const float a = row_a[g];
        acc[j][0] *= a;
        acc[j][1] *= a;
      }
    }
    const T* vcol = vs + buf * kTK * PITCH + 2 * dcol;
#pragma unroll 2
    for (int kk = 0; kk < kTK; kk += 4) {
      float2 vv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        vv[u] = *reinterpret_cast<const float2*>(vcol + (kk + u) * PITCH);
#pragma unroll
      for (int j = 0; j < GPT; ++j) {
        const int g = rg + RG * j;
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

  // each row's (m, l) to shared memory, then the split's result
#pragma unroll
  for (int j = 0; j < SG; ++j) {
    const int g = warp + kWarps * j;
    if (g < G && lane == 0) {
      row_a[g] = m_r[j] == -INFINITY ? flash_decoding::kNoKey : m_r[j];
      row_l[g] = l_r[j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < GPT; ++j) {
    const int g = rg + RG * j;
    if (g >= G) continue;
    if (n_splits == 1) {
      T* o = out + ((long long)b * H + (long long)kvh * G + g) * D + 2 * dcol;
      const float inv = 1.f / fmaxf(row_l[g], 1e-30f);
      flash_decoding::store_out(o, acc[j][0] * inv);
      flash_decoding::store_out(o + 1, acc[j][1] * inv);
    } else {
      float* row = part + flash_decoding::partial_row(
                              b, kvh, split, g, gridDim.y, n_splits, G, D);
      row[2 * dcol] = acc[j][0];
      row[2 * dcol + 1] = acc[j][1];
      if (dcol == 0) {
        row[D] = row_a[g];
        row[D + 1] = row_l[g];
      }
    }
  }
}

// ---- bf16: the two products on the tensor cores (mma.sync) ----
//
// The G <= 16 query rows of a kv head fill one m16 tile (rows past G are
// zeros).  Every warp scores the whole 32-key tile (S = Q K^T, 4 n8 blocks
// x D/16 k16 steps; exact, the inputs being bf16), so each warp holds every
// row's scores in registers: the row max and sum take two quad shuffles,
// and P, split into two bf16 parts in registers, is the A operand of
// O += P V (the m16n8k16 A layout is the accumulator layout of two
// neighbouring n8 blocks).  Each warp owns a quarter of the head_dim
// columns of O.  The scores are computed four times over (once a warp):
// cheap next to the shared-memory round trip and the two block barriers a
// split of the scores would cost.

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// (a, b) ~= hi + lo with both parts bf16 pairs: P keeps ~16 bits through
// the second product, so the bf16 kernel sums like the float32 plain
// version (a P rounded once to bf16 would move outputs by up to ~1e-2)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const uint8_t* __restrict__ valid,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ part, int H, int S, int G,
                            int n_splits, long long k_sb, long long k_ss,
                            long long k_sh, long long v_sb, long long v_ss,
                            long long v_sh, long long valid_sb,
                            float scale_log2) {
  using T = __nv_bfloat16;
  constexpr int PITCH = D + 8;            // +16 bytes: conflict-free ldmatrix
  constexpr int KS = D / 16;              // k16 steps of S = Q K^T
  constexpr int NB = D / 32;              // n8 blocks of O a warp owns
  static_assert(kTK == 32, "the score tile is 4 n8 blocks");

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                   // [2][kTK][PITCH]
  T* vs = ks + 2 * kTK * PITCH;                         // [2][kTK][PITCH]
  uint8_t* live_s = reinterpret_cast<uint8_t*>(vs + 2 * kTK * PITCH);

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int s_begin = (int)((long long)split * S / n_splits);
  const int s_end = (int)((long long)(split + 1) * S / n_splits);
  const int ntile = (s_end - s_begin + kTK - 1) / kTK;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  const uint8_t* lv = valid + b * valid_sb;

  // Q as m16k16 A fragments: rows lane / 4 and lane / 4 + 8 (zero past G)
  uint32_t qa[KS][4];
  {
    const T* qb = q + ((long long)b * H + (long long)kvh * G) * D +
                  2 * (lane % 4);
    const int r0 = lane / 4, r1 = lane / 4 + 8;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (i & 1) ? r1 : r0;
        qa[kk][i] = r < G ? *reinterpret_cast<const uint32_t*>(
                                qb + (long long)r * D + 16 * kk + 8 * (i / 2))
                          : 0u;
      }
  }

  auto load_tile = [&](int buf, int s0) {
    load_kv_tile<T, D>(ks, vs, live_s, kb, vb, lv, k_ss, v_ss, s0, s_begin,
                       s_end, buf);
  };

  // per thread: rows lane / 4 (h = 0) and lane / 4 + 8 (h = 1)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nb][i] = 0.f;
  const int col0 = warp * (D / 4);        // this warp's columns of O

  if (ntile > 0) load_tile(0, s_begin);
  for (int t = 0; t < ntile; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntile) {
      load_tile(buf ^ 1, s_begin + (t + 1) * kTK);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    if (!__syncthreads_or(tid < kTK && live_s[buf * kTK + tid])) continue;
    const T* kt = ks + buf * kTK * PITCH;
    const T* vt = vs + buf * kTK * PITCH;

    // S = Q K^T for the tile's 32 keys: sc[nb] is keys 8 nb .. 8 nb + 7
    float sc[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nb][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; kk += 2) {
        // matrices: (d 16kk, 16kk + 8, 16kk + 16, 16kk + 24) x 8 keys
        uint32_t bk[4];
        ldmatrix_x4(bk, kt + (8 * nb + lane % 8) * PITCH + 16 * kk +
                            8 * (lane / 8));
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
          const bool ok = live_s[buf * kTK + 8 * nb + 2 * (lane % 4) + e];
          float& x = sc[nb][2 * h + e];
          x = ok ? x * scale_log2 : -INFINITY;
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

    // O += P V: P as bf16 A fragments, high and low parts (keys 0-15,
    // then 16-31)
    uint32_t ph[2][4], pl[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      split_bf16(sc[2 * kk][0], sc[2 * kk][1], ph[kk][0], pl[kk][0]);
      split_bf16(sc[2 * kk][2], sc[2 * kk][3], ph[kk][1], pl[kk][1]);
      split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[kk][2], pl[kk][2]);
      split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[kk][3], pl[kk][3]);
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      // matrices: keys 0-7, 8-15, 16-23, 24-31 x columns col0 + 8 nb ..
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, vt + lane * PITCH + col0 + 8 * nb);
      mma_bf16(o[nb], ph[0], bv[0], bv[1]);
      mma_bf16(o[nb], pl[0], bv[0], bv[1]);
      mma_bf16(o[nb], ph[1], bv[2], bv[3]);
      mma_bf16(o[nb], pl[1], bv[2], bv[3]);
    }
    __syncthreads();   // the buffer is refilled two tiles on
  }

  // rows lane / 4 and lane / 4 + 8, columns col0 + 8 nb + 2 (lane % 4) + e
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = lane / 4 + 8 * h;
    if (g >= G) continue;
    if (n_splits == 1) {
      const float inv = 1.f / fmaxf(l[h], 1e-30f);
      T* orow = out + ((long long)b * H + (long long)kvh * G + g) * D + col0 +
                2 * (lane % 4);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * nb) =
            __floats2bfloat162_rn(o[nb][2 * h] * inv, o[nb][2 * h + 1] * inv);
    } else {
      float* row = part + flash_decoding::partial_row(
                              b, kvh, split, g, gridDim.y, n_splits, G, D);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        *reinterpret_cast<float2*>(row + col0 + 8 * nb + 2 * (lane % 4)) =
            make_float2(o[nb][2 * h], o[nb][2 * h + 1]);
      if (warp == 0 && lane % 4 == 0) {
        row[D] = m[h] == -INFINITY ? flash_decoding::kNoKey
                                   : m[h] / 1.4426950408889634f;
        row[D + 1] = l[h];
      }
    }
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* valid, void* out, float* part, int B,
                       int H, int Hkv, int S, int n_splits, long long k_sb,
                       long long k_ss, long long k_sh, long long v_sb,
                       long long v_ss, long long v_sh, long long valid_sb,
                       cudaStream_t stream) {
  using T = __nv_bfloat16;
  if (H / Hkv > 16) return cudaErrorInvalidValue;
  const size_t smem = 4 * (size_t)kTK * (D + 8) * sizeof(T) + 2 * kTK;
  decode_attention_mma_kernel<D><<<dim3(n_splits, Hkv, B), kThreads, smem,
                                   stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(valid),
      static_cast<T*>(out), part, H, S, H / Hkv, n_splits, k_sb, k_ss, k_sh,
      v_sb, v_ss, v_sh, valid_sb, 1.4426950408889634f / sqrtf((float)D));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  return flash_decoding::launch_combine<T>(part, static_cast<T*>(out), B, H,
                                           Hkv, n_splits, D, stream);
}

template <int D, int MAXG>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid, void* out, float* part, int B, int H,
                   int Hkv, int S, int n_splits, long long k_sb,
                   long long k_ss, long long k_sh, long long v_sb,
                   long long v_ss, long long v_sh, long long valid_sb,
                   cudaStream_t stream) {
  constexpr int PITCH = D + 4;
  const size_t smem = 4 * (size_t)kTK * PITCH * sizeof(float) +
                      sizeof(float) * ((size_t)MAXG * D + MAXG * kTK +
                                       2 * MAXG) +
                      2 * kTK;
  auto kern = decode_attention_kernel<D, MAXG>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<dim3(n_splits, Hkv, B), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), part, H, S, H / Hkv, n_splits, k_sb, k_ss,
      k_sh, v_sb, v_ss, v_sh, valid_sb, 1.0f / sqrtf((float)D));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  return flash_decoding::launch_combine<float>(part, static_cast<float*>(out),
                                               B, H, Hkv, n_splits, D, stream);
}

template <int D>
cudaError_t by_group(int G, const void* q, const void* k, const void* v,
                     const void* valid, void* out, float* part, int B, int H,
                     int Hkv, int S, int n_splits, long long k_sb,
                     long long k_ss, long long k_sh, long long v_sb,
                     long long v_ss, long long v_sh, long long valid_sb,
                     cudaStream_t stream) {
#define DECODE_ARGS q, k, v, valid, out, part, B, H, Hkv, S, n_splits, k_sb, \
                    k_ss, k_sh, v_sb, v_ss, v_sh, valid_sb, stream
  if (G <= 4) return launch<D, 4>(DECODE_ARGS);
  if (G <= 8) return launch<D, 8>(DECODE_ARGS);
  if (G <= 16) return launch<D, 16>(DECODE_ARGS);
#undef DECODE_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA-core products), 1 = bfloat16 (tensor-core
// products).  Strides are in elements; the last
// (head_dim) axis of q, k, v and out is contiguous, q and out are [B, H, D].
// part is a float32 scratch buffer of B*Hkv*n_splits*G*(D+2) elements
// (unused, may be null, when n_splits == 1).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* valid, void* out, void* part, int B,
                            int H, int Hkv, int S, int D, int dtype,
                            int n_splits, long long k_sb, long long k_ss,
                            long long k_sh, long long v_sb, long long v_ss,
                            long long v_sh, long long valid_sb, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  if (n_splits < 1 || (n_splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  float* pf = static_cast<float*>(part);
#define SPLIT_ARGS q, k, v, valid, out, pf, B, H, Hkv, S, n_splits, k_sb, \
                   k_ss, k_sh, v_sb, v_ss, v_sh, valid_sb, st
  if (dtype == 0) {
    if (D == 32) return (int)by_group<32>(G, SPLIT_ARGS);
    if (D == 64) return (int)by_group<64>(G, SPLIT_ARGS);
    if (D == 128) return (int)by_group<128>(G, SPLIT_ARGS);
  } else if (dtype == 1) {
    if (D == 32) return (int)launch_mma<32>(SPLIT_ARGS);
    if (D == 64) return (int)launch_mma<64>(SPLIT_ARGS);
    if (D == 128) return (int)launch_mma<128>(SPLIT_ARGS);
  }
#undef SPLIT_ARGS
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
