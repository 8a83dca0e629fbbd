// int8-weight matrix product with per-output-channel scales, for Hopper:
//     out[m, n] = (sum_k x[m, k] * w_q[k, n]) * scales[n]
// with f32 accumulation and the output in x's dtype (float32 or bfloat16).
//
// Replaces the reference package's Pallas TPU kernel
// src/repro/kernels/quant_matmul.py: quant_matmul_pallas (body _qmm_kernel).
// That kernel pads x and w_q to (bm, bn, bk) blocks and carries an f32 VMEM
// accumulator across a sequential K grid axis.  Here nothing is padded or
// copied: a block owns an output tile and walks its K range itself,
// masking the ragged edges of M, N and K.  As in _qmm_kernel, the scales
// are applied once, after the K loop (the reference's quant_matmul_ref
// scales the weights before the sum, which rounds differently: ~1e-6
// relative in f32).  w_q stays [K, N] with N contiguous, as callers pass
// it: it is never repacked, which would read it twice.
//
// What bounds it: at decode widths (a few rows) the int8 weight bytes
// (K*N, read once); at prefill widths (M of 512 and up) the 2*M*K*N
// operations.
//
// bfloat16 x (qmm_mma_kernel): the tensor cores.  Every int8 weight is
// exact in bf16, so mma.sync m16n8k16 (bf16 inputs, f32 accumulation)
// forms exact products and only the order of the sums differs from the
// plain version.  Per K step of BK rows:
//  * the x tile [BM][BK] (bf16) and the weight tile [BK][BN] (int8, 1 byte
//    an element) arrive by cp.async (16-byte copies) into a ring of
//    STAGES stages, STAGES - 1 steps ahead of the products;
//  * the weight tile is widened to a bf16 tile [BK][BN + 8] in shared
//    memory with a magic-number conversion (each byte, biased to unsigned,
//    becomes the low byte of the float 2^23 + u; 2^23 + 128 subtracted
//    leaves the int8 value, and the float's upper half is its bf16): two
//    byte permutes and a subtraction an element, against a quarter-rate
//    I2F;
//  * how the tile meets the fragment: the k16n8 B fragment packs two
//    neighbouring k of one column n into a register, while W's rows are
//    N-contiguous (neighbouring n of one k).  ldmatrix .trans of the
//    [k][n] tile performs exactly that transpose: each 8x8 matrix is 8 k
//    rows of 8 columns, and thread `lane` receives rows 2 (lane % 4) and
//    + 1 of column lane / 4, the B fragment's layout.  One x4 load gives
//    the (k 0-7, k 8-15) halves of two n8 blocks.  x is the A operand,
//    row-major as stored, by plain ldmatrix.  Row pitches of 16 bytes more
//    than a row keep both loads free of bank conflicts;
//  * one barrier a K step: step t's copies were issued STAGES - 1 steps
//    earlier, and while the warps multiply step t they also widen step
//    t + 1 into the second of two widened buffers;
//  * decode rows (M <= 16: DecodeTc, BM 16, one m16 tile with the rows past
//    M zero-filled; BN 128 over 4 warps, BK 64, 4 stages) are bytes-bound,
//    so K is also split across blocks (grid z, planned by the wrapper from
//    the SM count: kernels/quant_matmul.py plan_k_splits) to fill the card
//    and keep enough weight bytes in flight (8 blocks an SM: the down
//    projection's 64 column tiles take 17 splits); each split writes its f32
//    partial [splits, M, N] and qmm_reduce_kernel sums the splits in index
//    order and applies the scales (deterministic, no atomics).  Prefill
//    rows (PrefillTc: 128 x 128 x 32 tiles, 8 warps of 64 x 32, 4 stages,
//    128 registers: two blocks an SM) split K only when the output tiles
//    alone cannot fill the SMs;
//  * mma.sync, not wgmma: wgmma would read the widened B tile from shared
//    memory through a descriptor in the 128-byte swizzled layout, which
//    the widening pass would have to write; flash_attention.cu's descriptor
//    code covers TMA-written K/V tiles, not a tile written by threads.
//    That step is left for later work.
// The tensor-core path needs N % 16 == 0, K % 8 == 0 and 16-byte aligned x
// and w_q (whole 16-byte chunks along N and K).  choose() alone decides;
// the wrapper reads the tile it picked through quant_matmul_tile, so the
// split plan and its CPU mirror cut K on this file's BK.  Otherwise bf16
// takes the
// float32 path's CUDA-core kernels below (element-by-element weight loads
// when N % 16 != 0 or w_q is unaligned): a slow path, same arithmetic.
//
// float32 x: the CUDA cores, for the 1e-4 parity the tensor cores would
// not hold.  Two kernels:
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

#include "ptx.cuh"

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

// ---------------------------------------------------------------------------
// bf16 x on the tensor cores
// ---------------------------------------------------------------------------
template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_>
struct TcConfig {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;   // block tile
  static constexpr int WM = WM_, WN = WN_;             // warps along M, N
  static constexpr int STAGES = STAGES_;               // cp.async ring
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int WTM = BM / WM, WTN = BN / WN;   // a warp's tile
  static constexpr int MT = WTM / 16, NT = WTN / 8;    // its m16 / n8 tiles
  static constexpr int XP = BK + 8;                    // x tile pitch (bf16)
  static constexpr int WBP = BN + 8;                   // widened tile pitch
  static constexpr size_t SMEM = STAGES * ((size_t)BM * XP * 2 +
                                           (size_t)BK * BN) +
                                 2 * (size_t)BK * WBP * 2;
  static_assert(MT >= 1 && NT % 2 == 0 && BK % 16 == 0 && STAGES >= 4 &&
                    (BK * BN / 8) % THREADS == 0,
                "bad tile");
};
// (of the tiles and ring depths tried on the H100, the fastest; PERF.md)
using DecodeTc = TcConfig<16, 128, 64, 1, 4, 4>;    // M <= 16: bytes-bound
using PrefillTc = TcConfig<128, 128, 32, 2, 4, 4>;  // M > 16

// Which kernel takes the inputs: 0 the CUDA cores, 1 DecodeTc, 2
// PrefillTc.  bf16 x takes the tensor cores when its rows and w_q's are
// whole 16-byte chunks (vec: w_q 16-byte aligned, N % 16 == 0) and x is
// 16-byte aligned.  The one place the choice is made: the wrapper asks
// quant_matmul_tile for it.
int choose(int M, int K, int dtype, int vec, int x_aligned) {
  if (dtype != 1 || !vec || K % 8 != 0 || !x_aligned) return 0;
  return M <= DecodeTc::BM ? 1 : 2;
}

// four int8 (one word, byte 0 first) as two bf16 pairs, exactly: byte i,
// biased to unsigned, is the low byte of the float 2^23 + u (exponent and
// upper mantissa from 0x4B000000), 2^23 + 128 subtracted leaves the int8
// value, and the upper half of that float is its bf16
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) -
        8388736.f);
  lo = __byte_perm(f[0], f[1], 0x7632);
  hi = __byte_perm(f[2], f[3], 0x7632);
}

// Grid (M / BM, N / BN, n_splits): block (x, y, z) computes output tile
// (x, y) over split z's K steps [z T / n, (z + 1) T / n) of T = ceil(K / BK);
// with one split it scales and stores the tile, else it writes its f32
// partial to part[z] ([n_splits][M][N]).  M is the fastest grid axis, so
// the blocks that share a weight tile run together and read it from device
// memory once (x, a few MB, stays in L2).
template <class C>
__global__ void __launch_bounds__(C::THREADS)
qmm_mma_kernel(const __nv_bfloat16* __restrict__ x,
               const int8_t* __restrict__ w, const float* __restrict__ scales,
               __nv_bfloat16* __restrict__ out, float* __restrict__ part,
               int M, int K, int N, int n_splits) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);                      // [STAGES][BM][XP]
  int8_t* ws = reinterpret_cast<int8_t*>(xs + C::STAGES * C::BM * C::XP);
  // ws: [STAGES][BK][BN] int8, as loaded; wb: [2][BK][WBP] bf16, widened
  T* wb = reinterpret_cast<T*>(ws + C::STAGES * C::BK * C::BN);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;
  const int split = blockIdx.z;
  const int steps = (K + C::BK - 1) / C::BK;
  const int kt0 = (int)((long long)split * steps / n_splits);
  const int nk = (int)((long long)(split + 1) * steps / n_splits) - kt0;

  // K step kt into ring stage `stage`: x rows past M, x columns and w rows
  // past K, and w columns past N zero-filled without a read
  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * C::BK;
    T* xd = xs + stage * C::BM * C::XP;
    for (int idx = tid; idx < C::BM * C::BK / 8; idx += C::THREADS) {
      const int r = idx / (C::BK / 8), c = idx % (C::BK / 8);
      const int gm = m0 + r, gk = k0 + 8 * c;
      const bool ok = gm < M && gk < K;
      ptx::cp_async16(xd + r * C::XP + 8 * c,
                      ok ? x + (long long)gm * K + gk : x, ok);
    }
    int8_t* wd = ws + stage * C::BK * C::BN;
    for (int idx = tid; idx < C::BK * C::BN / 16; idx += C::THREADS) {
      const int r = idx / (C::BN / 16), c = idx % (C::BN / 16);
      const int gk = k0 + r, gn = n0 + 16 * c;
      const bool ok = gk < K && gn < N;
      ptx::cp_async16(wd + r * C::BN + 16 * c,
                      ok ? w + (long long)gk * N + gn : w, ok);
    }
  };

  // the int8 tile of ring stage `stage` widened into wb[buf]: 8 weights
  // (one 8-byte read, one 16-byte write) a thread a step
  auto widen = [&](int stage, int buf) {
    const int8_t* src = ws + stage * C::BK * C::BN;
    T* dst = wb + buf * C::BK * C::WBP;
#pragma unroll
    for (int i = 0; i < C::BK * C::BN / 8 / C::THREADS; ++i) {
      const int idx = tid + i * C::THREADS;
      const int r = idx / (C::BN / 8), c = idx % (C::BN / 8);
      const uint2 raw =
          *reinterpret_cast<const uint2*>(src + r * C::BN + 8 * c);
      uint4 o;
      widen4(raw.x, o.x, o.y);
      widen4(raw.y, o.z, o.w);
      *reinterpret_cast<uint4*>(dst + r * C::WBP + 8 * c) = o;
    }
  };

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // software pipeline, one barrier a K step: in step t the block issues
  // the copies of step t + STAGES - 1, widens step t + 1 into the other
  // widened buffer and multiplies step t, so the widening of one step
  // overlaps the products of the one before across the block's warps
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nk) load_stage(s, kt0 + s);
    ptx::cp_async_commit();   // empty groups keep the count uniform
  }
  if (nk > 0) {
    ptx::cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    widen(0, 0);
  }
  const int j8 = lane / 8, r8 = lane % 8;   // ldmatrix: matrix, row
  for (int t = 0; t < nk; ++t) {
    // steps t and t + 1 landed, wb[t % 2] written, step t - 1's products
    // and widening done: their buffers may be refilled
    ptx::cp_async_wait<C::STAGES - 3>();
    __syncthreads();
    if (t + C::STAGES - 1 < nk)
      load_stage((t + C::STAGES - 1) % C::STAGES, kt0 + t + C::STAGES - 1);
    ptx::cp_async_commit();
    if (t + 1 < nk) widen((t + 1) % C::STAGES, (t + 1) % 2);

    const T* xt = xs + (t % C::STAGES) * C::BM * C::XP;
    const T* wt = wb + (t % 2) * C::BK * C::WBP;
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk) {
      // A: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15), j = row half + 2 k half
      uint32_t a[C::MT][4];
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
        ptx::ldmatrix_x4(
            a[mt], xt + (wm * C::WTM + 16 * mt + (j8 & 1) * 8 + r8) * C::XP +
                       16 * kk + (j8 >> 1) * 8);
#pragma unroll
      for (int np = 0; np < C::NT / 2; ++np) {
        // B, transposed: (k 0-7 | 8-15) x (n 0-7 | 8-15) of n8 blocks 2 np
        // and 2 np + 1, j = k half + 2 n half
        uint32_t b[4];
        ptx::ldmatrix_x4_trans(b, wt + (16 * kk + (j8 & 1) * 8 + r8) * C::WBP +
                                      wn * C::WTN + 16 * np + (j8 >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt) {
          ptx::mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          ptx::mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  ptx::cp_async_wait<0>();

  // acc[mt][nt]: rows lane / 4 (e 0, 1) and + 8 (e 2, 3), columns
  // 2 (lane % 4) + {0, 1} of the warp's m16 tile mt, n8 block nt
  float* pz = part + (long long)split * M * N;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      const int n = n0 + wn * C::WTN + 8 * nt + 2 * (lane % 4);
      if (n >= N) continue;          // N is even: n + 1 < N too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * C::WTM + 16 * mt + lane / 4 + 8 * h;
        if (m >= M) continue;
        const float c0 = acc[mt][nt][2 * h], c1 = acc[mt][nt][2 * h + 1];
        if (n_splits == 1)
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)m * N + n) =
              __floats2bfloat162_rn(c0 * scales[n], c1 * scales[n + 1]);
        else
          *reinterpret_cast<float2*>(pz + (long long)m * N + n) =
              make_float2(c0, c1);
      }
    }
}

// out = (sum over the splits, in index order, of part) * scales
__global__ void qmm_reduce_kernel(const float* __restrict__ part,
                                  const float* __restrict__ scales,
                                  __nv_bfloat16* __restrict__ out, int M,
                                  int N, int n_splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long mn = (long long)M * N;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < n_splits; ++z) s += part[z * mn + i];
  out[i] = __float2bfloat16(s * scales[i % N]);
}

template <class C>
cudaError_t launch_mma(const void* x, const void* w, const void* scales,
                       void* out, void* part, int M, int K, int N,
                       int n_splits, cudaStream_t stream) {
  auto kern = qmm_mma_kernel<C>;
  // set on every launch: the attribute is per device, and the call is cheap
  cudaError_t set = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (set != cudaSuccess) return set;
  const dim3 grid((M + C::BM - 1) / C::BM, (N + C::BN - 1) / C::BN, n_splits);
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scales), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), M, K, N, n_splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  const long long mn = (long long)M * N;
  qmm_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const float*>(scales),
      static_cast<__nv_bfloat16*>(out), M, N, n_splits);
  return cudaGetLastError();
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
// 16-byte aligned and N % 16 == 0.  bfloat16 with vec, K % 8 == 0 and a
// 16-byte aligned x takes the tensor cores with n_splits splits of K (part:
// a float32 scratch of n_splits*M*N elements, unused and may be null with
// one split); every other case takes the CUDA cores with n_splits 1.
int quant_matmul_launch(const void* x, const void* w, const void* scales,
                        void* out, void* part, int M, int K, int N, int dtype,
                        int vec, int n_splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || N <= 0 || n_splits < 1 ||
      (n_splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int path = choose(M, K, dtype, vec,
                          reinterpret_cast<uintptr_t>(x) % 16 == 0);
  if (path == 1)
    return (int)launch_mma<DecodeTc>(x, w, scales, out, part, M, K, N,
                                     n_splits, st);
  if (path == 2)
    return (int)launch_mma<PrefillTc>(x, w, scales, out, part, M, K, N,
                                      n_splits, st);
  if (n_splits != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch<float>(x, w, scales, out, M, K, N, vec, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, scales, out, M, K, N, vec, st);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core tile quant_matmul_launch takes for these inputs (its
// arguments, x_aligned = 1 when x is 16-byte aligned): writes {BM, BN, BK,
// 1 if bytes-bound (the decode tile) else 0} to tile and returns 1, or
// returns 0 when the inputs take the CUDA cores (n_splits must then be 1).
int quant_matmul_tile(int M, int K, int dtype, int vec, int x_aligned,
                      int* tile) {
  const int path = choose(M, K, dtype, vec, x_aligned);
  if (path == 0) return 0;
  const int t[2][4] = {{DecodeTc::BM, DecodeTc::BN, DecodeTc::BK, 1},
                       {PrefillTc::BM, PrefillTc::BN, PrefillTc::BK, 0}};
  for (int i = 0; i < 4; ++i) tile[i] = t[path - 1][i];
  return 1;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
