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
// The tile bodies (both dtypes), the split's store and the combine live in
// flash_decoding.cuh, shared with the paged kernel; this file keeps the
// dense ring's tile loader (row s of the split at s * stride, liveness
// from kv_valid).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_decoding.cuh"

namespace {

using flash_decoding::kThreads;
using flash_decoding::kTK;

// Copy keys s0 .. s0 + kTK - 1 of the split [s_begin, s_end) into shared
// buffer `buf` (rows of the padded pitch of flash_decoding::TileRow), those
// past s_end or dead zero-filled without a read, and their liveness beside
// them; one cp.async group.
template <typename T, int D>
__device__ __forceinline__ void load_kv_tile(T* ks, T* vs, uint8_t* live_s,
                                             const T* kb, const T* vb,
                                             const uint8_t* lv, long long k_ss,
                                             long long v_ss, int s0,
                                             int s_begin, int s_end, int buf) {
  constexpr int EPC = flash_decoding::TileRow<T>::kEpc;
  constexpr int CPR = D / EPC;
  constexpr int PITCH = flash_decoding::TileRow<T>::template pitch<D>();
  for (int idx = threadIdx.x; idx < kTK * CPR; idx += kThreads) {
    const int r = idx / CPR, c = idx % CPR;
    const int s = s0 + r;
    const bool ok = s < s_end && lv[s];
    const long long src = ok ? s : s_begin;
    ptx::cp_async16(ks + (buf * kTK + r) * PITCH + c * EPC,
                               kb + src * k_ss + c * EPC, ok);
    ptx::cp_async16(vs + (buf * kTK + r) * PITCH + c * EPC,
                               vb + src * v_ss + c * EPC, ok);
    if (c == 0) live_s[buf * kTK + r] = ok;
  }
  ptx::cp_async_commit();
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
  using Shape = flash_decoding::F32Shape<D, MAXG>;
  constexpr int EPC = 4;
  constexpr int PITCH = flash_decoding::TileRow<T>::template pitch<D>();

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                   // [2][kTK][PITCH]
  T* vs = ks + 2 * kTK * PITCH;                         // [2][kTK][PITCH]
  float* qs = reinterpret_cast<float*>(vs + 2 * kTK * PITCH);   // [G][D]
  float* ps = qs + MAXG * D;                            // [G][kTK]
  float* row_a = ps + MAXG * kTK;                       // [G]: alpha, then m
  float* row_l = row_a + MAXG;                          // [G]: l at the end
  uint8_t* live_s = reinterpret_cast<uint8_t*>(row_l + MAXG);   // [2][kTK]

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
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

  float m_r[Shape::SG], l_r[Shape::SG], acc[Shape::GPT][2];
#pragma unroll
  for (int j = 0; j < Shape::SG; ++j) { m_r[j] = -INFINITY; l_r[j] = 0.f; }
#pragma unroll
  for (int j = 0; j < Shape::GPT; ++j) acc[j][0] = acc[j][1] = 0.f;

  if (ntile > 0) load_tile(0, s_begin);
  for (int t = 0; t < ntile; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntile) load_tile(buf ^ 1, s_begin + (t + 1) * kTK);
    if (t + 1 < ntile)
      ptx::cp_async_wait<1>();
    else
      ptx::cp_async_wait<0>();
    // tile t (and, the first time, q) visible; skip a tile with no live key
    if (!__syncthreads_or(tid < kTK && live_s[buf * kTK + tid])) continue;
    flash_decoding::f32_tile_update<D, MAXG, T, false>(
        ks + buf * kTK * PITCH, vs + buf * kTK * PITCH, live_s + buf * kTK,
        nullptr, nullptr, qs, ps, row_a, G, scale, m_r, l_r, acc);
  }
  flash_decoding::f32_store<D, MAXG, T>(m_r, l_r, acc, row_a, row_l, out,
                                        part, b, kvh, split, gridDim.y,
                                        n_splits, H, G);
}

// ---- bf16: the two products on the tensor cores (mma.sync), the tile
// body of flash_decoding::mma_tile_update ----
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
  using Tile = flash_decoding::Bf16Tile<D>;
  constexpr int PITCH = Tile::PITCH;      // +16 bytes: conflict-free ldmatrix

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                   // [2][kTK][PITCH]
  T* vs = ks + 2 * kTK * PITCH;                         // [2][kTK][PITCH]
  uint8_t* live_s = reinterpret_cast<uint8_t*>(vs + 2 * kTK * PITCH);

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32;
  const int s_begin = (int)((long long)split * S / n_splits);
  const int s_end = (int)((long long)(split + 1) * S / n_splits);
  const int ntile = (s_end - s_begin + kTK - 1) / kTK;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  const uint8_t* lv = valid + b * valid_sb;

  uint32_t qa[D / 16][4];
  flash_decoding::load_q_frags<D>(
      qa, q + ((long long)b * H + (long long)kvh * G) * D, G, lane);

  auto load_tile = [&](int buf, int s0) {
    load_kv_tile<T, D>(ks, vs, live_s, kb, vb, lv, k_ss, v_ss, s0, s_begin,
                       s_end, buf);
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[D / 32][4];
#pragma unroll
  for (int nb = 0; nb < D / 32; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nb][i] = 0.f;

  if (ntile > 0) load_tile(0, s_begin);
  for (int t = 0; t < ntile; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntile) load_tile(buf ^ 1, s_begin + (t + 1) * kTK);
    if (t + 1 < ntile)
      ptx::cp_async_wait<1>();
    else
      ptx::cp_async_wait<0>();
    if (!__syncthreads_or(tid < kTK && live_s[buf * kTK + tid])) continue;
    const Tile tile{ks + buf * kTK * PITCH, vs + buf * kTK * PITCH};
    flash_decoding::mma_tile_update<D, false>(qa, tile, live_s + buf * kTK,
                                              nullptr, nullptr, scale_log2,
                                              m, l, o);
    __syncthreads();   // the buffer is refilled two tiles on
  }
  flash_decoding::mma_store<D>(m, l, o, out, part, b, kvh, split, gridDim.y,
                               n_splits, H, G);
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
  const size_t smem =
      4 * (size_t)kTK * flash_decoding::Bf16Tile<D>::PITCH * sizeof(T) + 2 * kTK;
  decode_attention_mma_kernel<D><<<dim3(n_splits, Hkv, B), kThreads, smem,
                                   stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(valid),
      static_cast<T*>(out), part, H, S, H / Hkv, n_splits, k_sb, k_ss, k_sh,
      v_sb, v_ss, v_sh, valid_sb, 1.4426950408889634f / sqrtf((float)D));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  return flash_decoding::launch_combine<flash_decoding::DecodeCaller>(
      part, static_cast<T*>(out), B, H, Hkv, n_splits, D, stream);
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
  return flash_decoding::launch_combine<flash_decoding::DecodeCaller>(
      part, static_cast<float*>(out), B, H, Hkv, n_splits, D, stream);
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
