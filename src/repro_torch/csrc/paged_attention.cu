// One-token GQA decode attention through a page table, for Hopper, as
// split-pages flash-decoding.
//
// Replaces the reference package's Pallas TPU kernel
// src/repro/kernels/paged_attention.py: paged_attention_pallas (body
// _paged_kernel).  Same contract as paged_attention_ref: K/V live in one
// page arena [N, ps, Hkv, D] shared by every sequence, row b reaches its
// logical cell i at page page_table[b, i / ps], offset i % ps; cell i is live
// iff i <= pos[b], or every cell once pos[b] >= P*ps (a wrapped ring).  Scale
// 1/sqrt(D), f32 accumulation, softmax denominator clamped at 1e-30, output
// in q's dtype.  Int8 pages carry f32 scales [N, ps, Hkv].
//
// What bounds it: the live K and V bytes, once per decode step per layer
// (2 * live cells * Hkv * D * sizeof(KV), plus 4-byte scales for int8); the
// arithmetic is ~G*D FMAs per key, far below the card's compute rate.  The
// first version (one block per (kv head, row): 16 blocks at the text shape,
// a dependent online-softmax update per key, plain loads) was held back by
// latency, not bytes.  The design is the dense decode kernel's
// (decode_attention.cu), applied to the page table:
//  * grid (n_splits, Hkv, B), n_splits planned by the wrapper from the
//    table's width P*ps and B*Hkv (kernels/decode_attention.py:
//    plan_splits, four blocks per SM).  The wrapper never reads positions:
//    each block reads pos[b], counts its row's live cells n (pos + 1, or
//    P*ps once wrapped) and takes its balanced share of the row's
//    ceil(n / 32) tiles, [i*nt/n_splits, (i+1)*nt/n_splits), so each live
//    cell falls in exactly one split and a split past a short row reads
//    nothing and writes m = -1e30, l = 0.  The splits' partials are merged
//    by flash_decoding.cuh's combine (tagged PagedCaller); with one split
//    the kernel writes the output itself;
//  * the split's page ids are staged in shared memory once; 32-key tiles
//    are gathered through them with cp.async (16-byte copies) into a
//    double buffer of padded rows: key s comes from page pt[s / ps], row
//    s % ps.  Cells past the split's end are zero-filled without a read,
//    so table entries past a row's allocation (reserved page 0, foreign
//    values) are never read.  Int8 pages keep 1 byte an element in shared
//    memory, their per-key scales staged beside the tile;
//  * bf16 q, bf16 or int8 pages: both products on the tensor cores
//    (paged_attention_mma_kernel: mma.sync m16n8k16, the G <= 16 rows in
//    one m16 tile, P in registers split into hi + lo bf16 parts) through
//    flash_decoding::mma_tile_update, the dense decode kernel's own tile
//    body.  Int8 rows are widened to bf16 as the fragments are formed
//    (exact); the score is sk * (q . k_int8) / sqrt(D) and sv is folded
//    into P before the hi/lo split;
//  * float32 q, float32 or int8 pages: the CUDA cores
//    (paged_attention_kernel, flash_decoding::f32_tile_update: a whole
//    tile scored before its one max), as tensor cores would not hold
//    float32 to its 1e-4 parity.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_decoding.cuh"

namespace {

using flash_decoding::kThreads;
using flash_decoding::kTK;
using flash_decoding::TileRow;

// A block's view of its row and kv head in the arena: K/V (and the int8
// scales) at kv head kvh of page 0, strides in elements, and the split's
// page ids staged in shared memory (pt[0] is the row's page p_lo).
template <typename KV>
struct PagedRows {
  const KV* k;
  const KV* v;
  const float* ks;
  const float* vs;
  const int32_t* pt;
  int p_lo, ps;
  long long k_sn, k_ss, v_sn, v_ss, ks_sn, ks_ss, vs_sn, vs_ss;
};

// Cells [c_begin, c_end) of split `split` of a row whose query is at `pos`
// in a table of `total` cells: whole 32-key tiles of the row's live cells,
// balanced over the splits (the wrapper's Python mirror:
// kernels/paged_attention.py: split_cells).
__device__ __forceinline__ void split_cells(int pos, int total, int split,
                                            int n_splits, int& c_begin,
                                            int& c_end) {
  const int n = pos >= total ? total : max(pos + 1, 0);
  const int nt = (n + kTK - 1) / kTK;
  c_begin = min(n, (int)((long long)split * nt / n_splits) * kTK);
  c_end = min(n, (int)((long long)(split + 1) * nt / n_splits) * kTK);
}

// The split's page ids into shared memory; returns the first page's index.
__device__ __forceinline__ int stage_pages(int32_t* pt_s,
                                           const int32_t* page_table,
                                           long long pt_sb, int b,
                                           int c_begin, int c_end, int ps) {
  const int p_lo = c_begin / ps;
  const int count = c_end > c_begin ? (c_end - 1) / ps - p_lo + 1 : 0;
  for (int i = threadIdx.x; i < count; i += kThreads)
    pt_s[i] = page_table[b * pt_sb + p_lo + i];
  return p_lo;
}

// Keys s0 .. s0 + kTK - 1 of the split (ending at s_end) into one tile
// buffer: K/V rows through the page table, zero-filled without a read past
// s_end, their liveness and (kScaled) their scales beside them; one
// cp.async group.
template <typename KV, int D, bool kScaled>
__device__ __forceinline__ void load_paged_tile(const PagedRows<KV>& r,
                                                KV* kt, KV* vt, float* kst,
                                                float* vst, uint8_t* live_t,
                                                int s0, int s_end) {
  constexpr int EPC = TileRow<KV>::kEpc;
  constexpr int CPR = D / EPC;
  constexpr int PITCH = TileRow<KV>::template pitch<D>();
  for (int idx = threadIdx.x; idx < kTK * CPR; idx += kThreads) {
    const int row = idx / CPR, c = idx % CPR;
    const int s = s0 + row;
    const bool ok = s < s_end;
    const long long page = ok ? r.pt[s / r.ps - r.p_lo] : 0;
    const long long off = ok ? s % r.ps : 0;
    ptx::cp_async16(kt + row * PITCH + c * EPC,
                               r.k + page * r.k_sn + off * r.k_ss + c * EPC,
                               ok);
    ptx::cp_async16(vt + row * PITCH + c * EPC,
                               r.v + page * r.v_sn + off * r.v_ss + c * EPC,
                               ok);
    if (c == 0) {
      live_t[row] = ok;
      if (kScaled) {
        ptx::cp_async4(kst + row,
                                  r.ks + page * r.ks_sn + off * r.ks_ss, ok);
        ptx::cp_async4(vst + row,
                                  r.vs + page * r.vs_sn + off * r.vs_ss, ok);
      }
    }
  }
  ptx::cp_async_commit();
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *pt, *pos;
  void* out;
  float* part;
  int B, H, Hkv, P, ps, n_splits;
  long long k_sn, k_ss, k_sh, v_sn, v_ss, v_sh;
  long long ks_sn, ks_ss, ks_sh, vs_sn, vs_ss, vs_sh, pt_sb;
};

template <typename KV>
__device__ __forceinline__ PagedRows<KV> rows_of(const Args& a,
                                                 const int32_t* pt_s,
                                                 int p_lo, int kvh) {
  constexpr bool kInt8 = sizeof(KV) == 1;
  return PagedRows<KV>{
      static_cast<const KV*>(a.k) + kvh * a.k_sh,
      static_cast<const KV*>(a.v) + kvh * a.v_sh,
      kInt8 ? static_cast<const float*>(a.ks) + kvh * a.ks_sh : nullptr,
      kInt8 ? static_cast<const float*>(a.vs) + kvh * a.vs_sh : nullptr,
      pt_s, p_lo, a.ps, a.k_sn, a.k_ss, a.v_sn, a.v_ss, a.ks_sn, a.ks_ss,
      a.vs_sn, a.vs_ss};
}

// ---- bf16 q, bf16 or int8 pages: tensor cores ----
template <typename KV, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_mma_kernel(const Args a, float scale_log2) {
  constexpr bool kInt8 = sizeof(KV) == 1;
  using Tile = typename std::conditional<kInt8, flash_decoding::Int8Tile<D>,
                                         flash_decoding::Bf16Tile<D>>::type;
  constexpr int PITCH = Tile::PITCH;

  extern __shared__ __align__(16) unsigned char smem[];
  KV* kt = reinterpret_cast<KV*>(smem);                 // [2][kTK][PITCH]
  KV* vt = kt + 2 * kTK * PITCH;                        // [2][kTK][PITCH]
  float* kst = reinterpret_cast<float*>(vt + 2 * kTK * PITCH);  // [2][kTK]
  float* vst = kst + 2 * kTK;                           // [2][kTK]
  uint8_t* live_s = reinterpret_cast<uint8_t*>(vst + 2 * kTK);  // [2][kTK]
  int32_t* pt_s = reinterpret_cast<int32_t*>(live_s + 2 * kTK); // [P]

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv, lane = threadIdx.x % 32;
  int c_begin, c_end;
  split_cells(static_cast<const int32_t*>(a.pos)[b], a.P * a.ps, split,
              a.n_splits, c_begin, c_end);
  const int p_lo = stage_pages(pt_s, static_cast<const int32_t*>(a.pt),
                               a.pt_sb, b, c_begin, c_end, a.ps);
  const PagedRows<KV> rows = rows_of<KV>(a, pt_s, p_lo, kvh);
  const int ntile = (c_end - c_begin + kTK - 1) / kTK;

  uint32_t qa[D / 16][4];
  flash_decoding::load_q_frags<D>(
      qa, static_cast<const __nv_bfloat16*>(a.q) +
              ((long long)b * a.H + (long long)kvh * G) * D,
      G, lane);
  __syncthreads();   // the page ids

  auto load_tile = [&](int buf, int s0) {
    load_paged_tile<KV, D, kInt8>(rows, kt + buf * kTK * PITCH,
                                  vt + buf * kTK * PITCH, kst + buf * kTK,
                                  vst + buf * kTK, live_s + buf * kTK, s0,
                                  c_end);
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[D / 32][4];
#pragma unroll
  for (int nb = 0; nb < D / 32; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nb][i] = 0.f;

  if (ntile > 0) load_tile(0, c_begin);
  for (int t = 0; t < ntile; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntile) load_tile(buf ^ 1, c_begin + (t + 1) * kTK);
    if (t + 1 < ntile)
      ptx::cp_async_wait<1>();
    else
      ptx::cp_async_wait<0>();
    __syncthreads();   // tile t visible (every tile of a split has a live key)
    const Tile tile{kt + buf * kTK * PITCH, vt + buf * kTK * PITCH};
    flash_decoding::mma_tile_update<D, kInt8>(
        qa, tile, live_s + buf * kTK, kst + buf * kTK, vst + buf * kTK,
        scale_log2, m, l, o);
    __syncthreads();   // the buffer is refilled two tiles on
  }
  flash_decoding::mma_store<D>(m, l, o, static_cast<__nv_bfloat16*>(a.out),
                               a.part, b, kvh, split, a.Hkv, a.n_splits, a.H,
                               G);
}

// ---- float32 q, float32 or int8 pages: CUDA cores ----
template <typename KV, int D, int MAXG>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Args a, float scale) {
  constexpr bool kInt8 = sizeof(KV) == 1;
  using Shape = flash_decoding::F32Shape<D, MAXG>;
  constexpr int PITCH = TileRow<KV>::template pitch<D>();

  extern __shared__ __align__(16) unsigned char smem[];
  KV* kt = reinterpret_cast<KV*>(smem);                 // [2][kTK][PITCH]
  KV* vt = kt + 2 * kTK * PITCH;                        // [2][kTK][PITCH]
  float* qs = reinterpret_cast<float*>(vt + 2 * kTK * PITCH);   // [G][D]
  float* ps = qs + MAXG * D;                            // [G][kTK]
  float* row_a = ps + MAXG * kTK;                       // [G]
  float* row_l = row_a + MAXG;                          // [G]
  float* kst = row_l + MAXG;                            // [2][kTK]
  float* vst = kst + 2 * kTK;                           // [2][kTK]
  uint8_t* live_s = reinterpret_cast<uint8_t*>(vst + 2 * kTK);  // [2][kTK]
  int32_t* pt_s = reinterpret_cast<int32_t*>(live_s + 2 * kTK); // [P]

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv, tid = threadIdx.x;
  int c_begin, c_end;
  split_cells(static_cast<const int32_t*>(a.pos)[b], a.P * a.ps, split,
              a.n_splits, c_begin, c_end);
  const int p_lo = stage_pages(pt_s, static_cast<const int32_t*>(a.pt),
                               a.pt_sb, b, c_begin, c_end, a.ps);
  const PagedRows<KV> rows = rows_of<KV>(a, pt_s, p_lo, kvh);
  const int ntile = (c_end - c_begin + kTK - 1) / kTK;

  // the kv head's G query rows
  const float* qb = static_cast<const float*>(a.q) +
                    ((long long)b * a.H + (long long)kvh * G) * D;
  for (int idx = tid * 4; idx < G * D; idx += kThreads * 4)
    *reinterpret_cast<float4*>(qs + idx) =
        *reinterpret_cast<const float4*>(qb + idx);
  __syncthreads();   // the page ids

  auto load_tile = [&](int buf, int s0) {
    load_paged_tile<KV, D, kInt8>(rows, kt + buf * kTK * PITCH,
                                  vt + buf * kTK * PITCH, kst + buf * kTK,
                                  vst + buf * kTK, live_s + buf * kTK, s0,
                                  c_end);
  };

  float m_r[Shape::SG], l_r[Shape::SG], acc[Shape::GPT][2];
#pragma unroll
  for (int j = 0; j < Shape::SG; ++j) { m_r[j] = -INFINITY; l_r[j] = 0.f; }
#pragma unroll
  for (int j = 0; j < Shape::GPT; ++j) acc[j][0] = acc[j][1] = 0.f;

  if (ntile > 0) load_tile(0, c_begin);
  for (int t = 0; t < ntile; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntile) load_tile(buf ^ 1, c_begin + (t + 1) * kTK);
    if (t + 1 < ntile)
      ptx::cp_async_wait<1>();
    else
      ptx::cp_async_wait<0>();
    __syncthreads();   // tile t (and, the first time, q) visible
    flash_decoding::f32_tile_update<D, MAXG, KV, kInt8>(
        kt + buf * kTK * PITCH, vt + buf * kTK * PITCH, live_s + buf * kTK,
        kst + buf * kTK, vst + buf * kTK, qs, ps, row_a, G, scale, m_r, l_r,
        acc);
  }
  flash_decoding::f32_store<D, MAXG, float>(
      m_r, l_r, acc, row_a, row_l, static_cast<float*>(a.out), a.part, b, kvh,
      split, a.Hkv, a.n_splits, a.H, G);
}

// shared memory of both kernels: the double-buffered tiles, the f32
// kernel's q rows and softmax scratch (MAXG rows), the scales, the
// liveness and the page ids
template <typename KV, int D>
size_t smem_bytes(int maxg, int P) {
  return 4 * (size_t)kTK * TileRow<KV>::template pitch<D>() * sizeof(KV) +
         sizeof(float) * ((size_t)maxg * D + maxg * kTK + 2 * maxg) +
         sizeof(float) * 4 * kTK + 2 * kTK + sizeof(int32_t) * (size_t)P;
}

template <typename Kern>
cudaError_t launch_kernel(Kern kern, size_t smem, const Args& a, float scale,
                          cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<dim3(a.n_splits, a.Hkv, a.B), kThreads, smem, stream>>>(a, scale);
  return cudaGetLastError();
}

template <typename KV, int D>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  if (a.H / a.Hkv > 16) return cudaErrorInvalidValue;
  cudaError_t err = launch_kernel(paged_attention_mma_kernel<KV, D>,
                                  smem_bytes<KV, D>(0, a.P), a,
                                  1.4426950408889634f / sqrtf((float)D),
                                  stream);
  if (err != cudaSuccess || a.n_splits == 1) return err;
  return flash_decoding::launch_combine<flash_decoding::PagedCaller>(
      a.part, static_cast<__nv_bfloat16*>(a.out), a.B, a.H, a.Hkv,
      a.n_splits, D, stream);
}

template <typename KV, int D, int MAXG>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  cudaError_t err = launch_kernel(paged_attention_kernel<KV, D, MAXG>,
                                  smem_bytes<KV, D>(MAXG, a.P), a,
                                  1.0f / sqrtf((float)D), stream);
  if (err != cudaSuccess || a.n_splits == 1) return err;
  return flash_decoding::launch_combine<flash_decoding::PagedCaller>(
      a.part, static_cast<float*>(a.out), a.B, a.H, a.Hkv, a.n_splits, D,
      stream);
}

template <typename KV, int D>
cudaError_t by_group(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.Hkv;
  if (G <= 4) return launch_f32<KV, D, 4>(a, stream);
  if (G <= 8) return launch_f32<KV, D, 8>(a, stream);
  if (G <= 16) return launch_f32<KV, D, 16>(a, stream);
  return cudaErrorInvalidValue;
}

// float32 q (kBf16Q false) with float32 or int8 pages; bf16 q with bf16 or
// int8 pages
template <bool kBf16Q, typename KV>
cudaError_t by_dim(int D, const Args& a, cudaStream_t stream) {
  if constexpr (kBf16Q) {
    if (D == 32) return launch_mma<KV, 32>(a, stream);
    if (D == 64) return launch_mma<KV, 64>(a, stream);
    if (D == 128) return launch_mma<KV, 128>(a, stream);
  } else {
    if (D == 32) return by_group<KV, 32>(a, stream);
    if (D == 64) return by_group<KV, 64>(a, stream);
    if (D == 128) return by_group<KV, 128>(a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype (of q and out): 0 = float32, 1 = bfloat16.  kv_int8: 0 = pages in
// q's dtype (ks/vs unused), 1 = int8 pages with float32 scales ks/vs.
// Strides are in elements; the head_dim axis of q, k, v and out is
// contiguous, q and out are [B, H, D], page_table [B, P] and positions [B]
// are int32.  part is a float32 scratch buffer of B*Hkv*n_splits*G*(D+2)
// elements (unused, may be null, when n_splits == 1).
int paged_attention_launch(const void* q, const void* k, const void* v,
                           const void* ks, const void* vs,
                           const void* page_table, const void* positions,
                           void* out, void* part, int B, int H, int Hkv,
                           int P, int ps, int D, int dtype, int kv_int8,
                           int n_splits, long long k_sn, long long k_ss,
                           long long k_sh, long long v_sn, long long v_ss,
                           long long v_sh, long long ks_sn, long long ks_ss,
                           long long ks_sh, long long vs_sn, long long vs_ss,
                           long long vs_sh, long long pt_sb, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_splits < 1 || (n_splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, ks, vs, page_table, positions, out,
               static_cast<float*>(part), B, H, Hkv, P, ps, n_splits, k_sn,
               k_ss, k_sh, v_sn, v_ss, v_sh, ks_sn, ks_ss, ks_sh, vs_sn,
               vs_ss, vs_sh, pt_sb};
  if (dtype == 0 && !kv_int8) return (int)by_dim<false, float>(D, a, st);
  if (dtype == 0 && kv_int8) return (int)by_dim<false, int8_t>(D, a, st);
  if (dtype == 1 && !kv_int8)
    return (int)by_dim<true, __nv_bfloat16>(D, a, st);
  if (dtype == 1 && kv_int8) return (int)by_dim<true, int8_t>(D, a, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
