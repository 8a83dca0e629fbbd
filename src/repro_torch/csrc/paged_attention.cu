// One-token GQA decode attention through a page table, for Hopper.
//
// Replaces the reference package's Pallas TPU kernel
// src/repro/kernels/paged_attention.py: paged_attention_pallas (body
// _paged_kernel).  Same contract as paged_attention_ref: K/V live in one
// page arena [N, ps, Hkv, D] shared by every sequence, row b reaches its
// logical cell i at page page_table[b, i / ps], offset i % ps; cell i is live
// iff i <= pos[b], or every cell once pos[b] >= P*ps (a wrapped ring).  Scale
// 1/sqrt(D), f32 accumulation, softmax denominator clamped at 1e-30, output
// in q's dtype.  Int8 pages carry f32 scales [N, ps, Hkv] and are dequantised
// in registers right after the load.
//
// What bounds it: the live K and V bytes, once per decode step per layer
// (2 * live cells * Hkv * D * sizeof(KV), plus 4-byte scales for int8); the
// arithmetic is ~G*D FMAs per key, far below the card's compute rate.  The
// design therefore streams the live pages only:
//  * one block per (kv head, batch row); its G = H/Hkv query rows stay in
//    registers, so K/V are read once for the whole query group;
//  * the row's live page ids (pos / ps + 1 of them, or all P once wrapped)
//    are staged in shared memory once per block; the per-key address is then
//    smem_pt[i / ps] * page_stride + (i % ps) * row_stride;
//  * dead cells past pos are never loaded nor counted, so table entries past
//    a slot's allocation (which point at reserved page 0, holding foreign
//    values) are never read;
//  * each key row is read by LPK lanes with vector loads of EPL elements
//    (16 bytes for f32 and bf16; 8 bytes of int8 -- EPL stays 8 so the G
//    query rows and accumulators per lane fit in registers), each lane
//    group keeps its own online-softmax state (m, l, acc);
//  * lane groups merge by shuffles, warps through shared memory, once.
// Not yet done (later work): splitting the pages across blocks
// (flash-decoding) to fill all SMs when B*Hkv is small, and cp.async / TMA
// pipelining of the page loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kUnroll = 4;   // keys per lane group per loop trip

// N consecutive elements to float, with 16-byte (8-byte for int8) loads
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    out[i] = v.x; out[i + 1] = v.y; out[i + 2] = v.z; out[i + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
#pragma unroll
  for (int i = 0; i < N; i += 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      out[i + 2 * j] = f.x;
      out[i + 2 * j + 1] = f.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const int8_t* p, float* out) {
  static_assert(N == 8, "int8 rows are read 8 bytes per lane");
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(c[i]);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename KV> struct Lanes { static constexpr int EPL = 16 / sizeof(KV); };
template <> struct Lanes<int8_t> { static constexpr int EPL = 8; };

// T: q/out type; KV: page storage type (T, or int8 with scales)
template <typename T, typename KV, int D, int MAXG>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                       const KV* __restrict__ v,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int32_t* __restrict__ page_table,
                       const int32_t* __restrict__ positions,
                       T* __restrict__ out, int H, int P, int ps, int G,
                       long long k_sn, long long k_ss, long long k_sh,
                       long long v_sn, long long v_ss, long long v_sh,
                       long long ks_sn, long long ks_ss, long long ks_sh,
                       long long vs_sn, long long vs_ss, long long vs_sh,
                       long long pt_sb, float scale) {
  constexpr bool kInt8 = sizeof(KV) == 1;
  constexpr int EPL = Lanes<KV>::EPL;  // elements per lane
  constexpr int LPK = D / EPL;         // lanes per key row
  constexpr int KPW = 32 / LPK;        // key rows a warp reads at once
  static_assert(LPK >= 1 && LPK <= 32 && 32 % LPK == 0, "bad D");

  extern __shared__ float smem[];      // [kWarps][G][D + 2], then page ids
  int32_t* pt = reinterpret_cast<int32_t*>(smem + kWarps * G * (D + 2));

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / LPK;
  const int sub = lane % LPK;
  const unsigned gmask =
      LPK == 32 ? 0xffffffffu : (((1u << LPK) - 1u) << (grp * LPK));

  // live cells of this row and the pages that hold them
  const int pos = positions[b];
  const int total = P * ps;
  const int n_cells = pos >= total ? total : pos + 1;
  const int n_pages = (n_cells + ps - 1) / ps;
  for (int i = threadIdx.x; i < n_pages; i += blockDim.x)
    pt[i] = page_table[b * pt_sb + i];
  __syncthreads();

  float qr[MAXG][EPL];
  float m[MAXG], l[MAXG], acc[MAXG][EPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) { acc[g][e] = 0.f; qr[g][e] = 0.f; }
    if (g < G)
      load_vec<EPL>(q + ((long long)b * H + kvh * G + g) * D + sub * EPL, qr[g]);
  }

  const KV* kb = k + kvh * k_sh + sub * EPL;
  const KV* vb = v + kvh * v_sh + sub * EPL;
  const int stride = kWarps * KPW * kUnroll;

  for (int s0 = (warp * KPW + grp) * kUnroll; s0 < n_cells; s0 += stride) {
    float kr[kUnroll][EPL], vr[kUnroll][EPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      if (s < n_cells) {
        const long long page = pt[s / ps];
        const int off = s % ps;
        load_vec<EPL>(kb + page * k_sn + off * k_ss, kr[u]);
        load_vec<EPL>(vb + page * v_sn + off * v_ss, vr[u]);
        if constexpr (kInt8) {
          const float sk = ks[page * ks_sn + off * ks_ss + kvh * ks_sh];
          const float sv = vs[page * vs_sn + off * vs_ss + kvh * vs_sh];
#pragma unroll
          for (int e = 0; e < EPL; ++e) { kr[u][e] *= sk; vr[u][e] *= sv; }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s0 + u >= n_cells) continue;   // uniform across the lane group
      float dot[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        float acc_d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc_d += qr[g][e] * kr[u][e];
        dot[g] = acc_d;
      }
#pragma unroll
      for (int off = LPK / 2; off > 0; off /= 2) {
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          dot[g] += __shfl_xor_sync(gmask, dot[g], off);
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) continue;
        const float s = dot[g] * scale;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = acc[g][e] * alpha + p * vr[u][e];
        m[g] = m_new;
      }
    }
  }

  // merge the KPW lane groups of this warp
#pragma unroll
  for (int off = LPK; off < 32; off *= 2) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float m_new = fmaxf(m[g], m_o);
      const float a = expf(m[g] - m_new);
      const float c = expf(m_o - m_new);
      l[g] = l[g] * a + l_o * c;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + acc_o * c;
      }
      m[g] = m_new;
    }
  }

  // merge the warps through shared memory
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) continue;
      float* row = smem + (warp * G + g) * (D + 2);
#pragma unroll
      for (int e = 0; e < EPL; ++e) row[sub * EPL + e] = acc[g][e];
      if (sub == 0) { row[D] = m[g]; row[D + 1] = l[g]; }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, smem[(w * G + g) * (D + 2) + D]);
    float num = 0.f, den = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* row = smem + (w * G + g) * (D + 2);
      const float c = expf(row[D] - mx);
      num += row[d] * c;
      den += row[D + 1] * c;
    }
    store(out + ((long long)b * H + kvh * G + g) * D + d, num / fmaxf(den, 1e-30f));
  }
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *pt, *pos;
  void* out;
  int B, H, Hkv, P, ps;
  long long k_sn, k_ss, k_sh, v_sn, v_ss, v_sh;
  long long ks_sn, ks_ss, ks_sh, vs_sn, vs_ss, vs_sh, pt_sb;
};

template <typename T, typename KV, int D, int MAXG>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.Hkv;
  const size_t smem = (size_t)kWarps * G * (D + 2) * sizeof(float)
                      + (size_t)a.P * sizeof(int32_t);
  auto kern = paged_attention_kernel<T, KV, D, MAXG>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<dim3(a.Hkv, a.B), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int32_t*>(a.pt),
      static_cast<const int32_t*>(a.pos), static_cast<T*>(a.out), a.H, a.P,
      a.ps, G, a.k_sn, a.k_ss, a.k_sh, a.v_sn, a.v_ss, a.v_sh, a.ks_sn,
      a.ks_ss, a.ks_sh, a.vs_sn, a.vs_ss, a.vs_sh, a.pt_sb,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, typename KV, int D>
cudaError_t by_group(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.Hkv;
  if (G <= 4) return launch<T, KV, D, 4>(a, stream);
  if (G <= 8) return launch<T, KV, D, 8>(a, stream);
  if (G <= 16) return launch<T, KV, D, 16>(a, stream);
  return cudaErrorInvalidValue;
}

template <typename T, typename KV>
cudaError_t by_dim(int D, const Args& a, cudaStream_t stream) {
  if (D == 32) return by_group<T, KV, 32>(a, stream);
  if (D == 64) return by_group<T, KV, 64>(a, stream);
  if (D == 128) return by_group<T, KV, 128>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype (of q and out): 0 = float32, 1 = bfloat16.  kv_int8: 0 = pages in
// q's dtype (ks/vs unused), 1 = int8 pages with float32 scales ks/vs.
// Strides are in elements; the head_dim axis of q, k, v and out is
// contiguous, q and out are [B, H, D], page_table [B, P] and positions [B]
// are int32.
int paged_attention_launch(const void* q, const void* k, const void* v,
                           const void* ks, const void* vs,
                           const void* page_table, const void* positions,
                           void* out, int B, int H, int Hkv, int P, int ps,
                           int D, int dtype, int kv_int8, long long k_sn,
                           long long k_ss, long long k_sh, long long v_sn,
                           long long v_ss, long long v_sh, long long ks_sn,
                           long long ks_ss, long long ks_sh, long long vs_sn,
                           long long vs_ss, long long vs_sh, long long pt_sb,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, ks, vs, page_table, positions, out, B, H, Hkv, P, ps,
               k_sn, k_ss, k_sh, v_sn, v_ss, v_sh, ks_sn, ks_ss, ks_sh,
               vs_sn, vs_ss, vs_sh, pt_sb};
  if (dtype == 0 && !kv_int8) return (int)by_dim<float, float>(D, a, st);
  if (dtype == 0 && kv_int8) return (int)by_dim<float, int8_t>(D, a, st);
  if (dtype == 1 && !kv_int8)
    return (int)by_dim<__nv_bfloat16, __nv_bfloat16>(D, a, st);
  if (dtype == 1 && kv_int8) return (int)by_dim<__nv_bfloat16, int8_t>(D, a, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
