// One-token GQA decode attention over a dense (ring) KV cache, for Hopper.
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
// the card's compute rate.  So the design aims at streaming the cache:
//  * one block per (kv head, batch row); its G = H/Hkv query rows stay in
//    registers, so K/V are read once for the whole query group (GQA by
//    kv-head indexing, no repeated heads in memory);
//  * each key row is read by LPK lanes with 16-byte vector loads
//    (LPK = D*sizeof(T)/16), so a warp reads 32/LPK keys at once and each
//    lane group keeps its own online-softmax state (m, l, acc);
//  * keys whose kv_valid bit is off are neither loaded nor counted, so a
//    short sequence in a long ring costs its own length only;
//  * lane groups merge by shuffles, warps through shared memory, once.
// Not yet done (later work): splitting S across blocks (flash-decoding) to
// fill all SMs when B*Hkv is small, and TMA / cp.async pipelining.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kUnroll = 4;   // keys per lane group per loop trip

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

template <typename T, int D, int MAXG>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const uint8_t* __restrict__ valid, T* __restrict__ out,
                        int H, int S, int G, long long k_sb, long long k_ss,
                        long long k_sh, long long v_sb, long long v_ss,
                        long long v_sh, long long valid_sb, float scale) {
  constexpr int EPL = 16 / sizeof(T);  // elements per lane (16-byte loads)
  constexpr int LPK = D / EPL;         // lanes per key row
  constexpr int KPW = 32 / LPK;        // key rows a warp reads at once
  static_assert(LPK >= 1 && LPK <= 32 && 32 % LPK == 0, "bad D");

  extern __shared__ float smem[];      // [kWarps][G][D + 2]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / LPK;
  const int sub = lane % LPK;
  const unsigned gmask =
      LPK == 32 ? 0xffffffffu : (((1u << LPK) - 1u) << (grp * LPK));

  float qr[MAXG][EPL];
  float m[MAXG], l[MAXG], acc[MAXG][EPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) { acc[g][e] = 0.f; qr[g][e] = 0.f; }
    if (g < G) load16(q + ((long long)b * H + kvh * G + g) * D + sub * EPL, qr[g]);
  }

  const T* kb = k + b * k_sb + kvh * k_sh + sub * EPL;
  const T* vb = v + b * v_sb + kvh * v_sh + sub * EPL;
  const uint8_t* live = valid + b * valid_sb;
  const int stride = kWarps * KPW * kUnroll;

  for (int s0 = (warp * KPW + grp) * kUnroll; s0 < S; s0 += stride) {
    float kr[kUnroll][EPL], vr[kUnroll][EPL];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      ok[u] = s < S && live[s];
      if (ok[u]) {
        load16(kb + s * k_ss, kr[u]);
        load16(vb + s * v_ss, vr[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;            // uniform across the lane group
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

template <typename T, int D, int MAXG>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* valid, void* out, int B, int H, int Hkv, int S,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh,
                   long long valid_sb, cudaStream_t stream) {
  const int G = H / Hkv;
  const size_t smem = (size_t)kWarps * G * (D + 2) * sizeof(float);
  auto kern = decode_attention_kernel<T, D, MAXG>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<dim3(Hkv, B), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(valid),
      static_cast<T*>(out), H, S, G, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
      valid_sb, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_group(int G, const void* q, const void* k, const void* v,
                     const void* valid, void* out, int B, int H, int Hkv,
                     int S, long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long valid_sb, cudaStream_t stream) {
#define DECODE_ARGS q, k, v, valid, out, B, H, Hkv, S, k_sb, k_ss, k_sh, \
                    v_sb, v_ss, v_sh, valid_sb, stream
  if (G <= 4) return launch<T, D, 4>(DECODE_ARGS);
  if (G <= 8) return launch<T, D, 8>(DECODE_ARGS);
  if (G <= 16) return launch<T, D, 16>(DECODE_ARGS);
#undef DECODE_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// (head_dim) axis of q, k, v and out is contiguous, q and out are [B, H, D].
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* valid, void* out, int B, int H,
                            int Hkv, int S, int D, int dtype, long long k_sb,
                            long long k_ss, long long k_sh, long long v_sb,
                            long long v_ss, long long v_sh, long long valid_sb,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
#define DISPATCH(T, DD)                                                      \
  return (int)by_group<T, DD>(G, q, k, v, valid, out, B, H, Hkv, S, k_sb,    \
                              k_ss, k_sh, v_sb, v_ss, v_sh, valid_sb, st)
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
