// Split-S (flash-decoding) partials and their combine, shared by the
// one-token attention kernels.
//
// A decode kernel that splits the keys of one (batch row, kv head) across
// n_splits blocks writes each split's unnormalised state to a float32
// scratch buffer laid out [B, Hkv, n_splits, G, D + 2]:
//     [0, D)  acc = sum over the split's live keys of p * v
//     D       m   = the split's largest live score (-1e30 if it has none)
//     D + 1   l   = sum of p = exp(score - m)      (0 if it has none)
// and combine_splits_kernel merges the splits of each query row in index
// order: out = sum_i acc_i e^(m_i - M) / max(sum_i l_i e^(m_i - M), 1e-30)
// with M = max_i m_i, so a row with no live key in any split gives 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_decoding {

constexpr float kNoKey = -1e30f;   // m of a split with no live key

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

// Grid (G, Hkv, B), D threads: one output row of D elements a block.
template <typename T>
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

template <typename T>
cudaError_t launch_combine(const float* part, T* out, int B, int H, int Hkv,
                           int n_splits, int D, cudaStream_t stream) {
  combine_splits_kernel<T><<<dim3(H / Hkv, Hkv, B), D, 0, stream>>>(
      part, out, H, Hkv, n_splits, D);
  return cudaGetLastError();
}

}  // namespace flash_decoding
