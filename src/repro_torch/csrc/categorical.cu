// The sampler's draw for Hopper: JAX's threefry Gumbel noise and the argmax
// of noise + logits, per row, in one pass over the logits.
//
// A kernel of the port's own.  No TPU kernel stands behind it: the
// reference draws with jax.vmap(jax.random.categorical) inside its jitted
// sampler (src/repro/core/sampling.py:168), which XLA fuses.  The plain
// version (kernels/categorical.py: categorical_plain, on the threefry
// functions of core/sampling.py, which the CPU tests hold to jax.random bit
// for bit) runs some 140 int64 elementwise passes over [B, V] words.
//
// Per row b of logits [B, V] (float32, masked entries -inf):
//   step key  k = fold_in(base_b, pos_b), or fold_in(fold_in(base_b, salt),
//             pos_b) when salted; fold_in(key, d) = threefry(key, (0, d))
//             with d's low 32 bits, key words the low 32 bits of the int64s;
//   bits_i    = y0 ^ y1 of threefry(k, (0, i))  (JAX's partitionable
//             counters for element i of a [V] draw);
//   u_i       = max(((bits_i >> 9) | 0x3F800000) as f32 - 1) * 1 + tiny,
//             tiny), each operation rounded on its own as torch does it;
//   g_i       = -logf(-logf(u_i))  (libdevice logf, as torch's CUDA log);
//   draw_b    = argmax_i (g_i + logits[b, i]), lowest index on ties (an all
//             -inf row gives 0, as torch.argmax and jnp.argmax do).
//
// Design.  A grid of (chunks of V) x B blocks of 256 threads.  Every thread
// derives its row's step key in registers (two or three threefry calls:
// cheaper than a launch), then for each of its elements runs the 20 rounds
// on uint32 (rotations with __funnelshift_l), the uniform, the two logs and
// the add, and keeps a running maximum of one 64-bit key per element: the
// value's bits in an order-preserving map (NaN above +inf, -0 as +0) over
// 0xFFFFFFFF - i.  The largest key is the largest value, then the lowest
// index: a total order, so the warp's xor-shuffle maximum, the block's and
// the per-row combine (a second, one-warp-a-row launch over the blocks'
// keys) give the same answer whatever the chunk size or the rows in the
// call.  The [B, V] noise never reaches memory.  The scale and shift are
// __fmul_rn / __fadd_rn so nvcc contracts nothing into an FMA; the build
// uses no fast math (__logf is not logf).
//
// What bounds it: operations.  Per element about 88 integer operations (20
// rounds x add / rotate / xor, 5 key injections x 2 adds, the counter's add,
// the bits' xor, the uniform's shift and or, the loop and the 64-bit
// maximum) and about 40 float operations (two logf, the uniform's subtract,
// multiply, add and max, the add of the logit); 4 bytes read.  At [8,
// 151936] that is 107 M integer operations, about 0.0064 ms at 132 SMs x 64
// a clock; the bytes take 0.0015 ms.
//
// gumbel_noise mode writes g to a [B, V] buffer instead (the check of the
// noise against the plain version, bit for bit).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTiny = 1.17549435e-38f;    // float32's smallest normal

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds, of the counter words (x0, x1) under the key
// words (k0, k1), in place.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
#define ROUND(r) \
  x0 += x1;      \
  x1 = rotl(x1, r) ^ x0;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  ROUND(17) ROUND(29) ROUND(16) ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  ROUND(17) ROUND(29) ROUND(16) ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef ROUND
}

// fold_in(key, data): the key becomes threefry(key, (0, data)).
__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1,
                                        uint32_t data) {
  uint32_t x0 = 0u, x1 = data;
  threefry(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

struct Row {
  long long keys_rs, keys_cs, pos_s;
  const long long* keys;
  const long long* positions;
  int salted;
  uint32_t salt;

  __device__ __forceinline__ void step_key(int b, uint32_t& k0,
                                           uint32_t& k1) const {
    k0 = (uint32_t)keys[b * keys_rs];
    k1 = (uint32_t)keys[b * keys_rs + keys_cs];
    if (salted) fold_in(k0, k1, salt);
    fold_in(k0, k1, (uint32_t)positions[b * pos_s]);
  }
};

// JAX's Gumbel noise for element i under the step key (k0, k1).
__device__ __forceinline__ float gumbel(uint32_t k0, uint32_t k1,
                                        uint32_t i) {
  uint32_t x0 = 0u, x1 = i;
  threefry(k0, k1, x0, x1);
  const uint32_t bits = x0 ^ x1;
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(__fadd_rn(__fmul_rn(f, 1.0f), kTiny), kTiny);
  return -logf(-logf(u));
}

// (value, index) as one key whose unsigned order is (value ascending, index
// descending), NaN above +inf and -0 equal to +0, as torch.argmax ranks.
__device__ __forceinline__ unsigned long long order_key(float v,
                                                        uint32_t i) {
  uint32_t b = __float_as_uint(v);
  b = v != v ? 0xFFFFFFFFu
             : v == 0.f ? 0x80000000u
                        : (b & 0x80000000u) ? ~b : b | 0x80000000u;
  return ((unsigned long long)b << 32) | (0xFFFFFFFFu - i);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// Block (chunk c, row b): the largest key of g + logits over the chunk, to
// partial[b * gridDim.x + c].
__global__ void __launch_bounds__(kThreads)
    draw_kernel(const float* __restrict__ logits, long long logits_rs,
                Row row, int V, int chunk,
                unsigned long long* __restrict__ partial) {
  __shared__ unsigned long long warp_best[kThreads / 32];
  const int b = blockIdx.y;
  uint32_t k0, k1;
  row.step_key(b, k0, k1);
  const float* lr = logits + (long long)b * logits_rs;
  const int lo = blockIdx.x * chunk;
  const int hi = min(lo + chunk, V);
  unsigned long long best = 0ull;         // below every real key
#pragma unroll 4
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    const float v = __fadd_rn(gumbel(k0, k1, (uint32_t)i), lr[i]);
    const unsigned long long key = order_key(v, (uint32_t)i);
    best = key > best ? key : best;
  }
  best = warp_max(best);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  if (warp == 0) {
    best = warp_max(lane < kThreads / 32 ? warp_best[lane] : 0ull);
    if (lane == 0) partial[(long long)b * gridDim.x + blockIdx.x] = best;
  }
}

// One warp a row: the largest of the row's chunk keys, as an index.
__global__ void combine_kernel(const unsigned long long* __restrict__ partial,
                               int chunks, long long* __restrict__ out) {
  const int b = blockIdx.x;
  unsigned long long best = 0ull;
  for (int c = threadIdx.x; c < chunks; c += 32) {
    const unsigned long long k = partial[(long long)b * chunks + c];
    best = k > best ? k : best;
  }
  best = warp_max(best);
  if (threadIdx.x == 0)
    out[b] = (long long)(0xFFFFFFFFu - (uint32_t)(best & 0xFFFFFFFFull));
}

__global__ void __launch_bounds__(kThreads)
    noise_kernel(Row row, int V, int chunk, float* __restrict__ noise) {
  const int b = blockIdx.y;
  uint32_t k0, k1;
  row.step_key(b, k0, k1);
  const int lo = blockIdx.x * chunk;
  const int hi = min(lo + chunk, V);
  for (int i = lo + threadIdx.x; i < hi; i += kThreads)
    noise[(long long)b * V + i] = gumbel(k0, k1, (uint32_t)i);
}

}  // namespace

extern "C" {

// logits: float32 [B, V], last axis contiguous, row stride logits_rs;
// keys: int64 [B, 2] with strides (keys_rs, keys_cs); positions: int64 [B]
// with stride pos_s; salt: its low 32 bits are folded in first when salted.
// Draw mode (noise NULL): out int64 [B] gets the draws, partial int64 [B *
// ceil(V / chunk)] is scratch.  Noise mode (logits, out, partial NULL):
// noise float32 [B, V] contiguous gets g.  chunk: a positive multiple of
// 256 elements a block; the draws do not depend on it.
int categorical_launch(const void* logits, const void* keys,
                       const void* positions, void* out, void* partial,
                       void* noise, int B, int V, int chunk, int salted,
                       long long salt, long long logits_rs, long long keys_rs,
                       long long keys_cs, long long pos_s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 0 || V < 1 || chunk < kThreads || chunk % kThreads)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int chunks = (V + chunk - 1) / chunk;
  if (B > 65535) return (int)cudaErrorInvalidValue;    // gridDim.y
  const Row row{keys_rs, keys_cs, pos_s,
                static_cast<const long long*>(keys),
                static_cast<const long long*>(positions), salted,
                (uint32_t)(salt & 0xFFFFFFFFll)};
  const dim3 grid(chunks, B);
  if (noise != nullptr) {
    noise_kernel<<<grid, kThreads, 0, st>>>(row, V, chunk,
                                            static_cast<float*>(noise));
    return (int)cudaGetLastError();
  }
  auto* part = static_cast<unsigned long long*>(partial);
  draw_kernel<<<grid, kThreads, 0, st>>>(static_cast<const float*>(logits),
                                         logits_rs, row, V, chunk, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<<<B, 32, 0, st>>>(part, chunks,
                                   static_cast<long long*>(out));
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
