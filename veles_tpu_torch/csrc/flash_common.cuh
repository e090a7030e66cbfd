// Shared pieces of K6 (flash attention forward) and K7 (its backward):
// the masking constants of the JAX kernels, the tiling, the head widths
// the kernels are compiled for, and the row and dot-product helpers.
//
// Layout: every tensor is heads-first and contiguous, (B*H, S, D) f32 for
// Q, K, V, O, dO, dQ, dK, dV and (B*H, S) for the row logsumexp and
// D = rowsum(dO*O). A row of D floats is 16-byte aligned whenever D is a
// multiple of 4 (every D the kernels take), so rows move as float4.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace flash {

// the JAX kernels mask with -1e30 (ops/attention.py NEG_INF) and treat a
// score at or below -1e29 as masked (the all-masked-row guard)
constexpr float kNegInf = -1e30f;
constexpr float kMaskedAtOrBelow = -1e29f;

// rows of the "resident" side per block: one row per thread
constexpr int kThreads = 128;
// floats of one streamed array held in shared memory per chunk (16 KB):
// kChunkFloats / D rows of K and of V (forward, dQ) or of Q and of dO
// (dK/dV), 32 KB of static shared memory per block in all
constexpr int kChunkFloats = 4096;

// Copy `rows` rows of D floats starting at `src` into `dst` (a chunk of
// kChunkFloats), zero-filling the rest of the chunk: a partly filled
// tile then reads zeros, never stale values (p = 0 times a stale NaN
// would be NaN).
template <int D>
__device__ __forceinline__ void load_chunk(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int rows) {
  const int n4 = rows * (D / 4);
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < kChunkFloats / 4; i += blockDim.x) {
    d4[i] = i < n4 ? __ldg(s4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// one row of D floats from device memory into registers (zeros if !live)
template <int D>
__device__ __forceinline__ void load_row(float (&r)[D],
                                         const float* __restrict__ src,
                                         bool live) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
    const float4 x = live ? __ldg(s4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    r[4 * c] = x.x;
    r[4 * c + 1] = x.y;
    r[4 * c + 2] = x.z;
    r[4 * c + 3] = x.w;
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* __restrict__ dst,
                                          const float (&r)[D]) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
    d4[c] = make_float4(r[4 * c], r[4 * c + 1], r[4 * c + 2], r[4 * c + 3]);
  }
}

// a . b over D, a in registers, b a row in shared memory (every thread
// of a warp reads the same row: a broadcast), summed in order of d
template <int D>
__device__ __forceinline__ float dot_row(const float (&a)[D],
                                         const float* __restrict__ b) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
    const float4 x = b4[c];
    acc = fmaf(a[4 * c], x.x, acc);
    acc = fmaf(a[4 * c + 1], x.y, acc);
    acc = fmaf(a[4 * c + 2], x.z, acc);
    acc = fmaf(a[4 * c + 3], x.w, acc);
  }
  return acc;
}

// acc += w * b, b a row in shared memory
template <int D>
__device__ __forceinline__ void axpy_row(float (&acc)[D], float w,
                                         const float* __restrict__ b) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
    const float4 x = b4[c];
    acc[4 * c] = fmaf(w, x.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(w, x.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(w, x.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(w, x.w, acc[4 * c + 3]);
  }
}

inline int blocks_for(int64_t s_len) {
  return static_cast<int>((s_len + kThreads - 1) / kThreads);
}

}  // namespace flash
