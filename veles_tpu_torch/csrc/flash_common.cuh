// Shared pieces of K6 (flash attention forward) and K7 (its backward):
// the masking constants of the JAX kernels, the tiling, the head widths
// the kernels are compiled for, the row and dot-product helpers (K6), and
// the tensor-core pieces: 3xTF32 mma.sync and cp.async (K7).
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
// kChunkFloats / D rows of K and of V (K6), 32 KB of static shared memory
// per block in all
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

// ---------------------------------------------------------------------------
// Tensor-core pieces: 3xTF32 `mma.sync` m16n8k8 and `cp.async` staging
// (used by K7; K6 does not use them yet).
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, lane
// = 4*g + t (g = lane >> 2, t = lane & 3):
//   A (16 x 8, rows x k): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, k x cols):  b0 (t, g), b1 (t+4, g)
//   C (16 x 8):           c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t),
//                         c3 (g+8, 2t+1)
// 3xTF32 (CUTLASS's OpMultiplyAddFastF32): x = hi + lo, hi = tf32(x)
// rounded to nearest, ties away from zero (cvt.rna's rounding), lo = x - hi
// exactly, of which the tensor cores read the top 19 bits (TF32 operands'
// low 13 bits are not read: lo is truncated); a*b ~ a_lo*b_hi + a_hi*b_lo
// + a_hi*b_hi, the two cross terms first into the same f32 accumulator.
// Each product of two TF32 values is exact in f32; dropping a_lo*b_lo and
// truncating lo cost ~2^-21 of |a*b|.
// ---------------------------------------------------------------------------

// two integer operations: cvt.rna.tf32.f32 compiles to more (it also
// tests for infinities), and every operand here is finite
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a . b, one TF32 tensor-core product
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b to f32 accuracy: the cross terms, then hi . hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           uint32_t b_hi0, uint32_t b_hi1,
                                           uint32_t b_lo0, uint32_t b_lo1) {
  mma_tf32(c, a_lo, b_hi0, b_hi1);
  mma_tf32(c, a_hi, b_lo0, b_lo1);
  mma_tf32(c, a_hi, b_hi0, b_hi1);
}

// 2^x by the SFU (`ex2.approx.ftz`: ~2 ulp, results below 2^-126 flushed
// to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Asynchronous copies into shared memory; a copy that is not `live` reads
// nothing and zero-fills its destination.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool live) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(gmem), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool live) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(gmem), "r"(live ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace flash
