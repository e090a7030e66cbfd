// Shared pieces of K6 (flash attention forward) and K7 (its backward):
// the masking constant of the JAX kernels, the warp tiling, 3xTF32
// `mma.sync` on the tensor cores, the `cp.async` staging of streamed
// tiles with their split into TF32 hi and lo planes, the resident A
// fragments and the C-to-A permutation, and the PTX wrappers either
// kernel needs (`ldmatrix` is K6's, 4-byte `cp.async` K7's).
//
// Layout: every tensor is heads-first and contiguous, (B*H, S, D) f32 for
// Q, K, V, O, dO, dQ, dK, dV and (B*H, S) for the row logsumexp and
// D = rowsum(dO*O). A row of D floats is 16-byte aligned whenever D is a
// multiple of 4 (every D the kernels take), so rows move as 16-byte
// copies.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace flash {

// the JAX kernels mask with -1e30 (ops/attention.py NEG_INF) and start
// the running row max there; K6 starts it there too, masking by index
constexpr float kNegInf = -1e30f;

// 4 warps (128 threads) per block, each warp owning 16 resident rows (an
// m16 tile), a block 64; streamed rows arrive in tiles of 64, 8 n-tiles of
// 8 rows each
constexpr int kWarps = 4;
constexpr int kBlockThreads = 32 * kWarps;
constexpr int kWarpRows = 16;
constexpr int kBlockRows = kWarps * kWarpRows;  // 64
constexpr int kTile = 64;
constexpr int kUnits = kTile / 8;
constexpr float kLog2e = 1.4426950408889634f;

inline int64_t row_blocks(int64_t s) {
  return (s + kBlockRows - 1) / kBlockRows;
}

// ---------------------------------------------------------------------------
// Tensor-core pieces: 3xTF32 `mma.sync` m16n8k8 and `cp.async` staging.
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, lane
// = 4*g + t (g = lane >> 2, t = lane & 3):
//   A (16 x 8, rows x k): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, k x cols):  b0 (t, g), b1 (t+4, g)
//   C (16 x 8):           c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t),
//                         c3 (g+8, 2t+1)
// so lanes 4g .. 4g+3 (a quad) hold rows g and g + 8 of a C fragment.
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
// to 0; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Four 8x8 matrices of 16-bit values (here: 8 rows of four 32-bit words
// each) from shared memory, lanes 8i .. 8i+7 giving the row addresses of
// matrix i (16-byte aligned); lane 4g + t receives word t of row g of
// matrix i in r[i]: one instruction for the four B-fragment registers
// (hi b0, b1, lo b0, b1) of a k-step that would take four 32-bit loads.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            unsigned smem_addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr)
      : "memory");
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

// ---------------------------------------------------------------------------
// Streamed tiles and resident fragments
// ---------------------------------------------------------------------------

// Shared memory of one block's two streamed arrays (K and V, or Q and dO):
// two raw stages that cp.async fills, and the landed tile's TF32 hi and lo
// planes, rows padded to D + 4 (20 KB at D = 8, 36 KB at D = 16, 68 KB at
// D = 32): the block's dynamic shared memory. The padding makes the two
// read patterns, (row g, col t) for Q.K^T-like products and (row 2t or
// 2t+1, col g) for the products that take a C fragment as A, hit 32
// distinct banks at D = 8, 16 and 32.
template <int D>
struct Tiles {
  static constexpr int kPitch = D + 4;
  float raw[2][2][kTile * D];
  uint32_t hi[2][kTile * kPitch];
  uint32_t lo[2][kTile * kPitch];
};

// Start copying rows [r0, r0 + kTile) of u and w into `stage`, rows at or
// beyond `live_rows` zero-filled.
template <int D>
__device__ __forceinline__ void issue_tile(Tiles<D>& sm, int stage,
                                           const float* __restrict__ u,
                                           const float* __restrict__ w,
                                           int r0, int live_rows) {
  constexpr int kChunks = D / 4;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kTile * kChunks; i += kBlockThreads) {
    const int r = r0 + i / kChunks;
    const bool live = r < live_rows;
    const int64_t off =
        live ? static_cast<int64_t>(r) * D + 4 * (i % kChunks) : 0;
    cp_async16(&sm.raw[stage][0][4 * i], u + off, live);
    cp_async16(&sm.raw[stage][1][4 * i], w + off, live);
  }
}

// Split the landed `stage` into the hi and lo planes.
template <int D>
__device__ __forceinline__ void split_tile(Tiles<D>& sm, int stage) {
  constexpr int kChunks = D / 4;
  constexpr int kPitch = Tiles<D>::kPitch;
  for (int i = threadIdx.x; i < 2 * kTile * kChunks; i += kBlockThreads) {
    const int a = i / (kTile * kChunks);
    const int j = i % (kTile * kChunks);
    const float4 x = reinterpret_cast<const float4*>(sm.raw[stage][a])[j];
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    const int at = (j / kChunks) * kPitch + 4 * (j % kChunks);
    *reinterpret_cast<uint4*>(&sm.hi[a][at]) = h;
    *reinterpret_cast<uint4*>(&sm.lo[a][at]) = l;
  }
}

// One warp's 16 resident rows as m16n8k8 A fragments, hi and lo, one per
// 8-wide k slab.
template <int D>
struct Resident {
  uint32_t hi[D / 8][4];
  uint32_t lo[D / 8][4];
};

// The 16 rows from r0 of a (rows, D) array, each element times `mult`
// before its split; rows at or beyond S read as 0.
template <int D>
__device__ __forceinline__ void load_a(Resident<D>& a,
                                       const float* __restrict__ x, int r0,
                                       int s_len, int g, int t,
                                       float mult = 1.f) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + 8 * (e & 1);
      const int col = 8 * kk + t + 4 * (e >> 1);
      const float v =
          row < s_len ? __ldg(x + static_cast<int64_t>(row) * D + col) : 0.f;
      split_tf32(v * mult, a.hi[kk][e], a.lo[kk][e]);
    }
  }
}

// acc += X . B over streamed rows 8j .. 8j+7 of plane `a`, X the C
// fragment of a product against those rows (P or dS) read as an A
// fragment: the C fragment for n-tile j is the A fragment of k-step j when
// logical k = t is read as streamed row 8j + 2t and k = t + 4 as row
// 8j + 2t + 1, so a0..a3 = c0, c2, c1, c3, and B is read with the same
// permutation (b0 = row 8j + 2t, b1 = row 8j + 2t + 1, col g). The sum
// over k does not depend on the order of its terms.
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           const float (&x)[4],
                                           const Tiles<D>& sm, int a, int j,
                                           int g, int t) {
  constexpr int kPitch = Tiles<D>::kPitch;
  uint32_t a_hi[4], a_lo[4];
  split_tf32(x[0], a_hi[0], a_lo[0]);
  split_tf32(x[2], a_hi[1], a_lo[1]);
  split_tf32(x[1], a_hi[2], a_lo[2]);
  split_tf32(x[3], a_hi[3], a_lo[3]);
  const int at = (8 * j + 2 * t) * kPitch + g;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int b0 = at + 8 * nt, b1 = b0 + kPitch;
    mma_3xtf32(acc[nt], a_hi, a_lo, sm.hi[a][b0], sm.hi[a][b1],
               sm.lo[a][b0], sm.lo[a][b1]);
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }
}

template <int D>
__device__ __forceinline__ void add_to(float (&sum)[D / 8][4],
                                       const float (&part)[D / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[nt][e] += part[nt][e];
  }
}

}  // namespace flash
