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
// D = 32, 132 KB at D = 64): the block's dynamic shared memory. The
// padding makes the two read patterns, (row g, col t) for Q.K^T-like
// products and (row 2t or 2t+1, col g) for the products that take a C
// fragment as A, hit 32 distinct banks at D = 8, 16, 32 and 64: at
// D = 32 and 64 the pitch is 4 (mod 32) words (36, 68), so row g col t
// falls in bank 4g + t and row 2t (+1) col g in bank 8t + g (+ 4), eight
// rows by four columns and four row pairs by eight columns covering the
// 32 banks once.
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
// 8-wide k slab, in registers: D/4 words a thread. `frag` hands out k
// slab kk (a copy the compiler folds away), `put` stores it. K6 builds
// it bare; K7 builds it, like SmemResident, from a shared-memory slot,
// which it does not use.
template <int D>
struct Resident {
  // k slabs a product's loop unrolls: all (a register array needs
  // constant indices); n-tiles K7's dQ tile loop unrolls: all
  static constexpr int kUnroll = D / 8;
  static constexpr int kTileUnroll = kUnits;
  uint32_t hi[D / 8][4];
  uint32_t lo[D / 8][4];

  Resident() = default;
  __device__ __forceinline__ explicit Resident(uint4*) {}

  __device__ __forceinline__ void frag(int kk, uint32_t (&h)[4],
                                       uint32_t (&l)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[e] = hi[kk][e];
      l[e] = lo[kk][e];
    }
  }
  __device__ __forceinline__ void put(int kk, const uint32_t (&h)[4],
                                      const uint32_t (&l)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[kk][e] = h[e];
      lo[kk][e] = l[e];
    }
  }
};

// A 16-byte shared-memory load the compiler may neither merge with
// another nor hoist out of a loop (`asm volatile`): SmemResident's
// fragments are read anew at every use, or ptxas would keep them all in
// registers again. The "memory" clobber orders it after every earlier
// store in the compiler's view (st_shared_v4's among them), so the
// ordering does not rest on a barrier that happens to lie between.
__device__ __forceinline__ uint4 ld_shared_v4(const uint4* p) {
  uint4 v;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// Its store: SmemResident::put's words, written through asm as they are
// read.
__device__ __forceinline__ void st_shared_v4(uint4* p, uint4 v) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};"
               :
               : "r"(a), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// The same fragments kept in shared memory, for the instances whose
// register fragments would spill (D = 64: the backward holds two resident
// arrays, 128 words a thread, beside 128 words of accumulators). A lane
// reads back only the words it wrote, so no barrier is needed; each k
// slab is one 16-byte word per lane and plane, [kk][lane], so a warp's
// read is 512 contiguous bytes (conflict-free). `SmemResident` is a view:
// `base` points at this array's slot of kWords 16-byte words.
template <int D>
struct SmemResident {
  static constexpr int kWords = 2 * (D / 8) * 32;  // uint4 words a slot
  // k slabs a product's loop unrolls: 2, so that the compiler cannot
  // gather a whole product's loads (fragments and B words) up front;
  // n-tiles K7's dQ tile loop unrolls: 2 (fully unrolled, ptxas held
  // that launch at 128 registers and spilled)
  static constexpr int kUnroll = 2;
  static constexpr int kTileUnroll = 2;
  uint4* base;
  int lane;

  __device__ __forceinline__ explicit SmemResident(uint4* slot)
      : base(slot), lane(threadIdx.x & 31) {}
  __device__ __forceinline__ void frag(int kk, uint32_t (&h)[4],
                                       uint32_t (&l)[4]) const {
    const uint4 a = ld_shared_v4(base + kk * 32 + lane);
    const uint4 b = ld_shared_v4(base + (D / 8 + kk) * 32 + lane);
    h[0] = a.x, h[1] = a.y, h[2] = a.z, h[3] = a.w;
    l[0] = b.x, l[1] = b.y, l[2] = b.z, l[3] = b.w;
  }
  __device__ __forceinline__ void put(int kk, const uint32_t (&h)[4],
                                      const uint32_t (&l)[4]) {
    st_shared_v4(base + kk * 32 + lane, make_uint4(h[0], h[1], h[2], h[3]));
    st_shared_v4(base + (D / 8 + kk) * 32 + lane,
                 make_uint4(l[0], l[1], l[2], l[3]));
  }
};

// Where a kernel keeps `slots` resident arrays per warp: registers
// (Resident), or shared memory (SmemResident) behind the block's Tiles,
// which then takes smem_resident_bytes more; slot(...) is a warp's array.
template <int D, bool kInSmem>
struct ResidentPlace {
  using Type = Resident<D>;
  static constexpr int bytes(int) { return 0; }
};
template <int D>
struct ResidentPlace<D, true> {
  using Type = SmemResident<D>;
  static constexpr int bytes(int slots) {
    return kWarps * slots * SmemResident<D>::kWords * 16;
  }
};

// A warp's `i`-th of `slots` shared-memory resident arrays, behind the
// block's Tiles in its dynamic shared memory.
template <int D>
__device__ __forceinline__ uint4* resident_slot(float4* smem, int warp,
                                                int slots, int i) {
  return reinterpret_cast<uint4*>(reinterpret_cast<char*>(smem) +
                                  sizeof(Tiles<D>)) +
         (warp * slots + i) * SmemResident<D>::kWords;
}

// The 16 rows from r0 of a (rows, D) array, each element times `mult`
// before its split; rows at or beyond S read as 0.
template <int D, typename R>
__device__ __forceinline__ void load_a(R& a, const float* __restrict__ x,
                                       int r0, int s_len, int g, int t,
                                       float mult = 1.f) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + 8 * (e & 1);
      const int col = 8 * kk + t + 4 * (e >> 1);
      const float v =
          row < s_len ? __ldg(x + static_cast<int64_t>(row) * D + col) : 0.f;
      split_tf32(v * mult, h[e], l[e]);
    }
    a.put(kk, h, l);
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
