// K6: blocked (flash) attention forward, f32, heads-first (B*H, S, D),
// both products on the tensor cores as 3xTF32 `mma.sync`.
//
// Replaces: veles_tpu/ops/pallas_kernels.py `_flash_kernel` (reached
// through `_flash_fwd_core` and `flash_attention_pallas`, the `flash_attn`
// registry op's default), the TPU kernel whose grid (B*H, S/blk_q,
// S/blk_k) streams one K/V tile per step through VMEM into an
// online-softmax scratch, skips KV tiles wholly above the causal diagonal,
// and writes the normalised output and the row logsumexp:
//
//   s = (q . k) * scale, masked where key > query (causal) or key >= S;
//   per KV tile: m' = max(m, max s); p = exp(s - m') (0 where masked);
//   l = l*exp(m - m') + sum p; acc = acc*exp(m - m') + p.V;
//   then O = acc / l (times the optional pre-scaled dropout mask) and
//   lse = m + log l.
//
// Bound on the H100 SXM: operations. Per (query, key) pair that the causal
// mask keeps, 2*D products for Q.K^T and 2*D for P.V: 4*D*S(S+1)/2 per
// head, 68.7 GFLOP at B*H = 128, S = 4096, D = 16 (and at B*H = 64,
// D = 32) against 136 MB of inputs and outputs. At f32 accuracy on the
// tensor cores each product costs three TF32 products: 3 * 68.7 GFLOP at
// 495 TF32 TFLOP/s = 0.416 ms (1.0259 ms at 67 f32 TFLOP/s, the bound of
// f32 FMA on the CUDA cores). This design executes exactly the 4*D
// products per kept pair (plus the masked halves of the tiles on each
// warp's diagonal), with no recompute; the softmax adds about one ex2 per
// pair on the SFUs (PERF.md has the times).
//
// Numerics (3xTF32, flash_common.cuh): each operand x = hi + lo, hi =
// tf32(x) rounded to nearest, lo = x - hi, which the tensor cores read
// truncated to TF32; a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, the two
// cross terms first, into the same accumulator. Q is multiplied by
// scale*log2(e) before its split, so the scores come out in log2 units
// and p = 2^(x - m) by the SFU's ex2 (m the running row max of x); P is
// split in registers before P.V. Each 64-key tile's P.V goes into a fresh
// accumulator, added to the rescaled running sum by an f32 fma, so the
// tensor cores' accumulation chain is at most 24 mma long. l is summed per
// thread and reduced across the quad of lanes sharing a row once, at the
// end. lse = m*ln(2) + log(l), in natural-log units, as K7 reads it (it
// takes lse*log2(e)). Within tolerance of the plain version, not bit-equal
// to it; the result does not depend on the order in which blocks run (no
// atomics), so two calls agree bit for bit.
//
// Design: one block of 4 warps (128 threads) per (head, tile of 64 query
// rows), each warp owning 16 rows; under causal masking the heaviest
// (last) query tiles launch first, so the long ones do not trail the grid.
// - Q is loaded once into m16n8k8 A fragments, split once into hi and lo;
//   the output accumulator (D/8 C fragments), m and l stay in registers
//   for the whole sweep, so only O and lse go back to device memory.
// - 64-key tiles of K and V stream from key 0 to the block's diagonal
//   (causal) or S by cp.async, two stages deep, rows at or beyond that end
//   zero-filled; each landed tile is split once per block into hi and lo
//   planes (flash_common.cuh's Tiles / issue_tile / split_tile, shared with
//   K7). `reverse_kv` visits the tiles last to first (the JAX kernel's
//   searched `kv_order` axis).
// - Per tile, a warp computes x = Q.K^T over all 64 keys (8 n-tiles x
//   D/8 k-steps x 3 mma, each k-step's four B registers by one
//   ldmatrix), takes the row max over its own 16 keys and then
//   across the quad (two __shfl_xor_sync), rescales, takes p, and runs
//   P.V with P's C fragments as A fragments through flash_common.cuh's
//   permutation (`accumulate`).
// - Masking by index, never by value: on a tile that straddles a warp's
//   diagonal or runs past S, an n-tile of 8 keys wholly above the
//   diagonal or past S is skipped, and every other masked score is set to
//   -inf, so it never enters the max and gets p = 2^-inf = 0. The running
//   max starts at -1e30 (the JAX kernels' NEG_INF), so a row that has seen
//   only masked keys keeps m = -1e30 and its rescale factor is 2^0 = 1,
//   never NaN, in either `kv_order`. A warp's other tiles run a copy of
//   the loop with no test at all (fwd_tile<false>).
// Any S; D in {8, 16, 32, 64}, the head widths the port's workflows run.
#include <math.h>

#include "flash_common.cuh"

namespace {

using flash::accumulate;
using flash::issue_tile;
using flash::kBlockRows;
using flash::kBlockThreads;
using flash::kLog2e;
using flash::kNegInf;
using flash::kTile;
using flash::kUnits;
using flash::kWarpRows;
using flash::load_a;
using flash::mma_3xtf32;
using flash::Resident;
using flash::row_blocks;
using flash::split_tile;
using flash::Tiles;
using flash::zero;

constexpr float kLn2 = 0.6931471805599453f;

// True when n-tile j of the tile from k0 holds no key any of the warp's
// 16 rows may see: all 8 keys past S or, under causal masking, above the
// warp's last row.
__device__ __forceinline__ bool unit_masked(int j, int r0, int k0, int s_len,
                                            bool causal) {
  const int first = k0 + 8 * j;
  return first >= s_len || (causal && first > r0 + kWarpRows - 1);
}

// x = (Q*scale*log2e) . K^T for the warp's 16 rows against the landed
// tile's 64 keys from k0; element e of n-tile j pairs row g + 8*(e >> 1)
// with key k0 + 8j + 2t + (e & 1). kEdge: masked scores (and whole masked
// n-tiles) are -inf; otherwise no test runs.
template <bool kEdge, int D>
__device__ __forceinline__ void tile_scores(float (&x)[kUnits][4],
                                            const Resident<D>& qa,
                                            const Tiles<D>& sm, int r0,
                                            int k0, int s_len, bool causal,
                                            int g, int t) {
  constexpr int kPitch = Tiles<D>::kPitch;
  // this lane's row address for ldmatrix_x4: matrices 0, 1 are the hi
  // plane's words 0-3 and 4-7 of a k-step, matrices 2, 3 the lo plane's
  const int lane = threadIdx.x & 31;
  const unsigned k_lane = static_cast<unsigned>(__cvta_generic_to_shared(
      ((lane >> 4) ? sm.lo[0] : sm.hi[0]) + (lane & 7) * kPitch +
      4 * ((lane >> 3) & 1)));
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
    if (kEdge && unit_masked(j, r0, k0, s_len, causal)) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = -INFINITY;
      continue;
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t b[4];  // hi b0, b1, lo b0, b1: K[8j + g][8kk + t (+ 4)]
      flash::ldmatrix_x4(b, k_lane + 4 * (8 * j * kPitch + 8 * kk));
      mma_3xtf32(x[j], qa.hi[kk], qa.lo[kk], b[0], b[1], b[2], b[3]);
    }
    if (kEdge) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + 8 * (e >> 1);
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        if (key >= s_len || (causal && key > row)) x[j][e] = -INFINITY;
      }
    }
  }
}

// One warp's online-softmax step over one landed K/V tile from k0: the
// running max m and this thread's part of l (both per C-fragment row g,
// g + 8, in log2 units for m) and the accumulator acc are rescaled and
// take the tile's p and P.V.
template <bool kEdge, int D>
__device__ __forceinline__ void fwd_tile(float (&acc)[D / 8][4],
                                         float (&m)[2], float (&l)[2],
                                         const Resident<D>& qa,
                                         const Tiles<D>& sm, int r0, int k0,
                                         int s_len, bool causal, int g,
                                         int t) {
  float x[kUnits][4];
  tile_scores<kEdge, D>(x, qa, sm, r0, k0, s_len, causal, g, t);
  float mn[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) mn[e >> 1] = fmaxf(mn[e >> 1], x[j][e]);
  }
  float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mn[h] = fmaxf(mn[h], __shfl_xor_sync(0xffffffffu, mn[h], 1));
    mn[h] = fmaxf(mn[h], __shfl_xor_sync(0xffffffffu, mn[h], 2));
    alpha[h] = flash::exp2_approx(m[h] - mn[h]);
    m[h] = mn[h];
  }
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = flash::exp2_approx(x[j][e] - mn[e >> 1]);
      x[j][e] = p;
      ls[e >> 1] += p;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = fmaf(l[h], alpha[h], ls[h]);
  float part[D / 8][4];
  zero<D>(part);
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    if (kEdge && unit_masked(j, r0, k0, s_len, causal)) continue;
    accumulate<D>(part, x[j], sm, 1, j, g, t);
  }
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[nt][e] = fmaf(acc[nt][e], alpha[e >> 1], part[nt][e]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBlockThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ mask, float* __restrict__ o,
                     float* __restrict__ lse, int bh_count, int s_len,
                     float sl2, bool causal, bool reverse_kv) {
  extern __shared__ float4 flash_smem[];
  Tiles<D>& sm = *reinterpret_cast<Tiles<D>*>(flash_smem);
  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7,
            t = threadIdx.x & 3;
  const int nq = (s_len + kBlockRows - 1) / kBlockRows;
  const int bh = blockIdx.x % bh_count;
  const int tile = blockIdx.x / bh_count;
  const int qt = causal ? nq - 1 - tile : tile;
  const int q0 = qt * kBlockRows;
  const int r0 = q0 + warp * kWarpRows;  // the warp's first query
  const int64_t base = static_cast<int64_t>(bh) * s_len;
  const float* kb = k + base * D;
  const float* vb = v + base * D;

  // keys the block sees: up to its last query under causal masking
  const int kend = causal ? min(s_len, q0 + kBlockRows) : s_len;
  const int ntiles = (kend + kTile - 1) / kTile;
  // the it-th tile visited, from key 0 or (reverse_kv) from the last
  auto first_key = [&](int it) {
    return (reverse_kv ? ntiles - 1 - it : it) * kTile;
  };
  issue_tile<D>(sm, 0, kb, vb, first_key(0), kend);
  flash::cp_async_commit();
  if (ntiles > 1) issue_tile<D>(sm, 1, kb, vb, first_key(1), kend);
  flash::cp_async_commit();

  // Q stays in registers at every width (at D = 64 a thread holds 64
  // words of Q beside 96 of accumulators and scores; 0 spill)
  Resident<D> qa;
  load_a<D>(qa, q + base * D, r0, s_len, g, t, sl2);
  float acc[D / 8][4];
  zero<D>(acc);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const bool warp_live = r0 < s_len;

  for (int it = 0; it < ntiles; ++it) {
    flash::cp_async_wait<1>();
    __syncthreads();
    split_tile<D>(sm, it & 1);
    __syncthreads();
    if (it + 2 < ntiles) {
      issue_tile<D>(sm, it & 1, kb, vb, first_key(it + 2), kend);
    }
    flash::cp_async_commit();
    if (!warp_live) continue;
    const int k0 = first_key(it);
    if ((causal && k0 + kTile - 1 > r0) || k0 + kTile > s_len) {
      fwd_tile<true, D>(acc, m, l, qa, sm, r0, k0, s_len, causal, g, t);
    } else {
      fwd_tile<false, D>(acc, m, l, qa, sm, r0, k0, s_len, causal, g, t);
    }
  }
  if (!warp_live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= s_len) continue;
    const int64_t at = (base + row) * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      float2 out = make_float2(acc[nt][2 * h] / l[h],
                               acc[nt][2 * h + 1] / l[h]);
      if (mask != nullptr) {
        const float2 mk =
            __ldg(reinterpret_cast<const float2*>(mask + at + 8 * nt));
        out.x *= mk.x;
        out.y *= mk.y;
      }
      *reinterpret_cast<float2*>(o + at + 8 * nt) = out;
    }
    if (t == 0) lse[base + row] = m[h] * kLn2 + logf(l[h]);
  }
}

template <int D>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(Tiles<D>));
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* mask,
           float* o, float* lse, int64_t bh, int64_t s, float scale,
           int causal, int reverse_kv, cudaStream_t st) {
  constexpr int kSmem = smem_bytes<D>();
  if (kSmem > 48 * 1024) {  // above the default a block may ask for
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>(bh * row_blocks(s));
  flash_fwd_kernel<D><<<blocks, kBlockThreads, kSmem, st>>>(
      q, k, v, mask, o, lse, static_cast<int>(bh), static_cast<int>(s),
      scale * kLog2e, causal != 0, reverse_kv != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, mask (or NULL), o: (bh, s, d) f32 contiguous, 16-byte aligned;
// lse: (bh, s). Returns a cudaError_t (cudaErrorInvalidValue for a head
// width or a size the kernel does not take).
extern "C" int flash_attention_forward_f32(const float* q, const float* k,
                                           const float* v, const float* mask,
                                           float* o, float* lse, int64_t bh,
                                           int64_t s, int d, float scale,
                                           int causal, int reverse_kv,
                                           void* stream) {
  if (bh <= 0 || s <= 0) return 0;
  if (s > (int64_t{1} << 30) || bh * row_blocks(s) > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8:
      return launch<8>(q, k, v, mask, o, lse, bh, s, scale, causal,
                       reverse_kv, st);
    case 16:
      return launch<16>(q, k, v, mask, o, lse, bh, s, scale, causal,
                        reverse_kv, st);
    case 32:
      return launch<32>(q, k, v, mask, o, lse, bh, s, scale, causal,
                        reverse_kv, st);
    case 64:
      return launch<64>(q, k, v, mask, o, lse, bh, s, scale, causal,
                        reverse_kv, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory one block of the kernel takes at head width
// d, in bytes (-1 for a width it is not compiled for).
extern "C" int flash_attention_forward_smem_bytes(int d) {
  switch (d) {
    case 8:
      return smem_bytes<8>();
    case 16:
      return smem_bytes<16>();
    case 32:
      return smem_bytes<32>();
    case 64:
      return smem_bytes<64>();
    default:
      return -1;
  }
}
