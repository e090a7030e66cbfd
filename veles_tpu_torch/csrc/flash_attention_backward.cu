// K7: blocked (flash) attention backward, f32, heads-first (B*H, S, D),
// every product on the tensor cores as 3xTF32 `mma.sync`.
//
// Replaces: veles_tpu/ops/pallas_kernels.py `_flash_bwd_pallas`, its two
// TPU kernels `_flash_dq_kernel` (:553; dQ on the forward's grid, KV
// streamed) and `_flash_dkv_kernel` (:595; dK and dV on the transposed
// grid, the KV tile resident while Q and dO tiles stream), the backward
// half of the custom VJP `_flash_attn`. Both recompute the probabilities
// from the forward's saved logsumexp instead of storing them:
//
//   p = exp(s*scale - lse) (0 where the causal mask or S cuts the pair);
//   dS = p * (dO.V^T - D) * scale with D = rowsum(dO*O), computed by the
//   caller; dQ = dS.K; dV = P^T.dO; dK = dS^T.Q.
//
// Bound on the H100 SXM: operations. The function needs five products of
// 2*D per (query, key) pair the causal mask keeps (Q.K^T, dO.V^T, P^T.dO,
// dS.K, dS^T.Q), 10*D*S(S+1)/2 per head: 171.8 GFLOP at B*H = 128,
// S = 4096, D = 16 against 239 MB of inputs and outputs. At f32 accuracy
// on the tensor cores each product costs three TF32 products (below):
// 3 * 171.8 GFLOP at 495 TF32 TFLOP/s = 1.0415 ms (2.5648 ms at 67 f32
// TFLOP/s, the bound of f32 FMA on the CUDA cores). This design
// executes seven products per pair (14*D): Q.K^T and dO.V^T are
// recomputed in both launches, the price of having no atomics. Its pace
// is set by the rate of TF32 mma.sync (PERF.md has the times).
//
// Numerics (3xTF32, flash_common.cuh): each operand x = hi + lo, hi =
// tf32(x) rounded to nearest, lo = x - hi, which the tensor cores read
// truncated to TF32; a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, the two
// cross terms first, into the same accumulator. P and dS are split in
// registers before their products. p = 2^(s*scale*log2e - lse*log2e) by
// the SFU's ex2; dS is carried without its factor `scale`, applied to dQ
// and dK as they are stored. The second products sum each 64-row
// streamed tile into a fresh accumulator, added to the row's running sum
// by an f32 add (round to nearest), so the tensor cores' accumulation
// chain is at most 24 mma long. Within tolerance of the plain version,
// not bit-equal to it; the result does not depend on the order in which
// blocks run (no atomics), so two calls agree bit for bit.
//
// Design: two launches, 4 warps (128 threads) per block, each warp owns
// 16 rows, a block 64:
// 1. dQ: one block per (head, tile of 64 query rows); the heaviest (last)
//    query tiles launch first. 64-key tiles of K and V stream from key 0
//    to the block's diagonal.
// 2. dK/dV: one block per (head, tile of 64 key rows); key tile 0, the
//    heaviest, launches first. 64-query tiles of Q, dO, lse and D stream
//    from the block's first key on (earlier queries cannot see it under
//    causal masking).
// - Resident rows (Q and dO, or K and V) are loaded once into registers
//   as m16n8k8 A fragments, split once into hi and lo. The row's
//   accumulators stay in C fragments for the whole sweep.
// - Streamed tiles are copied by cp.async (16-byte chunks; lse and D by
//   4-byte copies), two stages deep, rows beyond S zero-filled. Each
//   landed tile is split once per block into hi and lo planes whose rows
//   are padded to D + 4 floats: the two read patterns, (row g, col t) for
//   Q.K^T and (row 2t or 2t+1, col g) for the second products, then hit
//   32 distinct banks at D = 8, 16, 32 and 64. The stages and planes are
//   dynamic shared memory (68 KB at D = 32; at D = 64, 132 KB and 64 KB
//   of resident arrays: past the 48 KB of a static array). The tiles,
//   their staging and split, the resident fragments and the permutation
//   below are flash_common.cuh's, shared with K6.
// - Per 8 streamed rows j (one n-tile), a warp computes s and dP for its
//   16 rows (D/8 k-steps x 3 mma each), p = exp2(s*scale*log2e -
//   lse*log2e), dS, and then takes the second products over those same 8
//   rows at once, so no score tile is held.
// - The fragment permutation: the C fragment of P (or dS) for n-tile j is
//   the A fragment of the second product's k-step j when logical k = t is
//   read as streamed row 8j + 2t and k = t + 4 as row 8j + 2t + 1:
//   a0..a3 = c0, c2, c1, c3; B is read with the same permutation
//   (b0 = row 8j + 2t, b1 = row 8j + 2t + 1, col g). The sum over k does
//   not depend on the order of its terms.
// - Masking by index, never by value: an n-tile whose 8 streamed rows all
//   lie above a warp's diagonal is skipped; on tiles that straddle the
//   diagonal and on ragged tiles p = 0 (hence dS = 0) where key > query,
//   key >= S or query >= S. (Zero-filled rows do not make p zero: q = 0
//   and lse = 0 give p = 1.) A warp's other tiles run a copy of the loop
//   with no test at all (dq_tile / dkv_tile<false>).
// Any S; D in {8, 16, 32, 64}, the head widths the port's workflows run.
// At D = 64 the resident fragments (Q and dO, or K and V: 128 words a
// thread) move to shared memory behind the tiles (RowPlace below): in
// registers they would leave the dK/dV launch's 128 words of
// accumulators no room.
#include "flash_common.cuh"

namespace {

using flash::accumulate;
using flash::add_to;
using flash::issue_tile;
using flash::kBlockRows;
using flash::kBlockThreads;
using flash::kLog2e;
using flash::kTile;
using flash::kUnits;
using flash::kWarpRows;
using flash::load_a;
using flash::mma_3xtf32;
using flash::row_blocks;
using flash::split_tile;
using flash::Tiles;
using flash::zero;

// Where the two resident arrays live: registers up to D = 32, shared
// memory at D = 64 (see the header).
template <int D>
using RowPlace = flash::ResidentPlace<D, (D >= 64)>;

// Start copying lse and D of rows [r0, r0 + kTile) into dst[0] and dst[1]
// (one 4-byte copy per thread), rows at or beyond S zero-filled.
__device__ __forceinline__ void issue_scalars(float (&dst)[2][kTile],
                                              const float* __restrict__ lse,
                                              const float* __restrict__ di,
                                              int r0, int s_len) {
  static_assert(kBlockThreads == 2 * kTile, "one copy per thread");
  const int i = threadIdx.x % kTile;
  const int a = threadIdx.x / kTile;  // 0: lse, 1: D
  const bool live = r0 + i < s_len;
  flash::cp_async4(&dst[a][i], (a == 0 ? lse : di) + (live ? r0 + i : 0),
                   live);
}

// s = X . U^T and dp = Y . W^T for the warp's 16 rows against streamed rows
// 8j .. 8j+7 of the planes (U = plane 0, W = plane 1); element e pairs
// row g + 8*(e >> 1) with streamed row 8j + 2t + (e & 1). The two chains
// of mma are interleaved.
template <int D, typename R>
__device__ __forceinline__ void scores(float (&s)[4], float (&dp)[4],
                                       const R& x, const R& y,
                                       const Tiles<D>& sm, int j, int g,
                                       int t) {
  constexpr int kPitch = Tiles<D>::kPitch;
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] = dp[e] = 0.f;
  const int at = (8 * j + g) * kPitch + t;
#pragma unroll(R::kUnroll)
  for (int kk = 0; kk < D / 8; ++kk) {
    const int b0 = at + 8 * kk, b1 = b0 + 4;
    uint32_t x_hi[4], x_lo[4], y_hi[4], y_lo[4];
    x.frag(kk, x_hi, x_lo);
    y.frag(kk, y_hi, y_lo);
    mma_3xtf32(s, x_hi, x_lo, sm.hi[0][b0], sm.hi[0][b1], sm.lo[0][b0],
               sm.lo[0][b1]);
    mma_3xtf32(dp, y_hi, y_lo, sm.hi[1][b0], sm.hi[1][b1], sm.lo[1][b0],
               sm.lo[1][b1]);
  }
}

// Write the C-fragment accumulator of the 16 rows from r0, times `scale`
// (rows < S only).
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           const float (&acc)[D / 8][4],
                                           float scale, int r0, int s_len,
                                           int g, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= s_len) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      *reinterpret_cast<float2*>(out + static_cast<int64_t>(row) * D +
                                 8 * nt + 2 * t) =
          make_float2(acc[nt][2 * half] * scale,
                      acc[nt][2 * half + 1] * scale);
    }
  }
}

// One warp's work on one landed K/V tile of the dQ launch: part += dS.K
// (dS without its factor `scale`) over the tile's keys from k0. kEdge: the
// tile straddles the diagonal or runs past S, so keys above the diagonal
// are skipped by n-tile and p is masked by index; otherwise no test runs.
template <bool kEdge, int D, typename R>
__device__ __forceinline__ void dq_tile(float (&part)[D / 8][4],
                                        const R& qa, const R& oa,
                                        const Tiles<D>& sm,
                                        const float (&l2)[2],
                                        const float (&dd)[2], float sl2,
                                        int r0, int k0, int s_len,
                                        bool causal, int g, int t) {
#pragma unroll(R::kTileUnroll)
  for (int j = 0; j < kUnits; ++j) {
    // 8 keys wholly above the warp's diagonal: p = 0 for all of them
    if (kEdge && causal && k0 + 8 * j > r0 + kWarpRows - 1) break;
    float s[4], dp[4];
    scores<D>(s, dp, qa, oa, sm, j, g, t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      float p = flash::exp2_approx(fmaf(s[e], sl2, -l2[h]));
      if (kEdge) {
        const int row = r0 + g + 8 * h;
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        if ((causal && key > row) || key >= s_len || row >= s_len) p = 0.f;
      }
      s[e] = p * (dp[e] - dd[h]);
    }
    accumulate<D>(part, s, sm, 0, j, g, t);
  }
}

template <int D>
__global__ void __launch_bounds__(kBlockThreads)
    flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, float* __restrict__ dq,
                    int bh_count, int s_len, float scale, bool causal) {
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
  issue_tile<D>(sm, 0, kb, vb, 0, kend);
  flash::cp_async_commit();
  if (ntiles > 1) issue_tile<D>(sm, 1, kb, vb, kTile, kend);
  flash::cp_async_commit();

  typename RowPlace<D>::Type qa(
      flash::resident_slot<D>(flash_smem, warp, 2, 0)),
      oa(flash::resident_slot<D>(flash_smem, warp, 2, 1));
  load_a<D>(qa, q + base * D, r0, s_len, g, t);
  load_a<D>(oa, dout + base * D, r0, s_len, g, t);
  // per C-fragment row (g, g + 8): lse * log2(e) and D
  float l2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    l2[h] = row < s_len ? lse[base + row] * kLog2e : 0.f;
    dd[h] = row < s_len ? di[base + row] : 0.f;
  }
  const float sl2 = scale * kLog2e;
  const bool warp_live = r0 < s_len;
  float acc[D / 8][4];
  zero<D>(acc);

  for (int it = 0; it < ntiles; ++it) {
    flash::cp_async_wait<1>();
    __syncthreads();
    split_tile<D>(sm, it & 1);
    __syncthreads();
    if (it + 2 < ntiles) {
      issue_tile<D>(sm, it & 1, kb, vb, (it + 2) * kTile, kend);
    }
    flash::cp_async_commit();
    if (!warp_live) continue;
    const int k0 = it * kTile;
    float part[D / 8][4];
    zero<D>(part);
    if ((causal && k0 + kTile - 1 > r0) || k0 + kTile > s_len ||
        r0 + kWarpRows > s_len) {
      dq_tile<true, D>(part, qa, oa, sm, l2, dd, sl2, r0, k0, s_len, causal,
                       g, t);
    } else {
      dq_tile<false, D>(part, qa, oa, sm, l2, dd, sl2, r0, k0, s_len, causal,
                        g, t);
    }
    add_to<D>(acc, part);
  }
  if (warp_live) store_rows<D>(dq + base * D, acc, scale, r0, s_len, g, t);
}

// One warp's work on one landed Q/dO tile of the dK/dV launch:
// dv_part += P^T.dO and dk_part += dS^T.Q (dS without its factor `scale`)
// over the tile's queries from c0; kEdge as in dq_tile.
template <bool kEdge, int D, typename R>
__device__ __forceinline__ void dkv_tile(float (&dk_part)[D / 8][4],
                                         float (&dv_part)[D / 8][4],
                                         const R& ka, const R& va,
                                         const Tiles<D>& sm,
                                         const float* l2s, const float* dds,
                                         float sl2, int r0, int c0, int s_len,
                                         bool causal, int g, int t) {
#pragma unroll
  for (int j = 0; j < kUnits; ++j) {
    // 8 queries wholly before the warp's first key: p = 0 for them all
    if (kEdge && causal && c0 + 8 * j + 7 < r0) continue;
    float s[4], dp[4];
    scores<D>(s, dp, ka, va, sm, j, g, t);
    const int ql = 8 * j + 2 * t;  // tile-local query of elements 0 and 2
    const float2 l2 = *reinterpret_cast<const float2*>(&l2s[ql]);
    const float2 dd = *reinterpret_cast<const float2*>(&dds[ql]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = flash::exp2_approx(
          fmaf(s[e], sl2, -((e & 1) ? l2.y : l2.x)));
      if (kEdge) {
        const int key = r0 + g + 8 * (e >> 1);
        const int query = c0 + ql + (e & 1);
        if ((causal && key > query) || query >= s_len || key >= s_len) {
          p = 0.f;
        }
      }
      s[e] = p;
      dp[e] = p * (dp[e] - ((e & 1) ? dd.y : dd.x));
    }
    accumulate<D>(dv_part, s, sm, 1, j, g, t);   // P^T.dO
    accumulate<D>(dk_part, dp, sm, 0, j, g, t);  // dS^T.Q
  }
}

template <int D>
__global__ void __launch_bounds__(kBlockThreads)
    flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, float* __restrict__ dk,
                     float* __restrict__ dv, int bh_count, int s_len,
                     float scale, bool causal) {
  extern __shared__ float4 flash_smem[];
  Tiles<D>& sm = *reinterpret_cast<Tiles<D>*>(flash_smem);
  __shared__ __align__(16) float sraw[2][2][kTile];  // stages x {lse, D}
  __shared__ __align__(16) float l2s[kTile];         // lse * log2(e)
  __shared__ __align__(16) float dds[kTile];         // D
  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7,
            t = threadIdx.x & 3;
  const int bh = blockIdx.x % bh_count;
  const int k0 = (blockIdx.x / bh_count) * kBlockRows;
  const int r0 = k0 + warp * kWarpRows;  // the warp's first key
  const int64_t base = static_cast<int64_t>(bh) * s_len;
  const float* qb = q + base * D;
  const float* ob = dout + base * D;

  // queries that can see this key tile: from its first key on (causal)
  const int qbeg = causal ? k0 : 0;
  const int ntiles = (s_len - qbeg + kTile - 1) / kTile;
  issue_tile<D>(sm, 0, qb, ob, qbeg, s_len);
  issue_scalars(sraw[0], lse + base, di + base, qbeg, s_len);
  flash::cp_async_commit();
  if (ntiles > 1) {
    issue_tile<D>(sm, 1, qb, ob, qbeg + kTile, s_len);
    issue_scalars(sraw[1], lse + base, di + base, qbeg + kTile, s_len);
  }
  flash::cp_async_commit();

  typename RowPlace<D>::Type ka(
      flash::resident_slot<D>(flash_smem, warp, 2, 0)),
      va(flash::resident_slot<D>(flash_smem, warp, 2, 1));
  load_a<D>(ka, k + base * D, r0, s_len, g, t);
  load_a<D>(va, v + base * D, r0, s_len, g, t);
  const float sl2 = scale * kLog2e;
  const bool warp_live = r0 < s_len;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero<D>(dk_acc);
  zero<D>(dv_acc);

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    flash::cp_async_wait<1>();
    __syncthreads();
    split_tile<D>(sm, st);
    if (threadIdx.x < kTile) {
      l2s[threadIdx.x] = sraw[st][0][threadIdx.x] * kLog2e;
      dds[threadIdx.x] = sraw[st][1][threadIdx.x];
    }
    __syncthreads();
    const int c0 = qbeg + it * kTile;  // the tile's first query
    if (it + 2 < ntiles) {
      issue_tile<D>(sm, st, qb, ob, c0 + 2 * kTile, s_len);
      issue_scalars(sraw[st], lse + base, di + base, c0 + 2 * kTile, s_len);
    }
    flash::cp_async_commit();
    if (!warp_live) continue;
    float dk_part[D / 8][4], dv_part[D / 8][4];
    zero<D>(dk_part);
    zero<D>(dv_part);
    if ((causal && c0 < r0 + kWarpRows - 1) || c0 + kTile > s_len ||
        r0 + kWarpRows > s_len) {
      dkv_tile<true, D>(dk_part, dv_part, ka, va, sm, l2s, dds, sl2, r0, c0,
                        s_len, causal, g, t);
    } else {
      dkv_tile<false, D>(dk_part, dv_part, ka, va, sm, l2s, dds, sl2, r0, c0,
                         s_len, causal, g, t);
    }
    add_to<D>(dk_acc, dk_part);
    add_to<D>(dv_acc, dv_part);
  }
  if (!warp_live) return;
  store_rows<D>(dk + base * D, dk_acc, scale, r0, s_len, g, t);
  store_rows<D>(dv + base * D, dv_acc, 1.f, r0, s_len, g, t);
}

// The dynamic shared memory one block of either launch takes at head
// width D: the streamed tiles, and the resident arrays where RowPlace puts
// them in shared memory.
template <int D>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(Tiles<D>)) + RowPlace<D>::bytes(2);
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* dout,
           const float* lse, const float* di, float* dq, float* dk, float* dv,
           int64_t bh, int64_t s, float scale, int causal, cudaStream_t st) {
  constexpr int kSmem = smem_bytes<D>();
  if (kSmem > 48 * 1024) {  // above the default a block may ask for
    cudaError_t err = cudaFuncSetAttribute(
        flash_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_dkv_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>(bh * row_blocks(s));
  flash_dq_kernel<D><<<blocks, kBlockThreads, kSmem, st>>>(
      q, k, v, dout, lse, di, dq, static_cast<int>(bh), static_cast<int>(s),
      scale, causal != 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_dkv_kernel<D><<<blocks, kBlockThreads, kSmem, st>>>(
      q, k, v, dout, lse, di, dk, dv, static_cast<int>(bh),
      static_cast<int>(s), scale, causal != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout, dq, dk, dv: (bh, s, d) f32 contiguous, 16-byte aligned;
// lse, di: (bh, s). Returns a cudaError_t (cudaErrorInvalidValue for a head
// width or a size the kernels do not take).
extern "C" int flash_attention_backward_f32(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* di, float* dq, float* dk, float* dv,
    int64_t bh, int64_t s, int d, float scale, int causal, void* stream) {
  if (bh <= 0 || s <= 0) return 0;
  if (s > (int64_t{1} << 30) || bh * row_blocks(s) > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8:
      return launch<8>(q, k, v, dout, lse, di, dq, dk, dv, bh, s, scale,
                       causal, st);
    case 16:
      return launch<16>(q, k, v, dout, lse, di, dq, dk, dv, bh, s, scale,
                        causal, st);
    case 32:
      return launch<32>(q, k, v, dout, lse, di, dq, dk, dv, bh, s, scale,
                        causal, st);
    case 64:
      return launch<64>(q, k, v, dout, lse, di, dq, dk, dv, bh, s, scale,
                        causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory one block of either launch takes at head
// width d, in bytes (-1 for a width it is not compiled for).
extern "C" int flash_attention_backward_smem_bytes(int d) {
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
