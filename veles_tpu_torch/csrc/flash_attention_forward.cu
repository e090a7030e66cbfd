// K6: blocked (flash) attention forward, f32, heads-first (B*H, S, D).
//
// Replaces: veles_tpu/ops/pallas_kernels.py `_flash_kernel` (reached
// through `_flash_fwd_core` and `flash_attention_pallas`, the `flash_attn`
// registry op's default), the TPU kernel whose grid (B*H, S/blk_q,
// S/blk_k) streams one K/V tile per step through VMEM into an
// online-softmax scratch, skips KV tiles wholly above the causal diagonal,
// and writes the normalised output and the row logsumexp.
//
//   s = (q . k) * scale, masked to -1e30 where key > query (causal) or
//   key >= S; per KV tile: m' = max(m, max s); p = exp(s - m') (0 where
//   s <= -1e29); l = l*exp(m - m') + sum p; acc = acc*exp(m - m') + p.V;
//   then O = acc / l (times the optional pre-scaled dropout mask) and
//   lse = m + log l.
//
// Bound on the H100: operations. Per (query, key) pair that the causal
// mask keeps, 2*D products for Q.K^T and 2*D for P.V: 4*D*S(S+1)/2 per
// head, 68.7 GFLOP at B*H = 128, S = 4096, D = 16 against 136 MB of
// inputs and outputs (over 500 operations per byte).
//
// Design (simple first, f32 FMA on the CUDA cores, no tensor cores):
// - one block of 128 threads per (head, tile of 128 query rows); each
//   thread owns one query row: q, the running max m, denominator l and the
//   D-wide accumulator live in registers for the whole KV sweep, so
//   nothing but the output ever goes back to device memory;
// - K and V stream through shared memory in chunks of 4096/D rows, read
//   by every thread of a warp at the same address (broadcast float4
//   loads); each chunk is consumed in tiles of BK keys whose scores stay in
//   registers between the max, exp and P.V passes;
// - a KV tile wholly above a thread's diagonal is skipped by that thread
//   (the guard below makes processing it a no-op, so skipping is exact),
//   and no chunk past the block's last query is loaded;
// - blocks of the heaviest (last) query tiles are launched first under
//   causal masking, so the long ones do not trail the grid;
// - `reverse_kv` visits chunks and tiles last to first (the JAX kernel's
//   searched `kv_order` axis); the all-masked-row guard p = 0 where
//   s <= -1e29 holds in both orders;
// - any S: the last query tile and the last KV chunk are ragged, masked
//   by index; D in {8, 16, 32}, the head widths the port's workflows run
//   (D = 32 takes BK = 32, so that q, the accumulator and the scores
//   still fit in registers).
#include "flash_common.cuh"

namespace {

using flash::kChunkFloats;
using flash::kMaskedAtOrBelow;
using flash::kNegInf;
using flash::kThreads;

template <int D, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ mask, float* __restrict__ o,
                     float* __restrict__ lse, int bh_count, int s_len,
                     float scale, bool causal, bool reverse_kv) {
  constexpr int CK = kChunkFloats / D;  // keys per shared-memory chunk
  static_assert(CK % BK == 0, "a chunk holds whole tiles");
  __shared__ __align__(16) float ks[kChunkFloats];
  __shared__ __align__(16) float vs[kChunkFloats];

  const int nq = (s_len + kThreads - 1) / kThreads;
  const int bh = blockIdx.x % bh_count;
  const int tile = blockIdx.x / bh_count;
  const int qt = causal ? nq - 1 - tile : tile;
  const int q0 = qt * kThreads;
  const int row = q0 + threadIdx.x;
  const bool live = row < s_len;
  const int64_t base = static_cast<int64_t>(bh) * s_len;

  float qr[D], acc[D];
  flash::load_row<D>(qr, q + (base + row) * D, live);
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;

  // keys this block can see: none past its last query under causal
  const int kend = causal ? min(s_len, q0 + kThreads) : s_len;
  const int nchunks = (kend + CK - 1) / CK;
  for (int c = 0; c < nchunks; ++c) {
    const int ci = reverse_kv ? nchunks - 1 - c : c;
    const int c0 = ci * CK;
    const int rows = min(CK, kend - c0);
    __syncthreads();  // every thread is done with the previous chunk
    flash::load_chunk<D>(ks, k + (base + c0) * D, rows);
    flash::load_chunk<D>(vs, v + (base + c0) * D, rows);
    __syncthreads();
    const int ntiles = (rows + BK - 1) / BK;
    for (int t = 0; t < ntiles; ++t) {
      const int ti = reverse_kv ? ntiles - 1 - t : t;
      const int j0 = c0 + ti * BK;  // the tile's first key
      if (causal && j0 > row) continue;  // wholly above the diagonal
      const float* kt = ks + ti * BK * D;
      const float* vt = vs + ti * BK * D;
      float sc[BK];
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const int key = j0 + j;
        const float sv = flash::dot_row<D>(qr, kt + j * D) * scale;
        const bool masked = key >= kend || (causal && key > row);
        sc[j] = masked ? kNegInf : sv;
        mt = fmaxf(mt, sc[j]);
      }
      const float mn = fmaxf(m, mt);
      const float a = expf(m - mn);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float p = sc[j] <= kMaskedAtOrBelow ? 0.f : expf(sc[j] - mn);
        sc[j] = p;
        ls += p;
      }
      l = l * a + ls;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= a;
#pragma unroll
      for (int j = 0; j < BK; ++j) flash::axpy_row<D>(acc, sc[j], vt + j * D);
      m = mn;
    }
  }
  if (!live) return;
  const int64_t off = (base + row) * D;
  float mk[D];
  if (mask != nullptr) {
    flash::load_row<D>(mk, mask + off, true);
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    acc[d] = acc[d] / l;
    if (mask != nullptr) acc[d] = acc[d] * mk[d];
  }
  flash::store_row<D>(o + off, acc);
  lse[base + row] = m + logf(l);
}

template <int D, int BK>
int launch(const float* q, const float* k, const float* v, const float* mask,
           float* o, float* lse, int64_t bh, int64_t s, float scale,
           int causal, int reverse_kv, cudaStream_t st) {
  const int64_t blocks = bh * flash::blocks_for(s);
  flash_fwd_kernel<D, BK><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      q, k, v, mask, o, lse, static_cast<int>(bh), static_cast<int>(s),
      scale, causal != 0, reverse_kv != 0);
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
  if (s > (int64_t{1} << 30) || bh * flash::blocks_for(s) > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8:
      return launch<8, 64>(q, k, v, mask, o, lse, bh, s, scale, causal,
                           reverse_kv, st);
    case 16:
      return launch<16, 64>(q, k, v, mask, o, lse, bh, s, scale, causal,
                            reverse_kv, st);
    case 32:
      return launch<32, 32>(q, k, v, mask, o, lse, bh, s, scale, causal,
                            reverse_kv, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
