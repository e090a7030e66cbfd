// K7: blocked (flash) attention backward, f32, heads-first (B*H, S, D).
//
// Replaces: veles_tpu/ops/pallas_kernels.py `_flash_bwd_pallas`, its two
// TPU kernels `_flash_dq_kernel` (dQ on the forward's grid, KV streamed)
// and `_flash_dkv_kernel` (dK and dV on the transposed grid, the KV tile
// resident while Q and dO tiles stream), the backward half of the custom
// VJP `_flash_attn`. Both recompute the probabilities from the forward's
// saved logsumexp instead of storing them:
//
//   p = exp(s*scale - lse) (0 where the causal mask or S cuts the pair);
//   dS = p * (dO.V^T - D) * scale with D = rowsum(dO*O), computed by the
//   caller; dQ = dS.K; dV = P^T.dO; dK = dS^T.Q.
//
// Bound on the H100: operations. The function needs five products of 2*D
// per (query, key) pair the causal mask keeps (Q.K^T, dO.V^T, P^T.dO,
// dS.K, dS^T.Q), 10*D*S(S+1)/2 per head: 171.8 GFLOP at B*H = 128,
// S = 4096, D = 16 against 239 MB of inputs and outputs. This design
// executes seven (14*D per pair, 240.5 GFLOP): s and dO.v are recomputed
// in both kernels, the price of having no atomics.
//
// Design: two launches, no atomics, so the result does not depend on the
// order in which blocks run (the TPU grid's sequential VMEM carry has no
// counterpart across CUDA blocks):
// 1. dQ: one block of 128 threads per (head, tile of 128 query rows), one
//    query row per thread with q, dO, lse, D and the dQ accumulator in
//    registers; K and V stream through shared memory in chunks of 4096/D
//    rows (broadcast float4 loads). A thread stops at its diagonal; the
//    heaviest (last) query tiles launch first.
// 2. dK/dV: one block of 128 threads per (head, tile of 128 key rows), one
//    key row per thread with k, v and both accumulators in registers; Q,
//    dO, lse and D stream through shared memory from the tile's first key
//    on (earlier queries cannot see it under causal masking); a thread
//    starts at its diagonal. The first key tiles, the heaviest, launch
//    first.
// Any S (ragged last tiles masked by index); D in {8, 16}, the head widths
// the port's workflows run.
#include "flash_common.cuh"

namespace {

using flash::kChunkFloats;
using flash::kThreads;

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, float* __restrict__ dq,
                    int bh_count, int s_len, float scale, bool causal) {
  constexpr int CK = kChunkFloats / D;
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

  float qr[D], dor[D], acc[D];
  flash::load_row<D>(qr, q + (base + row) * D, live);
  flash::load_row<D>(dor, dout + (base + row) * D, live);
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  const float lr = live ? lse[base + row] : 0.f;
  const float dr = live ? di[base + row] : 0.f;

  const int kend = causal ? min(s_len, q0 + kThreads) : s_len;
  // keys this thread sees: up to its own row under causal masking
  const int kmine = causal ? min(kend, row + 1) : kend;
  for (int c0 = 0; c0 < kend; c0 += CK) {
    const int rows = min(CK, kend - c0);
    __syncthreads();
    flash::load_chunk<D>(ks, k + (base + c0) * D, rows);
    flash::load_chunk<D>(vs, v + (base + c0) * D, rows);
    __syncthreads();
    const int jn = min(rows, kmine - c0);
#pragma unroll 2
    for (int j = 0; j < jn; ++j) {
      const float* kj = ks + j * D;
      const float s = flash::dot_row<D>(qr, kj) * scale;
      const float p = expf(s - lr);
      const float dp = flash::dot_row<D>(dor, vs + j * D);
      const float ds = p * (dp - dr) * scale;
      flash::axpy_row<D>(acc, ds, kj);
    }
  }
  if (live) flash::store_row<D>(dq + (base + row) * D, acc);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, float* __restrict__ dk,
                     float* __restrict__ dv, int bh_count, int s_len,
                     float scale, bool causal) {
  constexpr int CQ = kChunkFloats / D;
  __shared__ __align__(16) float qs[kChunkFloats];
  __shared__ __align__(16) float dos[kChunkFloats];
  __shared__ float ls[CQ];
  __shared__ float dis[CQ];

  const int bh = blockIdx.x % bh_count;
  const int kt = blockIdx.x / bh_count;
  const int k0 = kt * kThreads;
  const int krow = k0 + threadIdx.x;
  const bool live = krow < s_len;
  const int64_t base = static_cast<int64_t>(bh) * s_len;

  float kr[D], vr[D], dka[D], dva[D];
  flash::load_row<D>(kr, k + (base + krow) * D, live);
  flash::load_row<D>(vr, v + (base + krow) * D, live);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dka[d] = 0.f;
    dva[d] = 0.f;
  }

  // queries that can see this key tile: from its first key on (causal)
  const int qbeg = causal ? k0 : 0;
  for (int c0 = qbeg; c0 < s_len; c0 += CQ) {
    const int rows = min(CQ, s_len - c0);
    __syncthreads();
    flash::load_chunk<D>(qs, q + (base + c0) * D, rows);
    flash::load_chunk<D>(dos, dout + (base + c0) * D, rows);
    for (int i = threadIdx.x; i < CQ; i += blockDim.x) {
      ls[i] = i < rows ? lse[base + c0 + i] : 0.f;
      dis[i] = i < rows ? di[base + c0 + i] : 0.f;
    }
    __syncthreads();
    // under causal masking this thread's key sees queries >= krow only
    const int ib = causal ? max(0, min(rows, krow - c0)) : 0;
#pragma unroll 2
    for (int i = ib; i < rows; ++i) {
      const float* qi = qs + i * D;
      const float* doi = dos + i * D;
      const float s = flash::dot_row<D>(kr, qi) * scale;
      const float p = expf(s - ls[i]);
      flash::axpy_row<D>(dva, p, doi);
      const float dp = flash::dot_row<D>(vr, doi);
      const float ds = p * (dp - dis[i]) * scale;
      flash::axpy_row<D>(dka, ds, qi);
    }
  }
  if (!live) return;
  flash::store_row<D>(dk + (base + krow) * D, dka);
  flash::store_row<D>(dv + (base + krow) * D, dva);
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* dout,
           const float* lse, const float* di, float* dq, float* dk, float* dv,
           int64_t bh, int64_t s, float scale, int causal, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>(bh * flash::blocks_for(s));
  flash_dq_kernel<D><<<blocks, kThreads, 0, st>>>(
      q, k, v, dout, lse, di, dq, static_cast<int>(bh), static_cast<int>(s),
      scale, causal != 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_dkv_kernel<D><<<blocks, kThreads, 0, st>>>(
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
  if (s > (int64_t{1} << 30) || bh * flash::blocks_for(s) > 0x7fffffff) {
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
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
