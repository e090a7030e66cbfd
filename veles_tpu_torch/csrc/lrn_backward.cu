// K3: across-channel LRN backward, f32, on an (rows, C) channels-last view.
//
// Replaces: veles_tpu/ops/pallas_kernels.py `_lrn_bwd_kernel` (reached
// through `lrn_backward_pallas`, the backward half of the custom VJP
// `lrn_pallas`), the TPU kernel that streams (row_tile, C) blocks of x and
// the incoming gradient g through VMEM, recomputes s there, and forms both
// window sums with shifted adds.
//
// Bound on the H100: device-memory bytes. The function must read x and g
// once and write dx once; even recomputed per output, its ~100 float
// operations per element stay below the card's f32 rate over 12 bytes.
//
// Design: one thread per element of the (rows, C) view, neighbouring
// threads on neighbouring channels. dx at channel c needs t = g*x*d/s at
// c-half..c+half, and each of those s its own channel window, so a thread
// reads x at c +- 2*half and g at c +- half: ~35 loads that its
// neighbours make too, served by L1, so device memory sees each byte about
// once. The arithmetic is lrn_grad in lrn_common.cuh, shared with the
// fused LRN->max-pool backward (K5), in the plain version's order. Staging
// a row's x and g in shared memory would cut the repeated loads and the
// 5x recompute of s; that is later work.
#include <cstdint>

#include "lrn_common.cuh"

namespace {

__global__ void lrn_backward_kernel(const float* __restrict__ x,
                                    const float* __restrict__ g,
                                    float* __restrict__ dx, int64_t total,
                                    int C, int half, float k, float alpha,
                                    int q, float beta, float c2) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    const int64_t row = i / C;
    const int c = static_cast<int>(i - row * C);
    dx[i] = lrn_grad(x + row * C, g + row * C, c, C, half, k, alpha, q,
                     beta, c2);
  }
}

}  // namespace

extern "C" int lrn_backward_f32(const float* x, const float* g, float* dx,
                                int64_t rows, int C, int half, float k,
                                float alpha, int q, float beta, float c2,
                                void* stream) {
  const int64_t total = rows * static_cast<int64_t>(C);
  if (total > 0) {
    const int threads = 256;
    int64_t blocks = (total + threads - 1) / threads;
    if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
    lrn_backward_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        x, g, dx, total, C, half, k, alpha, q, beta, c2);
  }
  return static_cast<int>(cudaGetLastError());
}
