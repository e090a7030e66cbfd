// K2: across-channel LRN forward, f32, on an (rows, C) channels-last view.
//
// Replaces: veles_tpu/ops/pallas_kernels.py `_lrn_fwd_kernel` (reached
// through `_lrn_call` / `lrn_forward_pallas`), the TPU kernel that streams
// (row_tile, C) blocks through VMEM and forms the window sum with shifted
// adds.
//
// Bound on the H100: device-memory bytes. Each element needs about 2n+5
// float operations (n = 5 for AlexNet), far below the ~20 operations per
// byte at which the card's f32 rate would take over from its 3.35 TB/s
// (SXM); the least time is one read of x and one write of y.
//
// Design: one thread per element of the (rows, C) view, neighbouring
// threads on neighbouring channels, so each warp reads and writes one
// contiguous run of the row. The +-half channel neighbours a thread reads
// are the ones its neighbours read as their own element: those repeats hit
// L1, and device memory sees each byte of x about once. The window sum and
// s^(-beta) live in lrn_common.cuh, shared with the fused LRN->max-pool
// kernel. A later PR can vectorise the loads (float4) and stage the row
// in shared memory; this one is the simple correct kernel.
#include <cstdint>

#include "lrn_common.cuh"

namespace {

__global__ void lrn_forward_kernel(const float* __restrict__ x,
                                   float* __restrict__ y, int64_t total,
                                   int C, int half, float k, float alpha,
                                   int q, float beta) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    const int64_t row = i / C;
    const int c = static_cast<int>(i - row * C);
    y[i] = lrn_value(x + row * C, c, C, half, k, alpha, q, beta);
  }
}

}  // namespace

extern "C" int lrn_forward_f32(const float* x, float* y, int64_t rows, int C,
                               int half, float k, float alpha, int q,
                               float beta, void* stream) {
  const int64_t total = rows * static_cast<int64_t>(C);
  if (total > 0) {
    const int threads = 256;
    int64_t blocks = (total + threads - 1) / threads;
    // grid-stride beyond this: 132 SMs x 16 resident blocks is ~2k, so
    // 1 << 20 blocks keeps every SM fed while staying inside grid limits
    if (blocks > (1 << 20)) blocks = 1 << 20;
    lrn_forward_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        x, y, total, C, half, k, alpha, q, beta);
  }
  return static_cast<int>(cudaGetLastError());
}
