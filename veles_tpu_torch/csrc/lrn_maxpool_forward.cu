// K4: fused LRN -> ceil-mode max pool forward, f32, NHWC.
//
// Replaces: veles_tpu/ops/pallas_kernels.py `_lrn_pool_fwd_kernel`
// (reached through `_lrn_pool_call` / `lrn_maxpool_pallas`), the TPU
// kernel that loads whole (H, W, C) sample bands into VMEM, normalises
// them and pools them there, writing only the pooled output.
//
// Bound on the H100: device-memory bytes. The function must read x once
// and write the pooled output once (about a quarter of x for a 3x3/2 pool);
// the LRN arithmetic, even recomputed per window tap, stays far below the
// card's f32 rate.
//
// Design: one thread per pooled output (n, oh, ow, c), channels fastest,
// so a warp reads contiguous channel runs of each tap's pixel. For each of
// the ky*kx taps that lies inside H x W it computes the LRN value with
// lrn_common.cuh (the very arithmetic of the LRN kernel, so the two
// paths pool identical values) and keeps the maximum. Taps past the edge
// of a ceil-mode window count as -inf, as the TPU kernel's -inf padding
// makes them. The maximum propagates NaN like jnp.maximum (fmaxf would
// drop it). Overlapping 3x3/2 windows recompute each LRN value about
// 2.25 times and re-read x through L1/L2 rather than device memory;
// staging a sample band in shared memory is later work.
#include <cstdint>

#include <math_constants.h>

#include "lrn_common.cuh"

namespace {

__global__ void lrn_maxpool_forward_kernel(
    const float* __restrict__ x, float* __restrict__ y, int64_t total, int H,
    int W, int C, int OH, int OW, int ky, int kx, int sy, int sx, int half,
    float k, float alpha, int q, float beta) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    int64_t r = i;
    const int c = static_cast<int>(r % C);
    r /= C;
    const int ow = static_cast<int>(r % OW);
    r /= OW;
    const int oh = static_cast<int>(r % OH);
    const int64_t n = r / OH;
    const float* sample = x + n * H * W * static_cast<int64_t>(C);
    float m = -CUDART_INF_F;
    for (int dy = 0; dy < ky; ++dy) {
      const int ih = oh * sy + dy;
      if (ih >= H) break;
      for (int dx = 0; dx < kx; ++dx) {
        const int iw = ow * sx + dx;
        if (iw >= W) break;
        const float v =
            lrn_value(sample + (static_cast<int64_t>(ih) * W + iw) * C, c, C,
                      half, k, alpha, q, beta);
        if (v > m || isnan(v)) m = isnan(m) ? m : v;
      }
    }
    y[i] = m;
  }
}

}  // namespace

extern "C" int lrn_maxpool_forward_f32(const float* x, float* y, int64_t n,
                                       int H, int W, int C, int OH, int OW,
                                       int ky, int kx, int sy, int sx,
                                       int half, float k, float alpha, int q,
                                       float beta, void* stream) {
  const int64_t total = n * OH * OW * static_cast<int64_t>(C);
  if (total > 0) {
    const int threads = 256;
    int64_t blocks = (total + threads - 1) / threads;
    if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
    lrn_maxpool_forward_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        x, y, total, H, W, C, OH, OW, ky, kx, sy, sx, half, k, alpha, q,
        beta);
  }
  return static_cast<int>(cudaGetLastError());
}
