// K5: fused LRN -> ceil-mode max pool backward, f32, NHWC.
//
// Replaces: veles_tpu/ops/pallas_kernels.py `_lrn_pool_bwd_kernel`
// (reached through `_lrn_pool_bwd_rule`, the backward half of the custom
// VJP `lrn_maxpool_pallas`), the TPU kernel that, on a sample band resident
// in VMEM, recomputes the LRN output, routes the pooled gradient to each
// window's FIRST max in scan order (dilate + place, no scatter), and
// applies the closed-form LRN backward.
//
// Bound on the H100: device-memory bytes. The function must read x and
// the pooled gradient once and write dx once; the recomputed LRN values
// and the routing cost far fewer operations than the card's f32 rate
// allows for those bytes.
//
// Design: three launches, no atomics (blocks run in no order, so nothing
// may carry a sum across them the way the TPU grid carries VMEM):
//   1. route: one thread per pooled output (n, oh, ow, c) recomputes its
//      window's LRN values with lrn_value (the arithmetic of the forward
//      kernels, so it routes among exactly the values K4 pooled) and
//      records the first tap, in scan order (dy, then dx), that holds the
//      maximum. Ties keep the first: post-ReLU zeros tie constantly.
//      A NaN makes the window's max NaN, which equals no tap, so that
//      window's gradient goes nowhere, as in the JAX kernel. Taps past the
//      edge are -inf there and never win (tap (0, 0) is always inside).
//   2. gather: one thread per input element sums the gradients of the
//      (at most ceil(ky/sy) x ceil(kx/sx)) windows that cover it and chose
//      it, in the JAX kernel's tap order (dy, dx ascending), into an f32
//      scratch g_lrn the size of x.
//   3. the LRN backward (lrn_grad, K3's body) on (x, g_lrn).
// The tap record is one byte per pooled output (255: no tap).
#include <cstdint>

#include <math_constants.h>

#include "lrn_common.cuh"

namespace {

constexpr uint8_t kNoTap = 255;

__global__ void lrn_pool_route_kernel(const float* __restrict__ x,
                                      uint8_t* __restrict__ win,
                                      int64_t total, int H, int W, int C,
                                      int OH, int OW, int ky, int kx, int sy,
                                      int sx, int half, float k, float alpha,
                                      int q, float beta) {
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
    int best = kNoTap;
    bool nan = false;
    for (int dy = 0; dy < ky; ++dy) {
      const int ih = oh * sy + dy;
      if (ih >= H) break;
      for (int dx = 0; dx < kx; ++dx) {
        const int iw = ow * sx + dx;
        if (iw >= W) break;
        const float v =
            lrn_value(sample + (static_cast<int64_t>(ih) * W + iw) * C, c, C,
                      half, k, alpha, q, beta);
        if (isnan(v)) {
          nan = true;
        } else if (v > m) {  // strict: a tie keeps the earlier tap
          m = v;
          best = dy * kx + dx;
        }
      }
    }
    win[i] = static_cast<uint8_t>(nan ? kNoTap : best);
  }
}

__global__ void lrn_pool_gather_kernel(const float* __restrict__ g,
                                       const uint8_t* __restrict__ win,
                                       float* __restrict__ g_lrn,
                                       int64_t total, int H, int W, int C,
                                       int OH, int OW, int ky, int kx, int sy,
                                       int sx) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    int64_t r = i;
    const int c = static_cast<int>(r % C);
    r /= C;
    const int iw = static_cast<int>(r % W);
    r /= W;
    const int ih = static_cast<int>(r % H);
    const int64_t n = r / H;
    float acc = 0.0f;
    for (int dy = 0; dy < ky; ++dy) {
      const int th = ih - dy;
      if (th < 0) break;
      if (th % sy) continue;
      const int oh = th / sy;
      if (oh >= OH) continue;
      for (int dx = 0; dx < kx; ++dx) {
        const int tw = iw - dx;
        if (tw < 0) break;
        if (tw % sx) continue;
        const int ow = tw / sx;
        if (ow >= OW) continue;
        const int64_t o = ((n * OH + oh) * OW + ow) * C + c;
        if (win[o] == dy * kx + dx) acc = __fadd_rn(acc, __ldg(g + o));
      }
    }
    g_lrn[i] = acc;
  }
}

__global__ void lrn_pool_grad_kernel(const float* __restrict__ x,
                                     const float* __restrict__ g_lrn,
                                     float* __restrict__ dx, int64_t total,
                                     int C, int half, float k, float alpha,
                                     int q, float beta, float c2) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    const int64_t row = i / C;
    const int c = static_cast<int>(i - row * C);
    dx[i] = lrn_grad(x + row * C, g_lrn + row * C, c, C, half, k, alpha, q,
                     beta, c2);
  }
}

unsigned grid_for(int64_t total, int threads) {
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
  return static_cast<unsigned>(blocks);
}

}  // namespace

// `win` (n*OH*OW*C bytes) and `g_lrn` (n*H*W*C floats) are scratch the
// caller allocates.
extern "C" int lrn_maxpool_backward_f32(
    const float* x, const float* g, float* dx, uint8_t* win, float* g_lrn,
    int64_t n, int H, int W, int C, int OH, int OW, int ky, int kx, int sy,
    int sx, int half, float k, float alpha, int q, float beta, float c2,
    void* stream) {
  const int threads = 256;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t pooled = n * OH * OW * static_cast<int64_t>(C);
  const int64_t full = n * H * W * static_cast<int64_t>(C);
  if (pooled > 0) {
    lrn_pool_route_kernel<<<grid_for(pooled, threads), threads, 0, st>>>(
        x, win, pooled, H, W, C, OH, OW, ky, kx, sy, sx, half, k, alpha, q,
        beta);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (full > 0) {
    lrn_pool_gather_kernel<<<grid_for(full, threads), threads, 0, st>>>(
        g, win, g_lrn, full, H, W, C, OH, OW, ky, kx, sy, sx);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    lrn_pool_grad_kernel<<<grid_for(full, threads), threads, 0, st>>>(
        x, g_lrn, dx, full, C, half, k, alpha, q, beta, c2);
  }
  return static_cast<int>(cudaGetLastError());
}
