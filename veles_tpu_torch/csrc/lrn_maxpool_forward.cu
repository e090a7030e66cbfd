// K4: fused LRN -> ceil-mode max pool forward, NHWC, f32 or bf16 in device
// memory, f32 arithmetic.
//
// Replaces: veles_tpu/ops/pallas_kernels.py `_lrn_pool_fwd_kernel`
// (reached through `_lrn_pool_call` / `lrn_maxpool_pallas`), the TPU
// kernel that loads whole (H, W, C) sample bands into VMEM, normalises
// them and pools them there, writing only the pooled output.
//
// Bound on the H100: device-memory bytes. The function must read x once
// and write the pooled output once (about a quarter of x for a 3x3/2
// pool); its LRN arithmetic, computed once per element, and the window
// maxima stay below the card's f32 rate over those bytes.
//
// Design: the band staging of K5's route launch, writing the maximum
// instead of the tap. A block is (band of RB pooled rows x CB pooled
// columns, tile of 32 channels, sample); the channel tiles of a band are
// adjacent in launch order, so the channel halo one reads again is still
// in L2, and so are the halo rows of the next band. Per block:
//   1. stage by cp.async x over the band's input rows [oh0*sy, (oh1-1)*sy
//      + ky) and columns, clipped to the input, at channels [c0 - xp, c0
//      + 32 + xp), zeros outside [0, C) (xp = half rounded up to 4, so
//      that each staged pixel starts 16-byte aligned); 16-byte copies
//      where C % 4 == 0 and x is 16-byte aligned, else 4-byte ones.
//   2. A warp takes a staged pixel, a lane a channel: y =
//      lrn_value_staged (the LRN kernel's arithmetic, so the two paths
//      pool identical values), once per staged element; after the warp
//      has read its pixel's window (__syncwarp), y goes over x's centre
//      channel, so one array holds both.
//   3. A warp takes a pooled pixel, a lane a channel: the ky*kx taps in
//      scan order from shared memory (unrolled where the window lies
//      inside the input), the maximum stored coalesced. A NaN sticks,
//      as jnp.maximum propagates it (fmaxf would drop it); taps past the
//      edge of a ceil-mode window count as -inf, as the TPU kernel's -inf
//      padding makes them, and a window wholly past the edge gives -inf.
// Tiles: RB = 3 pooled rows x CB = 16 pooled columns at most (AlexNet's
// layer 1: two column tiles, 16 and 11), shrunk until a block fits 48 KB;
// the caller may ask for another band (the kernel search's rb x cb).
// Recomputation: y for ((RB-1)*sy + ky)/(RB*sy) of the rows (AlexNet:
// 7/6) and one column more a column tile. Shared memory: rows x cols x
// (32 + 2*xp) floats, 36,960 bytes at AlexNet's layer 1 (7 x 33 pixels of
// 40); with 45 registers a thread, five blocks of 256 threads share an
// SM. The band's shape and the unrolled window were chosen by timing
// their alternatives on an H100 (PERF.md). AlexNet's (half 2, 4*beta 3, 3x3 windows, stride 2) runs an
// instance with those as compile-time constants; any other geometry a
// generic one, which the caller may also ask for at AlexNet's
// (`generic`), to time what the constants buy.
//
// bf16 (the JAX kernel's io_dtype="native" under a bf16 step): the same
// bands and arithmetic in f32; the window maxima are taken of the f32 LRN
// values and each is rounded once to bf16, which gives the bits of pooling
// the rounded values (rounding is monotone). Staging loads and converts
// into the f32 band (lrn_common.cuh's bf16 stage and stage16: 2-byte
// loads, or 8-byte loads of four channels where C % 4 == 0 and x is 8-byte
// aligned) instead of cp.async, which cannot convert, so the shared-memory
// layout and every index stay the f32 instance's, and the f32 instance's
// statements are unchanged.
#include <algorithm>
#include <climits>
#include <cstdint>

#include <math_constants.h>

#include "lrn_common.cuh"
#include "lrn_pool_common.cuh"

namespace {

constexpr int kThreads = 256;
// blocks an SM must hold: bounds a thread's registers to 48
constexpr int kMinBlocks = 5;
constexpr int kCT = 32;  // channels of a tile: a warp's lanes
constexpr int kRB = 3;   // pooled rows of a band
constexpr int kCB = 16;  // pooled columns of a band, at most
// dynamic shared memory a block may take without opting in
constexpr size_t kSmemMax = 48 * 1024;
constexpr int kMaxGridY = 65535;  // samples beyond this loop

// x's pad either side of a staged pixel's 32 channels: half rounded up
// to 4
__host__ __device__ constexpr int pad_for(int half) {
  return (half + 3) / 4 * 4;
}

// The window maximum so far, m, after tap v: the first NaN sticks, as
// jnp.maximum propagates it (fmaxf would drop it).
__device__ __forceinline__ float pool_max(float m, float v) {
  return (v > m || isnan(v)) && !isnan(m) ? v : m;
}

// Grid: (bands of rb pooled rows x cb pooled columns x channel tiles,
// the channel tile fastest; samples); offsets inside a sample are 32-bit
// (the host refuses a sample of 2^31 elements or more).
// T is device memory's element type: float or __nv_bfloat16.
template <typename T, int kHalf, int kQ, int kKY, int kKX, int kSY, int kSX>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    lrn_maxpool_forward_kernel(const T* __restrict__ x, T* __restrict__ y,
                               Geom p, int n, int rb, int cb, int n_cb,
                               int n_ct, int wide, float k, float alpha,
                               float beta) {
  extern __shared__ float4 smem4[];
  const Shape<kHalf, kQ, kKY, kKX, kSY, kSX> sh(p);
  const int xp = pad_for(sh.half);
  const int xw = kCT + 2 * xp;  // staged floats a pixel
  const int band = blockIdx.x / n_ct;
  const int c0 = (blockIdx.x - band * n_ct) * kCT;
  const int br = band / n_cb, bc = band - br * n_cb;
  const int oh0 = br * rb, oh1 = min(oh0 + rb, p.OH);
  const int ow0 = bc * cb, ow1 = min(ow0 + cb, p.OW);
  const int ih0 = oh0 * sh.sy, iw0 = ow0 * sh.sx;
  // staged input rows and columns (none where a ceil-mode window lies
  // wholly past the edge)
  const int nr = max(0, min((oh1 - 1) * sh.sy + sh.ky, p.H) - ih0);
  const int nc = max(0, min((ow1 - 1) * sh.sx + sh.kx, p.W) - iw0);
  float* const xs = reinterpret_cast<float*>(smem4);  // [nr][nc][xw]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = kThreads / 32;
  const int span = wide ? xw / 4 : xw;  // copies a staged pixel
  const int c = c0 + lane;
  const int64_t sample = static_cast<int64_t>(p.H) * p.W * p.C;
  const int64_t pooled = static_cast<int64_t>(p.OH) * p.OW * p.C;
  for (int ni = blockIdx.y; ni < n; ni += gridDim.y) {
    const T* xn = x + ni * sample;
    // 1. stage x
    if (nr > 0 && nc > 0) {
      for (Walk w(threadIdx.x, kThreads, nc, span); w.i0 < nr; w.next()) {
        const int cc = (wide ? 4 * w.i2 : w.i2) - xp;  // channel less c0
        const bool in = c0 + cc >= 0 && c0 + cc < p.C;
        const T* src =
            in ? xn + ((ih0 + w.i0) * p.W + iw0 + w.i1) * p.C + c0 + cc
               : x;
        float* dst = xs + (w.i0 * nc + w.i1) * xw + xp + cc;
        if (wide)
          stage16(dst, src, in);
        else
          stage(dst, src, in);
      }
    }
    stage_wait();
    __syncthreads();
    // 2. y over x's centre channels; channels past C get values no one
    // reads
    for (int px = warp; px < nr * nc; px += warps) {
      float* const xc = xs + px * xw + xp + lane;
      const float v = lrn_value_staged(xc, sh.half, k, alpha, sh.q, beta);
      __syncwarp();  // the warp has read this pixel's windows
      *xc = v;
    }
    __syncthreads();
    // 3. the window maxima
    T* const yn = y + ni * pooled;
    if (c < p.C) {
      for (Walk w(warp, warps, ow1 - ow0, 1); w.i0 < oh1 - oh0; w.next()) {
        const int oh = oh0 + w.i0, ow = ow0 + w.i1;
        // the window's taps inside the input (none: -inf), in scan order
        const int ny = min(sh.ky, p.H - oh * sh.sy);
        const int nx = min(sh.kx, p.W - ow * sh.sx);
        const float* const yw =
            xs + ((oh * sh.sy - ih0) * nc + ow * sh.sx - iw0) * xw + xp +
            lane;
        float m = -CUDART_INF_F;
        if (ny == sh.ky && nx == sh.kx) {  // unrolled where compiled in
#pragma unroll
          for (int dy = 0; dy < sh.ky; ++dy)
#pragma unroll
            for (int dx = 0; dx < sh.kx; ++dx)
              m = pool_max(m, yw[(dy * nc + dx) * xw]);
        } else {
          for (int dy = 0; dy < ny; ++dy)
            for (int dx = 0; dx < nx; ++dx)
              m = pool_max(m, yw[(dy * nc + dx) * xw]);
        }
        yn[(oh * p.OW + ow) * p.C + c] = m;
      }
    }
    __syncthreads();  // the next sample's staging overwrites xs
  }
}

size_t smem_bytes(const Geom& p, int rb, int cb) {
  const size_t rows = std::min((rb - 1) * p.sy + p.ky, p.H);
  const size_t cols = std::min((cb - 1) * p.sx + p.kx, p.W);
  return rows * cols * (kCT + 2 * pad_for(p.half)) * sizeof(float);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The band (rb pooled rows x cb pooled columns): at most rb0 x cb0 (0:
// kRB, kCB), the band, then the width, shrunk until a block fits
// kSmemMax; false where even one pooled row and column does not, the
// bands outnumber a grid's blocks, or rb0 or cb0 is negative.
bool plan(const Geom& p, int rb0, int cb0, int* rb, int* cb) {
  if (rb0 < 0 || cb0 < 0) return false;
  *rb = std::min(rb0 > 0 ? rb0 : kRB, p.OH);
  *cb = std::min(cb0 > 0 ? cb0 : kCB, p.OW);
  while (smem_bytes(p, *rb, *cb) > kSmemMax && (*rb > 1 || *cb > 1)) {
    if (*rb > 1)
      --*rb;
    else
      *cb = (*cb + 1) / 2;
  }
  return smem_bytes(p, *rb, *cb) <= kSmemMax &&
         static_cast<int64_t>(ceil_div(p.OH, *rb)) * ceil_div(p.OW, *cb) *
                 ceil_div(p.C, kCT) <=
             INT_MAX;
}

template <int kHalf, int kQ, int kKY, int kKX, int kSY, int kSX, typename T>
cudaError_t launch(const T* x, T* y, int n, const Geom& p, bool wide,
                   float k, float alpha, float beta, int rb0, int cb0,
                   cudaStream_t st) {
  int rb = 0, cb = 0;
  if (!plan(p, rb0, cb0, &rb, &cb)) return cudaErrorInvalidValue;
  const int n_cb = ceil_div(p.OW, cb), n_ct = ceil_div(p.C, kCT);
  const dim3 grid(ceil_div(p.OH, rb) * n_cb * n_ct,
                  static_cast<unsigned>(std::min(n, kMaxGridY)));
  auto* kernel =
      lrn_maxpool_forward_kernel<T, kHalf, kQ, kKY, kKX, kSY, kSX>;
  kernel<<<grid, kThreads, smem_bytes(p, rb, cb), st>>>(
      x, y, p, n, rb, cb, n_cb, n_ct, wide, k, alpha, beta);
  return cudaGetLastError();
}

// AlexNet's compile-time instance, or the generic one
bool alexnet(const Geom& p, int generic) {
  return !generic && p.half == 2 && p.q == 3 && p.ky == 3 && p.kx == 3 &&
         p.sy == 2 && p.sx == 2;
}

template <typename T>
int entry(const T* x, T* y, int64_t n, int H, int W, int C, int OH, int OW,
          int ky, int kx, int sy, int sx, int half, float k, float alpha,
          int q, float beta, int generic, int rb, int cb, void* stream) {
  if (n * OH * OW * static_cast<int64_t>(C) == 0) return cudaSuccess;
  if (static_cast<int64_t>(H) * W * C > INT_MAX || n > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom p{H, W, C, OH, OW, ky, kx, sy, sx, half, q};
  // four elements a copy: 16 bytes of f32, 8 of bf16
  const bool wide =
      C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nn = static_cast<int>(n);
  const cudaError_t err =
      alexnet(p, generic)
          ? launch<2, 3, 3, 3, 2, 2>(x, y, nn, p, wide, k, alpha, beta, rb,
                                     cb, st)
          : launch<-1, -1, -1, -1, -1, -1>(x, y, nn, p, wide, k, alpha,
                                           beta, rb, cb, st);
  return static_cast<int>(err);
}

}  // namespace

// `generic` nonzero takes the generic instance at any geometry. `rb`,
// `cb`: the band's pooled rows and columns at most (0: kRB, kCB), the
// kernel search's axes. A sample of 2^31 elements or more, or a window
// whose smallest band (one pooled row and column) exceeds 48 KB of shared
// memory (half above ~600 under 3x3 windows), returns
// cudaErrorInvalidValue.
extern "C" int lrn_maxpool_forward_f32(const float* x, float* y, int64_t n,
                                       int H, int W, int C, int OH, int OW,
                                       int ky, int kx, int sy, int sx,
                                       int half, float k, float alpha, int q,
                                       float beta, int generic, int rb,
                                       int cb, void* stream) {
  return entry(x, y, n, H, W, C, OH, OW, ky, kx, sy, sx, half, k, alpha, q,
               beta, generic, rb, cb, stream);
}

// The same with bf16 x and y (f32 arithmetic, each maximum rounded once).
extern "C" int lrn_maxpool_forward_bf16(const __nv_bfloat16* x,
                                        __nv_bfloat16* y, int64_t n, int H,
                                        int W, int C, int OH, int OW, int ky,
                                        int kx, int sy, int sx, int half,
                                        float k, float alpha, int q,
                                        float beta, int generic, int rb,
                                        int cb, void* stream) {
  return entry(x, y, n, H, W, C, OH, OW, ky, kx, sy, sx, half, k, alpha, q,
               beta, generic, rb, cb, stream);
}

// The dynamic shared memory one block takes at this geometry under bands
// of at most rb0 x cb0 pooled pixels (0: kRB, kCB); -1 where the
// geometry is refused.
extern "C" int lrn_maxpool_forward_smem_bytes(int H, int W, int C, int OH,
                                              int OW, int ky, int kx, int sy,
                                              int sx, int half, int rb0,
                                              int cb0) {
  const Geom p{H, W, C, OH, OW, ky, kx, sy, sx, half, 0};
  int rb = 0, cb = 0;
  return plan(p, rb0, cb0, &rb, &cb)
             ? static_cast<int>(smem_bytes(p, rb, cb))
             : -1;
}
