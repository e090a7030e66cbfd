// K5: fused LRN -> ceil-mode max pool backward, NHWC, f32 or bf16 in
// device memory, f32 arithmetic.
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
// and the routing cost fewer operations than the card's f32 rate allows
// for those bytes. (Measured, it runs at several times that bound, bound
// by the issue of its per-element arithmetic: PERF.md.)
//
// Design: two launches, each staging a block's band of x in shared
// memory by cp.async, so that every LRN scale, power and division is
// computed about once per launch; no atomics (blocks run in no order, so
// nothing may carry a sum across them the way the TPU grid carries VMEM)
// and no scratch of x's size.
//   1. route (lrn_pool_route_kernel). A block is (band of RB pooled rows x
//      CB pooled columns, tile of CT channels, sample). It stages x over
//      the band's input rows [oh0*sy, (oh1-1)*sy + ky) and columns
//      (clipped to the input) at channels [c0-half, c0+CT+half), zero
//      outside [0, C); computes y = x*s^(-beta) once per staged element
//      of the CT channels (lrn_value_staged: the forward kernels'
//      arithmetic, so it routes among exactly the values K4 pooled); then
//      each thread scans a pooled output's ky*kx taps in scan order (dy,
//      then dx) and records the first that holds the maximum (strict >:
//      post-ReLU zeros tie constantly). A NaN makes the window's max NaN,
//      which equals no tap, so that window's gradient goes nowhere, as in
//      the JAX kernel; taps past the edge never win. The record is one
//      byte per pooled output (255: no tap), in (n, OH, OW, C) order.
//   2. gather + LRN backward (lrn_pool_grad_kernel). A block is (tile of
//      RI owned input rows x WI owned columns, CT channels, sample); the
//      tiles partition the input, the last along each axis taking what is
//      left. It stages x at channels [c0-2*half, c0+CT+2*half), and the
//      pooled gradient g and the tap record of every pooled row and column
//      whose window covers the tile at [c0-half, c0+CT+half) (the record
//      as whole 4-byte words when C % 4 == 0). For each owned pixel and
//      each channel of [c0-half, c0+CT+half) it computes, once: s, d =
//      s^(-beta), g_lrn (the gradients of the covering windows that chose
//      this tap, summed from 0 in tap order, dy then dx ascending, through
//      a per-row and per-column table of covering windows) and t =
//      ((g_lrn*x)*d)/s, 0 outside [0, C). Then dx = g_lrn*d - (c2*x)*W(t)
//      at the CT channels (lrn_window_staged), written straight to device
//      memory.
// Every operation is lrn_common.cuh's, in the same order, so the result
// is bit-equal to the plain version, as the three-launch design before it
// was.
//
// Shared memory, per block (floats unless said):
//   launch 1: x [rows][cols][CT + 2*half], y [rows][cols][CT], with rows
//     = (RB-1)*sy + ky and cols = (CB-1)*sx + kx at most;
//   launch 2: x [RI][WI][CT + 4*half], t [RI][WI][CT + 2*half], g_lrn*d
//     [RI][WI][CT], g [PR][PC][CT + 2*half], the tap record (bytes, up to
//     8 more a pixel for whole words) likewise, and per owned row and
//     column its first covering tap, that window and the count (ints);
//     PR, PC the covering pooled rows and columns. s, d and g_lrn stay in
//     registers.
// Tiles: CT = 32 channels (a warp's lanes on 32 neighbouring channels of
// one NHWC pixel), RB = 2 pooled rows and RI = 4 input rows across the
// whole width, each shrunk (RB or RI first, then the width, then CT) until
// a block needs at most kSmemTarget bytes; 512 threads a block where at
// most two blocks fit an SM, else 256. At AlexNet's layer 1 (55x55x96)
// launch 1 takes 74,800 bytes and launch 2 (3 rows) 87,204. Recomputation:
// launch 1 computes y for ((RB-1)*sy + ky)/(RB*sy) of the rows (AlexNet:
// 5/4), launch 2 s, d and t for (CT + 2*half)/CT of the channels (36/32).
// The bands of one channel tile and sample are adjacent in launch order,
// so the halo rows a neighbour reads again are still in L2. AlexNet's
// (half 2, 4*beta 3, 3x3 windows, stride 2) runs an instance with those
// as compile-time constants; any other geometry a generic one, which the
// caller may also ask for at AlexNet's (`generic`), to time what the
// constants buy.
//
// bf16 (the JAX kernel's io_dtype="native" under a bf16 step): x, the
// pooled gradient and dx in bf16, the same tiles and arithmetic in f32.
// The route compares the f32 LRN values, as the JAX kernel does after
// promoting its block; the tap record is the same bytes; each dx is
// rounded once to bf16. Staging loads and converts each element into the
// f32 tiles (lrn_common.cuh's bf16 stage: 2-byte loads) instead of
// cp.async, which cannot convert, so the shared-memory layout and every
// index stay the f32 instance's, and the f32 instance's statements are
// unchanged.
#include <algorithm>
#include <climits>
#include <cstdint>

#include <math_constants.h>

#include "lrn_common.cuh"
#include "lrn_pool_common.cuh"

namespace {

constexpr uint8_t kNoTap = 255;
constexpr int kThreads = 256;
constexpr int kCT = 32;
constexpr int kRB = 2;
constexpr int kRI = 4;
constexpr size_t kSmemTarget = 100 * 1024;
constexpr int kMaxGridZ = 65535;  // samples beyond this loop

// Launch 1. Grid: (bands of rb pooled rows x cb pooled columns, channel
// tiles of ct, samples); offsets inside a sample are 32-bit (the host
// refuses a sample of 2^31 elements or more).
// T is device memory's element type: float or __nv_bfloat16.
template <typename T, int kHalf, int kQ, int kKY, int kKX, int kSY, int kSX>
__global__ void __launch_bounds__(512) lrn_pool_route_kernel(
    const T* __restrict__ x, uint8_t* __restrict__ win, Geom p, int n,
    int rb, int cb, int ct, int n_cb, float k, float alpha, float beta) {
  extern __shared__ float4 smem4[];
  const Shape<kHalf, kQ, kKY, kKX, kSY, kSX> sh(p);
  const int cte = ct + 2 * sh.half;
  const int br = blockIdx.x / n_cb, bc = blockIdx.x - br * n_cb;
  const int c0 = blockIdx.y * ct;
  const int oh0 = br * rb, oh1 = min(oh0 + rb, p.OH);
  const int ow0 = bc * cb, ow1 = min(ow0 + cb, p.OW);
  const int ih0 = oh0 * sh.sy, iw0 = ow0 * sh.sx;
  // staged input rows and columns (none where a ceil-mode window lies
  // wholly past the edge)
  const int nr = max(0, min((oh1 - 1) * sh.sy + sh.ky, p.H) - ih0);
  const int nc = max(0, min((ow1 - 1) * sh.sx + sh.kx, p.W) - iw0);
  float* const xs = reinterpret_cast<float*>(smem4);  // [nr][nc][cte]
  float* const ys = xs + nr * nc * cte;                // [nr][nc][ct]
  const int64_t sample = static_cast<int64_t>(p.H) * p.W * p.C;
  const int64_t pooled = static_cast<int64_t>(p.OH) * p.OW * p.C;
  for (int ni = blockIdx.z; ni < n; ni += gridDim.z) {
    const T* xn = x + ni * sample;
    uint8_t* wn = win + ni * pooled;
    if (nr > 0 && nc > 0) {
      for (Walk w(threadIdx.x, blockDim.x, nc, cte); w.i0 < nr; w.next()) {
        const int c = c0 - sh.half + w.i2;
        const bool in = c >= 0 && c < p.C;
        stage(xs + w.i,
              in ? xn + ((ih0 + w.i0) * p.W + iw0 + w.i1) * p.C + c : x,
              in);
      }
      stage_wait();
      __syncthreads();
      // channels past C get values no one reads
      for (Walk w(threadIdx.x, blockDim.x, nc, ct); w.i0 < nr; w.next())
        ys[w.i] = lrn_value_staged(
            xs + (w.i0 * nc + w.i1) * cte + sh.half + w.i2, sh.half, k,
            alpha, sh.q, beta);
      __syncthreads();
    }
    for (Walk w(threadIdx.x, blockDim.x, ow1 - ow0, ct); w.i0 < oh1 - oh0;
         w.next()) {
      const int c = c0 + w.i2;
      if (c >= p.C) continue;
      const int oh = oh0 + w.i0, ow = ow0 + w.i1;
      float m = -CUDART_INF_F;
      int best = kNoTap;
      bool nan = false;
#pragma unroll
      for (int dy = 0; dy < sh.ky; ++dy) {
        const int ih = oh * sh.sy + dy;
        if (ih >= p.H) break;
        const float* yrow = ys + (ih - ih0) * nc * ct + w.i2;
#pragma unroll
        for (int dx = 0; dx < sh.kx; ++dx) {
          const int iw = ow * sh.sx + dx;
          if (iw >= p.W) break;
          const float v = yrow[(iw - iw0) * ct];
          if (isnan(v)) {
            nan = true;
          } else if (v > m) {  // strict: a tie keeps the earlier tap
            m = v;
            best = dy * sh.kx + dx;
          }
        }
      }
      wn[(oh * p.OW + ow) * p.C + c] =
          static_cast<uint8_t>(nan ? kNoTap : best);
    }
    __syncthreads();  // the next sample's staging overwrites xs and ys
  }
}

// Launch 2. Grid: (tiles of ri owned input rows x wi columns, channel
// tiles of ct, samples).
// T is device memory's element type: float or __nv_bfloat16.
template <typename T, int kHalf, int kQ, int kKY, int kKX, int kSY, int kSX>
__global__ void __launch_bounds__(512) lrn_pool_grad_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const uint8_t* __restrict__ win, T* __restrict__ dx, Geom p, int n,
    int ri, int wi, int ct, int pr, int pc, int n_wi, float k, float alpha,
    float beta, float c2) {
  extern __shared__ float4 smem4[];
  const Shape<kHalf, kQ, kKY, kKX, kSY, kSX> sh(p);
  const int h = sh.half;
  const int ctx = ct + 4 * h, cte = ct + 2 * h;
  float* const xs = reinterpret_cast<float*>(smem4);  // [ri][wi][ctx]
  float* const ts = xs + ri * wi * ctx;                // [ri][wi][cte]
  float* const gd = ts + ri * wi * cte;                // [ri][wi][ct]
  float* const gs = gd + ri * wi * ct;                 // [pr][pc][cte]
  // per owned row, then per owned column: the first covering tap (dy or
  // dx), its pooled row or column less the first staged one, the count
  int* const tab = reinterpret_cast<int*>(gs + pr * pc * cte);
  // the tap record at channels [wlo, wlo + wst), covering those of gs:
  // whole 4-byte words copied like the floats when C % 4 == 0 (every word
  // then lies wholly inside or outside [0, C)), else bytes
  uint8_t* const ws = reinterpret_cast<uint8_t*>(tab + 3 * (ri + wi));
  const bool words = p.C % 4 == 0;
  const int wlo = words ? (blockIdx.y * ct - h) & ~3 : blockIdx.y * ct - h;
  const int wst =
      words ? ((blockIdx.y * ct + ct + h + 3) & ~3) - wlo : cte;
  const int woff = blockIdx.y * ct - h - wlo;
  const int br = blockIdx.x / n_wi, bc = blockIdx.x - br * n_wi;
  const int c0 = blockIdx.y * ct;
  const int r0 = br * ri, nr = min(ri, p.H - r0);
  const int q0 = bc * wi, nc = min(wi, p.W - q0);
  // pooled rows whose window [oh*sy, oh*sy + ky) meets [r0, r0 + nr)
  const int p0 = max(0, floor_div(r0 - sh.ky, sh.sy) + 1);
  const int npr = max(0, min(p.OH, (r0 + nr - 1) / sh.sy + 1) - p0);
  const int u0 = max(0, floor_div(q0 - sh.kx, sh.sx) + 1);
  const int npc = max(0, min(p.OW, (q0 + nc - 1) / sh.sx + 1) - u0);
  for (int i = threadIdx.x; i < nr + nc; i += blockDim.x) {
    // the windows covering input row (or column) v, in ascending tap
    // order: tap v % s of window v / s, then tap + s of window - 1, ...
    const bool row = i < nr;
    const int v = row ? r0 + i : q0 + i - nr;
    const int s = row ? sh.sy : sh.sx, kk = row ? sh.ky : sh.kx;
    const int lim = row ? p.OH : p.OW, base = row ? p0 : u0;
    int tap = v % s, o = v / s;
    if (o >= lim) {  // windows past the last: skip them
      tap += (o - lim + 1) * s;
      o = lim - 1;
    }
    const int cnt = tap < kk ? min((kk - 1 - tap) / s + 1, o + 1) : 0;
    int* const t = tab + 3 * i;
    t[0] = tap;
    t[1] = o - base;
    t[2] = cnt;
  }
  const int64_t sample = static_cast<int64_t>(p.H) * p.W * p.C;
  const int64_t pooled = static_cast<int64_t>(p.OH) * p.OW * p.C;
  for (int ni = blockIdx.z; ni < n; ni += gridDim.z) {
    const T* xn = x + ni * sample;
    for (Walk w(threadIdx.x, blockDim.x, nc, ctx); w.i0 < nr; w.next()) {
      const int c = c0 - 2 * h + w.i2;
      const bool in = c >= 0 && c < p.C;
      stage(xs + w.i,
            in ? xn + ((r0 + w.i0) * p.W + q0 + w.i1) * p.C + c : x, in);
    }
    if (npr > 0 && npc > 0) {
      const T* gn = g + ni * pooled;
      const uint8_t* wn = win + ni * pooled;
      for (Walk w(threadIdx.x, blockDim.x, npc, cte); w.i0 < npr;
           w.next()) {
        const int c = c0 - h + w.i2;
        const bool in = c >= 0 && c < p.C;
        stage(gs + w.i,
              in ? gn + ((p0 + w.i0) * p.OW + u0 + w.i1) * p.C + c : g, in);
      }
      if (words) {
        for (Walk w(threadIdx.x, blockDim.x, npc, wst / 4); w.i0 < npr;
             w.next()) {
          const int c = wlo + 4 * w.i2;
          const bool in = c >= 0 && c < p.C;
          stage(ws + 4 * w.i,
                in ? wn + ((p0 + w.i0) * p.OW + u0 + w.i1) * p.C + c : wn,
                in);
        }
      } else {  // plain loads, while the copies are in flight
        for (Walk w(threadIdx.x, blockDim.x, npc, wst); w.i0 < npr;
             w.next()) {
          const int c = wlo + w.i2;
          ws[w.i] = (c >= 0 && c < p.C)
                        ? wn[((p0 + w.i0) * p.OW + u0 + w.i1) * p.C + c]
                        : kNoTap;
        }
      }
    }
    stage_wait();
    __syncthreads();
    // Every index stays inside the staged tiles; a channel outside [0, C)
    // gets t = 0, as the plain version's window sum adds there.
    for (Walk w(threadIdx.x, blockDim.x, nc, cte); w.i0 < nr; w.next()) {
      const float* xc = xs + (w.i0 * nc + w.i1) * ctx + h + w.i2;
      const float s = lrn_scale_staged(xc, h, k, alpha);
      const float d = lrn_pow_neg(s, sh.q, beta);
      const int* rtab = tab + 3 * w.i0;
      const int* ctab = tab + 3 * (nr + w.i1);
      float acc = 0.0f;
#pragma unroll
      for (int a = 0; a < sh.cy; ++a) {
        if (a >= rtab[2]) break;
        const int dy = rtab[0] + a * sh.sy;
        const uint8_t* wrow = ws + (rtab[1] - a) * npc * wst + woff + w.i2;
        const float* grow = gs + (rtab[1] - a) * npc * cte + w.i2;
#pragma unroll
        for (int b = 0; b < sh.cx; ++b) {
          if (b >= ctab[2]) break;
          const int col = ctab[1] - b;
          if (wrow[col * wst] == dy * sh.kx + ctab[0] + b * sh.sx)
            acc = __fadd_rn(acc, grow[col * cte]);
        }
      }
      const int c = c0 - h + w.i2;
      ts[w.i] = c >= 0 && c < p.C ? lrn_grad_term(acc, xc[0], s, d) : 0.0f;
      if (w.i2 >= h && w.i2 < h + ct)
        gd[(w.i0 * nc + w.i1) * ct + w.i2 - h] = __fmul_rn(acc, d);
    }
    __syncthreads();
    T* dxn = dx + ni * sample;
    for (Walk w(threadIdx.x, blockDim.x, nc, ct); w.i0 < nr; w.next()) {
      const int c = c0 + w.i2;
      if (c >= p.C) continue;
      const int px = w.i0 * nc + w.i1;
      const float tsum = lrn_window_staged(ts + px * cte + h + w.i2, h);
      const float xv = xs[px * ctx + 2 * h + w.i2];
      dxn[((r0 + w.i0) * p.W + q0 + w.i1) * p.C + c] =
          __fsub_rn(gd[w.i], __fmul_rn(__fmul_rn(c2, xv), tsum));
    }
    __syncthreads();  // the next sample's staging overwrites the tiles
  }
}

size_t route_smem(const Geom& p, int rb, int cb, int ct) {
  const size_t rows = std::min((rb - 1) * p.sy + p.ky, p.H);
  const size_t cols = std::min((cb - 1) * p.sx + p.kx, p.W);
  return rows * cols * (2 * ct + 2 * p.half) * sizeof(float);
}

// covering pooled rows (or columns) of `owned` input rows, at most
int covering(int owned, int kk, int s, int lim) {
  return std::min((owned + kk - 2) / s + 1, lim);
}

size_t grad_smem(const Geom& p, int ri, int wi, int ct) {
  const size_t px = static_cast<size_t>(ri) * wi;
  const size_t pooled = static_cast<size_t>(covering(ri, p.ky, p.sy, p.OH)) *
                        covering(wi, p.kx, p.sx, p.OW);
  const size_t cte = ct + 2 * p.half;
  return (px * (3 * ct + 6 * p.half) + pooled * cte) * sizeof(float) +
         3 * (ri + wi) * sizeof(int) + pooled * (cte + 8);
}

// Shrink (band, width, channels) until a block needs at most
// kSmemTarget bytes, or nothing is left to shrink.
template <typename F>
void fit(int* band, int* width, int* ct, F smem) {
  while (smem(*band, *width, *ct) > kSmemTarget) {
    if (*band > 1)
      --*band;
    else if (*width > 1)
      *width = (*width + 1) / 2;
    else if (*ct > 1)
      *ct = (*ct + 1) / 2;
    else
      return;
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// 512 threads where at most two blocks of `smem` bytes fit an SM, else
// 256: about 32 warps on an SM either way.
int threads_for(size_t smem, int sm_smem) {
  return sm_smem / static_cast<int>(smem + 1024) <= 2 ? 512 : kThreads;
}

template <int kHalf, int kQ, int kKY, int kKX, int kSY, int kSX, typename T>
cudaError_t launch(const T* x, const T* g, T* dx, uint8_t* win, int n,
                   const Geom& p, float k, float alpha, float beta, float c2,
                   cudaStream_t st) {
  auto* route = lrn_pool_route_kernel<T, kHalf, kQ, kKY, kKX, kSY, kSX>;
  auto* grad = lrn_pool_grad_kernel<T, kHalf, kQ, kKY, kKX, kSY, kSX>;
  int dev = 0, optin = 0, sm_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  // both kernels may take up to the card's opt-in shared memory per
  // block: once per device, process and instance
  static bool allowed[64] = {};
  if (err == cudaSuccess && !(dev < 64 && allowed[dev])) {
    err = cudaFuncSetAttribute(
        route, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          grad, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess && dev < 64) allowed[dev] = true;
  }
  if (err != cudaSuccess) return err;

  int rb = std::min(kRB, p.OH), cb = p.OW, ct1 = std::min(kCT, p.C);
  fit(&rb, &cb, &ct1,
      [&](int a, int b, int c) { return route_smem(p, a, b, c); });
  int ri = std::min(kRI, p.H), wi = p.W, ct2 = std::min(kCT, p.C);
  fit(&ri, &wi, &ct2,
      [&](int a, int b, int c) { return grad_smem(p, a, b, c); });
  const size_t smem1 = route_smem(p, rb, cb, ct1);
  const size_t smem2 = grad_smem(p, ri, wi, ct2);
  if (smem1 > static_cast<size_t>(optin) ||
      smem2 > static_cast<size_t>(optin) || ceil_div(p.C, ct1) > 65535 ||
      ceil_div(p.C, ct2) > 65535)
    return cudaErrorInvalidValue;
  const int n_cb = ceil_div(p.OW, cb), n_wi = ceil_div(p.W, wi);
  const unsigned z = static_cast<unsigned>(std::min(n, kMaxGridZ));
  const dim3 grid1(ceil_div(p.OH, rb) * n_cb, ceil_div(p.C, ct1), z);
  route<<<grid1, threads_for(smem1, sm_smem), smem1, st>>>(
      x, win, p, n, rb, cb, ct1, n_cb, k, alpha, beta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid2(ceil_div(p.H, ri) * n_wi, ceil_div(p.C, ct2), z);
  grad<<<grid2, threads_for(smem2, sm_smem), smem2, st>>>(
      x, g, win, dx, p, n, ri, wi, ct2, covering(ri, p.ky, p.sy, p.OH),
      covering(wi, p.kx, p.sx, p.OW), n_wi, k, alpha, beta, c2);
  return cudaGetLastError();
}

template <typename T>
int entry(const T* x, const T* g, T* dx, uint8_t* win, int64_t n, int H,
          int W, int C, int OH, int OW, int ky, int kx, int sy, int sx,
          int half, float k, float alpha, int q, float beta, float c2,
          int generic, void* stream) {
  if (n * H * W * static_cast<int64_t>(C) == 0) return cudaSuccess;
  if (static_cast<int64_t>(H) * W * C > INT_MAX || n > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom p{H, W, C, OH, OW, ky, kx, sy, sx, half, q};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nn = static_cast<int>(n);
  const cudaError_t err =
      !generic && half == 2 && q == 3 && ky == 3 && kx == 3 && sy == 2 &&
              sx == 2
          ? launch<2, 3, 3, 3, 2, 2>(x, g, dx, win, nn, p, k, alpha, beta,
                                     c2, st)
          : launch<-1, -1, -1, -1, -1, -1>(x, g, dx, win, nn, p, k, alpha,
                                           beta, c2, st);
  return static_cast<int>(err);
}

}  // namespace

// `win` (n*OH*OW*C bytes) is scratch the caller allocates; `generic`
// nonzero takes the generic instance at any geometry. A sample of
// 2^31 elements or more, more than 65535 channel tiles, or a geometry
// whose smallest tiles still exceed the card's shared memory per block
// returns cudaErrorInvalidValue.
extern "C" int lrn_maxpool_backward_f32(
    const float* x, const float* g, float* dx, uint8_t* win, int64_t n,
    int H, int W, int C, int OH, int OW, int ky, int kx, int sy, int sx,
    int half, float k, float alpha, int q, float beta, float c2,
    int generic, void* stream) {
  return entry(x, g, dx, win, n, H, W, C, OH, OW, ky, kx, sy, sx, half, k,
               alpha, q, beta, c2, generic, stream);
}

// The same with bf16 x, g and dx (f32 arithmetic, each dx rounded once).
extern "C" int lrn_maxpool_backward_bf16(
    const __nv_bfloat16* x, const __nv_bfloat16* g, __nv_bfloat16* dx,
    uint8_t* win, int64_t n, int H, int W, int C, int OH, int OW, int ky,
    int kx, int sy, int sx, int half, float k, float alpha, int q,
    float beta, float c2, int generic, void* stream) {
  return entry(x, g, dx, win, n, H, W, C, OH, OW, ky, kx, sy, sx, half, k,
               alpha, q, beta, c2, generic, stream);
}
