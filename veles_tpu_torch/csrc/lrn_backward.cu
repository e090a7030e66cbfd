// K3: across-channel LRN backward on an (rows, C) channels-last view, f32
// or bf16 in device memory, f32 arithmetic.
//
// Replaces: veles_tpu/ops/pallas_kernels.py `_lrn_bwd_kernel` (reached
// through `lrn_backward_pallas`, the backward half of the custom VJP
// `lrn_pallas`), the TPU kernel that streams (row_tile, C) blocks of x and
// the incoming gradient g through VMEM, recomputes s there, and forms both
// window sums with shifted adds.
//
// Bound on the H100: device-memory bytes. The function must read x and g
// once and write dx once (12 bytes an element); its ~22 float operations
// and one IEEE sqrt, rsqrt and division per element stay below the card's
// f32 rate over those bytes, if each is computed once.
//
// Design: a block takes a tile of rb consecutive rows, each at its full
// width C (AlexNet: 32 rows of 96, 12 of 256), so that no window crosses
// the tile and nothing is computed twice; a row wider than kTile channels
// is cut into runs of kTile channels (blockIdx.y), one row a tile, whose
// halo is recomputed. Per tile:
//   1. stage by cp.async x at channels [c0 - xp, c0 + ct + xp) of each
//      row, zeros outside [0, C) (xp = 2*half rounded up to 4, so that
//      each staged row starts 16-byte aligned), and g at the tile's own
//      elements, one contiguous run; 16-byte copies where C % 4 == 0 and
//      x and g are 16-byte aligned, else 4-byte ones.
//   2. For each own element, once: s (lrn_scale_staged), d = s^(-beta),
//      t = ((g*x)*d)/s into a staged row of t, and g*d over g. t at the
//      half channels either side of the tile: 0 outside [0, C) (whole
//      rows: all of them), else computed the same way from g read there.
//   3. dx = g*d - (c2*x)*W(t), W in the window sums' order, stored
//      coalesced. No atomics, no scratch in device memory.
// Every operation is lrn_common.cuh's, in the same order as the plain
// version's, so dx is bit-equal to it. Latency is hidden by resident
// blocks: a tile takes ~38 KB of shared memory and a thread at most 48
// registers (no per-element state is kept in registers across the
// barriers), so five blocks of 256 threads share an SM, each loading while
// another computes. The tile's size, the blocks an SM must hold and the
// 16-byte copies were chosen by timing their alternatives on an H100
// (PERF.md). AlexNet's half = 2 and 4*beta = 3 run an instance with them
// as compile-time constants; any other geometry a generic one, which the
// caller may also ask for at AlexNet's (`generic`), to time what the
// constants buy.
//
// bf16 (the JAX kernel's io_dtype="native" under a bf16 step): x, g and dx
// in bf16, the same tiles, staged rows and arithmetic in f32, each dx
// rounded once to bf16. Staging loads and converts into the f32 rows
// (lrn_common.cuh's bf16 stage and stage16: 2-byte loads, or 8-byte loads
// of four channels where C % 4 == 0 and x and g are 8-byte aligned)
// instead of cp.async, which cannot convert, so the shared-memory layout
// and every index stay the f32 instance's, and the f32 instance's
// statements are unchanged.
#include <algorithm>
#include <climits>
#include <cstdint>

#include "lrn_common.cuh"
#include "lrn_rows_common.cuh"

namespace {

constexpr int kThreads = 256;
// blocks an SM must hold: bounds a thread's registers to 48
constexpr int kMinBlocks = 5;
// own elements of one tile at most: whole rows of C <= kTile channels,
// else one row's run of kTile channels (a multiple of 4)
constexpr int kTile = 3072;
// dynamic shared memory a block may take without opting in
constexpr size_t kSmemMax = 48 * 1024;
constexpr int kMaxGridY = 65535;  // channel tiles a row, at most

// T is device memory's element type: float or __nv_bfloat16.
template <typename T, int kHalf, int kQ>
__global__ void __launch_bounds__(kThreads, kMinBlocks) lrn_backward_kernel(
    const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
    Geom p, float k, float alpha, float beta, float c2) {
  extern __shared__ float4 smem4[];
  const int h = kHalf >= 0 ? kHalf : p.half;
  const int q = kQ >= 0 ? kQ : p.q;
  float* const xs = reinterpret_cast<float*>(smem4);  // [rb][xw]
  float* const gs = xs + p.rb * p.xw;  // [rb * ct]: g, then g*d
  float* const ts = gs + p.rb * p.ct;  // [rb][tw]
  const Walk own(threadIdx.x, kThreads, p.ct);  // own elements: (rb, ct)
  const int span = p.wide ? p.xw / 4 : p.xw;    // copies a staged row
  const Walk copies(threadIdx.x, kThreads, span);
  const int c0 = blockIdx.y * p.ct;  // the tile's first channel
  const int nc = min(p.ct, p.C - c0);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * p.rb;
  const int nr =
      p.rows - row0 < p.rb ? static_cast<int>(p.rows - row0) : p.rb;
  // own elements: nr whole rows, or one row's run of nc channels, one
  // contiguous run either way, flat index i = r*ct + c
  const int n_own = nr * nc;
  // the tile's first element in x, g and dx
  const T* const xt = x + row0 * p.C + c0;
  const T* const gt = g + row0 * p.C + c0;
  T* const dt = dx + row0 * p.C + c0;
  // 1. stage x and g
  for (Walk w = copies; w.r < nr; w.next()) {
    const int cc = (p.wide ? 4 * w.c : w.c) - p.xp;  // channel less c0
    const bool in = c0 + cc >= 0 && c0 + cc < p.C;
    const T* src = in ? xt + w.r * p.C + cc : x;
    float* dst = xs + w.r * p.xw + p.xp + cc;
    if (p.wide)
      stage16(dst, src, in);
    else
      stage(dst, src, in);
  }
  if (p.wide)
    for (int i = 4 * threadIdx.x; i < n_own; i += 4 * kThreads)
      stage16(gs + i, gt + i, true);
  else
    for (int i = threadIdx.x; i < n_own; i += kThreads)
      stage(gs + i, gt + i, true);
  stage_wait();
  __syncthreads();
  // 2. s, d and t once per own element
  for (Walk w = own; w.i < n_own; w.next()) {
    const float* xc = xs + w.r * p.xw + p.xp + w.c;
    const float s = lrn_scale_staged(xc, h, k, alpha);
    const float d = lrn_pow_neg(s, q, beta);
    const float gv = gs[w.i];
    ts[w.r * p.tw + h + w.c] = lrn_grad_term(gv, xc[0], s, d);
    gs[w.i] = __fmul_rn(gv, d);
  }
  // t at [c0 - h, c0) and [c0 + nc, c0 + nc + h) of each row
  for (int i = threadIdx.x; i < nr * 2 * h; i += kThreads) {
    const int r = i / (2 * h), j = i - r * 2 * h;
    const int cc = j < h ? j - h : nc + j - h;  // channel less c0
    float t = 0.0f;
    if (c0 + cc >= 0 && c0 + cc < p.C) {
      const float* xc = xs + r * p.xw + p.xp + cc;
      const float s = lrn_scale_staged(xc, h, k, alpha);
      t = lrn_grad_term(__ldg(gt + r * p.C + cc), xc[0], s,
                        lrn_pow_neg(s, q, beta));
    }
    ts[r * p.tw + h + cc] = t;
  }
  __syncthreads();
  // 3. dx
  for (Walk w = own; w.i < n_own; w.next())
    dt[w.i] = __fsub_rn(
        gs[w.i],
        __fmul_rn(__fmul_rn(c2, xs[w.r * p.xw + p.xp + w.c]),
                  lrn_window_staged(ts + w.r * p.tw + h + w.c, h)));
}

// The tiles of C-wide rows under a window of 2*half + 1 channels (all of
// Geom but rows, q, row_tiles and wide); false where one staged row
// would exceed kSmemMax or a row have more than kMaxGridY tiles.
bool plan(int C, int half, int tile, Geom* p) {
  if (tile == 0) tile = kTile;
  if (C < 1 || half < 0 || tile < 4 || tile % 4 || half > tile)
    return false;
  p->C = C;
  p->half = half;
  p->ct = std::min(C, tile);
  p->n_ct = (C + p->ct - 1) / p->ct;
  p->xp = (2 * half + 3) / 4 * 4;
  p->xw = p->ct + 2 * p->xp;
  p->tw = p->ct + 2 * half;
  const size_t row_bytes = (p->xw + p->ct + p->tw) * sizeof(float);
  p->rb = static_cast<int>(
      std::min<size_t>(tile / p->ct, kSmemMax / row_bytes));
  return p->rb > 0 && p->n_ct <= kMaxGridY;
}

size_t smem_bytes(const Geom& p) {
  return p.rb * (p.xw + p.ct + p.tw) * sizeof(float);
}

template <int kHalf, int kQ, typename T>
cudaError_t launch(const T* x, const T* g, T* dx, const Geom& p, float k,
                   float alpha, float beta, float c2, cudaStream_t st) {
  auto* kernel = lrn_backward_kernel<T, kHalf, kQ>;
  const dim3 grid(static_cast<unsigned>(p.row_tiles), p.n_ct);
  kernel<<<grid, kThreads, smem_bytes(p), st>>>(x, g, dx, p, k, alpha, beta,
                                                c2);
  return cudaGetLastError();
}

template <typename T>
int entry(const T* x, const T* g, T* dx, int64_t rows, int C, int half,
          float k, float alpha, int q, float beta, float c2, int generic,
          int tile, void* stream) {
  if (rows * static_cast<int64_t>(C) == 0) return cudaSuccess;
  Geom p{};
  if (!plan(C, half, tile, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  p.rows = rows;
  p.q = q;
  p.row_tiles = (rows + p.rb - 1) / p.rb;
  if (p.row_tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // four elements a copy: 16 bytes of f32, 8 of bf16
  constexpr uintptr_t kQuad = 4 * sizeof(T);
  p.wide = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % kQuad == 0 &&
           reinterpret_cast<uintptr_t>(g) % kQuad == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      !generic && half == 2 && q == 3
          ? launch<2, 3>(x, g, dx, p, k, alpha, beta, c2, st)
          : launch<-1, -1>(x, g, dx, p, k, alpha, beta, c2, st);
  return static_cast<int>(err);
}

}  // namespace

// `generic` nonzero takes the run-time instance at any geometry. `tile`:
// the own elements of a tile at most, a multiple of 4 (0: kTile), the
// kernel search's `tile` axis. A window so wide that one staged row of
// `tile` channels exceeds kSmemMax (half above ~500 at kTile), or a tile
// that is no multiple of 4, returns cudaErrorInvalidValue.
extern "C" int lrn_backward_f32(const float* x, const float* g, float* dx,
                                int64_t rows, int C, int half, float k,
                                float alpha, int q, float beta, float c2,
                                int generic, int tile, void* stream) {
  return entry(x, g, dx, rows, C, half, k, alpha, q, beta, c2, generic,
               tile, stream);
}

// The same with bf16 x, g and dx (f32 arithmetic, each dx rounded once).
extern "C" int lrn_backward_bf16(const __nv_bfloat16* x,
                                 const __nv_bfloat16* g, __nv_bfloat16* dx,
                                 int64_t rows, int C, int half, float k,
                                 float alpha, int q, float beta, float c2,
                                 int generic, int tile, void* stream) {
  return entry(x, g, dx, rows, C, half, k, alpha, q, beta, c2, generic,
               tile, stream);
}

// The dynamic shared memory one block takes for C-wide rows and tiles of
// `tile` elements (0: kTile); -1 where the geometry is refused.
extern "C" int lrn_backward_smem_bytes(int C, int half, int tile) {
  Geom p{};
  return plan(C, half, tile, &p) ? static_cast<int>(smem_bytes(p)) : -1;
}
