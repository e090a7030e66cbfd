// K2: across-channel LRN forward on an (rows, C) channels-last view, f32
// or bf16 in device memory, f32 arithmetic.
//
// Replaces: veles_tpu/ops/pallas_kernels.py `_lrn_fwd_kernel` (reached
// through `_lrn_call` / `lrn_forward_pallas`), the TPU kernel that streams
// (row_tile, C) blocks through VMEM and forms the window sum with shifted
// adds.
//
// Bound on the H100: device-memory bytes. Each element needs about 2n+6
// float operations (n = 5 for AlexNet) and one IEEE sqrt and rsqrt, below
// what the card's f32 rate allows over its 8 bytes; the least time is one
// read of x and one write of y.
//
// Design: K3's tiles of whole channel rows (lrn_rows_common.cuh) and its
// staging, forward only. A block takes a tile of rb consecutive rows,
// each at its full width C (AlexNet: 32 rows of 96, 12 of 256), so that
// no window crosses the tile and nothing is computed twice; a row wider
// than kTile channels is cut into runs of kTile channels (blockIdx.y),
// one row a tile, whose halo is read from x. Per tile:
//   1. stage by cp.async x at channels [c0 - xp, c0 + ct + xp) of each
//      row, zeros outside [0, C) (xp = half rounded up to 4, so that each
//      staged row starts 16-byte aligned); 16-byte copies where C % 4 ==
//      0 and x and y are 16-byte aligned, else 4-byte ones.
//   2. y = x*s^(-beta) once per element (lrn_value_staged), stored
//      coalesced: under 16-byte copies four neighbouring channels a
//      thread, stored as one float4, else one element a thread.
// Every operation is lrn_common.cuh's, in the same order as the plain
// version's, so y is bit-equal to it, and to what the fused LRN->max-pool
// kernels pool. A tile takes ~13 KB of shared memory, so eight blocks of
// 256 threads share an SM, each loading while another computes (tiles of
// half or twice the size and a looser register bound timed no faster on
// an H100: PERF.md). AlexNet's
// half = 2 and 4*beta = 3 run an instance with them as compile-time
// constants; any other geometry a generic one, which the caller may also
// ask for at AlexNet's (`generic`), to time what the constants buy.
//
// bf16 (the JAX kernel's io_dtype="native" under a bf16 step): the same
// tiles, staged rows and arithmetic, in f32, each y rounded once to bf16
// (four of them in one 8-byte store where a thread stores four channels).
// Staging loads and converts into the f32 rows (lrn_common.cuh's bf16
// stage and stage16: 2-byte loads, or 8-byte loads of four channels where
// C % 4 == 0 and x and y are 8-byte aligned) instead of cp.async, which
// cannot convert: the shared-memory layout and every index stay the f32
// instance's, and the f32 instance's statements are unchanged.
#include <algorithm>
#include <climits>
#include <cstdint>

#include "lrn_common.cuh"
#include "lrn_rows_common.cuh"

namespace {

constexpr int kThreads = 256;
// blocks an SM must hold: bounds a thread's registers to 32
constexpr int kMinBlocks = 8;
// own elements of one tile at most: whole rows of C <= kTile channels,
// else one row's run of kTile channels (a multiple of 4)
constexpr int kTile = 3072;
// dynamic shared memory a block may take without opting in
constexpr size_t kSmemMax = 48 * 1024;
constexpr int kMaxGridY = 65535;  // channel tiles a row, at most

// T is device memory's element type: float or __nv_bfloat16.
template <typename T, int kHalf, int kQ>
__global__ void __launch_bounds__(kThreads, kMinBlocks) lrn_forward_kernel(
    const T* __restrict__ x, T* __restrict__ y, Geom p, float k, float alpha,
    float beta) {
  extern __shared__ float4 smem4[];
  const int h = kHalf >= 0 ? kHalf : p.half;
  const int q = kQ >= 0 ? kQ : p.q;
  float* const xs = reinterpret_cast<float*>(smem4);  // [rb][xw]
  const int c0 = blockIdx.y * p.ct;  // the tile's first channel
  const int nc = min(p.ct, p.C - c0);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * p.rb;
  const int nr =
      p.rows - row0 < p.rb ? static_cast<int>(p.rows - row0) : p.rb;
  // own elements: nr whole rows, or one row's run of nc channels, one
  // contiguous run either way, flat index i = r*ct + c
  const int n_own = nr * nc;
  const T* const xt = x + row0 * p.C + c0;
  T* const yt = y + row0 * p.C + c0;
  // 1. stage x (K3's loop)
  const int span = p.wide ? p.xw / 4 : p.xw;  // copies a staged row
  for (Walk w(threadIdx.x, kThreads, span); w.r < nr; w.next()) {
    const int cc = (p.wide ? 4 * w.c : w.c) - p.xp;  // channel less c0
    const bool in = c0 + cc >= 0 && c0 + cc < p.C;
    const T* src = in ? xt + w.r * p.C + cc : x;
    float* dst = xs + w.r * p.xw + p.xp + cc;
    if (p.wide)
      stage16(dst, src, in);
    else
      stage(dst, src, in);
  }
  stage_wait();
  __syncthreads();
  // 2. y
  if (p.wide) {
    // ct and nc are multiples of 4: (rows, ct/4) groups of 4 channels
    for (Walk w(threadIdx.x, kThreads, p.ct / 4); 4 * w.i < n_own;
         w.next()) {
      const float* xc = xs + w.r * p.xw + p.xp + 4 * w.c;
      float4 v;
      v.x = lrn_value_staged(xc, h, k, alpha, q, beta);
      v.y = lrn_value_staged(xc + 1, h, k, alpha, q, beta);
      v.z = lrn_value_staged(xc + 2, h, k, alpha, q, beta);
      v.w = lrn_value_staged(xc + 3, h, k, alpha, q, beta);
      if constexpr (kF32<T>)
        reinterpret_cast<float4*>(yt)[w.i] = v;
      else
        store4(yt, w.i, v);
    }
  } else {
    for (Walk w(threadIdx.x, kThreads, p.ct); w.i < n_own; w.next())
      yt[w.i] = lrn_value_staged(xs + w.r * p.xw + p.xp + w.c, h, k, alpha,
                                 q, beta);
  }
}

// The tiles of C-wide rows under a window of 2*half + 1 channels (all of
// Geom but rows, q, row_tiles and wide; tw is K3's); false where one
// staged row would exceed kSmemMax or a row have more than kMaxGridY
// tiles.
bool plan(int C, int half, int tile, Geom* p) {
  if (tile == 0) tile = kTile;
  if (C < 1 || half < 0 || tile < 4 || tile % 4 || half > tile)
    return false;
  p->C = C;
  p->half = half;
  p->ct = std::min(C, tile);
  p->n_ct = (C + p->ct - 1) / p->ct;
  p->xp = (half + 3) / 4 * 4;
  p->xw = p->ct + 2 * p->xp;
  const size_t row_bytes = p->xw * sizeof(float);
  p->rb = static_cast<int>(
      std::min<size_t>(tile / p->ct, kSmemMax / row_bytes));
  return p->rb > 0 && p->n_ct <= kMaxGridY;
}

size_t smem_bytes(const Geom& p) { return p.rb * p.xw * sizeof(float); }

template <int kHalf, int kQ, typename T>
cudaError_t launch(const T* x, T* y, const Geom& p, float k, float alpha,
                   float beta, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(p.row_tiles), p.n_ct);
  auto* kernel = lrn_forward_kernel<T, kHalf, kQ>;
  kernel<<<grid, kThreads, smem_bytes(p), st>>>(x, y, p, k, alpha, beta);
  return cudaGetLastError();
}

template <typename T>
int entry(const T* x, T* y, int64_t rows, int C, int half, float k,
          float alpha, int q, float beta, int generic, int tile,
          void* stream) {
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
           reinterpret_cast<uintptr_t>(y) % kQuad == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      !generic && half == 2 && q == 3
          ? launch<2, 3>(x, y, p, k, alpha, beta, st)
          : launch<-1, -1>(x, y, p, k, alpha, beta, st);
  return static_cast<int>(err);
}

}  // namespace

// `generic` nonzero takes the run-time instance at any geometry. `tile`:
// the own elements of a tile at most, a multiple of 4 (0: kTile), the
// kernel search's `tile` axis. A window so wide that one staged row of
// `tile` channels exceeds kSmemMax (half above ~4500 at kTile), or a tile
// that is no multiple of 4, returns cudaErrorInvalidValue.
extern "C" int lrn_forward_f32(const float* x, float* y, int64_t rows, int C,
                               int half, float k, float alpha, int q,
                               float beta, int generic, int tile,
                               void* stream) {
  return entry(x, y, rows, C, half, k, alpha, q, beta, generic, tile,
               stream);
}

// The same with bf16 x and y (f32 arithmetic, each y rounded once).
extern "C" int lrn_forward_bf16(const __nv_bfloat16* x, __nv_bfloat16* y,
                                int64_t rows, int C, int half, float k,
                                float alpha, int q, float beta, int generic,
                                int tile, void* stream) {
  return entry(x, y, rows, C, half, k, alpha, q, beta, generic, tile,
               stream);
}

// The dynamic shared memory one block takes for C-wide rows under a
// window of 2*half + 1 channels and tiles of `tile` elements (0: kTile);
// -1 where the geometry is refused.
extern "C" int lrn_forward_smem_bytes(int C, int half, int tile) {
  Geom p{};
  return plan(C, half, tile, &p) ? static_cast<int>(smem_bytes(p)) : -1;
}
