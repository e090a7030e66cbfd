// Pool geometry shared by the fused LRN -> max-pool kernels (K4
// `lrn_maxpool_forward.cu`, K5 `lrn_maxpool_backward.cu`): the geometry
// a launch gets, its compile-time instance, a division-free walk over a
// thread's share of a tile, and a floor division.
#pragma once

namespace {

struct Geom {
  int H, W, C, OH, OW, ky, kx, sy, sx, half, q;
};

// The LRN window's half-width, 4*beta, the pool window and its stride as
// compile-time constants for AlexNet's (2, 3, 3x3, 2x2), so that the
// window sums, the power, the tap scans and the gathers unroll without
// branches; -1 reads them from the Geom at run time. cy, cx: the most
// windows that cover one input row, column (ceil(ky/sy), ceil(kx/sx)).
template <int kHalf, int kQ, int kKY, int kKX, int kSY, int kSX>
struct Shape {
  const int half, q, ky, kx, sy, sx, cy, cx;
  __device__ explicit Shape(const Geom& p)
      : half(kHalf >= 0 ? kHalf : p.half),
        q(kQ >= 0 ? kQ : p.q),
        ky(kKY >= 0 ? kKY : p.ky),
        kx(kKX >= 0 ? kKX : p.kx),
        sy(kSY >= 0 ? kSY : p.sy),
        sx(kSX >= 0 ? kSX : p.sx),
        cy((ky + sy - 1) / sy),
        cx((kx + sx - 1) / sx) {}
};

// A thread's share (tid, tid + T, ...) of a row-major (*, n1, n2) grid,
// walked as index triples (i0, i1, i2) beside the flat index i, with no
// division per step.
struct Walk {
  int i, i0, i1, i2, d, d0, d1, d2, n1, n2;
  __device__ Walk(int tid, int T, int n1_, int n2_) : n1(n1_), n2(n2_) {
    i = tid;
    i2 = tid % n2;
    i1 = (tid / n2) % n1;
    i0 = tid / (n2 * n1);
    d = T;
    d2 = T % n2;
    d1 = (T / n2) % n1;
    d0 = T / (n2 * n1);
  }
  __device__ void next() {
    i += d;
    i2 += d2;
    i1 += d1;
    i0 += d0;
    if (i2 >= n2) {
      i2 -= n2;
      ++i1;
    }
    if (i1 >= n1) {
      i1 -= n1;
      ++i0;
    }
  }
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}

}  // namespace
