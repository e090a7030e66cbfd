// Tiles of whole channel rows shared by the LRN kernels on an (rows, C)
// channels-last view (K2 `lrn_forward.cu`, K3 `lrn_backward.cu`): the
// geometry a launch gets and a division-free walk over a thread's share
// of a tile. Each kernel keeps its own loop staging a tile's rows: K3's
// SASS changed when that loop became a function shared from here.
#pragma once

#include <cstdint>

namespace {

struct Geom {
  int64_t rows, row_tiles;
  int C, half, q;
  int ct, rb, n_ct;  // channels and rows of a tile, channel tiles a row
  int xp, xw, tw;    // x's pad, the staged row widths of x and of t (K3)
  int wide;          // 16-byte copies
};

// (r, c) of a thread's share (tid, tid + T, ...) of a row-major (*, n)
// grid, beside the flat index i, with no division per step.
struct Walk {
  int i, r, c, di, dr, dc, n;
  __device__ Walk(int tid, int T, int n_)
      : i(tid), r(tid / n_), c(tid % n_), di(T), dr(T / n_), dc(T % n_),
        n(n_) {}
  __device__ void next() {
    i += di;
    r += dr;
    c += dc;
    if (c >= n) {
      c -= n;
      ++r;
    }
  }
};

}  // namespace
