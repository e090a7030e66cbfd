// host_gather: the multithreaded minibatch gather of the packed uint8
// memmap dataset (veles_tpu_torch/loader/memmap.py).
//
// The port's own copy of the JAX package's native/host_gather.cpp, same
// C API and arithmetic. The dataset was decoded when it was packed, so
// the hot path is a strided row gather + optional horizontal flip +
// optional uint8->float32 normalize; numpy's fancy-index gather runs the
// row copies on one thread, this library fans rows out over a few.
//
// C API (ctypes, veles_tpu_torch/native_gather.py):
//   src: per-row SOURCE ADDRESSES (int64): the Python side resolves shard
//        bases + row offsets, so C++ has no shard logic at all.
//   flip: optional per-row horizontal-flip flags (the seeded
//        augmentation, loader/base.py:_flip_mask); rows flip scanline by
//        scanline with pixel granularity c (channels).
//   hg_gather_f32 additionally converts uint8 -> x / scale + offset and
//        subtracts an optional per-pixel mean image (row_bytes floats).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline void copy_row_u8(const unsigned char* s, unsigned char* d,
                        long long row_bytes, bool flip, int w, int c) {
  if (!flip) {
    std::memcpy(d, s, (size_t)row_bytes);
    return;
  }
  // flip each scanline: row = h lines of w pixels of c bytes
  long long line = (long long)w * c;
  long long h = row_bytes / line;
  for (long long y = 0; y < h; ++y) {
    const unsigned char* sl = s + y * line;
    unsigned char* dl = d + y * line;
    for (int x = 0; x < w; ++x)
      std::memcpy(dl + (size_t)(w - 1 - x) * c, sl + (size_t)x * c, c);
  }
}

// Fan row ranges [lo, hi) over up to n_threads threads; range-based so
// workers can keep per-thread scratch (the f32 path's staging row).
template <typename Fn>
void parallel_ranges(int n, int n_threads, Fn fn) {
  if (n_threads <= 1 || n < 2) {
    fn(0, n);
    return;
  }
  if (n_threads > n) n_threads = n;
  std::vector<std::thread> ts;
  ts.reserve(n_threads);
  int chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    ts.emplace_back([lo, hi, &fn] { fn(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

void hg_gather_u8(const long long* src, int n, long long row_bytes,
                  unsigned char* out, const unsigned char* flip, int w,
                  int c, int n_threads) {
  parallel_ranges(n, n_threads, [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i)
      copy_row_u8(reinterpret_cast<const unsigned char*>((intptr_t)src[i]),
                  out + (size_t)i * row_bytes, row_bytes,
                  flip != nullptr && flip[i] != 0, w, c);
  });
}

void hg_gather_f32(const long long* src, int n, long long row_bytes,
                   float* out, const float* mean, float scale, float offset,
                   const unsigned char* flip, int w, int c, int n_threads) {
  parallel_ranges(n, n_threads, [&](int lo, int hi) {
    // thread-local staging row: flips land here as raw bytes so the
    // u8 -> f32 convert below stays a straight vectorizable loop
    std::vector<unsigned char> staged((size_t)row_bytes);
    for (int i = lo; i < hi; ++i) {
      const unsigned char* s =
          reinterpret_cast<const unsigned char*>((intptr_t)src[i]);
      if (flip != nullptr && flip[i] != 0) {
        copy_row_u8(s, staged.data(), row_bytes, true, w, c);
        s = staged.data();
      }
      float* d = out + (size_t)i * row_bytes;
      // divide (not multiply-by-inverse): bit-identical to the numpy
      // twin's `u8 / 127.5 - 1.0`
      if (mean) {
        for (long long j = 0; j < row_bytes; ++j)
          d[j] = (float)s[j] / scale + offset - mean[j];
      } else {
        for (long long j = 0; j < row_bytes; ++j)
          d[j] = (float)s[j] / scale + offset;
      }
    }
  });
}

}  // extern "C"
