"""K5's CUDA source (`veles_tpu_torch/csrc/lrn_maxpool_backward.cu`) run
on the CPU, held bit for bit against the plain version
`ops/functional.py:lrn_maxpool_backward` (which
`test_torch_backward_kernels.py` holds against the JAX package's VJP).

The .cu file itself is compiled by g++ (skipped where there is none),
with a small prelude in place of the CUDA runtime:

- a launch `k<<<grid, threads, smem, stream>>>(...)` runs each block in
  turn on `threads` std::threads, one per CUDA thread, with its own
  dynamic shared memory (filled with 0x7f bytes, so that a read of
  anything not staged shows), a std::barrier for `__syncthreads` and
  one of 32 threads per warp for `__syncwarp`;
- the csrc/ headers a source includes are inlined, each once;
- `stage` and `stage16` (lrn_common.cuh's 4- and 16-byte cp.async)
  become plain copies, zeros where the source is out of range, and
  `stage_wait` nothing, one valid schedule of the asynchronous copies;
- the round-to-nearest intrinsics are plain float operations (compiled
  with -ffp-contract=off, so none becomes an FMA), `__ldg` a load, and
  `rsqrtf` 1/sqrtf, which is what torch.rsqrt computes on the CPU;
- `__nv_bfloat16` is a struct of its 16 bits: widened to f32 exactly (the
  high half of the f32) and rounded from f32 to nearest even, NaN to a
  NaN, by its conversions and assignment as by `cuda_bf16.h`'s, and as
  torch rounds.

The plain version runs with torch.sqrt rounded correctly (through
float64), as sqrtf is on the card and in g++: on the CPU, torch.sqrt of
float32 may take MKL's vector sqrt, which can be 1 ulp off.

Everything else is the kernel's own code: its tile sizing (`fit`), its
table of covering windows, its byte or word staging of the tap record
and its sums. The wrapper `kernels.lrn_maxpool_backward` calls it, so the
argument order of the C entry point is the wrapper's. The emulation
(`emulated_source`, `compile_source`, `load_entry`, `wrapper_on`) also
serves K3's test, `test_torch_lrn_backward_tiles.py`, and K4's and K2's,
`test_torch_lrn_forward_tiles.py`. Besides the build
as written, a "narrow" build shrinks K5's shared-memory target to 3 KB
and its grid to one sample, so that bands shrink to one row, tiles to
part of the width and channel tiles below 32, and blocks loop over the
samples. Shapes: chip_smoke.py's K5 small checks (clipped windows on
both axes, C = 3, 40 and 70, an all-zero input, NaN windows, 3x3/1 and
2x2/2), AlexNet's two LRN widths at batch 1, LRN n = 3, and AlexNet's
geometry through the generic instance. It cannot see nvcc errors,
register pressure or speed: chip_smoke.py holds the kernel on the card.
"""

import contextlib
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from veles_tpu_torch.ops import functional as fn
from veles_tpu_torch.ops import kernels

K, ALPHA, BETA = 2.0, 1e-4, 0.75
SOURCE = kernels.CSRC / "lrn_maxpool_backward.cu"

PRELUDE = r"""
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <thread>
#include <vector>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// cuda_bf16.h's type as its 16 bits: widened to f32 exactly (also by the
// implicit conversion), rounded from f32 to nearest even (also by the
// assignment from float)
struct __nv_bfloat16 {
  unsigned short bits;
  operator float() const {
    return __uint_as_float(static_cast<unsigned>(bits) << 16);
  }
  __nv_bfloat16& operator=(float f);
};
inline float __bfloat162float(__nv_bfloat16 b) { return b; }
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u)  // NaN stays a (quiet) NaN
    return {static_cast<unsigned short>((u >> 16) | 0x40u)};
  u += 0x7fffu + ((u >> 16) & 1u);  // to nearest, ties to even
  return {static_cast<unsigned short>(u >> 16)};
}
inline __nv_bfloat16& __nv_bfloat16::operator=(float f) {
  bits = __float2bfloat16_rn(f).bits;
  return *this;
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.bits; }

namespace emu {
inline thread_local dim3 thread_idx, block_idx;
inline dim3 block_dim, grid_dim;
inline std::barrier<>* bar = nullptr;
inline std::deque<std::barrier<>>* warp_bars = nullptr;
inline float4* smem = nullptr;

// Every block in turn on `threads` threads; a barrier between blocks,
// and the shared memory refilled with 0x7f bytes before each; a barrier
// of 32 threads for each warp's __syncwarp.
template <class F, class... A>
void launch(dim3 grid, int threads, size_t bytes, void*, F kernel,
            A... args) {
  std::vector<float4> buf(bytes / sizeof(float4) + 1);
  std::barrier<> b(threads);
  bar = &b;
  std::deque<std::barrier<>> wb;
  for (int w = 0; w < threads / 32; ++w) wb.emplace_back(32);
  warp_bars = &wb;
  smem = buf.data();
  block_dim = dim3(threads);
  grid_dim = grid;
  auto fill = [&] { std::memset(buf.data(), 0x7f, buf.size() * 16); };
  fill();
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([&, t] {
      thread_idx = dim3(t, 0, 0);
      for (unsigned z = 0; z < grid.z; ++z)
        for (unsigned y = 0; y < grid.y; ++y)
          for (unsigned x = 0; x < grid.x; ++x) {
            block_idx = dim3(x, y, z);
            kernel(args...);
            b.arrive_and_wait();  // the block is done
            if (t == 0) fill();
            b.arrive_and_wait();
          }
    });
  for (auto& th : pool) th.join();
}
}  // namespace emu

#define threadIdx emu::thread_idx
#define blockIdx emu::block_idx
#define blockDim emu::block_dim
#define gridDim emu::grid_dim
#define __syncthreads() emu::bar->arrive_and_wait()
#define __syncwarp() (*emu::warp_bars)[emu::thread_idx.x / 32].arrive_and_wait()
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define CUDART_INF_F INFINITY
using std::isnan;
using std::max;
using std::min;
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
template <class T> inline T __ldg(const T* p) { return *p; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr {
  cudaDevAttrMaxSharedMemoryPerBlockOptin,
  cudaDevAttrMaxSharedMemoryPerMultiprocessor
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
// the H100's: 227 KB a block (opt-in), 228 KB an SM
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMaxSharedMemoryPerBlockOptin ? 232448 : 233472;
  return 0;
}
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
"""

STAGE = r"""
__device__ __forceinline__ void stage(void* dst, const void* src, bool in) {
  if (in) std::memcpy(dst, src, 4); else std::memset(dst, 0, 4);
}

__device__ __forceinline__ void stage16(void* dst, const void* src,
                                        bool in) {
  if (in) std::memcpy(dst, src, 16); else std::memset(dst, 0, 16);
}

__device__ __forceinline__ void stage_wait() {}
"""

#: build -> substitutions in the kernel's constants
BUILDS = {"as written": {},
          "narrow": {"kSmemTarget = 100 * 1024": "kSmemTarget = 3 * 1024",
                     "kMaxGridZ = 65535": "kMaxGridZ = 1"}}


def sub(text, old, new, count=1):
    """`text` with `old` replaced; the kernel source must hold it."""
    assert text.count(old) == count, f"the source no longer holds {old!r}"
    return text.replace(old, new)


def _header(name):
    """csrc/`name` as C++ for g++: lrn_common.cuh's cp.async copies
    emulated."""
    text = (kernels.CSRC / name).read_text()
    if name == "lrn_common.cuh":
        text = sub(text, "#include <cuda_runtime.h>", "")
        text = sub(text, "#include <cuda_bf16.h>", "")
        text, n = re.subn(
            r"__device__ __forceinline__ void stage\(.*?"
            r"__device__ __forceinline__ void stage_wait\(\) {.*?\n}\n",
            lambda m: STAGE, text, flags=re.S)
        assert n == 1, "the cp.async copies are not where the emulation looks"
    return text


def _inline_headers(text, seen):
    """`text` with each `#include "*.cuh"` of csrc/ replaced by the header,
    itself inlined, the first time it is included and by nothing after."""
    def one(m):
        if m.group(1) in seen:
            return ""
        seen.add(m.group(1))
        return _inline_headers(_header(m.group(1)), seen)
    text = text.replace("#pragma once\n", "")
    return re.sub(r'#include "(\w+\.cuh)"\n', one, text)


def emulated_source(source, consts, launches):
    """The CUDA file `source` (one of csrc/, with `launches` kernels, each
    launched once) with its csrc/ headers inlined, the prelude before it,
    its copies, shared memory and launches emulated, and `consts` (old ->
    new) substituted in the whole: C++ for g++."""
    src = source.read_text().replace("#include <math_constants.h>", "")
    assert '#include "lrn_common.cuh"' in src
    src = _inline_headers(src, set())
    src = sub(src, "extern __shared__ float4 smem4[];",
              "float4* const smem4 = emu::smem;", launches)
    src, n = re.subn(r"(\w+)<<<(.*?)>>>\(", r"emu::launch(\2, \1, ", src,
                     flags=re.S)
    assert n == launches, f"{source.name} is no longer {launches} launches"
    for old, new in consts.items():
        src = sub(src, old, new)
    return PRELUDE + src


def find_gxx():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the CUDA source cannot be "
                    "emulated")
    return gxx


def compile_source(gxx, src, out):
    """Start g++ on `src`, the library at `out`; (out, process)."""
    cpp = out.with_suffix(".cpp")
    cpp.write_text(src)
    return out, subprocess.Popen(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread",
         "-shared", "-fPIC", "-w", "-o", str(out), str(cpp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def wait_built(out, proc):
    """The library `out` once the `compile_source` building it has
    finished."""
    log = proc.communicate()[0]
    assert proc.returncode == 0, f"g++:\n{log}"
    return out


def entry_in(lib, name):
    """The C entry point of kernel instance `name` (kernels.INSTANCES:
    `lrn_forward` (f32), `lrn_forward_bf16`, ...) in the emulated
    library `lib`."""
    symbol = kernels.INSTANCES[name][1]
    entry = getattr(ctypes.CDLL(str(lib)), symbol)
    entry.argtypes = kernels._ARGTYPES[symbol]
    entry.restype = ctypes.c_int
    return entry


def load_entry(out, proc, name="lrn_maxpool_backward"):
    """The C entry point of kernel instance `name` from a finished
    `compile_source`."""
    return entry_in(wait_built(out, proc), name)


def bf16_at(x, offset=0):
    """`x` rounded to bf16, `offset` elements (2 bytes each) into a fresh
    buffer: contiguous, and for offset 1 two bytes off 8-byte alignment
    (so the kernels stage it element by element), for 4 eight bytes off
    16-byte alignment (8-byte copies still take it)."""
    buf = torch.empty(x.numel() + offset + 8, dtype=torch.bfloat16)
    start = (-(buf.data_ptr() // 2)) % 8 + offset  # from a 16-byte boundary
    xt = buf[start:start + x.numel()].view(x.shape)
    xt.copy_(x)
    assert xt.data_ptr() % 16 == 2 * offset
    return xt


@pytest.fixture(scope="module")
def emulated_libs(tmp_path_factory):
    """build name -> K5's source compiled by g++ (the library), all
    builds compiled at once."""
    gxx = find_gxx()
    out = tmp_path_factory.mktemp("k5_emulation")
    started = {name: compile_source(gxx, emulated_source(SOURCE, consts, 2),
                                    out / f"{name.replace(' ', '_')}.so")
               for name, consts in BUILDS.items()}
    return {name: wait_built(*job) for name, job in started.items()}


@pytest.fixture(scope="module")
def emulated(emulated_libs):
    """build name -> the C entry point of K5's f32 instance."""
    return {name: entry_in(lib, "lrn_maxpool_backward")
            for name, lib in emulated_libs.items()}


@pytest.fixture(scope="module")
def emulated_bf16(emulated_libs):
    """build name -> the C entry point of K5's bf16 instance."""
    return {name: entry_in(lib, "lrn_maxpool_backward_bf16")
            for name, lib in emulated_libs.items()}


@contextlib.contextmanager
def wrapper_on(entry, monkeypatch):
    """The kernel wrappers launching `entry` on CPU tensors."""
    with monkeypatch.context() as m:
        m.setattr(kernels, "_on_card", lambda name, x: True)
        m.setattr(kernels, "_entry", lambda name: entry)
        m.setattr(kernels, "_stream", lambda x: None)
        m.setattr(torch.cuda, "device",
                  lambda device: contextlib.nullcontext())
        yield


#: (what, x shape, window, stride, LRN n, input): chip_smoke.py's K5
#: small checks, AlexNet's two LRN widths, and LRN n = 3
SHAPES = (("clipped both axes, C 40", (2, 14, 16, 40), (3, 3), (2, 2), 5,
           "relu"),
          ("C 3", (2, 14, 16, 3), (3, 3), (2, 2), 5, "relu"),
          ("C 70", (2, 9, 11, 70), (3, 3), (2, 2), 5, "relu"),
          ("all zero", (2, 14, 16, 40), (3, 3), (2, 2), 5, "zero"),
          ("NaN windows", (2, 14, 16, 40), (3, 3), (2, 2), 5, "nan"),
          ("3x3 stride 1", (2, 13, 15, 40), (3, 3), (1, 1), 5, "relu"),
          ("2x2 stride 2", (2, 13, 15, 40), (2, 2), (2, 2), 5, "relu"),
          ("LRN n 3", (2, 14, 16, 40), (3, 3), (2, 2), 3, "relu"),
          ("AlexNet L1", (1, 55, 55, 96), (3, 3), (2, 2), 5, "relu"),
          ("AlexNet L2", (1, 27, 27, 256), (3, 3), (2, 2), 5, "relu"))


def _inputs(shape, ksize, stride, kind, seed=8):
    rs = np.random.RandomState(seed)
    x = np.maximum(rs.randn(*shape), 0).astype(np.float32)
    if kind == "zero":
        x[:] = 0.0
    elif kind == "nan":
        x[0, 2, 2, 3] = x[1, 13, 15, 39] = x[1, 6, 0, 0] = np.nan
    oh, ow = fn.pool_out_hw(shape[1], shape[2], *ksize, *stride)
    g = rs.randn(shape[0], oh, ow, shape[3]).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(g)


def _case(emulated, monkeypatch, build, shape, ksize, stride, n, kind,
          generic=False, bf16_offset=None):
    """K5's source on one input against the plain version, bit for bit;
    in bf16 (x `bf16_offset` elements into its buffer) unless None."""
    x, g = _inputs(shape, ksize, stride, kind)
    if bf16_offset is not None:
        x, g = bf16_at(x, bf16_offset), g.to(torch.bfloat16)
    sqrt = torch.sqrt
    with monkeypatch.context() as m:
        m.setattr(torch, "sqrt", lambda t: sqrt(t.double()).to(t.dtype))
        want = fn.lrn_maxpool_backward(x, g, K, ALPHA, BETA, n, ksize,
                                       stride)
    with wrapper_on(emulated[build], monkeypatch):
        got = kernels.lrn_maxpool_backward(x, g, K, ALPHA, BETA, n, ksize,
                                           stride, generic=generic)
    assert torch.equal(got.isnan(), want.isnan())
    nan = want.isnan()
    assert torch.equal(got.masked_fill(nan, 0.0), want.masked_fill(nan, 0.0))
    return int(nan.sum())


@pytest.mark.parametrize("build", list(BUILDS))
@pytest.mark.parametrize("what,shape,ksize,stride,n,kind", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_k5_source_is_bit_equal_to_the_plain_version(emulated, monkeypatch,
                                                     build, what, shape,
                                                     ksize, stride, n, kind):
    nans = _case(emulated, monkeypatch, build, shape, ksize, stride, n,
                 kind)
    assert (nans > 0) == (kind == "nan")


@pytest.mark.parametrize("build", list(BUILDS))
def test_k5_generic_instance_at_alexnets_geometry(emulated, monkeypatch,
                                                  build):
    """The run-time instance, asked for at AlexNet's geometry (which the
    compile-time one takes otherwise), gives the plain version's bits."""
    _case(emulated, monkeypatch, build, (2, 14, 16, 40), (3, 3), (2, 2), 5,
          "relu", generic=True)


#: K5's bf16 instance at small shapes: (what, x shape, window, stride,
#: input, x's offset in elements from 16-byte alignment)
BF16_SHAPES = (("clipped both axes, C 40", (2, 14, 16, 40), (3, 3), (2, 2),
                "relu", 0),
               ("C 3", (2, 14, 16, 3), (3, 3), (2, 2), "relu", 0),
               ("all zero", (2, 14, 16, 40), (3, 3), (2, 2), "zero", 0),
               ("NaN windows", (2, 14, 16, 40), (3, 3), (2, 2), "nan", 0),
               ("x 2 bytes off alignment", (2, 14, 16, 40), (3, 3), (2, 2),
                "relu", 1))


@pytest.mark.parametrize("build", list(BUILDS))
@pytest.mark.parametrize("what,shape,ksize,stride,kind,offset", BF16_SHAPES,
                         ids=[s[0] for s in BF16_SHAPES])
def test_k5_bf16_source_is_bit_equal_to_the_plain_version(
        emulated_bf16, monkeypatch, build, what, shape, ksize, stride, kind,
        offset):
    """The bf16 instance (bf16 x, g and dx; staged as f32, routed on the
    f32 LRN values, dx rounded once) gives the plain version's bits."""
    nans = _case(emulated_bf16, monkeypatch, build, shape, ksize, stride, 5,
                 kind, bf16_offset=offset)
    assert (nans > 0) == (kind == "nan")


def test_k5_bf16_generic_instance(emulated_bf16, monkeypatch):
    _case(emulated_bf16, monkeypatch, "as written", (2, 14, 16, 40), (3, 3),
          (2, 2), 5, "relu", generic=True, bf16_offset=0)


def test_a_wrong_covering_window_fails(tmp_path, monkeypatch):
    """The emulation sees the kernel's index logic: a build whose table of
    covering windows drops the last window of each row and column is not
    bit-equal."""
    src = sub(emulated_source(SOURCE, {}, 2),
              "min((kk - 1 - tap) / s + 1, o + 1)",
              "min((kk - 1 - tap) / s, o + 1)")
    entry = load_entry(*compile_source(find_gxx(), src,
                                       tmp_path / "wrong.so"))
    with pytest.raises(AssertionError):
        _case({"wrong": entry}, monkeypatch, "wrong", (2, 14, 16, 40),
              (3, 3), (2, 2), 5, "relu")
