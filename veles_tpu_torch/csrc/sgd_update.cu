// K1: the SGD-momentum-L2 update of one parameter leaf, f32, in place.
//
// Replaces: veles_tpu/ops/pallas_kernels.py `_sgd_kernel` (reached through
// `sgd_update_pallas`, the `sgd_update` registry op's `pallas_rows`
// template), the TPU kernel that streams (row_tile, 128) blocks of p, g and
// v through VMEM and writes p and v back.
//
//   g' = g + wd*p;  v' = mu*v - lr*g';  p' = p + v'
//
// in that order, each multiply and add rounded on its own (no FMA), as the
// plain PyTorch version computes it.
//
// Bound on the H100: device-memory bytes: 3 reads and 2 writes of 4 bytes
// per element against 6 float operations.
//
// Design: one thread per four elements as float4 loads and stores when
// the three buffers are 16-byte aligned (PyTorch's allocator aligns every
// tensor it allocates much more coarsely), a scalar pass over the tail of
// fewer than four, grid-stride loops. One call updates one leaf; the
// wrapper calls it once per leaf with that leaf's learning rate (the bias
// multiplier included). The threads of a block are a run-time argument
// (0: kThreads, 256), the kernel search's `threads` axis.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void sgd_one(float& p, float g, float& v, float lr,
                                        float mu, float wd) {
  const float reg = __fadd_rn(g, __fmul_rn(wd, p));
  v = __fsub_rn(__fmul_rn(mu, v), __fmul_rn(lr, reg));
  p = __fadd_rn(p, v);
}

__global__ void sgd_update_vec4(float4* __restrict__ p,
                                const float4* __restrict__ g,
                                float4* __restrict__ v, int64_t n4, float lr,
                                float mu, float wd) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n4; i += stride) {
    float4 pp = p[i];
    const float4 gg = __ldg(g + i);
    float4 vv = v[i];
    sgd_one(pp.x, gg.x, vv.x, lr, mu, wd);
    sgd_one(pp.y, gg.y, vv.y, lr, mu, wd);
    sgd_one(pp.z, gg.z, vv.z, lr, mu, wd);
    sgd_one(pp.w, gg.w, vv.w, lr, mu, wd);
    p[i] = pp;
    v[i] = vv;
  }
}

__global__ void sgd_update_scalar(float* __restrict__ p,
                                  const float* __restrict__ g,
                                  float* __restrict__ v, int64_t lo,
                                  int64_t n, float lr, float mu, float wd) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = lo + static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    float pp = p[i];
    float vv = v[i];
    sgd_one(pp, __ldg(g + i), vv, lr, mu, wd);
    p[i] = pp;
    v[i] = vv;
  }
}

unsigned grid_for(int64_t total, int threads) {
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
  return static_cast<unsigned>(blocks);
}

constexpr int kThreads = 256;  // threads of a block unless asked otherwise

}  // namespace

// `threads`: the block's threads, a multiple of 32 up to 1024 (0:
// kThreads); any other count returns cudaErrorInvalidValue.
extern "C" int sgd_update_f32(float* p, const float* g, float* v, int64_t n,
                              float lr, float momentum, float weight_decay,
                              int threads, void* stream) {
  if (threads == 0) threads = kThreads;
  if (threads < 32 || threads > 1024 || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(p) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(v)) & 15u) == 0;
  const int64_t n4 = aligned ? n / 4 : 0;
  if (n4 > 0) {
    sgd_update_vec4<<<grid_for(n4, threads), threads, 0, st>>>(
        reinterpret_cast<float4*>(p), reinterpret_cast<const float4*>(g),
        reinterpret_cast<float4*>(v), n4, lr, momentum, weight_decay);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n > 4 * n4) {
    sgd_update_scalar<<<grid_for(n - 4 * n4, threads), threads, 0, st>>>(
        p, g, v, 4 * n4, n, lr, momentum, weight_decay);
  }
  return static_cast<int>(cudaGetLastError());
}
