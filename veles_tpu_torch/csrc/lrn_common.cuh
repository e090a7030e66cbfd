// Across-channel LRN arithmetic shared by the LRN kernels of this directory.
//
// y = x * (k + alpha * sum_{|d| <= half} x[c+d]^2)^(-beta), zero outside
// [0, C). The window sum adds the taps in the order the plain PyTorch
// version (veles_tpu_torch/ops/functional.py:lrn_forward) and the JAX
// package's `_window_sum` use: the centre, then +d and -d for d = 1..half.
// s^(-beta) takes the sqrt/rsqrt decomposition of `_pow_neg_quarters`
// when 4*beta is an integer q in [1, 16] (AlexNet: beta = 0.75, q = 3),
// else powf.
//
// The gradient is the closed form of the JAX package's `_lrn_bwd_kernel`:
// dx = g*d - (c2*x)*W(t), t = ((g*x)*d)/s, d = s^(-beta), c2 =
// 2*alpha*beta, with W the same window sum. The backward kernels (K3, K5)
// stage channel runs of x in shared memory, compute s, d and t once per
// element (lrn_scale_staged, lrn_pow_neg, lrn_grad_term) into a staged run
// of t, zero outside [0, C), and sum it with lrn_window_staged.
//
// Every multiply and add is spelled with the round-to-nearest intrinsics
// so that nvcc contracts none of them into an FMA: the LRN value is then
// bit-identical in every kernel that includes this header, and the fused
// LRN->max-pool kernels pool and route exactly the values the LRN kernel
// writes.
//
// Device memory holds f32 or bf16 (`__nv_bfloat16`), the JAX kernels'
// io_dtype="native": the kernels are templated on its element type T.
// Every staged value and every operation here is f32 either way. A bf16
// element widens to f32 exactly when it is staged or read (stage, stage16
// below; cuda_bf16.h's conversion for a load), and an f32 result stored
// to a bf16 element rounds once, to nearest even (cuda_bf16.h's
// assignment from float). The f32 instances run the f32 kernels'
// statements unchanged.
#pragma once

#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float lrn_pow_neg(float s, int q, float beta) {
  if (q == 0) return powf(s, -beta);
  float t = sqrtf(rsqrtf(s));  // s^(-1/4)
  float out = 0.0f;
  bool have = false;
  while (q) {
    if (q & 1) {
      out = have ? __fmul_rn(out, t) : t;
      have = true;
    }
    q >>= 1;
    if (q) t = __fmul_rn(t, t);
  }
  return out;
}

// s = k + alpha * W(x^2) at channel c of the C-wide channel row `row`.
__device__ __forceinline__ float lrn_scale(const float* __restrict__ row,
                                           int c, int C, int half, float k,
                                           float alpha) {
  const float xc = __ldg(row + c);
  float acc = __fmul_rn(xc, xc);
  for (int d = 1; d <= half; ++d) {
    const float hi = (c + d < C) ? __ldg(row + c + d) : 0.0f;
    const float lo = (c - d >= 0) ? __ldg(row + c - d) : 0.0f;
    acc = __fadd_rn(__fadd_rn(acc, __fmul_rn(hi, hi)), __fmul_rn(lo, lo));
  }
  return __fadd_rn(k, __fmul_rn(alpha, acc));
}

// LRN of the element at channel c of the C-wide channel row `row`.
__device__ __forceinline__ float lrn_value(const float* __restrict__ row,
                                           int c, int C, int half, float k,
                                           float alpha, int q, float beta) {
  const float s = lrn_scale(row, c, C, half, k, alpha);
  return __fmul_rn(__ldg(row + c), lrn_pow_neg(s, q, beta));
}

// lrn_scale of a channel run staged in shared memory: `xs` points at the
// centre channel and xs[-half..half] hold its window, zero outside
// [0, C) (what lrn_scale adds there). The same operations in the same
// order, so the result is the same bits.
__device__ __forceinline__ float lrn_scale_staged(const float* xs, int half,
                                                  float k, float alpha) {
  const float xc = xs[0];
  float acc = __fmul_rn(xc, xc);
  for (int d = 1; d <= half; ++d) {
    const float hi = xs[d];
    const float lo = xs[-d];
    acc = __fadd_rn(__fadd_rn(acc, __fmul_rn(hi, hi)), __fmul_rn(lo, lo));
  }
  return __fadd_rn(k, __fmul_rn(alpha, acc));
}

// lrn_value of a staged channel run (see lrn_scale_staged).
__device__ __forceinline__ float lrn_value_staged(const float* xs, int half,
                                                  float k, float alpha, int q,
                                                  float beta) {
  return __fmul_rn(xs[0],
                   lrn_pow_neg(lrn_scale_staged(xs, half, k, alpha), q, beta));
}

// t = ((g*x)*d)/s of one element, from its s and d = s^(-beta).
__device__ __forceinline__ float lrn_grad_term(float g, float x, float s,
                                               float d) {
  return __fdiv_rn(__fmul_rn(__fmul_rn(g, x), d), s);
}

// W(t) of a staged run of t: `ts` points at the centre channel and
// ts[-half..half] hold its window, zero outside [0, C). The centre, then
// +d and -d for d = 1..half, as every window sum here.
__device__ __forceinline__ float lrn_window_staged(const float* ts,
                                                   int half) {
  float acc = ts[0];
  for (int d = 1; d <= half; ++d)
    acc = __fadd_rn(__fadd_rn(acc, ts[d]), ts[-d]);
  return acc;
}

// Four bytes from device to shared memory by cp.async, zeros where `in`
// is false (src-size 0: nothing is read): a thread issues all its copies
// of a tile before any arrives.
__device__ __forceinline__ void stage(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// Sixteen bytes likewise; `dst` and `src` 16-byte aligned.
__device__ __forceinline__ void stage16(void* dst, const void* src,
                                        bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The bf16 instances' copies into the f32 staging, overloads of the two
// above (cp.async copies bytes and cannot convert): one element by a
// 2-byte load, widened here; the four elements of one 16-byte f32 copy by
// one 8-byte load (`src` 8-byte aligned), each half the high half of its
// f32, stored as one float4. Zeros where `in` is false.
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src,
                                      bool in) {
  *dst = in ? __bfloat162float(*src) : 0.0f;
}

__device__ __forceinline__ void stage16(float* dst,
                                        const __nv_bfloat16* src, bool in) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (in) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    v.x = __uint_as_float(u.x << 16);
    v.y = __uint_as_float(u.x & 0xffff0000u);
    v.z = __uint_as_float(u.y << 16);
    v.w = __uint_as_float(u.y & 0xffff0000u);
  }
  *reinterpret_cast<float4*>(dst) = v;
}

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Four f32 results to the i-th group of four bf16 from `p` (8-byte
// aligned), each rounded to nearest even, as one 8-byte store.
__device__ __forceinline__ void store4(__nv_bfloat16* p, int i, float4 v) {
  uint2 u;
  u.x = bf16_bits(v.x) | (bf16_bits(v.y) << 16);
  u.y = bf16_bits(v.z) | (bf16_bits(v.w) << 16);
  reinterpret_cast<uint2*>(p)[i] = u;
}

// True for an f32 instance.
template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;
