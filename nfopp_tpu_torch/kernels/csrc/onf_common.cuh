// What every field kernel shares (forward.cuh, field_grad.cuh,
// collision_bwd.cu): the C view of one batch of fields (NetArgs), the
// operand roundings of the bf16 modes, and small helpers. Each kernel keeps
// one problem's field on chip, one CTA per problem, and walks the problem's
// points in row tiles.
//
// Operand rounding (template parameter P of every kernel). A bf16 mode rounds
// a product's operands to bf16 and accumulates in f32. A bf16 x bf16 product
// is exact in f32, so the tensor cores' bf16 products with f32 accumulators
// (mma.sync) and f32 FMAs over rounded operands are the same arithmetic up to
// the order of the f32 sums.
//   F32         no rounding (kernels 1-3, and kernels 4-5 in f32);
//   BF16_MULTI  the TPU kernels onf_multi.py / field_grad_multi.py: encoding
//               layer in f32, every MLP and head product's operands rounded
//               (weights, features, h1, h2, and in the backward the
//               cotangents g, dh2, dh1 where they enter a product);
//   BF16_APPLY  models/onf.py::onf_apply's casts (the production solver's
//               bf16 kernels): as BF16_MULTI but xy and the encoding weights rounded
//               too; its backward is the autograd of those casts, which
//               rounds each cotangent once, where it passes back through a
//               cast, after its f32 product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace nf {

constexpr int TM = 32;                     // rows per tile of the f32 kernels
constexpr int THREADS = 256;               // threads of the f32 field-gradient kernel
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SMEM = 232448;           // bytes a CTA may use on sm_90

constexpr int F32 = 0;
constexpr int BF16_MULTI = 1;
constexpr int BF16_APPLY = 2;

// v rounded to the nearest bf16 (ties to even) under the bf16 modes.
template <int P>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (P == F32) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
}

// The encoding layer's operands (xy and the encoding weights) are rounded
// only under BF16_APPLY.
template <int P>
__device__ __forceinline__ float rnd_enc(float v) {
  return P == BF16_APPLY ? rnd<P>(v) : v;
}

// One batch of fields: every pointer is [B, ...] contiguous, f32; `live` [B]
// (bool) or nullptr marks the problems to compute (nullptr: all of them).
struct NetArgs {
  const float *ew, *eb, *w1, *b1, *w2, *b2, *w3, *b3, *ab;
  const bool* live;
  int F, A, HID, use_cos, bias;
  float mean, sigma;
};

// Whether this CTA's problem (blockIdx.x) is to be skipped. A skipped CTA
// writes zeros to its problem's outputs and returns before its first
// barrier: the tracked loop keeps no result of a problem that has stopped,
// and zeros keep the step's later ops on finite values that repeat from run
// to run (the outputs come from torch.empty). Live problems run unchanged.
__device__ __forceinline__ bool skipped(const NetArgs& n) {
  return n.live != nullptr && !n.live[blockIdx.x];
}

// Zeros over count floats at p, by the CTA's NT threads. Not inlined: inlined
// into the f32 field-gradient kernel, this loop made its live CTAs ~3% slower
// on an H100.
template <int NT>
__device__ __noinline__ void zero_row(float* p, size_t count) {
  for (size_t i = threadIdx.x; i < count; i += NT) p[i] = 0.f;
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// The offset of `count` floats at `offset` (advanced past them, rounded up to
// a 16-byte multiple).
__host__ __device__ inline int take(int& offset, int count) {
  const int at = offset;
  offset += round4(count);
  return at;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// g * w for a cotangent g (d logits of a row) entering a product with the
// head weight w (already rounded): BF16_MULTI rounds the operand g,
// BF16_APPLY the product.
template <int P>
__device__ __forceinline__ float head_cotangent(float g, float w) {
  if constexpr (P == BF16_APPLY) {
    return rnd<P>(g * w);
  } else {
    return rnd<P>(g) * w;
  }
}

}  // namespace nf
