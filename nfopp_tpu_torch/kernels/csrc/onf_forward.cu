// ONF forward for a batch of problems: logits[b, m] of field b at point m.
//
// Replaces the TPU kernel nfopp_tpu/experimental/pallas/onf_fused.py::_onf_kernel
// (candidate scoring of the field update; M = K + N - 1 = 199 on the main path).
//
// Bound on this card: f32 FMAs. About 32.7k multiply-adds per point against
// 33,141 weights per problem read once, so at B=256 x M=199 the work is
// ~3.3 GFLOP against ~34 MB of weights: ~50 us at the 67 TFLOP/s f32 rate and
// ~10 us at 3.35 TB/s (H100 SXM data sheet rates). In bf16 the work is ~3 us
// at 989 TFLOP/s against ~10 us of weights: bound by bytes.
// Design (forward.cuh): one CTA per problem keeps the whole field on chip
// (the TPU kernel's 128-lane padding and weight splitting are a TPU layout
// and are not carried over), walks the points in row tiles, and writes only
// the logits. F32 (onf_logits_f32_kernel) runs register-blocked f32 FMA
// tiles; tensor cores would change the f32 numerics.
//
// Under compute_dtype="bfloat16" (bf16 != 0) the production solver scores
// through models/onf.py::onf_apply's casts: onf_logits_tc_kernel<BF16_APPLY>
// (xy, the encoding weights and every product operand rounded to bf16, f32
// accumulation), the products on the tensor cores.
//
// Live rows (NetArgs::live, set while the tracked loop runs a chunk with
// stopped problems): a skipped problem's CTA writes zero logits and returns,
// so the f32 kernel (one CTA per SM) runs its live problems in one wave when
// at most 132 are live. The loop throws a stopped problem's step away; zeros,
// not the untouched torch.empty output, keep the replay buffer's resampling
// of that row on finite values that repeat.
#include "forward.cuh"

using namespace nf;

extern "C" const char* nf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int nf_onf_forward(const NetArgs* net, const float* x, int B, int M, int dim,
                              int bf16, float* out, void* stream) {
  return bf16 ? launch_onf_logits<BF16_APPLY>(net, x, B, M, dim, out, stream)
              : launch_onf_logits<F32>(net, x, B, M, dim, out, stream);
}
