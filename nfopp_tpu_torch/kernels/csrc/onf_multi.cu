// ONF forward for a batch of problems with the products in compute_dtype:
// logits[b, m] of field b at point m.
//
// Replaces the TPU kernel nfopp_tpu/experimental/pallas/onf_multi.py::_kernel
// (candidate scoring of the batch-explicit solve; M = K + N - 1 = 199). The
// TPU kernel packs P problems into one Pallas program to amortise the
// per-program pipeline cost of its sequential grid. On this card CTAs run in
// parallel, so one CTA per problem (256 CTAs at B=256) already fills the 132
// SMs; packing P problems into a CTA would leave SMs idle (32 CTAs at P=8).
// P is therefore checked by the wrapper (B % P == 0, as the TPU kernel
// requires) and does not reach the card: the results cannot depend on it.
//
// Casts (onf_common.cuh, BF16_MULTI): the encoding layer and the angle
// features in f32, as the TPU kernel computes them; then the operands of the
// MLP and head products rounded to bf16 with f32 accumulation.
//
// Bound on this card (H100 SXM data sheet rates): at B=256 x M=199, ~3.3
// GFLOP, ~3 us at 989 TFLOP/s bf16 dense, against ~34 MB of f32 weights read
// once, ~10 us at 3.35 TB/s: bound by bytes. Design: forward.cuh's
// onf_logits_tc_kernel<BF16_MULTI>, both products on the tensor cores.
// In f32 the function is kernel 1's, and so is the launch: each kernel
// instantiation lives in one translation unit only.
#include "forward.cuh"

using namespace nf;

extern "C" int nf_onf_forward(const NetArgs* net, const float* x, int B, int M, int dim,
                              int bf16, float* out, void* stream);

extern "C" int nf_onf_multi(const NetArgs* net, const float* x, int B, int M, int dim, int bf16,
                            float* out, void* stream) {
  return bf16 ? launch_onf_logits<BF16_MULTI>(net, x, B, M, dim, out, stream)
              : nf_onf_forward(net, x, B, M, dim, 0, out, stream);
}
