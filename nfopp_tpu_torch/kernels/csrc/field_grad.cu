// Field training step for a batch of problems: the ONF forward on M labelled
// points, the mean BCE-with-logits loss, and every parameter gradient.
//
// Replaces the TPU kernel nfopp_tpu/experimental/pallas/field_grad.py::_kernel
// (the field update; M = (N-1) + K + R = 209 per problem on the main path).
//
// f32 (field_grad.cuh::field_grad_f32_kernel): bound on this card by f32
// FMAs. About 97.8k multiply-adds per point (forward 32.7k, parameter
// backward ~65k): ~10.5 GFLOP at B=256 x M=209, ~156 us at 67 TFLOP/s;
// weights and their gradients are ~34 MB each way (~20 us at 3.35 TB/s)
// (H100 SXM data sheet rates).
//
// bf16 (bf16 != 0; field_grad_tc_kernel<BF16_APPLY>, tensor cores): the
// production solver's field update under compute_dtype="bfloat16", autograd
// of models/onf.py::onf_apply's casts. The same work takes ~11 us at 989
// TFLOP/s, so the ~68 MB of f32 weights in and gradients out bound it.
//
// Live rows (NetArgs::live, set while the tracked loop runs a chunk with
// stopped problems): a skipped problem's CTA writes a zero loss and zero
// gradients and returns. The loop throws a stopped problem's step away, so
// nothing is lost, and the CTA frees its SM within microseconds: with at
// most 132 live problems every live CTA (one per SM, ~219 KB of shared
// memory) starts in the first wave. Zeros, not the untouched torch.empty
// outputs, so the step's later ops see finite values that repeat.
#include "field_grad.cuh"

using namespace nf;

extern "C" int nf_field_grad(const NetArgs* net, const float* x, const float* y, int B, int M,
                             int dim, int bf16, float* loss, const Grads* grads, void* stream) {
  return bf16 ? launch_field_grad<BF16_APPLY>(net, x, y, B, M, dim, loss, grads, stream)
              : launch_field_grad<F32>(net, x, y, B, M, dim, loss, grads, stream);
}
