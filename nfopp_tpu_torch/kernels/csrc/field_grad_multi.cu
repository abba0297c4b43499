// Field training step for a batch of problems with the products in
// compute_dtype: the ONF forward on M labelled points, the mean
// BCE-with-logits loss, and every parameter gradient.
//
// Replaces the TPU kernel nfopp_tpu/experimental/pallas/field_grad_multi.py::_kernel
// (the field update of the batch-explicit solve; M = (N-1) + K + R = 209).
// As for onf_multi.cu, the TPU kernel's P problems per Pallas program become
// one CTA per problem: P is checked by the wrapper and does not reach the
// card, so the results cannot depend on it.
//
// Casts (field_grad.cuh, BF16_MULTI): both operands of every product rounded
// to bf16 with f32 accumulation, the cotangents g, dh2 and dh1 included; the
// bias and encoding-gradient row sums on the f32 cotangents; the encoding
// layer and its gradient in f32.
//
// Bound on this card (H100 SXM data sheet rates): at B=256 x M=209, ~10.5
// GFLOP, ~11 us at 989 TFLOP/s bf16 dense, against ~68 MB of f32 weights in
// and gradients out, ~20 us at 3.35 TB/s: bound by bytes. This first version
// runs the bf16 products as exact f32 FMAs on the CUDA cores, at kernel 2's
// speed; tensor cores are later work.
//
// In f32 the function is kernel 2's, and so is the launch: each kernel
// instantiation lives in one translation unit only.
#include "field_grad.cuh"

using namespace nf;

extern "C" int nf_field_grad(const NetArgs* net, const float* x, const float* y, int B, int M,
                             int dim, float* loss, const Grads* grads, void* stream);

extern "C" int nf_field_grad_multi(const NetArgs* net, const float* x, const float* y, int B,
                                   int M, int dim, int bf16, float* loss, const Grads* grads,
                                   void* stream) {
  return bf16 ? launch_field_grad<BF16_MULTI>(net, x, y, B, M, dim, loss, grads, stream)
              : nf_field_grad(net, x, y, B, M, dim, loss, grads, stream);
}
