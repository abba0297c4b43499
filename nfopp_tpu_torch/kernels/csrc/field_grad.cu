// Field training step for a batch of problems, f32: the ONF forward on M
// labelled points, the mean BCE-with-logits loss, and every parameter
// gradient (field_grad.cuh::field_grad_kernel<F32>).
//
// Replaces the TPU kernel nfopp_tpu/experimental/pallas/field_grad.py::_kernel
// (the field update; M = (N-1) + K + R = 209 per problem on the main path).
//
// Bound on this card: f32 FMAs. About 97.8k multiply-adds per point (forward
// 32.7k, parameter backward ~65k): ~10.5 GFLOP at B=256 x M=209, ~156 us at
// 67 TFLOP/s; weights and their gradients are ~34 MB each way (~20 us at
// 3.35 TB/s) (H100 SXM data sheet rates).
#include "field_grad.cuh"

using namespace nf;

extern "C" int nf_field_grad(const NetArgs* net, const float* x, const float* y, int B, int M,
                             int dim, float* loss, const Grads* grads, void* stream) {
  return launch_field_grad<F32>(net, x, y, B, M, dim, loss, grads, stream);
}
