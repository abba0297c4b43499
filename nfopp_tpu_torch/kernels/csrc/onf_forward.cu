// ONF forward for a batch of problems: logits[b, m] of field b at point m.
//
// Replaces the TPU kernel nfopp_tpu/experimental/pallas/onf_fused.py::_onf_kernel
// (candidate scoring of the field update; M = K + N - 1 = 199 on the main path).
//
// Bound on this card: f32 FMAs. About 32.7k multiply-adds per point against
// 33,141 weights per problem read once, so at B=256 x M=199 the work is
// ~3.3 GFLOP against ~34 MB of weights: ~50 us at the 67 TFLOP/s f32 rate and
// ~10 us at 3.35 TB/s (H100 SXM data sheet rates).
// Design: one CTA per problem keeps the whole field in shared memory (the
// TPU kernel's 128-lane padding and weight splitting are a TPU layout and are
// not carried over), walks the points in tiles of 32 rows, and writes only
// the logits: no activation touches device memory. The products are plain f32
// FMA loops (onf_common.cuh::onf_logits_kernel<F32>); tensor cores would
// change the f32 numerics.
#include "onf_common.cuh"

using namespace nf;

extern "C" const char* nf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int nf_onf_forward(const NetArgs* net, const float* x, int B, int M, int dim,
                              float* out, void* stream) {
  return launch_onf_logits<F32>(net, x, B, M, dim, out, stream);
}
