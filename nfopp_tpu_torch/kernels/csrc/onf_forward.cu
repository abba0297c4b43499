// ONF forward for a batch of problems: logits[b, m] of field b at point m.
//
// Replaces the TPU kernel nfopp_tpu/experimental/pallas/onf_fused.py::_onf_kernel
// (candidate scoring of the field update; M = K + N - 1 = 199 on the main path).
//
// Bound on this card: f32 FMAs. About 32.7k multiply-adds per point against
// 33,141 weights per problem read once, so at B=256 x M=199 the work is
// ~3.3 GFLOP against ~34 MB of weights: ~50 us at the 67 TFLOP/s f32 rate and
// ~10 us at 3.35 TB/s.
// Design: one CTA per problem keeps the whole field in shared memory (the
// TPU kernel's 128-lane padding and weight splitting are a TPU layout and are
// not carried over), walks the points in tiles of 32 rows, and writes only
// the logits: no activation touches device memory. The products are plain f32
// FMA loops (onf_common.cuh); tensor cores would change the f32 numerics.
#include "onf_common.cuh"

using namespace nf;

__global__ void __launch_bounds__(THREADS, 1)
onf_forward_kernel(const float* __restrict__ x, int M, int dim, NetArgs n,
                   float* __restrict__ out) {
  extern __shared__ float4 smem_f4[];
  float* s = reinterpret_cast<float*>(smem_f4);
  const Layout L = make_layout(n, 0);
  const int b = blockIdx.x;
  load_weights(n, L, b, s);
  x += (size_t)b * M * dim;
  out += (size_t)b * M;
  for (int row0 = 0; row0 < M; row0 += TM) {
    forward_tile(x, M, dim, row0, n, L, s);
    if (threadIdx.x < TM && row0 + threadIdx.x < M) out[row0 + threadIdx.x] = s[L.z + threadIdx.x];
  }
}

extern "C" const char* nf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int nf_onf_forward(const NetArgs* net, const float* x, int B, int M, int dim,
                              float* out, void* stream) {
  const Layout L = make_layout(*net, 0);
  size_t bytes;
  cudaError_t err = prepare_launch(onf_forward_kernel, L, &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  onf_forward_kernel<<<B, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(x, M, dim, *net,
                                                                               out);
  return static_cast<int>(cudaGetLastError());
}
