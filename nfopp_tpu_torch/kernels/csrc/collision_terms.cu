// Collision terms of the trajectory loss, forward (kernel 3a), for a batch of
// problems with frozen fields:
//   out[b] = (sum_m softplus_beta(z_bm), sum_m mu_bm * tanh(z_bm)).
// The backward (kernel 3b) is in collision_bwd.cu.
//
// Replaces the TPU kernel
// nfopp_tpu/experimental/pallas/collision_terms.py::_fwd_kernel
// (M = N - 1 = 99 segment samples per problem on the main path).
//
// Bound on this card: f32 FMAs. ~32.7k multiply-adds per pose: at B=256 x
// M=99, ~1.7 GFLOP, about 25 us at 67 TFLOP/s, against ~34 MB of weights
// (~10 us at 3.35 TB/s) (H100 SXM data sheet rates). In bf16 the operations
// take ~2 us at 989 TFLOP/s, and the bytes bound it.
// Design: one CTA per problem with the field in shared memory (onf_common.cuh),
// the per-problem sums reduced in a fixed order, so results repeat bit for
// bit from run to run.
//
// Two instantiations: F32, and BF16_APPLY, the trajectory step's collision
// terms under compute_dtype="bfloat16", computed by the solver through
// models/onf.py::onf_apply, whose casts round xy and the encoding weights too.
#include "onf_common.cuh"

using namespace nf;

template <int P>
__global__ void __launch_bounds__(THREADS, 1)
collision_fwd_kernel(const float* __restrict__ x, const float* __restrict__ mult, int M, int dim,
                     NetArgs n, float beta, float* __restrict__ out) {
  extern __shared__ float4 smem_f4[];
  float* s = reinterpret_cast<float*>(smem_f4);
  const Layout L = make_layout(n, 0);
  const int b = blockIdx.x, lane = threadIdx.x % 32;
  load_weights<P>(n, L, b, s);
  x += (size_t)b * M * dim;
  mult += (size_t)b * M;
  float sum_soft = 0.f, sum_mt = 0.f;  // held by thread 0
  for (int row0 = 0; row0 < M; row0 += TM) {
    forward_tile<P>(x, M, dim, row0, n, L, s);
    if (threadIdx.x < 32) {
      const int row = row0 + lane;
      float soft = 0.f, mt = 0.f;
      if (row < M) {
        const float z = s[L.z + lane];
        const float scaled = beta * z;
        soft = scaled > 20.f ? z : log1pf(expf(scaled)) / beta;
        mt = mult[row] * tanhf(z);
      }
      soft = warp_sum(soft);
      mt = warp_sum(mt);
      sum_soft += soft;
      sum_mt += mt;
    }
  }
  if (threadIdx.x == 0) {
    out[2 * b] = sum_soft;
    out[2 * b + 1] = sum_mt;
  }
}

template <int P>
int launch_collision_fwd(const NetArgs* net, const float* x, const float* mult, int B, int M,
                         int dim, float beta, float* out, void* stream) {
  const Layout L = make_layout(*net, 0);
  size_t bytes;
  cudaError_t err = prepare_launch(collision_fwd_kernel<P>, L, &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  collision_fwd_kernel<P><<<B, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, mult, M, dim, *net, beta, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nf_collision_fwd(const NetArgs* net, const float* x, const float* mult, int B,
                                int M, int dim, float beta, int bf16, float* out, void* stream) {
  return bf16 ? launch_collision_fwd<BF16_APPLY>(net, x, mult, B, M, dim, beta, out, stream)
              : launch_collision_fwd<F32>(net, x, mult, B, M, dim, beta, out, stream);
}
