// Collision terms of the trajectory loss, forward (kernel 3a), for a batch of
// problems with frozen fields:
//   out[b] = (sum_m softplus_beta(z_bm), sum_m mu_bm * tanh(z_bm)).
// The backward (kernel 3b) is in collision_bwd.cu.
//
// Replaces the TPU kernel
// nfopp_tpu/experimental/pallas/collision_terms.py::_fwd_kernel
// (M = N - 1 = 99 segment samples per problem on the main path).
//
// Bound on this card (H100 SXM data sheet rates): ~32.7k multiply-adds per
// pose, at B=256 x M=99 ~1.7 GFLOP, 25 us at 67 TFLOP/s in f32, against ~34
// MB of weights (10 us at 3.35 TB/s); in bf16 the operations take ~2 us at
// 989 TFLOP/s, and the bytes bound it.
// Design: forward.cuh's forward over the problem's poses, in its two
// families (bf16 on the tensor cores, 16-row tiles, two CTAs per SM; f32 on
// register-blocked FMA tiles, 16 warps). The epilogue takes each row's
// softplus_beta(z) and mu tanh(z) into the running sums of the lane that
// holds the row's slot in its tile (row mod the tile's rows), tile after
// tile; at the end the slots' sums are added in slot order. A fixed order
// and no atomics, so results repeat bit for bit.
//
// Two instantiations: F32, and BF16_APPLY, the trajectory step's collision
// terms under compute_dtype="bfloat16", computed by the solver through
// models/onf.py::onf_apply, whose casts round xy and the encoding weights too.
//
// Live rows (NetArgs::live, set while the tracked loop runs a chunk with
// stopped problems): a skipped problem's CTA writes (0, 0) and returns, so the
// f32 kernel (one CTA per SM) runs its live problems in one wave when at most
// 132 are live. The loop throws a stopped problem's step away; zeros, not
// the untouched torch.empty output, keep that row's trajectory loss finite
// and repeatable.
#include "forward.cuh"

using namespace nf;

namespace {

template <int P>
__device__ inline void collision_sums(const float* x, const float* mult, int M, int dim,
                                      const NetArgs& n, float beta, float* out, float4* smem) {
  constexpr int ROWS = Fwd<P>::ROWS, WARPS = Fwd<P>::WARPS;
  if (skipped(n)) {
    if (threadIdx.x == 0) out[2 * blockIdx.x] = out[2 * blockIdx.x + 1] = 0.f;
    return;
  }
  float soft = 0.f, mt = 0.f;  // this lane's row slot, summed over the tiles
  float* part = forward_problem<P>(x, mult, M, dim, n, smem, [&](int row, float z, float mu) {
    if (row < M) {
      const float scaled = beta * z;
      soft += scaled > 20.f ? z : log1pf(expf(scaled)) / beta;
      mt += mu * tanhf(z);
    }
  });
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < ROWS / WARPS) {
    const int r = warp + WARPS * lane;
    part[2 * r] = soft;
    part[2 * r + 1] = mt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, c = 0.f;
    for (int r = 0; r < ROWS; ++r) {
      a += part[2 * r];
      c += part[2 * r + 1];
    }
    out[2 * blockIdx.x] = a;
    out[2 * blockIdx.x + 1] = c;
  }
}

template <int P>
__global__ void __launch_bounds__(FB_THREADS, FB_CTAS_PER_SM)
collision_fwd_tc_kernel(const float* __restrict__ x, const float* __restrict__ mult, int M,
                        int dim, NetArgs n, float beta, float* __restrict__ out) {
  static_assert(P == BF16_APPLY, "the bf16 collision terms take onf_apply's casts");
  extern __shared__ float4 smem_f4[];
  collision_sums<P>(x, mult, M, dim, n, beta, out, smem_f4);
}

template <int P>
__global__ void __launch_bounds__(FF_THREADS, 1)
collision_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ mult, int M,
                         int dim, NetArgs n, float beta, float* __restrict__ out) {
  static_assert(P == F32, "the bf16 mode runs collision_fwd_tc_kernel");
  extern __shared__ float4 smem_f4[];
  collision_sums<P>(x, mult, M, dim, n, beta, out, smem_f4);
}

template <int P>
int launch_collision_fwd(const NetArgs* net, const float* x, const float* mult, int B, int M,
                         int dim, float beta, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t bytes;
  if constexpr (P == F32) {
    const int err = prepare_forward<P>(collision_fwd_f32_kernel<P>, *net, &bytes);
    if (err != 0) return err;
    collision_fwd_f32_kernel<P><<<B, FF_THREADS, bytes, s>>>(x, mult, M, dim, *net, beta, out);
  } else {
    const int err = prepare_forward<P>(collision_fwd_tc_kernel<P>, *net, &bytes);
    if (err != 0) return err;
    collision_fwd_tc_kernel<P><<<B, FB_THREADS, bytes, s>>>(x, mult, M, dim, *net, beta, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nf_collision_fwd(const NetArgs* net, const float* x, const float* mult, int B,
                                int M, int dim, float beta, int bf16, float* out, void* stream) {
  return bf16 ? launch_collision_fwd<BF16_APPLY>(net, x, mult, B, M, dim, beta, out, stream)
              : launch_collision_fwd<F32>(net, x, mult, B, M, dim, beta, out, stream);
}
