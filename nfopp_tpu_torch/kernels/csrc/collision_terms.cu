// Collision terms of the trajectory loss, forward and backward, for a batch of
// problems with frozen fields:
//   forward:  out[b] = (sum_m softplus_beta(z_bm), sum_m mu_bm * tanh(z_bm))
//   backward: d positions [b, m, dim] and d multipliers [b, m] from the two
//             cotangents g[b] = (g1, g2); no parameter gradients.
//
// Replaces the TPU kernels
// nfopp_tpu/experimental/pallas/collision_terms.py::_fwd_kernel and ::_bwd_kernel
// (M = N - 1 = 99 segment samples per problem on the main path).
//
// Bound on this card: f32 FMAs. Forward ~32.7k and forward + input backward
// ~65k multiply-adds per pose: at B=256 x M=99, ~1.7 and ~3.3 GFLOP, about 25
// and 49 us at 67 TFLOP/s, against ~34 MB of weights (~10 us at 3.35 TB/s)
// (H100 SXM data sheet rates). In bf16 the operations take ~2 and ~3 us at
// 989 TFLOP/s, and the bytes bound them.
// Design: one CTA per problem with the field in shared memory (onf_common.cuh).
// The backward recomputes the forward of each tile, as the TPU kernel does,
// then walks back through the head, both ReLU layers (W^T products read the
// odd-strided weight rows without bank conflicts) and the encodings. The
// per-problem sums are reduced in a fixed order, so results repeat bit for
// bit from run to run.
//
// Two instantiations: F32 (kernels 3a/3b), and BF16_APPLY, the trajectory
// step's collision terms under compute_dtype="bfloat16". The solver computes
// them through models/onf.py::onf_apply, whose casts round xy and the
// encoding weights too, and whose autograd rounds each cotangent once where
// it passes back through a cast (d h2, d h1, each of the two d feature terms,
// d xy); BF16_APPLY does the same.
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
__global__ void __launch_bounds__(THREADS, 1)
collision_bwd_kernel(const float* __restrict__ x, const float* __restrict__ mult,
                     const float* __restrict__ g, int M, int dim, NetArgs n, float beta,
                     float* __restrict__ dx, float* __restrict__ dmult) {
  extern __shared__ float4 smem_f4[];
  float* s = reinterpret_cast<float*>(smem_f4);
  const Layout L = make_layout(n, 0);
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int cs = tid % CSLOTS, r0 = (tid / CSLOTS) * RPT;
  const int F = n.F, FEAT = L.FEAT;
  load_weights<P>(n, L, b, s);
  x += (size_t)b * M * dim;
  mult += (size_t)b * M;
  dx += (size_t)b * M * dim;
  dmult += (size_t)b * M;
  const float g1 = g[2 * b], g2 = g[2 * b + 1];
  for (int row0 = 0; row0 < M; row0 += TM) {
    forward_tile<P>(x, M, dim, row0, n, L, s);
    // d logits per row; d multipliers
    if (tid < TM) {
      const int row = row0 + tid;
      float gz = 0.f;
      if (row < M) {
        const float z = s[L.z + tid];
        const float th = tanhf(z);
        const float sig = 1.f / (1.f + expf(-beta * z));
        gz = g1 * sig + g2 * mult[row] * (1.f - th * th);
        dmult[row] = g2 * th;
      }
      s[L.g + tid] = gz;
    }
    __syncthreads();
    head_backprop<P>(n, L, s);  // h2 := d pre2
    __syncthreads();
    relu_backprop<P>(s + L.h2, n.HID, s + L.w2, L.ldw2, n.HID, s + L.h1);  // h1 := d pre1
    __syncthreads();
    // d features -> d pre-activations (x the angle frequency), over the
    // feature tile, which the backward no longer reads
    for (int k = cs; k < FEAT; k += CSLOTS) {
      float acc[RPT];
      feature_grad<P>(n, L, s, k, acc);
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        float f;
        const float d = feature_pre_grad(n, L, s, k, r0 + q, acc[q], &f);
        s[L.feat + k * LDT + r0 + q] = k < F ? d : d * f;
      }
    }
    __syncthreads();
    // per row: x, y through the encoding weights (the cotangent of the
    // rounded xy under BF16_APPLY, then / sigma), theta through the angle
    // phases
    for (int r = warp; r < TM; r += WARPS) {
      float ax = 0.f, ay = 0.f, at = 0.f;
      for (int k = lane; k < FEAT; k += 32) {
        const float d = s[L.feat + k * LDT + r];
        if (k < F) {
          ax = fmaf(d, s[L.ew + k], ax);
          ay = fmaf(d, s[L.ew + F + k], ay);
        } else {
          at += d;
        }
      }
      ax = rnd_enc<P>(warp_sum(ax));
      ay = rnd_enc<P>(warp_sum(ay));
      at = warp_sum(at);
      const int row = row0 + r;
      if (lane == 0 && row < M) {
        float* p = dx + (size_t)row * dim;
        p[0] = ax / n.sigma;
        p[1] = ay / n.sigma;
        if (dim > 2) p[2] = at;
      }
    }
    __syncthreads();
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

template <int P>
int launch_collision_bwd(const NetArgs* net, const float* x, const float* mult, const float* g,
                         int B, int M, int dim, float beta, float* dx, float* dmult,
                         void* stream) {
  const Layout L = make_layout(*net, 0);
  size_t bytes;
  cudaError_t err = prepare_launch(collision_bwd_kernel<P>, L, &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  collision_bwd_kernel<P><<<B, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, mult, g, M, dim, *net, beta, dx, dmult);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nf_collision_fwd(const NetArgs* net, const float* x, const float* mult, int B,
                                int M, int dim, float beta, int bf16, float* out, void* stream) {
  return bf16 ? launch_collision_fwd<BF16_APPLY>(net, x, mult, B, M, dim, beta, out, stream)
              : launch_collision_fwd<F32>(net, x, mult, B, M, dim, beta, out, stream);
}

extern "C" int nf_collision_bwd(const NetArgs* net, const float* x, const float* mult,
                                const float* g, int B, int M, int dim, float beta, int bf16,
                                float* dx, float* dmult, void* stream) {
  return bf16 ? launch_collision_bwd<BF16_APPLY>(net, x, mult, g, B, M, dim, beta, dx, dmult,
                                                 stream)
              : launch_collision_bwd<F32>(net, x, mult, g, B, M, dim, beta, dx, dmult, stream);
}
