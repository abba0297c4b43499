// Field training step for a batch of problems (kernels 2 and 4): the ONF
// forward on M labelled points, the mean BCE-with-logits loss, and the
// gradient of every parameter (encoding w/b, mlp1, mlp2, out, angle biases);
// no input gradients.
//
// Design: one CTA per problem, field in shared memory (onf_common.cuh). The
// two big gradients (W1 220x100, W2 100x100: another 128 KB) do not fit in
// shared memory beside the weights and the tiles, so each tile adds its
// contribution to the problem's own slice of the output: the first tile
// stores, later tiles read-modify-write, each element always by the same
// thread. No atomics: the sums are taken in one fixed order and repeat bit
// for bit from run to run. The small gradients (out.w, biases, encoding,
// angle biases) accumulate in shared memory and are written once.
//
// Under BF16_MULTI (the TPU kernel field_grad_multi.py::_kernel) every
// product rounds both operands, the cotangents g, dh2 and dh1 included,
// while the row sums of the bias and encoding gradients take the f32
// cotangents: d_b3 sums g before it is rounded, d_b2 and d_b1 sum dh2 and
// dh1 before the tile is rounded in place, and the encoding and angle-bias
// sums never see a rounded value. The ReLU masks come from the f32
// pre-activations (h > 0 holds for bf16(h) as for h).
#pragma once

#include "onf_common.cuh"

namespace nf {

struct Grads {
  float *ew, *eb, *w1, *b1, *w2, *b2, *w3, *b3, *ab;
};

// Offsets of the shared-memory gradient accumulators, relative to Layout.acc.
struct GradLayout {
  int w3, b1, b2, ew, eb, ab, b3, size;
};

__host__ __device__ inline GradLayout grad_layout(const NetArgs& n) {
  GradLayout G;
  int o = 0;
  G.w3 = take(o, n.HID + n.F + n.A);
  G.b1 = take(o, n.HID);
  G.b2 = take(o, n.HID);
  G.ew = take(o, 2 * n.F);
  G.eb = take(o, n.F);
  G.ab = take(o, n.A);
  G.b3 = take(o, 1);
  G.size = o;
  return G;
}

// out[k][c] (+)= sum_r aT[k][r] * bT[c][r] for k < K, c < N: thread (c, part)
// holds column c of bT in registers and walks its share of k. The first tile
// stores, later tiles add to what the same thread stored.
__device__ inline void outer_accumulate(const float* aT, int K, const float* bT, int N,
                                        float* __restrict__ out, bool first) {
  const int c = threadIdx.x % CSLOTS, part = threadIdx.x / CSLOTS;
  if (c >= N) return;
  float bc[TM];
  const float4* bp = reinterpret_cast<const float4*>(bT + c * LDT);
#pragma unroll
  for (int q = 0; q < TM / 4; ++q) {
    const float4 v = bp[q];
    bc[4 * q] = v.x;
    bc[4 * q + 1] = v.y;
    bc[4 * q + 2] = v.z;
    bc[4 * q + 3] = v.w;
  }
  const int per = (K + RGROUPS - 1) / RGROUPS;
  const int k0 = part * per, k1 = min(K, k0 + per);
  for (int k = k0; k < k1; ++k) {
    const float4* ap = reinterpret_cast<const float4*>(aT + k * LDT);
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < TM / 4; ++q) {
      const float4 v = ap[q];
      acc = fmaf(v.x, bc[4 * q], acc);
      acc = fmaf(v.y, bc[4 * q + 1], acc);
      acc = fmaf(v.z, bc[4 * q + 2], acc);
      acc = fmaf(v.w, bc[4 * q + 3], acc);
    }
    float* p = out + (size_t)k * N + c;
    *p = first ? acc : *p + acc;
  }
}

// acc += sum of column colT's TM rows (f32), then the column rounded in place
// under the bf16 modes: it is the operand of the products that follow.
template <int P>
__device__ inline void row_sum_then_round(float* colT, float* acc) {
  float sum = 0.f;
#pragma unroll
  for (int r = 0; r < TM; ++r) sum += colT[r];
  *acc += sum;
  if constexpr (P != F32) {
#pragma unroll
    for (int r = 0; r < TM; ++r) colT[r] = rnd<P>(colT[r]);
  }
}

template <int P>
__global__ void __launch_bounds__(THREADS, 1)
field_grad_kernel(const float* __restrict__ x, const float* __restrict__ y, int M, int dim,
                  NetArgs n, float* __restrict__ loss, Grads gr) {
  extern __shared__ float4 smem_f4[];
  float* s = reinterpret_cast<float*>(smem_f4);
  const GradLayout G = grad_layout(n);
  const Layout L = make_layout(n, G.size);
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid % 32, cs = tid % CSLOTS, rg = tid / CSLOTS, r0 = rg * RPT;
  const int F = n.F, A = n.A, HID = n.HID, FEAT = L.FEAT;
  float* acc_s = s + L.acc;
  load_weights<P>(n, L, b, s);
  for (int i = tid; i < G.size; i += THREADS) acc_s[i] = 0.f;
  x += (size_t)b * M * dim;
  y += (size_t)b * M;
  float* gw1 = gr.w1 + (size_t)b * FEAT * HID;
  float* gw2 = gr.w2 + (size_t)b * HID * HID;
  const float inv_n = 1.f / (float)M;
  float loss_sum = 0.f;  // held by thread 0

  for (int row0 = 0; row0 < M; row0 += TM) {
    const bool first = row0 == 0;
    forward_tile<P>(x, M, dim, row0, n, L, s);
    // loss and d logits per row (f32)
    if (tid < 32) {
      const int row = row0 + lane;
      float bce = 0.f, gv = 0.f;
      if (row < M) {
        const float z = s[L.z + lane], t = y[row];
        bce = fmaxf(z, 0.f) - z * t + log1pf(expf(-fabsf(z)));
        gv = (1.f / (1.f + expf(-z)) - t) * inv_n;
      }
      s[L.g + lane] = gv;
      loss_sum += warp_sum(bce);
    }
    __syncthreads();
    // out.w from g (rounded as an operand) and the head's inputs [h2 |
    // features]; out.b from the f32 g
    for (int j = tid; j < HID + FEAT; j += THREADS) {
      const float* a = j < HID ? s + L.h2 + j * LDT : s + L.feat + (j - HID) * LDT;
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < TM; ++r) acc = fmaf(a[r], rnd<P>(s[L.g + r]), acc);
      acc_s[G.w3 + j] += acc;
    }
    if (tid == 0) {
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < TM; ++r) sum += s[L.g + r];
      acc_s[G.b3] += sum;
    }
    __syncthreads();
    head_backprop<P>(n, L, s);  // h2 := d pre2
    __syncthreads();
    if (tid < HID) row_sum_then_round<P>(s + L.h2 + tid * LDT, acc_s + G.b2 + tid);
    __syncthreads();
    outer_accumulate(s + L.h1, HID, s + L.h2, HID, gw2, first);  // d W2 = h1^T d pre2
    __syncthreads();
    relu_backprop<P>(s + L.h2, HID, s + L.w2, L.ldw2, HID, s + L.h1);  // h1 := d pre1
    __syncthreads();
    if (tid < HID) row_sum_then_round<P>(s + L.h1 + tid * LDT, acc_s + G.b1 + tid);
    __syncthreads();
    outer_accumulate(s + L.feat, FEAT, s + L.h1, HID, gw1, first);  // d W1 = feat^T d pre1
    // d features -> encoding and angle-bias gradients, summed over the
    // thread's rows, then added by one row group at a time
    float p0[2], p1[2], p2[2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int k = cs + kk * CSLOTS;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f;
      if (k < FEAT) {
        float acc[RPT];
        feature_grad<P>(n, L, s, k, acc);
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          const int r = r0 + q;
          float f;
          const float d = feature_pre_grad(n, L, s, k, r, acc[q], &f);
          if (k < F) {
            a0 = fmaf(s[L.xn + r], d, a0);
            a1 = fmaf(s[L.yn + r], d, a1);
            a2 += d;
          } else {
            a2 = fmaf(d, f, a2);
          }
        }
      }
      p0[kk] = a0;
      p1[kk] = a1;
      p2[kk] = a2;
    }
    for (int group = 0; group < RGROUPS; ++group) {
      if (rg == group) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int k = cs + kk * CSLOTS;
          if (k < F) {
            acc_s[G.ew + k] += p0[kk];
            acc_s[G.ew + F + k] += p1[kk];
            acc_s[G.eb + k] += p2[kk];
          } else if (k < FEAT) {
            acc_s[G.ab + k - F] += p2[kk];
          }
        }
      }
      __syncthreads();
    }
  }

  const size_t hf = (size_t)(HID + FEAT);
  for (int j = tid; j < HID + FEAT; j += THREADS) gr.w3[b * hf + j] = acc_s[G.w3 + j];
  for (int j = tid; j < HID; j += THREADS) {
    gr.b1[(size_t)b * HID + j] = acc_s[G.b1 + j];
    gr.b2[(size_t)b * HID + j] = acc_s[G.b2 + j];
  }
  for (int j = tid; j < 2 * F; j += THREADS) gr.ew[(size_t)b * 2 * F + j] = acc_s[G.ew + j];
  // bias=False: the encoding bias is not trainable and its gradient is zero
  for (int j = tid; j < F; j += THREADS) gr.eb[(size_t)b * F + j] = n.bias ? acc_s[G.eb + j] : 0.f;
  for (int j = tid; j < A; j += THREADS) gr.ab[(size_t)b * A + j] = acc_s[G.ab + j];
  if (tid == 0) {
    gr.b3[b] = acc_s[G.b3];
    loss[b] = loss_sum * inv_n;
  }
}

template <int P>
inline int launch_field_grad(const NetArgs* net, const float* x, const float* y, int B, int M,
                             int dim, float* loss, const Grads* grads, void* stream) {
  const Layout L = make_layout(*net, grad_layout(*net).size);
  size_t bytes;
  cudaError_t err = prepare_launch(field_grad_kernel<P>, L, &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  field_grad_kernel<P><<<B, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, y, M, dim, *net, loss, *grads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nf
