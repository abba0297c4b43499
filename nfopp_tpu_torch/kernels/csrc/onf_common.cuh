// Shared pieces of the ONF kernels (onf_forward.cu, onf_multi.cu,
// field_grad.cuh, collision_terms.cu): one CTA per problem holds that
// problem's whole field in shared memory and walks the problem's points in
// tiles of TM rows.
//
// Shared-memory picture for the full-width field (F=200 Fourier + A=20
// angle features, hidden 100):
//   weights   W1 [220 x 101], W2 [100 x 101] (rows padded to an odd stride so
//             that both W[k][c] and W[c][k] walks are free of bank conflicts),
//             out.w, encoding w/b, biases               ~131 KB
//   tiles     features, h1, h2, stored transposed [column][TM + 4]   ~59 KB
// which fits the 227 KB a CTA may take. Every product is an f32 FMA loop on
// the CUDA cores: thread (column slot c, row group) keeps 16 row sums in
// registers, reads its weight column once per k and the activation rows as
// broadcast float4 loads.
//
// Operand rounding (template parameter P of every kernel). A bf16 mode rounds
// a product's operands to bf16 and accumulates in f32; since bf16 x bf16 is
// exact in f32, rounding the weights as they are loaded into shared memory
// and the activations as they are written into the tiles, then running the
// same f32 FMA loops, is the arithmetic of a bf16 product with f32
// accumulation. Values stay f32 in shared memory.
//   F32         no rounding (kernels 1-3, and kernels 4-5 in f32);
//   BF16_MULTI  the TPU kernels onf_multi.py / field_grad_multi.py: encoding
//               layer in f32, every MLP and head product's operands rounded
//               (weights, features, h1, h2, and in the backward the
//               cotangents g, dh2, dh1 where they enter a product);
//   BF16_APPLY  models/onf.py::onf_apply's casts (the production solver's
//               bf16 kernels): as BF16_MULTI but xy and the encoding weights rounded
//               too; its backward is the autograd of those casts, which
//               rounds each cotangent once, where it passes back through a
//               cast, after its f32 product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace nf {

constexpr int TM = 32;                     // rows per tile, one per lane
constexpr int LDT = TM + 4;                // stride of a transposed tile column
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CSLOTS = 128;                // column slots (hidden <= 128)
constexpr int RGROUPS = THREADS / CSLOTS;  // row groups
constexpr int RPT = TM / RGROUPS;          // rows per thread in the products
constexpr int MAX_SMEM = 232448;           // bytes a CTA may use on sm_90
static_assert(TM == 32, "row-wise steps put one row on each lane of a warp");
static_assert(RPT % 4 == 0, "rows are read as float4");

constexpr int F32 = 0;
constexpr int BF16_MULTI = 1;
constexpr int BF16_APPLY = 2;

// v rounded to the nearest bf16 (ties to even) under the bf16 modes.
template <int P>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (P == F32) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
}

// The encoding layer's operands (xy and the encoding weights) are rounded
// only under BF16_APPLY.
template <int P>
__device__ __forceinline__ float rnd_enc(float v) {
  return P == BF16_APPLY ? rnd<P>(v) : v;
}

// One batch of fields: every pointer is [B, ...] contiguous, f32.
struct NetArgs {
  const float *ew, *eb, *w1, *b1, *w2, *b2, *w3, *b3, *ab;
  int F, A, HID, use_cos, bias;
  float mean, sigma;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline int take(int& offset, int count) {
  const int at = offset;
  offset += round4(count);
  return at;
}

// Offsets, in floats, of one CTA's shared memory; every offset is 16-byte
// aligned. `acc` is the start of a kernel's own extra region.
struct Layout {
  int FEAT, ldw1, ldw2;
  int w1, w2, w3, ew, eb, b1, b2, ab, b3;
  int feat, h1, h2;
  int xn, yn, th, z, g;
  int acc, total;
};

__host__ __device__ inline Layout make_layout(const NetArgs& n, int extra) {
  Layout L;
  L.FEAT = n.F + n.A;
  L.ldw1 = n.HID | 1;
  L.ldw2 = n.HID | 1;
  int o = 0;
  L.w1 = take(o, L.FEAT * L.ldw1);
  L.w2 = take(o, n.HID * L.ldw2);
  L.w3 = take(o, n.HID + L.FEAT);
  L.ew = take(o, 2 * n.F);
  L.eb = take(o, n.F);
  L.b1 = take(o, n.HID);
  L.b2 = take(o, n.HID);
  L.ab = take(o, n.A);
  L.b3 = take(o, 1);
  L.feat = take(o, L.FEAT * LDT);
  L.h1 = take(o, n.HID * LDT);
  L.h2 = take(o, n.HID * LDT);
  L.xn = take(o, TM);
  L.yn = take(o, TM);
  L.th = take(o, TM);
  L.z = take(o, TM);
  L.g = take(o, TM);
  L.acc = take(o, extra);
  L.total = o;
  return L;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dst[i] = src[i], rounded to bf16 when `R` is a bf16 mode.
template <int R>
__device__ inline void copy_to_shared(float* dst, const float* src, int count) {
  for (int i = threadIdx.x; i < count; i += THREADS) dst[i] = rnd<R>(src[i]);
}

// Problem b's weights into shared memory; the weight matrices rounded under
// the bf16 modes, the encoding weights only under BF16_APPLY, biases never.
template <int P>
__device__ inline void load_weights(const NetArgs& n, const Layout& L, int b, float* s) {
  const int F = n.F, A = n.A, HID = n.HID, FEAT = L.FEAT;
  const float* w1 = n.w1 + (size_t)b * FEAT * HID;
  for (int i = threadIdx.x; i < FEAT * HID; i += THREADS) {
    const int k = i / HID, c = i - k * HID;
    s[L.w1 + k * L.ldw1 + c] = rnd<P>(w1[i]);
  }
  const float* w2 = n.w2 + (size_t)b * HID * HID;
  for (int i = threadIdx.x; i < HID * HID; i += THREADS) {
    const int k = i / HID, c = i - k * HID;
    s[L.w2 + k * L.ldw2 + c] = rnd<P>(w2[i]);
  }
  copy_to_shared<P>(s + L.w3, n.w3 + (size_t)b * (HID + FEAT), HID + FEAT);
  copy_to_shared<P == BF16_APPLY ? P : F32>(s + L.ew, n.ew + (size_t)b * 2 * F, 2 * F);
  copy_to_shared<F32>(s + L.eb, n.eb + (size_t)b * F, F);
  copy_to_shared<F32>(s + L.b1, n.b1 + (size_t)b * HID, HID);
  copy_to_shared<F32>(s + L.b2, n.b2 + (size_t)b * HID, HID);
  if (A > 0) copy_to_shared<F32>(s + L.ab, n.ab + (size_t)b * A, A);
  if (threadIdx.x == 0) s[L.b3] = n.b3[b];
}

// Rows row0 .. row0+TM of x [M, dim] (this problem's), normalised (and
// rounded under BF16_APPLY); rows past M read as the origin and are masked
// by the callers.
template <int P>
__device__ inline void load_rows(const float* x, int M, int dim, int row0, const NetArgs& n,
                                 const Layout& L, float* s) {
  const int t = threadIdx.x;
  if (t < TM) {
    const int row = row0 + t;
    float px = 0.f, py = 0.f, pt = 0.f;
    if (row < M) {
      const float* p = x + (size_t)row * dim;
      px = p[0];
      py = p[1];
      if (dim > 2) pt = p[2];
    }
    s[L.xn + t] = rnd_enc<P>((px - n.mean) / n.sigma);
    s[L.yn + t] = rnd_enc<P>((py - n.mean) / n.sigma);
    s[L.th + t] = pt;
  }
}

// Pre-activation of Fourier feature k at tile row r (the K=2 encoding layer
// as two FMAs).
__device__ __forceinline__ float fourier_pre(const NetArgs& n, const Layout& L, const float* s,
                                             int k, int r) {
  float e = s[L.xn + r] * s[L.ew + k] + s[L.yn + r] * s[L.ew + n.F + k];
  if (n.bias) e += s[L.eb + k];
  return e;
}

// Phase of angle feature a at tile row r, and its frequency.
__device__ __forceinline__ float angle_phase(const NetArgs& n, const Layout& L, const float* s,
                                             int a, int r, float* freq) {
  const int h = n.A / 2;
  *freq = (float)(a % h + 1);
  return (s[L.th + r] + s[L.ab + a]) * *freq;
}

template <int P>
__device__ inline void features(const NetArgs& n, const Layout& L, float* s) {
  for (int i = threadIdx.x; i < L.FEAT * TM; i += THREADS) {
    const int k = i / TM, r = i - k * TM;
    float v;
    if (k < n.F) {
      const float e = fourier_pre(n, L, s, k, r);
      v = (n.use_cos && k >= n.F / 2) ? cosf(e) : sinf(e);
    } else {
      float f;
      const float ph = angle_phase(n, L, s, k - n.F, r, &f);
      v = (k - n.F < n.A / 2) ? sinf(ph) : cosf(ph);
    }
    s[L.feat + k * LDT + r] = rnd<P>(v);
  }
}

// acc[q] += sum_k at[k * LDT + q] * w[k * sk]  (q < RPT). `at` points at the
// thread's first row of a transposed tile, `w` at its weight column (sk =
// row stride) or weight row (sk = 1).
__device__ __forceinline__ void mm_rows(const float* __restrict__ at, int K,
                                        const float* __restrict__ w, int sk, float acc[RPT]) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float wk = w[k * sk];
    const float4* a = reinterpret_cast<const float4*>(at + k * LDT);
#pragma unroll
    for (int q = 0; q < RPT / 4; ++q) {
      const float4 v = a[q];
      acc[4 * q + 0] = fmaf(v.x, wk, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(v.y, wk, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(v.z, wk, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(v.w, wk, acc[4 * q + 3]);
    }
  }
}

// out[c][r] = relu(sum_k in[k][r] * W[k][c] + bias[c]) for c < N, stored
// rounded under the bf16 modes (it is the next product's operand).
template <int P>
__device__ inline void dense_relu(const float* s_in, int K, const float* s_w, int ldw,
                                  const float* s_b, int N, float* s_out) {
  const int c = threadIdx.x % CSLOTS, r0 = (threadIdx.x / CSLOTS) * RPT;
  if (c >= N) return;
  float acc[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) acc[q] = 0.f;
  mm_rows(s_in + r0, K, s_w + c, ldw, acc);
  const float bc = s_b[c];
  float4* o = reinterpret_cast<float4*>(s_out + c * LDT + r0);
#pragma unroll
  for (int q = 0; q < RPT / 4; ++q)
    o[q] = make_float4(rnd<P>(fmaxf(acc[4 * q] + bc, 0.f)), rnd<P>(fmaxf(acc[4 * q + 1] + bc, 0.f)),
                       rnd<P>(fmaxf(acc[4 * q + 2] + bc, 0.f)),
                       rnd<P>(fmaxf(acc[4 * q + 3] + bc, 0.f)));
}

// z[r] = [h2 | features][r] . out.w + out.b, one warp per row.
__device__ inline void head(const NetArgs& n, const Layout& L, float* s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = n.HID + L.FEAT;
  for (int r = warp; r < TM; r += WARPS) {
    float acc = 0.f;
    for (int j = lane; j < len; j += 32) {
      const float a = j < n.HID ? s[L.h2 + j * LDT + r] : s[L.feat + (j - n.HID) * LDT + r];
      acc = fmaf(a, s[L.w3 + j], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) s[L.z + r] = acc + s[L.b3];
  }
}

// The whole forward of one tile; leaves features, h1, h2 and z in shared
// memory. Starts by overwriting the row buffers, so callers sync between
// tiles once every read of the previous tile is done.
template <int P>
__device__ inline void forward_tile(const float* x, int M, int dim, int row0, const NetArgs& n,
                                    const Layout& L, float* s) {
  load_rows<P>(x, M, dim, row0, n, L, s);
  __syncthreads();
  features<P>(n, L, s);
  __syncthreads();
  dense_relu<P>(s + L.feat, L.FEAT, s + L.w1, L.ldw1, s + L.b1, n.HID, s + L.h1);
  __syncthreads();
  dense_relu<P>(s + L.h1, n.HID, s + L.w2, L.ldw2, s + L.b2, n.HID, s + L.h2);
  __syncthreads();
  head(n, L, s);
  __syncthreads();
}

// g * w for a cotangent g (d logits of a row) entering a product with the
// head weight w (already rounded): BF16_MULTI rounds the operand g,
// BF16_APPLY the product.
template <int P>
__device__ __forceinline__ float head_cotangent(float g, float w) {
  if constexpr (P == BF16_APPLY) {
    return rnd<P>(g * w);
  } else {
    return rnd<P>(g) * w;
  }
}

// Launch helper: checks and sets the dynamic shared memory of `kernel`.
template <typename Kernel>
inline cudaError_t prepare_launch(Kernel kernel, const Layout& L, size_t* bytes) {
  *bytes = (size_t)L.total * sizeof(float);
  if (*bytes > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

// Logits of a batch of fields at their query points (kernels 1 and 5): one
// CTA per problem, the field in shared memory, only the logits written.
template <int P>
__global__ void __launch_bounds__(THREADS, 1)
onf_logits_kernel(const float* __restrict__ x, int M, int dim, NetArgs n, float* __restrict__ out) {
  extern __shared__ float4 smem_f4[];
  float* s = reinterpret_cast<float*>(smem_f4);
  const Layout L = make_layout(n, 0);
  const int b = blockIdx.x;
  load_weights<P>(n, L, b, s);
  x += (size_t)b * M * dim;
  out += (size_t)b * M;
  for (int row0 = 0; row0 < M; row0 += TM) {
    forward_tile<P>(x, M, dim, row0, n, L, s);
    if (threadIdx.x < TM && row0 + threadIdx.x < M) out[row0 + threadIdx.x] = s[L.z + threadIdx.x];
  }
}

template <int P>
inline int launch_onf_logits(const NetArgs* net, const float* x, int B, int M, int dim,
                             float* out, void* stream) {
  const Layout L = make_layout(*net, 0);
  size_t bytes;
  cudaError_t err = prepare_launch(onf_logits_kernel<P>, L, &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  onf_logits_kernel<P><<<B, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(x, M, dim, *net,
                                                                                 out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nf
