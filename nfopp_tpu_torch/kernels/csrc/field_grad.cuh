// Field training step for a batch of problems (kernels 2 and 4): the ONF
// forward on M labelled points, the mean BCE-with-logits loss, and the
// gradient of every parameter (encoding w/b, mlp1, mlp2, out, angle biases);
// no input gradients. One CTA per problem; no atomics, every sum in a fixed
// order, so results repeat bit for bit from launch to launch.
//
// Roundings (onf_common.cuh's template parameter P):
//   F32         no rounding (kernel 2, and kernel 4 in f32);
//   BF16_MULTI  the TPU kernel field_grad_multi.py::_kernel: every product
//               rounds both operands, the cotangents g, dh2 and dh1 included,
//               while the row sums of the bias and encoding gradients take the
//               f32 cotangents (d_b3 sums g before it is rounded, d_b2 and d_b1
//               sum dh2 and dh1 before they are); the encoding layer in f32;
//   BF16_APPLY  the production solver's bf16 field update, autograd of
//               models/onf.py::onf_apply's casts: xy and the encoding weights
//               rounded too; each activation cotangent rounded where it passes
//               back through a cast (onf_common.cuh); out.w's gradient takes
//               the f32 g; each gradient of a cast weight (encoding, mlp1,
//               mlp2, out weights) is its f32 sum over all M points rounded
//               once to bf16; the bias gradients stay f32 sums.
// The ReLU masks come from the f32 pre-activations (h > 0 holds for bf16(h) as
// for h).
//
// Bound on this card (H100 SXM data sheet rates), B=256 x M=209, full-width
// field: ~10.5 GFLOP, 156 us at 67 TFLOP/s f32 or 11 us at 989 TFLOP/s bf16,
// against ~68 MB of f32 weights in and gradients out, 20 us at 3.35 TB/s.
//
// bf16 modes (field_grad_tc_kernel): the six matrix products of a tile run on
// the tensor cores through mma.sync m16n8k16 (mma.cuh): forward feat.W1 and
// h1.W2, backward dpre2.W2^T, dpre1.W1^T, h1^T.dpre2 and feat^T.dpre1. A
// bf16 x bf16 product is exact in f32, so only the order of the f32 sums
// differs from the plain version's. mma.sync rather than wgmma: M = 209
// rows fill 14 m16 tiles with 7% padding against four 64-row wgmma tiles with
// 22%; wgmma, TMA and warp specialisation are later work. Shared memory holds
// the weights in bf16 (W1 224 x 120 and W2 112 x 120 at the full width, rows
// padded by 16 bytes so that ldmatrix reads 8 rows from 8 bank groups), the
// bf16 activation tiles of 32 rows (row-major, zero past each width), the f32
// slope of every feature (its sin/cos partner, from one sincosf with the
// feature, so the encoding gradients recompute no trig) and dW2's f32 sum:
// ~205 KB, one CTA of 16 warps per SM, so the tiles stay at 32 rows. dW1's
// f32 sum stays in the MMA accumulators of the warps that own its 16 x 8
// tiles (at most 12 per warp, 48 registers; 128 registers in all, no
// spills; a field of more than 192 such tiles, hidden > 104 at 220 features,
// is refused: TOO_LARGE). So both weight
// gradients accumulate on chip over all row tiles and are written once,
// rounded under BF16_APPLY, dW1 staged through the freed shared memory so
// that its rows are written whole. Each warp owns whole 8-column tiles of
// every other product's output (two at a time where they share A
// fragments), so each column's sum over the tile's rows (bias and encoding
// gradients) is a fixed butterfly in one warp. Epilogues work on the f32
// accumulators in registers (bias, ReLU mask, bias-gradient sums, rounding as
// they are written). The head (a 320-wide dot per row, a warp's rows at
// once) and the encoding and angle gradients stay on the CUDA cores. 8
// barriers per 32-row tile. Latency and not the tensor cores bounds it; the
// features' sincosf, the d-feature epilogue and the dW1 products are its
// largest phases.
//
// F32 (field_grad_f32_kernel): register-blocked FMA micro-tiles on the CUDA
// cores (a one-pass TF32 product would miss the f32 tolerances), 8 warps.
// Shared memory holds the f32 weights (W1, W2 [k][column], 128 KB at the
// full width) and row-major f32 tiles of 32 rows (features, h1 then d pre1,
// h2 then d pre2), rows strided 4 (mod 8) floats, and, where it fits (the
// full width: ~219 KB in all), an f32 slope tile filled by the features'
// sincosf; without it the encoding gradients recompute their sin/cos. Each
// product gives a thread 4 rows x 4 columns: the forward products (mm_nn)
// and the two with W transposed (mm_nt: d pre1 = d pre2 . W2^T, d features
// = d pre1 . W1^T) read 4 float4s of the tile and 4 of the weights for 64
// FMAs. Both weight gradients stay in registers over all row tiles: each
// thread owns 2 x 3 4x4 chunks of dW1 (96 values) and 1 x 3 of dW2 (48),
// and per row reads 5 (4) float4s for 96 (48) FMAs; they are written once,
// staged through the weights' space. Bias and encoding gradients are row
// sums in a fixed order (a 3-step butterfly over the 8 row groups). A field
// whose chunks need more threads than the CTA has (hidden > 108 at 220
// features) is refused (TOO_LARGE).
#pragma once

#include "mma.cuh"
#include "onf_common.cuh"

namespace nf {

struct Grads {
  float *ew, *eb, *w1, *b1, *w2, *b2, *w3, *b3, *ab;
};

// A skipped problem's loss and gradients (onf_common.cuh's `skipped`): zeros,
// by the CTA's NT threads (not inlined, as zero_row).
template <int NT>
__device__ __noinline__ void zero_grads(const NetArgs& n, float* loss, const Grads& gr) {
  const size_t b = blockIdx.x, F = n.F, A = n.A, HID = n.HID, FEAT = F + A;
  zero_row<NT>(gr.ew + b * 2 * F, 2 * F);
  zero_row<NT>(gr.eb + b * F, F);
  zero_row<NT>(gr.w1 + b * FEAT * HID, FEAT * HID);
  zero_row<NT>(gr.b1 + b * HID, HID);
  zero_row<NT>(gr.w2 + b * HID * HID, HID * HID);
  zero_row<NT>(gr.b2 + b * HID, HID);
  zero_row<NT>(gr.w3 + b * (HID + FEAT), HID + FEAT);
  zero_row<NT>(gr.b3 + b, 1);
  if (A > 0) zero_row<NT>(gr.ab + b * A, A);
  zero_row<NT>(loss + b, 1);
}

// A cast weight's gradient, rounded once after its f32 sum over all points
// under BF16_APPLY; f32 otherwise.
template <int P>
__device__ __forceinline__ float rnd_cast(float v) {
  return P == BF16_APPLY ? rnd<P>(v) : v;
}

// g as the operand of out.w's gradient: rounded under BF16_MULTI; f32 under
// F32 and BF16_APPLY (whose sum is rounded at the end)
template <int P>
__device__ __forceinline__ float w3_operand(float g) {
  return P == BF16_MULTI ? rnd<P>(g) : g;
}

// ------------------- shared with collision_bwd.cu (kernel 3b) and forward.cuh --

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float bf(float v) { return v; }

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Rows row0 .. row0 + ROWS of x [M, dim] (this problem's), normalised
// (rounded under BF16_APPLY) into xn, yn, th; rows past M read as the origin.
template <int P, int ROWS>
__device__ inline void load_poses(const float* x, int M, int dim, int row0, const NetArgs& n,
                                  float* xn, float* yn, float* th) {
  const int t = threadIdx.x;
  if (t < ROWS) {
    const int row = row0 + t;
    float px = 0.f, py = 0.f, pt = 0.f;
    if (row < M) {
      const float* p = x + (size_t)row * dim;
      px = p[0];
      py = p[1];
      if (dim > 2) pt = p[2];
    }
    xn[t] = rnd_enc<P>((px - n.mean) / n.sigma);
    yn[t] = rnd_enc<P>((py - n.mean) / n.sigma);
    th[t] = pt;
  }
}

// Problem b's f32 weights into shared memory (a CTA of NT threads): W1, W2
// [k][column] at row stride ldw (unless MATRICES is false), out.w, the
// encoding weights and biases.
template <int NT, bool MATRICES = true>
__device__ inline void load_f32_weights(const NetArgs& n, int b, float* w1, float* w2, int ldw,
                                        float* w3, float* ew, float* eb, float* b1, float* b2,
                                        float* ab) {
  const int tid = threadIdx.x, F = n.F, A = n.A, HID = n.HID, FEAT = F + A;
  if constexpr (MATRICES) {
    const float* src = n.w1 + (size_t)b * FEAT * HID;
    for (int i = tid; i < FEAT * HID; i += NT) {
      const int k = i / HID, c = i - k * HID;
      w1[k * ldw + c] = src[i];
    }
    src = n.w2 + (size_t)b * HID * HID;
    for (int i = tid; i < HID * HID; i += NT) {
      const int k = i / HID, c = i - k * HID;
      w2[k * ldw + c] = src[i];
    }
  }
  for (int i = tid; i < HID + FEAT; i += NT) w3[i] = n.w3[(size_t)b * (HID + FEAT) + i];
  for (int i = tid; i < 2 * F; i += NT) ew[i] = n.ew[(size_t)b * 2 * F + i];
  for (int i = tid; i < F; i += NT) eb[i] = n.eb[(size_t)b * F + i];
  for (int i = tid; i < HID; i += NT) {
    b1[i] = n.b1[(size_t)b * HID + i];
    b2[i] = n.b2[(size_t)b * HID + i];
  }
  for (int i = tid; i < A; i += NT) ab[i] = n.ab[(size_t)b * A + i];
}

// This lane's share of z = [h2 | features] . out.w at rows warp + WARPS q,
// q < RW (h2 and features row-major, f32 or bf16); warp_sum completes it.
template <int WARPS, int RW, typename T>
__device__ inline void head_partial(float acc[RW], const T* h2, int ldh, const T* feat, int ldf,
                                    const float* w3, int HID, int FEAT) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < RW; ++q) acc[q] = 0.f;
  for (int j = lane; j < HID; j += 32) {
    const float w = w3[j];
#pragma unroll
    for (int q = 0; q < RW; ++q) acc[q] = fmaf(bf(h2[(warp + q * WARPS) * ldh + j]), w, acc[q]);
  }
  for (int k = lane; k < FEAT; k += 32) {
    const float w = w3[HID + k];
#pragma unroll
    for (int q = 0; q < RW; ++q) acc[q] = fmaf(bf(feat[(warp + q * WARPS) * ldf + k]), w, acc[q]);
  }
}

// ------------------------------------------------------------------ F32 ----

// Returned by a launch whose field does not fit one CTA of its kernel on chip
// (shared memory, or the register tiles of the weight gradients); not a CUDA
// error code.
constexpr int TOO_LARGE = -1;

constexpr int KC = 2;  // 4-feature chunks of dW1 per thread
constexpr int CC = 3;  // 4-column chunks of dW1 and of dW2 per thread

// The smallest stride >= n floats that is 4 (mod 8): the float4s of 8
// consecutive rows at one column then fall in 8 different bank groups.
__host__ __device__ inline int stride4(int n) {
  const int v = round4(n);
  return v % 8 == 0 ? v + 4 : v;
}

// Offsets, in floats, of the f32 kernel's shared memory (each 16-byte
// aligned). Tiles are row-major [row][column] and W1, W2 [k][column], their
// columns and rows zero-padded to whole 4-wide chunks: NF chunks of features,
// NH of hidden columns. NK x NC threads own dW1's chunks (KC x CC each), NH x
// NC threads dW2's (1 x CC each). slope < 0: no room for the slope tile.
struct F32Layout {
  int FEAT, NF, NH, NK, NC, ldw, ldf, ldh;
  int w1, w2, feat, slope, h1, h2, w3, ew, eb, b1, b2, ab, xn, yn, th, g, bce;
  int gw3, gb1, gb2, gew, geb, gab, total;
};

__host__ __device__ inline F32Layout f32_layout(const NetArgs& n, bool with_slope) {
  F32Layout L;
  const int F = n.F, A = n.A, HID = n.HID;
  L.FEAT = F + A;
  L.NF = (L.FEAT + 3) / 4;
  L.NH = (HID + 3) / 4;
  L.NK = (L.NF + KC - 1) / KC;
  L.NC = (L.NH + CC - 1) / CC;
  L.ldw = stride4(4 * L.NH);
  L.ldf = stride4(4 * KC * L.NK);
  L.ldh = stride4(4 * CC * L.NC);
  int o = 0;
  L.w1 = take(o, 4 * L.NF * L.ldw);
  L.w2 = take(o, 4 * L.NH * L.ldw);
  L.feat = take(o, TM * L.ldf);
  L.slope = with_slope ? take(o, TM * L.ldf) : -1;
  L.h1 = take(o, TM * L.ldh);
  L.h2 = take(o, TM * L.ldh);
  L.w3 = take(o, HID + L.FEAT);
  L.ew = take(o, 2 * F);
  L.eb = take(o, F);
  L.b1 = take(o, 4 * L.NH);
  L.b2 = take(o, 4 * L.NH);
  L.ab = take(o, A);
  L.xn = take(o, TM);
  L.yn = take(o, TM);
  L.th = take(o, TM);
  L.g = take(o, TM);
  L.bce = take(o, TM);
  L.gw3 = take(o, HID + L.FEAT);
  L.gb1 = take(o, HID);
  L.gb2 = take(o, HID);
  L.gew = take(o, 2 * F);
  L.geb = take(o, F);
  L.gab = take(o, A);
  L.total = o;
  return L;
}

// With the slope tile where it fits (the full-width field), else without.
__host__ __device__ inline F32Layout f32_layout(const NetArgs& n) {
  const F32Layout L = f32_layout(n, true);
  return L.total * (int)sizeof(float) <= MAX_SMEM ? L : f32_layout(n, false);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Sum of v over the 8 lanes that share lane / 8 (the row groups of one
// column group), in a fixed order.
__device__ __forceinline__ float sum_row_groups(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}

// acc[i][v] += sum_k X[rg + 8 i][k] W[k][c0 + v] for a row-major tile X and
// a row-major W [k][column]; K a multiple of 4. Each step of 4 k reads 8
// float4s for 64 FMAs.
__device__ __forceinline__ void mm_nn(float acc[4][4], const float* X, int ldx, int rg, int K,
                                      const float* W, int ldw, int c0) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 a[4], w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(X + (rg + 8 * i) * ldx + k);
#pragma unroll
    for (int u = 0; u < 4; ++u) w[u] = ld4(W + (k + u) * ldw + c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float av = at(a[i], u);
        acc[i][0] = fmaf(av, w[u].x, acc[i][0]);
        acc[i][1] = fmaf(av, w[u].y, acc[i][1]);
        acc[i][2] = fmaf(av, w[u].z, acc[i][2]);
        acc[i][3] = fmaf(av, w[u].w, acc[i][3]);
      }
    }
  }
}

// acc[i][v] += sum_k X[rg + 8 i][k] W[j0 + jstep v][k] for a row-major tile X
// and a row-major W [j][k] (a product with W transposed); K a multiple of 4.
__device__ __forceinline__ void mm_nt(float acc[4][4], const float* X, int ldx, int rg, int K,
                                      const float* W, int ldw, int j0, int jstep) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 a[4], w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(X + (rg + 8 * i) * ldx + k);
#pragma unroll
    for (int v = 0; v < 4; ++v) w[v] = ld4(W + (j0 + jstep * v) * ldw + k);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        float s = acc[i][v];
        s = fmaf(a[i].x, w[v].x, s);
        s = fmaf(a[i].y, w[v].y, s);
        s = fmaf(a[i].z, w[v].z, s);
        acc[i][v] = fmaf(a[i].w, w[v].w, s);
      }
    }
  }
}

// O[r][c] = relu(sum_k X[r][k] W[k][c] + bias[c]) for the tile's TM rows and
// 4 NG columns: thread (tid % 8, tid / 8) takes rows tid % 8 + 8 i and
// columns 4 (tid / 8) .. + 3. Zero-padded weights and biases give zero
// padding columns.
__device__ inline void dense_relu_f32(const float* X, int ldx, int K, const float* W, int ldw,
                                      const float* bias, int NG, float* O, int ldo) {
  const int rg = threadIdx.x % 8, cg = threadIdx.x / 8;
  if (cg >= NG) return;
  float acc[4][4] = {};
  mm_nn(acc, X, ldx, rg, K, W, ldw, 4 * cg);
  const float4 bv = ld4(bias + 4 * cg);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(O + (rg + 8 * i) * ldo + 4 * cg) =
        make_float4(fmaxf(acc[i][0] + bv.x, 0.f), fmaxf(acc[i][1] + bv.y, 0.f),
                    fmaxf(acc[i][2] + bv.z, 0.f), fmaxf(acc[i][3] + bv.w, 0.f));
}

// Pre-activation of feature k at a row (xr, yr, tr): the encoding output of a
// Fourier feature, the phase of an angle feature; whether the feature is its
// cosine, and the phase's frequency (1 for a Fourier feature).
__device__ __forceinline__ float feature_arg(const NetArgs& n, const float* ew, const float* eb,
                                             const float* ab, float xr, float yr, float tr, int k,
                                             bool* is_cos, float* freq) {
  if (k < n.F) {
    float arg = xr * ew[k] + yr * ew[n.F + k];
    if (n.bias) arg += eb[k];
    *is_cos = n.use_cos && k >= n.F / 2;
    *freq = 1.f;
    return arg;
  }
  const int a = k - n.F;
  *freq = (float)(a % (n.A / 2) + 1);
  *is_cos = a >= n.A / 2;
  return (tr + ab[a]) * *freq;
}

// Features [row][k] of TM rows by a CTA of NT threads, and where `slope` is
// given the slope of each (d feature / d its pre-activation), from one
// sincosf.
template <int NT>
__device__ inline void f32_features(const NetArgs& n, const float* ew, const float* eb,
                                    const float* ab, const float* xn, const float* yn,
                                    const float* th, float* feat, float* slope, int ldf) {
  const int FEAT = n.F + n.A;
  for (int i = threadIdx.x; i < TM * FEAT; i += NT) {
    const int r = i / FEAT, k = i - r * FEAT;
    bool is_cos;
    float freq, sv, cv;
    sincosf(feature_arg(n, ew, eb, ab, xn[r], yn[r], th[r], k, &is_cos, &freq), &sv, &cv);
    feat[r * ldf + k] = is_cos ? cv : sv;
    if (slope) slope[r * ldf + k] = is_cos ? -sv : cv;
  }
}

// (a template, instantiated for F32 only, so that the header can be included
// by several translation units)
template <int P>
__global__ void __launch_bounds__(THREADS, 1)
field_grad_f32_kernel(const float* __restrict__ x, const float* __restrict__ y, int M, int dim,
                      NetArgs n, float* __restrict__ loss, Grads gr) {
  static_assert(P == F32, "the bf16 modes run field_grad_tc_kernel");
  extern __shared__ float4 smem_f4[];
  float* s = reinterpret_cast<float*>(smem_f4);
  const F32Layout L = f32_layout(n);
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32, rg = tid % 8;
  const int F = n.F, A = n.A, HID = n.HID, FEAT = L.FEAT, NF = L.NF, NH = L.NH, NK = L.NK,
            NC = L.NC, ldw = L.ldw, ldf = L.ldf, ldh = L.ldh;
  float *w1 = s + L.w1, *w2 = s + L.w2, *feat = s + L.feat, *h1 = s + L.h1, *h2 = s + L.h2;
  float* slope = L.slope >= 0 ? s + L.slope : nullptr;
  float *w3 = s + L.w3, *ew = s + L.ew, *eb = s + L.eb, *b1 = s + L.b1, *b2 = s + L.b2,
        *ab = s + L.ab, *xn = s + L.xn, *yn = s + L.yn, *th = s + L.th, *gs = s + L.g,
        *bces = s + L.bce;
  float *gw3 = s + L.gw3, *gb1 = s + L.gb1, *gb2 = s + L.gb2, *gew = s + L.gew,
        *geb = s + L.geb, *gab = s + L.gab;
  if (skipped(n)) {
    zero_grads<THREADS>(n, loss, gr);
    return;
  }

  // zero everything: padding rows and columns stay zero, sums start at zero
  for (int i = tid; i < L.total / 4; i += THREADS) smem_f4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  load_f32_weights<THREADS>(n, b, w1, w2, ldw, w3, ew, eb, b1, b2, ab);
  const float b3 = n.b3[b];
  x += (size_t)b * M * dim;
  y += (size_t)b * M;
  const float inv_n = 1.f / (float)M;
  float loss_sum = 0.f, b3_sum = 0.f;  // held by thread 0
  // this thread's chunks of the weight gradients, summed over all tiles in
  // registers: dW1 at feature chunks kq + NK s, column chunks cq + NC t; dW2
  // at row chunk jq, column chunks cq2 + NC t
  const int kq = tid % NK, cq = tid / NK, jq = tid % NH, cq2 = tid / NH;
  float dw1[KC][CC][4][4] = {}, dw2[CC][4][4] = {};

  for (int row0 = 0; row0 < M; row0 += TM) {
    // rows row0 .. row0 + TM (rows past M: g is zero), their features, and
    // the slopes where there is room for them
    load_poses<F32, TM>(x, M, dim, row0, n, xn, yn, th);
    __syncthreads();
    f32_features<THREADS>(n, ew, eb, ab, xn, yn, th, feat, slope, ldf);
    __syncthreads();
    dense_relu_f32(feat, ldf, 4 * NF, w1, ldw, b1, NH, h1, ldh);
    __syncthreads();
    dense_relu_f32(h1, ldh, 4 * NH, w2, ldw, b2, NH, h2, ldh);
    __syncthreads();
    // head z = [h2 | features] . out.w + out.b, then the loss and d logits of
    // each row: warp w takes rows w + 8 q, all four at once, and lane q
    // finishes row w + 8 q
    {
      float acc[4];
      head_partial<WARPS, 4>(acc, h2, ldh, feat, ldf, w3, HID, FEAT);
      float z = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[q] = warp_sum(acc[q]);
        if (lane == q) z = acc[q] + b3;
      }
      if (lane < 4) {
        const int r = warp + 8 * lane, row = row0 + r;
        float bce = 0.f, gv = 0.f;
        if (row < M) {
          const float yt = y[row];
          bce = fmaxf(z, 0.f) - z * yt + log1pf(expf(-fabsf(z)));
          gv = (1.f / (1.f + expf(-z)) - yt) * inv_n;
        }
        gs[r] = gv;
        bces[r] = bce;
      }
    }
    __syncthreads();
    // out.w's gradient from g and [h2 | features]; h2 := d pre2 and its
    // column sums (d b2); out.b and the loss by thread 0
    for (int j = tid; j < HID + FEAT; j += THREADS) {
      float acc = 0.f;
      if (j < HID) {
        const float w = w3[j];
        float sum = 0.f;
        for (int r = 0; r < TM; ++r) {
          float* hp = h2 + r * ldh + j;
          const float h = *hp, gv = gs[r];
          acc = fmaf(h, gv, acc);
          const float d = h > 0.f ? gv * w : 0.f;
          sum += d;
          *hp = d;
        }
        gb2[j] += sum;
      } else {
        const float* fp = feat + (j - HID);
        for (int r = 0; r < TM; ++r) acc = fmaf(fp[r * ldf], gs[r], acc);
      }
      gw3[j] += acc;
    }
    if (tid == 0) {
      for (int r = 0; r < TM; ++r) {
        b3_sum += gs[r];
        loss_sum += bces[r];
      }
    }
    __syncthreads();
    // dW2 += h1^T d pre2: per row, one float4 of h1 and CC of d pre2 feed
    // 4 x 4 CC FMAs
    if (cq2 < NC) {
      for (int r = 0; r < TM; ++r) {
        const float4 a = ld4(h1 + r * ldh + 4 * jq);
        float4 d[CC];
#pragma unroll
        for (int t = 0; t < CC; ++t) d[t] = ld4(h2 + r * ldh + 4 * (cq2 + NC * t));
#pragma unroll
        for (int t = 0; t < CC; ++t) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float av = at(a, u);
            dw2[t][u][0] = fmaf(av, d[t].x, dw2[t][u][0]);
            dw2[t][u][1] = fmaf(av, d[t].y, dw2[t][u][1]);
            dw2[t][u][2] = fmaf(av, d[t].z, dw2[t][u][2]);
            dw2[t][u][3] = fmaf(av, d[t].w, dw2[t][u][3]);
          }
        }
      }
    }
    __syncthreads();
    // h1 := d pre1 = [h1 > 0] * (d pre2 . W2^T) and its column sums (d b1):
    // thread (rg, jg) takes rows rg + 8 i and columns jg + NH v
    if (4 * warp < NH) {
      const bool active = tid / 8 < NH;
      const int jg = min(tid / 8, NH - 1);
      float acc[4][4] = {};
      mm_nt(acc, h2, ldh, rg, 4 * NH, w2, ldw, jg, NH);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int j = jg + NH * v;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* hp = h1 + (rg + 8 * i) * ldh + j;
          if (active) {
            const float d = *hp > 0.f ? acc[i][v] : 0.f;
            *hp = d;
            sum += d;
          }
        }
        sum = sum_row_groups(sum);
        if (active && rg == 0 && j < HID) gb1[j] += sum;
      }
    }
    __syncthreads();
    // dW1 += features^T d pre1: per row, KC float4s of features and CC of
    // d pre1 feed 16 KC CC FMAs
    if (cq < NC) {
      for (int r = 0; r < TM; ++r) {
        float4 fa[KC], hb[CC];
#pragma unroll
        for (int q = 0; q < KC; ++q) fa[q] = ld4(feat + r * ldf + 4 * (kq + NK * q));
#pragma unroll
        for (int t = 0; t < CC; ++t) hb[t] = ld4(h1 + r * ldh + 4 * (cq + NC * t));
#pragma unroll
        for (int q = 0; q < KC; ++q) {
#pragma unroll
          for (int t = 0; t < CC; ++t) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float av = at(fa[q], u);
              dw1[q][t][u][0] = fmaf(av, hb[t].x, dw1[q][t][u][0]);
              dw1[q][t][u][1] = fmaf(av, hb[t].y, dw1[q][t][u][1]);
              dw1[q][t][u][2] = fmaf(av, hb[t].z, dw1[q][t][u][2]);
              dw1[q][t][u][3] = fmaf(av, hb[t].w, dw1[q][t][u][3]);
            }
          }
        }
      }
    }
    // d features = d pre1 . W1^T + g out.w, through the encoding: the
    // encoding and angle-bias gradients of each feature; thread (rg, kg)
    // takes rows rg + 8 i and features kg + NF v, in passes of 32 groups
    for (int pass = 0; 4 * (warp + 8 * pass) < NF; ++pass) {
      const int item = tid / 8 + 32 * pass;
      const int kg = min(item, NF - 1);
      float acc[4][4] = {};
      mm_nt(acc, h1, ldh, rg, 4 * NH, w1, ldw, kg, NF);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int k = kg + NF * v;
        const bool valid = item < NF && k < FEAT;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f;
        if (valid) {
          const float w = w3[HID + k];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = rg + 8 * i;
            const float df = fmaf(gs[r], w, acc[i][v]);
            bool is_cos;
            float freq, sl;
            const float arg = feature_arg(n, ew, eb, ab, xn[r], yn[r], th[r], k, &is_cos, &freq);
            if (slope) {
              sl = slope[r * ldf + k];
            } else {
              float sv, cv;
              sincosf(arg, &sv, &cv);
              sl = is_cos ? -sv : cv;
            }
            const float d = sl * df;
            if (k < F) {
              a0 = fmaf(xn[r], d, a0);
              a1 = fmaf(yn[r], d, a1);
              a2 += d;
            } else {
              a2 = fmaf(d, freq, a2);
            }
          }
        }
        a0 = sum_row_groups(a0);
        a1 = sum_row_groups(a1);
        a2 = sum_row_groups(a2);
        if (valid && rg == 0) {
          if (k < F) {
            gew[k] += a0;
            gew[F + k] += a1;
            geb[k] += a2;
          } else {
            gab[k - F] += a2;
          }
        }
      }
    }
    __syncthreads();
  }

  // every gradient written once; dW1 and dW2 go from the registers through
  // the weights' space (free now) so that whole rows are written
  if (cq < NC) {
#pragma unroll
    for (int q = 0; q < KC; ++q)
#pragma unroll
      for (int t = 0; t < CC; ++t)
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int k = 4 * (kq + NK * q) + u, c = 4 * (cq + NC * t) + v;
            if (k < FEAT && c < HID) w1[k * HID + c] = dw1[q][t][u][v];
          }
  }
  if (cq2 < NC) {
#pragma unroll
    for (int t = 0; t < CC; ++t)
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int j = 4 * jq + u, c = 4 * (cq2 + NC * t) + v;
          if (j < HID && c < HID) w2[j * HID + c] = dw2[t][u][v];
        }
  }
  __syncthreads();
  float* gw1 = gr.w1 + (size_t)b * FEAT * HID;
  for (int i = tid; i < FEAT * HID; i += THREADS) gw1[i] = w1[i];
  float* gw2 = gr.w2 + (size_t)b * HID * HID;
  for (int i = tid; i < HID * HID; i += THREADS) gw2[i] = w2[i];
  const size_t hf = (size_t)(HID + FEAT);
  for (int j = tid; j < HID + FEAT; j += THREADS) gr.w3[b * hf + j] = gw3[j];
  for (int j = tid; j < HID; j += THREADS) {
    gr.b1[(size_t)b * HID + j] = gb1[j];
    gr.b2[(size_t)b * HID + j] = gb2[j];
  }
  for (int j = tid; j < 2 * F; j += THREADS) gr.ew[(size_t)b * 2 * F + j] = gew[j];
  // bias=False: the encoding bias is not trainable and its gradient is zero
  for (int j = tid; j < F; j += THREADS) gr.eb[(size_t)b * F + j] = n.bias ? geb[j] : 0.f;
  for (int j = tid; j < A; j += THREADS) gr.ab[(size_t)b * A + j] = gab[j];
  if (tid == 0) {
    gr.b3[b] = b3_sum;
    loss[b] = loss_sum * inv_n;
  }
}

// ----------------------------------------------------- bf16, tensor cores ----

constexpr int TR = 32;             // rows per tile: two m16 MMA tiles
constexpr int MT = TR / 16;        // m16 tiles per row tile
// 16 warps, at the 128 registers each that the register file allows them:
// with one CTA per SM, more warps hide more latency; 8, 12, 24 and 32 warps
// ran slower (32 spilled)
constexpr int TC_THREADS = 512;
constexpr int TC_WARPS = TC_THREADS / 32;
constexpr int MAX_W1_TILES = 12;   // dW1 16x8 tiles per warp held in registers (192 per CTA)

// Byte offsets of one CTA's shared memory (each 16-byte aligned) and the
// padded sizes: K* are multiples of 16 (MMA depth), N* counts of 8-column
// tiles, M* of 16-row tiles; ld* are row strides in elements.
struct TcLayout {
  int FEAT, KF, KH, NH, NF, MF, MH, ldf, ldh, ldg;
  int w1, w2, feat, h1, h2, dp1, slope, dw2;
  int w3, ew, eb, b1, b2, ab, xn, yn, th, g, bce;
  int gw3, gb1, gb2, gew, geb, gab;
  int total;
};

__host__ __device__ inline int take_bytes(int& offset, int bytes) {
  const int at = offset;
  offset += (bytes + 15) & ~15;
  return at;
}

__host__ __device__ inline TcLayout tc_layout(const NetArgs& n) {
  TcLayout L;
  const int F = n.F, A = n.A, HID = n.HID;
  L.FEAT = F + A;
  L.KF = (L.FEAT + 15) & ~15;
  L.KH = (HID + 15) & ~15;
  L.NH = (HID + 7) / 8;
  L.NF = (L.FEAT + 7) / 8;
  L.MF = L.KF / 16;
  L.MH = L.KH / 16;
  L.ldf = L.KF + 8;  // a row is an odd number of 16-byte units
  L.ldh = L.KH + 8;
  L.ldg = L.NH * 8;
  int o = 0;
  L.w1 = take_bytes(o, L.KF * L.ldh * 2);   // W1 [feature][hidden] bf16
  L.w2 = take_bytes(o, L.KH * L.ldh * 2);   // W2 [hidden][hidden] bf16
  L.feat = take_bytes(o, TR * L.ldf * 2);   // features [row][feature] bf16
  L.h1 = take_bytes(o, TR * L.ldh * 2);     // h1 [row][hidden] bf16
  L.h2 = take_bytes(o, TR * L.ldh * 2);     // h2, then d pre2
  L.dp1 = take_bytes(o, TR * L.ldh * 2);    // d pre1
  L.slope = take_bytes(o, TR * L.ldf * 4);  // d feature / d its pre-activation, f32
  L.dw2 = take_bytes(o, L.KH * L.ldg * 4);  // dW2 [hidden][hidden] f32 sum
  L.w3 = take_bytes(o, (HID + L.FEAT) * 4);
  L.ew = take_bytes(o, 2 * F * 4);
  L.eb = take_bytes(o, F * 4);
  L.b1 = take_bytes(o, L.KH * 4);
  L.b2 = take_bytes(o, L.KH * 4);
  L.ab = take_bytes(o, A * 4);
  L.xn = take_bytes(o, TR * 4);
  L.yn = take_bytes(o, TR * 4);
  L.th = take_bytes(o, TR * 4);
  L.g = take_bytes(o, TR * 4);
  L.bce = take_bytes(o, TR * 4);
  L.gw3 = take_bytes(o, (HID + L.FEAT) * 4);
  L.gb1 = take_bytes(o, HID * 4);
  L.gb2 = take_bytes(o, HID * 4);
  L.gew = take_bytes(o, 2 * F * 4);
  L.geb = take_bytes(o, F * 4);
  L.gab = take_bytes(o, A * 4);
  L.total = o;
  return L;
}

// Fragment loads (mma.cuh): A m16 x k16 at (m0, k0) of a row-major tile X
// [m][k], or of A = S^T for a row-major S [k][m]; B k16 x n8 at (k0, n0) of
// B = T^T for a row-major T [n][k], or of a row-major S [k][n].
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* X, int ld, int m0, int k0) {
  const int lane = threadIdx.x % 32, mi = lane / 8, rr = lane % 8;
  ldsm_x4(a, X + (m0 + (mi & 1) * 8 + rr) * ld + k0 + (mi >> 1) * 8);
}

__device__ __forceinline__ void load_a_trans(uint32_t a[4], const bf16* S, int ld, int m0,
                                             int k0) {
  const int lane = threadIdx.x % 32, mi = lane / 8, rr = lane % 8;
  ldsm_x4_trans(a, S + (k0 + (mi >> 1) * 8 + rr) * ld + m0 + (mi & 1) * 8);
}

__device__ __forceinline__ void load_b(uint32_t b[2], const bf16* T, int ld, int n0, int k0) {
  const int lane = threadIdx.x % 32, mi = (lane / 8) & 1, rr = lane % 8;
  ldsm_x2(b, T + (n0 + rr) * ld + k0 + mi * 8);
}

__device__ __forceinline__ void load_b_trans(uint32_t b[2], const bf16* S, int ld, int n0,
                                             int k0) {
  const int lane = threadIdx.x % 32, mi = (lane / 8) & 1, rr = lane % 8;
  ldsm_x2_trans(b, S + (k0 + mi * 8 + rr) * ld + n0);
}

// Sum of v over the 8 lanes that share lane % 4 (the rows g of an
// accumulator fragment), in a fixed order.
__device__ __forceinline__ float sum_over_rows(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// acc[j][m] (m16 tile m of the row tile) += X [16 MTILES x K] . B [K x 8] at
// columns 8 (nt + WARPS j), for the pair of 8-column tiles nt and nt + WARPS
// (the second when `both`; WARPS, the CTA's warps): B = W for a row-major W
// [k][n] (TRANS_W false), or B = W^T for a row-major W [n][k] (TRANS_W true).
// The pair shares the A fragments and gives 2 MTILES independent accumulator
// chains.
template <bool TRANS_W, int WARPS = TC_WARPS, int MTILES = MT>
__device__ __forceinline__ void pair_product(float acc[2][MTILES][4], const bf16* X, int ldx,
                                             int K, const bf16* W, int ldw, int nt, bool both) {
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t b[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j == 0 || both) {
        if constexpr (TRANS_W) {
          load_b(b[j], W, ldw, (nt + WARPS * j) * 8, k0);
        } else {
          load_b_trans(b[j], W, ldw, (nt + WARPS * j) * 8, k0);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MTILES; ++m) {
      uint32_t a[4];
      load_a(a, X, ldx, m * 16, k0);
      mma_bf16(acc[0][m], a, b[0]);
      if (both) mma_bf16(acc[1][m], a, b[1]);
    }
  }
}

// acc += S1^T [16 x TR] . S2 [TR x 8] for row-major tiles S1, S2
// [row][column]: columns m0.. of S1 against columns n0.. of S2, summed over
// the tile's rows (one 16 x 8 tile of a weight gradient).
__device__ __forceinline__ void tile_outer(float acc[4], const bf16* S1, int ld1, int m0,
                                           const bf16* S2, int ld2, int n0) {
#pragma unroll
  for (int k0 = 0; k0 < TR; k0 += 16) {
    uint32_t a[4], b[2];
    load_a_trans(a, S1, ld1, m0, k0);
    load_b_trans(b, S2, ld2, n0, k0);
    mma_bf16(acc, a, b);
  }
}

// O [16 MTILES x 8 NH] = bf16(relu(X . W + bias)) for a row-major W [k][n];
// warp w of the CTA's WARPS computes the 8-column tiles w + WARPS j, two at a
// time.
template <int WARPS = TC_WARPS, int MTILES = MT>
__device__ inline void tc_dense_relu(const bf16* X, int ldx, int K, const bf16* W, int ldw,
                                     const float* bias, int NH, bf16* O, int ldo) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  for (int nt = warp; nt < NH; nt += 2 * WARPS) {
    const bool both = nt + WARPS < NH;
    float acc[2][MTILES][4] = {};
    pair_product<false, WARPS, MTILES>(acc, X, ldx, K, W, ldw, nt, both);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j == 1 && !both) break;
      const int c = (nt + WARPS * j) * 8 + 2 * t;
      const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
      for (int m = 0; m < MTILES; ++m) {
        const int r = m * 16 + g;
        store_pair(O + r * ldo + c, fmaxf(acc[j][m][0] + b0, 0.f), fmaxf(acc[j][m][1] + b1, 0.f));
        store_pair(O + (r + 8) * ldo + c, fmaxf(acc[j][m][2] + b0, 0.f),
                   fmaxf(acc[j][m][3] + b1, 0.f));
      }
    }
  }
}

// dst[k * ld + c] = bf16(src[k * cols + c]) for a row-major src [rows][cols]
// by a CTA of THREADS threads, four values per load where cols and the
// alignment allow it
template <int THREADS_ = TC_THREADS>
__device__ inline void load_bf16_rows(bf16* dst, int ld, const float* __restrict__ src, int rows,
                                      int cols) {
  if (cols % 4 == 0 && reinterpret_cast<size_t>(src) % 16 == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int i = threadIdx.x; i < rows * cols / 4; i += THREADS_) {
      const float4 v = src4[i];
      const int k = 4 * i / cols, c = 4 * i - k * cols;
      store_pair(dst + k * ld + c, v.x, v.y);
      store_pair(dst + k * ld + c + 2, v.z, v.w);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += THREADS_) {
      const int k = i / cols, c = i - k * cols;
      dst[k * ld + c] = __float2bfloat16_rn(src[i]);
    }
  }
}

// Problem b's weights for a tensor-core kernel (a CTA of NT threads): W1, W2
// rounded into bf16 at row stride ldh, out.w rounded, the encoding weights
// rounded under BF16_APPLY, biases f32.
template <int P, int NT>
__device__ inline void load_tc_weights(const NetArgs& n, int b, bf16* w1, bf16* w2, int ldh,
                                       float* w3, float* ew, float* eb, float* b1, float* b2,
                                       float* ab) {
  const int tid = threadIdx.x, F = n.F, A = n.A, HID = n.HID, FEAT = F + A;
  load_bf16_rows<NT>(w1, ldh, n.w1 + (size_t)b * FEAT * HID, FEAT, HID);
  load_bf16_rows<NT>(w2, ldh, n.w2 + (size_t)b * HID * HID, HID, HID);
  for (int i = tid; i < HID + FEAT; i += NT) w3[i] = rnd<P>(n.w3[(size_t)b * (HID + FEAT) + i]);
  for (int i = tid; i < 2 * F; i += NT) ew[i] = rnd_enc<P>(n.ew[(size_t)b * 2 * F + i]);
  for (int i = tid; i < F; i += NT) eb[i] = n.eb[(size_t)b * F + i];
  for (int i = tid; i < HID; i += NT) {
    b1[i] = n.b1[(size_t)b * HID + i];
    b2[i] = n.b2[(size_t)b * HID + i];
  }
  for (int i = tid; i < A; i += NT) ab[i] = n.ab[(size_t)b * A + i];
}

// Features [row][k] of ROWS rows, rounded (product operands), and, under
// SLOPE, in f32 the slope of each (d feature / d its pre-activation) from the
// same sincosf; warp w of WARPS takes rows w + WARPS q, its lanes the
// features.
template <int WARPS, int ROWS, bool SLOPE = true>
__device__ inline void tc_features(const NetArgs& n, const float* ew, const float* eb,
                                   const float* ab, const float* xn, const float* yn,
                                   const float* th, bf16* feat, float* slope, int ldf) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, FEAT = n.F + n.A;
  for (int r = warp; r < ROWS; r += WARPS) {
    const float xr = xn[r], yr = yn[r], tr = th[r];
    for (int k = lane; k < FEAT; k += 32) {
      bool is_cos;
      float freq, sv, cv;
      sincosf(feature_arg(n, ew, eb, ab, xr, yr, tr, k, &is_cos, &freq), &sv, &cv);
      feat[r * ldf + k] = __float2bfloat16_rn(is_cos ? cv : sv);
      if constexpr (SLOPE) slope[r * ldf + k] = is_cos ? -sv : cv;
    }
  }
}

template <int P>
__global__ void __launch_bounds__(TC_THREADS, 1)
field_grad_tc_kernel(const float* __restrict__ x, const float* __restrict__ y, int M, int dim,
                     NetArgs n, float* __restrict__ loss, Grads gr) {
  extern __shared__ float4 smem_f4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem_f4);
  const TcLayout L = tc_layout(n);
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int F = n.F, A = n.A, HID = n.HID, FEAT = L.FEAT, NH = L.NH;
  bf16* w1 = reinterpret_cast<bf16*>(sm + L.w1);
  bf16* w2 = reinterpret_cast<bf16*>(sm + L.w2);
  bf16* feat = reinterpret_cast<bf16*>(sm + L.feat);
  bf16* h1 = reinterpret_cast<bf16*>(sm + L.h1);
  bf16* h2 = reinterpret_cast<bf16*>(sm + L.h2);
  bf16* dp1 = reinterpret_cast<bf16*>(sm + L.dp1);
  float* slope = reinterpret_cast<float*>(sm + L.slope);
  float* dw2 = reinterpret_cast<float*>(sm + L.dw2);
  float* w3 = reinterpret_cast<float*>(sm + L.w3);
  float* ew = reinterpret_cast<float*>(sm + L.ew);
  float* eb = reinterpret_cast<float*>(sm + L.eb);
  float* b1 = reinterpret_cast<float*>(sm + L.b1);
  float* b2 = reinterpret_cast<float*>(sm + L.b2);
  float* ab = reinterpret_cast<float*>(sm + L.ab);
  float* xn = reinterpret_cast<float*>(sm + L.xn);
  float* yn = reinterpret_cast<float*>(sm + L.yn);
  float* th = reinterpret_cast<float*>(sm + L.th);
  float* gs = reinterpret_cast<float*>(sm + L.g);
  float* bces = reinterpret_cast<float*>(sm + L.bce);
  float* gw3 = reinterpret_cast<float*>(sm + L.gw3);
  float* gb1 = reinterpret_cast<float*>(sm + L.gb1);
  float* gb2 = reinterpret_cast<float*>(sm + L.gb2);
  float* gew = reinterpret_cast<float*>(sm + L.gew);
  float* geb = reinterpret_cast<float*>(sm + L.geb);
  float* gab = reinterpret_cast<float*>(sm + L.gab);
  if (skipped(n)) {
    zero_grads<TC_THREADS>(n, loss, gr);
    return;
  }

  // zero everything: padding rows and columns stay zero, sums start at zero
  for (int i = tid; i < L.total / 16; i += TC_THREADS) smem_f4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  load_tc_weights<P, TC_THREADS>(n, b, w1, w2, L.ldh, w3, ew, eb, b1, b2, ab);
  const float b3 = n.b3[b];
  x += (size_t)b * M * dim;
  y += (size_t)b * M;
  const float inv_n = 1.f / (float)M;
  float loss_sum = 0.f, b3_sum = 0.f;  // held by thread 0
  const int w2_tiles = L.MH * NH, w1_tiles = L.MF * NH;
  float dw1[MAX_W1_TILES][4];  // this warp's dW1 tiles: warp + 8 q
#pragma unroll
  for (int q = 0; q < MAX_W1_TILES; ++q) dw1[q][0] = dw1[q][1] = dw1[q][2] = dw1[q][3] = 0.f;

  for (int row0 = 0; row0 < M; row0 += TR) {
    // rows row0 .. row0 + TR (rows past M: g is zero), their features and
    // the slopes for the encoding gradients
    load_poses<P, TR>(x, M, dim, row0, n, xn, yn, th);
    __syncthreads();
    tc_features<TC_WARPS, TR>(n, ew, eb, ab, xn, yn, th, feat, slope, L.ldf);
    __syncthreads();
    tc_dense_relu(feat, L.ldf, L.KF, w1, L.ldh, b1, NH, h1, L.ldh);
    __syncthreads();
    tc_dense_relu(h1, L.ldh, L.KH, w2, L.ldh, b2, NH, h2, L.ldh);
    __syncthreads();
    // head z = [h2 | features] . out.w + out.b, then the loss and d logits
    // of each row: warp w takes rows w + 16 q, both at once, and lane q
    // finishes row w + 16 q
    {
      constexpr int RW = TR / TC_WARPS;
      static_assert(TR % TC_WARPS == 0, "every warp takes as many rows");
      float acc[RW];
      head_partial<TC_WARPS, RW>(acc, h2, L.ldh, feat, L.ldf, w3, HID, FEAT);
      float z = 0.f;
#pragma unroll
      for (int q = 0; q < RW; ++q) {
        acc[q] = warp_sum(acc[q]);
        if (lane == q) z = acc[q] + b3;
      }
      if (lane < RW) {
        const int r = warp + lane * TC_WARPS, row = row0 + r;
        float bce = 0.f, gv = 0.f;
        if (row < M) {
          const float yt = y[row];
          bce = fmaxf(z, 0.f) - z * yt + log1pf(expf(-fabsf(z)));
          gv = (1.f / (1.f + expf(-z)) - yt) * inv_n;
        }
        gs[r] = gv;
        bces[r] = bce;
      }
    }
    __syncthreads();
    // out.w's gradient from g and [h2 | features]; h2 := d pre2 (the rounded
    // operand), d b2 summing its f32 value; out.b and the loss by thread 0
    for (int j = tid; j < HID + FEAT; j += TC_THREADS) {
      float acc = 0.f;
      if (j < HID) {
        const float w = w3[j];
        float sum = 0.f;
        for (int r = 0; r < TR; ++r) {
          bf16* hp = h2 + r * L.ldh + j;
          const float h = bf(*hp), gv = gs[r];
          acc = fmaf(h, w3_operand<P>(gv), acc);
          const float d = h > 0.f ? head_cotangent<P>(gv, w) : 0.f;
          sum += d;
          *hp = __float2bfloat16_rn(d);
        }
        gb2[j] += sum;
      } else {
        const bf16* fp = feat + (j - HID);
        for (int r = 0; r < TR; ++r) acc = fmaf(bf(fp[r * L.ldf]), w3_operand<P>(gs[r]), acc);
      }
      gw3[j] += acc;
    }
    if (tid == 0) {
      for (int r = 0; r < TR; ++r) {
        b3_sum += gs[r];
        loss_sum += bces[r];
      }
    }
    __syncthreads();
    // d W2 += h1^T d pre2 into the f32 sum in shared memory
    for (int i = warp; i < w2_tiles; i += TC_WARPS) {
      const int j = (i / NH) * 16 + g, c = (i % NH) * 8 + 2 * t;
      float acc[4] = {};
      tile_outer(acc, h1, L.ldh, (i / NH) * 16, h2, L.ldh, (i % NH) * 8);
      float2* p = reinterpret_cast<float2*>(dw2 + j * L.ldg + c);
      *p = make_float2(p->x + acc[0], p->y + acc[1]);
      p = reinterpret_cast<float2*>(dw2 + (j + 8) * L.ldg + c);
      *p = make_float2(p->x + acc[2], p->y + acc[3]);
    }
    // d pre1 = [h1 > 0] * (d pre2 . W2^T), rounded as it is written; d b1
    // sums it after the rounding under BF16_APPLY, before it under BF16_MULTI
    for (int nt = warp; nt < NH; nt += TC_WARPS) {
      float acc[2][MT][4] = {};
      pair_product<true>(acc, h2, L.ldh, L.KH, w2, L.ldh, nt, false);
      const int c = nt * 8 + 2 * t;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = m * 16 + g + 8 * half;
          const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(h1 + r * L.ldh + c);
          constexpr int R = P == BF16_APPLY ? P : F32;
          const float v0 = bf(h.x) > 0.f ? rnd<R>(acc[0][m][2 * half]) : 0.f;
          const float v1 = bf(h.y) > 0.f ? rnd<R>(acc[0][m][2 * half + 1]) : 0.f;
          s0 += v0;
          s1 += v1;
          store_pair(dp1 + r * L.ldh + c, v0, v1);
        }
      }
      s0 = sum_over_rows(s0);
      s1 = sum_over_rows(s1);
      if (g == 0) {
        if (c < HID) gb1[c] += s0;
        if (c + 1 < HID) gb1[c + 1] += s1;
      }
    }
    __syncthreads();
    // d W1 += feat^T d pre1 in this warp's accumulators
#pragma unroll
    for (int q = 0; q < MAX_W1_TILES; ++q) {
      const int i = warp + q * TC_WARPS;
      if (i < w1_tiles) tile_outer(dw1[q], feat, L.ldf, (i / NH) * 16, dp1, L.ldh, (i % NH) * 8);
    }
    // d features = d pre1 . W1^T + g out.w (each term rounded on its own
    // under BF16_APPLY), through the encoding: the encoding and angle-bias
    // gradients of each feature column
    for (int nt0 = warp; nt0 < L.NF; nt0 += 2 * TC_WARPS) {
      const bool both = nt0 + TC_WARPS < L.NF;
      float accs[2][MT][4] = {};
      pair_product<true>(accs, dp1, L.ldh, L.KH, w1, L.ldh, nt0, both);
#pragma unroll
      for (int je = 0; je < 4; ++je) {
        const int j = je / 2, e = je % 2;
        if (j == 1 && !both) break;
        const float (*acc)[4] = accs[j];
        const int k = (nt0 + TC_WARPS * j) * 8 + 2 * t + e;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f;
        if (k < FEAT) {
          const float w = w3[HID + k];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = m * 16 + g + 8 * half;
              const float sum = acc[m][2 * half + e], gv = gs[r];
              const float df = P == BF16_APPLY ? rnd<P>(sum) + head_cotangent<P>(gv, w)
                                               : fmaf(rnd<P>(gv), w, sum);
              const float d = slope[r * L.ldf + k] * df;
              if (k < F) {
                a0 = fmaf(xn[r], d, a0);
                a1 = fmaf(yn[r], d, a1);
                a2 += d;
              } else {
                a2 = fmaf(d, (float)((k - F) % (A / 2) + 1), a2);
              }
            }
          }
        }
        a0 = sum_over_rows(a0);
        a1 = sum_over_rows(a1);
        a2 = sum_over_rows(a2);
        if (g == 0 && k < FEAT) {
          if (k < F) {
            gew[k] += a0;
            gew[F + k] += a1;
            geb[k] += a2;
          } else {
            gab[k - F] += a2;
          }
        }
      }
    }
    __syncthreads();
  }

  // every gradient written once; the cast weights' rounded under BF16_APPLY.
  // dW1 goes from the accumulators through shared memory (the weights' space,
  // free now) so that its rows are written whole
  float* stage = reinterpret_cast<float*>(sm);
#pragma unroll
  for (int q = 0; q < MAX_W1_TILES; ++q) {
    const int i = warp + q * TC_WARPS;
    if (i < w1_tiles) {
      const int k = (i / NH) * 16 + g, c = (i % NH) * 8 + 2 * t;
      *reinterpret_cast<float2*>(stage + k * L.ldg + c) = make_float2(dw1[q][0], dw1[q][1]);
      *reinterpret_cast<float2*>(stage + (k + 8) * L.ldg + c) = make_float2(dw1[q][2], dw1[q][3]);
    }
  }
  __syncthreads();
  float* gw1 = gr.w1 + (size_t)b * FEAT * HID;
  for (int i = tid; i < FEAT * HID; i += TC_THREADS) {
    const int k = i / HID, c = i - k * HID;
    gw1[i] = rnd_cast<P>(stage[k * L.ldg + c]);
  }
  float* gw2 = gr.w2 + (size_t)b * HID * HID;
  for (int i = tid; i < HID * HID; i += TC_THREADS) {
    const int j = i / HID, c = i - j * HID;
    gw2[i] = rnd_cast<P>(dw2[j * L.ldg + c]);
  }
  const size_t hf = (size_t)(HID + FEAT);
  for (int j = tid; j < HID + FEAT; j += TC_THREADS) gr.w3[b * hf + j] = rnd_cast<P>(gw3[j]);
  for (int j = tid; j < HID; j += TC_THREADS) {
    gr.b1[(size_t)b * HID + j] = gb1[j];
    gr.b2[(size_t)b * HID + j] = gb2[j];
  }
  for (int j = tid; j < 2 * F; j += TC_THREADS) gr.ew[(size_t)b * 2 * F + j] = rnd_cast<P>(gew[j]);
  // bias=False: the encoding bias is not trainable and its gradient is zero
  for (int j = tid; j < F; j += TC_THREADS) gr.eb[(size_t)b * F + j] = n.bias ? geb[j] : 0.f;
  for (int j = tid; j < A; j += TC_THREADS) gr.ab[(size_t)b * A + j] = gab[j];
  if (tid == 0) {
    gr.b3[b] = b3_sum;
    loss[b] = loss_sum * inv_n;
  }
}

// ------------------------------------------------------------- launches ----

template <int P>
inline int launch_field_grad(const NetArgs* net, const float* x, const float* y, int B, int M,
                             int dim, float* loss, const Grads* grads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (P == F32) {
    const F32Layout L = f32_layout(*net);
    const size_t bytes = (size_t)L.total * sizeof(float);
    if (bytes > (size_t)MAX_SMEM || L.NK * L.NC > THREADS || L.NH * L.NC > THREADS)
      return TOO_LARGE;
    const cudaError_t err = cudaFuncSetAttribute(
        field_grad_f32_kernel<F32>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    field_grad_f32_kernel<F32><<<B, THREADS, bytes, s>>>(x, y, M, dim, *net, loss, *grads);
  } else {
    const TcLayout L = tc_layout(*net);
    const size_t bytes = (size_t)L.total;
    // (dW1 is staged at the start of shared memory, below dW2, at the end)
    if (bytes > (size_t)MAX_SMEM || L.MF * L.NH > MAX_W1_TILES * TC_WARPS ||
        L.KF * L.ldg * 4 > L.dw2)
      return TOO_LARGE;
    const cudaError_t err = cudaFuncSetAttribute(
        field_grad_tc_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    field_grad_tc_kernel<P><<<B, TC_THREADS, bytes, s>>>(x, y, M, dim, *net, loss, *grads);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nf
