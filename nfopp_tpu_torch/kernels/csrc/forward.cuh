// The field's forward over all of a problem's query points, shared by the
// ONF logits kernel (kernels 1 and 5: onf_forward.cu, onf_multi.cu) and the
// collision-terms forward (kernel 3a: collision_terms.cu). Both keep one
// problem's field on chip, walk its points in row tiles and write only what
// their epilogue makes of each row's logit z: the logits, or two sums per
// problem. No activation touches device memory.
//
// Bound on this card (H100 SXM data sheet rates), full-width field (33,141
// weights, ~32.7k multiply-adds per point): at B=256, M=199 the logits take
// ~3.3 GFLOP, 50 us at 67 TFLOP/s in f32 or 3 us at 989 TFLOP/s in bf16,
// against ~34 MB of f32 weights read once, 10 us at 3.35 TB/s; so f32 is
// bound by operations and bf16 by bytes. The collision forward (M=99) has
// half the operations and the same bytes.
//
// One CTA per problem, in one of two families, by the rounding mode P
// (onf_common.cuh):
//   bf16 modes (BF16_APPLY: onf_apply's casts; BF16_MULTI: the TPU
//     multi-problem kernel's): both products of a tile (features . W1, h1 .
//     W2) on the tensor cores through mma.sync m16n8k16 (mma.cuh and
//     field_grad.cuh's fragment loads), W1, W2 and the activation tiles in
//     bf16 in shared memory. 16-row tiles and 8 warps keep a CTA at ~100 KB at
//     the full width, so two CTAs share an SM (carveout at its most) and 256
//     problems run in one wave; the collision backward's measured best layout.
//   F32: register-blocked 4x4 FMA micro-tiles on the CUDA cores
//     (field_grad.cuh's dense_relu_f32; a one-pass TF32 product would miss the
//     f32 tolerances), f32 weights and row-major 32-row tiles whose strides
//     are 4 (mod 8) floats, ~187 KB at the full width, one CTA per SM.
// A tile: the features (one sincosf each, no slope), h1 = relu(features . W1
// + b1), h2 = relu(h1 . W2 + b2), and the head z = [h2 | features] . out.w +
// out.b (a warp's rows at once, field_grad.cuh's head_partial); 4 barriers.
// The poses and multipliers of the next tile are read from device memory
// while a tile runs; in f32, W1 and W2 are copied by cp.async while the first
// tile's features are computed (on an H100 1.5% / 6% faster for the logits /
// collision sums than loads through registers).
//
// Widths: the bf16 family takes every field of hidden <= 128 and <= 256
// features (~127 KB at the widest, one CTA per SM there); the f32 family
// every field whose layout fits one CTA (hidden <= 120 at 220 features),
// dropping the tiles' bank padding where only that makes it fit, so that it
// takes every field the first version of these kernels took. A field that
// does not fit is refused (TOO_LARGE).
#pragma once

#include <type_traits>

#include "field_grad.cuh"

namespace nf {

// bf16 family: rows per tile (one m16 tile), warps, CTAs per SM; 16 warps,
// and 32-row tiles with 16 warps at one CTA per SM, ran slower on an H100
constexpr int FB_ROWS = 16;
constexpr int FB_WARPS = 8;
constexpr int FB_THREADS = 32 * FB_WARPS;
constexpr int FB_CTAS_PER_SM = 2;
// f32 family: warps (rows per tile: TM); 8 warps, and 4 x 2 micro-tiles (400
// threads in the products), ran slower on an H100
constexpr int FF_WARPS = 16;
constexpr int FF_THREADS = 32 * FF_WARPS;
static_assert(FB_ROWS % FB_WARPS == 0 && TM % FF_WARPS == 0, "every warp takes as many head rows");

// Byte offsets of one CTA's shared memory (each 16-byte aligned). K1, K2:
// the padded depths of the two products (multiples of 16 in bf16, of 4 in
// f32); NH: 8-column tiles (bf16) or 4-column chunks (f32) of the hidden
// layer; ld*: row strides in elements (W1 and W2 [k][column] at ldw).
struct FwdLayout {
  int FEAT, K1, K2, NH, ldw, ldf, ldh;
  int w1, w2, feat, h1, h2, w3, ew, eb, b1, b2, ab, xn, yn, th, part, total;
};

// The f32 parts after the tiles, for tiles of `rows` rows.
__host__ __device__ inline void fwd_tail(FwdLayout& L, int o, const NetArgs& n, int rows) {
  L.w3 = take_bytes(o, (n.HID + L.FEAT) * 4);
  L.ew = take_bytes(o, 2 * n.F * 4);
  L.eb = take_bytes(o, n.F * 4);
  L.b1 = take_bytes(o, L.K2 * 4);
  L.b2 = take_bytes(o, L.K2 * 4);
  L.ab = take_bytes(o, n.A * 4);
  L.xn = take_bytes(o, rows * 4);
  L.yn = take_bytes(o, rows * 4);
  L.th = take_bytes(o, rows * 4);
  L.part = take_bytes(o, 2 * rows * 4);  // the collision sums of each row slot
  L.total = o;
}

__host__ __device__ inline FwdLayout fwd_tc_layout(const NetArgs& n) {
  FwdLayout L;
  L.FEAT = n.F + n.A;
  L.K1 = (L.FEAT + 15) & ~15;
  L.K2 = (n.HID + 15) & ~15;
  L.NH = (n.HID + 7) / 8;
  L.ldf = L.K1 + 8;  // a row is an odd number of 16-byte units
  L.ldh = L.K2 + 8;
  L.ldw = L.ldh;
  int o = 0;
  L.w1 = take_bytes(o, L.K1 * L.ldw * 2);
  L.w2 = take_bytes(o, L.K2 * L.ldw * 2);
  L.feat = take_bytes(o, FB_ROWS * L.ldf * 2);
  L.h1 = take_bytes(o, FB_ROWS * L.ldh * 2);
  L.h2 = take_bytes(o, FB_ROWS * L.ldh * 2);
  fwd_tail(L, o, n, FB_ROWS);
  return L;
}

// pad: tile strides 4 (mod 8) floats, so that the float4s of 8 rows at one
// column fall in 8 bank groups; the weights' rows are read whole by a warp
// and need no padding.
__host__ __device__ inline FwdLayout fwd_f32_layout(const NetArgs& n, bool pad) {
  FwdLayout L;
  L.FEAT = n.F + n.A;
  L.K1 = round4(L.FEAT);
  L.K2 = round4(n.HID);
  L.NH = L.K2 / 4;
  L.ldw = L.K2;
  L.ldf = pad ? stride4(L.K1) : L.K1;
  L.ldh = pad ? stride4(L.K2) : L.K2;
  int o = 0;
  L.w1 = take_bytes(o, L.K1 * L.ldw * 4);
  L.w2 = take_bytes(o, L.K2 * L.ldw * 4);
  L.feat = take_bytes(o, TM * L.ldf * 4);
  L.h1 = take_bytes(o, TM * L.ldh * 4);
  L.h2 = take_bytes(o, TM * L.ldh * 4);
  fwd_tail(L, o, n, TM);
  return L;
}

// With the bank padding where it fits, else without.
__host__ __device__ inline FwdLayout fwd_f32_layout(const NetArgs& n) {
  const FwdLayout L = fwd_f32_layout(n, true);
  return L.total <= MAX_SMEM ? L : fwd_f32_layout(n, false);
}

// 16 bytes from device to shared memory without passing through registers
// (cp.async; both addresses 16-byte aligned), and the wait for all of this
// thread's copies.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// load_f32_weights, with W1 and W2 copied by cp.async where their rows are
// whole, aligned float4s (ldw == HID): the copies then run while the first
// tile's features are computed, and each thread waits for its own before the
// barrier that precedes the first product.
template <int NT>
__device__ inline void load_f32_weights_async(const NetArgs& n, int b, float* w1, float* w2,
                                              int ldw, float* w3, float* ew, float* eb,
                                              float* b1, float* b2, float* ab) {
  const int tid = threadIdx.x, HID = n.HID, FEAT = n.F + n.A;
  const float* s1 = n.w1 + (size_t)b * FEAT * HID;
  const float* s2 = n.w2 + (size_t)b * HID * HID;
  if (ldw != HID || reinterpret_cast<size_t>(s1) % 16 || reinterpret_cast<size_t>(s2) % 16) {
    load_f32_weights<NT>(n, b, w1, w2, ldw, w3, ew, eb, b1, b2, ab);
    return;
  }
  for (int i = tid; i < FEAT * HID / 4; i += NT) cp_async16(w1 + 4 * i, s1 + 4 * i);
  for (int i = tid; i < HID * HID / 4; i += NT) cp_async16(w2 + 4 * i, s2 + 4 * i);
  load_f32_weights<NT, false>(n, b, w1, w2, ldw, w3, ew, eb, b1, b2, ab);
}

// Pointers into one CTA's shared memory; T the type of the weights and tiles.
template <typename T>
struct FwdSmem {
  T *w1, *w2, *feat, *h1, *h2;
  float *w3, *ew, *eb, *b1, *b2, *ab, *xn, *yn, *th, *part;
};

template <typename T>
__device__ inline FwdSmem<T> fwd_smem(float4* smem, const FwdLayout& L) {
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem);
  auto f = [sm](int offset) { return reinterpret_cast<float*>(sm + offset); };
  return {reinterpret_cast<T*>(sm + L.w1), reinterpret_cast<T*>(sm + L.w2),
          reinterpret_cast<T*>(sm + L.feat), reinterpret_cast<T*>(sm + L.h1),
          reinterpret_cast<T*>(sm + L.h2), f(L.w3), f(L.ew), f(L.eb), f(L.b1), f(L.b2), f(L.ab),
          f(L.xn), f(L.yn), f(L.th), f(L.part)};
}

// One query pose as read from device memory (the origin past M).
struct Pose {
  float x, y, t;
};

__device__ __forceinline__ Pose fetch_pose(const float* x, int M, int dim, int row) {
  Pose p = {0.f, 0.f, 0.f};
  if (row < M) {
    const float* q = x + (size_t)row * dim;
    p.x = q[0];
    p.y = q[1];
    if (dim > 2) p.t = q[2];
  }
  return p;
}

// Row r of the tile: normalised xy (rounded under BF16_APPLY, as
// field_grad.cuh's load_poses) and theta.
template <int P, typename T>
__device__ __forceinline__ void put_pose(const Pose& p, const NetArgs& n, const FwdSmem<T>& s,
                                         int r) {
  s.xn[r] = rnd_enc<P>((p.x - n.mean) / n.sigma);
  s.yn[r] = rnd_enc<P>((p.y - n.mean) / n.sigma);
  s.th[r] = p.t;
}

// The forward of one bf16 tile whose poses are in shared memory: z[q] =
// [h2 | features] . out.w at row warp + FB_WARPS q, without out.b, in every
// lane of the warp.
template <int P>
__device__ inline void tc_forward_tile(const NetArgs& n, const FwdLayout& L,
                                       const FwdSmem<bf16>& s, float z[FB_ROWS / FB_WARPS]) {
  constexpr int RW = FB_ROWS / FB_WARPS;
  tc_features<FB_WARPS, FB_ROWS, false>(n, s.ew, s.eb, s.ab, s.xn, s.yn, s.th, s.feat, nullptr,
                                        L.ldf);
  __syncthreads();
  tc_dense_relu<FB_WARPS, FB_ROWS / 16>(s.feat, L.ldf, L.K1, s.w1, L.ldw, s.b1, L.NH, s.h1, L.ldh);
  __syncthreads();
  tc_dense_relu<FB_WARPS, FB_ROWS / 16>(s.h1, L.ldh, L.K2, s.w2, L.ldw, s.b2, L.NH, s.h2, L.ldh);
  __syncthreads();
  head_partial<FB_WARPS, RW>(z, s.h2, L.ldh, s.feat, L.ldf, s.w3, n.HID, L.FEAT);
#pragma unroll
  for (int q = 0; q < RW; ++q) z[q] = warp_sum(z[q]);
}

// The same for an f32 tile of TM rows (FF_WARPS warps).
__device__ inline void f32_forward_tile(const NetArgs& n, const FwdLayout& L,
                                        const FwdSmem<float>& s, float z[TM / FF_WARPS]) {
  constexpr int RW = TM / FF_WARPS;
  f32_features<FF_THREADS>(n, s.ew, s.eb, s.ab, s.xn, s.yn, s.th, s.feat, nullptr, L.ldf);
  cp_async_wait_all();  // the weights' copies, on the first tile
  __syncthreads();
  dense_relu_f32(s.feat, L.ldf, L.K1, s.w1, L.ldw, s.b1, L.NH, s.h1, L.ldh);
  __syncthreads();
  dense_relu_f32(s.h1, L.ldh, L.K2, s.w2, L.ldw, s.b2, L.NH, s.h2, L.ldh);
  __syncthreads();
  head_partial<FF_WARPS, RW>(z, s.h2, L.ldh, s.feat, L.ldf, s.w3, n.HID, L.FEAT);
#pragma unroll
  for (int q = 0; q < RW; ++q) z[q] = warp_sum(z[q]);
}

// Rows per tile and warps of the family of P (tensor cores under the bf16
// modes, f32 FMA tiles under F32).
template <int P>
struct Fwd {
  static constexpr bool TC = P != F32;
  static constexpr int ROWS = TC ? FB_ROWS : TM;
  static constexpr int WARPS = TC ? FB_WARPS : FF_WARPS;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int RW = ROWS / WARPS;  // rows per warp in the head and epilogue
  using T = std::conditional_t<TC, bf16, float>;
  __host__ __device__ static FwdLayout layout(const NetArgs& n) {
    return TC ? fwd_tc_layout(n) : fwd_f32_layout(n);
  }
};

// The forward of problem blockIdx.x at all its points x [M, dim] (with
// multipliers mult [M], or nullptr): lane q of warp w calls epi(row, z, mu)
// for row = row0 + w + WARPS q of every tile, rows past M included (z =
// [h2 | features] . out.w + out.b). Returns the CTA's scratch for
// 2 ROWS floats (free of other use).
template <int P, typename Epi>
__device__ inline float* forward_problem(const float* x, const float* mult, int M, int dim,
                                         const NetArgs& n, float4* smem, Epi epi) {
  using Fam = Fwd<P>;
  constexpr int ROWS = Fam::ROWS, WARPS = Fam::WARPS, NT = Fam::THREADS, RW = Fam::RW;
  const FwdLayout L = Fam::layout(n);
  const FwdSmem<typename Fam::T> s = fwd_smem<typename Fam::T>(smem, L);
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // zero everything (padding rows and columns stay zero), then the weights
  for (int i = tid; i < L.total / 16; i += NT) smem[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  if constexpr (Fam::TC) {
    load_tc_weights<P, NT>(n, b, s.w1, s.w2, L.ldw, s.w3, s.ew, s.eb, s.b1, s.b2, s.ab);
  } else {
    load_f32_weights_async<NT>(n, b, s.w1, s.w2, L.ldw, s.w3, s.ew, s.eb, s.b1, s.b2, s.ab);
  }
  const float b3 = n.b3[b];
  x += (size_t)b * M * dim;
  if (mult) mult += (size_t)b * M;
  // the next tile's data, read while a tile runs: thread t < ROWS holds the
  // pose of its row t, lane q < RW of warp w the multiplier of its row w +
  // WARPS q (row slot `slot`)
  const int slot = lane < RW ? warp + WARPS * lane : ROWS;
  auto fetch_mu = [&](int row) { return mult && slot < ROWS && row < M ? mult[row] : 0.f; };
  Pose next = fetch_pose(x, M, dim, tid < ROWS ? tid : M);
  float next_mu = fetch_mu(slot);
  for (int row0 = 0; row0 < M; row0 += ROWS) {
    // every read of the last tile's poses is behind its second barrier
    if (tid < ROWS) {
      put_pose<P>(next, n, s, tid);
      next = fetch_pose(x, M, dim, row0 + ROWS + tid);
    }
    const float mu = next_mu;
    next_mu = fetch_mu(row0 + ROWS + slot);
    __syncthreads();
    float z[RW];
    if constexpr (Fam::TC) {
      tc_forward_tile<P>(n, L, s, z);
    } else {
      f32_forward_tile(n, L, s, z);
    }
#pragma unroll
    for (int q = 0; q < RW; ++q) {
      if (lane == q) epi(row0 + slot, z[q] + b3, mu);
    }
  }
  return s.part;
}

// Logits of a batch of fields at their query points (kernels 1 and 5): one
// CTA per problem, only the logits written (zeros for a skipped problem).
template <int P>
__device__ inline void onf_logits(const float* x, int M, int dim, const NetArgs& n, float* out,
                                  float4* smem) {
  out += (size_t)blockIdx.x * M;
  if (skipped(n)) {
    zero_row<Fwd<P>::THREADS>(out, M);
    return;
  }
  forward_problem<P>(x, nullptr, M, dim, n, smem, [&](int row, float z, float) {
    if (row < M) out[row] = z;
  });
}

template <int P>
__global__ void __launch_bounds__(FB_THREADS, FB_CTAS_PER_SM)
onf_logits_tc_kernel(const float* __restrict__ x, int M, int dim, NetArgs n,
                     float* __restrict__ out) {
  static_assert(P != F32, "the f32 mode runs onf_logits_f32_kernel");
  extern __shared__ float4 smem_f4[];
  onf_logits<P>(x, M, dim, n, out, smem_f4);
}

template <int P>
__global__ void __launch_bounds__(FF_THREADS, 1)
onf_logits_f32_kernel(const float* __restrict__ x, int M, int dim, NetArgs n,
                      float* __restrict__ out) {
  static_assert(P == F32, "the bf16 modes run onf_logits_tc_kernel");
  extern __shared__ float4 smem_f4[];
  onf_logits<P>(x, M, dim, n, out, smem_f4);
}

// Checks that a forward kernel's layout fits one CTA and sets its dynamic
// shared memory (and for the bf16 family the carveout at its most, for two
// CTAs per SM). Returns TOO_LARGE or a CUDA error code.
template <int P, typename Kernel>
inline int prepare_forward(Kernel kernel, const NetArgs& n, size_t* bytes) {
  const FwdLayout L = Fwd<P>::layout(n);
  *bytes = (size_t)L.total;
  if (*bytes > (size_t)MAX_SMEM || (!Fwd<P>::TC && 8 * L.NH > FF_THREADS)) return TOO_LARGE;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)*bytes);
  if (err == cudaSuccess && Fwd<P>::TC)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return static_cast<int>(err);
}

template <int P>
inline int launch_onf_logits(const NetArgs* net, const float* x, int B, int M, int dim,
                             float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t bytes;
  if constexpr (P == F32) {
    const int err = prepare_forward<P>(onf_logits_f32_kernel<P>, *net, &bytes);
    if (err != 0) return err;
    onf_logits_f32_kernel<P><<<B, FF_THREADS, bytes, s>>>(x, M, dim, *net, out);
  } else {
    const int err = prepare_forward<P>(onf_logits_tc_kernel<P>, *net, &bytes);
    if (err != 0) return err;
    onf_logits_tc_kernel<P><<<B, FB_THREADS, bytes, s>>>(x, M, dim, *net, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nf
