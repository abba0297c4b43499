// Backward of the collision terms (kernel 3b): for cotangents g[b] = (g1, g2)
// of (sum_m softplus_beta(z_bm), sum_m mu_bm tanh(z_bm)), the gradients d
// positions [b, m, dim] and d multipliers [b, m]; the field is frozen, so no
// parameter gradients.
//
// Replaces the TPU kernel
// nfopp_tpu/experimental/pallas/collision_terms.py::_bwd_kernel (M = N - 1 =
// 99 segment samples per problem on the main path).
//
// Each pose's forward is recomputed (features, h1, h2, the logit z), then
//   gz = g1 sigmoid(beta z) + g2 mu (1 - tanh^2 z),  d mu = g2 tanh z,
//   d pre2 = [h2 > 0] gz out.w[:hid],  d pre1 = [h1 > 0] (d pre2 . W2^T),
//   d feat = d pre1 . W1^T + gz out.w[hid:],
// and through each feature's slope (d feature / d its pre-activation) to d x,
// d y (the sum over Fourier features of slope d feat w_enc, over sigma) and d
// theta (the sum over angle features of slope d feat freq). No sum runs over
// the poses, so only the three per-pose sums over the features need a fixed
// order: a warp's lanes, then the warps' partial sums in shared memory in
// warp order. No atomics; results repeat bit for bit from launch to launch.
//
// Bound on this card (H100 SXM data sheet rates): ~65k multiply-adds per pose
// at the full width, ~3.3 GFLOP at B=256 x M=99: 49 us at 67 TFLOP/s in f32;
// in bf16 3 us at 989 TFLOP/s, so the ~34 MB of f32 weights read (10 us at
// 3.35 TB/s) bound it.
//
// Both modes: one CTA per problem, its weights in shared memory, its poses in
// row tiles (16 rows in bf16, 32 in f32); 7 barriers per tile. The features' sincosf also fills an f32
// slope tile, so the backward recomputes no trig. The per-warp partial sums
// take the feature tile's place once the head has read it (the next tile
// rewrites its padding columns with zeros).
//
// BF16_APPLY (collision_bwd_tc_kernel), the trajectory step under
// compute_dtype="bfloat16": the four products of a tile (feat . W1, h1 . W2,
// d pre2 . W2^T, d pre1 . W1^T) run on the tensor cores through mma.sync
// m16n8k16 with field_grad.cuh's fragment loads and pair products; weights and
// activation tiles are bf16 in shared memory. The roundings are those of
// models/onf.py::onf_apply's casts and their autograd, on the f32
// accumulators: operands (weights, xy, the encoding weights, features, h1,
// h2), gz . w (d pre2 and d feat's head term), d pre1 after its sum, d feat's
// product term after its sum, and the d x and d y sums before the division
// by sigma. 8 warps, two CTAs per SM (the shared-memory carveout set to its
// most). mma.sync rather than wgmma: 99 rows fill 7 m16 tiles against two
// 64-row wgmma tiles with 22% more padding.
//
// F32 (collision_bwd_f32_kernel): register-blocked FMA micro-tiles on the
// CUDA cores (a one-pass TF32 product would miss the f32 tolerances): each
// product gives a thread 4 rows x 4 columns and reads 8 float4s per 64 FMAs
// (field_grad.cuh's mm_nn, mm_nt), from row-major f32 tiles whose strides are
// 4 (mod 8) floats. 16 warps at 128 registers, one CTA per SM (~221 KB of
// shared memory at the full width).
//
// A field whose layout exceeds the shared memory of a CTA, or whose hidden
// columns exceed the f32 kernel's thread mapping, is refused (TOO_LARGE): at
// 220 features the f32 kernel takes hidden <= 108, the bf16 kernel every field
// of hidden <= 128 and <= 256 features.
//
// Live rows (NetArgs::live, set while the tracked loop runs a chunk with
// stopped problems): a skipped problem's CTA writes zero pose and multiplier
// gradients and returns, so the f32 kernel (one CTA per SM) runs its live
// problems in one wave when at most 132 are live. The loop throws a stopped
// problem's step away; zeros, not the untouched torch.empty outputs, keep
// that row's Adam step and dual ascent on finite values that repeat.
#include "field_grad.cuh"

using namespace nf;

namespace {

// bf16 mode: rows per tile (one m16 tile), warps per CTA and CTAs per SM.
// 16-row tiles keep a CTA at 115,504 bytes of shared memory at the full
// width, so two CTAs share an SM and the main path's 256 problems run in one
// wave; 32-row tiles (one CTA per SM) with 16 or 8 warps ran slower
constexpr int CB_ROWS = 16;
constexpr int CB_MTILES = CB_ROWS / 16;
constexpr int CB_WARPS = 8;
constexpr int CB_THREADS = 32 * CB_WARPS;
constexpr int CB_CTAS_PER_SM = 2;
// f32 mode: warps per CTA (rows per tile: TM); 8 warps ran slower
constexpr int CF_WARPS = 16;
constexpr int CF_THREADS = 32 * CF_WARPS;
static_assert(CB_ROWS % CB_WARPS == 0 && TM % CF_WARPS == 0, "every warp takes as many head rows");

// Byte offsets of the bf16 kernel's shared memory (each 16-byte aligned); K*
// are multiples of 16 (MMA depth), N* counts of 8-column tiles, ld* row
// strides in elements, rows an odd number of 16-byte units (ldmatrix reads 8
// rows from 8 bank groups).
struct CbLayout {
  int FEAT, KF, KH, NH, NF, ldf, ldh;
  int w1, w2, feat, h1, h2, slope, w3, ew, eb, b1, b2, ab, xn, yn, th, g, total;
};

__host__ __device__ inline CbLayout cb_layout(const NetArgs& n) {
  CbLayout L;
  const int F = n.F, A = n.A, HID = n.HID;
  L.FEAT = F + A;
  L.KF = (L.FEAT + 15) & ~15;
  L.KH = (HID + 15) & ~15;
  L.NH = (HID + 7) / 8;
  L.NF = (L.FEAT + 7) / 8;
  L.ldf = L.KF + 8;
  L.ldh = L.KH + 8;
  const int feat_bytes = CB_ROWS * L.ldf * 2, part_bytes = CB_WARPS * CB_ROWS * 3 * 4;
  int o = 0;
  L.w1 = take_bytes(o, L.KF * L.ldh * 2);  // W1 [feature][hidden] bf16
  L.w2 = take_bytes(o, L.KH * L.ldh * 2);  // W2 [hidden][hidden] bf16
  // features [row][feature] bf16, then the partial sums [warp][row][3] f32
  L.feat = take_bytes(o, feat_bytes > part_bytes ? feat_bytes : part_bytes);
  L.h1 = take_bytes(o, CB_ROWS * L.ldh * 2);      // h1, then d pre1
  L.h2 = take_bytes(o, CB_ROWS * L.ldh * 2);      // h2, then d pre2
  L.slope = take_bytes(o, CB_ROWS * L.ldf * 4);   // d feature / d pre-activation, f32
  L.w3 = take_bytes(o, (HID + L.FEAT) * 4);
  L.ew = take_bytes(o, 2 * F * 4);
  L.eb = take_bytes(o, F * 4);
  L.b1 = take_bytes(o, L.KH * 4);
  L.b2 = take_bytes(o, L.KH * 4);
  L.ab = take_bytes(o, A * 4);
  L.xn = take_bytes(o, CB_ROWS * 4);
  L.yn = take_bytes(o, CB_ROWS * 4);
  L.th = take_bytes(o, CB_ROWS * 4);
  L.g = take_bytes(o, CB_ROWS * 4);
  L.total = o;
  return L;
}

// Offsets, in floats, of the f32 kernel's shared memory (each 16-byte
// aligned): W1, W2 [k][column] and row-major tiles, zero-padded to whole
// 4-wide chunks (NF of features, NH of hidden columns).
struct CfLayout {
  int FEAT, NF, NH, ldw, ldf, ldh;
  int w1, w2, feat, slope, h1, h2, w3, ew, eb, b1, b2, ab, xn, yn, th, g, total;
};

__host__ __device__ inline CfLayout cf_layout(const NetArgs& n) {
  CfLayout L;
  const int F = n.F, A = n.A, HID = n.HID;
  L.FEAT = F + A;
  L.NF = (L.FEAT + 3) / 4;
  L.NH = (HID + 3) / 4;
  L.ldw = stride4(4 * L.NH);
  L.ldf = stride4(4 * L.NF);
  L.ldh = stride4(4 * L.NH);
  const int feat_floats = TM * L.ldf, part_floats = CF_WARPS * TM * 3;
  int o = 0;
  L.w1 = take(o, 4 * L.NF * L.ldw);
  L.w2 = take(o, 4 * L.NH * L.ldw);
  // features, then the partial sums [warp][row][3]
  L.feat = take(o, feat_floats > part_floats ? feat_floats : part_floats);
  L.slope = take(o, TM * L.ldf);
  L.h1 = take(o, TM * L.ldh);  // h1, then d pre1
  L.h2 = take(o, TM * L.ldh);  // h2, then d pre2
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
  L.total = o;
  return L;
}

// d logit of a pose from its logit z (zero past M); writes d multiplier.
__device__ __forceinline__ float logit_cotangent(float z, int row, int M, const float* mult,
                                                 float g1, float g2, float beta, float* dmult,
                                                 bool write) {
  if (row >= M) return 0.f;
  const float th = tanhf(z);
  const float sig = 1.f / (1.f + expf(-beta * z));
  if (write) dmult[row] = g2 * th;
  return g1 * sig + g2 * mult[row] * (1.f - th * th);
}

// One feature's term of a pose's three sums: d = slope d feat goes to d x and
// d y through the encoding weights (Fourier features) or to d theta times
// the phase's frequency (angle features).
__device__ __forceinline__ void add_feature(const NetArgs& n, const float* ew, int k, float d,
                                            float& ax, float& ay, float& at) {
  if (k < n.F) {
    ax = fmaf(d, ew[k], ax);
    ay = fmaf(d, ew[n.F + k], ay);
  } else {
    at = fmaf(d, (float)((k - n.F) % (n.A / 2) + 1), at);
  }
}

// The pose's d x, d y, d theta from the WARPS partial sums part[warp][row][3],
// summed in warp order (the cotangent of the rounded xy, under BF16_APPLY,
// rounded before the division by sigma).
template <int P, int WARPS, int ROWS>
__device__ inline void write_pose_grads(const float* part, int row0, int M, int dim,
                                        const NetArgs& n, float* dx) {
  const int r = threadIdx.x;
  if (r >= ROWS || row0 + r >= M) return;
  float ax = 0.f, ay = 0.f, at = 0.f;
  for (int w = 0; w < WARPS; ++w) {
    const float* q = part + (w * ROWS + r) * 3;
    ax += q[0];
    ay += q[1];
    at += q[2];
  }
  float* p = dx + (size_t)(row0 + r) * dim;
  p[0] = rnd_enc<P>(ax) / n.sigma;
  p[1] = rnd_enc<P>(ay) / n.sigma;
  if (dim > 2) p[2] = at;
}

// ------------------------------------------------------ bf16, tensor cores --

template <int P>
__global__ void __launch_bounds__(CB_THREADS, CB_CTAS_PER_SM)
collision_bwd_tc_kernel(const float* __restrict__ x, const float* __restrict__ mult,
                        const float* __restrict__ gcot, int M, int dim, NetArgs n, float beta,
                        float* __restrict__ dx, float* __restrict__ dmult) {
  static_assert(P == BF16_APPLY, "the bf16 collision terms take onf_apply's casts");
  constexpr int WARPS = CB_WARPS, ROWS = CB_ROWS, MTILES = CB_MTILES;
  extern __shared__ float4 smem_f4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem_f4);
  const CbLayout L = cb_layout(n);
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int HID = n.HID, FEAT = L.FEAT, NH = L.NH, NF = L.NF;
  const int ldf = L.ldf, ldh = L.ldh;
  bf16* w1 = reinterpret_cast<bf16*>(sm + L.w1);
  bf16* w2 = reinterpret_cast<bf16*>(sm + L.w2);
  bf16* feat = reinterpret_cast<bf16*>(sm + L.feat);
  float* part = reinterpret_cast<float*>(sm + L.feat);
  bf16* h1 = reinterpret_cast<bf16*>(sm + L.h1);
  bf16* h2 = reinterpret_cast<bf16*>(sm + L.h2);
  float* slope = reinterpret_cast<float*>(sm + L.slope);
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

  if (skipped(n)) {
    zero_row<CB_THREADS>(dx + (size_t)b * M * dim, (size_t)M * dim);
    zero_row<CB_THREADS>(dmult + (size_t)b * M, M);
    return;
  }

  // zero everything: padding rows and columns stay zero
  for (int i = tid; i < L.total / 16; i += CB_THREADS) smem_f4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  load_tc_weights<P, CB_THREADS>(n, b, w1, w2, ldh, w3, ew, eb, b1, b2, ab);
  const float b3 = n.b3[b], g1 = gcot[2 * b], g2 = gcot[2 * b + 1];
  x += (size_t)b * M * dim;
  mult += (size_t)b * M;
  dx += (size_t)b * M * dim;
  dmult += (size_t)b * M;

  for (int row0 = 0; row0 < M; row0 += ROWS) {
    // poses past M: gz is zero; the feature tile's padding columns are
    // zeroed again (the last tile's partial sums used them)
    load_poses<P, ROWS>(x, M, dim, row0, n, xn, yn, th);
    __syncthreads();
    tc_features<WARPS, ROWS>(n, ew, eb, ab, xn, yn, th, feat, slope, ldf);
    for (int i = tid, pad = L.KF - FEAT; i < ROWS * pad; i += CB_THREADS)
      feat[(i / pad) * ldf + FEAT + i % pad] = __float2bfloat16_rn(0.f);
    __syncthreads();
    tc_dense_relu<WARPS, MTILES>(feat, ldf, L.KF, w1, ldh, b1, NH, h1, ldh);
    __syncthreads();
    tc_dense_relu<WARPS, MTILES>(h1, ldh, L.KH, w2, ldh, b2, NH, h2, ldh);
    __syncthreads();
    // head z = [h2 | features] . out.w + out.b, d logits, d multipliers, and
    // h2 := d pre2 = [h2 > 0] bf16(gz out.w): warp w takes rows w + WARPS q,
    // all at once; each lane rewrites the h2 elements it read
    {
      constexpr int RW = ROWS / WARPS;
      float acc[RW];
      head_partial<WARPS, RW>(acc, h2, ldh, feat, ldf, w3, HID, FEAT);
#pragma unroll
      for (int q = 0; q < RW; ++q) {
        const int r = warp + q * WARPS;
        const float gz = logit_cotangent(warp_sum(acc[q]) + b3, row0 + r, M, mult, g1, g2, beta,
                                         dmult, lane == 0);
        if (lane == 0) gs[r] = gz;
        for (int j = lane; j < HID; j += 32) {
          bf16* hp = h2 + r * ldh + j;
          *hp = __float2bfloat16_rn(bf(*hp) > 0.f ? head_cotangent<P>(gz, w3[j]) : 0.f);
        }
      }
    }
    __syncthreads();
    // h1 := d pre1 = [h1 > 0] bf16(d pre2 . W2^T): each warp owns whole
    // 8-column tiles, so it reads each mask before it writes it
    for (int nt = warp; nt < NH; nt += 2 * WARPS) {
      const bool both = nt + WARPS < NH;
      float acc[2][MTILES][4] = {};
      pair_product<true, WARPS, MTILES>(acc, h2, ldh, L.KH, w2, ldh, nt, both);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j == 1 && !both) break;
        const int c = (nt + WARPS * j) * 8 + 2 * t;
#pragma unroll
        for (int m = 0; m < MTILES; ++m) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            bf16* p = h1 + (m * 16 + g + 8 * half) * ldh + c;
            const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(p);
            store_pair(p, bf(h.x) > 0.f ? acc[j][m][2 * half] : 0.f,
                       bf(h.y) > 0.f ? acc[j][m][2 * half + 1] : 0.f);
          }
        }
      }
    }
    __syncthreads();
    // d features = bf16(d pre1 . W1^T) + bf16(gz out.w) on the accumulators,
    // times the slope, summed over this warp's features for each row: lane
    // (g, t) holds rows 16 m + g + 8 half, then the 4 lanes t are summed
    {
      float ax[MTILES][2] = {}, ay[MTILES][2] = {}, at[MTILES][2] = {};
      for (int nt0 = warp; nt0 < NF; nt0 += 2 * WARPS) {
        const bool both = nt0 + WARPS < NF;
        float accs[2][MTILES][4] = {};
        pair_product<true, WARPS, MTILES>(accs, h1, ldh, L.KH, w1, ldh, nt0, both);
#pragma unroll
        for (int je = 0; je < 4; ++je) {
          const int j = je / 2, e = je % 2;
          if (j == 1 && !both) break;
          const int k = (nt0 + WARPS * j) * 8 + 2 * t + e;
          if (k >= FEAT) continue;
          const float w = w3[HID + k];
#pragma unroll
          for (int m = 0; m < MTILES; ++m) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = m * 16 + g + 8 * half;
              const float df = rnd<P>(accs[j][m][2 * half + e]) + head_cotangent<P>(gs[r], w);
              add_feature(n, ew, k, slope[r * ldf + k] * df, ax[m][half], ay[m][half],
                          at[m][half]);
            }
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MTILES; ++m) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v[3] = {ax[m][half], ay[m][half], at[m][half]};
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            v[c] += __shfl_xor_sync(0xffffffffu, v[c], 1);
            v[c] += __shfl_xor_sync(0xffffffffu, v[c], 2);
          }
          if (t == 0) {
            float* q = part + (warp * ROWS + m * 16 + g + 8 * half) * 3;
            q[0] = v[0];
            q[1] = v[1];
            q[2] = v[2];
          }
        }
      }
    }
    __syncthreads();
    write_pose_grads<P, WARPS, ROWS>(part, row0, M, dim, n, dx);
  }
}

// ---------------------------------------------------------------- f32 ----

template <int P>
__global__ void __launch_bounds__(CF_THREADS, 1)
collision_bwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ mult,
                         const float* __restrict__ gcot, int M, int dim, NetArgs n, float beta,
                         float* __restrict__ dx, float* __restrict__ dmult) {
  static_assert(P == F32, "the bf16 mode runs collision_bwd_tc_kernel");
  constexpr int WARPS = CF_WARPS;
  extern __shared__ float4 smem_f4[];
  float* s = reinterpret_cast<float*>(smem_f4);
  const CfLayout L = cf_layout(n);
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32, rg = tid % 8;
  const int HID = n.HID, FEAT = L.FEAT, NF = L.NF, NH = L.NH;
  const int ldw = L.ldw, ldf = L.ldf, ldh = L.ldh;
  float *w1 = s + L.w1, *w2 = s + L.w2, *feat = s + L.feat, *part = s + L.feat,
        *slope = s + L.slope, *h1 = s + L.h1, *h2 = s + L.h2;
  float *w3 = s + L.w3, *ew = s + L.ew, *eb = s + L.eb, *b1 = s + L.b1, *b2 = s + L.b2,
        *ab = s + L.ab, *xn = s + L.xn, *yn = s + L.yn, *th = s + L.th, *gs = s + L.g;

  if (skipped(n)) {
    zero_row<CF_THREADS>(dx + (size_t)b * M * dim, (size_t)M * dim);
    zero_row<CF_THREADS>(dmult + (size_t)b * M, M);
    return;
  }

  // zero everything: padding rows and columns stay zero
  for (int i = tid; i < L.total / 4; i += CF_THREADS) smem_f4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  load_f32_weights<CF_THREADS>(n, b, w1, w2, ldw, w3, ew, eb, b1, b2, ab);
  const float b3 = n.b3[b], g1 = gcot[2 * b], g2 = gcot[2 * b + 1];
  x += (size_t)b * M * dim;
  mult += (size_t)b * M;
  dx += (size_t)b * M * dim;
  dmult += (size_t)b * M;

  for (int row0 = 0; row0 < M; row0 += TM) {
    // poses past M: gz is zero; the feature tile's padding columns are
    // zeroed again (the last tile's partial sums used them)
    load_poses<P, TM>(x, M, dim, row0, n, xn, yn, th);
    __syncthreads();
    f32_features<CF_THREADS>(n, ew, eb, ab, xn, yn, th, feat, slope, ldf);
    for (int i = tid, pad = 4 * NF - FEAT; i < TM * pad; i += CF_THREADS)
      feat[(i / pad) * ldf + FEAT + i % pad] = 0.f;
    __syncthreads();
    dense_relu_f32(feat, ldf, 4 * NF, w1, ldw, b1, NH, h1, ldh);
    __syncthreads();
    dense_relu_f32(h1, ldh, 4 * NH, w2, ldw, b2, NH, h2, ldh);
    __syncthreads();
    // head, d logits, d multipliers, h2 := d pre2 (as in the bf16 kernel)
    {
      constexpr int RW = TM / WARPS;
      float acc[RW];
      head_partial<WARPS, RW>(acc, h2, ldh, feat, ldf, w3, HID, FEAT);
#pragma unroll
      for (int q = 0; q < RW; ++q) {
        const int r = warp + q * WARPS;
        const float gz = logit_cotangent(warp_sum(acc[q]) + b3, row0 + r, M, mult, g1, g2, beta,
                                         dmult, lane == 0);
        if (lane == 0) gs[r] = gz;
        for (int j = lane; j < HID; j += 32) {
          float* hp = h2 + r * ldh + j;
          *hp = *hp > 0.f ? gz * w3[j] : 0.f;
        }
      }
    }
    __syncthreads();
    // h1 := d pre1 = [h1 > 0] (d pre2 . W2^T): thread (rg, jg) takes rows
    // rg + 8 i and columns jg + NH v
    if (tid / 8 < NH) {
      const int jg = tid / 8;
      float acc[4][4] = {};
      mm_nt(acc, h2, ldh, rg, 4 * NH, w2, ldw, jg, NH);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          float* hp = h1 + (rg + 8 * i) * ldh + jg + NH * v;
          *hp = *hp > 0.f ? acc[i][v] : 0.f;
        }
      }
    }
    __syncthreads();
    // d features = d pre1 . W1^T + gz out.w, times the slope, summed over
    // this thread's features kg + NF v for its rows rg + 8 i, in passes of a
    // warp's 32 items; then over the 4 lanes of each row group
    {
      float ax[4] = {}, ay[4] = {}, at[4] = {};
      for (int base = 32 * warp; base < 8 * NF; base += CF_THREADS) {
        const int item = base + lane, kg = min(item / 8, NF - 1);
        float acc[4][4] = {};
        mm_nt(acc, h1, ldh, rg, 4 * NH, w1, ldw, kg, NF);
        if (item >= 8 * NF) continue;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int k = kg + NF * v;
          if (k >= FEAT) continue;
          const float w = w3[HID + k];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = rg + 8 * i;
            add_feature(n, ew, k, slope[r * ldf + k] * fmaf(gs[r], w, acc[i][v]), ax[i], ay[i],
                        at[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v[3] = {ax[i], ay[i], at[i]};
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          v[c] += __shfl_xor_sync(0xffffffffu, v[c], 8);
          v[c] += __shfl_xor_sync(0xffffffffu, v[c], 16);
        }
        if (lane < 8) {
          float* q = part + (warp * TM + rg + 8 * i) * 3;
          q[0] = v[0];
          q[1] = v[1];
          q[2] = v[2];
        }
      }
    }
    __syncthreads();
    write_pose_grads<P, WARPS, TM>(part, row0, M, dim, n, dx);
  }
}

template <int P>
int launch_collision_bwd(const NetArgs* net, const float* x, const float* mult, const float* g,
                         int B, int M, int dim, float beta, float* dx, float* dmult,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (P == F32) {
    const CfLayout L = cf_layout(*net);
    const size_t bytes = (size_t)L.total * sizeof(float);
    if (bytes > (size_t)MAX_SMEM || 8 * L.NH > CF_THREADS) return TOO_LARGE;
    const cudaError_t err = cudaFuncSetAttribute(
        collision_bwd_f32_kernel<F32>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    collision_bwd_f32_kernel<F32><<<B, CF_THREADS, bytes, s>>>(x, mult, g, M, dim, *net, beta,
                                                               dx, dmult);
  } else {
    const CbLayout L = cb_layout(*net);
    const size_t bytes = (size_t)L.total;
    if (bytes > (size_t)MAX_SMEM) return TOO_LARGE;
    cudaError_t err = cudaFuncSetAttribute(
        collision_bwd_tc_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(collision_bwd_tc_kernel<P>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    collision_bwd_tc_kernel<P><<<B, CB_THREADS, bytes, s>>>(x, mult, g, M, dim, *net, beta, dx,
                                                            dmult);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int nf_collision_bwd(const NetArgs* net, const float* x, const float* mult,
                                const float* g, int B, int M, int dim, float beta, int bf16,
                                float* dx, float* dmult, void* stream) {
  return bf16 ? launch_collision_bwd<BF16_APPLY>(net, x, mult, g, B, M, dim, beta, dx, dmult,
                                                 stream)
              : launch_collision_bwd<F32>(net, x, mult, g, B, M, dim, beta, dx, dmult, stream);
}
