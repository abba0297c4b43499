// Adam's update of every leaf of a tree of batched parameters in one launch:
// for element i of a leaf, in row r = i / row_size (a row of `count`: one
// problem, or one group of a shared field),
//   m' = (1-b1) g + b1 m,   v' = (1-b2) (g g) + b2 v,
//   p' = p + (-lr) ((m' / bc1[r]) / (sqrt(v' / bc2[r]) + eps)),
// written to fresh arrays (the caller keeps the old state). The bias
// corrections bc1 = 1 - b1^count and bc2 = 1 - b2^count are the caller's
// PyTorch ops (solver/adam.py); the kernel reads them and computes no power.
//
// Replaces no TPU kernel: on the TPU, XLA fuses optax's update into a few
// passes. PyTorch runs the same formula as 14 elementwise kernels per leaf
// (kernels/adam.py::adam_leaves_plain), 32 passes over the leaf.
//
// Bound on this card: bytes. Each element reads g, m, v and p and writes m',
// v' and p' once, 28 bytes for ~12 flops. For the car field at B=256 (33,141
// parameters a problem, 8.48M elements) that is 238 MB, 71 us at 3.35 TB/s
// (H100 SXM data sheet rate).
// Design: the leaf table travels by value in the kernel's parameters (a
// __grid_constant__ struct, read from the constant bank), so nothing is
// copied to the card before the launch and a captured graph replays the
// launch as it was captured. The leaves' elements are cut into quads of 4,
// numbered across the leaves, one thread per quad and as many blocks as the
// quads need (8,286 for the car field at B=256, 63 blocks an SM): the block
// scheduler keeps every SM fed to the end. A persistent grid of the blocks
// the SMs hold at once, striding over the quads, read 9% slower (0.090 ms
// against 0.082 on an H100 SXM at B=256). A quad of a leaf whose seven
// arrays are 16-byte aligned moves as one float4 per array, 64 bytes of
// loads in flight a thread; a leaf's last short quad, and every quad of a
// leaf that is not aligned, moves element by element. Row sizes (1, 20, 100,
// 200, 320, 400, 10,000, 22,000 for the car field; 300 for its trajectory)
// need not divide by 4, so a quad may straddle rows: its elements find their
// rows one by one from the first element's row.
// Every operation rounds once to f32, in the order and with the f32 scalars
// of PyTorch's separate kernels (__fmul_rn and friends: nvcc contracts
// nothing into an FMA; the shared NVCC_FLAGS are not touched), so the result
// equals the plain version's bit for bit.
#include <cuda_runtime.h>

namespace nf {

constexpr int ADAM_MAX_LEAVES = 16;  // kernels/adam.py::MAX_LEAVES
constexpr int ADAM_THREADS = 256;

// one leaf as the wrapper describes it (kernels/adam.py::_Leaf)
struct AdamLeaf {
  const float* g;
  const float* m;
  const float* v;
  const float* p;
  float* m_out;
  float* v_out;
  float* p_out;
  long long numel;
  long long row_size;  // numel / rows of count
};

// the launch's parameter: the leaves and where each one's quads end
struct AdamTable {
  AdamLeaf leaf[ADAM_MAX_LEAVES];
  long long end[ADAM_MAX_LEAVES];  // quads of leaves 0..l together
  int vec[ADAM_MAX_LEAVES];        // 1 when leaf l's seven arrays are 16-byte aligned
  int count;
};

// the f32 scalars, each a Python double rounded once, as PyTorch rounds a
// scalar it multiplies or adds to a float32 tensor
struct AdamScalars {
  float one_minus_b1, b1, one_minus_b2, b2, eps, neg_lr;
};

__device__ __forceinline__ void adam_element(float g, float m, float v, float p, float bc1,
                                             float bc2, const AdamScalars& s, float& m_out,
                                             float& v_out, float& p_out) {
  m_out = __fadd_rn(__fmul_rn(s.one_minus_b1, g), __fmul_rn(s.b1, m));
  v_out = __fadd_rn(__fmul_rn(s.one_minus_b2, __fmul_rn(g, g)), __fmul_rn(s.b2, v));
  const float m_hat = __fdiv_rn(m_out, bc1);
  const float v_hat = __fdiv_rn(v_out, bc2);
  const float step = __fdiv_rn(m_hat, __fadd_rn(__fsqrt_rn(v_hat), s.eps));
  p_out = __fadd_rn(p, __fmul_rn(s.neg_lr, step));
}

__global__ void __launch_bounds__(ADAM_THREADS)
adam_kernel(const __grid_constant__ AdamTable t, const float* __restrict__ bc1,
            const float* __restrict__ bc2, const __grid_constant__ AdamScalars s) {
  const long long q = static_cast<long long>(blockIdx.x) * ADAM_THREADS + threadIdx.x;
  if (q >= t.end[t.count - 1]) return;
  int l = 0;
  while (q >= t.end[l]) ++l;
  const AdamLeaf& a = t.leaf[l];
  const long long e = 4 * (q - (l > 0 ? t.end[l - 1] : 0));  // the quad's first element
  const int n = a.numel - e < 4 ? static_cast<int>(a.numel - e) : 4;
  // each element's row: a row's ragged end may fall inside the quad
  long long row = a.numel <= 0xffffffffLL
                      ? static_cast<unsigned>(e) / static_cast<unsigned>(a.row_size)
                      : e / a.row_size;
  long long next = (row + 1) * a.row_size;
  float c1[4], c2[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < n) {
      if (e + j >= next) {
        ++row;
        next += a.row_size;
      }
      c1[j] = __ldg(bc1 + row);
      c2[j] = __ldg(bc2 + row);
    }
  }
  if (n == 4 && t.vec[l]) {
    const float4 g = __ldg(reinterpret_cast<const float4*>(a.g + e));
    const float4 m = __ldg(reinterpret_cast<const float4*>(a.m + e));
    const float4 v = __ldg(reinterpret_cast<const float4*>(a.v + e));
    const float4 p = __ldg(reinterpret_cast<const float4*>(a.p + e));
    float4 mo, vo, po;
    adam_element(g.x, m.x, v.x, p.x, c1[0], c2[0], s, mo.x, vo.x, po.x);
    adam_element(g.y, m.y, v.y, p.y, c1[1], c2[1], s, mo.y, vo.y, po.y);
    adam_element(g.z, m.z, v.z, p.z, c1[2], c2[2], s, mo.z, vo.z, po.z);
    adam_element(g.w, m.w, v.w, p.w, c1[3], c2[3], s, mo.w, vo.w, po.w);
    *reinterpret_cast<float4*>(a.m_out + e) = mo;
    *reinterpret_cast<float4*>(a.v_out + e) = vo;
    *reinterpret_cast<float4*>(a.p_out + e) = po;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < n) {
        const long long i = e + j;
        adam_element(__ldg(a.g + i), __ldg(a.m + i), __ldg(a.v + i), __ldg(a.p + i), c1[j], c2[j],
                     s, a.m_out[i], a.v_out[i], a.p_out[i]);
      }
    }
  }
}

}  // namespace nf

namespace {

bool aligned(const void* ptr) { return reinterpret_cast<unsigned long long>(ptr) % 16 == 0; }

}  // namespace

// One launch over `count` leaves (1 to ADAM_MAX_LEAVES, none empty) on
// `stream`, with the bias corrections bc1, bc2 [rows] and the scalars as
// PyTorch rounds them: f32(1 - b1), f32(b1), f32(1 - b2), f32(b2), f32(eps),
// f32(-lr).
extern "C" int nf_adam(const nf::AdamLeaf* leaves, int count, const float* bc1,
                       const float* bc2, float one_minus_b1, float b1, float one_minus_b2,
                       float b2, float eps, float neg_lr, void* stream) {
  if (count < 1 || count > nf::ADAM_MAX_LEAVES) return static_cast<int>(cudaErrorInvalidValue);
  nf::AdamTable t{};
  long long quads = 0;
  for (int l = 0; l < count; ++l) {
    const nf::AdamLeaf& a = leaves[l];
    if (a.numel < 1 || a.row_size < 1) return static_cast<int>(cudaErrorInvalidValue);
    t.leaf[l] = a;
    quads += (a.numel + 3) / 4;
    t.end[l] = quads;
    t.vec[l] = aligned(a.g) && aligned(a.m) && aligned(a.v) && aligned(a.p) &&
               aligned(a.m_out) && aligned(a.v_out) && aligned(a.p_out);
  }
  t.count = count;
  const long long blocks = (quads + nf::ADAM_THREADS - 1) / nf::ADAM_THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const nf::AdamScalars s{one_minus_b1, b1, one_minus_b2, b2, eps, neg_lr};
  nf::adam_kernel<<<static_cast<unsigned>(blocks), nf::ADAM_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(t, bc1, bc2, s);
  return static_cast<int>(cudaGetLastError());
}
