// Fused conv-WideResNet NNGP Gram: the stride-1 residual tail (K5) and the
// stride-2 group-boundary block (K6), CUDA C++ for Hopper (sm_90a). Bound to
// Python with ctypes by snngp_torch/ops/resnet_conv_gram.py.
//
// Both run on the matched-pixel state k[p] of a pair (i, j) of images, one
// value per pixel, with S the 3 x 3 SAME mean (zeros off the edge), T the
// arccos (ReLU) or arcsin (Erf) dual activation and the variance maps of
// the two images computed outside (O(N HW depth)).
//
// K5 replaces snngp/ops/pallas/resnet_conv_gram.py::_tail_kernel (launched
// by _tail_pallas): `nblocks` stride-1 residual blocks,
//   t1 = T(k; v1[2b, i], v2[2b, j]);  c1 = w2 S(t1) + b2
//   t2 = T(c1; v1[2b+1, i], v2[2b+1, j])
//   k <- k + w2 S(t2) + b2     (identity shortcut)
// with `mismatch` block 0 taking the conv shortcut instead,
//   k <- (w2 S(t2) + b2) + (w2 S(k) + b2).
//
// K6 replaces resnet_conv_gram.py::_strided_kernel (launched by
// strided_mismatch_block): a group's leading stride-2 mismatch block,
//   t1 = T(k; v_in)                        at full resolution H x W
//   c1 = w2 S(t1)|lattice + b2             the stride-2 conv
//   t2 = T(c1; v_mid)                      at H2 x W2 = ceil halves
//   out = (w2 S(t2) + b2) + (w2 S(k)|lattice + b2)
// where S(.)|lattice is the stride-1 stencil read at the lattice points
// (2a + oh, 2b + ow), (oh, ow) = (H even, W even): the SAME stride-2 conv.
// The TPU kernel ran at full resolution, on a parity lattice with a dilated
// stencil, and XLA subsampled its output; this kernel evaluates the strided
// stencils at the lattice points only and writes the reduced state.
//
// What bounds them on an H100: per pixel and block each runs two dual
// activations (an IEEE acosf or asinf, two sqrtf and divides), two or three
// stencils of 4 adds and an IEEE divide, and a few FMAs, on a state that
// enters and leaves once (4 KB a pair at 32 x 32): the FP32 and SFU pipes,
// that is the instructions a warp issues, bound them, not memory.
//
// K5's design: one warp streams a pair's rows through registers. Lane c of
// a segment owns column c of the state; a stencil's column sum (z + left) +
// right takes two shuffles, its row sum (zc + up) + down comes from a window
// of three rows of column sums held in registers, then / 9, the order of
// the plain version (ops/conv_gram.py::_stencil). The 2 NB stencils of a
// launch's NB residual blocks are pipelined: at step t block b receives row
// t - 2b of its input k_b, its first stencil emits row t - 2b - 1 of S(t1)
// and its second row t - 2b - 2 of S(t2), which with the carry k_b held two
// steps (and, for the conv shortcut of block 0 with `mismatch`, S(k) of the
// old k from a third window, held one step) gives row t - 2b - 2 of
// k_{b+1}. No shared memory holds the state, no barrier runs, and the row
// loop's addresses advance by a stride: no integer division in it. NB is a
// template argument (1 to 4) and the wrapper chains launches for a deeper
// tail, the fp32 state between launches being the state within one.
// Narrow images: a segment is seg = 2^lg >= the state's columns lanes wide
// and a warp holds 32 / seg pairs (16 x 16: two, 4 x 4: eight), the
// shuffles taking `width` seg. An image wider than 32 columns (h w <= 1,024
// gives h <= 32 then) streams transposed: the wrapper swaps the strides
// (rstride, cstride), which only changes the stencil's summation order. The
// variance rows are read through the read-only cache (each is read by every
// pair of its image). IEEE acosf / asinf / sqrtf and divides, no fast math:
// the parity bar is fp32. The dual activation multiplies v1 v2 in one order
// for (i, j) and (j, i), and with `same` (K(x, x)) a launch enumerates the
// n (n + 1) / 2 pairs j <= i, runs each once and writes (i, j) and (j, i).
//
// K6 (simple first). None of the TPU layout carries over (the 128-lane HW
// padding, the rolls with lane masks, the "ones off the lattice"). A block
// keeps a tile of ti x tj pairs in shared memory, the wrapper choosing the
// tile from HW at launch (about 4,096 pair-pixels a block: 2 x 2 pairs at
// 32 x 32, 8 x 8 at 8 x 8): k and t1 at full resolution and the column sums
// of each at the lattice columns (12 KB a pair at 32 x 32). The separable
// stencil writes the column sums (z + left) + right in one pass and reads
// their row neighbours, (zc + up) + down, then / 9, in the next, one
// barrier after each pass; neighbours are read with row / column edge
// tests, so ragged H, W need no padding.

#include <cuda_runtime.h>

#include "stream.cuh"

namespace {

constexpr int kThreads = 256;
// K5: at most this many residual blocks a launch (the wrapper reads it
// through snngp_resnet_tail_max_blocks and chains launches for a deeper
// tail), and its blocks an SM (the __launch_bounds__ minimum): 4 x 256
// threads leave each thread 64 registers, and ptxas spills (stores / loads)
// 48 / 104 bytes at four blocks, 56 / 112 at four with the conv shortcut
// and 4 / 24 at three with it. On an H100 (700 W) at 200 x 200 pairs of
// 32 x 32 states, four blocks with the conv shortcut, relu, symmetric: 3
// blocks an SM (80 registers; this relu instantiation spills 4 bytes)
// 1.112 ms, 4 blocks 0.913 ms, 5 blocks 0.937 ms, 6 blocks 0.943 ms.
constexpr int kMaxTailBlocks = 4;
constexpr int kTailBlocksPerSM = 4;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kInv2Pi = 0.15915494309189533577f;
constexpr float kTwoOverPi = 0.63661977236758134308f;

enum Act { kRelu = 0, kErf = 1 };

// The dual activations: line for line those of csrc/conv_gram.cu and of
// _relu_t / _erf_t in ops/gram.py.
template <int ACT>
__device__ __forceinline__ float dual_act(float k, float v1, float v2);

template <>
__device__ __forceinline__ float dual_act<kRelu>(float k, float v1, float v2) {
  const float s = sqrtf(fmaxf(v1 * v2, 1e-30f));
  const float c = fminf(fmaxf(k / s, -1.0f), 1.0f);
  const float theta = acosf(c);
  const float sin_t = sqrtf(fmaxf(1.0f - c * c, 0.0f));
  return (s * sin_t + (kPi - theta) * k) * kInv2Pi;
}

template <>
__device__ __forceinline__ float dual_act<kErf>(float k, float v1, float v2) {
  const float denom = sqrtf((1.0f + 2.0f * v1) * (1.0f + 2.0f * v2));
  const float c = fminf(fmaxf(2.0f * k / denom, -1.0f), 1.0f);
  return kTwoOverPi * asinf(c);
}

// The block's tile: pairs (i0 + q / tj, j0 + q % tj) for q < ti * tj.
struct Tile {
  int ti, tj, pairs, i0, j0;

  __device__ Tile(int ti_, int tj_)
      : ti(ti_), tj(tj_), pairs(ti_ * tj_), i0(blockIdx.y * ti_), j0(blockIdx.x * tj_) {}
  __device__ int i(int q) const { return i0 + q / tj; }
  __device__ int j(int q) const { return j0 + q % tj; }
};

// Column pass of the separable 3 x 3 sum: (z[p] + z[p - 1]) + z[p + 1],
// the missing neighbours off the row's ends counting 0.
__device__ __forceinline__ float col_sum(const float* z, int p, int col, int w) {
  float s = z[p] + ((col >= 1) ? z[p - 1] : 0.0f);
  return s + ((col < w - 1) ? z[p + 1] : 0.0f);
}

// Row pass on the column sums, in a plane of row stride `stride`:
// (zc[p] + zc[p - stride]) + zc[p + stride], rows off the image counting 0.
__device__ __forceinline__ float row_sum(const float* z, int p, int row, int h, int stride) {
  float s = z[p] + ((row >= 1) ? z[p - stride] : 0.0f);
  return s + ((row < h - 1) ? z[p + stride] : 0.0f);
}

// Row `img` of an [n, len] variance map at pixel p; 1 off the edge, which
// keeps the masked pairs finite.
__device__ __forceinline__ float var_at(const float* __restrict__ v, int img, int n, int len,
                                        int p) {
  return (img < n) ? __ldg(v + (size_t)img * len + p) : 1.0f;
}

// K5: NB residual blocks, streamed (see the header). v1 [2 NB, n1, hw] and
// v2 [2 NB, n2, hw]: the launch's variance rows; scales = [w^2, b^2]; MIS:
// block 0 takes the conv shortcut. Per block b the registers hold the two
// stencils' windows (cpA, ccA: S(t1); cpB, ccB: S(t2)) and the carry k_b of
// the last two rows (kc1, kc2).
template <int ACT, int NB, bool MIS>
__global__ void __launch_bounds__(kThreads, kTailBlocksPerSM)
resnet_tail_kernel(const float* __restrict__ k_in, const float* __restrict__ v1,
                   const float* __restrict__ v2, const float* __restrict__ scales,
                   float* __restrict__ k_out, int n1, int n2, Geo G, int same) {
  const StreamLane L(G, n1, n2, same);
  const int seg = 1 << G.lg;
  const int rows = G.rows;
  const int rs = G.rstride;
  const float w2 = scales[0];
  const float b2 = scales[1];
  const int pix = L.c * G.cstride;
  const float* kp = k_in + ((size_t)L.i * n2 + L.j) * G.hw + pix;
  float* out1 = k_out + ((size_t)L.i * n2 + L.j) * G.hw + pix;
  float* out2 = k_out + ((size_t)L.j * n2 + L.i) * G.hw + pix;
  const bool mirror = same && L.i != L.j;
  const int o1 = L.i * G.hw + pix;   // in one variance row block
  const int o2 = L.j * G.hw + pix;
  const int s1 = n1 * G.hw;          // between variance row blocks
  const int s2 = n2 * G.hw;

  float cpA[NB], ccA[NB], cpB[NB], ccB[NB], kc1[NB], kc2[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) cpA[b] = ccA[b] = cpB[b] = ccB[b] = kc1[b] = kc2[b] = 0.0f;
  float cpK = 0.0f, ccK = 0.0f, sk_held = 0.0f;   // MIS: S(k)'s window, S(k) held a step

  for (int t = 0; t < rows + 2 * NB; ++t) {
    float z = (L.active && t < rows) ? kp[t * rs] : 0.0f;   // k_0, row t
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int r = t - 2 * b;   // the row of k_b entering block b; z holds it
      float t1 = 0.0f;           // T(k_b), 0 off the image
      if (r >= 0 && r < rows) {
        float va = 1.0f, vb = 1.0f;
        if (L.active) {
          va = __ldg(v1 + (2 * b * s1 + o1 + r * rs));
          vb = __ldg(v2 + (2 * b * s2 + o2 + r * rs));
        }
        t1 = dual_act<ACT>(z, va, vb);
      }
      const float cs_a = lane_col_sum(t1, L, seg);
      float sk = 0.0f;
      if (MIS && b == 0) {        // S(k) of the old k at row r - 1
        const float cs_k = lane_col_sum(z, L, seg);
        sk = ((ccK + cpK) + cs_k) / 9.0f;
        cpK = ccK;
        ccK = cs_k;
      }
      float t2 = 0.0f;           // t2 = T(c1) at row r - 1
      const int ua = r - 1;
      if (ua >= 0 && ua < rows) {
        const float c1 = w2 * (((ccA[b] + cpA[b]) + cs_a) / 9.0f) + b2;
        float va = 1.0f, vb = 1.0f;
        if (L.active) {
          va = __ldg(v1 + ((2 * b + 1) * s1 + o1 + ua * rs));
          vb = __ldg(v2 + ((2 * b + 1) * s2 + o2 + ua * rs));
        }
        t2 = dual_act<ACT>(c1, va, vb);
      }
      cpA[b] = ccA[b];
      ccA[b] = cs_a;
      const float cs_b = lane_col_sum(t2, L, seg);
      float next = 0.0f;         // k_{b+1} at row r - 2
      const int ub = r - 2;
      if (ub >= 0 && ub < rows) {
        const float s2v = ((ccB[b] + cpB[b]) + cs_b) / 9.0f;
        if (MIS && b == 0)
          next = (w2 * s2v + b2) + (w2 * sk_held + b2);
        else
          next = kc2[b] + w2 * s2v + b2;
      }
      cpB[b] = ccB[b];
      ccB[b] = cs_b;
      kc2[b] = kc1[b];
      kc1[b] = z;
      if (MIS && b == 0) sk_held = sk;
      z = next;
    }
    const int u = t - 2 * NB;    // the row of k_NB that z holds
    if (L.active && u >= 0) {
      out1[u * rs] = z;
      if (mirror) out2[u * rs] = z;
    }
  }
}

// K6. Shared memory per pair: k and t1 [hw] at full resolution, then the
// column sums of t1 and of k at the lattice columns, [h][wr] each. The
// reduced planes (t2, the shortcut, t2's column sums; [hr][wr] each) reuse
// the first three once their contents are consumed. v1 [n1, hw] and
// v1m [n1, hr * wr] (v2, v2m likewise): the variances entering the
// block's two activations; scales = [w^2, b^2].
template <int ACT>
__global__ void __launch_bounds__(kThreads)
resnet_strided_kernel(const float* __restrict__ k_in, const float* __restrict__ v1,
                      const float* __restrict__ v2, const float* __restrict__ v1m,
                      const float* __restrict__ v2m, const float* __restrict__ scales,
                      float* __restrict__ k_out, int n1, int n2, int h, int w, int ti,
                      int tj) {
  extern __shared__ float smem[];
  const Tile t(ti, tj);
  const int hw = h * w;
  const int oh = (h % 2 == 0) ? 1 : 0;
  const int ow = (w % 2 == 0) ? 1 : 0;
  const int hr = (h + 1) / 2;
  const int wr = (w + 1) / 2;
  const int hwr = hr * wr;
  const int hwc = h * wr;            // every row, the lattice columns
  float* kpl = smem;                 // [pairs][hw] k;  later t2 [pairs][hwr]
  float* tpl = kpl + t.pairs * hw;   // [pairs][hw] t1; later the shortcut [pairs][hwr]
  float* ct = tpl + t.pairs * hw;    // [pairs][hwc] t1's column sums; later t2's [pairs][hwr]
  float* ck = ct + t.pairs * hwc;    // [pairs][hwc] k's column sums
  const float w2 = scales[0];
  const float b2 = scales[1];

  for (int e = threadIdx.x; e < t.pairs * hw; e += kThreads) {   // t1 = T(k; v_in)
    const int q = e / hw;
    const int p = e - q * hw;
    const int i = t.i(q);
    const int j = t.j(q);
    const float kv = (i < n1 && j < n2) ? k_in[((size_t)i * n2 + j) * hw + p] : 0.0f;
    kpl[e] = kv;
    tpl[e] = dual_act<ACT>(kv, var_at(v1, i, n1, hw, p), var_at(v2, j, n2, hw, p));
  }
  __syncthreads();
  for (int e = threadIdx.x; e < t.pairs * hwc; e += kThreads) {  // column sums at c = 2b + ow
    const int q = e / hwc;
    const int rc = e - q * hwc;
    const int r = rc / wr;
    const int c = 2 * (rc - r * wr) + ow;
    const int p = r * w + c;
    ct[e] = col_sum(tpl + q * hw, p, c, w);
    ck[e] = col_sum(kpl + q * hw, p, c, w);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < t.pairs * hwr; e += kThreads) {  // at (2a + oh, 2b + ow)
    const int q = e / hwr;
    const int pr = e - q * hwr;
    const int a = pr / wr;
    const int r = 2 * a + oh;
    const int rc = r * wr + (pr - a * wr);
    const float c1 = w2 * (row_sum(ct + q * hwc, rc, r, h, wr) / 9.0f) + b2;
    kpl[e] = dual_act<ACT>(c1, var_at(v1m, t.i(q), n1, hwr, pr),
                           var_at(v2m, t.j(q), n2, hwr, pr));             // t2
    tpl[e] = w2 * (row_sum(ck + q * hwc, rc, r, h, wr) / 9.0f) + b2;     // shortcut
  }
  __syncthreads();
  for (int e = threadIdx.x; e < t.pairs * hwr; e += kThreads) {  // t2's column sums
    const int q = e / hwr;
    const int pr = e - q * hwr;
    ct[e] = col_sum(kpl + q * hwr, pr, pr % wr, wr);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < t.pairs * hwr; e += kThreads) {  // out = c2 + shortcut
    const int q = e / hwr;
    const int pr = e - q * hwr;
    const int i = t.i(q);
    const int j = t.j(q);
    const float c2 = w2 * (row_sum(ct + q * hwr, pr, pr / wr, hr, wr) / 9.0f) + b2;
    if (i < n1 && j < n2) k_out[((size_t)i * n2 + j) * hwr + pr] = c2 + tpl[e];
  }
}

// Dynamic shared memory above 48 KB needs the kernel's opt-in first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int ACT, int NB, bool MIS>
cudaError_t launch_tail_nb(const float* k, const float* v1, const float* v2,
                           const float* scales, float* out, int n1, int n2, const Geo& G,
                           int same, cudaStream_t stream) {
  const long long pairs = same ? (long long)n1 * (n1 + 1) / 2 : (long long)n1 * n2;
  const long long warps = (pairs + (32 >> G.lg) - 1) / (32 >> G.lg);
  const long long blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  resnet_tail_kernel<ACT, NB, MIS><<<(unsigned)blocks, kThreads, 0, stream>>>(
      k, v1, v2, scales, out, n1, n2, G, same);
  return cudaGetLastError();
}

template <int ACT, bool MIS>
cudaError_t launch_tail_mis(const float* k, const float* v1, const float* v2,
                            const float* scales, float* out, int n1, int n2, const Geo& G,
                            int nblocks, int same, cudaStream_t stream) {
  switch (nblocks) {
    case 1: return launch_tail_nb<ACT, 1, MIS>(k, v1, v2, scales, out, n1, n2, G, same, stream);
    case 2: return launch_tail_nb<ACT, 2, MIS>(k, v1, v2, scales, out, n1, n2, G, same, stream);
    case 3: return launch_tail_nb<ACT, 3, MIS>(k, v1, v2, scales, out, n1, n2, G, same, stream);
    case 4: return launch_tail_nb<ACT, 4, MIS>(k, v1, v2, scales, out, n1, n2, G, same, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int ACT>
cudaError_t launch_tail(const float* k, const float* v1, const float* v2,
                        const float* scales, float* out, int n1, int n2, const Geo& G,
                        int nblocks, int mismatch, int same, cudaStream_t stream) {
  if (mismatch)
    return launch_tail_mis<ACT, true>(k, v1, v2, scales, out, n1, n2, G, nblocks, same, stream);
  return launch_tail_mis<ACT, false>(k, v1, v2, scales, out, n1, n2, G, nblocks, same, stream);
}

template <int ACT>
cudaError_t launch_strided(const float* k, const float* v1, const float* v2,
                           const float* v1m, const float* v2m, const float* scales,
                           float* out, int n1, int n2, int h, int w, int ti, int tj,
                           cudaStream_t stream) {
  const dim3 grid((n2 + tj - 1) / tj, (n1 + ti - 1) / ti);
  const size_t per_pair = 2 * (size_t)h * w + 2 * (size_t)h * ((w + 1) / 2);
  const size_t smem = sizeof(float) * per_pair * ti * tj;
  const cudaError_t err = allow_smem(resnet_strided_kernel<ACT>, smem);
  if (err != cudaSuccess) return err;
  resnet_strided_kernel<ACT><<<grid, kThreads, smem, stream>>>(
      k, v1, v2, v1m, v2m, scales, out, n1, n2, h, w, ti, tj);
  return cudaGetLastError();
}

}  // namespace

// k, out [n1, n2, lanes * rows]; v1 [2 * nblocks, n1, lanes * rows], v2
// [2 * nblocks, n2, lanes * rows]; scales [w^2, b^2]: all fp32, contiguous,
// on the device of `stream`. The state streams `rows` rows of `lanes` <= 32
// columns in segments of 2^lg >= lanes lanes, element (r, c) at pixel r *
// rstride + c * cstride. nblocks: 1 to 4 residual blocks; mismatch: block 0
// takes the conv shortcut; act: 0 relu, 1 erf; same = 1: k is K(x, x)'s
// state (bitwise symmetric, n1 == n2, v2 is v1), so each pair j <= i runs
// once and writes (i, j) and (j, i). The caller checks that every variance
// index fits an int. Returns the CUDA error code of the launch (0 on
// success); does not synchronize.
extern "C" int snngp_resnet_tail_f32(const float* k, const float* v1, const float* v2,
                                     const float* scales, float* out, int n1, int n2,
                                     int lanes, int rows, int lg, int rstride, int cstride,
                                     int nblocks, int mismatch, int act, int same,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo G{lanes, rows, lg, rstride, cstride, lanes * rows};
  if (lanes < 1 || lg > 5 || lanes > (1 << lg) || rows < 1 || nblocks < 1 ||
      nblocks > kMaxTailBlocks || (same && n1 != n2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (act == kRelu)
    err = launch_tail<kRelu>(k, v1, v2, scales, out, n1, n2, G, nblocks, mismatch, same, s);
  else if (act == kErf)
    err = launch_tail<kErf>(k, v1, v2, scales, out, n1, n2, G, nblocks, mismatch, same, s);
  return static_cast<int>(err);
}

// k [n1, n2, h*w] -> out [n1, n2, hr*wr], hr = ceil(h/2), wr = ceil(w/2);
// v1 [n1, h*w], v2 [n2, h*w] enter the first activation, v1m [n1, hr*wr],
// v2m [n2, hr*wr] the second; scales [w^2, b^2]. As snngp_resnet_tail_f32
// otherwise.
extern "C" int snngp_resnet_strided_f32(const float* k, const float* v1, const float* v2,
                                        const float* v1m, const float* v2m,
                                        const float* scales, float* out, int n1, int n2,
                                        int h, int w, int act, int ti, int tj,
                                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (act == kRelu)
    err = launch_strided<kRelu>(k, v1, v2, v1m, v2m, scales, out, n1, n2, h, w, ti, tj, s);
  else if (act == kErf)
    err = launch_strided<kErf>(k, v1, v2, v1m, v2m, scales, out, n1, n2, h, w, ti, tj, s);
  return static_cast<int>(err);
}

// The most residual blocks one snngp_resnet_tail_f32 call takes.
extern "C" int snngp_resnet_tail_max_blocks() { return kMaxTailBlocks; }

// cudaGetErrorString for the wrapper's exception message.
extern "C" const char* snngp_resnet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
