// Fused CNN-NNGP Gram (K3) and its scalar-tangent backward (K4), CUDA C++
// for Hopper (sm_90a). Bound to Python with ctypes by
// snngp_torch/ops/conv_gram.py.
//
// K3 replaces snngp/ops/pallas/conv_gram.py::_kernel (launched by
// _cnn_gram_pallas). Same math, per pair (i, j) of [H, W, C] images, on the
// matched-pixel state k[p], one value per pixel p:
//   k = sum_c x1[i, p, c] x2[j, p, c] / C
//   depth x [k = T(w2 S(k) + b2; v1[l, i, p], v2[l, j, p])]
//   K[i, j] = last2 / HW * sum_p k
// with S the 3 x 3 SAME mean (zeros off the edge), T the arccos (ReLU) or
// arcsin (Erf) dual activation and the variance maps v1 [depth+1, n1, HW],
// v2 [depth+1, n2, HW] computed outside (O(N HW depth)).
//
// K4 replaces conv_gram.py::_grad_kernel (launched by _cnn_gram_grads). It
// carries the forward-mode tangents dk/dw_std and dk/db_std beside k through
// the same linear stencil, du/dw = w2 S(dk_w) + 2 w S(k), du/db =
// w2 S(dk_b) + 2 b, with the activation partials shared by both and the
// variance maps' tangents dv1, dv2 [2, depth+1, n, HW]. The TPU kernel
// writes four Grams (K, dK/dw, dK/db, dK/dlast) and its only caller reduces
// the three tangents against the cotangent g; this kernel reads g and fuses
// that contraction: each block writes one triple (sum g dK/dw, sum g dK/db,
// sum g dK/dlast) of its pairs, reduced in float64 in a fixed order (per
// pair a warp's shuffles, per warp its pairs in order, then the block's
// warps in order), with no atomics, so the sums repeat bitwise. The
// wrapper adds the blocks' triples in float64.
//
// What bounds them on an H100: at the CIFAR shape (32 x 32 x 3, depth 4)
// each pair runs 1,024 pixels x depth x (a 3 x 3 stencil of 4 adds and an
// IEEE divide, one acosf or asinf, two sqrtf, one divide, ~12 FMA) and
// writes one float: the FP32 and SFU pipes, that is the instructions a warp
// issues, bound them, not memory (the inputs are a few MB and stay in L2).
// K4 does about three times K3's work per pixel. The TPU kernel read a
// precomputed k0 [N1, N2, HW] from HBM; here the input moment (C <= 3 FMAs
// a pixel) is fused, which saves an N1 N2 HW x 4-byte pass (287 MB over the
// three Gram blocks of one SVSP step at the CIFAR shape).
//
// K3's design: one warp streams a pair's rows through registers. Lane c of
// a segment owns column c of the state; each lane forms its pixel's input
// moment (the channel-order fmaf, times 1/C, so K(x, x) stays symmetric),
// and each conv layer's stencil takes its column sum (z + left) + right by
// two shuffles and its row sum (zc + up) + down from a window of three rows
// of column sums in registers, then / 9, the Dense FMA and the dual
// activation: the plain version's order (ops/conv_gram.py::_stencil). The
// layers are pipelined, layer l emitting row t - l - 1 at step t from the
// row layer l - 1 emitted in the same step; each lane adds the last layer's
// rows of its column, and a fixed-order shuffle tree gives the pair's sum,
// times last2 / HW. kStages layers run in registers a pass; a deeper
// network streams the state through a per-warp plane of shared memory
// between passes ([rows][32] floats, read and written by its own lane, no
// barrier), the launch sizing its block to what kPlaneBudget holds. No
// shared memory holds the state otherwise, no barrier runs, and the row
// loop's addresses advance by a stride: no integer division in it. Narrow
// images: a segment is seg = 2^lg >= the image's columns lanes
// wide and a warp holds 32 / seg pairs (8 x 8: four), the shuffles taking
// `width` seg. An image wider than 32 columns (h w <= 1,024 gives h <= 32
// then) streams transposed: the wrapper swaps the strides (rstride,
// cstride), which only changes the stencil's summation order. With `same`
// (K(x, x)) a launch enumerates the n (n + 1) / 2 pairs j <= i, runs each
// once and writes (i, j) and (j, i). IEEE acosf / asinf / sqrtf and
// divides, no fast math: the parity bar is fp32.
//
// K4's design (simple first). None of the TPU layout carries over (the
// 128-lane HW padding, the wide / narrow tiles, the rolls with lane masks).
// Each pair's state is a whole image (HW floats, 4 KB at 32 x 32), and a
// block keeps the states of a tile of ti x tj pairs in shared memory, with
// a second plane per state for the separable stencil's column sums: pass 1
// writes the column sums (z + left) + right, pass 2 reads the row
// neighbours of those, (zc + up) + down, divides by 9 and applies the Dense
// step and the dual activation's partials in place, one barrier after each
// pass. The neighbours are read with row / column edge tests, so ragged H
// and W (28 x 28, 6 x 5, 1 x 1) need no padding. The tile's variance rows
// of the current layer and their tangents are staged in shared memory too,
// and each is read by tj (or ti) pairs. The wrapper chooses the tile from
// HW at launch (about 2,048 pair-pixels a block: 1 x 2 pairs at 32 x 32,
// 5 x 6 at 8 x 8). The readout sums each pair's pixels in a fixed order
// (one warp per pair), so results repeat.

#include <cuda_runtime.h>

#include "stream.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// K3: conv layers a pass keeps in registers (a deeper network takes more
// passes), and its blocks an SM (the __launch_bounds__ minimum): 5 x 256
// threads leave each thread 48 registers, and ptxas fits both
// instantiations without a spill. On an H100 (700 W) at 200 x 200 pairs
// of 32 x 32 x 3, depth 4, relu, symmetric: 4 blocks (64 registers) 0.472
// ms, 5 blocks 0.464 ms, 6 blocks (40 registers) 0.468 ms.
constexpr int kStages = 4;
constexpr int kConvBlocksPerSM = 5;
// K3 deeper than kStages layers: the per-warp planes may take this many
// bytes of shared memory a block (at least one warp's plane), and no block
// may take more than Hopper's opt-in limit.
constexpr int kPlaneBudget = 64 * 1024;
constexpr int kSmemLimit = 232448;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kInv2Pi = 0.15915494309189533577f;
constexpr float kInv4Pi = 0.07957747154594766788f;
constexpr float kTwoOverPi = 0.63661977236758134308f;

enum Act { kRelu = 0, kErf = 1 };

// The dual activations and their partials: line for line those of
// csrc/gram.cu and of _relu_t / _erf_t / *_partials in ops/gram.py.
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

struct Partials {
  float t, tk, tv1, tv2;
};

template <int ACT>
__device__ __forceinline__ Partials dual_act_partials(float k, float v1, float v2);

template <>
__device__ __forceinline__ Partials dual_act_partials<kRelu>(float k, float v1,
                                                             float v2) {
  const float s = sqrtf(fmaxf(v1 * v2, 1e-30f));
  const float c = fminf(fmaxf(k / s, -1.0f), 1.0f);
  const float theta = acosf(c);
  const float sin_t = sqrtf(fmaxf(1.0f - c * c, 0.0f));
  const float q = sin_t / s * kInv4Pi;
  Partials p;
  p.t = (s * sin_t + (kPi - theta) * k) * kInv2Pi;
  p.tk = (kPi - theta) * kInv2Pi;
  p.tv1 = q * v2;
  p.tv2 = q * v1;
  return p;
}

template <>
__device__ __forceinline__ Partials dual_act_partials<kErf>(float k, float v1,
                                                            float v2) {
  const float d1 = 1.0f + 2.0f * v1;
  const float d2 = 1.0f + 2.0f * v2;
  const float r = 1.0f / sqrtf(d1 * d2);
  const float g = 2.0f * k * r;
  const float c = fminf(fmaxf(g, -1.0f), 1.0f);
  const bool inside = (g > -1.0f) && (g < 1.0f);
  const float base = inside ? kTwoOverPi / sqrtf(fmaxf(1.0f - c * c, 1e-30f)) : 0.0f;
  const float bgr2 = base * g * (r * r);
  Partials p;
  p.t = kTwoOverPi * asinf(c);
  p.tk = base * (2.0f * r);
  p.tv1 = -bgr2 * d2;
  p.tv2 = -bgr2 * d1;
  return p;
}

// The block's tile: pairs (i0 + q / tj, j0 + q % tj) for q < ti * tj, each
// with an HW-pixel plane; element e = q * hw + p.
struct Tile {
  int h, w, hw, ti, tj, pairs, elems, i0, j0;

  __device__ Tile(int h_, int w_, int ti_, int tj_)
      : h(h_), w(w_), hw(h_ * w_), ti(ti_), tj(tj_), pairs(ti_ * tj_),
        elems(ti_ * tj_ * h_ * w_), i0(blockIdx.y * ti_), j0(blockIdx.x * tj_) {}
};

// Column pass of the separable 3 x 3 sum: (z[p] + z[p - 1]) + z[p + 1],
// the missing neighbours off the row's ends counting 0.
__device__ __forceinline__ float col_sum(const float* z, int p, int col, int w) {
  float s = z[p] + ((col >= 1) ? z[p - 1] : 0.0f);
  return s + ((col < w - 1) ? z[p + 1] : 0.0f);
}

// Row pass on the column sums: (zc[p] + zc[p - w]) + zc[p + w].
__device__ __forceinline__ float row_sum(const float* z, int p, int row, int h, int w) {
  float s = z[p] + ((row >= 1) ? z[p - w] : 0.0f);
  return s + ((row < h - 1) ? z[p + w] : 0.0f);
}

// k0 of every element of the tile: the input moment in plain fp32 FMA in
// channel order (so K(x, x) stays symmetric), times 1/C; 0 off the edge.
__device__ __forceinline__ void input_moment(const Tile& t, const float* __restrict__ x1,
                                             const float* __restrict__ x2, int n1,
                                             int n2, int c, float inv_c, float* kpl) {
  for (int e = threadIdx.x; e < t.elems; e += kThreads) {
    const int q = e / t.hw;
    const int p = e - q * t.hw;
    const int i = t.i0 + q / t.tj;
    const int j = t.j0 + q % t.tj;
    float acc = 0.0f;
    if (i < n1 && j < n2) {
      const float* a = x1 + ((size_t)i * t.hw + p) * c;
      const float* b = x2 + ((size_t)j * t.hw + p) * c;
      for (int ch = 0; ch < c; ++ch) acc = fmaf(a[ch], b[ch], acc);
    }
    kpl[e] = acc * inv_c;
  }
}

// Layer l's rows of an [*, n, HW] map for the tile's `count` images from
// `first`: dst[r * hw + p]; `fill` off the edge.
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, int l, int n,
                                           int first, int count, int hw, float fill,
                                           float* dst) {
  for (int e = threadIdx.x; e < count * hw; e += kThreads) {
    const int r = e / hw;
    const int p = e - r * hw;
    dst[e] = (first + r < n) ? src[((size_t)l * n + first + r) * hw + p] : fill;
  }
}

// Per-pair pixel sum in a fixed order: lanes stride the plane, then
// shuffles; the result is valid in lane 0.
__device__ __forceinline__ float pair_sum(const float* plane, int hw, int lane) {
  float s = 0.0f;
  for (int p = lane; p < hw; p += 32) s += plane[p];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  return s;
}

// K3, streamed (see the header). x1 [n1, hw, c], x2 [n2, hw, c]; v1 [depth
// + 1, n1, hw], v2 [depth + 1, n2, hw]; scales = [w^2, b^2, last^2, 1/C].
// Dynamic shared memory: with depth > kStages, one [rows][32] plane a warp.
template <int ACT>
__global__ void __launch_bounds__(kThreads, kConvBlocksPerSM)
conv_gram_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                 const float* __restrict__ v1, const float* __restrict__ v2,
                 const float* __restrict__ scales, float* __restrict__ out, int n1, int n2,
                 Geo G, int c, int depth, int same) {
  extern __shared__ float planes[];
  const StreamLane L(G, n1, n2, same);
  const int seg = 1 << G.lg;
  const int rows = G.rows;
  const int rs = G.rstride;
  const float w2 = scales[0];
  const float b2 = scales[1];
  const float inv_c = scales[3];
  const int pix = L.c * G.cstride;
  const float* xa = x1 + ((size_t)L.i * G.hw + pix) * c;
  const float* xb = x2 + ((size_t)L.j * G.hw + pix) * c;
  const int rsc = rs * c;
  const int o1 = L.i * G.hw + pix;   // in one variance layer
  const int o2 = L.j * G.hw + pix;
  const int s1 = n1 * G.hw;          // between variance layers
  const int s2 = n2 * G.hw;
  float* plane = planes + (threadIdx.x >> 5) * 32 * rows + (threadIdx.x & 31);

  float acc = 0.0f;
  for (int l0 = 0;; l0 += kStages) {
    const int g = min(kStages, depth - l0);   // this pass's layers, l0 + 1 .. l0 + g
    const bool first = l0 == 0;
    const bool last = l0 + g == depth;
    float cp[kStages], cc[kStages];
#pragma unroll
    for (int l = 0; l < kStages; ++l) cp[l] = cc[l] = 0.0f;
    for (int t = 0; t < rows + g; ++t) {
      float z = 0.0f;            // row t entering the pass
      if (L.active && t < rows) {
        if (first) {
          const float* a = xa + t * rsc;
          const float* b = xb + t * rsc;
          float m = 0.0f;
          for (int ch = 0; ch < c; ++ch) m = fmaf(__ldg(a + ch), __ldg(b + ch), m);
          z = m * inv_c;
        } else {
          z = plane[t * 32];
        }
      }
#pragma unroll
      for (int l = 0; l < kStages; ++l) {
        if (l < g) {
          const float cn = lane_col_sum(z, L, seg);   // row t - l's column sums
          const int u = t - l - 1;                     // the row layer l emits
          z = 0.0f;
          if (u >= 0 && u < rows) {
            const float sk = ((cc[l] + cp[l]) + cn) / 9.0f;
            const int layer = l0 + l + 1;
            float va = 1.0f, vb = 1.0f;
            if (L.active) {
              va = __ldg(v1 + (layer * s1 + o1 + u * rs));
              vb = __ldg(v2 + (layer * s2 + o2 + u * rs));
            }
            z = dual_act<ACT>(w2 * sk + b2, va, vb);   // Conv 3x3 SAME, act
          }
          cp[l] = cc[l];
          cc[l] = cn;
        }
      }
      const int u = t - g;       // the row leaving the pass
      if (L.active && u >= 0) {
        if (last)
          acc += z;
        else
          plane[u * 32] = z;
      }
    }
    if (last) break;
  }

  // Flatten (spatial mean) + final Dense: the segment's column sums in a
  // fixed order.
  for (int off = seg >> 1; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off, seg);
  if (L.c == 0 && L.pair_ok) {
    const float k = scales[2] / (float)G.hw * acc;
    out[(size_t)L.i * n2 + L.j] = k;
    if (same && L.i != L.j) out[(size_t)L.j * n2 + L.i] = k;
  }
}

// K4. Shared memory: k, dk/dw, dk/db and their column sums, six
// [ti * tj][hw] planes; then the layer's rows v1, dv1/dw, dv1/db [ti][hw]
// and v2, dv2/dw, dv2/db [tj][hw]. scales = [w^2, b^2, last^2, 1/C, w, b,
// last]; partial is [3][gridDim.x * gridDim.y] float64.
template <int ACT>
__global__ void __launch_bounds__(kThreads)
conv_gram_grads_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                       const float* __restrict__ v1, const float* __restrict__ v2,
                       const float* __restrict__ dv1, const float* __restrict__ dv2,
                       const float* __restrict__ scales, const float* __restrict__ g,
                       double* __restrict__ partial, int n1, int n2, int h, int w,
                       int c, int depth, int ti, int tj) {
  extern __shared__ float smem[];
  __shared__ double red[3][kWarps];
  const Tile t(h, w, ti, tj);
  const int hw = t.hw;
  float* kpl = smem;
  float* kw = kpl + t.elems;
  float* kb = kw + t.elems;
  float* sk = kb + t.elems;
  float* sw = sk + t.elems;
  float* sb = sw + t.elems;
  float* vr1 = sb + t.elems;
  float* dw1 = vr1 + ti * hw;
  float* db1 = dw1 + ti * hw;
  float* vr2 = db1 + ti * hw;
  float* dw2 = vr2 + tj * hw;
  float* db2 = dw2 + tj * hw;
  const int rows = depth + 1;

  const float w2 = scales[0];
  const float b2 = scales[1];
  const float last2 = scales[2];
  const float two_w = 2.0f * scales[4];
  const float two_b = 2.0f * scales[5];
  const float two_last = 2.0f * scales[6];

  input_moment(t, x1, x2, n1, n2, c, scales[3], kpl);
  for (int e = threadIdx.x; e < t.elems; e += kThreads) {
    kw[e] = 0.0f;
    kb[e] = 0.0f;
  }
  __syncthreads();
  for (int l = 1; l <= depth; ++l) {
    // Off the edge: variance 1, tangents 0 (finite, and g is not read there).
    stage_rows(v1, l, n1, t.i0, ti, hw, 1.0f, vr1);
    stage_rows(dv1, l, n1, t.i0, ti, hw, 0.0f, dw1);
    stage_rows(dv1, rows + l, n1, t.i0, ti, hw, 0.0f, db1);
    stage_rows(v2, l, n2, t.j0, tj, hw, 1.0f, vr2);
    stage_rows(dv2, l, n2, t.j0, tj, hw, 0.0f, dw2);
    stage_rows(dv2, rows + l, n2, t.j0, tj, hw, 0.0f, db2);
    for (int e = threadIdx.x; e < t.elems; e += kThreads) {
      const int q = e / hw;
      const int p = e - q * hw;
      const int col = p % w;
      sk[e] = col_sum(kpl + q * hw, p, col, w);
      sw[e] = col_sum(kw + q * hw, p, col, w);
      sb[e] = col_sum(kb + q * hw, p, col, w);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < t.elems; e += kThreads) {
      const int q = e / hw;
      const int p = e - q * hw;
      const int row = p / w;
      const int r1 = (q / tj) * hw + p;
      const int r2 = (q % tj) * hw + p;
      const float s_k = row_sum(sk + q * hw, p, row, h, w) / 9.0f;
      const float u = w2 * s_k + b2;                          // Conv 3x3 SAME
      const float duw = w2 * (row_sum(sw + q * hw, p, row, h, w) / 9.0f) + two_w * s_k;
      const float dub = w2 * (row_sum(sb + q * hw, p, row, h, w) / 9.0f) + two_b;
      const Partials pa = dual_act_partials<ACT>(u, vr1[r1], vr2[r2]);
      kw[e] = pa.tk * duw + pa.tv1 * dw1[r1] + pa.tv2 * dw2[r2];
      kb[e] = pa.tk * dub + pa.tv1 * db1[r1] + pa.tv2 * db2[r2];
      kpl[e] = pa.t;
    }
    __syncthreads();
  }

  // Flatten + final Dense per pair, contracted against g: one warp per
  // pair, each warp's pairs added in order in lane 0.
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float scale = last2 / (float)hw;
  const float scale_l = two_last / (float)hw;
  double aw = 0.0, ab = 0.0, al = 0.0;
  for (int q = warp; q < t.pairs; q += kWarps) {
    const float s_k = pair_sum(kpl + q * hw, hw, lane);
    const float s_w = pair_sum(kw + q * hw, hw, lane);
    const float s_b = pair_sum(kb + q * hw, hw, lane);
    const int i = t.i0 + q / tj;
    const int j = t.j0 + q % tj;
    if (lane == 0 && i < n1 && j < n2) {
      const double gv = (double)g[(size_t)i * n2 + j];
      aw = fma(gv, (double)(scale * s_w), aw);
      ab = fma(gv, (double)(scale * s_b), ab);
      al = fma(gv, (double)(scale_l * s_k), al);
    }
  }
  if (lane == 0) {
    red[0][warp] = aw;
    red[1][warp] = ab;
    red[2][warp] = al;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    double s = 0.0;
    for (int wi = 0; wi < kWarps; ++wi) s += red[threadIdx.x][wi];
    const int nb = gridDim.x * gridDim.y;
    partial[(size_t)threadIdx.x * nb + blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// Dynamic shared memory above 48 KB needs the kernel's opt-in first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

size_t smem_bytes(int hw, int ti, int tj, int planes, int row_planes) {
  return sizeof(float) * (size_t)hw * ((size_t)planes * ti * tj + (size_t)row_planes * (ti + tj));
}

// K3's launch: kWarps warps a block; deeper than kStages layers, as many
// warps as kPlaneBudget bytes of [rows][32]-float planes hold (at least
// one), with one plane a warp.
template <int ACT>
cudaError_t launch(const float* x1, const float* x2, const float* v1, const float* v2,
                   const float* scales, float* out, int n1, int n2, const Geo& G, int c,
                   int depth, int same, cudaStream_t stream) {
  const int plane = depth > kStages ? G.rows * 32 * (int)sizeof(float) : 0;
  const int warps = plane > 0 ? max(1, min(kWarps, kPlaneBudget / plane)) : kWarps;
  const int smem = warps * plane;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const long long pairs = same ? (long long)n1 * (n1 + 1) / 2 : (long long)n1 * n2;
  const long long lane_warps = (pairs + (32 >> G.lg) - 1) / (32 >> G.lg);
  const long long blocks = (lane_warps + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const cudaError_t err = allow_smem(conv_gram_kernel<ACT>, smem);
  if (err != cudaSuccess) return err;
  conv_gram_kernel<ACT><<<(unsigned)blocks, 32 * warps, smem, stream>>>(
      x1, x2, v1, v2, scales, out, n1, n2, G, c, depth, same);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t launch_grads(const float* x1, const float* x2, const float* v1,
                         const float* v2, const float* dv1, const float* dv2,
                         const float* scales, const float* g, double* partial, int n1,
                         int n2, int h, int w, int c, int depth, int ti, int tj,
                         cudaStream_t stream) {
  const dim3 grid((n2 + tj - 1) / tj, (n1 + ti - 1) / ti);
  const size_t smem = smem_bytes(h * w, ti, tj, 6, 3);
  const cudaError_t err = allow_smem(conv_gram_grads_kernel<ACT>, smem);
  if (err != cudaSuccess) return err;
  conv_gram_grads_kernel<ACT><<<grid, kThreads, smem, stream>>>(
      x1, x2, v1, v2, dv1, dv2, scales, g, partial, n1, n2, h, w, c, depth, ti, tj);
  return cudaGetLastError();
}

}  // namespace

// x1 [n1, h, w, c], x2 [n2, h, w, c], v1 [depth+1, n1, h*w], v2 [depth+1, n2,
// h*w], scales [w^2, b^2, last^2, 1/c], out [n1, n2]: all fp32, contiguous, on
// the device of `stream`. The images stream `rows` rows of `lanes` <= 32
// columns (lanes * rows = h * w) in segments of 2^lg >= lanes lanes, pixel
// (r, col) at r * rstride + col * cstride. act: 0 relu, 1 erf; same = 1: x2
// is x1 and v2 is v1 (n1 == n2), so each pair j <= i runs once and writes
// (i, j) and (j, i). The caller checks that every variance index fits an
// int. Returns the CUDA error code of the launch (0 on success); does not
// synchronize.
extern "C" int snngp_conv_gram_f32(const float* x1, const float* x2, const float* v1,
                                   const float* v2, const float* scales, float* out,
                                   int n1, int n2, int lanes, int rows, int lg, int rstride,
                                   int cstride, int c, int depth, int act, int same,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo G{lanes, rows, lg, rstride, cstride, lanes * rows};
  if (lanes < 1 || lg > 5 || lanes > (1 << lg) || rows < 1 || c < 1 || depth < 0 ||
      (same && n1 != n2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (act == kRelu)
    err = launch<kRelu>(x1, x2, v1, v2, scales, out, n1, n2, G, c, depth, same, s);
  else if (act == kErf)
    err = launch<kErf>(x1, x2, v1, v2, scales, out, n1, n2, G, c, depth, same, s);
  return static_cast<int>(err);
}

// As snngp_conv_gram_f32, plus dv1 [2, depth+1, n1, h*w], dv2 [2, depth+1, n2,
// h*w] (the variance maps' tangents in w_std, b_std), the cotangent g [n1, n2]
// fp32, scales [w^2, b^2, last^2, 1/c, w, b, last], and partial [3, nblocks]
// float64 with nblocks = ceil(n1 / ti) * ceil(n2 / tj): block (by, bx) writes
// its (sum g dK/dw, sum g dK/db, sum g dK/dlast) at column by * ceil(n2 / tj)
// + bx. Returns the CUDA error code of the launch; does not synchronize.
extern "C" int snngp_conv_gram_grads_f32(const float* x1, const float* x2,
                                         const float* v1, const float* v2,
                                         const float* dv1, const float* dv2,
                                         const float* scales, const float* g,
                                         double* partial, int n1, int n2, int h, int w,
                                         int c, int depth, int act, int ti, int tj,
                                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (act == kRelu)
    err = launch_grads<kRelu>(x1, x2, v1, v2, dv1, dv2, scales, g, partial, n1, n2, h, w,
                              c, depth, ti, tj, s);
  else if (act == kErf)
    err = launch_grads<kErf>(x1, x2, v1, v2, dv1, dv2, scales, g, partial, n1, n2, h, w,
                             c, depth, ti, tj, s);
  return static_cast<int>(err);
}

// cudaGetErrorString for the wrapper's exception message.
extern "C" const char* snngp_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
