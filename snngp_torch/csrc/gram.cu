// Fused NNGP Gram for the MLP and dense-ResNet kernels (K1) and its
// scalar-tangent backward (K2), CUDA C++ for Hopper (sm_90a). Bound to Python
// with ctypes by snngp_torch/ops/gram.py.
//
// K1 replaces snngp/ops/pallas/gram.py::_gram_kernel (launched by
// _mlp_gram_pallas). Same math, per output element:
//   k = <x1_i, x2_j> / D
//   mlp:    depth x [k = T(w2 k + b2; v1[l+1]_i, v2[l+1]_j)], then last2 k
//   resnet: k = w2 k + b2, then depth x [k = k + w2 T(k; v1[l]_i, v2[l]_j) + b2],
//           then last2 T(k; v1[depth]_i, v2[depth]_j)
// with T the arccos (ReLU) or arcsin (Erf) dual activation and the per-layer
// variance rows v1 [depth+1, n1], v2 [depth+1, n2] computed outside (O(N depth)).
//
// K2 replaces snngp/ops/pallas/gram.py::_gram_grad_kernel (launched by
// _mlp_gram_grads). It runs K1's recursion with the forward-mode tangents
// dk/dw_std and dk/db_std carried beside k, fed the variance rows and their
// two tangent rows. The TPU kernel writes the four Grams (K, dK/dw, dK/db,
// dK/dlast) and its only caller reduces each tangent against the cotangent g;
// this kernel reads g and fuses that contraction: each block writes one
// triple (sum g dK/dw, sum g dK/db, sum g dK/dlast) of its 64 x 64 tile,
// reduced in float64 in a fixed order (warp shuffles, then the block's 8
// warps), with no atomics, so the sums repeat bitwise from run to run. The
// wrapper adds the blocks' triples in float64.
//
// What bounds them on an H100: at D = 16, N = 10,000, depth 4, K1 does ~5e7
// pairs of K(x, x) x depth x (one acosf or asinf, one rsqrtf, ~15 FMA) against
// a 400 MB store; K2 about twice that arithmetic per pair against a 400 MB
// read of g. Both are bound by the instructions their warps issue (the FP32
// and SFU pipes), not by memory. The input product is 2 D FMA per output:
// too little for wgmma to pay at D = 16.
//
// Design. One 64 x 64 output tile per 256-thread block, 4 x 4 outputs per
// thread. The block stages its x1 and x2 rows in shared memory in chunks of
// 32 features and accumulates the dot product in plain fp32 FMA in a fixed
// order over D. The recursion runs layer by layer over the thread's 16
// outputs (16 independent chains a layer), in registers, with IEEE acosf /
// asinf (no fast math: the parity bar is fp32) and rsqrtf for sin(theta)
// and erf's T'.
// - Per-row factors. Every row-only part of the dual activation comes from
//   factors staged beside the tile's rows, kLayers layers at a time, so that
//   a pair pays no sqrtf or divide for them: relu a = sqrt(v), r = 1 / a
//   (v floored at kVarFloor), s = a_i a_j, c = k (r_i r_j); erf e = 1 /
//   sqrt(1 + 2 v), c = 2 k (e_i e_j). K2's tangent rows are staged already
//   scaled: relu r dv (T_v1 dv1 + T_v2 dv2 = sin(theta) / (4 pi) (a_j r_i
//   dv_i + a_i r_j dv_j)), erf e^2 dv (= -T' g (e_i^2 dv_i + e_j^2 dv_j)).
//   The products of two factors are formed first, so they commute.
// - Symmetric launch (`same`, K(x, x)): a 1-D grid over the T (T + 1) / 2
//   tiles (ti, tj), tj <= ti (tri_pair, csrc/stream.cuh). K1 writes an
//   off-diagonal tile and its transpose through a padded [64][65] plane
//   (both stores coalesced); a diagonal tile writes its lower triangle and
//   mirrors it, so K(x, x) is bitwise symmetric by construction. K2 weights
//   each pair j < i by g[i, j] + g[j, i] (added in float64; g[j, i] read
//   through the same plane) and each diagonal pair by g[i, i], so g and g^T
//   give the same bits. A cross launch runs the 2-D grid of all tiles.
// Ragged edges are masked: no padding of rows or features. The scales come
// from a device tensor, so a launch needs no host sync.

#include <cuda_runtime.h>

#include "stream.cuh"

namespace {

constexpr int kTile = 64;                 // output tile edge
constexpr int kThreadsEdge = 16;          // 16 x 16 threads
constexpr int kPer = kTile / kThreadsEdge;  // outputs per thread per axis
constexpr int kThreads = kThreadsEdge * kThreadsEdge;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;                // features staged per pass
constexpr int kLayers = 8;                // layers of row factors staged per pass
constexpr int kGramBlocks = 4;            // K1's blocks an SM (__launch_bounds__)
constexpr int kGradsBlocks = 3;           // K2's blocks an SM (__launch_bounds__)
constexpr float kVarFloor = 1e-30f;       // relu: a row's variance floor
constexpr float kPi = 3.14159265358979323846f;
constexpr float kInv2Pi = 0.15915494309189533577f;
constexpr float kInv4Pi = 0.07957747154594766788f;
constexpr float kTwoOverPi = 0.63661977236758134308f;

enum Mode { kMlp = 0, kResnet = 1 };
enum Act { kRelu = 0, kErf = 1 };

// Factors a row stages per layer: K1 relu (a, r), erf (e); K2 adds the two
// scaled tangents (relu r dv/dw, r dv/db; erf e^2 dv/dw, e^2 dv/db).
template <int ACT, bool GRADS>
constexpr int kFactors = (ACT == kRelu ? 2 : 1) + (GRADS ? 2 : 0);

// The block's shared stage of the input rows, reused once the dot product
// is done as one [64][65] plane of a tile. The +1s: conflict-free column
// reads.
struct Stage {
  float xs[2][kTile][kChunk + 1];
};
static_assert(2 * kTile * (kChunk + 1) >= kTile * (kTile + 1), "plane fits the stage");

__device__ __forceinline__ float (*plane(Stage& st))[kTile + 1] {
  return reinterpret_cast<float (*)[kTile + 1]>(&st.xs[0][0][0]);
}

// The output tile of this block: (blockIdx.y, blockIdx.x) of a cross launch,
// the lower-triangle tile blockIdx.x of a symmetric one.
struct Tile {
  int row0, col0;
  bool diag;
};

__device__ __forceinline__ Tile tile_of(int same) {
  if (!same) return {(int)blockIdx.y * kTile, (int)blockIdx.x * kTile, false};
  int ti, tj;
  tri_pair(blockIdx.x, ti, tj);
  return {ti * kTile, tj * kTile, ti == tj};
}

// sin(acos(c)) = sqrt(1 - c^2) by rsqrtf (2 ulp; held to the plain version
// on the card), 0 at c = +-1.
__device__ __forceinline__ float sin_of(float c) {
  const float s2 = fmaxf(1.0f - c * c, 0.0f);
  return s2 > 0.0f ? s2 * rsqrtf(s2) : 0.0f;
}

// The dual activation T(k) of rows i and j, from their factors fi, fj.
template <int ACT>
__device__ __forceinline__ float dual_act(float k, const float* fi, const float* fj);

// E[relu(u) relu(v)] for (u, v) ~ N(0, [[v1, k], [k, v2]]); factors (a, r),
// a = sqrt(v), r = 1 / sqrt(v).
template <>
__device__ __forceinline__ float dual_act<kRelu>(float k, const float* fi, const float* fj) {
  const float s = fi[0] * fj[0];
  const float c = fminf(fmaxf(k * (fi[1] * fj[1]), -1.0f), 1.0f);
  const float theta = acosf(c);
  const float sin_t = sin_of(c);
  return (s * sin_t + (kPi - theta) * k) * kInv2Pi;
}

// E[erf(u) erf(v)] = (2/pi) asin(2k e_i e_j); factor e = 1 / sqrt(1 + 2 v).
template <>
__device__ __forceinline__ float dual_act<kErf>(float k, const float* fi, const float* fj) {
  const float c = fminf(fmaxf(2.0f * k * (fi[0] * fj[0]), -1.0f), 1.0f);
  return kTwoOverPi * asinf(c);
}

// T, dT/dk, and the tangents' sums T_v1 dv1 + T_v2 dv2 in w_std and b_std.
struct Partials {
  float t, tk, tw, tb;
};

template <int ACT>
__device__ __forceinline__ Partials dual_act_partials(float k, const float* fi,
                                                      const float* fj);

// Analytic partials, finite at c = +-1 (the Gram's diagonal): T_k = (pi -
// theta) / (2 pi), T_v1 = sin(theta) v2 / (4 pi s), T_v2 likewise; the row
// factors f = (a, r, r dv/dw, r dv/db).
template <>
__device__ __forceinline__ Partials dual_act_partials<kRelu>(float k, const float* fi,
                                                             const float* fj) {
  const float s = fi[0] * fj[0];
  const float c = fminf(fmaxf(k * (fi[1] * fj[1]), -1.0f), 1.0f);
  const float theta = acosf(c);
  const float sin_t = sin_of(c);
  const float h = sin_t * kInv4Pi;
  Partials p;
  p.t = (s * sin_t + (kPi - theta) * k) * kInv2Pi;
  p.tk = (kPi - theta) * kInv2Pi;
  p.tw = h * (fj[0] * fi[2] + fi[0] * fj[2]);
  p.tb = h * (fj[0] * fi[3] + fi[0] * fj[3]);
  return p;
}

// The clip zeroes the gradient outside the strict interval |g| < 1, as XLA's
// autodiff through the reference tier does; row factors f = (e, e^2 dv/dw,
// e^2 dv/db). T' = (2/pi) / sqrt(1 - g^2) by rsqrtf (2 ulp; held to the
// plain version on the card).
template <>
__device__ __forceinline__ Partials dual_act_partials<kErf>(float k, const float* fi,
                                                            const float* fj) {
  const float r = fi[0] * fj[0];
  const float g = 2.0f * k * r;
  const float c = fminf(fmaxf(g, -1.0f), 1.0f);
  const bool inside = (g > -1.0f) && (g < 1.0f);
  const float base = inside ? kTwoOverPi * rsqrtf(fmaxf(1.0f - c * c, 1e-30f)) : 0.0f;
  const float bg = base * g;
  Partials p;
  p.t = kTwoOverPi * asinf(c);
  p.tk = base * (2.0f * r);
  p.tw = -bg * (fi[1] + fj[1]);
  p.tb = -bg * (fi[2] + fj[2]);
  return p;
}

// acc[i][j] = <x1[row0 + ty + 16 i], x2[col0 + tx + 16 j]> for the block's
// tile, in plain fp32 FMA in a fixed order over the features (d >= 1: the
// wrappers check).
__device__ __forceinline__ void tile_dot(const float* __restrict__ x1,
                                         const float* __restrict__ x2, int n1,
                                         int n2, int d, int row0, int col0,
                                         Stage& st, float acc[kPer][kPer]) {
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsEdge + tx;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    const int kc = min(kChunk, d - k0);
    __syncthreads();  // the previous chunk has been consumed
    for (int e = tid; e < kTile * kChunk; e += kThreads) {
      const int r = e / kChunk;
      const int c = e - r * kChunk;
      const bool in_k = c < kc;
      st.xs[0][r][c] = (in_k && row0 + r < n1) ? x1[(size_t)(row0 + r) * d + k0 + c] : 0.0f;
      st.xs[1][r][c] = (in_k && col0 + r < n2) ? x2[(size_t)(col0 + r) * d + k0 + c] : 0.0f;
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      float a[kPer];
      float b[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) a[i] = st.xs[0][ty + kThreadsEdge * i][kk];
#pragma unroll
      for (int j = 0; j < kPer; ++j) b[j] = st.xs[1][tx + kThreadsEdge * j][kk];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// The variance rows (and, with GRADS, their tangents) of one side of the
// tile: v [depth+1, n], dv [2, depth+1, n].
struct Side {
  const float* v;
  const float* dv;
  int n, base;  // rows, first row of the tile
};

// Stages the factors of layers [l0, l0 + lc) (variance rows lbase + l0 ...)
// of both sides into fs[side][factor][layer][row]. Off the edge: variance 1,
// tangents 0 (finite, and masked outputs are neither stored nor read).
// Starts with a barrier (the previous pass's factors are consumed) and ends
// with one (the factors are published).
template <int ACT, bool GRADS>
__device__ __forceinline__ void stage_factors(
    const Side& s1, const Side& s2, int depth, int lbase, int l0, int lc,
    float (*fs)[kFactors<ACT, GRADS>][kLayers][kTile]) {
  const int tid = threadIdx.y * kThreadsEdge + threadIdx.x;
  const int rows = depth + 1;
  __syncthreads();
  for (int e = tid; e < 2 * lc * kTile; e += kThreads) {
    const int side = e / (lc * kTile);
    const int l = (e - side * lc * kTile) / kTile;
    const int i = e % kTile;
    const Side S = side ? s2 : s1;
    const bool in = S.base + i < S.n;
    const size_t o = (size_t)(lbase + l0 + l) * S.n + S.base + i;
    const float v = in ? S.v[o] : 1.0f;
    float(*f)[kLayers][kTile] = fs[side];
    float scale;  // of the tangents
    if (ACT == kRelu) {
      const float a = sqrtf(fmaxf(v, kVarFloor));
      scale = 1.0f / a;
      f[0][l][i] = a;
      f[1][l][i] = scale;
    } else {
      const float e2 = 1.0f / (1.0f + 2.0f * v);
      f[0][l][i] = 1.0f / sqrtf(1.0f + 2.0f * v);
      scale = e2;
    }
    if (GRADS) {
      constexpr int t0 = ACT == kRelu ? 2 : 1;
      f[t0][l][i] = in ? scale * S.dv[o] : 0.0f;
      f[t0 + 1][l][i] = in ? scale * S.dv[(size_t)rows * S.n + o] : 0.0f;
    }
  }
  __syncthreads();
}

// Activation layers of the recursion and the variance row of the first:
// mlp depth (rows 1 .. depth), resnet depth + 1 (rows 0 .. depth, the last
// the final activation).
template <int MODE>
__device__ __forceinline__ int act_layers(int depth) {
  return MODE == kMlp ? depth : depth + 1;
}
template <int MODE>
__device__ __forceinline__ int act_base() {
  return MODE == kMlp ? 1 : 0;
}

template <int MODE, int ACT>
__global__ void __launch_bounds__(kThreads, kGramBlocks)
gram_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
            const float* __restrict__ v1, const float* __restrict__ v2,
            const float* __restrict__ scales, float* __restrict__ out,
            int n1, int n2, int d, int depth, int same) {
  constexpr int NF = kFactors<ACT, false>;
  __shared__ Stage st;
  __shared__ float fs[2][NF][kLayers][kTile];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsEdge + tx;
  const Tile T = tile_of(same);
  const Side s1{v1, nullptr, n1, T.row0};
  const Side s2{v2, nullptr, n2, T.col0};

  float k[kPer][kPer];
  tile_dot(x1, x2, n1, n2, d, T.row0, T.col0, st, k);

  const float w2 = scales[0];
  const float b2 = scales[1];
  const float last2 = scales[2];
  const float inv_d = scales[3];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      k[i][j] *= inv_d;
      if (MODE == kResnet) k[i][j] = w2 * k[i][j] + b2;    // initial Dense
    }

  const int nl = act_layers<MODE>(depth);
  for (int l0 = 0; l0 < nl; l0 += kLayers) {
    const int lc = min(kLayers, nl - l0);
    stage_factors<ACT, false>(s1, s2, depth, act_base<MODE>(), l0, lc, fs);
    for (int l = 0; l < lc; ++l) {
      const bool final = MODE == kResnet && l0 + l == depth;
      float fi[kPer][NF];
      float fj[kPer][NF];
#pragma unroll
      for (int q = 0; q < kPer; ++q)
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          fi[q][f] = fs[0][f][l][ty + kThreadsEdge * q];
          fj[q][f] = fs[1][f][l][tx + kThreadsEdge * q];
        }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const float u = MODE == kMlp ? w2 * k[i][j] + b2 : k[i][j];  // mlp: Dense
          const float t = dual_act<ACT>(u, fi[i], fj[j]);
          if (MODE == kMlp)
            k[i][j] = t;
          else  // a residual block, or the final activation
            k[i][j] = final ? last2 * t : k[i][j] + w2 * t + b2;
        }
    }
  }
  if (MODE == kMlp) {
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) k[i][j] *= last2;     // final Dense
  }

  if (!same) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + kThreadsEdge * i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = tx + kThreadsEdge * j;
        if (T.row0 + r < n1 && T.col0 + c < n2)
          out[(size_t)(T.row0 + r) * n2 + T.col0 + c] = k[i][j];
      }
    }
    return;
  }
  // Symmetric: the tile through the plane, then the tile and its transpose,
  // or the diagonal tile's lower triangle and its mirror, in coalesced rows.
  float(*P)[kTile + 1] = plane(st);
  __syncthreads();  // the dot product's stage is consumed
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) P[ty + kThreadsEdge * i][tx + kThreadsEdge * j] = k[i][j];
  __syncthreads();
  const int n = n1;
  for (int e = tid; e < kTile * kTile; e += kThreads) {
    const int a = e / kTile;
    const int b = e % kTile;
    if (T.diag) {
      if (T.row0 + a < n && T.row0 + b < n)
        out[(size_t)(T.row0 + a) * n + T.row0 + b] = b <= a ? P[a][b] : P[b][a];
    } else {
      if (T.row0 + a < n && T.col0 + b < n)
        out[(size_t)(T.row0 + a) * n + T.col0 + b] = P[a][b];
      if (T.col0 + a < n && T.row0 + b < n)
        out[(size_t)(T.col0 + a) * n + T.row0 + b] = P[b][a];
    }
  }
}

// K2. dv1 / dv2 are [2][depth+1][n]: the tangents of the variance rows with
// respect to w_std (index 0) and b_std (index 1). scales = [w^2, b^2, last^2,
// 1/D, w, b, last]. partial is [3][number of blocks] float64.
template <int MODE, int ACT>
__global__ void __launch_bounds__(kThreads, kGradsBlocks)
gram_grads_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                  const float* __restrict__ v1, const float* __restrict__ v2,
                  const float* __restrict__ dv1, const float* __restrict__ dv2,
                  const float* __restrict__ scales, const float* __restrict__ g,
                  double* __restrict__ partial, int n1, int n2, int d, int depth,
                  int same) {
  constexpr int NF = kFactors<ACT, true>;
  __shared__ Stage st;
  __shared__ float fs[2][NF][kLayers][kTile];
  __shared__ double red[3][kWarps];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsEdge + tx;
  const Tile T = tile_of(same);
  const Side s1{v1, dv1, n1, T.row0};
  const Side s2{v2, dv2, n2, T.col0};

  float k[kPer][kPer];
  tile_dot(x1, x2, n1, n2, d, T.row0, T.col0, st, k);

  const float w2 = scales[0];
  const float b2 = scales[1];
  const float last2 = scales[2];
  const float inv_d = scales[3];
  const float two_w = 2.0f * scales[4];
  const float two_b = 2.0f * scales[5];
  const float two_last = 2.0f * scales[6];

  float dkw[kPer][kPer];
  float dkb[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float k0 = k[i][j] * inv_d;
      if (MODE == kMlp) {
        k[i][j] = k0;
        dkw[i][j] = 0.0f;
        dkb[i][j] = 0.0f;
      } else {                                             // initial Dense
        k[i][j] = w2 * k0 + b2;
        dkw[i][j] = two_w * k0;
        dkb[i][j] = two_b;
      }
    }

  const int nl = act_layers<MODE>(depth);
  for (int l0 = 0; l0 < nl; l0 += kLayers) {
    const int lc = min(kLayers, nl - l0);
    stage_factors<ACT, true>(s1, s2, depth, act_base<MODE>(), l0, lc, fs);
    for (int l = 0; l < lc; ++l) {
      const bool final = MODE == kResnet && l0 + l == depth;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        float fi[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) fi[f] = fs[0][f][l][ty + kThreadsEdge * i];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          float fj[NF];
#pragma unroll
          for (int f = 0; f < NF; ++f) fj[f] = fs[1][f][l][tx + kThreadsEdge * j];
          if (MODE == kMlp) {
            const float u = w2 * k[i][j] + b2;               // Dense
            const float duw = w2 * dkw[i][j] + two_w * k[i][j];
            const float dub = w2 * dkb[i][j] + two_b;
            const Partials p = dual_act_partials<ACT>(u, fi, fj);
            dkw[i][j] = p.tk * duw + p.tw;
            dkb[i][j] = p.tk * dub + p.tb;
            k[i][j] = p.t;
          } else {
            const Partials p = dual_act_partials<ACT>(k[i][j], fi, fj);
            const float dtw = p.tk * dkw[i][j] + p.tw;
            const float dtb = p.tk * dkb[i][j] + p.tb;
            if (final) {                                     // final activation
              dkw[i][j] = last2 * dtw;
              dkb[i][j] = last2 * dtb;
              k[i][j] = p.t;
            } else {                                         // residual block
              k[i][j] = k[i][j] + w2 * p.t + b2;
              dkw[i][j] = dkw[i][j] + w2 * dtw + two_w * p.t;
              dkb[i][j] = dkb[i][j] + w2 * dtb + two_b;
            }
          }
        }
      }
    }
  }

  // Readout. A symmetric launch weights pair (i, j), j < i, by g[i, j] +
  // g[j, i], g[j, i] read through the plane.
  float(*P)[kTile + 1] = plane(st);
  if (same) {
    const int n = n1;
    __syncthreads();  // the dot product's stage is consumed
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int a = e / kTile;
      const int b = e % kTile;
      P[a][b] = (T.col0 + a < n && T.row0 + b < n) ? g[(size_t)(T.col0 + a) * n + T.row0 + b]
                                                   : 0.0f;
    }
    __syncthreads();
  }
  double sw = 0.0, sb = 0.0, sl = 0.0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = ty + kThreadsEdge * i;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = tx + kThreadsEdge * j;
      const bool upper = T.diag && c > r;  // mirrored by (c, r)
      if (T.row0 + r < n1 && T.col0 + c < n2 && !upper) {
        double gv = (double)g[(size_t)(T.row0 + r) * n2 + T.col0 + c];
        if (same && !(T.diag && c == r)) gv += (double)P[c][r];
        // mlp: the final Dense (resnet: applied with the final activation).
        const float dw = MODE == kMlp ? last2 * dkw[i][j] : dkw[i][j];
        const float db = MODE == kMlp ? last2 * dkb[i][j] : dkb[i][j];
        sw = fma(gv, (double)dw, sw);
        sb = fma(gv, (double)db, sb);
        sl = fma(gv, (double)(two_last * k[i][j]), sl);
      }
    }
  }

  // Fixed-order block reduction: within each warp by shuffles, then warp 0
  // adds the 8 warp sums in order.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sw += __shfl_down_sync(0xffffffffu, sw, off);
    sb += __shfl_down_sync(0xffffffffu, sb, off);
    sl += __shfl_down_sync(0xffffffffu, sl, off);
  }
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (lane == 0) {
    red[0][warp] = sw;
    red[1][warp] = sb;
    red[2][warp] = sl;
  }
  __syncthreads();
  if (tid < 3) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += red[tid][w];
    const int nb = gridDim.x * gridDim.y;
    partial[(size_t)tid * nb + blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

// The blocks of a launch: the T (T + 1) / 2 lower-triangle tiles of a
// symmetric one (n1 == n2), else all tiles; -1 past the grid's limits
// (2^31 - 1 blocks; a cross launch's 65,535 row tiles) or for `same` with
// n1 != n2.
long long launch_blocks(int n1, int n2, int same) {
  const long long t1 = (n1 + kTile - 1) / kTile;
  const long long t2 = (n2 + kTile - 1) / kTile;
  if (n1 < 1 || n2 < 1 || (same && n1 != n2)) return -1;
  if (same) {
    const long long blocks = t1 * (t1 + 1) / 2;
    return blocks > 0x7fffffffLL ? -1 : blocks;
  }
  return t1 > 65535 ? -1 : t1 * t2;
}

dim3 launch_grid(int n1, int n2, int same) {
  if (same) return dim3((unsigned)launch_blocks(n1, n2, same));
  return dim3((n2 + kTile - 1) / kTile, (n1 + kTile - 1) / kTile);
}

template <int MODE, int ACT>
cudaError_t launch(const float* x1, const float* x2, const float* v1,
                   const float* v2, const float* scales, float* out, int n1,
                   int n2, int d, int depth, int same, cudaStream_t stream) {
  gram_kernel<MODE, ACT><<<launch_grid(n1, n2, same), dim3(kThreadsEdge, kThreadsEdge), 0,
                           stream>>>(x1, x2, v1, v2, scales, out, n1, n2, d, depth, same);
  return cudaGetLastError();
}

template <int MODE, int ACT>
cudaError_t launch_grads(const float* x1, const float* x2, const float* v1,
                         const float* v2, const float* dv1, const float* dv2,
                         const float* scales, const float* g, double* partial,
                         int n1, int n2, int d, int depth, int same,
                         cudaStream_t stream) {
  gram_grads_kernel<MODE, ACT><<<launch_grid(n1, n2, same),
                                 dim3(kThreadsEdge, kThreadsEdge), 0, stream>>>(
      x1, x2, v1, v2, dv1, dv2, scales, g, partial, n1, n2, d, depth, same);
  return cudaGetLastError();
}

bool bad_launch(int n1, int n2, int d, int depth, int same) {
  return launch_blocks(n1, n2, same) < 0 || d < 1 || depth < 0;
}

}  // namespace

// x1 [n1, d], x2 [n2, d], v1 [depth+1, n1], v2 [depth+1, n2], scales
// [w^2, b^2, last^2, 1/D], out [n1, n2]: all fp32, contiguous, on the device
// of `stream`. mode: 0 mlp, 1 resnet; act: 0 relu, 1 erf; same = 1: x2 and
// v2 are x1 and v1 (n1 == n2), and the launch runs the lower-triangle tiles
// and mirrors them. Returns the CUDA error code of the launch (0 on
// success); does not synchronize.
extern "C" int snngp_gram_f32(const float* x1, const float* x2, const float* v1,
                              const float* v2, const float* scales, float* out,
                              int n1, int n2, int d, int depth, int mode,
                              int act, int same, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (bad_launch(n1, n2, d, depth, same)) return static_cast<int>(err);
  if (mode == kMlp && act == kRelu)
    err = launch<kMlp, kRelu>(x1, x2, v1, v2, scales, out, n1, n2, d, depth, same, s);
  else if (mode == kMlp && act == kErf)
    err = launch<kMlp, kErf>(x1, x2, v1, v2, scales, out, n1, n2, d, depth, same, s);
  else if (mode == kResnet && act == kRelu)
    err = launch<kResnet, kRelu>(x1, x2, v1, v2, scales, out, n1, n2, d, depth, same, s);
  else if (mode == kResnet && act == kErf)
    err = launch<kResnet, kErf>(x1, x2, v1, v2, scales, out, n1, n2, d, depth, same, s);
  return static_cast<int>(err);
}

// As snngp_gram_f32, plus dv1 [2, depth+1, n1], dv2 [2, depth+1, n2] (the
// variance rows' tangents in w_std, b_std), the cotangent g [n1, n2] fp32
// (with same = 1 any g: each pair j < i is weighted by g[i, j] + g[j, i]),
// scales [w^2, b^2, last^2, 1/D, w, b, last], and partial [3, nblocks]
// float64, nblocks from snngp_gram_blocks: block b writes its (sum g dK/dw,
// sum g dK/db, sum g dK/dlast) at column b (a cross launch's tile (ti, tj)
// is block ti * ceil(n2 / 64) + tj). Returns the CUDA error code of the
// launch; does not synchronize.
extern "C" int snngp_gram_grads_f32(const float* x1, const float* x2,
                                    const float* v1, const float* v2,
                                    const float* dv1, const float* dv2,
                                    const float* scales, const float* g,
                                    double* partial, int n1, int n2, int d,
                                    int depth, int mode, int act, int same,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (bad_launch(n1, n2, d, depth, same)) return static_cast<int>(err);
  if (mode == kMlp && act == kRelu)
    err = launch_grads<kMlp, kRelu>(x1, x2, v1, v2, dv1, dv2, scales, g, partial,
                                    n1, n2, d, depth, same, s);
  else if (mode == kMlp && act == kErf)
    err = launch_grads<kMlp, kErf>(x1, x2, v1, v2, dv1, dv2, scales, g, partial,
                                   n1, n2, d, depth, same, s);
  else if (mode == kResnet && act == kRelu)
    err = launch_grads<kResnet, kRelu>(x1, x2, v1, v2, dv1, dv2, scales, g,
                                       partial, n1, n2, d, depth, same, s);
  else if (mode == kResnet && act == kErf)
    err = launch_grads<kResnet, kErf>(x1, x2, v1, v2, dv1, dv2, scales, g,
                                      partial, n1, n2, d, depth, same, s);
  return static_cast<int>(err);
}

// The blocks of a K1 or K2 launch on these shapes (the columns of K2's
// partial sums); -1 where no launch takes them.
extern "C" long long snngp_gram_blocks(int n1, int n2, int same) {
  return launch_blocks(n1, n2, same);
}

// cudaGetErrorString for the wrapper's exception message.
extern "C" const char* snngp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
