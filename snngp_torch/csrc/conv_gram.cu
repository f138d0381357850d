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
// sum g dK/dlast) of its pairs, reduced in a fixed order (see K4's design),
// with no atomics, so the sums repeat bitwise. The wrapper adds the blocks'
// triples in float64.
//
// What bounds them on an H100: at the CIFAR shape (32 x 32 x 3, depth 4)
// each pair runs 1,024 pixels x depth x (a 3 x 3 stencil of 4 adds and an
// IEEE divide, one acosf or asinf, two sqrtf, one divide, ~12 FMA) and
// writes one float: the FP32 and SFU pipes, that is the instructions a warp
// issues, bound them, not memory (the inputs are a few MB and stay in L2).
// K4 does about 2.2 times K3's operations a pixel and layer (relu). The
// TPU kernel read a precomputed k0 [N1, N2, HW] from HBM; here the input
// moment (C <= 3 FMAs a pixel) is fused, which saves an N1 N2 HW x 4-byte
// pass (287 MB over the three Gram blocks of one SVSP step at the CIFAR
// shape).
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
// K4's design: K3's streamed layout carrying three states. Each layer keeps
// three windows of column sums in registers, for k, dk/dw and dk/db, takes
// three column-sum shuffles and one set of the activation's partials, and
// reads six variance rows a pixel (v, dv/dw, dv/db of each image) through
// the read-only cache; a deeper network than kGradStages layers streams the
// three states through three per-warp shared planes between passes, each
// lane touching only its own column (no barrier). Each lane sums its
// column of the last layer's k, dk/dw and dk/db in row order, a segment's
// shuffle tree gives the pair's three sums, and the segment's first lane
// forms in float64 g * (double)(scale * s), scale = last2 / HW for dw and
// db and 2 last / HW for dlast. The warp's first lane adds its segments'
// triples in lane order, the block's first threads its warps' in warp
// order, and the block writes one triple: no atomics, and the sums repeat
// bitwise. With `same` (K(x, x)) a launch runs each pair j <= i once, its
// cotangent weight g[i, j] + g[j, i] (once on the diagonal), since g need
// not be symmetric.

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
// K4: its layers a pass (SVSP's depth 4 in one), and its blocks an SM. A
// layer holds three windows where K3's holds one, so ptxas spills at 64
// registers (136 bytes stored) and at 80 (52), not at 128. On an H100
// (700 W) at 200 x 200 pairs of 32 x 32 x 3, depth 4, relu, symmetric: 4
// blocks 0.924-0.931 ms, 3 blocks 0.927-0.949 ms, 2 blocks 1.088-1.098 ms.
constexpr int kGradStages = 4;
constexpr int kGradBlocksPerSM = 4;
// Deeper than a pass's layers: the per-warp planes may take this many
// bytes of shared memory a block (at least one warp's planes), and no
// block may take more than Hopper's opt-in limit.
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

// K4, streamed (see the header). As K3, plus dv1 [2, depth + 1, n1, hw] and
// dv2 [2, depth + 1, n2, hw] (the variance maps' tangents in w and b), the
// cotangent g [n1, n2] and scales = [w^2, b^2, last^2, 1/C, w, b, last];
// partial is [3][gridDim.x] float64. Dynamic shared memory: with depth >
// kGradStages, three [rows][32] planes a warp (k, dk/dw, dk/db).
template <int ACT>
__global__ void __launch_bounds__(kThreads, kGradBlocksPerSM)
conv_gram_grads_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                       const float* __restrict__ v1, const float* __restrict__ v2,
                       const float* __restrict__ dv1, const float* __restrict__ dv2,
                       const float* __restrict__ scales, const float* __restrict__ g,
                       double* __restrict__ partial, int n1, int n2, Geo G, int c,
                       int depth, int same) {
  extern __shared__ float planes[];
  __shared__ double red[3][kWarps];
  const StreamLane L(G, n1, n2, same);
  const int seg = 1 << G.lg;
  const int rows = G.rows;
  const int rs = G.rstride;
  const float w2 = scales[0];
  const float b2 = scales[1];
  const float inv_c = scales[3];
  const float two_w = 2.0f * scales[4];
  const float two_b = 2.0f * scales[5];
  const int pix = L.c * G.cstride;
  const float* xa = x1 + ((size_t)L.i * G.hw + pix) * c;
  const float* xb = x2 + ((size_t)L.j * G.hw + pix) * c;
  const int rsc = rs * c;
  const int o1 = L.i * G.hw + pix;   // in one variance layer
  const int o2 = L.j * G.hw + pix;
  const int s1 = n1 * G.hw;          // between variance layers
  const int s2 = n2 * G.hw;
  const int d1 = (depth + 1) * s1;   // from a tangent in w to the one in b
  const int d2 = (depth + 1) * s2;
  float* kpl = planes + (threadIdx.x >> 5) * 3 * 32 * rows + (threadIdx.x & 31);
  float* wpl = kpl + 32 * rows;
  float* bpl = wpl + 32 * rows;

  float acc = 0.0f, acc_w = 0.0f, acc_b = 0.0f;
  for (int l0 = 0;; l0 += kGradStages) {
    const int gn = min(kGradStages, depth - l0);   // this pass's layers, l0 + 1 .. l0 + gn
    const bool first = l0 == 0;
    const bool last = l0 + gn == depth;
    float cp[kGradStages], cc[kGradStages], cpw[kGradStages], ccw[kGradStages],
        cpb[kGradStages], ccb[kGradStages];
#pragma unroll
    for (int l = 0; l < kGradStages; ++l) cp[l] = cc[l] = cpw[l] = ccw[l] = cpb[l] = ccb[l] = 0.0f;
    for (int t = 0; t < rows + gn; ++t) {
      float z = 0.0f, zw = 0.0f, zb = 0.0f;   // row t entering the pass
      if (L.active && t < rows) {
        if (first) {
          const float* a = xa + t * rsc;
          const float* b = xb + t * rsc;
          float m = 0.0f;
          for (int ch = 0; ch < c; ++ch) m = fmaf(__ldg(a + ch), __ldg(b + ch), m);
          z = m * inv_c;
        } else {
          z = kpl[t * 32];
          zw = wpl[t * 32];
          zb = bpl[t * 32];
        }
      }
#pragma unroll
      for (int l = 0; l < kGradStages; ++l) {
        if (l < gn) {
          const float cn = lane_col_sum(z, L, seg);   // row t - l's column sums
          const float cnw = lane_col_sum(zw, L, seg);
          const float cnb = lane_col_sum(zb, L, seg);
          const int u = t - l - 1;                     // the row layer l emits
          z = zw = zb = 0.0f;
          if (u >= 0 && u < rows) {
            const float sk = ((cc[l] + cp[l]) + cn) / 9.0f;
            const float uk = w2 * sk + b2;                               // Conv 3x3 SAME
            const float duw = w2 * (((ccw[l] + cpw[l]) + cnw) / 9.0f) + two_w * sk;
            const float dub = w2 * (((ccb[l] + cpb[l]) + cnb) / 9.0f) + two_b;
            float va = 1.0f, vb = 1.0f, wa = 0.0f, wb = 0.0f, ba = 0.0f, bb = 0.0f;
            if (L.active) {   // off the edge: variance 1, tangents 0
              const int e1 = (l0 + l + 1) * s1 + o1 + u * rs;
              const int e2 = (l0 + l + 1) * s2 + o2 + u * rs;
              va = __ldg(v1 + e1);
              vb = __ldg(v2 + e2);
              wa = __ldg(dv1 + e1);
              wb = __ldg(dv2 + e2);
              ba = __ldg(dv1 + d1 + e1);
              bb = __ldg(dv2 + d2 + e2);
            }
            const Partials pa = dual_act_partials<ACT>(uk, va, vb);
            zw = pa.tk * duw + pa.tv1 * wa + pa.tv2 * wb;
            zb = pa.tk * dub + pa.tv1 * ba + pa.tv2 * bb;
            z = pa.t;
          }
          cp[l] = cc[l];
          cc[l] = cn;
          cpw[l] = ccw[l];
          ccw[l] = cnw;
          cpb[l] = ccb[l];
          ccb[l] = cnb;
        }
      }
      const int u = t - gn;      // the row leaving the pass
      if (L.active && u >= 0) {
        if (last) {
          acc += z;
          acc_w += zw;
          acc_b += zb;
        } else {
          kpl[u * 32] = z;
          wpl[u * 32] = zw;
          bpl[u * 32] = zb;
        }
      }
    }
    if (last) break;
  }

  // Flatten + final Dense, contracted against g: the segment's column sums
  // in a fixed order, then its first lane's float64 triple.
  for (int off = seg >> 1; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off, seg);
    acc_w += __shfl_down_sync(0xffffffffu, acc_w, off, seg);
    acc_b += __shfl_down_sync(0xffffffffu, acc_b, off, seg);
  }
  double tw = 0.0, tb = 0.0, tl = 0.0;
  if (L.c == 0 && L.pair_ok) {
    double gv = (double)g[(size_t)L.i * n2 + L.j];
    if (same && L.i != L.j) gv += (double)g[(size_t)L.j * n2 + L.i];
    const float scale = scales[2] / (float)G.hw;
    const float scale_l = 2.0f * scales[6] / (float)G.hw;
    tw = gv * (double)(scale * acc_w);
    tb = gv * (double)(scale * acc_b);
    tl = gv * (double)(scale_l * acc);
  }
  // The warp's segments in lane order, into lane 0; then the block's warps
  // in order.
  double sw = tw, sb = tb, sl = tl;
  for (int s = seg; s < 32; s += seg) {
    const double a = __shfl_sync(0xffffffffu, tw, s);
    const double b = __shfl_sync(0xffffffffu, tb, s);
    const double d = __shfl_sync(0xffffffffu, tl, s);
    sw += a;
    sb += b;
    sl += d;
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = sw;
    red[1][warp] = sb;
    red[2][warp] = sl;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    double sum = 0.0;
    for (int wi = 0; wi < (int)(blockDim.x >> 5); ++wi) sum += red[threadIdx.x][wi];
    partial[(size_t)threadIdx.x * gridDim.x + blockIdx.x] = sum;
  }
}

// Dynamic shared memory above 48 KB needs the kernel's opt-in first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// A streamed launch's size: kWarps warps a block; deeper than `stages`
// layers, as many warps as kPlaneBudget bytes of `planes` [rows][32]-float
// planes a warp hold (at least one). blocks < 0: the launch does not fit.
struct Launch {
  int warps, smem;
  long long blocks;
};

Launch size_launch(const Geo& G, int n1, int n2, int depth, int same, int stages,
                   int planes) {
  const int plane = depth > stages ? planes * G.rows * 32 * (int)sizeof(float) : 0;
  const int warps = plane > 0 ? max(1, min(kWarps, kPlaneBudget / plane)) : kWarps;
  Launch s{warps, warps * plane, stream_blocks(G, n1, n2, same, warps)};
  if (s.smem > kSmemLimit) s.blocks = -1;
  return s;
}

// K3's launch: one [rows][32] plane a warp past kStages layers.
template <int ACT>
cudaError_t launch(const float* x1, const float* x2, const float* v1, const float* v2,
                   const float* scales, float* out, int n1, int n2, const Geo& G, int c,
                   int depth, int same, cudaStream_t stream) {
  const Launch s = size_launch(G, n1, n2, depth, same, kStages, 1);
  if (s.blocks < 0) return cudaErrorInvalidConfiguration;
  const cudaError_t err = allow_smem(conv_gram_kernel<ACT>, s.smem);
  if (err != cudaSuccess) return err;
  conv_gram_kernel<ACT><<<(unsigned)s.blocks, 32 * s.warps, s.smem, stream>>>(
      x1, x2, v1, v2, scales, out, n1, n2, G, c, depth, same);
  return cudaGetLastError();
}

// K4's launch: three planes a warp past kGradStages layers.
Launch size_grads(const Geo& G, int n1, int n2, int depth, int same) {
  return size_launch(G, n1, n2, depth, same, kGradStages, 3);
}

template <int ACT>
cudaError_t launch_grads(const float* x1, const float* x2, const float* v1,
                         const float* v2, const float* dv1, const float* dv2,
                         const float* scales, const float* g, double* partial, int n1,
                         int n2, const Geo& G, int c, int depth, int same,
                         cudaStream_t stream) {
  const Launch s = size_grads(G, n1, n2, depth, same);
  if (s.blocks < 0) return cudaErrorInvalidConfiguration;
  const cudaError_t err = allow_smem(conv_gram_grads_kernel<ACT>, s.smem);
  if (err != cudaSuccess) return err;
  conv_gram_grads_kernel<ACT><<<(unsigned)s.blocks, 32 * s.warps, s.smem, stream>>>(
      x1, x2, v1, v2, dv1, dv2, scales, g, partial, n1, n2, G, c, depth, same);
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
  if (bad_geometry(G, n1, n2, same) || depth < 0 || c < 1)
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
// fp32 (with same = 1 any g: each pair j <= i is weighted by g[i, j] +
// g[j, i]), scales [w^2, b^2, last^2, 1/c, w, b, last], and partial [3,
// nblocks] float64, nblocks from snngp_conv_gram_grads_blocks on the same
// arguments: block b writes its (sum g dK/dw, sum g dK/db, sum g dK/dlast) at
// column b. The caller checks that every tangent index fits an int. Returns
// the CUDA error code of the launch; does not synchronize.
extern "C" int snngp_conv_gram_grads_f32(const float* x1, const float* x2,
                                         const float* v1, const float* v2,
                                         const float* dv1, const float* dv2,
                                         const float* scales, const float* g,
                                         double* partial, int n1, int n2, int lanes,
                                         int rows, int lg, int rstride, int cstride, int c,
                                         int depth, int act, int same, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo G{lanes, rows, lg, rstride, cstride, lanes * rows};
  if (bad_geometry(G, n1, n2, same) || depth < 0 || c < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (act == kRelu)
    err = launch_grads<kRelu>(x1, x2, v1, v2, dv1, dv2, scales, g, partial, n1, n2, G, c,
                              depth, same, s);
  else if (act == kErf)
    err = launch_grads<kErf>(x1, x2, v1, v2, dv1, dv2, scales, g, partial, n1, n2, G, c,
                             depth, same, s);
  return static_cast<int>(err);
}

// The blocks of a snngp_conv_gram_grads_f32 launch on these arguments: the
// columns of its `partial`. -1 if the launch does not fit.
extern "C" long long snngp_conv_gram_grads_blocks(int n1, int n2, int lanes, int rows,
                                                  int lg, int depth, int same) {
  const Geo G{lanes, rows, lg, 0, 0, lanes * rows};
  if (bad_geometry(G, n1, n2, same) || depth < 0) return -1;
  return size_grads(G, n1, n2, depth, same).blocks;
}

// cudaGetErrorString for the wrapper's exception message.
extern "C" const char* snngp_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
