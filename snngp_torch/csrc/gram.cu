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
// dk/dw_std and dk/db_std carried beside k (the activation partials T_k,
// T_v1, T_v2 shared by both), fed the variance rows and their two tangent
// rows. The TPU kernel writes the four Grams (K, dK/dw, dK/db, dK/dlast) and
// its only caller reduces each tangent against the cotangent g; this kernel
// reads g and fuses that contraction: each block writes one triple
// (sum g dK/dw, sum g dK/db, sum g dK/dlast) of its 64 x 64 tile, reduced in
// float64 in a fixed order (warp shuffles, then the block's 8 warps), with no
// atomics, so the sums repeat bitwise from run to run. The wrapper adds the
// blocks' triples in float64.
//
// What bounds them on an H100: at D = 16, N = 10,000, depth 4, K1 does ~1e8
// outputs x depth x (one acosf or asinf, two sqrtf, one IEEE divide, ~15 FMA)
// against a 400 MB store; K2 does about twice that arithmetic per output
// (the partials add a divide and ~20 FMA, and three float64 FMAs for the
// contraction) against a 400 MB read of g. Both are bound by the FP32 and SFU
// pipes, not by memory. The input product is a small share (2 D FMA per
// output).
//
// Design (simple first): one 64 x 64 output tile per 256-thread block, 4 x 4
// outputs per thread. The block stages its x1 and x2 rows in shared memory in
// chunks of 32 features and accumulates the dot product in plain fp32 FMA in
// a fixed order over D, so K(x, x) comes out bitwise symmetric (fma(a, b, c)
// == fma(b, a, c)). It also stages its variance rows (and, for K2, their
// tangent rows) in dynamic shared memory. The recursion runs in registers
// with IEEE acosf/asinf/sqrtf and divides (no fast math: the parity bar is
// fp32); K1 stores each output once, K2 stores nothing per output. Ragged
// edges are masked: no padding of rows or features. The scales come from a
// device tensor, so a launch needs no host sync.
// Not yet used: wgmma for the input product, TMA, the symmetry of K(x, x).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;                 // output tile edge
constexpr int kThreadsEdge = 16;          // 16 x 16 threads
constexpr int kPer = kTile / kThreadsEdge;  // outputs per thread per axis
constexpr int kThreads = kThreadsEdge * kThreadsEdge;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;                // features staged per pass
constexpr float kPi = 3.14159265358979323846f;
constexpr float kInv2Pi = 0.15915494309189533577f;
constexpr float kInv4Pi = 0.07957747154594766788f;
constexpr float kTwoOverPi = 0.63661977236758134308f;

enum Mode { kMlp = 0, kResnet = 1 };
enum Act { kRelu = 0, kErf = 1 };

template <int ACT>
__device__ __forceinline__ float dual_act(float k, float v1, float v2);

// E[relu(u) relu(v)] for (u, v) ~ N(0, [[v1, k], [k, v2]]).
template <>
__device__ __forceinline__ float dual_act<kRelu>(float k, float v1, float v2) {
  const float s = sqrtf(fmaxf(v1 * v2, 1e-30f));
  const float c = fminf(fmaxf(k / s, -1.0f), 1.0f);
  const float theta = acosf(c);
  const float sin_t = sqrtf(fmaxf(1.0f - c * c, 0.0f));
  return (s * sin_t + (kPi - theta) * k) * kInv2Pi;
}

// E[erf(u) erf(v)] = (2/pi) asin(2k / sqrt((1 + 2 v1)(1 + 2 v2))).
template <>
__device__ __forceinline__ float dual_act<kErf>(float k, float v1, float v2) {
  const float denom = sqrtf((1.0f + 2.0f * v1) * (1.0f + 2.0f * v2));
  const float c = fminf(fmaxf(2.0f * k / denom, -1.0f), 1.0f);
  return kTwoOverPi * asinf(c);
}

// T and its partials (T_k, T_v1, T_v2); written out line for line by
// _relu_t_partials / _erf_t_partials in ops/gram.py.
struct Partials {
  float t, tk, tv1, tv2;
};

template <int ACT>
__device__ __forceinline__ Partials dual_act_partials(float k, float v1, float v2);

// Analytic partials, finite at c = +-1 (the Gram's diagonal):
// T_k = (pi - theta) / (2 pi), T_v1 = sin(theta) v2 / (4 pi s), T_v2 likewise.
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

// The clip zeroes the gradient outside the strict interval |g| < 1, as XLA's
// autodiff through the reference tier does. 1/d1 = r^2 d2 and 1/d2 = r^2 d1
// take the place of two more IEEE divides (each has a called slow path,
// whose register save/restore spilled the resnet instance).
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

// acc[i][j] = <x1[row0 + ty + 16 i], x2[col0 + tx + 16 j]> for the block's
// tile, in plain fp32 FMA in a fixed order over the features. Starts with a
// barrier, so rows the caller staged in shared memory before it are
// published once it returns (d >= 1: the wrappers check).
__device__ __forceinline__ void tile_dot(const float* __restrict__ x1,
                                         const float* __restrict__ x2, int n1,
                                         int n2, int d, int row0, int col0,
                                         float (*xs1)[kChunk + 1],
                                         float (*xs2)[kChunk + 1],
                                         float acc[kPer][kPer]) {
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
      xs1[r][c] = (in_k && row0 + r < n1) ? x1[(size_t)(row0 + r) * d + k0 + c] : 0.0f;
      xs2[r][c] = (in_k && col0 + r < n2) ? x2[(size_t)(col0 + r) * d + k0 + c] : 0.0f;
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      float a[kPer];
      float b[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) a[i] = xs1[ty + kThreadsEdge * i][kk];
#pragma unroll
      for (int j = 0; j < kPer; ++j) b[j] = xs2[tx + kThreadsEdge * j][kk];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

template <int MODE, int ACT>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
            const float* __restrict__ v1, const float* __restrict__ v2,
            const float* __restrict__ scales, float* __restrict__ out,
            int n1, int n2, int d, int depth) {
  __shared__ float xs1[kTile][kChunk + 1];  // +1: conflict-free column reads
  __shared__ float xs2[kTile][kChunk + 1];
  extern __shared__ float vs[];             // [depth+1][kTile] of v1, then v2
  const int rows = depth + 1;
  float* vs1 = vs;
  float* vs2 = vs + rows * kTile;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsEdge + tx;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  // Variance rows of this tile; 1.0 off the edge keeps masked lanes finite.
  for (int e = tid; e < rows * kTile; e += kThreads) {
    const int l = e / kTile;
    const int i = e - l * kTile;
    vs1[e] = (row0 + i < n1) ? v1[(size_t)l * n1 + row0 + i] : 1.0f;
    vs2[e] = (col0 + i < n2) ? v2[(size_t)l * n2 + col0 + i] : 1.0f;
  }

  float acc[kPer][kPer];
  tile_dot(x1, x2, n1, n2, d, row0, col0, xs1, xs2, acc);

  const float w2 = scales[0];
  const float b2 = scales[1];
  const float last2 = scales[2];
  const float inv_d = scales[3];

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = ty + kThreadsEdge * i;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = tx + kThreadsEdge * j;
      float k = acc[i][j] * inv_d;
      if (MODE == kMlp) {
        for (int l = 1; l <= depth; ++l) {
          k = w2 * k + b2;                                   // Dense
          k = dual_act<ACT>(k, vs1[l * kTile + r], vs2[l * kTile + c]);
        }
        k = last2 * k;                                       // final Dense
      } else {
        k = w2 * k + b2;                                     // initial Dense
        for (int l = 0; l < depth; ++l) {                    // residual blocks
          k = k + w2 * dual_act<ACT>(k, vs1[l * kTile + r], vs2[l * kTile + c]) + b2;
        }
        k = last2 * dual_act<ACT>(k, vs1[depth * kTile + r], vs2[depth * kTile + c]);
      }
      if (row0 + r < n1 && col0 + c < n2) out[(size_t)(row0 + r) * n2 + col0 + c] = k;
    }
  }
}

// K2. dv1 / dv2 are [2][depth+1][n]: the tangents of the variance rows with
// respect to w_std (index 0) and b_std (index 1). scales = [w^2, b^2, last^2,
// 1/D, w, b, last]. partial is [3][gridDim.x * gridDim.y] float64.
template <int MODE, int ACT>
__global__ void __launch_bounds__(kThreads)
gram_grads_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                  const float* __restrict__ v1, const float* __restrict__ v2,
                  const float* __restrict__ dv1, const float* __restrict__ dv2,
                  const float* __restrict__ scales, const float* __restrict__ g,
                  double* __restrict__ partial, int n1, int n2, int d, int depth) {
  __shared__ float xs1[kTile][kChunk + 1];
  __shared__ float xs2[kTile][kChunk + 1];
  __shared__ double red[3][kWarps];
  // Six [depth+1][kTile] planes: v1, v2, dv1/dw, dv1/db, dv2/dw, dv2/db.
  extern __shared__ float vs[];
  const int rows = depth + 1;
  const int plane = rows * kTile;
  float* vs1 = vs;
  float* vs2 = vs + plane;
  float* dw1 = vs + 2 * plane;
  float* db1 = vs + 3 * plane;
  float* dw2 = vs + 4 * plane;
  float* db2 = vs + 5 * plane;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsEdge + tx;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  // Off the edge: variance 1, tangents 0 (finite, and g is not read there).
  for (int e = tid; e < plane; e += kThreads) {
    const int l = e / kTile;
    const int i = e - l * kTile;
    const bool in1 = row0 + i < n1;
    const bool in2 = col0 + i < n2;
    const size_t o1 = (size_t)l * n1 + row0 + i;
    const size_t o2 = (size_t)l * n2 + col0 + i;
    vs1[e] = in1 ? v1[o1] : 1.0f;
    vs2[e] = in2 ? v2[o2] : 1.0f;
    dw1[e] = in1 ? dv1[o1] : 0.0f;
    db1[e] = in1 ? dv1[(size_t)rows * n1 + o1] : 0.0f;
    dw2[e] = in2 ? dv2[o2] : 0.0f;
    db2[e] = in2 ? dv2[(size_t)rows * n2 + o2] : 0.0f;
  }

  float acc[kPer][kPer];
  tile_dot(x1, x2, n1, n2, d, row0, col0, xs1, xs2, acc);

  const float w2 = scales[0];
  const float b2 = scales[1];
  const float last2 = scales[2];
  const float inv_d = scales[3];
  const float two_w = 2.0f * scales[4];
  const float two_b = 2.0f * scales[5];
  const float two_last = 2.0f * scales[6];

  double sw = 0.0, sb = 0.0, sl = 0.0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = ty + kThreadsEdge * i;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = tx + kThreadsEdge * j;
      float k = acc[i][j] * inv_d;
      float dkw, dkb, dl;
      if (MODE == kMlp) {
        dkw = 0.0f;
        dkb = 0.0f;
        for (int l = 1; l <= depth; ++l) {
          const float u = w2 * k + b2;                       // Dense
          const float duw = w2 * dkw + two_w * k;
          const float dub = w2 * dkb + two_b;
          const Partials p = dual_act_partials<ACT>(u, vs1[l * kTile + r],
                                                    vs2[l * kTile + c]);
          dkw = p.tk * duw + p.tv1 * dw1[l * kTile + r] + p.tv2 * dw2[l * kTile + c];
          dkb = p.tk * dub + p.tv1 * db1[l * kTile + r] + p.tv2 * db2[l * kTile + c];
          k = p.t;
        }
        dkw = last2 * dkw;
        dkb = last2 * dkb;
        dl = two_last * k;
      } else {
        const float k0 = k;
        k = w2 * k0 + b2;                                    // initial Dense
        dkw = two_w * k0;
        dkb = two_b;
        for (int l = 0; l < depth; ++l) {                    // residual blocks
          const Partials p = dual_act_partials<ACT>(k, vs1[l * kTile + r],
                                                    vs2[l * kTile + c]);
          const float dtw = p.tk * dkw + p.tv1 * dw1[l * kTile + r] + p.tv2 * dw2[l * kTile + c];
          const float dtb = p.tk * dkb + p.tv1 * db1[l * kTile + r] + p.tv2 * db2[l * kTile + c];
          k = k + w2 * p.t + b2;
          dkw = dkw + w2 * dtw + two_w * p.t;
          dkb = dkb + w2 * dtb + two_b;
        }
        const int l = depth;
        const Partials p = dual_act_partials<ACT>(k, vs1[l * kTile + r],
                                                  vs2[l * kTile + c]);
        dkw = last2 * (p.tk * dkw + p.tv1 * dw1[l * kTile + r] + p.tv2 * dw2[l * kTile + c]);
        dkb = last2 * (p.tk * dkb + p.tv1 * db1[l * kTile + r] + p.tv2 * db2[l * kTile + c]);
        dl = two_last * p.t;
      }
      if (row0 + r < n1 && col0 + c < n2) {
        const double gv = (double)g[(size_t)(row0 + r) * n2 + col0 + c];
        sw = fma(gv, (double)dkw, sw);
        sb = fma(gv, (double)dkb, sb);
        sl = fma(gv, (double)dl, sl);
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

// Dynamic shared memory above 48 KB needs the kernel's opt-in first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int MODE, int ACT>
cudaError_t launch(const float* x1, const float* x2, const float* v1,
                   const float* v2, const float* scales, float* out, int n1,
                   int n2, int d, int depth, cudaStream_t stream) {
  const dim3 block(kThreadsEdge, kThreadsEdge);
  const dim3 grid((n2 + kTile - 1) / kTile, (n1 + kTile - 1) / kTile);
  const size_t smem = 2 * (size_t)(depth + 1) * kTile * sizeof(float);
  const cudaError_t err = allow_smem(gram_kernel<MODE, ACT>, smem);
  if (err != cudaSuccess) return err;
  gram_kernel<MODE, ACT><<<grid, block, smem, stream>>>(x1, x2, v1, v2, scales,
                                                        out, n1, n2, d, depth);
  return cudaGetLastError();
}

template <int MODE, int ACT>
cudaError_t launch_grads(const float* x1, const float* x2, const float* v1,
                         const float* v2, const float* dv1, const float* dv2,
                         const float* scales, const float* g, double* partial,
                         int n1, int n2, int d, int depth, cudaStream_t stream) {
  const dim3 block(kThreadsEdge, kThreadsEdge);
  const dim3 grid((n2 + kTile - 1) / kTile, (n1 + kTile - 1) / kTile);
  const size_t smem = 6 * (size_t)(depth + 1) * kTile * sizeof(float);
  const cudaError_t err = allow_smem(gram_grads_kernel<MODE, ACT>, smem);
  if (err != cudaSuccess) return err;
  gram_grads_kernel<MODE, ACT><<<grid, block, smem, stream>>>(
      x1, x2, v1, v2, dv1, dv2, scales, g, partial, n1, n2, d, depth);
  return cudaGetLastError();
}

}  // namespace

// x1 [n1, d], x2 [n2, d], v1 [depth+1, n1], v2 [depth+1, n2], scales
// [w^2, b^2, last^2, 1/D], out [n1, n2]: all fp32, contiguous, on the device
// of `stream`. mode: 0 mlp, 1 resnet; act: 0 relu, 1 erf. Returns the CUDA
// error code of the launch (0 on success); does not synchronize.
extern "C" int snngp_gram_f32(const float* x1, const float* x2, const float* v1,
                              const float* v2, const float* scales, float* out,
                              int n1, int n2, int d, int depth, int mode,
                              int act, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (mode == kMlp && act == kRelu)
    err = launch<kMlp, kRelu>(x1, x2, v1, v2, scales, out, n1, n2, d, depth, s);
  else if (mode == kMlp && act == kErf)
    err = launch<kMlp, kErf>(x1, x2, v1, v2, scales, out, n1, n2, d, depth, s);
  else if (mode == kResnet && act == kRelu)
    err = launch<kResnet, kRelu>(x1, x2, v1, v2, scales, out, n1, n2, d, depth, s);
  else if (mode == kResnet && act == kErf)
    err = launch<kResnet, kErf>(x1, x2, v1, v2, scales, out, n1, n2, d, depth, s);
  return static_cast<int>(err);
}

// As snngp_gram_f32, plus dv1 [2, depth+1, n1], dv2 [2, depth+1, n2] (the
// variance rows' tangents in w_std, b_std), the cotangent g [n1, n2] fp32,
// scales [w^2, b^2, last^2, 1/D, w, b, last], and partial [3, nblocks]
// float64 with nblocks = ceil(n1 / 64) * ceil(n2 / 64): block (by, bx) writes
// its (sum g dK/dw, sum g dK/db, sum g dK/dlast) at column by * ceil(n2 / 64)
// + bx. Returns the CUDA error code of the launch; does not synchronize.
extern "C" int snngp_gram_grads_f32(const float* x1, const float* x2,
                                    const float* v1, const float* v2,
                                    const float* dv1, const float* dv2,
                                    const float* scales, const float* g,
                                    double* partial, int n1, int n2, int d,
                                    int depth, int mode, int act, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (mode == kMlp && act == kRelu)
    err = launch_grads<kMlp, kRelu>(x1, x2, v1, v2, dv1, dv2, scales, g, partial,
                                    n1, n2, d, depth, s);
  else if (mode == kMlp && act == kErf)
    err = launch_grads<kMlp, kErf>(x1, x2, v1, v2, dv1, dv2, scales, g, partial,
                                   n1, n2, d, depth, s);
  else if (mode == kResnet && act == kRelu)
    err = launch_grads<kResnet, kRelu>(x1, x2, v1, v2, dv1, dv2, scales, g,
                                       partial, n1, n2, d, depth, s);
  else if (mode == kResnet && act == kErf)
    err = launch_grads<kResnet, kErf>(x1, x2, v1, v2, dv1, dv2, scales, g,
                                      partial, n1, n2, d, depth, s);
  return static_cast<int>(err);
}

// cudaGetErrorString for the wrapper's exception message.
extern "C" const char* snngp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
