// Fused NNGP Gram for the MLP and dense-ResNet kernels (K1), CUDA C++ for
// Hopper (sm_90a). Bound to Python with ctypes by snngp_torch/ops/gram.py.
//
// Replaces: snngp/ops/pallas/gram.py::_gram_kernel (launched by
// _mlp_gram_pallas). Same math, per output element:
//   k = <x1_i, x2_j> / D
//   mlp:    depth x [k = T(w2 k + b2; v1[l+1]_i, v2[l+1]_j)], then last2 k
//   resnet: k = w2 k + b2, then depth x [k = k + w2 T(k; v1[l]_i, v2[l]_j) + b2],
//           then last2 T(k; v1[depth]_i, v2[depth]_j)
// with T the arccos (ReLU) or arcsin (Erf) dual activation and the per-layer
// variance rows v1 [depth+1, n1], v2 [depth+1, n2] computed outside (O(N depth)).
//
// What bounds it on an H100: at D = 16, N = 10,000, depth 4 the kernel does
// ~1e8 outputs x depth x (one acosf or asinf, two sqrtf, one IEEE divide,
// ~15 FMA) against a 400 MB store, so it is bound by the FP32 and SFU pipes,
// not by memory. The input product is a small share (2 D FMA per output).
//
// Design (simple first): one 64 x 64 output tile per 256-thread block, 4 x 4
// outputs per thread. The block stages its x1 and x2 rows in shared memory in
// chunks of 32 features and accumulates the dot product in plain fp32 FMA in
// a fixed order over D, so K(x, x) comes out bitwise symmetric (fma(a, b, c)
// == fma(b, a, c)). It also stages its [depth+1, 64] variance rows in
// dynamic shared memory. The recursion runs in registers with IEEE
// acosf/asinf/sqrtf (no fast math: the parity bar is fp32); each output is
// stored once. Ragged edges are masked: no padding of rows or features.
// Not yet used: wgmma for the input product, TMA, the symmetry of K(x, x).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;                 // output tile edge
constexpr int kThreadsEdge = 16;          // 16 x 16 threads
constexpr int kPer = kTile / kThreadsEdge;  // outputs per thread per axis
constexpr int kThreads = kThreadsEdge * kThreadsEdge;
constexpr int kChunk = 32;                // features staged per pass
constexpr float kPi = 3.14159265358979323846f;
constexpr float kInv2Pi = 0.15915494309189533577f;
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
  // d >= 1 (the wrapper checks), so the chunk loop's barriers have also
  // published the variance rows.

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

template <int MODE, int ACT>
cudaError_t launch(const float* x1, const float* x2, const float* v1,
                   const float* v2, const float* scales, float* out, int n1,
                   int n2, int d, int depth, cudaStream_t stream) {
  const dim3 block(kThreadsEdge, kThreadsEdge);
  const dim3 grid((n2 + kTile - 1) / kTile, (n1 + kTile - 1) / kTile);
  const size_t smem = 2 * (size_t)(depth + 1) * kTile * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gram_kernel<MODE, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  gram_kernel<MODE, ACT><<<grid, block, smem, stream>>>(x1, x2, v1, v2, scales,
                                                        out, n1, n2, d, depth);
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

// cudaGetErrorString for the wrapper's exception message.
extern "C" const char* snngp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
