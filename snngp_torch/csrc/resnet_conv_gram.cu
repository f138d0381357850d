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
// enters and leaves once (4 KB a pair at 32 x 32): the FP32 and SFU pipes
// bound them, not memory, as K3 (csrc/conv_gram.cu).
//
// Design (simple first, as K3). None of the TPU layout carries over (the
// 128-lane HW padding, the rolls with lane masks, the "ones off the
// lattice"). A block keeps a tile of ti x tj pairs in shared memory, the
// wrapper choosing the tile from HW at launch (about 4,096 pair-pixels a
// block: 2 x 2 pairs at 32 x 32, 8 x 8 at 8 x 8). K5 holds three planes a
// pair (the carry k, a working plane, the column sums: 12 KB at 32 x 32);
// K6 holds k and t1 at full resolution and the column sums of each at the
// lattice columns (12 KB at 32 x 32). The separable stencil writes the
// column sums (z + left) + right in one pass and reads their row
// neighbours, (zc + up) + down, then / 9, in the next, one barrier after
// each pass; neighbours are read with row / column edge tests, so ragged
// H, W need no padding. The TPU kernel staged all 2 nblocks variance rows
// of a tile at once (128 KB at 32 x 32 with four blocks and 2 x 2 pairs);
// here each pass reads the one row it needs through the read-only cache
// (each row is read by tj or ti pairs of the tile and stays in L1 / L2), so
// shared memory holds only the pair states. IEEE acosf / asinf / sqrtf and
// divides, no fast math: the parity bar is fp32. The dual activation
// multiplies v1 v2 in one order for (i, j) and (j, i), so K(x, x) stays
// bitwise symmetric.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
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

// K5. Shared memory: k, the working plane and the column sums, three
// [ti * tj][hw] planes. v1 [2 nblocks, n1, hw], v2 [2 nblocks, n2, hw];
// scales = [w^2, b^2].
template <int ACT>
__global__ void __launch_bounds__(kThreads)
resnet_tail_kernel(const float* __restrict__ k_in, const float* __restrict__ v1,
                   const float* __restrict__ v2, const float* __restrict__ scales,
                   float* __restrict__ k_out, int n1, int n2, int h, int w, int nblocks,
                   int mismatch, int ti, int tj) {
  extern __shared__ float smem[];
  const Tile t(ti, tj);
  const int hw = h * w;
  const int elems = t.pairs * hw;
  float* kpl = smem;           // the residual carry k
  float* work = kpl + elems;   // t1, then t2, then S(k)'s column sums
  float* col = work + elems;   // column sums
  const float w2 = scales[0];
  const float b2 = scales[1];

  for (int e = threadIdx.x; e < elems; e += kThreads) {
    const int q = e / hw;
    const int p = e - q * hw;
    const int i = t.i(q);
    const int j = t.j(q);
    kpl[e] = (i < n1 && j < n2) ? k_in[((size_t)i * n2 + j) * hw + p] : 0.0f;
  }
  __syncthreads();

  for (int blk = 0; blk < nblocks; ++blk) {
    const float* va1 = v1 + (size_t)(2 * blk) * n1 * hw;   // rows entering act 1
    const float* va2 = v2 + (size_t)(2 * blk) * n2 * hw;
    const float* vb1 = va1 + (size_t)n1 * hw;              // rows entering act 2
    const float* vb2 = va2 + (size_t)n2 * hw;
    for (int e = threadIdx.x; e < elems; e += kThreads) {  // t1 = T(k)
      const int q = e / hw;
      const int p = e - q * hw;
      work[e] = dual_act<ACT>(kpl[e], var_at(va1, t.i(q), n1, hw, p),
                              var_at(va2, t.j(q), n2, hw, p));
    }
    __syncthreads();
    for (int e = threadIdx.x; e < elems; e += kThreads) {
      const int q = e / hw;
      const int p = e - q * hw;
      col[e] = col_sum(work + q * hw, p, p % w, w);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < elems; e += kThreads) {  // c1 = w2 S(t1) + b2; t2 = T(c1)
      const int q = e / hw;
      const int p = e - q * hw;
      const float c1 = w2 * (row_sum(col + q * hw, p, p / w, h, w) / 9.0f) + b2;
      work[e] = dual_act<ACT>(c1, var_at(vb1, t.i(q), n1, hw, p),
                              var_at(vb2, t.j(q), n2, hw, p));
    }
    __syncthreads();
    for (int e = threadIdx.x; e < elems; e += kThreads) {
      const int q = e / hw;
      const int p = e - q * hw;
      col[e] = col_sum(work + q * hw, p, p % w, w);
    }
    __syncthreads();
    const bool conv_shortcut = mismatch && blk == 0;
    if (conv_shortcut) {
      // S(k)'s column sums, from the old k before it is overwritten; t2 is
      // no longer needed, so they take its plane.
      for (int e = threadIdx.x; e < elems; e += kThreads) {
        const int q = e / hw;
        const int p = e - q * hw;
        work[e] = col_sum(kpl + q * hw, p, p % w, w);
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < elems; e += kThreads) {
      const int q = e / hw;
      const int p = e - q * hw;
      const int row = p / w;
      const float s2 = row_sum(col + q * hw, p, row, h, w) / 9.0f;
      if (conv_shortcut) {
        const float sk = row_sum(work + q * hw, p, row, h, w) / 9.0f;
        kpl[e] = (w2 * s2 + b2) + (w2 * sk + b2);
      } else {
        kpl[e] = kpl[e] + w2 * s2 + b2;
      }
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < elems; e += kThreads) {
    const int q = e / hw;
    const int p = e - q * hw;
    const int i = t.i(q);
    const int j = t.j(q);
    if (i < n1 && j < n2) k_out[((size_t)i * n2 + j) * hw + p] = kpl[e];
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

template <int ACT>
cudaError_t launch_tail(const float* k, const float* v1, const float* v2,
                        const float* scales, float* out, int n1, int n2, int h, int w,
                        int nblocks, int mismatch, int ti, int tj, cudaStream_t stream) {
  const dim3 grid((n2 + tj - 1) / tj, (n1 + ti - 1) / ti);
  const size_t smem = sizeof(float) * 3 * (size_t)h * w * ti * tj;
  const cudaError_t err = allow_smem(resnet_tail_kernel<ACT>, smem);
  if (err != cudaSuccess) return err;
  resnet_tail_kernel<ACT><<<grid, kThreads, smem, stream>>>(
      k, v1, v2, scales, out, n1, n2, h, w, nblocks, mismatch, ti, tj);
  return cudaGetLastError();
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

// k, out [n1, n2, h*w]; v1 [2*nblocks, n1, h*w], v2 [2*nblocks, n2, h*w];
// scales [w^2, b^2]: all fp32, contiguous, on the device of `stream`.
// mismatch: block 0 takes the conv shortcut. act: 0 relu, 1 erf. (ti, tj):
// the pairs of one block's tile, ti <= n1, tj <= n2; the caller checks that
// the tile's shared memory fits. Returns the CUDA error code of the launch
// (0 on success); does not synchronize.
extern "C" int snngp_resnet_tail_f32(const float* k, const float* v1, const float* v2,
                                     const float* scales, float* out, int n1, int n2,
                                     int h, int w, int nblocks, int mismatch, int act,
                                     int ti, int tj, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (act == kRelu)
    err = launch_tail<kRelu>(k, v1, v2, scales, out, n1, n2, h, w, nblocks, mismatch, ti,
                             tj, s);
  else if (act == kErf)
    err = launch_tail<kErf>(k, v1, v2, scales, out, n1, n2, h, w, nblocks, mismatch, ti,
                            tj, s);
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

// cudaGetErrorString for the wrapper's exception message.
extern "C" const char* snngp_resnet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
