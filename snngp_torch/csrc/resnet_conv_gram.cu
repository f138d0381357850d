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
// K6's design: K5's streamed layout at the lattice's two resolutions. Lane
// c holds full-resolution column c, and step t reads row t of k (128
// contiguous bytes at 32 x 32), forms t1 = T(k; v_in) and the column sums of
// t1 and of k (two shuffles each), and keeps a three-row window of each.
// Once row r + 1 is in (or r is the last row), a lattice row r = 2a + oh
// has its two stride-1 stencils S(t1) and S(k) complete at every column;
// one shuffle each moves those of the lattice columns 2b + ow to lanes b =
// 0 .. wr - 1, which form c1 = w2 S(t1) + b2, t2 = T(c1; v_mid[a, b]) and
// the shortcut w2 S(k) + b2, each lane reading its own v_mid. The reduced
// stencil's column sums run over those wr lanes, and a three-row window of
// them gives output row a - 1 when reduced row a is formed (the shortcut
// held one reduced row), an output row being one contiguous store; the
// last row is flushed at the end. A narrow state takes segments of 2^lg >=
// w lanes and 32 / 2^lg pairs a warp, a state wider than 32 streams
// transposed, the wrapper swapping the input's strides and the output's
// (ors, ocs), and the kernel taking the lattice offsets from the parity of
// the streamed extents, so (oh, ow) swap too. With `same` a launch runs each
// pair j <= i of K(x, x) once (its state enters bitwise symmetric) and
// writes (i, j) and (j, i). No shared memory and no barrier.

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
// K6: its blocks an SM. On an H100 (700 W) at 200 x 200 pairs, 32 -> 16,
// relu, symmetric: 4 or 5 blocks (47-48 registers, no spill) 0.170-0.182
// ms, 6 blocks (40 registers, 8-16 bytes spilled) 0.170-0.173 ms, 8 blocks
// (32 registers, 28-32 bytes spilled) 0.181 ms.
constexpr int kStridedBlocksPerSM = 4;
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

// K6, streamed (see the header). v1 [n1, hw] and v1m [n1, hwr] (v2, v2m
// likewise): the variances entering the block's two activations; scales =
// [w^2, b^2]. Lane c holds full-resolution column c; reduced lane b = c
// (b < ceil(lanes / 2)) holds reduced column b, element (a, b) of the
// reduced state at a * ors + b * ocs. The registers hold the windows of
// t1's and k's column sums (cpT, ccT; cpK, ccK), the window of t2's reduced
// column sums (cp2, cc2) and the shortcut of the last reduced row (sc).
template <int ACT>
__global__ void __launch_bounds__(kThreads, kStridedBlocksPerSM)
resnet_strided_kernel(const float* __restrict__ k_in, const float* __restrict__ v1,
                      const float* __restrict__ v2, const float* __restrict__ v1m,
                      const float* __restrict__ v2m, const float* __restrict__ scales,
                      float* __restrict__ k_out, int n1, int n2, Geo G, int ors, int ocs,
                      int same) {
  const StreamLane L(G, n1, n2, same);
  const int seg = 1 << G.lg;
  const int rows = G.rows;
  const int rs = G.rstride;
  const float w2 = scales[0];
  const float b2 = scales[1];
  // The lattice (2a + oR, 2b + oC): an even extent centres the stride-2
  // window on 2a + 1, an odd one on 2a.
  const int oR = (rows & 1) ^ 1;
  const int oC = (G.lanes & 1) ^ 1;
  const int lanes_r = (G.lanes + 1) >> 1;
  const int hwr = ((rows + 1) >> 1) * lanes_r;
  const bool active_r = L.pair_ok && L.c < lanes_r;
  const bool left_r = L.c >= 1;
  const bool right_r = L.c < lanes_r - 1;
  const int src = 2 * L.c + oC;      // the full-resolution lane of reduced lane c
  const int pix = L.c * G.cstride;
  const int pix_r = L.c * ocs;
  const float* kp = k_in + ((size_t)L.i * n2 + L.j) * G.hw + pix;
  const float* va_in = v1 + (L.i * G.hw + pix);
  const float* vb_in = v2 + (L.j * G.hw + pix);
  const float* va_mid = v1m + (L.i * hwr + pix_r);
  const float* vb_mid = v2m + (L.j * hwr + pix_r);
  float* out1 = k_out + ((size_t)L.i * n2 + L.j) * hwr + pix_r;
  float* out2 = k_out + ((size_t)L.j * n2 + L.i) * hwr + pix_r;
  const bool mirror = same && L.i != L.j;

  float cpT = 0.0f, ccT = 0.0f, cpK = 0.0f, ccK = 0.0f;
  float cp2 = 0.0f, cc2 = 0.0f, sc = 0.0f;
  int a = 0;                         // the next reduced row
  for (int t = 0; t <= rows; ++t) {  // t == rows: the row below the image, 0
    float z = 0.0f, t1 = 0.0f;       // k and T(k; v_in) at row t
    if (t < rows) {
      float va = 1.0f, vb = 1.0f;
      if (L.active) {
        z = kp[t * rs];
        va = __ldg(va_in + t * rs);
        vb = __ldg(vb_in + t * rs);
      }
      t1 = dual_act<ACT>(z, va, vb);
    }
    const float csT = lane_col_sum(t1, L, seg);
    const float csK = lane_col_sum(z, L, seg);
    const int r = t - 1;             // the row whose stencils are complete
    if (r >= oR && ((r - oR) & 1) == 0) {
      // Lattice row r = 2a + oR: S(t1) and S(k) there, moved from lane 2b +
      // oC to lane b, give c1 = w2 S(t1) + b2, t2 = T(c1; v_mid) and the
      // shortcut w2 S(k) + b2 of reduced row a.
      const float sT = __shfl_sync(0xffffffffu, ((ccT + cpT) + csT) / 9.0f, src, seg);
      const float sK = __shfl_sync(0xffffffffu, ((ccK + cpK) + csK) / 9.0f, src, seg);
      float va = 1.0f, vb = 1.0f;
      if (active_r) {
        va = __ldg(va_mid + a * ors);
        vb = __ldg(vb_mid + a * ors);
      }
      const float t2 = dual_act<ACT>(w2 * sT + b2, va, vb);
      const float cs2 = lane_col_sum(t2, left_r, right_r, seg);
      if (a >= 1 && active_r) {      // reduced row a - 1: w2 S(t2) + b2, plus the shortcut
        const float o = (w2 * (((cc2 + cp2) + cs2) / 9.0f) + b2) + sc;
        out1[(a - 1) * ors] = o;
        if (mirror) out2[(a - 1) * ors] = o;
      }
      cp2 = cc2;
      cc2 = cs2;
      sc = w2 * sK + b2;
      ++a;
    }
    cpT = ccT;
    ccT = csT;
    cpK = ccK;
    ccK = csK;
  }
  if (active_r) {                    // the last reduced row; the row below it is 0
    const float o = (w2 * ((cc2 + cp2) / 9.0f) + b2) + sc;
    out1[(a - 1) * ors] = o;
    if (mirror) out2[(a - 1) * ors] = o;
  }
}

template <int ACT, int NB, bool MIS>
cudaError_t launch_tail_nb(const float* k, const float* v1, const float* v2,
                           const float* scales, float* out, int n1, int n2, const Geo& G,
                           int same, cudaStream_t stream) {
  const long long blocks = stream_blocks(G, n1, n2, same, kThreads / 32);
  if (blocks < 0) return cudaErrorInvalidConfiguration;
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
                           float* out, int n1, int n2, const Geo& G, int ors, int ocs,
                           int same, cudaStream_t stream) {
  const long long blocks = stream_blocks(G, n1, n2, same, kThreads / 32);
  if (blocks < 0) return cudaErrorInvalidConfiguration;
  resnet_strided_kernel<ACT><<<(unsigned)blocks, kThreads, 0, stream>>>(
      k, v1, v2, v1m, v2m, scales, out, n1, n2, G, ors, ocs, same);
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
  if (bad_geometry(G, n1, n2, same) || nblocks < 1 || nblocks > kMaxTailBlocks)
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
// v2m [n2, hr*wr] the second; scales [w^2, b^2]. The state streams as in
// snngp_resnet_tail_f32, and reduced element (a, b) (of ceil(rows / 2) rows
// and ceil(lanes / 2) columns) is pixel a * ors + b * ocs of the output; the
// lattice offsets follow the parity of rows and lanes. same = 1: k is
// K(x, x)'s state (bitwise symmetric, n1 == n2), v2 is v1 and v2m is v1m.
// Returns the CUDA error code of the launch; does not synchronize.
extern "C" int snngp_resnet_strided_f32(const float* k, const float* v1, const float* v2,
                                        const float* v1m, const float* v2m,
                                        const float* scales, float* out, int n1, int n2,
                                        int lanes, int rows, int lg, int rstride,
                                        int cstride, int ors, int ocs, int act, int same,
                                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo G{lanes, rows, lg, rstride, cstride, lanes * rows};
  if (bad_geometry(G, n1, n2, same)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (act == kRelu)
    err = launch_strided<kRelu>(k, v1, v2, v1m, v2m, scales, out, n1, n2, G, ors, ocs, same,
                                s);
  else if (act == kErf)
    err = launch_strided<kErf>(k, v1, v2, v1m, v2m, scales, out, n1, n2, G, ors, ocs, same,
                               s);
  return static_cast<int>(err);
}

// The most residual blocks one snngp_resnet_tail_f32 call takes.
extern "C" int snngp_resnet_tail_max_blocks() { return kMaxTailBlocks; }

// cudaGetErrorString for the wrapper's exception message.
extern "C" const char* snngp_resnet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
