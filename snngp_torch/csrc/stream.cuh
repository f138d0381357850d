// The streamed launch of K3, K4 (csrc/conv_gram.cu), K5 and K6
// (csrc/resnet_conv_gram.cu): one warp streams a pair's rows through
// registers, lane c of a segment of 2^lg lanes owning column c of the
// pair's [rows, lanes] state, a warp holding 32 / 2^lg pairs.

#pragma once

#include <cuda_runtime.h>

namespace {

// The launch's geometry, from the wrapper: the state's `lanes` columns
// (<= 32) in segments of 2^lg lanes, `rows` rows streamed; element (row r,
// column c) is pixel r * rstride + c * cstride of the [hw] image.
struct Geo {
  int lanes, rows, lg, rstride, cstride, hw;
};

// The pairs a launch runs: the n (n + 1) / 2 pairs j <= i of a symmetric
// one (`same`, n1 == n2), else all n1 n2.
__host__ __device__ __forceinline__ long long stream_pairs(int n1, int n2, int same) {
  return same ? (long long)n1 * (n1 + 1) / 2 : (long long)n1 * n2;
}

// A geometry no streamed launch takes.
inline bool bad_geometry(const Geo& G, int n1, int n2, int same) {
  return G.lanes < 1 || G.lg > 5 || G.lanes > (1 << G.lg) || G.rows < 1 ||
         (same && n1 != n2);
}

// The blocks of `warps` warps a launch takes, a warp running 32 / 2^lg
// pairs; -1 past the grid's limit.
inline long long stream_blocks(const Geo& G, int n1, int n2, int same, int warps) {
  const long long lane_warps = (stream_pairs(n1, n2, same) + (32 >> G.lg) - 1) / (32 >> G.lg);
  const long long blocks = (lane_warps + warps - 1) / warps;
  return blocks > 0x7fffffffLL ? -1 : blocks;
}

// Pair p of a symmetric launch: the n (n + 1) / 2 pairs (i, j), j <= i, in
// row order, p = i (i + 1) / 2 + j (the double root, then exact fix-ups).
__device__ __forceinline__ void tri_pair(long long p, int& i, int& j) {
  int r = (int)((sqrt(8.0 * (double)p + 1.0) - 1.0) * 0.5);
  while ((long long)r * (r + 1) / 2 > p) --r;
  while ((long long)(r + 1) * (r + 2) / 2 <= p) ++r;
  i = r;
  j = (int)(p - (long long)r * (r + 1) / 2);
}

// One lane's place in a streamed launch: segment s of warp w runs pair p =
// w * 32 / 2^lg + s, lane c of the segment its column c. `active`: a real
// column of a real pair; `left` / `right`: the column's neighbours exist.
// Every lane, active or not, takes part in the shuffles.
struct StreamLane {
  int i, j, c;
  bool pair_ok, active, left, right;

  __device__ StreamLane(const Geo& G, int n1, int n2, int same) {
    const int lane = threadIdx.x & 31;
    c = lane & ((1 << G.lg) - 1);
    const long long warp = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    const long long p = (warp << (5 - G.lg)) + (lane >> G.lg);
    pair_ok = p < stream_pairs(n1, n2, same);
    i = j = 0;
    if (pair_ok && same) {
      tri_pair(p, i, j);
    } else if (pair_ok) {
      i = (int)(p / n2);
      j = (int)(p - (long long)i * n2);
    }
    active = pair_ok && c < G.lanes;
    left = c >= 1;
    right = c < G.lanes - 1;
  }
};

// Column pass of the separable 3 x 3 sum across a segment of `seg` lanes:
// (z + left) + right, by shuffles, the missing neighbours counting 0.
__device__ __forceinline__ float lane_col_sum(float z, bool left, bool right, int seg) {
  const float l = __shfl_up_sync(0xffffffffu, z, 1, seg);
  const float r = __shfl_down_sync(0xffffffffu, z, 1, seg);
  return (z + (left ? l : 0.0f)) + (right ? r : 0.0f);
}

__device__ __forceinline__ float lane_col_sum(float z, const StreamLane& L, int seg) {
  return lane_col_sum(z, L.left, L.right, seg);
}

}  // namespace
