// Fused Myrtle conv-NNGP Gram (K7) and its scale-tangent mode, CUDA C++ for
// Hopper (sm_90a). Bound to Python with ctypes by
// snngp_torch/ops/myrtle_gram.py.
//
// Replaces snngp/ops/pallas/myrtle_gram.py::_myrtle_kernel (launched by
// _myrtle_call), both its forward and its `tangents` mode. Per pair (a, b)
// of [h, h, C] images (h = 8, 16 or 32) it runs the Myrtle-5/7/10
// recursion on the [h^2, h^2] pixel-pair covariance K[p1, p2]:
//   K = sum_c x1[a, p1, c] x2[b, p2, c] / C
//   three groups of g0 / g1 / g2 x [K = T(w2 S(K) + b2; v1[p1], v2[p2])],
//   each followed by an exact 2 x 2 average pool on both sides,
//   out[a, b] = last2 * mean(K)   (global average pool + dense readout)
// with S the same-offset 3 x 3 stencil mean K'[p1, p2] = 1/9 sum_d
// K[p1 + d, p2 + d] (zero off the image), T the arccos (ReLU) or arcsin
// (Erf) dual activation, and the per-sample variance profiles v1, v2 of
// every conv layer computed outside (O(N h^4) per sample, not per pair).
//
// What bounds it on an H100: at 32 x 32 one pair's stage 1 alone is 1M
// pixel pairs x (the moment's C FMAs, a 9-point stencil, a dual activation
// with acosf / asinf, two sqrtf and divides, the pool) and it writes one
// float: fp32 and SFU operations, not memory (the inputs are ~MBs and stay
// in L2), ~35-40 M operations a pair at Myrtle-5.
//
// Design. The TPU kernel kept a pair's whole 4 MB state in VMEM, with
// strip-mined stage-1 rows and halos, one-hot matvecs to read profile
// columns, reshape pooling and sparse 128-lane tail layouts; none of that
// carries over, since a block has 227 KB. Instead the state is cut into
// Delta-slabs: S keeps the offset Delta = p2 - p1 and the moment and T are
// pointwise, so inside a conv group slab Delta (an (r - |Di|) x (r - |Dj|)
// image) evolves alone, with its own zero boundary and the profiles of p1
// on side a and of p1 + Delta on side b. A 2 x 2 pool sends each entry of
// slab Delta to exactly one entry of pooled slab floor(D/2) or ceil(D/2)
// per axis (an entry with even p1 to floor, odd to ceil, for odd D). One
// block of 16 warps runs one pair (tangent_recursion, both modes):
//   stage 1 (h): slab rows Di ascending; in a row three waves (Dj even,
//     Dj = 1 mod 4, Dj = 3 mod 4) whose slabs pool into disjoint targets,
//     so warps add into the pooled slabs without atomics, one barrier a
//     wave; the pooled (h/2) state lives in shared memory as a ring of two
//     pooled rows (row m receives from Di = 2m - 1, 2m, 2m + 1);
//   stage 2 (h/2): a pooled row m runs as soon as Di = 2m + 1 is done, in
//     place in the ring, pooling into the whole stage-3 (h/4) state;
//   stage 3 (h/4): every slab, then the GAP, which after the last pool is
//     the mean over stage 3's entries, accumulated in float64.
// Stage 1 (94% of a pair's entries at 32 x 32, and all of the moment work)
// keeps no slab in shared memory: a warp streams a slab's rows top to
// bottom through registers, one slab column a lane (stream_task). Column
// sums come by shuffles, row sums from a window of three rows a conv layer,
// layer l + 1 runs one row behind layer l, and the 2 x 2 pool adds rows held
// in registers and columns by shuffle, then adds into the ring once. The
// slabs Dj > 0 and Dj - h fill one warp together (h columns, the seam a slab
// edge; both in the same wave), so a row's waves hold h/2, h/4 and h/4 warp
// tasks; the tasks of the short waves are split into row parts (a part
// recomputes G0 rows above its first) so that all 16 warps have work.
// Stages 2 and 3 run in shared memory, one (h/2)^2 column-sum plane a warp
// (slab_convs / slab_pool). Each pooled entry receives its partial sums in
// one fixed order (rows, then waves), so results repeat bitwise, and every
// entry sees the operations of the plain version
// (ops/myrtle_gram.py::_PlainRecursion) in its order. IEEE acosf / asinf /
// sqrtf and divides, no fast math. With `same` (x2 is x1) block (a, b), b <
// a, returns at once and block (a, b), b >= a, writes (a, b) and (b, a):
// half the pairs, and K(x, x) (and its tangents) bitwise symmetric.
//
// The two modes are instantiations of one recursion, tangent_recursion<ACT,
// NT, G0> with NT tangents carried and G0 stage-1 convs. The forward
// (myrtle_gram_kernel, NT = 0) carries one state and differs only where NT
// says so: it applies dual_act (the plain version's forward T, which for
// erf rounds otherwise than the partials' t), reads four scales (no w, b),
// and its block takes a quarter of the shared memory (one state: 64 KB at
// 32 x 32), so its launch bounds ask for kForwardBlocks blocks an SM. The
// tangent mode (myrtle_gram_tangents_kernel) carries dK/dw_std and/or
// dK/db_std: the conv adds 2 w S(K) and 2 b, the activation's partials
// serve every tangent, and the pools and the GAP apply to each state; it
// writes the tangent Grams themselves (dK/dlast = (2 / last) K needs no
// kernel); three states take 160 KB at 32 x 32, one block an SM.
//
// The forward's bf16 variant (myrtle_gram_kernel<ACT, G0, true>, the JAX
// package's myrtle_gram(dtype=bf16), snngp/ops/pallas/myrtle_gram.py:309-
// 352) carries the pair state in bf16: stage 1's registers are
// __nv_bfloat16, and every op of the recursion rounds to bf16 at the plain
// version's points (State<true> below); the moment, the pools and the GAP
// sum in fp32 (float64 for the GAP) and the output is fp32. Its shared
// memory is the fp32 forward's: the ring and stage 3 accumulate each
// pooled entry's partial sums in fp32 (rounded once, when read), so a
// bf16 ring would round each of up to nine partial sums instead. Both
// variants take 64 registers, which bounds them to two blocks an SM.
//
// What bounds the recursion: per entry and conv the IEEE divides,
// sqrtf and acosf (and, in the tangent mode, the partials) and the
// stencil's dependent adds, a chain with one or two loads and shuffles in
// it; the short waves and the halo rows of split tasks; stage 2 still runs
// in shared memory with a barrier a wave. Not used: the pair-independence
// of the side-a moment and profile loads, and tensor cores: the work is
// transcendental and elementwise, with no matrix product to give wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxStates = 3;
constexpr int kWarps = 16;   // warps a block, both modes
// The forward's blocks an SM (its __launch_bounds__ minimum): one state's
// 64 KB of shared memory at 32 x 32 lets two 16-warp blocks share an SM,
// and ptxas fits every forward instantiation in 64 registers without a
// spill. On an H100 (700 W) at 200 x 200 pairs of 32 x 32 x 3, Myrtle-5,
// two blocks ran in 341 ms, one (125 registers) in 432 ms.
constexpr int kForwardBlocks = 2;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kInv2Pi = 0.15915494309189533577f;
constexpr float kInv4Pi = 0.07957747154594766788f;
constexpr float kTwoOverPi = 0.63661977236758134308f;

enum Act { kRelu = 0, kErf = 1 };

// The dual activations and their partials: line for line those of
// csrc/conv_gram.cu and of ops/gram.py.
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

// Slab geometry at resolution r: offsets d in (-r, r); slab d spans r - |d|
// entries starting at p1 = max(0, -d); cum(r, d) counts the entries of the
// slabs d' < d on one axis, so slab (di, dj) of a full state starts at
// cum(r, di) r^2 + span(r, di) cum(r, dj).
__device__ __forceinline__ int span(int r, int d) { return r - abs(d); }
__device__ __forceinline__ int lo(int d) { return d < 0 ? -d : 0; }
__device__ __forceinline__ int cum(int r, int d) {
  if (d <= 0) {
    const int k = r + d - 1;
    return k * (k + 1) / 2;
  }
  return r * (r + 1) / 2 + (d - 1) * (2 * r - d) / 2;
}
// e / n for 0 <= e < 4096 and 1 <= n <= 64 (a slab has at most h^2 = 1024
// entries), by a float reciprocal instead of an integer division: exact
// there, since (e + 0.5) / n lies at least 0.5 / n from an integer and the
// float product errs by less than 4096 * 2^-23.
struct Div {
  float inv;
  __device__ explicit Div(int n) : inv(1.0f / (float)n) {}
  __device__ __forceinline__ int operator()(int e) const {
    return __float2int_rz(((float)e + 0.5f) * inv);
  }
};

// The wave of slab column d: 0 even, 1 for d = 1 mod 4, 2 for d = 3 mod 4.
__device__ __forceinline__ int wave_of(int d) {
  if ((d & 1) == 0) return 0;
  return (((d % 4) + 4) % 4 == 1) ? 1 : 2;
}

// The pair state's type (St) and its rounding. The fp32 state is float and
// every function here is the identity. The bf16 state (the forward's bf16
// variant) holds stage 1's registers as __nv_bfloat16 and rounds to bf16
// at the plain version's points (ops/myrtle_gram.py::_PlainRecursion): the
// arithmetic itself is fp32, each op's result rounded once (cvt.rn), as
// PyTorch's bf16 ops round on the CPU. Packed __nv_bfloat162 FMAs would
// fuse w2 * S + b2 into one rounding and leave the plain version's order;
// and the divide, sqrtf and acosf of the dual activation have no bf16
// form. The stage-2 ring and stage 3 stay fp32 accumulators (the pools sum
// in fp32 and round once per pooled entry, when its stage first reads
// it); the values they hold after a conv are bf16 values.
template <bool BF16>
struct State {
  using St = float;
  static __device__ __forceinline__ float get(float v) { return v; }
  static __device__ __forceinline__ float put(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float shfl_up(float v) {
    return __shfl_up_sync(0xffffffffu, v, 1);
  }
  static __device__ __forceinline__ float shfl_down(float v) {
    return __shfl_down_sync(0xffffffffu, v, 1);
  }
};

template <>
struct State<true> {
  using St = __nv_bfloat16;
  static __device__ __forceinline__ float get(St v) { return __bfloat162float(v); }
  static __device__ __forceinline__ St put(float v) { return __float2bfloat16_rn(v); }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  // Shuffles move a bf16 as the low 16 bits of a 32-bit word.
  static __device__ __forceinline__ St shfl_up(St v) {
    const unsigned u = __shfl_up_sync(0xffffffffu, (unsigned)__bfloat16_as_ushort(v), 1);
    return __ushort_as_bfloat16((unsigned short)u);
  }
  static __device__ __forceinline__ St shfl_down(St v) {
    const unsigned u = __shfl_down_sync(0xffffffffu, (unsigned)__bfloat16_as_ushort(v), 1);
    return __ushort_as_bfloat16((unsigned short)u);
  }
};

struct Args {
  const float* x1;      // [n1, h, h, c]
  const float* x2;      // [n2, h, h, c]
  const float* prof1;   // [n1, P]: every conv layer's [r, r] profile
  const float* prof2;   // [n2, P]
  const float* dprof1;  // [n1, 2, P] (d/dw, d/db) or null
  const float* dprof2;  // [n2, 2, P] or null
  const float* scales;  // [w^2, b^2, last^2, 1/C(, w, b)]
  float* out;           // [states, n1, n2]
  int n1, n2, h, c, g0, g1, g2, tsel;
  int same;             // x2 is x1: run only b >= a
};

// Per-pair pointers and scales, and the tangents carried.
template <int NT>
struct Pair {
  const float* v1;             // prof1 row of a
  const float* v2;             // prof2 row of b
  const float* dv1[kMaxStates];
  const float* dv2[kMaxStates];
  int tan[kMaxStates];         // 0 = d/dw, 1 = d/db
  float w2, b2, two_w, two_b;
};

// Layer l's offset into a profile row and its resolution.
__device__ __forceinline__ int layer_offset(const Args& A, int l) {
  const int h = A.h, r2 = h / 2, r3 = h / 4;
  if (l < A.g0) return l * h * h;
  if (l < A.g0 + A.g1) return A.g0 * h * h + (l - A.g0) * r2 * r2;
  return A.g0 * h * h + A.g1 * r2 * r2 + (l - A.g0 - A.g1) * r3 * r3;
}

// g convs (layers l0 .. l0 + g - 1) on one slab (di, dj) at resolution r
// whose NS = 1 + NT state planes st[] hold ni x nj entries; tmp is the
// warp's column-sum plane. Warp-wide; one __syncwarp after each pass. With
// a bf16 state (NT = 0 only) every op rounds, and so does each read of the
// state: the first conv of a stage reads the fp32 pooled sums and rounds
// each once, later convs read bf16 values, which rounding leaves as they
// are.
template <int ACT, int NT, bool BF16>
__device__ void slab_convs(const Args& A, const Pair<NT>& P, float* const* st, float* tmp,
                           int r, int di, int dj, int l0, int g, int lane) {
  static_assert(NT == 0 || !BF16, "the bf16 state is the forward's");
  using N = State<BF16>;
  const int ni = span(r, di), nj = span(r, dj), i0 = lo(di), j0 = lo(dj);
  const int n = ni * nj;
  const Div div(nj);
  for (int l = l0; l < l0 + g; ++l) {
    const int off = layer_offset(A, l);
#pragma unroll
    for (int s = 0; s < 1 + NT; ++s) {
      // Column sums (z + left) + right, then row sums (zc + up) + down, / 9.
      const float* z = st[s];
      for (int e = lane; e < n; e += 32) {
        const int v = e - div(e) * nj;
        float acc = N::round(N::round(z[e]) + ((v >= 1) ? N::round(z[e - 1]) : 0.0f));
        tmp[e] = N::round(acc + ((v < nj - 1) ? N::round(z[e + 1]) : 0.0f));
      }
      __syncwarp();
      for (int e = lane; e < n; e += 32) {
        const int u = div(e);
        float acc = N::round(tmp[e] + ((u >= 1) ? tmp[e - nj] : 0.0f));
        acc = N::round(acc + ((u < ni - 1) ? tmp[e + nj] : 0.0f));
        const float sk = N::round(acc / 9.0f);
        if (NT == 0) {
          const int v = e - u * nj;
          const int q1 = (i0 + u) * r + j0 + v;
          const int q2 = q1 + di * r + dj;
          st[0][e] = N::round(dual_act<ACT>(N::round(N::round(P.w2 * sk) + P.b2),
                                            N::round(__ldg(P.v1 + off + q1)),
                                            N::round(__ldg(P.v2 + off + q2))));
        } else {
          st[s][e] = sk;
        }
      }
      __syncwarp();
    }
    if (NT > 0) {
      for (int e = lane; e < n; e += 32) {
        const int u = div(e);
        const int v = e - u * nj;
        const int q1 = off + (i0 + u) * r + j0 + v;
        const int q2 = q1 + di * r + dj;
        const float sk = st[0][e];
        const Partials pa = dual_act_partials<ACT>(P.w2 * sk + P.b2, __ldg(P.v1 + q1),
                                                   __ldg(P.v2 + q2));
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const float du = P.w2 * st[1 + t][e] + (P.tan[t] == 0 ? P.two_w * sk : P.two_b);
          st[1 + t][e] = pa.tk * du + pa.tv1 * __ldg(P.dv1[t] + q1) +
                         pa.tv2 * __ldg(P.dv2[t] + q2);
        }
        st[0][e] = pa.t;
      }
      __syncwarp();
    }
  }
}

// Where pooled slabs live: stage 2's ring of two rows ([slot][state][rowmax],
// row m in slot (m + r - 1) & 1) or stage 3's whole state ([state][r^4]).
struct Dest {
  float* base;
  int r;        // the pooled resolution
  bool ring;
  int states;

  __device__ float* row(int s, int pi) const {
    if (ring) {
      const int slot = (pi + r - 1) & 1;
      return base + (size_t)(slot * states + s) * r * r * r;
    }
    return base + (size_t)s * r * r * r * r + (size_t)cum(r, pi) * r * r;
  }
};

// Add the 2 x 2 pool of slab (di, dj) at resolution r to the pooled slabs
// it feeds: each target entry gets 1/16 of the sum of its 1, 2 or 4
// sources, in (row parity, column parity) order. Warp-wide.
template <int NT>
__device__ void slab_pool(float* const* st, int r, int di, int dj, const Dest& D,
                          int lane) {
  const int r2 = r / 2, nj = span(r, dj);
  for (int ti = 0; ti < 2; ++ti) {
    const int pi = (ti == 0) ? (di >> 1) : ((di + 1) >> 1);
    if ((ti == 1 && pi == (di >> 1)) || abs(pi) >= r2) continue;
    const int ei = di - 2 * pi;
    const int ai = (ei == -1) ? 1 : 0, bi = (ei == 1) ? 0 : 1;
    const int ni_t = span(r2, pi), i0_t = lo(pi);
    for (int tj = 0; tj < 2; ++tj) {
      const int pj = (tj == 0) ? (dj >> 1) : ((dj + 1) >> 1);
      if ((tj == 1 && pj == (dj >> 1)) || abs(pj) >= r2) continue;
      const int ej = dj - 2 * pj;
      const int aj = (ej == -1) ? 1 : 0, bj = (ej == 1) ? 0 : 1;
      const int nj_t = span(r2, pj), j0_t = lo(pj);
      const int toff = ni_t * cum(r2, pj);
      float* dst[1 + NT];
#pragma unroll
      for (int s = 0; s < 1 + NT; ++s) dst[s] = D.row(s, pi) + toff;
      const Div div(nj_t);
      for (int e = lane; e < ni_t * nj_t; e += 32) {
        const int uu = div(e);
        const int vv = e - uu * nj_t;
        const int ub = 2 * (i0_t + uu) - lo(di);
        const int vb = 2 * (j0_t + vv) - lo(dj);
#pragma unroll
        for (int s = 0; s < 1 + NT; ++s) {
          float acc = 0.0f;
          for (int a = ai; a <= bi; ++a)
            for (int b = aj; b <= bj; ++b) acc += st[s][(ub + a) * nj + vb + b];
          dst[s][e] += 0.0625f * acc;
        }
      }
    }
  }
  __syncwarp();
}

// ---- the pair recursion: stage 1 streamed through registers ----

template <int NT>
__device__ Pair<NT> pair_of(const Args& A, int a, int b) {
  const int h = A.h, r2 = h / 2, r3 = h / 4;
  const int plen = A.g0 * h * h + A.g1 * r2 * r2 + A.g2 * r3 * r3;
  Pair<NT> P;
  P.v1 = A.prof1 + (size_t)a * plen;
  P.v2 = A.prof2 + (size_t)b * plen;
  P.w2 = A.scales[0];
  P.b2 = A.scales[1];
  if constexpr (NT > 0) {   // the forward's scales hold four values
    P.two_w = 2.0f * A.scales[4];
    P.two_b = 2.0f * A.scales[5];
    for (int t = 0; t < NT; ++t) {
      P.tan[t] = (NT == 2) ? t : A.tsel;
      P.dv1[t] = A.dprof1 + ((size_t)a * 2 + P.tan[t]) * plen;
      P.dv2[t] = A.dprof2 + ((size_t)b * 2 + P.tan[t]) * plen;
    }
  }
  return P;
}

// Stage 1 of one warp task: the slab pair (di, dj) and (di, dj - h), which
// together are h columns wide (dj = 0: the one slab (di, 0)), rows [ua, ub)
// of their ni = h - |di| rows. Lane L owns absolute column p1_j = L of both
// (slab dj holds lanes [0, h - dj), slab dj - h the rest; the seam acts as a
// slab edge). The warp streams the rows top to bottom: the moment of row t
// enters conv layer 0 at step t, and layer l emits row t - l - 1 from the
// column sums of its input rows held in registers (cp, cc, and the new
// row's cn), so the last of the G0 layers emits row t - G0. Each entry sees
// the plain version's operations in its order: column sums (z + left) +
// right by shuffles, row sums (zc + up) + down, / 9, the dual activation
// (NT = 0) or its partials, and the 2 x 2 pool's (row parity, column
// parity) order, then one += into the ring. A
// task starting below row 0 (ua > 0, a split slab) starts G0 rows early, so
// that its window holds true rows by row ua, and pools only rows >= ua.
// With a bf16 state the window and the rows in flight are __nv_bfloat16
// (St), each op rounding; the pool sums them in fp32.
template <int ACT, int NT, int G0, bool BF16>
__device__ void stream_task(const Args& A, const Pair<NT>& P, const float* xa, const float* xb,
                            const Dest& D, int di, int dj, int ua, int ub, int lane) {
  static_assert(NT == 0 || !BF16, "the bf16 state is the forward's");
  using N = State<BF16>;
  using St = typename N::St;
  constexpr int NS = 1 + NT;
  const int h = A.h, c = A.c, r2 = h / 2;
  const int ni = span(h, di), i0 = lo(di);
  const float inv_c = A.scales[3];
  const bool active = lane < h;
  const int seam = h - dj;                    // first lane of slab dj - h
  const int dl = lane < seam ? dj : dj - h;   // this lane's slab: (di, dl)
  const bool has_left = active && lane >= 1 && lane != seam;
  const bool has_right = lane + 1 < h && lane + 1 != seam;

  // The pool's column target: dl even -> pooled slab dl / 2, the even lane
  // adding its own entry and its right neighbour's; dl odd -> floor(dl / 2)
  // from an even column, ceil from an odd one.
  const bool col_pair = (dl & 1) == 0;
  const int pj = (col_pair || (lane & 1) == 0) ? (dl >> 1) : ((dl + 1) >> 1);
  const int qc = (lane >> 1) - lo(pj);
  const int ncol = span(r2, pj);
  const bool col_ok = active && abs(pj) < r2 && qc >= 0 && qc < ncol &&
                      !(col_pair && (lane & 1));
  const int col_cum = cum(r2, pj);

  const St zero = N::put(0.0f);
  St cp[G0][NS], cc[G0][NS];
  float acc[NS];
#pragma unroll
  for (int l = 0; l < G0; ++l)
#pragma unroll
    for (int s = 0; s < NS; ++s) cp[l][s] = cc[l][s] = zero;
#pragma unroll
  for (int s = 0; s < NS; ++s) acc[s] = 0.0f;

  const int t0 = ua > G0 ? ua - G0 : 0;
  for (int t = t0; t < ub + G0; ++t) {
    St in[NS];
    in[0] = zero;
    if (active && t < ni) {
      const float* pa = xa + ((size_t)(i0 + t) * h + lane) * c;
      const float* pb = xb + ((size_t)(i0 + t + di) * h + lane + dl) * c;
      float m = 0.0f;
      for (int ch = 0; ch < c; ++ch) m = fmaf(__ldg(pa + ch), __ldg(pb + ch), m);
      in[0] = N::put(m * inv_c);
    }
#pragma unroll
    for (int s = 1; s < NS; ++s) in[s] = zero;   // the moment has no tangent

#pragma unroll
    for (int l = 0; l < G0; ++l) {
      const int u_in = t - l;     // the row entering layer l
      const bool real = u_in >= 0 && u_in < ni;
      St cn[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const St z = real ? in[s] : zero;
        const St left = N::shfl_up(z);
        const St right = N::shfl_down(z);
        const float zl = N::round(N::get(z) + (has_left ? N::get(left) : 0.0f));
        cn[s] = N::put(zl + (has_right ? N::get(right) : 0.0f));
      }
      const int u = u_in - 1;     // the row layer l emits
      if (u >= 0 && u < ni) {
        float sk[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const float up = N::round(N::get(cc[l][s]) + N::get(cp[l][s]));
          sk[s] = N::round(N::round(up + N::get(cn[s])) / 9.0f);
        }
        float v1 = 1.0f, v2 = 1.0f, dv1[NS], dv2[NS];
        const int q1 = l * h * h + (i0 + u) * h + lane;
        const int q2 = q1 + di * h + dl;
#pragma unroll
        for (int k = 0; k < NT; ++k) dv1[k] = dv2[k] = 0.0f;
        if (active) {
          v1 = N::round(__ldg(P.v1 + q1));
          v2 = N::round(__ldg(P.v2 + q2));
#pragma unroll
          for (int k = 0; k < NT; ++k) {
            dv1[k] = __ldg(P.dv1[k] + q1);
            dv2[k] = __ldg(P.dv2[k] + q2);
          }
        }
        if constexpr (NT == 0) {
          in[0] = N::put(dual_act<ACT>(N::round(N::round(P.w2 * sk[0]) + P.b2), v1, v2));
        } else {
          const Partials pa = dual_act_partials<ACT>(P.w2 * sk[0] + P.b2, v1, v2);
#pragma unroll
          for (int k = 0; k < NT; ++k) {
            const float du = P.w2 * sk[1 + k] + (P.tan[k] == 0 ? P.two_w * sk[0] : P.two_b);
            in[1 + k] = pa.tk * du + pa.tv1 * dv1[k] + pa.tv2 * dv2[k];
          }
          in[0] = pa.t;
        }
      }
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        cp[l][s] = cc[l][s];
        cc[l][s] = cn[s];
      }
    }

    // The last layer emitted row u: pool it into the ring.
    const int u = t - G0;
    if (u >= ua && u < ub) {
      const int R = i0 + u;       // its absolute row p1_i
      const bool both = (di & 1) == 0;   // di even: rows 2P and 2P + 1 feed one entry
      const int pi = (both || (R & 1) == 0) ? (di >> 1) : ((di + 1) >> 1);
      const int pr = (R >> 1) - lo(pi);
      const bool row_ok = abs(pi) < r2 && pr >= 0 && pr < span(r2, pi);
      const bool first = !both || (R & 1) == 0;
      const bool last = !both || (R & 1) == 1;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float nb = N::get(N::shfl_down(in[s]));
        if (first) acc[s] = 0.0f;
        acc[s] = acc[s] + N::get(in[s]);
        if (col_pair) acc[s] = acc[s] + nb;
      }
      if (last && row_ok && col_ok) {
        const int off = span(r2, pi) * col_cum + pr * ncol + qc;
#pragma unroll
        for (int s = 0; s < NS; ++s) D.row(s, pi)[off] += 0.0625f * acc[s];
      }
    }
  }
}

// One block per pair (a, b); with A.same, only b >= a, written to both
// (a, b) and (b, a). Stage 1 in registers (stream_task); stages 2 and 3 in
// shared memory, with one (h/2)^2 column-sum plane a warp; the GAP in
// float64. NT = 0 is the forward, NT = 1 or 2 the tangent mode; BF16 (the
// forward only) carries the pair state in bf16, with w2, b2 and the
// profiles rounded to bf16 too.
template <int ACT, int NT, int G0, bool BF16>
__device__ void tangent_recursion(const Args& A, float* smem, double* red) {
  constexpr int NS = 1 + NT;
  constexpr int W = kWarps;
  const int a = blockIdx.y, b = blockIdx.x;
  if (A.same && b < a) return;
  const int h = A.h, r2 = h / 2, r3 = h / 4, c = A.c;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nthreads = blockDim.x;

  // Shared memory: the stage-2 ring, stage 3, the warps' column-sum planes.
  float* ring = smem;
  float* buf3 = ring + (size_t)2 * NS * r2 * r2 * r2;
  float* tmp = buf3 + (size_t)NS * r3 * r3 * r3 * r3 + (size_t)warp * r2 * r2;
  const Dest to2{ring, r2, true, NS};
  const Dest to3{buf3, r3, false, NS};

  Pair<NT> P = pair_of<NT>(A, a, b);
  P.w2 = State<BF16>::round(P.w2);
  P.b2 = State<BF16>::round(P.b2);
  const float* xa = A.x1 + (size_t)a * h * h * c;
  const float* xb = A.x2 + (size_t)b * h * h * c;

  for (int e = threadIdx.x; e < NS * r3 * r3 * r3 * r3; e += nthreads) buf3[e] = 0.0f;

  // ---- stage 1 (resolution h), pooling into the ring ----
  for (int di = -(h - 1); di < h; ++di) {
    const int m = (di - 1) >> 1;     // for odd di: the pooled rows m, m + 1
    if (di & 1) {
      if (m + 1 <= r2 - 1) {           // row m + 1 first receives from di = 2m + 1
        for (int s = 0; s < NS; ++s) {
          float* row = to2.row(s, m + 1);
          for (int e = threadIdx.x; e < r2 * r2 * r2; e += nthreads) row[e] = 0.0f;
        }
      }
      __syncthreads();
    }
    const int ni = span(h, di);
    for (int wave = 0; wave < 3; ++wave) {
      // The wave's slab pairs dj in [0, h) (h / 2, h / 4, h / 4 of them),
      // each split into row parts of an even length so that every warp
      // has a task.
      const int pairs = wave == 0 ? h / 2 : h / 4;
      const int parts = pairs >= W ? 1 : W / pairs;
      const int rows = ((ni + parts - 1) / parts + 1) & ~1;
      int rank = 0;
      for (int dj = 0; dj < h; ++dj) {
        if (wave_of(dj) != wave) continue;
        for (int k = 0; k < parts; ++k) {
          if (rank++ % W != warp || k * rows >= ni) continue;
          stream_task<ACT, NT, G0, BF16>(A, P, xa, xb, to2, di, dj, k * rows,
                                   min(ni, (k + 1) * rows), lane);
        }
      }
      __syncthreads();
    }

    // ---- stage 2 (h/2): pooled row m is complete ----
    if ((di & 1) && m > -r2) {
      for (int wave = 0; wave < 3; ++wave) {
        int rank = 0;
        for (int pj = -(r2 - 1); pj < r2; ++pj) {
          if (wave_of(pj) != wave) continue;
          if (rank++ % W != warp) continue;
          float* ps[NS];
          const int off = span(r2, m) * cum(r2, pj);
#pragma unroll
          for (int s = 0; s < NS; ++s) ps[s] = to2.row(s, m) + off;
          slab_convs<ACT, NT, BF16>(A, P, ps, tmp, r2, m, pj, A.g0, A.g1, lane);
          slab_pool<NT>(ps, r2, m, pj, to3, lane);
        }
        __syncthreads();
      }
    }
  }

  // ---- stage 3 (h/4) and the GAP, in float64 ----
  double acc[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) acc[s] = 0.0;
  int rank = 0;
  for (int qi = -(r3 - 1); qi < r3; ++qi) {
    for (int qj = -(r3 - 1); qj < r3; ++qj) {
      if (rank++ % W != warp) continue;
      float* ps[NS];
      const int ni = span(r3, qi), nj = span(r3, qj);
      const size_t off = (size_t)cum(r3, qi) * r3 * r3 + (size_t)ni * cum(r3, qj);
#pragma unroll
      for (int s = 0; s < NS; ++s) ps[s] = buf3 + (size_t)s * r3 * r3 * r3 * r3 + off;
      slab_convs<ACT, NT, BF16>(A, P, ps, tmp, r3, qi, qj, A.g0 + A.g1, A.g2, lane);
      for (int e = lane; e < ni * nj; e += 32) {
#pragma unroll
        for (int s = 0; s < NS; ++s) acc[s] += (double)ps[s][e];
      }
    }
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    double v = acc[s];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp * kMaxStates + s] = v;
  }
  __syncthreads();
  if (threadIdx.x < NS) {
    double sum = 0.0;
    for (int wi = 0; wi < W; ++wi) sum += red[wi * kMaxStates + threadIdx.x];
    const double count = (double)r3 * r3 * r3 * r3;
    const float v = (float)(sum * (double)A.scales[2] / count);
    A.out[((size_t)threadIdx.x * A.n1 + a) * A.n2 + b] = v;
    if (A.same) A.out[((size_t)threadIdx.x * A.n1 + b) * A.n2 + a] = v;
  }
}

// The forward; BF16 = true is its bf16 pair-state variant (the JAX
// package's myrtle_gram(dtype=bf16)), with the fp32 variant's shared memory
// and launch bounds.
template <int ACT, int G0, bool BF16>
__global__ void __launch_bounds__(32 * kWarps, kForwardBlocks)
    myrtle_gram_kernel(Args A) {
  extern __shared__ float smem[];
  __shared__ double red[kWarps * kMaxStates];
  tangent_recursion<ACT, 0, G0, BF16>(A, smem, red);
}

template <int ACT, int NT, int G0>
__global__ void __launch_bounds__(32 * kWarps, 1) myrtle_gram_tangents_kernel(Args A) {
  extern __shared__ float smem[];
  __shared__ double red[kWarps * kMaxStates];
  tangent_recursion<ACT, NT, G0, false>(A, smem, red);
}

size_t smem_bytes(int h, int ns) {
  const size_t r2 = h / 2, r3 = h / 4;
  return sizeof(float) * (2 * ns * r2 * r2 * r2 + ns * r3 * r3 * r3 * r3 +
                          (size_t)kWarps * r2 * r2);
}

template <int ACT, int NT, int G0, bool BF16>
cudaError_t launch(const Args& A, cudaStream_t stream) {
  void (*kernel)(Args);
  if constexpr (NT == 0) kernel = myrtle_gram_kernel<ACT, G0, BF16>;
  else kernel = myrtle_gram_tangents_kernel<ACT, NT, G0>;
  const size_t smem = smem_bytes(A.h, 1 + NT);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(A.n2, A.n1);
  kernel<<<grid, 32 * kWarps, smem, stream>>>(A);
  return cudaGetLastError();
}

template <int NT, bool BF16 = false>
cudaError_t launch_act_g0(const Args& A, int act, cudaStream_t stream) {
  static_assert(NT == 0 || !BF16, "the bf16 state is the forward's");
  if (act != kRelu && act != kErf) return cudaErrorInvalidValue;
  switch (A.g0) {
    case 1:
      return act == kRelu ? launch<kRelu, NT, 1, BF16>(A, stream)
                          : launch<kErf, NT, 1, BF16>(A, stream);
    case 2:
      return act == kRelu ? launch<kRelu, NT, 2, BF16>(A, stream)
                          : launch<kErf, NT, 2, BF16>(A, stream);
    case 3:
      return act == kRelu ? launch<kRelu, NT, 3, BF16>(A, stream)
                          : launch<kErf, NT, 3, BF16>(A, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool valid(const Args& A) {
  return A.n1 >= 1 && A.n2 >= 1 && A.n1 <= 65535 && (A.h == 8 || A.h == 16 || A.h == 32) &&
         A.c >= 1 && A.g0 >= 1 && A.g0 <= 3 && (!A.same || A.n1 == A.n2);
}

}  // namespace

// x1 [n1, h, h, c], x2 [n2, h, h, c], prof1 [n1, P], prof2 [n2, P] (the
// packed per-layer variance profiles, P = g0 h^2 + g1 (h/2)^2 + g2 (h/4)^2),
// scales [w^2, b^2, last^2, 1/c], out [n1, n2]: fp32, contiguous, on the
// device of `stream`. h is 8, 16 or 32; (g0, g1, g2): convs per pooling
// group, g0 1 to 3; act: 0 relu, 1 erf; same = 1 says x2 is x1 (n1 == n2):
// each pair b >= a runs once and is written to (a, b) and (b, a). Returns
// the CUDA error code of the launch (0 on success); does not synchronize.
extern "C" int snngp_myrtle_gram_f32(const float* x1, const float* x2, const float* prof1,
                                     const float* prof2, const float* scales, float* out,
                                     int n1, int n2, int h, int c, int g0, int g1, int g2,
                                     int act, int same, void* stream) {
  const Args A{x1, x2, prof1, prof2, nullptr, nullptr, scales, out,
               n1, n2, h, c, g0, g1, g2, 0, same ? 1 : 0};
  if (!valid(A)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_act_g0<0>(A, act, static_cast<cudaStream_t>(stream)));
}

// As snngp_myrtle_gram_f32, with the pair state in bf16 (inputs, scales and
// out fp32, as there): stage 1's registers __nv_bfloat16, each op of the
// recursion, w2, b2, the profiles and the dual activation's result rounded
// to bf16, the pools summed in fp32 and rounded once per pooled entry, the
// GAP in float64.
extern "C" int snngp_myrtle_gram_bf16(const float* x1, const float* x2, const float* prof1,
                                      const float* prof2, const float* scales, float* out,
                                      int n1, int n2, int h, int c, int g0, int g1, int g2,
                                      int act, int same, void* stream) {
  const Args A{x1, x2, prof1, prof2, nullptr, nullptr, scales, out,
               n1, n2, h, c, g0, g1, g2, 0, same ? 1 : 0};
  if (!valid(A)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_act_g0<0, true>(A, act, static_cast<cudaStream_t>(stream)));
}

// As snngp_myrtle_gram_f32, plus dprof1 [n1, 2, P] and dprof2 [n2, 2, P]
// (the profiles' tangents in w_std, b_std), scales [w^2, b^2, last^2, 1/c,
// w, b], and mode 0 (dK/dw), 1 (dK/db) or 2 (both); out is [states, n1, n2]
// with states = 2 or 3: K, then the tangents carried.
extern "C" int snngp_myrtle_gram_tangents_f32(const float* x1, const float* x2,
                                              const float* prof1, const float* prof2,
                                              const float* dprof1, const float* dprof2,
                                              const float* scales, float* out, int n1,
                                              int n2, int h, int c, int g0, int g1, int g2,
                                              int act, int mode, int same, void* stream) {
  const Args A{x1, x2, prof1, prof2, dprof1, dprof2, scales, out,
               n1, n2, h, c, g0, g1, g2, mode == 1 ? 1 : 0, same ? 1 : 0};
  if (!valid(A) || mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(mode == 2 ? launch_act_g0<2>(A, act, s) : launch_act_g0<1>(A, act, s));
}

// cudaGetErrorString for the wrapper's exception message.
extern "C" const char* snngp_myrtle_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
