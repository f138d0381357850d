"""The yardstick's arithmetic: the published peaks of one NVIDIA H100 SXM,
the operations and bytes of the port's kernels counted from their shapes,
and the algorithm's work that the whole-step shares (``step_mfu``,
``serve_mfu``) divide by.

Frozen copies of ``chip_smoke.py``'s ``_dual_act_ops``, ``_pairs``,
``k1_ops``, ``k2_ops``, ``k7_ops`` and ``bound_ms`` (the benchmark imports
nothing of the smoke), with the Myrtle pooling groups written out here.
Operations count an FMA as 2 and every other arithmetic op, compare and
select as 1; ``acosf``, ``asinf``, ``sqrtf``, ``rsqrtf`` and an IEEE divide
count 1 each, so each count is a floor and each bound a least time.
"""

from __future__ import annotations

import re

# NVIDIA's H100 SXM data sheet (dense, at the 700 W limit).
H100_BYTES_PER_S = 3.35e12
H100_FP32_PER_S = 67e12
H100_FP64_PER_S = 34e12
H100_BF16_PER_S = 2 * H100_FP32_PER_S   # packed bf16 on the CUDA cores

# Convs per pooling group of Myrtle-5 / -7 / -10 (Shankar et al., 2020).
MYRTLE_GROUPS = {5: (1, 1, 1), 7: (2, 2, 1), 10: (3, 3, 2)}

# The device kernels a work item names, by the key its launches carry, and
# the pattern of the profiler's kernel name. A word boundary keeps
# ``gram_kernel`` from matching ``myrtle_gram_kernel`` or ``conv_gram_kernel``.
KERNELS = {
    "k1": re.compile(r"\bgram_kernel\b"),
    "k2": re.compile(r"\bgram_grads_kernel\b"),
    "k7_fwd": re.compile(r"\bmyrtle_gram_kernel\b"),
    "k7_wb": re.compile(r"\bmyrtle_gram_tangents_kernel\b"),
}


def kernel_key(name):
    """The work key of a device kernel's profiler name, or None."""
    for key, pattern in KERNELS.items():
        if pattern.search(name):
            return key
    return None


def dual_act_ops(act, partials):
    """fp32 operations of one dual activation (or of its partials with the
    tangents' sums, as K2 computes them), counted from csrc/gram.cu."""
    if act == "relu":
        return 25 if partials else 15
    return 24 if partials else 7


def pairs(n1, n2, same):
    """Pairs the function needs: n (n + 1) / 2 for K(x, x), else n1 n2."""
    return n1 * (n1 + 1) // 2 if same else n1 * n2


def k1_ops(n1, n2, d, depth, act, mode, same):
    """fp32 operations of K1 on these shapes."""
    a = dual_act_ops(act, False)
    per = 2 * d + 1 + (depth * (2 + a) + 1 if mode == "mlp"
                       else 2 + depth * (a + 3) + a + 1)
    return pairs(n1, n2, same) * per


def k2_ops(n1, n2, d, depth, act, mode, same):
    """(fp32, fp64) operations of K2: the fp64 ones are the contraction's
    three FMAs per pair and, for K(x, x), the fold g[i, j] + g[j, i]."""
    p = dual_act_ops(act, True)
    per = 2 * d + 1 + (depth * (11 + p) + 3 if mode == "mlp"
                       else 3 + depth * (p + 14) + p + 7)
    folds = n1 * (n1 - 1) // 2 if same else 0
    return pairs(n1, n2, same) * per, pairs(n1, n2, same) * 6 + folds


def k7_ops(n1, n2, h, c, depth, act, same, tangents=0):
    """(fp32, fp64) operations of K7, or of its tangent mode carrying
    ``tangents`` tangents, counted from csrc/myrtle_gram.cu."""
    g0, g1, g2 = MYRTLE_GROUPS[depth]
    ns = 1 + tangents
    act_ops = dual_act_ops(act, tangents > 0)
    conv = 5 * ns + 2 + act_ops + 8 * tangents
    e1, e2, e3 = h ** 4, (h // 2) ** 4, (h // 4) ** 4
    per = e1 * (2 * c + 1) + 2 * ns * (e1 + e2) + conv * (g0 * e1 + g1 * e2 + g2 * e3)
    p = pairs(n1, n2, same)
    return p * per, p * ns * e3


def least_s(nbytes, fp32_ops, fp64_ops=0, bf16_ops=0):
    """Least time on an H100 SXM: the larger of the bytes over 3.35 TB/s
    and the operations, each type at its own peak (``bound_ms`` of the
    smoke, in seconds)."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = (fp32_ops / H100_FP32_PER_S + fp64_ops / H100_FP64_PER_S
             + bf16_ops / H100_BF16_PER_S)
    return max(t_bytes, t_ops)


# -- bytes, each input read once and each output written once ------------------

def _tiles(n1, n2, same, tile=64):
    """K1 / K2's blocks (csrc/gram.cu ``launch_blocks``): 64 x 64 output
    tiles, the lower triangle's for K(x, x)."""
    t1, t2 = -(-n1 // tile), -(-n2 // tile)
    return t1 * (t1 + 1) // 2 if same else t1 * t2


def k1_bytes(n1, n2, d, depth, same):
    """x1, x2, the variance rows [depth + 1, n], the four scales, the Gram."""
    rows = n1 * d + (depth + 1) * n1
    if not same:
        rows += n2 * d + (depth + 1) * n2
    return 4 * (rows + 4 + n1 * n2)


def k2_bytes(n1, n2, d, depth, same):
    """K1's inputs and the variance tangents [depth + 1, 2, n], seven
    scales, the cotangent g [n1, n2], and three fp64 partial sums a block."""
    rows = n1 * d + 3 * (depth + 1) * n1
    if not same:
        rows += n2 * d + 3 * (depth + 1) * n2
    return 4 * (rows + 7 + n1 * n2) + 8 * 3 * _tiles(n1, n2, same)


def myrtle_profile_len(h, depth):
    """Floats of one image's packed variance profile: r^2 for each conv."""
    return sum((h >> stage) ** 2 * reps
               for stage, reps in enumerate(MYRTLE_GROUPS[depth]))


def k7_bytes(n1, n2, h, c, depth, same, tangents=0):
    """The images, their profiles (and two tangent rows each with
    tangents), the scales, and the Gram (and its tangents)."""
    p = myrtle_profile_len(h, depth) * (1 + (2 if tangents else 0))
    rows = n1 * (h * h * c + p)
    if not same:
        rows += n2 * (h * h * c + p)
    return 4 * (rows + (6 if tangents else 4) + (1 + tangents) * n1 * n2)


# -- launches with their least times ---------------------------------------------

def k1_launch(n1, n2, d, depth, act="relu", mode="mlp", same=False):
    return least_s(k1_bytes(n1, n2, d, depth, same),
                   k1_ops(n1, n2, d, depth, act, mode, same))


def k2_launch(n1, n2, d, depth, act="relu", mode="mlp", same=False):
    return least_s(k2_bytes(n1, n2, d, depth, same),
                   *k2_ops(n1, n2, d, depth, act, mode, same))


def k7_launch(n1, n2, h, c, depth, act="relu", same=False, tangents=0):
    return least_s(k7_bytes(n1, n2, h, c, depth, same, tangents),
                   *k7_ops(n1, n2, h, c, depth, act, same, tangents))


# -- the algorithm's work beyond the kernels (fp32 flops, an FMA is 2) -------------

def cholesky_flops(n):
    """One Cholesky factorization of an n x n matrix: n^3 / 3."""
    return n ** 3 / 3


def inverse_from_factor_flops(n):
    """A^-1 from A's Cholesky factor (L^-1, then L^-T L^-1): 2 n^3 / 3. The
    ML-II backward needs it: the log-determinant's gradient is A^-1."""
    return 2 * n ** 3 / 3


def trsm_flops(n, m):
    """A triangular solve of an n x n factor against m right-hand sides:
    n^2 m."""
    return n * n * m


def gemv_flops(n, m):
    """An [m, n] product with one vector, or m dot products of length n."""
    return 2 * n * m
