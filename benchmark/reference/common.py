"""Arithmetic shared by the plain references: the precisions they run in,
the positive bijector, objax's Adam and the relu dual activation with its
analytic partials.

A reference runs in float64 (``Arith("float64")``). Its control runs the
same code in the precision just below the configurations' (float32 with
TF32 off): ``Arith("tf32")`` computes in float32 and rounds the operands of
every product (matrix products, the Cholesky factor's trailing updates and
the triangular solves' block updates, and a convolution's input) to TF32's
10-bit mantissa, as a TF32 tensor-core product or convolution would. It
imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

F32_EPS = torch.finfo(torch.float32).eps   # the configurations' working precision


def round_tf32(x):
    """``x`` (float32) rounded to TF32 (10 mantissa bits, nearest even);
    the value flows through unchanged in the backward."""
    bits = x.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0x0FFF + lsb) & -8192).view(torch.float32)
    return x + (rounded - x).detach()


class Arith:
    """float64; float32, the configurations' own precision (a witness of
    what plain arithmetic at that precision gives); or float32 with TF32
    products (the control)."""

    def __init__(self, precision="float64", block=256):
        if precision not in ("float64", "float32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.block = block

    @property
    def tf32(self):
        return self.precision == "tf32"

    def op(self, x):
        """An operand of a product."""
        return round_tf32(x) if self.tf32 else x

    def mm(self, a, b):
        return self.op(a) @ self.op(b)

    def chol(self, a):
        """Lower Cholesky factor of the symmetrized ``a`` ([..., n, n]);
        NaN where the factorization fails. The control factors by blocks:
        each diagonal block in float32, the trailing update a TF32 product."""
        sym = (a + a.mT) * 0.5
        if not self.tf32:
            chol, info = torch.linalg.cholesky_ex(sym)
            return chol + torch.where(info > 0, math.nan, 0.0)[..., None, None]
        n, bs = sym.shape[-1], self.block
        cols = []
        rest = sym
        for k in range(0, n, bs):
            kb = min(bs, n - k)
            a11, a21, a22 = rest[..., :kb, :kb], rest[..., kb:, :kb], rest[..., kb:, kb:]
            l11, info = torch.linalg.cholesky_ex(a11)
            l11 = l11 + torch.where(info > 0, math.nan, 0.0)[..., None, None]
            l21 = torch.linalg.solve_triangular(l11.mT, a21, upper=True, left=False)
            above = sym.new_zeros(*sym.shape[:-2], k, kb)
            cols.append(torch.cat([above, l11, l21], dim=-2))
            rest = a22 - self.mm(l21, l21.mT)
        return torch.cat(cols, dim=-1)

    def trsm(self, chol, b, trans=False):
        """L^-1 b (or L^-T b with ``trans``) for a lower factor L; the
        control solves by blocks, each block update a TF32 product."""
        if not self.tf32:
            mat = chol.mT if trans else chol
            return torch.linalg.solve_triangular(mat, b, upper=trans)
        n, bs = chol.shape[-1], self.block
        starts = list(range(0, n, bs))
        order = reversed(starts) if trans else starts
        parts = {}
        for k in order:
            kb = min(bs, n - k)
            rhs = b[..., k:k + kb, :]
            if trans:   # rows below k are done: x_k = L_kk^-T (b_k - L[k:, k]^T x_below)
                below = [(j, parts[j]) for j in parts if j > k]
                for j, xj in below:
                    rhs = rhs - self.mm(chol[..., j:j + xj.shape[-2], k:k + kb].mT, xj)
                parts[k] = torch.linalg.solve_triangular(chol[..., k:k + kb, k:k + kb].mT,
                                                         rhs, upper=True)
            else:
                for j, xj in parts.items():
                    rhs = rhs - self.mm(chol[..., k:k + kb, j:j + xj.shape[-2]], xj)
                parts[k] = torch.linalg.solve_triangular(chol[..., k:k + kb, k:k + kb],
                                                         rhs, upper=False)
        return torch.cat([parts[k] for k in starts], dim=-2)


def softplus(raw):
    return torch.nn.functional.softplus(raw)


def softplus_inv(value):
    """The raw parameter whose softplus is ``value`` (the identity from 20
    up, where softplus(x) == x in float32)."""
    value = float(value)
    return value if value >= 20.0 else math.log(math.expm1(value))


class Adam:
    """objax's Adam: lr_t = lr sqrt(1 - b2^t) / (1 - b1^t); m += (1 - b1)
    (g - m); v += (1 - b2) (g^2 - v); p -= lr_t m / (sqrt(v) + eps), where
    ``keep`` (a set of names) lists the leaves that move; every moment
    updates."""

    def __init__(self, names, keep, beta1=0.9, beta2=0.999, eps=1e-8):
        self.names, self.keep = list(names), set(keep)
        self.b1, self.b2, self.eps = beta1, beta2, eps
        self.t = 0
        self.m, self.v = {}, {}

    def update(self, params, grads, lr):
        self.t += 1
        lr_t = lr * math.sqrt(1.0 - self.b2 ** self.t) / (1.0 - self.b1 ** self.t)
        out = {}
        for n in self.names:
            g = grads[n]
            m = self.m.get(n, torch.zeros_like(g))
            v = self.v.get(n, torch.zeros_like(g))
            self.m[n] = m + (1.0 - self.b1) * (g - m)
            self.v[n] = v + (1.0 - self.b2) * (g * g - v)
            step = lr_t * self.m[n] / (torch.sqrt(self.v[n]) + self.eps)
            out[n] = params[n] - step if n in self.keep else params[n]
        return out


def relu_dual(k, v1, v2, dk=None, dv1=None, dv2=None):
    """The arccos kernel T(k, v1, v2) = (s sin t + (pi - t) k) / (2 pi),
    s = sqrt(v1 v2), cos t = k / s, and with tangents (lists of dk, dv1,
    dv2) its forward-mode tangents from the analytic partials dT/dk =
    (pi - t) / (2 pi), dT/dv1 = sin t v2 / (4 pi s), dT/dv2 = sin t v1 /
    (4 pi s), which stay finite where c = 1."""
    s = torch.sqrt(torch.clamp(v1 * v2, min=1e-300 if k.dtype == torch.float64 else 1e-30))
    c = torch.clamp(k / s, -1.0, 1.0)
    theta = torch.acos(c)
    sin_t = torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
    t = (s * sin_t + (math.pi - theta) * k) * (0.5 / math.pi)
    if dk is None:
        return t, None
    t_k = (math.pi - theta) * (0.5 / math.pi)
    q = sin_t / s * (0.25 / math.pi)
    dt = [t_k * a + q * v2 * b + q * v1 * c_ for a, b, c_ in zip(dk, dv1, dv2)]
    return t, dt


def leaf_gaps(got, want, skip=()):
    """Each leaf's gap between its norms on the two sides, over the larger
    of the leaf's reference norm and the median leaf's; leaves in ``skip``
    are left out."""
    norms = {n: float(torch.as_tensor(want[n], dtype=torch.float64).norm())
             for n in want if n not in skip}
    if not norms:
        return {}
    median = float(torch.tensor(sorted(norms.values())).median())
    gaps = {}
    for n, ref in norms.items():
        mine = float(torch.as_tensor(got[n], dtype=torch.float64).norm())
        scale = max(ref, median)
        gaps[n] = abs(mine - ref) / scale if scale > 0 else (0.0 if mine == 0 else math.inf)
    return gaps


def worst_leaf_gap(got, want, skip=()):
    """The largest of ``leaf_gaps`` and its leaf (None where no leaf
    counts); NaN counts as worst."""
    worst, leaf = 0.0, None
    for n, gap in leaf_gaps(got, want, skip).items():
        if not gap <= worst:
            worst, leaf = gap, n
    return worst, leaf
