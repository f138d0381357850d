"""Dense linear algebra core: Cholesky-everything (counterpart of
``snngp/ops/linalg.py``). On the card these calls go to cuSOLVER/cuBLAS, as
the JAX package left the factorization to XLA.

Two differences from ``torch.linalg`` that the port hides, so that it
behaves like the reference:

- ``jnp.linalg.cholesky`` symmetrizes its input, ``(A + A^T) / 2``;
  ``torch.linalg.cholesky`` reads only the lower triangle. :func:`cholesky`
  symmetrizes at every site where the JAX package calls
  ``jnp.linalg.cholesky``.
- JAX returns a factor whose lower triangle is all NaN when the
  factorization fails (and the CLI then logs a NaN NLL); torch raises.
  :func:`cholesky` uses ``cholesky_ex`` and sets the factor's diagonal to
  NaN where ``info > 0``, without a host sync: every solve, quadratic form
  and log-determinant taken from it is then NaN, as in JAX. Outside autograd
  that is done in place, for O(N) work instead of a pass over the N x N
  factor; under autograd, on a copy of the factor.

The marginal likelihoods (:func:`mvn_logpdf`, and
:func:`snngp_torch.ops.mvt.multivariate_t_logpdf`) are differentiable
through all of these. For one vector against one matrix factored by
:func:`cholesky` they take (q, log det S) from :func:`quad_logdet`, whose
backward is the closed form dq/dS = -alpha alpha^T, dlog det S/dS = S^-1
(alpha = S^-1 r), with S^-1 from the factor in 2 N^3 / 3 flops
(:func:`inverse_from_factor`) where autograd through the factor takes
4 N^3 (a GEMM and two triangular solves against N right-hand sides).

The sparse variational model's guards (:func:`inv_psd`,
:func:`psd_safety_lift`, :func:`pinv_psd_eigh`) keep the JAX package's
reads: ``jnp.linalg.eigh`` / ``eigvalsh`` symmetrize their input (as
``cholesky`` does), ``torch.linalg.eigh`` reads one triangle, so the port
symmetrizes first; ``cho_factor(lower=True)`` reads the lower triangle, as
``torch.linalg.cholesky`` does.

``gp_predict`` regularizes with ``diag_reg * mean(diag(K)) * I`` — the
*relative* scaling of neural_tangents' ``gradient_descent_mse_ensemble``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from snngp_torch.utils.profiling import span

__all__ = [
    "jitter",
    "add_jitter",
    "add_diag_reg",
    "logdet",
    "trace",
    "split_kernel",
    "cholesky",
    "chol_solve",
    "chol_logdet",
    "chol_quad_form",
    "chol_append",
    "solve_psd",
    "gp_predict",
    "mvn_logpdf",
    "quad_logdet",
    "inverse_from_factor",
    "BACKWARDS",
    "inv_psd",
    "psd_safety_lift",
    "pinv_psd_eigh",
]


def _add_to_diagonal(mat: torch.Tensor, value) -> torch.Tensor:
    """mat + value * I as one copy plus an O(N) update (no N x N identity)."""
    out = mat.clone()
    out.diagonal(dim1=-2, dim2=-1).add_(value)
    return out


def _diag_reg_value(mat: torch.Tensor, diag_reg):
    """diag_reg * mean(diag(K)): the regularizer :func:`add_diag_reg` adds."""
    scale = torch.diagonal(mat, dim1=-2, dim2=-1).sum(-1) / mat.shape[-1]
    return (diag_reg * scale)[..., None]


def jitter(num: int, eps=1e-6, dtype=torch.float32) -> torch.Tensor:
    """eps * I (spax/utils.py:26-27)."""
    return eps * torch.eye(num, dtype=dtype)


def add_jitter(mat: torch.Tensor, eps=1e-6) -> torch.Tensor:
    return _add_to_diagonal(mat, eps)


def add_diag_reg(mat: torch.Tensor, diag_reg) -> torch.Tensor:
    """K + diag_reg * mean(diag(K)) * I — neural_tangents' relative diag_reg."""
    return _add_to_diagonal(mat, _diag_reg_value(mat, diag_reg))


def _add_diag_reg_(mat: torch.Tensor, diag_reg) -> torch.Tensor:
    """:func:`add_diag_reg` in ``mat``'s own buffer (the memory-lean fit's
    step: no N x N copy); the same values bit for bit."""
    mat.diagonal(dim1=-2, dim2=-1).add_(_diag_reg_value(mat, diag_reg))
    return mat


def logdet(mat: torch.Tensor) -> torch.Tensor:
    """Summed log-determinant over leading batch dims, sign x log|det| from
    the LU-based ``slogdet`` (spax/utils.py:38-40)."""
    sign, abslogdet = torch.linalg.slogdet(mat)
    return torch.sum(sign * abslogdet)


def trace(mat: torch.Tensor) -> torch.Tensor:
    """Summed trace over leading batch dims (spax/utils.py:43-44)."""
    return torch.sum(torch.diagonal(mat, dim1=-2, dim2=-1))


def split_kernel(kernel: torch.Tensor, num_11: int):
    """2 x 2 block split (spax/utils.py:30-35): (K11, K12, K21, K22)."""
    return (kernel[:num_11, :num_11], kernel[:num_11, num_11:],
            kernel[num_11:, :num_11], kernel[num_11:, num_11:])


def cholesky(mat: torch.Tensor) -> torch.Tensor:
    """Lower factor of the symmetrized ``mat``; NaN on the diagonal where it
    is not PD, so everything solved with it is NaN (``jnp.linalg.cholesky``
    semantics downstream).

    When autograd records the factorization it has saved the factor for its
    backward, so the marker goes onto a copy (one N x N pass); otherwise, as
    under ``inference_mode`` where serving runs, onto the factor itself."""
    sym = (mat + mat.mT).mul_(0.5)      # == (A + A^T) / 2 bitwise
    return _nan_where_failed(*torch.linalg.cholesky_ex(sym))


def _nan_where_failed(chol: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """The factor with NaN on its diagonal where ``cholesky_ex`` failed
    (``info > 0``); on a copy when autograd saved the factor."""
    if chol.requires_grad:
        chol = chol.clone()
    nan_if_failed = torch.where(info > 0, float("nan"), 0.0).to(chol.dtype)
    chol.diagonal(dim1=-2, dim2=-1).add_(nan_if_failed[..., None])
    return chol


def chol_logdet(chol: torch.Tensor) -> torch.Tensor:
    """log det A = 2 sum log diag(L)."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)


def chol_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given the lower Cholesky factor of A (b is [n, k])."""
    return torch.cholesky_solve(b, chol, upper=False)


def chol_quad_form(chol: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y^T A^{-1} y via one triangular solve (y is [n] or [n, k])."""
    rhs = y[:, None] if y.ndim == 1 else y
    alpha = torch.linalg.solve_triangular(chol, rhs, upper=False)
    if y.ndim == 1:
        return torch.sum(alpha * alpha)
    return torch.sum(alpha * alpha, dim=-2)


def chol_append(chol: torch.Tensor, k_nb: torch.Tensor, k_bb: torch.Tensor,
                lower: bool = True) -> torch.Tensor:
    """Extend a Cholesky factor by m new rows / columns in O(n^2 m)
    (``snngp/ops/linalg.py:119``).

    Given the factor of ``A`` [n, n] and the blocks of the bordered matrix
    ``[[A, k_nb], [k_nb^T, k_bb]]`` (``k_nb`` [n, m], ``k_bb`` [m, m], already
    regularized), returns the factor of the bordered matrix without
    refactorizing the n x n block. ``lower=True`` extends L (A = L L^T);
    ``lower=False`` extends the upper U (A = U^T U) of a memory-lean state.
    The Schur complement is factored by :func:`cholesky`, so a bordered
    matrix that is not PD gives NaN on the new block's diagonal."""
    m = k_bb.shape[-1]
    if lower:
        l21 = torch.linalg.solve_triangular(chol, k_nb, upper=False).mT    # [m, n]
        l22 = cholesky(k_bb - l21 @ l21.mT)
        top = torch.cat([chol, chol.new_zeros(chol.shape[0], m)], dim=1)
        return torch.cat([top, torch.cat([l21, l22], dim=1)])
    # U^T u12 = k_nb: a lower solve on U^T.
    u12 = torch.linalg.solve_triangular(chol.mT, k_nb, upper=False)        # [n, m]
    u22 = cholesky(k_bb - u12.mT @ u12).mT
    top = torch.cat([chol, u12], dim=1)
    return torch.cat([top, torch.cat([chol.new_zeros(m, chol.shape[0]), u22], dim=1)])


def solve_psd(mat: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """PSD solve A^{-1} b through a Cholesky factor of A's lower triangle
    (``cho_factor(lower=True)``, which reads that triangle, as
    ``torch.linalg.cholesky`` does)."""
    return torch.cholesky_solve(b, torch.linalg.cholesky(mat), upper=False)


def gp_predict(
    kernel_fn,
    x_train: torch.Tensor,
    y_train: torch.Tensor,
    x_test: torch.Tensor,
    diag_reg=1e-6,
    compute_cov: bool = True,
    chol_fn=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Exact NNGP posterior: mean = K*^T (K + r I)^-1 y,
    cov = K** - K*^T (K + r I)^-1 K*, with the trace-relative ``diag_reg``.
    ``chol_fn`` swaps in another factorization of the train Gram (a blocked
    or distributed one, :mod:`snngp_torch.parallel.cholesky`)."""
    k_dd = kernel_fn(x_train, x_train, get="nngp")
    k_td = kernel_fn(x_test, x_train, get="nngp")
    chol = (chol_fn or cholesky)(add_diag_reg(k_dd, diag_reg))
    mean = k_td @ chol_solve(chol, y_train)
    if not compute_cov:
        return mean, None
    k_tt = kernel_fn(x_test, x_test, get="nngp")
    v = torch.linalg.solve_triangular(chol, k_td.T, upper=False)
    cov = k_tt - v.T @ v
    return mean, cov


def mvn_logpdf(y: torch.Tensor, cov: torch.Tensor, chol_fn=None) -> torch.Tensor:
    """Zero-mean multivariate normal log-density via one Cholesky: the
    log-determinant from the factor's diagonal, the quadratic form from one
    triangular solve. ``chol_fn`` swaps in another factorization. One
    vector against one matrix without a ``chol_fn`` goes through
    :func:`quad_logdet` (the same value, the closed-form backward)."""
    n = y.shape[-1]
    if chol_fn is None and y.ndim == 1 and cov.ndim == 2:
        quad, logdet_cov = quad_logdet(cov, y)
    else:
        chol = (chol_fn or cholesky)(cov)
        quad, logdet_cov = chol_quad_form(chol, y), chol_logdet(chol)
    return -0.5 * (quad + logdet_cov + n * math.log(2.0 * math.pi))


# Closed-form backwards taken by :func:`quad_logdet`, as ``ops.gram.LAUNCHES``
# counts kernel launches.
BACKWARDS = {"marginal": 0}

# Rows and columns of the blocks :func:`inverse_from_factor` works in: 256
# and 1,024 ran 2-4% slower at N = 10,000 on an H100.
_BLOCK = 512


def _diagonal_inverses(chol: torch.Tensor, block: int):
    """L_kk^-1 of the factor's diagonal blocks, in order: one batched
    triangular solve against the identity for the whole blocks, one for a
    ragged last block."""
    n = chol.shape[-1]
    whole = n // block * block
    invs = []
    if whole:
        diag = torch.stack([chol[s:s + block, s:s + block] for s in range(0, whole, block)])
        eye = torch.eye(block, dtype=chol.dtype, device=chol.device).expand_as(diag)
        invs += torch.linalg.solve_triangular(diag, eye, upper=False).unbind(0)
    if whole < n:
        eye = torch.eye(n - whole, dtype=chol.dtype, device=chol.device)
        invs.append(torch.linalg.solve_triangular(chol[whole:, whole:], eye, upper=False))
    return invs


def inverse_from_factor(chol: torch.Tensor) -> torch.Tensor:
    """(L L^T)^-1, symmetric bit for bit, from a lower Cholesky factor
    ``chol`` [N, N]; NaN where the factor holds NaN (:func:`cholesky`'s mark
    of a failed factorization). A block column at a time from the last:
    with L = [[L_kk, 0], [L_rk, L_rr]], T_rr the inverse already made of
    L_rr L_rr^T and Y = L_rk L_kk^-1,

        T_rk = -T_rr Y,    T_kk = L_kk^-T L_kk^-1 - Y^T T_rk.

    T_rr is dense and symmetric, so the products hold no triangle's zeros:
    2 N^3 / 3 flops in N / ``_BLOCK`` products against T_rr and 2 N^2
    ``_BLOCK`` more for Y and T_kk, all matrix products; triangular solves
    only on the diagonal blocks, against the identity
    (:func:`_diagonal_inverses`). ``torch.cholesky_inverse`` on one CUDA
    matrix takes 2 N^3 of triangular solves. T_rk is copied onto T_kr for
    the next products, and T_kk's lower triangle onto its upper."""
    n, block = chol.shape[-1], _BLOCK
    out = torch.empty_like(chol)
    for s, inv_kk in reversed(list(zip(range(0, n, block), _diagonal_inverses(chol, block)))):
        e = min(s + block, n)
        t_kk = torch.mm(inv_kk.mT, inv_kk, out=out[s:e, s:e])
        if e < n:
            y = torch.mm(chol[e:, s:e], inv_kk).neg_()                  # -Y
            t_rk = torch.mm(out[e:, e:], y, out=out[e:, s:e])           # -T_rr Y
            t_kk.addmm_(y.mT, t_rk)                                     # + Y^T T_rr Y
            out[s:e, e:].copy_(t_rk.mT)
        t_kk.copy_(t_kk.tril() + t_kk.tril(-1).mT)
    return out


class _QuadLogdet(torch.autograd.Function):
    """(r^T S^-1 r, log det S) from :func:`cholesky` of S, with the closed
    form backward g_S = g_logdet S^-1 - g_q alpha alpha^T, g_r = 2 g_q alpha
    (alpha = S^-1 r): S^-1 from the factor (:func:`inverse_from_factor`)
    in the buffer it returns, scaled, plus the rank-1 term. S^-1 and
    alpha_i alpha_j are symmetric bit for bit, so g_S is too: K2's symmetric
    launch reads both triangles."""

    @staticmethod
    def forward(ctx, s, r):
        chol = cholesky(s)
        z = torch.linalg.solve_triangular(chol, r[:, None], upper=False)
        ctx.save_for_backward(chol, z)
        return torch.sum(z * z), chol_logdet(chol)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_quad, g_logdet):
        chol, z = ctx.saved_tensors
        with span("linalg.marginal_backward"):
            BACKWARDS["marginal"] += 1
            alpha = torch.linalg.solve_triangular(chol.mT, z, upper=True)[:, 0]
            g_s = inverse_from_factor(chol)
            g_s.mul_(g_logdet).addcmul_(torch.outer(alpha, alpha), -g_quad)
            return g_s, (2.0 * g_quad) * alpha


def quad_logdet(s: torch.Tensor, r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, log det S) = (r^T S^-1 r, log det S) for [N] ``r`` and [N, N]
    ``s``, through :func:`cholesky` of S (its symmetrization, NaN where it
    is not PD) and one triangular solve: the values of
    ``chol_quad_form(cholesky(s), r)`` and ``chol_logdet(cholesky(s))``.
    Its backward is the closed form (:class:`_QuadLogdet`), counted in
    ``BACKWARDS["marginal"]``: S^-1 in 2 N^3 / 3 flops where autograd
    through the factor takes 4 N^3."""
    return _QuadLogdet.apply(s, r)


def _sym(mat: torch.Tensor) -> torch.Tensor:
    return (mat + mat.mT) * 0.5


def inv_psd(mat: torch.Tensor, chol_fn=None) -> torch.Tensor:
    """Explicit PSD inverse through the lower Cholesky factor of ``mat``
    (its lower triangle, as ``cho_factor(lower=True)`` reads it), for sites
    where the reference materializes ``jnp.linalg.inv`` (spax/models.py:40).
    NaN where ``mat`` is not PD, as in JAX. ``chol_fn`` swaps in another
    factorization (a blocked or distributed one,
    :mod:`snngp_torch.parallel.cholesky`)."""
    if chol_fn is not None:
        chol = chol_fn(mat)
    else:
        chol = _nan_where_failed(*torch.linalg.cholesky_ex(mat))
    return torch.cholesky_inverse(chol, upper=False)


def psd_safety_lift(mat: torch.Tensor, mult: float = 1.0) -> torch.Tensor:
    """Diagonal lift that makes a symmetric matrix safely factorizable: its
    smallest eigenvalue is raised to ``mult * eps_dtype * max_eig`` when it
    is below that floor; an exact no-op otherwise (boost 0). The eigenvalues
    are detached: gradients flow through ``mat`` as without the guard. A
    matrix that holds NaN or inf is returned as it is: JAX's eigvalsh
    gives NaN there and the lift spreads it, where torch's raises."""
    with span("linalg.safety_lift"):
        sym = _sym(mat.detach())
        if not bool(torch.isfinite(sym).all()):
            return mat
        ev = torch.linalg.eigvalsh(sym)
        lo, hi = ev[..., 0], ev[..., -1]
        floor = mult * torch.finfo(mat.dtype).eps * hi
        boost = torch.clamp(floor - lo, min=0.0)
        return _add_to_diagonal(mat, boost[..., None])


class _PinvPsdEigh(torch.autograd.Function):
    """Eigh pseudo-inverse whose derivative is the matrix-inverse rule
    d(A^-1) = -A^-1 dA A^-1, not the eigendecomposition's (whose
    1 / (lambda_i - lambda_j) terms explode on clustered spectra); the
    backward is its transpose, G -> -A^-T G A^-T."""

    @staticmethod
    def forward(ctx, mat):
        evals, evecs = torch.linalg.eigh(_sym(mat))
        floor = evals[..., -1:] * torch.finfo(mat.dtype).eps
        evals = torch.maximum(evals, floor)
        inv = (evecs / evals[..., None, :]) @ evecs.mT
        ctx.save_for_backward(inv)
        return inv

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        inv_t = inv.mT
        return -(inv_t @ g @ inv_t)


def pinv_psd_eigh(mat: torch.Tensor) -> torch.Tensor:
    """Indefinite-safe explicit PSD (pseudo-)inverse via eigh
    (``snngp/ops/linalg.py:179``): eigenvalues floored at
    ``max_eig * eps_dtype`` (a no-op on well-conditioned input, a bounded
    pseudo-inverse on numerically indefinite input; the floor is not
    positive when max_eig <= 0, as in the reference), differentiated by the
    matrix-inverse rule."""
    return _PinvPsdEigh.apply(mat)
