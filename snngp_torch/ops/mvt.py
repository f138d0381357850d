"""Multivariate Student-t primitives (counterpart of ``snngp/ops/mvt.py``):
the correlated Student-t sampler of the reference and the multivariate
Student-t log-density.

Sampler quirk kept on purpose (``spax/utils.py:94-140``): the reference
draws *i.i.d.* univariate Student-t coordinates and correlates them through
a factor of ``cov`` (``mean + factor @ t_iid``), rather than the textbook
multivariate t (which shares one chi-square mixing variable across the
coordinates). The scale-mixture training objective depends on this
construction.

Random draws. ``jax.random.t(key, df, shape)`` is ``n * sqrt((df / 2) / g)``
with n standard normal and g ~ Gamma(df / 2); JAX differentiates g with
respect to df by implicit reparameterization. :func:`standard_t` computes
the same from a :class:`TDraws` pair (n, g): drawn from a
``torch.Generator`` by :func:`draw_t`, or injected by a caller (the parity
tests inject JAX's own draws). Either way g's value enters through
:class:`_ImplicitGamma`, whose backward is dg/dalpha =
``torch._standard_gamma_grad(alpha, g)``, so d/d(df) is the same as JAX's.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from snngp_torch.ops.linalg import cholesky

__all__ = ["TDraws", "draw_t", "standard_t", "multivariate_t", "multivariate_t_logpdf"]


class TDraws(NamedTuple):
    """The standard variates of Student-t draws: n ~ N(0, 1) and the gamma
    variate g ~ Gamma(df / 2), both of the draws' shape."""

    normal: torch.Tensor
    gamma: torch.Tensor


class _ImplicitGamma(torch.autograd.Function):
    """The gamma variate ``g`` (drawn at ``alpha``) as a differentiable
    function of ``alpha``: the value is ``g``; the backward is the
    implicit-reparameterization derivative dg/dalpha at fixed quantile."""

    @staticmethod
    def forward(ctx, alpha, g):
        ctx.save_for_backward(alpha, g)
        return g.clone()

    @staticmethod
    def backward(ctx, grad):
        alpha, g = ctx.saved_tensors
        return grad * torch._standard_gamma_grad(alpha, g), None


def draw_t(df, shape: Sequence[int], generator: Optional[torch.Generator] = None, *,
           dtype=torch.float32, device=None) -> TDraws:
    """Standard variates for Student-t draws of ``shape`` at ``df`` (a
    scalar), from ``generator``: n ~ N(0, 1) and g ~ Gamma(df / 2)."""
    shape = tuple(shape)
    normal = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    alpha = torch.as_tensor(df, dtype=dtype, device=device).detach() / 2.0
    gamma = torch._standard_gamma(alpha.expand(shape).contiguous(), generator=generator)
    return TDraws(normal, gamma)


def standard_t(df, draws: TDraws) -> torch.Tensor:
    """Student-t variates n sqrt((df / 2) / g) from ``draws``, differentiable
    in ``df`` as ``jax.random.t`` is."""
    half_df = (df / 2.0).expand(draws.normal.shape)
    g = _ImplicitGamma.apply(half_df, draws.gamma)
    return draws.normal * torch.sqrt(half_df / g)


def multivariate_t(df, mean: torch.Tensor, cov: torch.Tensor,
                   shape: Optional[Sequence[int]] = None,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[TDraws] = None) -> torch.Tensor:
    """Correlated Student-t draws ``mean + chol(cov) @ t_iid(df)``
    (``spax/utils.py:94-140``), of shape ``shape + (n,)``; ``shape``
    defaults to the broadcast batch shape of ``mean`` and ``cov``. The
    standard variates are ``draws`` when given, else drawn from
    ``generator``."""
    if mean.ndim < 1:
        raise ValueError("multivariate_t requires mean.ndim >= 1")
    if cov.ndim < 2:
        raise ValueError("multivariate_t requires cov.ndim >= 2")
    n = mean.shape[-1]
    if cov.shape[-2:] != (n, n):
        raise ValueError(f"cov.shape {tuple(cov.shape)} incompatible with mean dim {n}")
    if shape is None:
        shape = torch.broadcast_shapes(mean.shape[:-1], cov.shape[:-2])
    shape = tuple(shape)
    torch.broadcast_shapes(shape, mean.shape[:-1], cov.shape[:-2])
    factor = cholesky(cov)
    if draws is None:
        draws = draw_t(df, shape + (n,), generator, dtype=mean.dtype, device=mean.device)
    t_samples = standard_t(df, draws)
    return mean + torch.einsum("...ij,...j->...i", factor, t_samples)


def multivariate_t_logpdf(x: torch.Tensor, loc, shape_mat: torch.Tensor, df,
                          chol_fn=None) -> torch.Tensor:
    """Multivariate Student-t log-density (``spax/utils.py:160-183``).

    log p(x) = -((df+n)/2) log(1 + (1/df) y^T y) - (n/2) log(df pi)
               + lgamma((df+n)/2) - lgamma(df/2) - sum log diag(L)
    with L = chol(shape) and y = L^{-1}(x - loc); ``x`` is [n]. ``chol_fn``
    swaps in another factorization.
    """
    n = x.shape[-1]
    half = 0.5 * (df + n)
    chol = (chol_fn or cholesky)(shape_mat)
    diff = x - loc
    y = torch.linalg.solve_triangular(chol, diff[..., None], upper=False)[..., 0]
    quad = torch.sum(y * y, dim=-1)
    return (
        -half * torch.log1p(quad / df)
        - 0.5 * n * torch.log(df * math.pi)
        + torch.lgamma(half)
        - torch.lgamma(0.5 * df)
        - torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    )
