"""Multivariate Student-t log-density (counterpart of
``multivariate_t_logpdf`` in ``snngp/ops/mvt.py``; the sampler comes with
the classification slice)."""

from __future__ import annotations

import math

import torch

from snngp_torch.ops.linalg import cholesky

__all__ = ["multivariate_t_logpdf"]


def multivariate_t_logpdf(x: torch.Tensor, loc, shape_mat: torch.Tensor, df) -> torch.Tensor:
    """Multivariate Student-t log-density (``spax/utils.py:160-183``).

    log p(x) = -((df+n)/2) log(1 + (1/df) y^T y) - (n/2) log(df pi)
               + lgamma((df+n)/2) - lgamma(df/2) - sum log diag(L)
    with L = chol(shape) and y = L^{-1}(x - loc); ``x`` is [n].
    """
    n = x.shape[-1]
    half = 0.5 * (df + n)
    chol = cholesky(shape_mat)
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
