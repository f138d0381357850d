"""Regression likelihoods (counterpart of ``snngp/models/likelihoods.py``).

- :class:`GaussianLikelihood` -> exact GP regression: a zero-mean normal
  marginal.
- :class:`StudentTLikelihood` -> Student-t process: the marginal is a
  multivariate t with df = 2a and scale (b/a) K; the predictive is a
  conditional-t with 2a + N degrees of freedom and the data-dependent scale
  inflation d / (2a + N), d = 2a + y^T ((b/a) K + jitter)^{-1} y.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from snngp_torch.models import params as P
from snngp_torch.models.bijectors import positive
from snngp_torch.ops.linalg import add_jitter, chol_quad_form, cholesky, mvn_logpdf
from snngp_torch.ops.mvt import multivariate_t_logpdf

__all__ = ["Likelihood", "GaussianLikelihood", "StudentTLikelihood",
           "normal_logpdf", "student_t_logpdf"]


def normal_logpdf(x, mean, sigma):
    """``jax.scipy.stats.norm.logpdf``."""
    z = (x - mean) / sigma
    return -0.5 * z * z - torch.log(sigma) - 0.5 * math.log(2.0 * math.pi)


def student_t_logpdf(x, df, mean, sigma):
    """``jax.scipy.stats.t.logpdf`` (location-scale Student-t)."""
    z = (x - mean) / sigma
    half_df = df / 2.0
    norm = (torch.lgamma(half_df) + torch.log(sigma * sigma * math.pi * df) / 2.0
            - torch.lgamma(half_df + 0.5))
    return -(norm + (half_df + 0.5) * torch.log1p(z * z / df))


class Likelihood(nn.Module):
    require = None


class GaussianLikelihood(Likelihood):
    require = None

    def __init__(self, chol_fn=None):
        super().__init__()
        # chol_fn swaps in a blocked / distributed factorization on a mesh
        self.chol_fn = chol_fn

    def prior_logpdf(self, x, cov):
        """Zero-mean MVN marginal log-likelihood (spax/likelihoods.py:25-28)."""
        return mvn_logpdf(x, cov, chol_fn=self.chol_fn)

    def logpdf(self, x, mean, cov, aux):
        """Diagonal-Normal predictive density (spax/likelihoods.py:30-33)."""
        return normal_logpdf(x, mean, torch.sqrt(torch.diagonal(cov)))


class StudentTLikelihood(Likelihood):
    require = ["cov_data", "y_data"]

    def __init__(self, alpha: float, beta: float, chol_fn=None):
        super().__init__()
        self.chol_fn = chol_fn
        self.bij = positive()
        self.a = P.constrained_init(alpha, self.bij)
        self.b = P.constrained_init(beta, self.bij)

    def _ab(self):
        return (P.constrained_read(self.a, self.bij),
                P.constrained_read(self.b, self.bij))

    def prior_logpdf(self, x, cov):
        """Multivariate-t marginal, df = 2a, scale (b/a) K
        (spax/likelihoods.py:45-50)."""
        a, b = self._ab()
        return multivariate_t_logpdf(x, torch.zeros_like(x), (b / a) * cov, 2 * a,
                                     chol_fn=self.chol_fn)

    def logpdf(self, x, mean, cov, aux):
        """Conditional-t predictive (spax/likelihoods.py:52-65):

        df* = 2a + N,  d = 2a + y^T ((b/a) K_dd + jitter)^{-1} y,
        sigma^2 = (d / df*) (b/a) diag(cov).
        """
        a, b = self._ab()
        cov_data, y_data = aux
        df = 2 * a
        cond_df = df + cov_data.shape[-1]
        chol = (self.chol_fn or cholesky)(add_jitter((b / a) * cov_data, 1e-6))
        d = df + chol_quad_form(chol, y_data)
        sigma = torch.sqrt(torch.diagonal((d / cond_df) * (b / a) * cov))
        return student_t_logpdf(x, cond_df, mean, sigma)
