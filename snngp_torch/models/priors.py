"""Priors over the latent function (counterpart of
``snngp/models/priors.py``; rebuilds ``spax/priors.py``).

- :class:`GaussianPrior`: MVN sampling and the Gaussian KL(q || p) -> SVGP.
- :class:`InverseGammaPrior`: inverse-gamma mixing over the function scale;
  sampling becomes Student-t with df = 2a and scale (b/a) cov, and the KL
  gains the closed-form inverse-gamma terms -> SVTP (the scale-mixture
  result). ``a`` and ``b`` are its trainable parameters (``prior.a``,
  ``prior.b``).

Each sampler takes its standard variates as ``draws`` (the parity tests
inject JAX's) or draws them from ``generator`` with :meth:`draw`: a normal
array for the Gaussian prior, a :class:`~snngp_torch.ops.mvt.TDraws` pair
for the inverse-gamma prior. The shapes are JAX's: [S, C, B] for the
correlated draws, [C, B, S] for the marginal ones.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from snngp_torch.models import params as P
from snngp_torch.models.bijectors import positive
from snngp_torch.ops.linalg import cholesky
from snngp_torch.ops.mvt import draw_t, multivariate_t, standard_t

__all__ = ["Prior", "GaussianPrior", "InverseGammaPrior"]


def _logdet_psd(mat):
    """slogdet (LU-based), as the reference's logdet (spax/utils.py:38-40):
    finite on numerically non-PSD Grams where a Cholesky would NaN."""
    sign, abslogdet = torch.linalg.slogdet(mat)
    return sign * abslogdet


def _common_kl_terms(k_ii, k_ii_inv, q_mu, q_sqrt, num_class):
    """The Gaussian KL's pieces, with the variational covariance
    diag(q_sqrt) per class (spax/models.py:35: the diagonal matrix of the
    q_sqrt values, not their squares)."""
    logdet_k = _logdet_psd(k_ii) * num_class
    logdet_q = torch.sum(torch.log(q_sqrt))
    tr = torch.sum(torch.diagonal(k_ii_inv)[None, :] * q_sqrt)
    quad = torch.einsum("ci,ij,cj->", q_mu, k_ii_inv, q_mu)
    return logdet_k, logdet_q, tr, quad


def _mvn(mean, cov, normal):
    """mean + chol(cov) @ normal, batched (``jax.random.multivariate_normal``
    with method="cholesky")."""
    return mean + torch.einsum("...ij,...j->...i", cholesky(cov), normal)


class Prior(nn.Module):
    """The base of the priors: a module whose trainable parameters, if any,
    are its own (the JAX package's ``Prior.init_params`` returns none)."""


class GaussianPrior(Prior):
    def draw(self, shape: Sequence[int], generator=None, *, like: torch.Tensor):
        return torch.randn(tuple(shape), generator=generator, dtype=like.dtype,
                           device=like.device)

    def sample_f(self, mean, cov, num_samples, generator=None, draws=None):
        """Full-covariance MVN draws -> [C, B, S] (spax/priors.py:22-26);
        ``draws`` [S, C, B] standard normals."""
        num_class, num_batch = mean.shape
        if draws is None:
            draws = self.draw((num_samples, num_class, num_batch), generator, like=mean)
        return _mvn(mean, cov, draws).permute(1, 2, 0)

    def sample_f_iid(self, mean, cov, num_samples, generator=None, draws=None):
        """Marginal draws -> [C, B, S] (spax/priors.py:28-34); ``draws``
        [C, B, S]. The diagonal is clamped at 0 before the sqrt (fp32
        Schur-complement round-off can make it slightly negative)."""
        num_class, num_batch = mean.shape
        if draws is None:
            draws = self.draw((num_class, num_batch, num_samples), generator, like=mean)
        sigma = torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1), min=0.0))
        return draws * sigma[..., None] + mean[..., None]

    def kl_divergence(self, k_ii, k_ii_inv, q_mu, q_sqrt, num_inducing, num_class):
        """KL(q || GP prior) (spax/priors.py:36-41)."""
        logdet_k, logdet_q, tr, quad = _common_kl_terms(k_ii, k_ii_inv, q_mu, q_sqrt,
                                                        num_class)
        return 0.5 * ((logdet_k - logdet_q) - num_inducing * num_class + tr + quad)


class InverseGammaPrior(Prior):
    """Inverse-gamma mixing with trainable (a, b) and fixed prior
    (alpha, beta)."""

    def __init__(self, alpha: float, beta: float):
        super().__init__()
        self.alpha = alpha
        self.beta = beta
        self.bij = positive()
        self.a = P.constrained_init(alpha, self.bij)
        self.b = P.constrained_init(beta, self.bij)

    def _ab(self):
        return (P.constrained_read(self.a, self.bij),
                P.constrained_read(self.b, self.bij))

    def draw(self, shape: Sequence[int], generator=None, *, like: torch.Tensor):
        """Student-t standard variates at the current df = 2a."""
        a, _ = self._ab()
        return draw_t(2 * a, shape, generator, dtype=like.dtype, device=like.device)

    def sample_f(self, mean, cov, num_samples, generator=None, draws=None):
        """Student-t draws, df = 2a, scale (b/a) cov -> [C, B, S]
        (spax/priors.py:52-58); ``draws`` of shape [S, C, B]."""
        a, b = self._ab()
        return self.sample_f2(mean, cov, num_samples, a, b, generator, draws)

    def sample_f_iid(self, mean, cov, num_samples, generator=None, draws=None):
        """Marginal t draws -> [C, B, S] (spax/priors.py:60-68); ``draws`` of
        shape [C, B, S]. The diagonal is clamped at 0 before the sqrt."""
        a, b = self._ab()
        num_class, num_batch = mean.shape
        if draws is None:
            draws = self.draw((num_class, num_batch, num_samples), generator, like=mean)
        sigma = torch.sqrt(torch.clamp(torch.diagonal((b / a) * cov, dim1=-2, dim2=-1),
                                       min=0.0))
        return standard_t(2 * a, draws) * sigma[..., None] + mean[..., None]

    def kl_divergence(self, k_ii, k_ii_inv, q_mu, q_sqrt, num_inducing, num_class):
        """Gaussian KL with the quadratic term scaled by a/b, plus the
        closed-form KL between the inverse-gamma mixing distributions
        (spax/priors.py:70-82)."""
        a, b = self._ab()
        return self.kl_divergence2(k_ii, k_ii_inv, q_mu, q_sqrt, num_inducing, num_class,
                                   a, b)

    # Explicit-(a, b) variants (spax/priors.py:84-102), used by grid searches.
    def sample_f2(self, mean, cov, num_samples, a, b, generator=None, draws=None):
        num_class = mean.shape[0]
        sampled = multivariate_t(2 * a, mean, (b / a) * cov, shape=(num_samples, num_class),
                                 generator=generator, draws=draws)
        return sampled.permute(1, 2, 0)

    def kl_divergence2(self, k_ii, k_ii_inv, q_mu, q_sqrt, num_inducing, num_class, a, b):
        a_by_b = a / b
        logdet_k, logdet_q, tr, quad = _common_kl_terms(k_ii, k_ii_inv, q_mu, q_sqrt,
                                                        num_class)
        gauss = 0.5 * ((logdet_k - logdet_q) - num_inducing * num_class + tr + quad * a_by_b)
        ig = (self.alpha * torch.log(b / self.beta)
              - torch.lgamma(a) + math.lgamma(self.alpha)
              + (a - self.alpha) * torch.digamma(a)
              + (self.beta - b) * a_by_b)
        return gauss + ig
