"""Probabilistic layer: bijectors, parameter helpers, the NNGP kernel,
likelihoods, the SPR regression model and its fitted predictor."""

from snngp_torch.models import bijectors
from snngp_torch.models import params
from snngp_torch.models.bijectors import positive, Softplus
from snngp_torch.models.kernels import NNGPKernel
from snngp_torch.models.likelihoods import (Likelihood, GaussianLikelihood,
                                            StudentTLikelihood)
from snngp_torch.models.gp import SPR
from snngp_torch.models.predictor import fit_spr, FittedSPR

__all__ = [
    "bijectors", "params", "positive", "Softplus", "NNGPKernel",
    "Likelihood", "GaussianLikelihood", "StudentTLikelihood", "SPR",
    "fit_spr", "FittedSPR",
]
