"""Probabilistic layer: bijectors, parameter helpers, the NNGP kernel,
likelihoods and priors, the SPR regression and SVSP classification models
and their fitted predictors."""

from snngp_torch.models import bijectors
from snngp_torch.models import params
from snngp_torch.models.bijectors import positive, Softplus, Exp
from snngp_torch.models.kernels import NNGPKernel
from snngp_torch.models.likelihoods import (Likelihood, GaussianLikelihood,
                                            StudentTLikelihood)
from snngp_torch.models.priors import Prior, GaussianPrior, InverseGammaPrior
from snngp_torch.models.gp import SPR, SVSP
from snngp_torch.models.predictor import fit_spr, FittedSPR, fit_svsp, FittedSVSP

__all__ = [
    "bijectors", "params", "positive", "Softplus", "Exp",
    "NNGPKernel", "Prior", "GaussianPrior", "InverseGammaPrior",
    "Likelihood", "GaussianLikelihood", "StudentTLikelihood", "SPR", "SVSP",
    "fit_spr", "FittedSPR", "fit_svsp", "FittedSVSP",
]
