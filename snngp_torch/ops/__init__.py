"""Compute core: Cholesky / eigh linear algebra, the marginal likelihoods, the
samplers and estimators, and the fused NNGP, CNN and conv-WideResNet Grams
(``ops.gram``, ``ops.conv_gram``, ``ops.resnet_conv_gram``)."""

from snngp_torch.ops.linalg import (
    add_jitter, add_diag_reg, cholesky, chol_solve, chol_logdet, chol_quad_form,
    gp_predict, mvn_logpdf,
)
from snngp_torch.ops.mvt import multivariate_t_logpdf

__all__ = ["add_jitter", "add_diag_reg", "cholesky", "chol_solve", "chol_logdet",
           "chol_quad_form", "gp_predict", "mvn_logpdf", "multivariate_t_logpdf"]
