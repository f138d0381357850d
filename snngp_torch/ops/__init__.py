"""Compute core: Cholesky / eigh linear algebra, the marginal likelihoods, the
samplers and estimators, and the fused NNGP, CNN, conv-WideResNet and
Myrtle Grams (``ops.gram``, ``ops.conv_gram``, ``ops.resnet_conv_gram``,
``ops.myrtle_gram``). Exports the names of ``snngp/ops/__init__.py``."""

from snngp_torch.ops.linalg import (
    jitter, add_jitter, add_diag_reg, logdet, trace, split_kernel,
    cholesky, chol_solve, chol_logdet, chol_quad_form,
    solve_psd, inv_psd, gp_predict, mvn_logpdf,
)
from snngp_torch.ops.mvt import multivariate_t, multivariate_t_logpdf
from snngp_torch.ops.softmax import (
    get_true_values, log_likelihood, test_log_likelihood, get_correct_count,
)

__all__ = [
    "jitter", "add_jitter", "add_diag_reg", "logdet", "trace", "split_kernel",
    "cholesky", "chol_solve", "chol_logdet", "chol_quad_form",
    "solve_psd", "inv_psd", "gp_predict", "mvn_logpdf",
    "multivariate_t", "multivariate_t_logpdf",
    "get_true_values", "log_likelihood", "test_log_likelihood", "get_correct_count",
]
