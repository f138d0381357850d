"""Compute core: Cholesky-based linear algebra and the fused NNGP Gram."""

from snngp_torch.ops.linalg import (
    add_jitter, add_diag_reg, cholesky, chol_solve, chol_quad_form, gp_predict,
)

__all__ = ["add_jitter", "add_diag_reg", "cholesky", "chol_solve",
           "chol_quad_form", "gp_predict"]
