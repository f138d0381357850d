"""Trainable NNGP kernel wrapper (counterpart of ``snngp/models/kernels.py``).

Holds the softplus-constrained scale hyperparameters as raw ``nn.Parameter``s
and rebuilds the kernel function from their current values on every call.
"""

from __future__ import annotations

from typing import Callable

from torch import nn

from snngp_torch.models import params as P
from snngp_torch.models.bijectors import positive
from snngp_torch.ops import gp_predict

__all__ = ["NNGPKernel"]


class NNGPKernel(nn.Module):
    """``get_kernel_fn(w_std, b_std, last_w_std) -> kernel_fn`` mirrors the
    reference's builder closures (``experiments/regression/train.py:119-124``).
    Parameters are registered in name order, as the JAX package's dict walk
    lists them."""

    def __init__(self, get_kernel_fn: Callable, w_std: float = 1.0,
                 b_std: float = 1.0, last_w_std: float = 1.0):
        super().__init__()
        self._get_kernel_fn = get_kernel_fn
        self.bij = positive()
        self.b_std = P.constrained_init(b_std, self.bij)
        self.last_w_std = P.constrained_init(last_w_std, self.bij)
        self.w_std = P.constrained_init(w_std, self.bij)

    def get_params(self):
        """(w_std, b_std, last_w_std) safe values (spax/kernels.py:34-35)."""
        return (P.constrained_read(self.w_std, self.bij),
                P.constrained_read(self.b_std, self.bij),
                P.constrained_read(self.last_w_std, self.bij))

    def get_kernel_fn(self):
        return self._get_kernel_fn(*self.get_params())

    def K(self, kernel_fn, x, x2=None):
        """N1 x N2 NNGP Gram block (spax/kernels.py:23-27)."""
        return kernel_fn(x, x if x2 is None else x2, get="nngp")

    def predict(self, kernel_fn, x, y, x_test, eps=1e-6, chol_fn=None):
        """Exact GP posterior (spax/kernels.py:29-32); nt-relative diag_reg.
        ``chol_fn`` swaps in a blocked or distributed factorization of the
        train Gram (:mod:`snngp_torch.parallel.cholesky`)."""
        return gp_predict(kernel_fn, x, y, x_test, diag_reg=eps, compute_cov=True,
                          chol_fn=chol_fn)
