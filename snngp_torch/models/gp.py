"""Exact-inference stochastic process regression (counterpart of
``SPR`` in ``snngp/models/gp.py``, single device).

``SPR`` is an ``nn.Module`` whose parameters carry the JAX package's dotted
names: ``eps``, ``kernel.{b_std,last_w_std,w_std}`` and, for a Student-t
likelihood, ``likelihood.{a,b}``. The training data and the target
normalization are non-persistent buffers, so ``.to(device)`` moves them
with the parameters and ``state_dict()`` holds the parameters only.
``loss`` is the ML-II objective (differentiable in every parameter);
``test_nll`` the predictive NLL.
"""

from __future__ import annotations

import torch
from torch import nn

from snngp_torch.models import params as P
from snngp_torch.models.bijectors import positive
from snngp_torch.ops.linalg import add_jitter

__all__ = ["SPR"]


class SPR(nn.Module):
    """Exact-inference stochastic process regression (spax/models.py:81-120)."""

    def __init__(self, kernel, likelihood, x_data, y_data, y_mean, y_std, *,
                 eps: float = 1e-6):
        super().__init__()
        self.bij = positive()
        self.eps = P.constrained_init(eps, self.bij)
        self.kernel = kernel
        self.likelihood = likelihood
        f32 = dict(dtype=torch.float32)
        self.register_buffer("x_data", torch.as_tensor(x_data, **f32), persistent=False)
        self.register_buffer("y_data", torch.as_tensor(y_data, **f32), persistent=False)
        self.register_buffer("y_mean", torch.as_tensor(y_mean, **f32), persistent=False)
        self.register_buffer("y_std", torch.as_tensor(y_std, **f32), persistent=False)

    @property
    def num_data(self) -> int:
        return self.x_data.shape[0]

    def _gram(self, kernel_fn):
        """Full training Gram."""
        return self.kernel.K(kernel_fn, self.x_data)

    def loss(self, gram=None):
        """Negative marginal log-likelihood / N (spax/models.py:93-98), with
        eps added to the Gram's diagonal. ``gram`` optionally supplies the
        train Gram for the current parameters (``_gram``'s result, still on
        the autograd graph)."""
        eps = P.constrained_read(self.eps, self.bij)
        if gram is None:
            gram = self._gram(self.kernel.get_kernel_fn())
        log_prob = self.likelihood.prior_logpdf(self.y_data, add_jitter(gram, eps))
        return -log_prob / self.num_data

    def test_nll(self, x, y):
        """Predictive NLL on de-normalized targets (spax/models.py:100-120)."""
        eps = P.constrained_read(self.eps, self.bij)
        kernel_fn = self.kernel.get_kernel_fn()
        mean, cov = self.kernel.predict(kernel_fn, self.x_data,
                                        self.y_data[:, None], x, eps=eps)

        require = self.likelihood.require
        if require:
            cov_data = self.kernel.K(kernel_fn, self.x_data)
            aux_dict = dict(cov_data=cov_data, y_data=self.y_data)
            aux = tuple(aux_dict[k] for k in require)
        else:
            aux = None

        log_prob = self.likelihood.logpdf(
            (y * self.y_std) + self.y_mean,
            (mean.flatten() * self.y_std) + self.y_mean,
            cov * self.y_std ** 2,
            aux,
        )
        return -torch.mean(log_prob)
