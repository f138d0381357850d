"""Scale-mixture process models (counterpart of ``snngp/models/gp.py``;
rebuilds ``spax/models.py``).

- :class:`SVSP` — sparse variational stochastic process: inducing-point
  variational classification; a Gaussian prior gives SVGP, an inverse-gamma
  prior SVTP. Its parameters carry the JAX package's dotted names:
  ``eps``, ``inducing_variable``, ``kernel.{b_std,last_w_std,w_std}``,
  ``prior.{a,b}`` (SVTP), ``q_mu``, ``q_sqrt``.
- :class:`SPR` — exact-inference stochastic process regression: ``eps``,
  ``kernel.{b_std,last_w_std,w_std}`` and, for a Student-t likelihood,
  ``likelihood.{a,b}``. The training data and the target normalization are
  non-persistent buffers, so ``.to(device)`` moves them with the parameters
  and ``state_dict()`` holds the parameters only. ``loss`` is the ML-II
  objective (differentiable in every parameter); ``test_nll`` the
  predictive NLL. On a ``mesh`` (:mod:`snngp_torch.parallel`) the train
  Gram is built as row panels over the shards and every factorization of
  it goes through the likelihood's ``chol_fn``.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch import nn

from snngp_torch.models import params as P
from snngp_torch.models.bijectors import positive
from snngp_torch.ops.linalg import (add_diag_reg, add_jitter, inv_psd, pinv_psd_eigh,
                                    psd_safety_lift)
from snngp_torch.ops.softmax import get_correct_count, log_likelihood, test_log_likelihood

__all__ = ["SVSP", "SPR"]


def _no_phase(name):
    return contextlib.nullcontext()


class SVSP(nn.Module):
    """Sparse variational stochastic process classifier
    (spax/models.py:15-78).

    The random draws of ``loss`` / ``test_acc_nll`` come from ``generator``
    (a ``torch.Generator`` on the parameters' device) or are injected as
    ``draws`` (see :mod:`snngp_torch.models.priors`).

    ``chol_fn`` routes both inducing-side inverses through a factorization
    (:mod:`snngp_torch.parallel.cholesky`) in place of the eigh
    pseudo-inverse; ``mesh`` without a ``chol_fn`` installs
    :func:`~snngp_torch.parallel.cholesky.blocked_cholesky` with
    ``chol_block``, as the JAX package does. ``mesh`` shards nothing here:
    ``loss(..., mesh=)`` shards a batch's Gram blocks."""

    def __init__(self, prior, kernel, inducing_variable, *, num_latent_gps: int = 1,
                 eps: float = 1e-6, chol_fn=None, mesh=None, chol_block: int = 512):
        super().__init__()
        if chol_fn is None and mesh is not None:
            from snngp_torch.parallel.cholesky import blocked_cholesky
            chol_fn = functools.partial(blocked_cholesky, block=chol_block)
        self.chol_fn = chol_fn
        self.bij = positive()
        self.num_latent_gps = num_latent_gps
        self.prior = prior
        self.kernel = kernel
        z = torch.as_tensor(inducing_variable, dtype=torch.float32)
        self.inducing_variable = nn.Parameter(z.clone())
        self.q_mu = nn.Parameter(torch.zeros((num_latent_gps, z.shape[0])))
        self.q_sqrt = P.constrained_init(torch.ones((num_latent_gps, z.shape[0])), self.bij)
        self.eps = P.constrained_init(eps, self.bij)

    @property
    def num_inducing(self) -> int:
        return self.inducing_variable.shape[0]

    def _posterior_pieces(self, x_batch, phase=_no_phase, mesh=None):
        """The Gram blocks and solves shared by the loss and test paths:
        (A_B [B, I], B_B [B, B], k_rel_inv, k_bi, k_ii, k_ii_inv, q_mu,
        q_sqrt) with A_B = k_bi (k_ii + eps I)^-1 (absolute-eps jitter,
        spax/models.py:40) and B_B = k_bb - k_bi (k_ii + r I)^-1 k_ib with
        the trace-relative r (spax/models.py:43 via kernel.predict), the
        latter through the eigh pseudo-inverse (see
        :func:`~snngp_torch.ops.linalg.pinv_psd_eigh`) or, with a
        ``chol_fn``, through its factor L as V^T V, V = L^-1.

        On a 1-D ``mesh`` of P shards (P must divide B) k_bi and k_bb are
        the row panels of :func:`~snngp_torch.parallel.gram.sharded_gram`,
        one [B / P, I] and one [B / P, B] a shard, gathered on the
        parameters' device, where k_ii and everything after the Grams run
        (the partition GSPMD gives the JAX package's ELBO over a
        batch-sharded minibatch). The panels' backward runs on their
        shards. On a mesh across ranks each rank computes its own panels
        from the kernel's hyperparameters and z passed through
        :func:`~snngp_torch.parallel.mesh.to_shards`, and the rest, the
        draws included, on every rank alike."""
        z = self.inducing_variable
        eps = P.constrained_read(self.eps, self.bij)
        q_sqrt = P.constrained_read(self.q_sqrt, self.bij)
        with phase("gram"):
            kernel_fn = self.kernel.get_kernel_fn()
            if mesh is None:
                k_bi = self.kernel.K(kernel_fn, x_batch, z)      # [B, I]
                k_bb = self.kernel.K(kernel_fn, x_batch)         # [B, B]
            else:
                from snngp_torch.parallel.gram import sharded_gram
                from snngp_torch.parallel.mesh import gather, to_shards
                *hyper, z_in = to_shards(mesh, *self.kernel.get_params(), z)
                shard_fn = self.kernel._get_kernel_fn(*hyper)
                k_bi = gather(sharded_gram(shard_fn, x_batch, mesh, x2=z_in), z.device)
                k_bb = gather(sharded_gram(shard_fn, x_batch, mesh), z.device)
            k_ii = self.kernel.K(kernel_fn, z)                   # [I, I]
        with phase("posterior"):
            # The lift is a no-op while (k_ii + eps I) is numerically PD.
            k_ii_inv = inv_psd(psd_safety_lift(add_jitter(k_ii, eps)), self.chol_fn)
            a_b = k_bi @ k_ii_inv
            k_rel_inv = self._rel_inv(add_diag_reg(k_ii, eps))
            b_b = k_bb - k_bi @ k_rel_inv @ k_bi.T
        return a_b, b_b, k_rel_inv, k_bi, k_ii, k_ii_inv, self.q_mu, q_sqrt

    def _rel_inv(self, k_rel):
        """(k_ii + r I)^-1: the eigh pseudo-inverse, or with a ``chol_fn``
        V^T V from V = L^-1, without the safety lift (as in the JAX
        package: an fp32-indefinite k_ii gives NaN there)."""
        if self.chol_fn is None:
            return pinv_psd_eigh(k_rel)
        chol = self.chol_fn(k_rel)
        eye = torch.eye(chol.shape[0], dtype=chol.dtype, device=chol.device)
        v = torch.linalg.solve_triangular(chol, eye, upper=False)
        return v.T @ v

    def loss(self, x_batch, y_batch, num_train, num_samples, generator=None, draws=None,
             aux=False, phase=_no_phase, mesh=None):
        """Negative ELBO per data point (spax/models.py:30-56). ``phase``
        (a profiler's ``phase``) names the gram / posterior /
        sampling+likelihood intervals; ``mesh`` shards the batch's Gram
        blocks (see :meth:`_posterior_pieces`)."""
        a_b, b_b, _, _, k_ii, k_ii_inv, q_mu, q_sqrt = self._posterior_pieces(
            x_batch, phase, mesh)
        with phase("posterior"):
            mean = q_mu @ a_b.T                                  # [C, B]
            cov = torch.einsum("ij,cj,kj->cik", a_b, q_sqrt, a_b) + b_b[None, :, :]
            # A no-op unless fp32 round-off makes the sampling covariance
            # indefinite; detached, so the pathwise gradients are untouched.
            cov = psd_safety_lift(cov, mult=cov.shape[-1])
        with phase("sampling+likelihood"):
            sampled_f = self.prior.sample_f(mean, cov, num_samples, generator, draws)
            ll = log_likelihood(sampled_f, y_batch)
            kl = self.prior.kl_divergence(k_ii, k_ii_inv, q_mu, q_sqrt, self.num_inducing,
                                          self.num_latent_gps)
            n_elbo = -ll + kl / num_train
        if aux:
            return n_elbo, (-ll, kl / num_train)
        return n_elbo

    def test_acc_nll(self, x_batch, y_batch, num_samples, generator=None, draws=None):
        """MC predictive NLL and correct count (spax/models.py:58-78)."""
        a_b, b_b, k_rel_inv, k_bi, _, _, q_mu, q_sqrt = self._posterior_pieces(x_batch)
        mean = (k_bi @ (k_rel_inv @ q_mu.T)).T                   # [C, B]
        test_cov = torch.einsum("ij,cj,kj->cik", a_b, q_sqrt, a_b) + b_b[None, :, :]
        sampled_f = self.prior.sample_f_iid(mean, test_cov, num_samples, generator, draws)
        nll = -test_log_likelihood(sampled_f, y_batch)
        return nll, get_correct_count(sampled_f, y_batch)


class SPR(nn.Module):
    """Exact-inference stochastic process regression (spax/models.py:81-120).

    ``mesh`` (a :class:`snngp_torch.parallel.mesh.Mesh`) builds the train
    Gram as row panels over its shards; the likelihood's ``chol_fn`` then
    defaults to :func:`~snngp_torch.parallel.cholesky.blocked_cholesky` with
    ``chol_block``, and the marginal likelihood and the predictive both
    factor through it (``self.chol_fn``)."""

    def __init__(self, kernel, likelihood, x_data, y_data, y_mean, y_std, *,
                 eps: float = 1e-6, mesh=None, chol_block: int = 512):
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
        self.mesh = mesh
        if mesh is not None and getattr(likelihood, "chol_fn", None) is None:
            from snngp_torch.parallel.cholesky import blocked_cholesky
            likelihood.chol_fn = functools.partial(blocked_cholesky, block=chol_block)
        self.chol_fn = getattr(likelihood, "chol_fn", None)

    @property
    def num_data(self) -> int:
        return self.x_data.shape[0]

    def _gram(self, kernel_fn):
        """Full training Gram; on a mesh, from its row panels (rows
        zero-padded to a multiple of the mesh size, then sliced back), the
        panels' kernel built from the kernel's current hyperparameters
        passed through :func:`~snngp_torch.parallel.mesh.to_shards` (so
        ``kernel_fn`` must be the kernel's own, as every caller's is): on a
        mesh across ranks each rank runs its own panels and gets the whole
        Gram."""
        if self.mesh is None:
            return self.kernel.K(kernel_fn, self.x_data)
        from snngp_torch.parallel.gram import sharded_gram
        from snngp_torch.parallel.mesh import gather, to_shards
        n = self.num_data
        pad = (-n) % self.mesh.size
        x = self.x_data
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        shard_fn = self.kernel._get_kernel_fn(*to_shards(self.mesh, *self.kernel.get_params()))
        gram = gather(sharded_gram(shard_fn, x, self.mesh), x.device)
        return gram[:n, :n] if pad else gram

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
                                        self.y_data[:, None], x, eps=eps, chol_fn=self.chol_fn)

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
