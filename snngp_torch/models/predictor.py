"""Fitted-state predictors: factorize once, predict many times (counterpart
of ``fit_spr`` / ``FittedSPR`` and ``fit_svsp`` / ``FittedSVSP`` in
``snngp/models/predictor.py``).

:func:`fit_spr` runs the train-side work once — the train Gram, its
regularized Cholesky factor, the target solve and, for a Student-t
likelihood, the conditional-t degrees of freedom and data scale ``d`` — and
returns a :class:`FittedSPR` whose ``predict`` / ``test_nll`` cost only the
cross-Gram, the test Gram of each chunk and triangular solves.
:func:`fit_svsp` hoists an ``SVSP``'s inducing-side inverses and the
``q_mu`` solve; a :class:`FittedSVSP` request costs the [B, I] and [B, B]
Grams and two products.

The fitted state is a flat dict of tensors. ``save`` / ``load`` use the JAX
package's ``.npz`` layout (state arrays plus ``param:<dotted name>``), so a
file written by either package loads in the other.

``var_floor`` clips the posterior variance at predict time, and
``predict_given`` / ``test_nll_given`` serve from precomputed Gram pieces
(the Myrtle pipeline, ``snngp_torch.examples.cifar_myrtle``).

``fit_spr(extendable=True)`` freezes the absolute regularizer and keeps the
Student-t factor, so that :meth:`FittedSPR.extend` grows the training set by
a bordered-block update of the factors
(:func:`~snngp_torch.ops.linalg.chol_append`) instead of a refit.

``fit_spr(memory_lean=True)`` holds one N x N buffer: the Gram is
regularized, scaled and factored in its own storage
(:func:`~snngp_torch.parallel.cholesky.inplace_blocked_cholesky`), and the
fitted state carries the UPPER factor (``chol_lower = 0``). Its solves, and
every solve of :class:`FittedSPR` against an upper factor, go through the
panel solve :func:`~snngp_torch.parallel.cholesky.blocked_triangular_solve`
(``torch.cholesky_solve`` copies its factor). Such states, written by either
package, load and serve, and extend if they are extendable.

Divergence from the JAX package: for a Student-t likelihood the lean fit
needs the Gram twice (the scaled Gram's factor for ``d``, then the main
factor). Without ``gram`` it computes the Gram a second time on the device
(the fused Gram is bitwise repeatable) where JAX stages it to the host and
uploads it again; a given ``gram`` is staged to the host as in JAX.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from snngp_torch.models import params as P
from snngp_torch.models.likelihoods import normal_logpdf, student_t_logpdf
from snngp_torch.ops.linalg import (_add_diag_reg_, add_diag_reg, add_jitter, chol_append,
                                    chol_quad_form, chol_solve, cholesky, inv_psd)
from snngp_torch.parallel.cholesky import blocked_triangular_solve, inplace_blocked_cholesky
from snngp_torch.ops.softmax import get_correct_count, test_log_likelihood

__all__ = ["fit_spr", "FittedSPR", "fit_svsp", "FittedSVSP"]


def fit_spr(model, memory_lean: bool = False, extendable: bool = False,
            gram=None, var_floor: float = 0.0,
            t_jitter: float = 1e-6) -> "FittedSPR":
    """One-time train-side solve for an :class:`snngp_torch.models.gp.SPR`,
    with the parameters the model holds.

    ``gram`` optionally supplies the precomputed train Gram (a tensor, or a
    host array such as :func:`~snngp_torch.ops.myrtle_gram.myrtle_gram_tiled`'s
    result, moved to the model's device); it must equal
    ``model._gram(kernel_fn)`` for the same parameters, since the fitted
    state stores solved quantities, not the inputs.

    ``var_floor`` (relative to the prior test variance) clips the posterior
    variance at predict time: ``var = max(var, var_floor * diag(k_tt))``.
    0 keeps the reference's exact arithmetic; at large N the fp32 posterior
    variance sits below the cancellation noise of the [N]-long contraction
    and can go slightly negative, so large-N pipelines pass ~1e-6.

    ``t_jitter`` is the absolute jitter on the scaled Gram ``(b/a) K`` whose
    factor defines the Student-t data scale ``d`` (the reference hardcodes
    1e-6). At large N the Gram's own fp32 noise exceeds 1e-6 and the
    factorization needs a proportionally larger value to stay PD.

    ``extendable=True`` keeps what :meth:`FittedSPR.extend` needs: the
    absolute regularizer applied (``reg`` = eps tr(K) / N, frozen at fit
    time, so extensions do not re-derive it from the drifting mean
    diagonal) and, for a Student-t likelihood, the factor of the scaled
    Gram (``chol_t``, a second [N, N]).

    ``memory_lean=True`` holds one N x N device buffer at a time: the Gram
    is regularized (and, for the Student-t ``d``, scaled) and factored in
    its own storage, and the state carries the UPPER factor (``chol_lower =
    0``). A device ``gram`` of the model's dtype is factored in its own
    storage (JAX donates it); a Student-t fit stages a given ``gram`` to the
    host and uploads it twice, and without one computes the Gram twice.
    Not together with ``extendable`` (a ``ValueError``, as in the JAX
    package). The model's ``chol_fn`` (a blocked or distributed
    factorization) factors the default path's Grams.
    """
    if extendable and memory_lean:
        raise ValueError("extendable fits keep extra factors resident; "
                         "memory_lean exists to avoid exactly that — pick one")
    eps = P.constrained_read(model.eps, model.bij)
    kernel_fn = model.kernel.get_kernel_fn()

    like = model.x_data
    if memory_lean:
        return _fit_spr_lean(model, kernel_fn, eps, gram, var_floor, t_jitter)
    chol_fn = model.chol_fn or cholesky
    k_dd = (model._gram(kernel_fn) if gram is None
            else torch.as_tensor(gram, dtype=like.dtype, device=like.device))
    chol = chol_fn(add_diag_reg(k_dd, eps))                     # [N, N]
    alpha = chol_solve(chol, model.y_data[:, None])             # [N, 1]

    state = {
        "chol": chol,
        "alpha": alpha,
        "y_mean": model.y_mean,
        "y_std": model.y_std,
    }
    if var_floor:
        state["var_floor"] = torch.tensor(var_floor, dtype=like.dtype, device=like.device)
    if extendable:  # freeze the absolute regularizer add_diag_reg applied
        state["reg"] = eps * torch.trace(k_dd) / model.num_data
    if model.likelihood.require:  # Student-t conditional predictive
        a, b = model.likelihood._ab()
        df = 2.0 * a
        chol_t = chol_fn(add_jitter((b / a) * k_dd, t_jitter))
        state["d"] = df + chol_quad_form(chol_t, model.y_data)
        state["cond_df"] = df + model.num_data
        state["scale_ba"] = b / a
        if extendable:
            state["chol_t"] = chol_t
    return FittedSPR(model, state)


@torch.no_grad()
def _fit_spr_lean(model, kernel_fn, eps, gram, var_floor, t_jitter) -> "FittedSPR":
    """``fit_spr(memory_lean=True)``: every factorization in the Gram's own
    buffer, every solve by panels; one N x N buffer at a time."""
    like = model.x_data
    y = model.y_data

    def upload(host):
        """A device copy of host data: the host array stays as it was."""
        return torch.as_tensor(np.asarray(host), dtype=like.dtype).to(like.device, copy=True)

    def device_gram():
        """The Gram the fit may overwrite: the kernel's, the caller's device
        tensor itself, or an upload of the caller's host array."""
        if gram is None:
            return model._gram(kernel_fn)
        if isinstance(gram, torch.Tensor):
            return torch.as_tensor(gram, dtype=like.dtype, device=like.device)
        return upload(gram)

    state = {"y_mean": model.y_mean, "y_std": model.y_std,
             "chol_lower": torch.tensor(0, dtype=torch.int32, device=like.device)}
    if var_floor:
        state["var_floor"] = torch.tensor(var_floor, dtype=like.dtype, device=like.device)
    host = None
    if model.likelihood.require:  # Student-t: the scaled Gram's factor, then freed
        if gram is not None:      # staged, so that neither factorization consumes it
            host = (gram.detach().cpu().numpy() if isinstance(gram, torch.Tensor)
                    else np.asarray(gram))
        a, b = model.likelihood._ab()
        df = 2.0 * a
        k = device_gram() if host is None else upload(host)
        k.mul_(b / a).diagonal().add_(t_jitter)
        u_t = inplace_blocked_cholesky(k)
        del k
        at = blocked_triangular_solve(u_t, y, trans=True)
        del u_t
        state["d"] = df + torch.sum(at * at)
        state["cond_df"] = df + model.num_data
        state["scale_ba"] = b / a
    u = inplace_blocked_cholesky(_add_diag_reg_(
        device_gram() if host is None else upload(host), eps))
    z = blocked_triangular_solve(u, y[:, None], trans=True)
    state["chol"] = u
    state["alpha"] = blocked_triangular_solve(u, z, trans=False)
    return FittedSPR(model, state)


class FittedSPR:
    """Cheap repeated prediction from a one-time :func:`fit_spr` solve."""

    def __init__(self, model, state: Dict[str, torch.Tensor]):
        self.model = model
        self.state = state
        self._kernel_fn = model.kernel.get_kernel_fn()
        self._student_t = "d" in state
        # The factor's orientation: lower L (A = L L^T) unless the state says
        # chol_lower = 0, the upper U (A = U^T U) of a memory-lean fit.
        cl = state.get("chol_lower")
        self._chol_lower = True if cl is None else bool(cl)
        self._var_floor = float(state["var_floor"]) if "var_floor" in state else 0.0

    # -- prediction -------------------------------------------------------

    def predict(self, x, batch: int = None):
        """De-normalized predictive mean and variance at ``x`` ([n], [n]).

        ``batch`` chunks the test points: the variance needs only the
        diagonal, but the cancellation-safe ordering builds a [c, c] test
        Gram per chunk; ~4096 keeps it at 64 MB. Each diagonal element is
        computed by the same arithmetic either way.
        """
        mean_n, var_n = self._posterior(x, batch=batch)
        return self._denorm(mean_n, var_n)

    def test_nll(self, x, y, batch: int = None):
        """Predictive NLL on de-normalized targets; equals SPR.test_nll."""
        mean_n, var_n = self._posterior(x, batch=batch)
        return self._score_nll(mean_n, var_n, y)

    def predict_given(self, k_td, k_tt_diag):
        """:meth:`predict` from precomputed Gram pieces: ``k_td`` [n, N] is
        K(x_test, x_train), ``k_tt_diag`` [n] the prior test variance, for
        pipelines that assemble their Grams outside the kernel function
        (``snngp_torch.examples.cifar_myrtle``). With only the diagonal,
        the variance takes the streaming form ``k_tt_diag - sum(v * v)``,
        which cancels in fp32 when the posterior variance is tiny: pair it
        with a ``var_floor`` at scale."""
        mean_n, var_n = self._posterior_given(k_td, k_tt_diag)
        return self._denorm(mean_n, var_n)

    def test_nll_given(self, k_td, k_tt_diag, y):
        """:meth:`test_nll` from precomputed Gram pieces (see
        :meth:`predict_given`); ``y`` is normalized like ``test_nll``'s."""
        mean_n, var_n = self._posterior_given(k_td, k_tt_diag)
        return self._score_nll(mean_n, var_n, y)

    def _denorm(self, mean_n, var_n):
        s = self.state
        mean = mean_n * s["y_std"] + s["y_mean"]
        var = var_n * s["y_std"] ** 2
        if self._student_t:
            var = (s["d"] / s["cond_df"]) * s["scale_ba"] * var
        return mean, var

    def _score_nll(self, mean_n, var_n, y):
        s = self.state
        y_den = y * s["y_std"] + s["y_mean"]
        mean = mean_n * s["y_std"] + s["y_mean"]
        var = var_n * s["y_std"] ** 2
        if self._student_t:
            sigma = torch.sqrt((s["d"] / s["cond_df"]) * s["scale_ba"] * var)
            log_prob = student_t_logpdf(y_den, s["cond_df"], mean, sigma)
        else:
            log_prob = normal_logpdf(y_den, mean, torch.sqrt(var))
        return -torch.mean(log_prob)

    def extend(self, x_new, y_new) -> "FittedSPR":
        """A new fitted predictor with ``m`` more training points, without
        refactorizing: the factor (and the Student-t scaled-Gram factor) grow
        by a bordered-block update (:func:`~snngp_torch.ops.linalg.chol_append`,
        O(N^2 m) against the O((N + m)^3) refit), ``alpha`` is solved
        against the new factor and the Student-t ``d`` recomputed.

        Needs ``fit_spr(..., extendable=True)``. ``y_new`` is raw-scale and
        normalized with the fit-time mean / std. The frozen regularizer goes
        on the new diagonal block, so the result equals a factorization of
        the same bordered matrix to fp32 resolution. The returned predictor
        holds a new ``SPR`` over the concatenated data that shares this
        one's kernel and likelihood modules. As in the JAX package, the
        extended state carries no ``var_floor``."""
        from snngp_torch.models.gp import SPR

        s = self.state
        if "reg" not in s:
            raise ValueError("extend() needs fit_spr(..., extendable=True)")
        model = self.model
        like = model.x_data
        x_new = torch.as_tensor(x_new, dtype=like.dtype, device=like.device)
        y_n = (torch.as_tensor(y_new, dtype=like.dtype, device=like.device).reshape(-1)
               - s["y_mean"]) / s["y_std"]

        k_nb = model.kernel.K(self._kernel_fn, model.x_data, x_new)   # [N, m]
        k_bb = model.kernel.K(self._kernel_fn, x_new)                 # [m, m]
        chol = chol_append(s["chol"], k_nb, add_jitter(k_bb, s["reg"]),
                           lower=self._chol_lower)

        new_model = SPR(model.kernel, model.likelihood, torch.cat([model.x_data, x_new]),
                        torch.cat([model.y_data, y_n]), model.y_mean, model.y_std)
        new_model.eps = model.eps
        y_all = new_model.y_data
        state = {"chol": chol, "alpha": self._solve(chol, y_all[:, None]),
                 "y_mean": s["y_mean"], "y_std": s["y_std"], "reg": s["reg"]}
        if "chol_lower" in s:
            state["chol_lower"] = s["chol_lower"]
        if self._student_t:
            ba = s["scale_ba"]
            chol_t = chol_append(s["chol_t"], ba * k_nb, add_jitter(ba * k_bb, 1e-6),
                                 lower=self._chol_lower)
            df = s["cond_df"] - model.num_data
            at = self._whiten_with(chol_t, y_all[:, None])
            state["chol_t"] = chol_t
            state["d"] = df + torch.sum(at * at)
            state["cond_df"] = df + new_model.num_data
            state["scale_ba"] = ba
        return FittedSPR(new_model, state)

    def _posterior(self, x, batch: int = None):
        """Normalized posterior mean + variance diagonal ([n], [n]).

        The variance is diag(k_tt - v^T v), the full-covariance form that
        ``gp_predict`` uses, not diag(k_tt) - sum(v*v): when the posterior
        variance is tiny the latter cancels catastrophically in fp32.
        """
        if batch is not None and x.shape[0] > batch:
            parts = [self._posterior(x[i:i + batch])
                     for i in range(0, x.shape[0], batch)]
            return (torch.cat([p[0] for p in parts]),
                    torch.cat([p[1] for p in parts]))
        model, s = self.model, self.state
        k_td = model.kernel.K(self._kernel_fn, x, model.x_data)  # [n, N]
        mean = (k_td @ s["alpha"]).flatten()
        v = self._whiten(k_td)                                   # [N, n]
        k_tt = model.kernel.K(self._kernel_fn, x)                # [n, n]
        var = torch.diagonal(k_tt - v.T @ v)
        if self._var_floor:
            var = torch.maximum(var, self._var_floor * torch.diagonal(k_tt))
        return mean, var

    def _posterior_given(self, k_td, k_tt_diag):
        """As :meth:`_posterior` from precomputed (k_td, diag(k_tt)), with the
        streaming variance (see :meth:`predict_given`)."""
        like = self.state["alpha"]
        k_td = torch.as_tensor(k_td, dtype=like.dtype, device=like.device)
        k_tt_diag = torch.as_tensor(k_tt_diag, dtype=like.dtype, device=like.device)
        mean = (k_td @ self.state["alpha"]).flatten()
        v = self._whiten(k_td)                                   # [N, n]
        var = k_tt_diag - torch.sum(v * v, dim=0)
        if self._var_floor:
            var = torch.maximum(var, self._var_floor * k_tt_diag)
        return mean, var

    def _whiten(self, k_td):
        """L^{-1} K* for the cached factor ([N, n])."""
        return self._whiten_with(self.state["chol"], k_td.T)

    def _whiten_with(self, chol, b):
        """L^{-1} b for a factor of this state's orientation: with the upper
        U = L^T, U^{-T} b by the panel solve (no copy of the factor)."""
        if self._chol_lower:
            return torch.linalg.solve_triangular(chol, b, upper=False)
        return blocked_triangular_solve(chol, b, trans=True)

    def _solve(self, chol, b):
        """A^{-1} b for a factor of this state's orientation."""
        if self._chol_lower:
            return chol_solve(chol, b)
        return blocked_triangular_solve(chol, blocked_triangular_solve(chol, b, trans=True))

    # -- persistence ------------------------------------------------------

    def save(self, path):
        """Write the fitted state to ``path`` (.npz); parameters travel too."""
        flat = dict(self.state)
        for name, leaf in P.named_leaves(self.model):
            flat["param:" + name] = leaf
        np.savez(path, **{k: torch.as_tensor(v).detach().cpu().numpy()
                          for k, v in flat.items()})

    @classmethod
    def load(cls, path, model):
        """Rebuild from :meth:`save` output (either package's). The saved
        parameters are loaded into ``model``; the state goes to its device."""
        like = model.x_data
        with np.load(path) as data:
            state = {k: torch.as_tensor(data[k], device=like.device)
                     for k in data.files if not k.startswith("param:")}
            saved = {k[len("param:"):]: data[k]
                     for k in data.files if k.startswith("param:")}
        model.load_state_dict(P.from_jax_named(saved))
        return cls(model, state)


def fit_svsp(model) -> "FittedSVSP":
    """One-time inducing-side solve for an :class:`snngp_torch.models.gp.SVSP`
    with the parameters it holds: the inducing Gram's jittered inverse, its
    relative-reg inverse (the eigh pseudo-inverse, or through the model's
    ``chol_fn`` when it has one, as ``SVSP._posterior_pieces`` computes
    them) and the ``q_mu`` solve."""
    z = model.inducing_variable.detach()
    eps = P.constrained_read(model.eps, model.bij)
    kernel_fn = model.kernel.get_kernel_fn()
    k_ii = model.kernel.K(kernel_fn, z)
    k_rel_inv = model._rel_inv(add_diag_reg(k_ii, eps))
    state = {
        "z": z,
        "k_ii_inv": inv_psd(add_jitter(k_ii, eps), model.chol_fn),
        "k_rel_inv": k_rel_inv,
        "w": k_rel_inv @ model.q_mu.T,                           # [I, C]
        "q_sqrt": P.constrained_read(model.q_sqrt, model.bij),
    }
    return FittedSVSP(model, {k: v.detach() for k, v in state.items()})


class FittedSVSP:
    """Cheap repeated classification from a one-time :func:`fit_svsp`
    solve. The samplers take a ``generator`` or injected ``draws``, as
    ``SVSP.test_acc_nll`` does."""

    def __init__(self, model, state: Dict[str, torch.Tensor]):
        self.model = model
        self.state = state
        self._kernel_fn = model.kernel.get_kernel_fn()

    def predict_f(self, x):
        """Latent posterior at ``x``: mean [C, B] and covariance [C, B, B]
        (the matrices of ``SVSP.test_acc_nll``)."""
        model, s = self.model, self.state
        k_bi = model.kernel.K(self._kernel_fn, x, s["z"])        # [B, I]
        k_bb = model.kernel.K(self._kernel_fn, x)                # [B, B]
        a_b = k_bi @ s["k_ii_inv"]                               # [B, I]
        mean = (k_bi @ s["w"]).T                                 # [C, B]
        b_b = k_bb - k_bi @ s["k_rel_inv"] @ k_bi.T
        cov = torch.einsum("ij,cj,kj->cik", a_b, s["q_sqrt"], a_b) + b_b[None]
        return mean, cov

    def _sample(self, x, num_samples, generator, draws):
        mean, cov = self.predict_f(x)
        return self.model.prior.sample_f_iid(mean, cov, num_samples, generator, draws)

    def predict_proba(self, x, num_samples=1000, generator=None, draws=None):
        """Mean MC predictive class probabilities [B, C] (rows sum to 1)."""
        f = self._sample(x, num_samples, generator, draws)        # [C, B, S]
        log_pbar = torch.logsumexp(torch.log_softmax(f, dim=0), dim=2) - math.log(num_samples)
        return torch.exp(log_pbar).T

    def test_acc_nll(self, x, y, num_samples=1000, generator=None, draws=None):
        """MC predictive NLL and correct count; equals ``SVSP.test_acc_nll``
        on the same draws."""
        f = self._sample(x, num_samples, generator, draws)
        return -test_log_likelihood(f, y), get_correct_count(f, y)

    def save(self, path):
        """Write the fitted state to ``path`` (.npz); parameters travel too
        (``param:<dotted name>``, the JAX package's layout)."""
        flat = dict(self.state)
        for name, leaf in P.named_leaves(self.model):
            flat["param:" + name] = leaf
        np.savez(path, **{k: torch.as_tensor(v).detach().cpu().numpy()
                          for k, v in flat.items()})

    @classmethod
    def load(cls, path, model):
        """Rebuild from :meth:`save` output (either package's): the saved
        parameters go into ``model``, the state to its device. A state saved
        before the eigh pseudo-inverse (a Cholesky factor ``chol_rel``) is
        turned into the explicit inverse and the ``q_mu`` solve."""
        like = model.inducing_variable
        with np.load(path) as data:
            state = {k: torch.as_tensor(data[k], device=like.device)
                     for k in data.files if not k.startswith("param:")}
            saved = {k[len("param:"):]: data[k]
                     for k in data.files if k.startswith("param:")}
        model.load_state_dict(P.from_jax_named(saved))
        if "k_rel_inv" not in state and "chol_rel" in state:
            chol_rel = state.pop("chol_rel")
            eye = torch.eye(chol_rel.shape[0], dtype=chol_rel.dtype, device=chol_rel.device)
            v = torch.linalg.solve_triangular(chol_rel, eye, upper=False)
            state["k_rel_inv"] = v.T @ v
            state["w"] = state["k_rel_inv"] @ model.q_mu.detach().T
        return cls(model, state)
