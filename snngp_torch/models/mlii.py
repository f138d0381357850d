"""Full-Gram ML-II: exact marginal-likelihood gradients over a tiled Gram
(counterpart of ``snngp/models/mlii.py``).

The reference trains the kernel scales by gradients through the Gram and
its factorization in one differentiable computation, which caps N at what
one reverse-mode factorization holds. Here the Gram is assembled in
[block, block] tiles on the host, and the gradient is taken in closed form:

    dL/dtheta = <G, dK/dtheta>,    G = dL/dK

with L the per-datapoint marginal NLL of ``SPR.loss`` at S = K + eps I
(absolute eps), alpha = S^{-1} y and q = y^T alpha:

    Gaussian:   G = (1/2N) (S^{-1} - alpha alpha^T)
    Student-t (shape (b/a) S, df = 2a):
                G = (1/2N) S^{-1} - kappa alpha alpha^T,
                kappa = (a/b)(2a + N) / (2N (2a + (a/b) q)).

One step costs one augmented tiled assembly, (K, dK/dw_std, dK/db_std)
from the tangent mode of the fused Myrtle Gram (K7 on the card;
:func:`snngp_torch.ops.myrtle_gram.myrtle_gram_scale_grads`);
dK/dlast_w_std = (2 / last) K needs no contraction. Then one factorization
on the device (``torch.linalg.cholesky_ex``, cuSOLVER), the S^{-1} column
panels streamed to the host for the two dK contractions in float64, and
scalar closed forms for eps; the (a, b) gradients come from autograd of
:func:`marginal_nll_from_scalars`.

Divergences from the JAX package:

- the factor is the lower L of K + eps I, from ``cholesky_ex`` on the
  device, written over S's own storage (JAX: the upper factor of its
  in-place blocked factorization); both hold one N^2 buffer;
  q = |L^{-1} y|^2, logdet S = 2 sum log diag(L), and a factorization that
  fails puts NaN on the factor's diagonal, so the loss is NaN;
- alpha^T dK alpha accumulates in float64 (:func:`_quad_host` casts each
  row chunk; JAX's multiplies the chunk by alpha in float32). The
  gradient's two terms can cancel (d/db_std on images that share a large
  mean), and float32 sums there put the closed form farther from float64
  than autograd through the Gram;
- ragged last blocks are not padded (the kernels take any N);
- a diagonal tile passes one block object as both operands, which the fused
  Gram's tangent mode takes as its symmetric launch (each pair of
  K(x_i, x_i) once, mirrored);
- tiles are copied to pinned host memory as soon as they are launched, so
  the host writes tile t to its memmap while the device runs tile t + 1
  (:mod:`snngp_torch.ops.tiled`, shared with ``myrtle_gram_tiled``).
"""

from __future__ import annotations

import math
import os
import shutil
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from snngp_torch.models import params as P
from snngp_torch.models.bijectors import positive
from snngp_torch.ops.linalg import _nan_where_failed
from snngp_torch.ops.tiled import assemble_tiles
from snngp_torch.utils.optim import Adam

__all__ = ["marginal_nll_from_scalars", "gram_cotangent_coeffs",
           "tiled_aug_gram", "full_gram_mlii_value_and_grad",
           "MLIIFullState", "mlii_fit_full"]


def marginal_nll_from_scalars(q, logdet_s, n, ab=None):
    """Per-datapoint marginal NLL as a function of ``q = y^T S^{-1} y`` and
    ``logdet_s = logdet(S)`` (float32 tensors or numbers). ``ab=None`` gives
    the Gaussian marginal, ``ab=(a, b)`` the Student-t one with shape
    ``(b/a) S`` and ``df = 2a``. Differentiable in everything, so the (a, b)
    gradients come from autograd of this function (S does not depend on
    them)."""
    f32 = dict(dtype=torch.float32)
    q = torch.as_tensor(q, **f32)
    logdet_s = torch.as_tensor(logdet_s, **f32)
    n_f = torch.as_tensor(float(n), **f32)
    if ab is None:
        return (q + logdet_s + n_f * math.log(2.0 * math.pi)) / (2.0 * n_f)
    a, b = (torch.as_tensor(v, **f32) for v in ab)
    df = 2.0 * a
    half = 0.5 * (df + n_f)
    quad_sigma = (a / b) * q
    logdet_sigma = n_f * torch.log(b / a) + logdet_s
    neg_logp = (half * torch.log1p(quad_sigma / df)
                + 0.5 * n_f * torch.log(df * math.pi)
                - torch.lgamma(half) + torch.lgamma(0.5 * df)
                + 0.5 * logdet_sigma)
    return neg_logp / n_f


def gram_cotangent_coeffs(q, n, ab=None):
    """(c_inv, c_aa) with ``dL/dK = c_inv S^{-1} + c_aa alpha alpha^T`` for
    the marginal NLL of :func:`marginal_nll_from_scalars`."""
    n_f = float(n)
    if ab is None:
        return 1.0 / (2.0 * n_f), -1.0 / (2.0 * n_f)
    a, b = float(ab[0]), float(ab[1])
    c_aa = -(a / b) * (2.0 * a + n_f) / (2.0 * n_f * (2.0 * a + (a / b) * float(q)))
    return 1.0 / (2.0 * n_f), c_aa


def tiled_aug_gram(aug_fn: Callable, x, *, block: int,
                   resume_dir: Optional[str] = None, log=None,
                   profile_fn: Optional[Callable] = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Assemble host (K, dK/dw_std, dK/db_std) [N, N] float32 arrays from
    augmented-kernel tiles.

    ``aug_fn(x1_block, x2_block) -> (k, dkw, dkb)`` gives [b1, b2] tiles
    (e.g. :func:`~snngp_torch.ops.myrtle_gram.myrtle_gram_scale_grads`).
    Only upper-triangle tiles are computed and mirrored: all three outputs
    are symmetric. A diagonal tile gets one block object as both operands.

    ``profile_fn(x_block)`` (optional) caches a per-block precompute, such
    as :func:`~snngp_torch.ops.myrtle_gram.myrtle_profile_tangents`, once
    per block: tiles then run as ``aug_fn(x1, x2, profiles=(prof_i,
    prof_j))``.

    ``resume_dir`` makes the assembly resumable in the JAX package's layout
    (``aug_k.npy``, ``aug_dkw.npy``, ``aug_dkb.npy`` memmaps and the tile
    bitmap ``aug.done.npy``, flushed per tile), so either package resumes
    the other's directory. Tile t + 1 is launched before tile t is written
    to the host arrays (:func:`snngp_torch.ops.tiled.assemble_tiles`). The
    last block is ragged, not padded."""
    n = x.shape[0]
    todo = [(i, j) for i in range(0, n, block) for j in range(i, n, block)]

    prof_cache: Dict[int, object] = {}

    def prof(i):
        if i not in prof_cache:
            prof_cache[i] = profile_fn(x[i:i + block])
        return prof_cache[i]

    def launch(i, j):
        x1 = x[i:i + block]
        x2 = x1 if i == j else x[j:j + block]       # one object: a symmetric launch
        if profile_fn is None:
            return aug_fn(x1, x2)
        return aug_fn(x1, x2, profiles=(prof(i), prof(j)))

    paths = done_path = None
    if resume_dir is not None:
        os.makedirs(resume_dir, exist_ok=True)
        paths = [os.path.join(resume_dir, f"aug_{nm}.npy") for nm in ("k", "dkw", "dkb")]
        done_path = os.path.join(resume_dir, "aug.done.npy")
    return tuple(assemble_tiles(todo, launch, (n, n), count=3, mirror=True, paths=paths,
                                done_path=done_path, log=log, label="tiled_aug_gram"))


def _f64_frob(a: np.ndarray, b: np.ndarray, chunk: int = 1 << 22) -> float:
    """<A, B> elementwise with float64 accumulation, streaming (memmap-safe)."""
    total = 0.0
    av, bv = a.reshape(-1), b.reshape(-1)
    for s in range(0, av.shape[0], chunk):
        total += float(np.sum(av[s:s + chunk].astype(np.float64)
                              * bv[s:s + chunk].astype(np.float64)))
    return total


def _quad_host(mat: np.ndarray, vec: np.ndarray, chunk: int = 4096) -> float:
    """vec^T mat vec with float64 accumulation, row-streamed (memmap-safe):
    each row chunk is cast, so the inner sums are float64 too."""
    v64 = vec.astype(np.float64)
    total = 0.0
    for s in range(0, mat.shape[0], chunk):
        total += float(v64[s:s + chunk] @ (mat[s:s + chunk].astype(np.float64) @ v64))
    return total


def _default_device(*candidates):
    for c in candidates:
        if isinstance(c, torch.Tensor):
            return c.device
    return torch.device("cuda")


def full_gram_mlii_value_and_grad(k, dkw, dkb, y, *, last_w_std, eps, ab=None,
                                  panel: int = 2048, log=None, device=None
                                  ) -> Tuple[float, Dict[str, float]]:
    """Exact marginal NLL and constrained-space gradients from one assembled
    augmented Gram.

    ``k`` / ``dkw`` / ``dkb`` are host [N, N] arrays (memmaps fine) from
    :func:`tiled_aug_gram`; ``eps`` is the absolute diagonal regularizer
    (``SPR.loss``'s); ``ab=(a, b)`` selects the Student-t marginal. Returns
    ``(loss, grads)`` with grads over ``{w_std, b_std, last_w_std, eps[, a,
    b]}`` in constrained space (:func:`mlii_fit_full` chains them through
    the bijector).

    The factorization and the solves run on ``device`` (default: ``y``'s
    device if ``y`` is a tensor, else CUDA); the device holds K + eps I,
    factored in its own storage, and one [N, panel] S^{-1} panel at a time,
    which goes to the host for the float64 contractions."""
    device = torch.device(device) if device is not None else _default_device(y)
    n = k.shape[0]
    y_dev = torch.as_tensor(y, dtype=torch.float32).reshape(-1).to(device)
    with torch.no_grad():
        s = torch.tensor(np.asarray(k), dtype=torch.float32, device=device)   # a copy
        s.diagonal().add_(torch.as_tensor(eps, dtype=torch.float32, device=device))
        # Factor in place: S is symmetric, so its transpose view is the same
        # matrix in the column-major layout the factorization writes, and the
        # lower factor overwrites S's storage (one N^2 buffer, not two).
        chol = _nan_where_failed(*torch.linalg.cholesky_ex(s.mT, out=(s.mT, torch.empty(
            (), dtype=torch.int32, device=device))))
        del s
        z = torch.linalg.solve_triangular(chol, y_dev[:, None], upper=False)
        alpha = torch.linalg.solve_triangular(chol.mT, z, upper=True)[:, 0]
        q_f = float(torch.dot(z[:, 0], z[:, 0]))                   # y^T S^{-1} y
        logdet_f = float(2.0 * torch.sum(torch.log(torch.diagonal(chol))))
        alpha_h = alpha.cpu().numpy()

        # S^{-1} column panels: two triangular solves on an identity panel,
        # fetched to the host; the diagonal accumulates tr(S^{-1}).
        p = min(panel, n)
        rows = torch.arange(n, device=device)[:, None]
        sinv_dkw = sinv_dkb = tr_sinv = 0.0
        for col in range(0, n, p):
            e = (rows == col + torch.arange(p, device=device)[None, :]).to(torch.float32)
            sp = torch.linalg.solve_triangular(
                chol.mT, torch.linalg.solve_triangular(chol, e, upper=False), upper=True)
            w_eff = min(p, n - col)                  # tail panel: drop the pad columns
            sp = sp.cpu().numpy()[:, :w_eff]
            sinv_dkw += _f64_frob(sp, dkw[:, col:col + w_eff])
            sinv_dkb += _f64_frob(sp, dkb[:, col:col + w_eff])
            tr_sinv += float(np.sum(np.diagonal(sp, offset=-col).astype(np.float64)[:w_eff]))
            if log is not None:
                log(f"mlii: S^-1 panel {col // p + 1}/{-(-n // p)}")
        del chol

    aa_dkw = _quad_host(dkw, alpha_h)
    aa_dkb = _quad_host(dkb, alpha_h)
    aa_norm = float(np.sum(alpha_h.astype(np.float64) ** 2))

    return closed_form_value_and_grad(q_f, logdet_f, n, sinv_dkw, sinv_dkb, tr_sinv, aa_dkw,
                                      aa_dkb, aa_norm, last_w_std=last_w_std, eps=eps, ab=ab)


def closed_form_value_and_grad(q, logdet_s, n, sinv_dkw, sinv_dkb, tr_sinv, aa_dkw, aa_dkb,
                               aa_norm, *, last_w_std, eps, ab=None
                               ) -> Tuple[float, Dict[str, float]]:
    """The loss and constrained-space gradients from the scalars of one step:
    q = y^T S^{-1} y, logdet S, <S^{-1}, dK/dw_std>, <S^{-1}, dK/db_std>,
    tr S^{-1}, alpha^T dK/dw_std alpha, alpha^T dK/db_std alpha and
    |alpha|^2 (shared with :mod:`snngp_torch.parallel.mlii`)."""
    c_inv, c_aa = gram_cotangent_coeffs(q, n, ab=ab)
    grads = {
        "w_std": c_inv * sinv_dkw + c_aa * aa_dkw,
        "b_std": c_inv * sinv_dkb + c_aa * aa_dkb,
        # dK/dlast = (2/last) K; <S^{-1}, K> = N - eps tr(S^{-1}) and
        # alpha^T K alpha = q - eps |alpha|^2 (S alpha = y): no contraction.
        "last_w_std": (2.0 / float(last_w_std)) * (
            c_inv * (n - float(eps) * tr_sinv) + c_aa * (q - float(eps) * aa_norm)),
        "eps": c_inv * tr_sinv + c_aa * aa_norm,     # tr(G): dS/deps = I
    }
    if ab is None:
        loss = float(marginal_nll_from_scalars(q, logdet_s, n))
    else:
        with torch.inference_mode(False), torch.enable_grad():
            scalars = torch.tensor([float(ab[0]), float(ab[1])], requires_grad=True)
            loss_v = marginal_nll_from_scalars(q, logdet_s, n, ab=(scalars[0], scalars[1]))
            (dab,) = torch.autograd.grad(loss_v, scalars)
        loss = float(loss_v.detach())
        grads["a"], grads["b"] = float(dab[0]), float(dab[1])
    return loss, grads


class _Raw(nn.Module):
    """Unconstrained scalars under the JAX package's dotted names (``eps``,
    ``kernel.<scale>``, ``likelihood.{a,b}``), so that ``named_parameters``
    sorted is the JAX parameter pytree's order."""

    def __init__(self, named: Dict[str, torch.Tensor]):
        super().__init__()
        groups: Dict[str, Dict[str, nn.Parameter]] = {}
        for name, value in named.items():
            head, _, leaf = name.rpartition(".")
            param = nn.Parameter(torch.as_tensor(value, dtype=torch.float32).clone())
            if head:
                groups.setdefault(head, {})[leaf] = param
            else:
                self.register_parameter(name, param)
        for head, leaves in groups.items():
            self.add_module(head, nn.ParameterDict(leaves))


class MLIIFullState:
    """Resumable optimizer state of :func:`mlii_fit_full`: the unconstrained
    parameters (a module of scalars under the JAX dotted names), their
    :class:`~snngp_torch.utils.optim.Adam` and the step counter. The
    ``.npz`` holds ``step``, ``param:<name>``, ``mu:<name>``, ``nu:<name>``
    and ``opt_step``, the JAX package's keys, so a file written by either
    package loads in the other."""

    def __init__(self, params: nn.Module, opt_state: Adam, step: int):
        self.params = params
        self.opt_state = opt_state
        self.step = step

    def save(self, path):
        names = [name for name, _ in P.named_leaves(self.params)]
        flat = {"step": np.asarray(self.step)}
        for name, leaf in P.named_leaves(self.params):
            flat["param:" + name] = leaf.detach().cpu().numpy()
        for name, m, v in zip(names, self.opt_state.mu, self.opt_state.nu):
            flat["mu:" + name] = m.cpu().numpy()
            flat["nu:" + name] = v.cpu().numpy()
        flat["opt_step"] = self.opt_state.step.cpu().numpy()
        np.savez(path, **flat)

    @classmethod
    def load(cls, path):
        with np.load(path) as data:
            step = int(data["step"])
            groups = {"param": {}, "mu": {}, "nu": {}}
            for key in data.files:
                for g in groups:
                    if key.startswith(g + ":"):
                        groups[g][key[len(g) + 1:]] = np.asarray(data[key])
            opt_step = np.asarray(data["opt_step"])
        params = _Raw(groups["param"])
        opt = Adam(params)
        opt.load_state_leaves([opt_step, *(groups["mu"][n] for n in opt.names),
                               *(groups["nu"][n] for n in opt.names)])
        return cls(params, opt, step)


def _chain_grads(params: nn.Module, bij, grads_c: Dict[str, float]):
    """Constrained-space gradients -> the raw parameters' ``.grad``,
    dL/du = dL/dt * dt/du through the bijector (what autograd of
    ``SPR.loss`` gives on the raw parameters)."""
    for name, raw in params.named_parameters():
        g = torch.tensor(grads_c[name.rpartition(".")[2]], dtype=raw.dtype)
        with torch.enable_grad():
            (raw.grad,) = torch.autograd.grad(bij(raw), raw, g)


def mlii_fit_full(aug_builder: Callable, x, y, *, steps: int, lr: float,
                  block: int, init_hyper: Dict[str, float], eps: float,
                  ab: Optional[Tuple[float, float]] = None,
                  panel: int = 2048, resume_dir: Optional[str] = None,
                  profile_builder: Optional[Callable] = None,
                  log=print, device=None):
    """Full-Gram ML-II Adam loop at tiled scale.

    ``aug_builder(w_std, b_std, last_w_std) -> aug_fn`` with
    ``aug_fn(x1_blk, x2_blk) -> (k, dkw, dkb)`` tiles, e.g. ``lambda w, b,
    l: lambda a, c, profiles=None: myrtle_gram_scale_grads(a, c, depth=5,
    w_std=w, b_std=b, last_w_std=l, profiles=profiles)``.
    ``profile_builder(w_std, b_std) -> profile_fn`` (optional) enables the
    per-block profile cache of :func:`tiled_aug_gram`, rebuilt each step.

    The parameters live unconstrained behind the softplus bijector (the
    storage of ``SPR``), and the objax-exact Adam of
    :mod:`snngp_torch.utils.optim` steps them, so this is ``reg tr``'s
    optimizer on the closed-form gradient.

    ``resume_dir`` keeps each step's tile directory (``step<NNN>``,
    removed when the step completes) and the optimizer state
    (``mlii_state.npz``); a re-run with the same directory continues from
    the last completed step. ``device``: where the factorization runs
    (default: ``x``'s device if ``x`` is a tensor, else CUDA).

    Returns ``(hyper, eps, ab, losses)``: the constrained final values and
    the losses of the steps this call ran."""
    device = torch.device(device) if device is not None else _default_device(x, y)
    bij = positive()
    init = {"kernel." + k: bij.inverse(torch.tensor(float(v))) for k, v in init_hyper.items()}
    init["eps"] = bij.inverse(torch.tensor(float(eps)))
    if ab is not None:
        init["likelihood.a"] = bij.inverse(torch.tensor(float(ab[0])))
        init["likelihood.b"] = bij.inverse(torch.tensor(float(ab[1])))
    params = _Raw(init)
    opt = Adam(params)
    start = 0
    state_path = os.path.join(resume_dir, "mlii_state.npz") if resume_dir else None
    if state_path and os.path.exists(state_path):
        st = MLIIFullState.load(state_path)
        params, opt, start = st.params, st.opt_state, st.step
        log(f"mlii_fit_full: resuming at step {start}")

    def read():
        with torch.no_grad():
            return {name.rpartition(".")[2]: float(bij(raw))
                    for name, raw in params.named_parameters()}

    losses = []
    for step in range(start, steps):
        t0 = time.time()
        c = read()
        aug_fn = aug_builder(c["w_std"], c["b_std"], c["last_w_std"])
        prof_fn = (profile_builder(c["w_std"], c["b_std"])
                   if profile_builder is not None else None)
        step_dir = os.path.join(resume_dir, f"step{step:03d}") if resume_dir else None
        k, dkw, dkb = tiled_aug_gram(aug_fn, x, block=block, resume_dir=step_dir,
                                     log=log, profile_fn=prof_fn)
        t_asm = time.time() - t0
        loss, g_c = full_gram_mlii_value_and_grad(
            k, dkw, dkb, y, last_w_std=c["last_w_std"], eps=c["eps"],
            ab=(c["a"], c["b"]) if ab is not None else None, panel=panel,
            device=device)
        del k, dkw, dkb
        _chain_grads(params, bij, g_c)
        opt.update(lr)
        losses.append(loss)
        log(f"mlii_fit_full: step {step + 1}/{steps} nll {loss:.5f} "
            f"({time.time() - t0:.1f}s, assembly {t_asm:.1f}s) -> {read()}")
        if state_path:
            MLIIFullState(params, opt, step + 1).save(state_path)
            if step_dir and os.path.isdir(step_dir):
                shutil.rmtree(step_dir)        # parameters changed: tiles stale

    final = read()
    hyper = {k: final[k] for k in ("w_std", "b_std", "last_w_std")}
    out_ab = (final["a"], final["b"]) if ab is not None else None
    return hyper, final["eps"], out_ab, losses
