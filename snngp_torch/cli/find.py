"""Burr-XII importance-sampling hyperparameter grid search, ``reg find|fd``
(counterpart of ``snngp/cli/find.py``; rebuilds the reference's
``experiments/regression/find.py``).

For each (w_std, b_std) the NNGP train Gram is built once (K1 on the card);
for each eps the exact GP predictive is formed and its Gaussian NLL scored,
and for each (alpha, beta) the Student-t predictive NLL is estimated by
self-normalized importance sampling over the Burr-XII mixing scale q. Same
flags and defaults as the JAX package.

- ``-smp scipy`` keeps the host scipy Burr-XII draws (``random_state=101``,
  the reference's MT19937 stream), so both packages and the reference score
  the same draws.
- ``-smp device`` draws the uniforms from a ``torch.Generator`` seeded with
  101 on the device and maps them through the Burr-XII inverse CDF; the
  stream is not JAX's ``PRNGKey(101)`` (parity is tested by injecting the
  same uniforms into both).
- Either way the whole (alpha, beta, q) lattice is scored in one vectorized
  computation on the device.
- One Cholesky factor gives the quadratic form and the log-determinant; when
  ``cholesky_ex`` reports failure the cell falls back to the eigh
  pseudo-determinant, as the JAX package does.

The JAX package logs each cell's (alpha, beta) table as a pandas DataFrame;
the port formats it without pandas (rounded to four decimals, alpha down,
beta across). The minima lines are the same.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from snngp_torch.data.regression import DATASETS
from snngp_torch.models.likelihoods import normal_logpdf
from snngp_torch.ops.linalg import add_jitter, chol_logdet, chol_quad_form, gp_predict
from snngp_torch.utils import Logger, get_context_summary

WSL = [1, 1.4, 2]
BSL = [0, 0.3, 1]
EL = [float(f"1e{v}") for v in range(-6, 5)]
AL = [1, 2, 3]
BL = [1, 2, 3]
SEED = 101          # the reference's random_state (find.py:172)


def add_subparser(subparsers):
    parser = subparsers.add_parser("find", aliases=["fd"])
    parser.set_defaults(func=main)

    parser.add_argument("-n",   "--network",     choices=["resnet", "mlp"], default=None)
    parser.add_argument("-dn",  "--data-name",   choices=DATASETS, required=True)
    parser.add_argument("-dr",  "--data-root",   type=str, default="./data")
    parser.add_argument("-cd",  "--ckpt-dir",    type=str, required=True)

    parser.add_argument("-vp",  "--valid-prop",  type=float, default=0.1)
    parser.add_argument("-nd",  "--num-data",    type=int, default=None)

    parser.add_argument("-al",  "--alpha-list",  type=float, nargs="+", default=AL)
    parser.add_argument("-bl",  "--beta-list",   type=float, nargs="+", default=BL)
    parser.add_argument("-el",  "--eps-list",    type=float, nargs="+", default=EL)

    parser.add_argument("-nh",  "--num-hiddens", type=int, default=4)
    parser.add_argument("-act", "--activation",  choices=["erf", "relu"], default="relu")
    parser.add_argument("-wsl", "--w-std-list",  type=float, nargs="+", default=WSL)
    parser.add_argument("-bsl", "--b-std-list",  type=float, nargs="+", default=BSL)

    parser.add_argument("-ns",  "--num-is-samples", type=int, default=1000)
    parser.add_argument("-smp", "--sampler",     choices=["scipy", "device"],
                        default="scipy",
                        help="Burr-XII mixing draws: host scipy (the reference's "
                             "stream, find.py:172) or on-device inverse-CDF draws "
                             "from a torch.Generator seeded with 101")
    parser.add_argument("-s",   "--seed",        type=int, default=10)
    parser.add_argument("-q",   "--quite",       default=False, action="store_true")
    parser.add_argument("-c",   "--comment",     type=str, default="")


def _gaussian_nll(y, mean, cov):
    sigma = torch.sqrt(torch.diagonal(cov))
    return -torch.mean(normal_logpdf(y, mean, sigma))


def burr12_icdf(u, c, d):
    """Burr-XII inverse CDF: x = ((1 - u)^(-1/d) - 1)^(1/c)."""
    return ((1.0 - u) ** (-1.0 / d) - 1.0) ** (1.0 / c)


def device_uniforms(num_samples, device):
    """The ``-smp device`` uniforms on (1e-7, 1 - 1e-7), from a
    ``torch.Generator`` seeded with 101 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    u = torch.rand((num_samples,), generator=gen, device=device)
    return 1e-7 + u * ((1.0 - 1e-7) - 1e-7)


def device_draws(u, alphas, betas):
    """Burr-XII draws [A, B, S] of the whole (alpha, beta) lattice from one
    set of uniforms ``u`` [S]."""
    a = torch.as_tensor(alphas, dtype=u.dtype, device=u.device)[:, None, None]
    b = torch.as_tensor(betas, dtype=u.dtype, device=u.device)[None, :, None]
    return burr12_icdf(u[None, None, :], a, b)


def scipy_draws(alphas, betas, num_samples, device):
    """The reference's host draws, ``burr12.rvs(c=a, d=b, size=S,
    random_state=101)`` per cell, stacked to [A, B, S]."""
    from scipy import stats as scipy_stats

    q = [[scipy_stats.burr12.rvs(c=a, d=b, loc=0., scale=1., size=num_samples,
                                 random_state=SEED) for b in betas] for a in alphas]
    return torch.as_tensor(np.asarray(q, np.float32), device=device)


def tnll_lattice(sample_q, quad, logdet_term, num_train, y_, mean_, std_diag, y_std):
    """Student-t predictive NLLs [A, B] of a lattice of Burr-XII draws
    ``sample_q`` [A, B, S] by self-normalized importance sampling (the prior
    and proposal densities are the same Burr-XII and cancel).

    ``quad`` = y^T (K + eps I)^{-1} y; ``logdet_term`` = -(1/2) log det(K +
    eps I) - (N/2) log 2 pi."""
    log_prob_data = (logdet_term - 0.5 * quad / sample_q
                     - 0.5 * num_train * torch.log(sample_q))                 # [A, B, S]
    prob = torch.exp(log_prob_data - log_prob_data.amax(dim=-1, keepdim=True))
    w_bar = prob / prob.sum(dim=-1, keepdim=True)
    std = torch.sqrt(sample_q)[..., None] * std_diag                          # [A, B, S, n]
    log_probs = (torch.log(w_bar + 1e-24)[..., None]
                 + normal_logpdf(y_, mean_, std * y_std))
    return -torch.mean(torch.logsumexp(log_probs, dim=-2), dim=-1)


def format_table(table, alphas, betas):
    """The (alpha, beta) table rounded to four decimals, alpha down and beta
    across (the JAX package logs it as a pandas DataFrame)."""
    head = " " * 8 + "".join(f"{b:>10g}" for b in betas)
    rows = [f"{a:<8g}" + "".join(f"{v:>10.4f}" for v in row) for a, row in zip(alphas, table)]
    return "\n".join([head, *rows])


def _marginal_pieces(cov_data, eps, y_train, minus_log_two_pi):
    """(quad, logdet_term) of the marginal at (K + eps I): from one
    Cholesky factor, or, where ``cholesky_ex`` fails, the eigh
    pseudo-determinant (the reference scores those cells with scipy's
    ``allow_singular=True``)."""
    cov_data_eps = add_jitter(cov_data, eps)
    chol, info = torch.linalg.cholesky_ex(cov_data_eps)
    if int(info) > 0:
        evals, evecs = torch.linalg.eigh(cov_data_eps)
        keep = evals > 1e-10 * evals.max()
        safe = torch.where(keep, evals, torch.ones_like(evals))
        z = evecs.T @ y_train
        quad = torch.sum(torch.where(keep, z * z / safe, torch.zeros_like(z)))
        logdet = torch.sum(torch.where(keep, torch.log(safe), torch.zeros_like(safe)))
        return quad, minus_log_two_pi - 0.5 * logdet
    return chol_quad_form(chol, y_train), minus_log_two_pi - 0.5 * chol_logdet(chol)


def main(args):
    logger = Logger(args.ckpt_dir, quite=args.quite)
    logger.log(get_context_summary(args, {}))
    try:
        with torch.inference_mode():
            _search(args, logger)
    except Exception:
        import traceback
        logger.log(f"\n{traceback.format_exc()}\nStopped")
        raise
    finally:
        logger.close()


def _search(args, logger):
    from snngp_torch.cli.regression import _load_splits, _resolve_network

    (x_train, y_train), _, (x, y), (y_std, y_mean) = _load_splits(
        args.data_name, args.data_root, args.seed, args.device)
    num_train = x_train.shape[0]
    args.network, base_kernel_fn = _resolve_network(args.network)
    y_ = y * y_std + y_mean

    min_t, min_tv = None, float("inf")
    min_g, min_gv = None, float("inf")
    il, jl, kl = len(args.w_std_list), len(args.b_std_list), len(args.eps_list)
    total = il * jl * kl
    minus_log_two_pi = -(num_train / 2) * math.log(2 * math.pi)
    if args.sampler == "device":
        sample_q = device_draws(device_uniforms(args.num_is_samples, x_train.device),
                                args.alpha_list, args.beta_list)
    else:
        sample_q = scipy_draws(args.alpha_list, args.beta_list, args.num_is_samples,
                               x_train.device)

    for i, w_std in enumerate(args.w_std_list):
        for j, b_std in enumerate(args.b_std_list):
            kernel_fn = base_kernel_fn(args.num_hiddens, act=args.activation,
                                       w_std=w_std, b_std=b_std, last_w_std=1.)
            cov_data = kernel_fn(x_train, x_train, get="nngp")

            for k, eps in enumerate(args.eps_list):
                mean, cov = gp_predict(kernel_fn, x_train, y_train[:, None], x,
                                       diag_reg=eps)
                mean_ = mean.flatten() * y_std + y_mean
                gnll = float(_gaussian_nll(y_, mean_, cov * y_std ** 2))
                if gnll < min_gv:
                    min_g, min_gv = (w_std, b_std, eps), gnll

                quad, logdet_term = _marginal_pieces(cov_data, eps, y_train,
                                                     minus_log_two_pi)
                std_diag = torch.sqrt(torch.diagonal(cov))
                table = tnll_lattice(sample_q, quad, logdet_term, num_train, y_, mean_,
                                     std_diag, y_std).tolist()
                for a, row in zip(args.alpha_list, table):
                    for b, tnll in zip(args.beta_list, row):
                        if tnll < min_tv:
                            min_t, min_tv = (w_std, b_std, a, b, eps), tnll

                logger.log(f"\n{w_std}-{b_std}-{eps}: "
                           f"{i * jl * kl + j * kl + k + 1} / {total} "
                           f"({i + 1}/{il}, {j + 1}/{jl}, {k + 1}/{kl})")
                logger.log(f"{format_table(table, args.alpha_list, args.beta_list)}\n")
                logger.log(f"({min_t}): {min_tv:.4f}")
                logger.log(f"({min_g}): {min_gv:.4f}")

    logger.log(f"({min_t}): {min_tv:.4f}")
    logger.log(f"({min_g}): {min_gv:.4f}")
