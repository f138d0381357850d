"""Online exact-GP / TP regression on the port: grow the conditioning set
without refits (counterpart of ``examples/online_regression.py``).

A fitted predictor takes batches as they arrive through
:meth:`~snngp_torch.models.predictor.FittedSPR.extend`: each arrival costs
one bordered Cholesky update, O(N^2 m)
(:func:`~snngp_torch.ops.linalg.chol_append`), where a refit costs
O((N + m)^3). After every batch it prints the held-out NLL and the wall
clock of the extension beside that of a full refit at the same size.

    python -m snngp_torch.examples.online_regression --device cuda \
        --n0 256 --batch 64 --rounds 6
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from snngp_torch.models import (SPR, GaussianLikelihood, NNGPKernel, StudentTLikelihood,
                                fit_spr)
from snngp_torch.nn.arch import get_mlp_kernel


def make_stream(n_total, d, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n_total, d).astype(np.float32)
    w = rng.randn(d) / np.sqrt(d)
    y = (np.sin(2.0 * x @ w) + 0.05 * rng.randn(n_total)).astype(np.float32)
    return x, y


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Run the rounds; returns a list of (N, extend_s, refit_s, test NLL),
    round 0's extend_s being the first fit's time and refit_s None."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--method", choices=["gp", "tp"], default="tp")
    ap.add_argument("--n0", type=int, default=256, help="initial training-set size")
    ap.add_argument("--batch", type=int, default=64, help="points per arriving batch")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--n-test", type=int, default=256)
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--eps", type=float, default=1e-4)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: CUDA is not available")
    device = torch.device(args.device)

    n_total = args.n0 + args.rounds * args.batch + args.n_test
    x, y = make_stream(n_total, args.dim, seed=0)
    x_test, y_test = x[-args.n_test:], y[-args.n_test:]
    y_mean, y_std = float(y[:args.n0].mean()), float(y[:args.n0].std())

    def get_kernel_fn(w, b, l):
        return get_mlp_kernel(3, act="relu", w_std=w, b_std=b, last_w_std=l,
                              trainable_inputs=False)

    kernel = NNGPKernel(get_kernel_fn, 1.5, 0.3, 1.0)
    lik = StudentTLikelihood(2.0, 2.0) if args.method == "tp" else GaussianLikelihood()

    def spr(n):
        y_n = (y[:n] - y_mean) / y_std
        return SPR(kernel, lik, x[:n], y_n, y_mean, y_std, eps=args.eps).to(device)

    xt_test = torch.as_tensor(x_test, device=device)
    y_test_n = torch.as_tensor((y_test - y_mean) / y_std, device=device)
    rows = []
    with torch.inference_mode():
        model = spr(args.n0)
        t0 = time.perf_counter()
        fitted = fit_spr(model, extendable=True)
        _sync(device)
        t_fit = time.perf_counter() - t0
        nll = float(fitted.test_nll(xt_test, y_test_n))
        print(f"round 0: N={args.n0:5d}  fit {t_fit:6.2f}s  test NLL {nll:8.4f}")
        rows.append((args.n0, t_fit, None, nll))

        for r in range(1, args.rounds + 1):
            lo = args.n0 + (r - 1) * args.batch
            xb = torch.as_tensor(x[lo:lo + args.batch], device=device)
            yb = torch.as_tensor(y[lo:lo + args.batch], device=device)
            t0 = time.perf_counter()
            fitted = fitted.extend(xb, yb)
            _sync(device)
            t_ext = time.perf_counter() - t0

            # The full refit at the same size (what the reference would do).
            m_ref = spr(lo + args.batch)
            t0 = time.perf_counter()
            fit_spr(m_ref)
            _sync(device)
            t_refit = time.perf_counter() - t0

            nll = float(fitted.test_nll(xt_test, y_test_n))
            print(f"round {r}: N={fitted.model.num_data:5d}  extend {t_ext:6.2f}s vs "
                  f"refit {t_refit:6.2f}s  test NLL {nll:8.4f}")
            rows.append((fitted.model.num_data, t_ext, t_refit, nll))
    return rows


if __name__ == "__main__":
    main()
