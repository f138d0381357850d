"""Regression subcommands: test / predict (counterpart of ``reg ts`` and
``reg pr`` in ``snngp/cli/regression.py``; ``tr`` and ``fd`` come with
training, ``pr``'s ``--add-x`` / ``--add-y`` with ``FittedSPR.extend``).

Same flags, data pipeline (double seeded permutation, byte-identical to the
reference's order) and restore-by-suffix path. Every tensor lives on the
device named by ``python -m snngp_torch --device``.

Divergence from the JAX package: it logs a failure's traceback and exits 0;
the port logs it the same way and then re-raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from snngp_torch.data.regression import get_dataset, permute_dataset, split_dataset
from snngp_torch.models import (SPR, FittedSPR, GaussianLikelihood, NNGPKernel,
                                StudentTLikelihood, fit_spr)
from snngp_torch.models.params import assign_by_suffix, get_by_suffix
from snngp_torch.nn.arch import get_dense_resnet_kernel, get_mlp_kernel
from snngp_torch.utils import Checkpointer, Logger, load_named


def add_subparser(subparsers):
    parser = subparsers.add_parser("regression", aliases=["reg"])
    sub = parser.add_subparsers(metavar="ops")
    _add_test_parser(sub)
    _add_predict_parser(sub)


def _load_splits(data_name, data_root, seed, device):
    """Shared data assembly: seed-10 permutation, 0.8/0.1/0.1 split, then the
    seeded train/valid re-permutation (reference train.py:97-109)."""
    x, y = get_dataset(name=data_name, root=data_root)
    x, y = permute_dataset(x, y, seed=10)
    splits = split_dataset(x, y, train=0.8, valid=0.1, test=0.1)
    (x_train, y_train), (x_valid, y_valid), (x_test, y_test), (y_std, y_mean) = splits

    num_train = x_train.shape[0]
    x_tv = np.concatenate([x_train, x_valid], axis=0)
    y_tv = np.concatenate([y_train, y_valid], axis=0)
    x_tv, y_tv = permute_dataset(x_tv, y_tv, seed=seed)
    x_train, x_valid = x_tv[:num_train], x_tv[num_train:]
    y_train, y_valid = y_tv[:num_train], y_tv[num_train:]

    def to_t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    return ((to_t(x_train), to_t(y_train)), (to_t(x_valid), to_t(y_valid)),
            (to_t(x_test), to_t(y_test)), (to_t(y_std), to_t(y_mean)))


def _resolve_network(network):
    if network is None or network == "mlp":
        return "mlp", get_mlp_kernel
    if network == "resnet":
        return "resnet", get_dense_resnet_kernel
    raise ValueError(f"Unsupported network '{network}'")


def _build_model(args_like, x_train, y_train, y_mean, y_std):
    network, base_kernel_fn = _resolve_network(args_like["network"])

    def get_kernel_fn(w_std, b_std, last_w_std):
        return base_kernel_fn(args_like["num_hiddens"], act=args_like["activation"],
                              w_std=w_std, b_std=b_std, last_w_std=last_w_std)

    kernel = NNGPKernel(get_kernel_fn, args_like["w_std"], args_like["b_std"],
                        args_like["last_w_std"])
    if args_like["method"] == "gp":
        likelihood = GaussianLikelihood()
    elif args_like["method"] == "tp":
        likelihood = StudentTLikelihood(args_like["alpha"], args_like["beta"])
    else:
        raise ValueError(f"Unsupported method '{args_like['method']}'")

    model = SPR(kernel, likelihood, x_train, y_train, y_mean, y_std,
                eps=args_like["epsilon"])
    return model.to(x_train.device), network


# ---------------------------------------------------------------------------
# test (experiments/regression/test.py)
# ---------------------------------------------------------------------------

def _add_test_parser(subparsers):
    parser = subparsers.add_parser("test", aliases=["ts"])
    parser.set_defaults(func=test_main)

    parser.add_argument("-dr", "--data-root",  type=str, default="./data")
    parser.add_argument("-cd", "--ckpt-dir",   type=str, required=True)
    parser.add_argument("-ci", "--ckpt-index", type=int, default=None)
    parser.add_argument("-vp", "--valid-prop", type=float, default=0.1)
    parser.add_argument("-nd", "--num-data",   type=int, default=None)
    parser.add_argument("-s",  "--seed",       type=int, default=10)
    parser.add_argument("-q",  "--quite",      default=False, action="store_true")


def _restore_model(args):
    """Checkpoint restore shared by test/predict: latest (or -ci) .npz +
    meta.npy context -> (model, splits, context). Restore is by variable
    name suffix with the reference's fallbacks (regression/test.py:38-43,89-99)."""
    if args.ckpt_index is None:
        indices = Checkpointer.list_indices(args.ckpt_dir)
        if not indices:
            raise SystemExit(f"no checkpoints (*.npz) found in {args.ckpt_dir}")
        args.ckpt_index = indices[-1]

    named = load_named(os.path.join(args.ckpt_dir,
                                    Checkpointer.FILE_FORMAT.format(args.ckpt_index)))
    context = np.load(os.path.join(args.ckpt_dir, "meta.npy"),
                      allow_pickle=True).item()["args"]

    splits = _load_splits(context["data_name"], args.data_root, args.seed, args.device)
    (x_train, y_train), _, _, (y_std, y_mean) = splits

    a = get_by_suffix(named, "a")
    b = get_by_suffix(named, "b")
    w_std = get_by_suffix(named, "w_std")
    b_std = get_by_suffix(named, "b_std")
    last_w_std = get_by_suffix(named, "last_w_std")
    eps = get_by_suffix(named, "eps")
    if eps is None:
        eps = get_by_suffix(named, "diag_reg")
    if last_w_std is None:
        last_w_std = np.array(context["last_w_std"])

    args_like = dict(context)
    args_like["epsilon"] = 1.0
    if context["method"] == "tp":
        args_like["alpha"], args_like["beta"] = 1.0, 1.0
    model, _ = _build_model(args_like, x_train, y_train, y_mean, y_std)

    # Values in the checkpoint are raw (unconstrained), assigned directly
    # like objax .assign (regression/test.py:118-131).
    for key, value in [("eps", eps), ("w_std", w_std), ("b_std", b_std),
                       ("last_w_std", last_w_std), ("a", a), ("b", b)]:
        if value is not None:
            assign_by_suffix(model, key, value)

    return model, splits, context


def test_main(args):
    logger = Logger(os.path.join(args.ckpt_dir, "test"), "test.log", quite=args.quite)
    try:
        model, splits, _ = _restore_model(args)
        _, _, (x_test, y_test), _ = splits
        with torch.inference_mode():
            test_nll = model.test_nll(x_test, y_test)
        logger.log(f"NLL: {float(test_nll):.5f}")
    except Exception:
        import traceback
        logger.log(f"\n{traceback.format_exc()}\nStopped")
        raise
    finally:
        logger.close()


# ---------------------------------------------------------------------------
# predict (serving path; beyond the reference, which only has test)
# ---------------------------------------------------------------------------

def _add_predict_parser(subparsers):
    parser = subparsers.add_parser("predict", aliases=["pr"])
    parser.set_defaults(func=predict_main)

    parser.add_argument("-dr", "--data-root",  type=str, default="./data")
    parser.add_argument("-cd", "--ckpt-dir",   type=str, required=True)
    parser.add_argument("-ci", "--ckpt-index", type=int, default=None)
    parser.add_argument("-s",  "--seed",       type=int, default=10)
    parser.add_argument("-i",  "--input",      type=str, default=None,
                        help=".npy of raw inputs in the dataset's original "
                             "feature space (normalized with the train-split "
                             "stats); default = held-out test split")
    parser.add_argument("-o",  "--output",     type=str, default=None,
                        help="output .npz of de-normalized (mean, var); "
                             "default <ckpt_dir>/predictions.npz")
    parser.add_argument("-fs", "--fitted-state", type=str, default=None,
                        help="path for the fitted solve cache: loaded if it "
                             "exists, written after fitting otherwise — "
                             "repeat predictions skip the N x N factorization")
    parser.add_argument("-q",  "--quite",      default=False, action="store_true")


def _train_x_stats(data_name, data_root):
    """(x_mean, x_std) of the train split — the exact stats split_dataset
    normalized with, for normalizing raw serving inputs."""
    x, y = get_dataset(name=data_name, root=data_root)
    x, _ = permute_dataset(x, y, seed=10)
    x_train = x[:int(0.8 * len(x))]
    return np.mean(x_train, axis=0), np.std(x_train, axis=0)


def predict_main(args):
    logger = Logger(os.path.join(args.ckpt_dir, "predict"), "predict.log",
                    quite=args.quite)
    try:
        model, splits, context = _restore_model(args)
        _, _, (x_test, y_test), _ = splits
        with torch.inference_mode():
            if args.fitted_state and os.path.exists(args.fitted_state):
                fitted = FittedSPR.load(args.fitted_state, model)
                logger.log(f"loaded fitted state from {args.fitted_state}")
            else:
                fitted = fit_spr(model)
                if args.fitted_state:
                    fitted.save(args.fitted_state)
                    logger.log(f"saved fitted state to {args.fitted_state}")

            if args.input:
                x_raw = np.load(args.input)
                x_mean, x_std = _train_x_stats(context["data_name"], args.data_root)
                x_in = torch.as_tensor(
                    np.nan_to_num((x_raw - x_mean) / x_std).astype(np.float32),
                    device=args.device)
                y_eval = None
            else:
                x_in, y_eval = x_test, y_test

            mean, var = fitted.predict(x_in)
            out = args.output or os.path.join(args.ckpt_dir, "predictions.npz")
            np.savez(out, mean=mean.cpu().numpy(), var=var.cpu().numpy())
            logger.log(f"predicted {mean.shape[0]} points -> {out}")
            if y_eval is not None:
                nll = fitted.test_nll(x_in, y_eval)
                logger.log(f"NLL: {float(nll):.5f}")
    except Exception:
        import traceback
        logger.log(f"\n{traceback.format_exc()}\nStopped")
        raise
    finally:
        logger.close()
