"""Finite-width CNN ensemble baseline: ``ens tr`` / ``ens ts`` (counterpart
of ``snngp/cli/ensemble.py``; rebuilds ``experiments/ensemble/{train,
test}.py``).

Same flags and defaults, data pipeline (byte-identical splits and batch
order), network (the layer tier's finite-width ``init`` / ``apply``,
:func:`snngp_torch.nn.arch.get_cnn_layer`), loss ``-mean(log_softmax(
logits) * y)`` (a mean over batch and classes), objax-exact Adam / SGD,
and best-valid checkpoints: ``NNN.npy``, a 2-element object array
``[params pytree of numpy arrays, list(net_kwargs.values())]``, and
``meta.npy``, which either package reads. ``ens ts`` averages the member
logits, then takes the loss. Every tensor lives on the device named by
``python -m snngp_torch --device``; the network runs cuDNN convolutions
and cuBLAS products there (the JAX package's are XLA's, outside any
Pallas kernel).

Kept reference quirks: ``ens ts`` rebuilds every member with
``act="relu"`` (the saved ``net_kwargs`` hold no activation), and ``-n
resnet`` is accepted but the CNN is built.

Divergences from the JAX package:

- ``-mp`` scopes TF32 to the command instead of XLA's matmul precision:
  ``highest`` keeps TF32 off; ``high`` and ``default`` turn on
  ``torch.backends.cuda.matmul.allow_tf32`` and
  ``torch.backends.cudnn.allow_tf32``, and both are restored on exit (the
  GP paths need them off, ``snngp_torch/__init__.py``);
- the initial params come from a ``torch.Generator`` seeded with ``-s``
  and the ``tp`` draw of ``last_w_std = sqrt(beta / Gamma(alpha))`` from a
  host numpy generator seeded with ``-s`` (``torch.distributions`` takes no
  generator); JAX draws both from one key. :func:`train_main` takes both
  as arguments, so that JAX's can be handed in;
- the epoch's losses accumulate on the device (one host read an epoch);
- it logs a failure's traceback and exits 0; the port logs it the same way
  and then re-raises.
"""

from __future__ import annotations

import contextlib
import glob
import os
from datetime import datetime

import numpy as np
import torch

from snngp_torch.data.classification import get_test_dataset, get_train_dataset
from snngp_torch.nn.arch import get_cnn_layer
from snngp_torch.nn.finite import FiniteNet, params_from_jax, params_to_numpy
from snngp_torch.utils import (SGD, Adam, DataLoader, Logger, get_context_summary,
                               progress)

PRECISIONS = ["highest", "high", "default"]


def add_subparser(subparsers):
    parser = subparsers.add_parser("ensemble", aliases=["ens"])
    sub = parser.add_subparsers(metavar="ops")
    _add_train_parser(sub)
    _add_test_parser(sub)


def _add_train_parser(subparsers):
    parser = subparsers.add_parser("train", aliases=["tr"])
    parser.set_defaults(func=train_main)

    parser.add_argument("-m",   "--method",       choices=["gp", "tp"], required=True)
    parser.add_argument("-n",   "--network",      choices=["cnn", "resnet"], default="cnn")
    parser.add_argument("-dr",  "--data-root",    type=str, default="./data")
    parser.add_argument("-dn",  "--data-name",    required=True)
    parser.add_argument("-cr",  "--ckpt-root",    type=str, default="./_ckpt/ens")
    parser.add_argument("-cn",  "--ckpt-name",    type=str, default=None)

    parser.add_argument("-vp",  "--valid-prop",   type=float, default=0.1)
    parser.add_argument("-nd",  "--num-data",     type=int, default=None)
    parser.add_argument("-nb",  "--num-batch",    type=int, default=250)

    parser.add_argument("-a",   "--alpha",        type=float, default=2.)
    parser.add_argument("-b",   "--beta",         type=float, default=2.)

    parser.add_argument("-nh",  "--num-hiddens",  type=int, default=4)
    parser.add_argument("-nc",  "--num-channels", type=int, default=32)
    parser.add_argument("-act", "--activation",   choices=["erf", "relu"], default="relu")
    parser.add_argument("-ws",  "--w-std",        type=float, default=1.)
    parser.add_argument("-bs",  "--b-std",        type=float, default=0.)
    parser.add_argument("-eps", "--epsilon",      type=float, default=1e-6)

    parser.add_argument("-opt", "--optimizer",    choices=["adam", "sgd"], default="adam")
    parser.add_argument("-lr",  "--lr",           type=float, default=1e-2)
    parser.add_argument("-e",   "--max-epoch",    type=int, default=100)

    parser.add_argument("-s",   "--seed",         type=int, default=10)
    parser.add_argument("-q",   "--quite",        default=False, action="store_true")
    parser.add_argument("-c",   "--comment",      type=str, default="")
    parser.add_argument("-mp",  "--matmul-precision", choices=PRECISIONS, default="highest",
                        help="matmul precision of the finite network's steps: 'highest' "
                             "keeps TF32 off; 'high' and 'default' allow TF32 in cuBLAS "
                             "and cuDNN for this command only")


@contextlib.contextmanager
def matmul_precision(precision: str):
    """TF32 in cuBLAS and cuDNN for ``high`` / ``default``, off for
    ``highest``; both flags are restored on exit."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = precision != "highest"
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def invgamma(seed: int, alpha: float, beta: float) -> float:
    """sqrt of an inverse-gamma draw (ensemble/train.py:52-54), from a host
    numpy generator seeded with ``seed``."""
    return float(np.sqrt(beta / np.random.default_rng(seed).gamma(alpha)))


def get_cnn(num_hiddens, num_channels, num_class, w_std=1., b_std=0., last_w_std=1.,
            act="relu"):
    """The finite-width CNN of the layer tier (ensemble/train.py:57-65)."""
    return get_cnn_layer(num_hiddens, num_class, act, w_std, b_std, last_w_std,
                         channels=num_channels)


def cross_entropy(logits, y):
    return -torch.mean(torch.log_softmax(logits, dim=-1) * y)


def _to_device(x, y, device):
    return (torch.as_tensor(np.asarray(x, dtype=np.float32), device=device),
            torch.as_tensor(np.asarray(y, dtype=np.float32), device=device))


def train_main(args, init_params=None, last_w_std=None):
    """``ens tr``. ``init_params`` (nested tuples of numpy arrays, the JAX
    pytree's layout) and ``last_w_std`` replace the seeded draws."""
    with matmul_precision(args.matmul_precision):
        return _train_main(args, init_params, last_w_std)


def _train_main(args, init_params, last_w_std):
    device = args.device
    dataset = get_train_dataset(
        name=args.data_name, root=args.data_root,
        num_data=args.num_data, valid_prop=args.valid_prop,
        normalize=True, onehot=True, seed=args.seed,
    )
    (x_train, y_train), (x_valid, y_valid), (num_class, data_name, data_msg) = dataset
    num_train, num_valid = x_train.shape[0], x_valid.shape[0]

    if not args.ckpt_name:
        args.ckpt_name = f"{data_name}/{args.method}-{args.network}"
        args.ckpt_name += f"/nh{args.num_hiddens}-nc{args.num_channels}"
        if args.method == "tp":
            args.ckpt_name += f"-a{args.alpha:.0f}-b{args.beta:.0f}"
        args.ckpt_name += f"/{args.comment or datetime.now().strftime('%y%m%d%H%M')}"

    ckpt_dir = os.path.join(os.path.expanduser(args.ckpt_root), args.ckpt_name)
    os.makedirs(ckpt_dir, exist_ok=True)
    logger = Logger(ckpt_dir, quite=args.quite)

    try:
        if last_w_std is None:
            last_w_std = 1. if args.method == "gp" else invgamma(args.seed, args.alpha,
                                                                  args.beta)
        net_kwargs = dict(
            num_hiddens=args.num_hiddens, num_channels=args.num_channels,
            num_class=num_class, w_std=args.w_std, b_std=args.b_std,
            last_w_std=last_w_std,
        )
        layer = get_cnn(**net_kwargs, act=args.activation)

        np.save(os.path.join(ckpt_dir, "meta.npy"),
                {k: v for k, v in vars(args).items() if k not in ("func", "device")})
        logger.log(get_context_summary(args, dict(
            num_class=num_class, num_train=num_train, num_valid=num_valid,
            data_name=data_name, data_msg=data_msg, last_w_std=last_w_std,
        )))

        if init_params is None:
            generator = torch.Generator(device=device).manual_seed(args.seed)
            _, params = layer.init(generator, (-1,) + x_train.shape[1:])
        else:
            params = params_from_jax(init_params, device)
        net = FiniteNet(layer, params)
        optimizer = Adam(net) if args.optimizer == "adam" else SGD(net)

        train_loader = DataLoader(x_train, y_train, batch_size=args.num_batch, shuffle=True)
        valid_loader = DataLoader(x_valid, y_valid, batch_size=args.num_batch, shuffle=False)

        def valid_epoch():
            total_nll = torch.zeros((), dtype=torch.float64, device=device)
            total_corrects = torch.zeros((), dtype=torch.int64, device=device)
            with torch.no_grad():
                for x_batch, y_batch in valid_loader:
                    xb, yb = _to_device(x_batch, y_batch, device)
                    logits = net(xb)
                    total_nll += cross_entropy(logits, yb).double() * xb.shape[0]
                    total_corrects += torch.sum(logits.argmax(-1) == yb.argmax(-1))
            return (float(total_nll) / valid_loader.num_data,
                    int(total_corrects) * 100 / valid_loader.num_data)

        valid_nll, valid_acc = valid_epoch()
        logger.log(f"[{0:3d}]  Valid NLL: {valid_nll:.6f}  Valid ACC: {valid_acc:.2f}")
        best_epoch, best_nll, best_acc = 0, valid_nll, valid_acc

        for epoch in progress(range(1, args.max_epoch + 1), args.quite, desc="Epoch"):
            total_nll = torch.zeros((), dtype=torch.float64, device=device)
            for x_batch, y_batch in progress(train_loader, args.quite, desc="Train",
                                             leave=False):
                xb, yb = _to_device(x_batch, y_batch, device)
                optimizer.zero_grad()
                loss = cross_entropy(net(xb), yb)
                loss.backward()
                optimizer.update(args.lr)
                total_nll += loss.detach().double() * xb.shape[0]
            train_nll = float(total_nll) / train_loader.num_data
            logger.log(f"[{epoch:3d}]  Train NLL: {train_nll:.6f}", is_tqdm=True)

            valid_nll, valid_acc = valid_epoch()
            logger.log(f"[{epoch:3d}]  Valid NLL: {valid_nll:.6f}  Valid ACC: {valid_acc:.2f}",
                       is_tqdm=True)

            if valid_nll < best_nll:
                best_epoch, best_nll, best_acc = epoch, valid_nll, valid_acc
                # Pre-allocated object array: np.array((pytree, list)) would
                # recurse when len(params) == len(net_kwargs) (nh=2).
                blob = np.empty(2, dtype=object)
                blob[0] = params_to_numpy(net.params())
                blob[1] = list(net_kwargs.values())
                np.save(os.path.join(ckpt_dir, f"{epoch:03d}.npy"), blob, allow_pickle=True)
                logger.log(f"[{epoch:3d}]  Updated  NLL: {valid_nll:.6f}  ACC: {valid_acc:.2f}",
                           is_tqdm=True)

        logger.log(f"[{best_epoch:3d}]  Valid NLL: {best_nll:.6f}  Valid ACC: {best_acc:.2f}")
        return best_nll, best_acc

    except Exception:
        import traceback
        logger.log(f"\n{traceback.format_exc()}\nStopped")
        raise
    finally:
        logger.close()


def _add_test_parser(subparsers):
    parser = subparsers.add_parser("test", aliases=["ts"])
    parser.set_defaults(func=test_main)
    parser.add_argument("-mp", "--matmul-precision", choices=PRECISIONS, default="highest",
                        help="matmul precision of the member logits (see ens tr -mp)")

    parser.add_argument("-dr", "--data-root", type=str, default="./data")
    parser.add_argument("-dn", "--data-name", required=True)
    parser.add_argument("-cd", "--ckpt-dir",  type=str, required=True, nargs="+")
    parser.add_argument("-nd", "--num-data",  type=int, default=None)
    parser.add_argument("-nb", "--num-batch", type=int, default=100)
    parser.add_argument("-q",  "--quite",     default=False, action="store_true")


def load_member(ckpt_dir, device):
    """The last ``NNN.npy`` of a run directory -> (layer, params on
    ``device``). The layer is rebuilt from the saved ``net_kwargs`` with the
    default activation, as the reference does."""
    ckpts = [c for c in sorted(glob.glob(os.path.join(ckpt_dir, "*.npy")))
             if not c.endswith("meta.npy")]
    if not ckpts:
        raise FileNotFoundError(
            f"no member checkpoints (*.npy) under '{ckpt_dir}' — pass the "
            f"run directory itself (ckpt_root/ckpt_name), one per member")
    params, net_args = np.load(ckpts[-1], allow_pickle=True)
    return get_cnn(*net_args), params_from_jax(params, device)


def test_main(args):
    """``ens ts``: prints and returns the test NLL and accuracy (%) of the
    members' averaged logits."""
    with matmul_precision(args.matmul_precision):
        return _test_main(args)


def _test_main(args):
    (x_test, y_test), _ = get_test_dataset(
        name=args.data_name, root=args.data_root,
        num_data=args.num_data, onehot=True, normalize=True,
    )
    members = [load_member(d, args.device) for d in args.ckpt_dir]
    test_loader = DataLoader(x_test, y_test, batch_size=args.num_batch, shuffle=False)

    nll = torch.zeros((), dtype=torch.float64, device=args.device)
    corrects = torch.zeros((), dtype=torch.int64, device=args.device)
    with torch.no_grad():
        for x_batch, y_batch in progress(test_loader, args.quite, desc="Test", leave=False):
            xb, yb = _to_device(x_batch, y_batch, args.device)
            logits = torch.stack([layer.apply(p, xb) for layer, p in members]).mean(dim=0)
            nll += cross_entropy(logits, yb).double() * xb.shape[0]
            corrects += torch.sum(logits.argmax(dim=1) == yb.argmax(dim=1))

    test_nll = float(nll) / test_loader.num_data
    test_acc = int(corrects) * 100 / test_loader.num_data
    print(f"{test_nll = :.6f}   {test_acc = :.2f}")
    return test_nll, test_acc
