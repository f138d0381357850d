"""Classification subcommands: train / test / predict (counterpart of
``cls tr``, ``cls ts`` and ``cls pr`` in ``snngp/cli/classification.py``;
rebuilds ``experiments/classification/{train,test}.py``).

Same flags, data pipeline (byte-identical splits and batch order),
class-proportional inducing-point init, ``-r`` host resize, svtp
``last_w_std`` = 1 with its optimizer mask, the ``-lr2`` two-optimizer
split, ``--freeze-inducing``, ``-rs`` resume, per-epoch valid NLL / ACC,
plateau LR and best-NLL checkpoints (``NNN.npz``, ``meta.npy`` and
``resume.state`` in the JAX package's layouts, readable by either
package). Every tensor lives on the device named by
``python -m snngp_torch --device``; the Gram blocks go through K3 there
(``-n cnn``), through K5 and K6 (``-n resnet``), or through K7 (``-n
myrtle``, with ``-nh`` the Myrtle depth 5, 7 or 10; the inducing inputs are
frozen and the Gram blocks take scalar-only gradients, K7's tangent mode,
as in the JAX package).

Kept reference quirks: the ``-lr2`` split does not apply the svtp
``last_w_std`` freeze (classification/train.py:228-229), and ``cls ts``
evaluates with the constructor's eps = 1e-6, not the checkpoint's
(classification/test.py:129-144).

Divergences from the JAX package:

- the Monte Carlo draws come from a ``torch.Generator`` seeded with ``-s``,
  not from JAX keys: the two packages' NLLs agree within MC error, not
  bitwise;
- it logs a failure's traceback and exits 0; the port logs it the same way
  and then re-raises;
- ``-sck`` (one ``lax.scan`` per epoch there, to amortize dispatch) runs
  the epoch's batches in the same Python loop: the same math and draws;
- ``--freeze-inducing`` also switches the Gram blocks to scalar-only
  gradients (``trainable_inputs=False``: K4 on the card for ``-n cnn``,
  the layer-tier recompute for the three scales only for ``-n resnet``),
  as the JAX package's Myrtle path does for its frozen inducing inputs;
  the inducing inputs' gradient, and so their Adam moments, are then zero
  (the JAX package computes and masks them); every parameter takes the
  same values;
- with ``SNNGP_MESH_DEVICES`` > 1 (or a mesh handed to :func:`train_main`)
  the ELBO of each training batch the mesh divides is partitioned by hand,
  as GSPMD partitions it there: its two batch Gram blocks are row panels
  over the shards, gathered on the parameters' device
  (``SVSP.loss(..., mesh=)``); the same math and draws;
- the progress bars need ``tqdm`` only if it can be imported.
"""

from __future__ import annotations

import os
from datetime import datetime

import numpy as np
import torch

from snngp_torch.data.classification import get_test_dataset, get_train_dataset
from snngp_torch.data.resize import bilinear_resize
from snngp_torch.models import (SVSP, GaussianPrior, InverseGammaPrior, NNGPKernel,
                                fit_svsp)
from snngp_torch.models.params import get_by_suffix
from snngp_torch.nn.arch import get_cnn_kernel, get_conv_resnet_kernel, get_myrtle_kernel
from snngp_torch.parallel.mesh import get_mesh
from snngp_torch.utils import (SGD, Adam, Checkpointer, DataLoader, Logger,
                               ReduceLROnPlateau, get_context_summary, load_named,
                               load_training_state, progress, save_training_state,
                               svsp_train_step)


def add_subparser(subparsers):
    parser = subparsers.add_parser("classification", aliases=["cls"])
    sub = parser.add_subparsers(metavar="ops")
    _add_train_parser(sub)
    _add_test_parser(sub)
    _add_predict_parser(sub)


def _add_train_parser(subparsers):
    parser = subparsers.add_parser("train", aliases=["tr"])
    parser.set_defaults(func=train_main)

    parser.add_argument("-m",   "--method",           choices=["svgp", "svtp"], required=True)
    parser.add_argument("-n",   "--network",          choices=["cnn", "resnet", "myrtle"],
                        default="cnn", help="kernel architecture; myrtle takes -nh as "
                                            "the Myrtle depth (5, 7, 10)")
    parser.add_argument("-dr",  "--data-root",        type=str, default="./data")
    parser.add_argument("-dn",  "--data-name",        required=True)
    parser.add_argument("-cr",  "--ckpt-root",        type=str, default="./_ckpt/cls")
    parser.add_argument("-cn",  "--ckpt-name",        type=str, default=None)

    parser.add_argument("-vp",  "--valid-prop",       type=float, default=0.1)
    parser.add_argument("-nd",  "--num-data",         type=int, default=None)
    parser.add_argument("-nb",  "--num-batch",        type=int, default=100)
    parser.add_argument("-ni",  "--num-inducing",     type=int, default=200)
    parser.add_argument("-ns",  "--num-sample",       type=int, default=100)
    parser.add_argument("-nvs", "--num-valid-sample", type=int, default=1000)

    parser.add_argument("-a",   "--alpha",            type=float, default=2.)
    parser.add_argument("-b",   "--beta",             type=float, default=2.)

    parser.add_argument("-nh",  "--num-hiddens",      type=int, default=4)
    parser.add_argument("-act", "--activation",       choices=["erf", "relu"], default="relu")
    parser.add_argument("-ws",  "--w-std",            type=float, default=1.)
    parser.add_argument("-bs",  "--b-std",            type=float, default=1e-8)
    parser.add_argument("-ls",  "--last-w-std",       type=float, default=1.)
    parser.add_argument("-eps", "--epsilon",          type=float, default=1e-6)

    parser.add_argument("-opt", "--optimizer",        choices=["adam", "sgd"], default="adam")
    parser.add_argument("-lr",  "--lr",               type=float, default=1e-2)
    parser.add_argument("-lr2", "--lr2",              type=float, default=None)
    parser.add_argument("-lrd", "--lr-decay",         type=float, default=0.5)
    parser.add_argument("-lrt", "--lr-threshold",     type=float, default=1e-4)
    parser.add_argument("-lrp", "--lr-patience",      type=int, default=5)
    parser.add_argument("-e",   "--max-epoch",        type=int, default=300)
    parser.add_argument("-r",   "--resize",           type=int, default=1)

    parser.add_argument("--freeze-inducing",  default=False, action="store_true",
                        help="mask the inducing inputs out of the optimizer; the "
                             "Gram blocks then take scalar-only gradients")
    parser.add_argument("-rs",  "--resume",           default=False, action="store_true",
                        help="resume from <ckpt_dir>/resume.state")
    parser.add_argument("-sck", "--scan-epoch",       default=False, action="store_true",
                        help="accepted for the JAX CLI's flag: the epoch runs in the "
                             "same loop (identical math and draws)")
    parser.add_argument("-s",   "--seed",             type=int, default=10)
    parser.add_argument("-q",   "--quite",            default=False, action="store_true")
    parser.add_argument("-c",   "--comment",          type=str, default="")


def _base_kernel(network):
    if network is None or network == "cnn":
        return "cnn", get_cnn_kernel
    if network == "resnet":
        return "resnet", get_conv_resnet_kernel
    if network == "myrtle":
        return "myrtle", get_myrtle_kernel
    raise ValueError(f"Unsupported network '{network}'")


def _check_myrtle_depth(network, num_hiddens):
    if network == "myrtle" and num_hiddens not in (5, 7, 10):
        raise ValueError("-n myrtle uses -nh/--num-hiddens as the Myrtle depth: "
                         f"one of 5, 7, 10 (got {num_hiddens})")


def _make_model(method, network, num_hiddens, activation, w_std, b_std, last_w_std,
                alpha, beta, num_class, inducing_points, epsilon, get_kernel_fn=None,
                trainable_inputs=True):
    """``trainable_inputs=False`` (``--freeze-inducing``): the Gram blocks
    take scalar-only gradients (``-n cnn``: K4 on the card instead of the
    layer-tier recompute; ``-n resnet``: the same recompute, for the three
    scales only) and the inducing inputs zero cotangents. ``-n myrtle``
    always takes scalar-only gradients (K7's tangent mode): its inducing
    inputs are frozen."""
    if get_kernel_fn is None:
        _, base_kernel_fn = _base_kernel(network)
        if network == "myrtle":
            _check_myrtle_depth(network, num_hiddens)
            trainable_inputs = False

        def get_kernel_fn(w, b, l):
            return base_kernel_fn(num_hiddens, num_class, activation, w_std=w, b_std=b,
                                  last_w_std=l, trainable_inputs=trainable_inputs)

    if method == "svgp":
        kernel = NNGPKernel(get_kernel_fn, w_std, b_std, last_w_std)
        prior = GaussianPrior()
    elif method == "svtp":
        # svtp fixes last_w_std = 1 (classification/train.py:181).
        kernel = NNGPKernel(get_kernel_fn, w_std, b_std, 1.)
        prior = InverseGammaPrior(alpha, beta)
    else:
        raise ValueError(f"Unsupported method '{method}'")
    return SVSP(prior, kernel, inducing_points, num_latent_gps=num_class, eps=epsilon)


def _to_device(x, y, device):
    return (torch.as_tensor(np.asarray(x, dtype=np.float32), device=device),
            torch.as_tensor(np.asarray(y), device=device))


def _optimizers(model, args):
    """The optimizers of ``cls tr`` with their masks (classification/
    train.py:216-242): svtp freezes last_w_std; ``--freeze-inducing``
    freezes the inducing inputs; ``-lr2`` splits the prior's parameters
    off to a second optimizer and, as the reference does, drops the svtp
    freeze there."""
    opt_cls = Adam if args.optimizer == "adam" else SGD
    freeze_z = args.freeze_inducing or getattr(args, "network", None) == "myrtle"
    if args.lr2:
        return [opt_cls(model, mask=lambda n: "prior" not in n
                        and not (freeze_z and "inducing_variable" in n)),
                opt_cls(model, mask=lambda n: "prior" in n)]

    def keep(n):
        if args.method == "svtp" and "last_w_std" in n:
            return False
        return not (freeze_z and "inducing_variable" in n)

    return [opt_cls(model, mask=keep)]


def _params_str(model, nelbo, method):
    with torch.no_grad():
        ws, bs, ls = (float(v) for v in model.kernel.get_params())
        eps = float(model.bij(model.eps))
        if method == "svtp":
            ia, ib = (float(v) for v in model.prior._ab())
            return (f"nELBO: {nelbo:.5f}  ws: {ws:.4f}  bs: {bs:.3E}  "
                    f"a: {ia:.4f}  b: {ib:.4f}  e: {eps:.3E}")
        return (f"nELBO: {nelbo:.5f}  ws: {ws:.4f}  bs: {bs:.3E}  "
                f"ls: {ls:.4f}  e: {eps:.3E}")


def _inducing_init(x_train, y_train, num_class, num_inducing):
    """Class-proportional inducing-point init (classification/train.py:186-190):
    the first round(ni * share) training images of each class."""
    label_class = np.array([np.sum(y_train == ci) for ci in range(num_class)])
    per_class = np.round(num_inducing * label_class / label_class.sum()).astype(int).tolist()
    points = np.concatenate([x_train[y_train == ci][:ni]
                             for ci, ni in zip(range(num_class), per_class)], axis=0)
    return points, per_class


def train_main(args, mesh=None):
    """``cls tr``. ``mesh`` (a :class:`snngp_torch.parallel.mesh.Mesh`, such
    as four shards of one card) takes the place of the one that
    ``SNNGP_MESH_DEVICES`` > 1 would build over ``--device``."""
    device = args.device
    _check_myrtle_depth(args.network, args.num_hiddens)   # before the log opens
    dataset = get_train_dataset(
        name=args.data_name, root=args.data_root,
        num_data=args.num_data, valid_prop=args.valid_prop,
        normalize=True, seed=args.seed,
    )
    (x_train, y_train), (x_valid, y_valid), (num_class, data_name, data_msg) = dataset
    num_train, num_valid = x_train.shape[0], x_valid.shape[0]

    if not args.ckpt_name:
        args.ckpt_name = f"{data_name}/{args.method}-{args.network}"
        args.ckpt_name += f"/ni{args.num_inducing}-nh{args.num_hiddens}"
        if args.method == "svtp":
            args.ckpt_name += f"-a{args.alpha:.1f}-b{args.beta:.1f}"
        args.ckpt_name += f"/{args.comment or datetime.now().strftime('%y%m%d%H%M')}"

    ckpt_dir = os.path.join(os.path.expanduser(args.ckpt_root), args.ckpt_name)
    checkpointer = Checkpointer(ckpt_dir, keep_ckpts=20)
    logger = Logger(ckpt_dir, quite=args.quite)

    try:
        h, w, c = x_train.shape[1:]
        if args.resize > 1:
            new_h, new_w = h // args.resize, w // args.resize
            x_train = bilinear_resize(x_train, new_h, new_w)
            x_valid = bilinear_resize(x_valid, new_h, new_w)
            logger.log(f"Resized to ({h}, {w}, {c}) -> ({new_h}, {new_w}, {c})")

        args.network, _ = _base_kernel(args.network)

        inducing_points, num_inducing_class = _inducing_init(x_train, y_train, num_class,
                                                             args.num_inducing)
        args.num_inducing = inducing_points.shape[0]
        model = _make_model(args.method, args.network, args.num_hiddens, args.activation,
                            args.w_std, args.b_std, args.last_w_std, args.alpha,
                            args.beta, num_class, inducing_points, args.epsilon,
                            trainable_inputs=not args.freeze_inducing).to(device)
        n_mesh = int(os.environ.get("SNNGP_MESH_DEVICES", "1"))
        if mesh is None and n_mesh > 1:
            mesh = get_mesh(n_mesh, device=device)
        if mesh is not None:
            logger.log(f"Mesh: {mesh.size} devices (batch-sharded ELBO)")
        if args.network == "myrtle":
            logger.log("Myrtle kernel: inducing inputs fixed at their "
                       "class-proportional init (scalar-only kernel gradients)")
        elif args.freeze_inducing:
            logger.log("--freeze-inducing: inducing inputs fixed at their "
                       "class-proportional init (scalar-only kernel gradients)")
        optimizers = _optimizers(model, args)
        scheduler = ReduceLROnPlateau(lr=args.lr, factor=args.lr_decay,
                                      patience=args.lr_patience)

        resume_path = os.path.join(ckpt_dir, "resume.state")
        start_epoch = 0
        if args.resume and os.path.isfile(resume_path):
            rmeta = load_training_state(resume_path, model, optimizers)
            start_epoch = int(rmeta["epoch"])
            scheduler.lr = float(rmeta["lr"])
            scheduler.best = float(rmeta["sched_best"])
            scheduler.num_bad_epochs = int(rmeta["sched_bad"])
            scheduler.last_epoch = int(rmeta["sched_epoch"])
            checkpointer.best_loss = float(rmeta["best_loss"])
            logger.log(f"Resumed from {resume_path} at epoch {start_epoch}")

        np.save(os.path.join(ckpt_dir, "meta.npy"),
                {k: v for k, v in vars(args).items() if k not in ("func", "device")})
        logger.log(get_context_summary(args, dict(
            num_class=num_class, num_train=num_train, num_valid=num_valid,
            data_name=data_name, data_msg=data_msg,
            num_inducing=args.num_inducing, inducing_points=num_inducing_class,
        )))

        train_loader = DataLoader(x_train, y_train, batch_size=args.num_batch,
                                  shuffle=True, seed=args.seed)
        valid_loader = DataLoader(x_valid, y_valid, batch_size=args.num_batch,
                                  shuffle=False)
        generator = torch.Generator(device=device).manual_seed(args.seed)

        def lrs():
            return [scheduler.lr, args.lr2] if args.lr2 else [scheduler.lr]

        def valid_epoch():
            total_nll, total_corrects = 0.0, 0
            with torch.no_grad():
                for x_batch, y_batch in progress(valid_loader, args.quite, desc="Valid",
                                                 leave=False):
                    xb, yb = _to_device(x_batch, y_batch, device)
                    nll, corrects = model.test_acc_nll(xb, yb, args.num_valid_sample,
                                                       generator)
                    total_nll += float(nll) * x_batch.shape[0]
                    total_corrects += int(corrects)
            return (total_nll / valid_loader.num_data,
                    total_corrects * 100 / valid_loader.num_data)

        valid_nll, valid_acc = valid_epoch()
        logger.log(f"[{0:3d}]  NLL: {valid_nll:.5f}  ACC: {valid_acc:.2f}")
        best_epoch, best_nll, best_acc, best_print_str = 0, valid_nll, valid_acc, ""
        checkpointer.step(0, valid_nll, model)

        log_interval = max(len(train_loader) // 4, 1)
        for epoch in progress(range(start_epoch + 1, args.max_epoch + 1), args.quite,
                              desc="Epoch"):
            total_nelbo = 0.0
            for idx, (x_batch, y_batch) in enumerate(progress(
                    train_loader, args.quite, desc="Train", leave=False)):
                xb, yb = _to_device(x_batch, y_batch, device)
                # As the JAX CLI: only the loop without -sck shards, and only
                # a batch the mesh divides.
                shard = (mesh is not None and not args.scan_epoch
                         and xb.shape[0] % mesh.size == 0)
                nelbo = float(svsp_train_step(model, optimizers, lrs(), xb, yb, num_train,
                                              args.num_sample, generator,
                                              mesh=mesh if shard else None))
                total_nelbo += nelbo * x_batch.shape[0]
                if not args.scan_epoch and (idx + 1) % log_interval == 0:
                    logger.log(f"       [{idx + 1:4d}]  {_params_str(model, nelbo, args.method)}",
                               is_tqdm=True)
            train_nelbo = total_nelbo / train_loader.num_data
            logger.log(f"[{epoch:3d}]  nELBO: {train_nelbo:.5f}", is_tqdm=True)

            valid_nll, valid_acc = valid_epoch()
            logger.log(f"[{epoch:3d}]  NLL: {valid_nll:.5f}  ACC: {valid_acc:.2f}",
                       is_tqdm=True)

            if checkpointer.step(epoch, valid_nll, model):
                best_epoch, best_nll, best_acc = epoch, valid_nll, valid_acc
                best_print_str = _params_str(model, train_nelbo, args.method)
                logger.log(f"[{epoch:3d}]  Updated  NLL: {valid_nll:.5f}  "
                           f"ACC: {valid_acc:.2f}", is_tqdm=True)

            save_training_state(resume_path, model, optimizers, dict(
                epoch=epoch, lr=scheduler.lr, sched_best=scheduler.best,
                sched_bad=scheduler.num_bad_epochs, sched_epoch=scheduler.last_epoch,
                best_loss=checkpointer.best_loss))

            if scheduler.step(valid_nll):
                logger.log(f"[{epoch:3d}]  LR reduced to {scheduler.lr:.6f}", is_tqdm=True)
                if scheduler.lr < args.lr_threshold:
                    break

        logger.log(f"[{best_epoch:3d}]  NLL: {best_nll:.5f}  ACC: {best_acc:.2f}  "
                   f"{best_print_str}")

    except Exception:
        import traceback
        logger.log(f"\n{traceback.format_exc()}\nStopped")
        raise
    finally:
        logger.close()


# ---------------------------------------------------------------------------
# test (experiments/classification/test.py)
# ---------------------------------------------------------------------------

def _add_test_parser(subparsers):
    parser = subparsers.add_parser("test", aliases=["ts"])
    parser.set_defaults(func=test_main)

    parser.add_argument("-dr", "--data-root",  type=str, default="./data")
    parser.add_argument("-dn", "--data-name",  required=True)
    parser.add_argument("-cd", "--ckpt-dir",   type=str, required=True)
    parser.add_argument("-ci", "--ckpt-index", type=int, default=None)
    parser.add_argument("-nd", "--num-data",   type=int, default=None)
    parser.add_argument("-nb", "--num-batch",  type=int, default=100)
    parser.add_argument("-ns", "--num-sample", type=int, default=10000)
    parser.add_argument("-s",  "--seed",       type=int, default=10)
    parser.add_argument("-q",  "--quite",      default=False, action="store_true")


def _restore_svsp(args, num_class):
    """Checkpoint restore shared by test / predict: the latest (or ``-ci``)
    ``.npz`` and ``meta.npy`` -> (model, context). Raw (unconstrained)
    values are restored by name suffix (classification/test.py:129-144);
    eps is not restored (the reference evaluates with eps = 1e-6)."""
    if args.ckpt_index is None:
        indices = Checkpointer.list_indices(args.ckpt_dir)
        if not indices:
            raise SystemExit(f"no checkpoints (*.npz) found in {args.ckpt_dir}")
        args.ckpt_index = indices[-1]

    named = load_named(os.path.join(args.ckpt_dir,
                                    Checkpointer.FILE_FORMAT.format(args.ckpt_index)))
    context = np.load(os.path.join(args.ckpt_dir, "meta.npy"), allow_pickle=True).item()

    last_w_std = get_by_suffix(named, "last_w_std")
    if last_w_std is None:
        last_w_std = np.array(context["last_w_std"])
    method = context["method"]
    model = _make_model(method, context["network"], context["num_hiddens"],
                        context["activation"], 0., 0., 0., context.get("alpha", 2.),
                        context.get("beta", 2.), num_class,
                        get_by_suffix(named, "inducing_variable"), 1e-6)
    restore = {"kernel.w_std": get_by_suffix(named, "w_std"),
               "kernel.b_std": get_by_suffix(named, "b_std"),
               "kernel.last_w_std": last_w_std,
               "q_mu": get_by_suffix(named, "q_mu"),
               "q_sqrt": get_by_suffix(named, "q_sqrt")}
    if method == "svtp":
        restore["prior.a"] = get_by_suffix(named, "a")
        restore["prior.b"] = get_by_suffix(named, "b")
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, value in restore.items():
            params[name].copy_(torch.as_tensor(np.asarray(value), dtype=torch.float32))
    return model.to(args.device), context


def _resize_to_inducing(x, model):
    """Resize inputs to the inducing points' resolution
    (classification/test.py:112-114), on the host."""
    h, w = model.inducing_variable.shape[1:3]
    return bilinear_resize(x, h, w)


def test_main(args):
    (x_test, y_test), (num_class, data_name) = get_test_dataset(
        name=args.data_name, root=args.data_root, num_data=args.num_data, normalize=True)
    model, context = _restore_svsp(args, num_class)
    method, network = context["method"], context["network"]

    log_dir = os.path.join(args.ckpt_dir, "test")
    log_name = f"{method}-{network}-{data_name.replace('/', '-')}-{args.ckpt_index}.log"
    logger = Logger(log_dir, log_name, quite=args.quite)
    try:
        x_test = _resize_to_inducing(x_test, model)
        logger.log(f"Data: {data_name}")
        logger.log(f"Epoch: {args.ckpt_index}")

        test_loader = DataLoader(x_test, y_test, batch_size=args.num_batch, shuffle=False)
        generator = torch.Generator(device=args.device).manual_seed(args.seed)
        nll_sum, corrects = 0.0, 0
        with torch.no_grad():
            for x_batch, y_batch in progress(test_loader, args.quite, desc="Test", leave=False):
                xb, yb = _to_device(x_batch, y_batch, args.device)
                nll, cc = model.test_acc_nll(xb, yb, args.num_sample, generator)
                nll_sum += float(nll) * x_batch.shape[0]
                corrects += int(cc)
        logger.log(f"NLL: {nll_sum / test_loader.num_data:.5f}  "
                   f"ACC: {corrects * 100 / test_loader.num_data:.2f}\n")
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
    parser.add_argument("-dn", "--data-name",  required=True)
    parser.add_argument("-cd", "--ckpt-dir",   type=str, required=True)
    parser.add_argument("-ci", "--ckpt-index", type=int, default=None)
    parser.add_argument("-nd", "--num-data",   type=int, default=None)
    parser.add_argument("-nb", "--num-batch",  type=int, default=100)
    parser.add_argument("-ns", "--num-sample", type=int, default=10000)
    parser.add_argument("-i",  "--input",      type=str, default=None,
                        help=".npy of [N, H, W, C] images already normalized "
                             "like the training data; default = test split")
    parser.add_argument("-o",  "--output",     type=str, default=None,
                        help="output .npz of class probabilities [N, C]; "
                             "default <ckpt_dir>/predictions.npz")
    parser.add_argument("-s",  "--seed",       type=int, default=10)
    parser.add_argument("-q",  "--quite",      default=False, action="store_true")


def predict_main(args):
    (x_test, y_test), (num_class, data_name) = get_test_dataset(
        name=args.data_name, root=args.data_root, num_data=args.num_data, normalize=True)
    model, _ = _restore_svsp(args, num_class)

    logger = Logger(os.path.join(args.ckpt_dir, "predict"), "predict.log",
                    quite=args.quite)
    try:
        if args.input:
            x_in, y_eval = np.load(args.input), None
        else:
            x_in, y_eval = x_test, y_test
        x_in = _resize_to_inducing(x_in, model)

        generator = torch.Generator(device=args.device).manual_seed(args.seed)
        probas, nll_sum, corrects = [], 0.0, 0
        with torch.no_grad():
            fitted = fit_svsp(model)
            for start in range(0, x_in.shape[0], args.num_batch):
                stop = min(start + args.num_batch, x_in.shape[0])
                xb = torch.as_tensor(np.asarray(x_in[start:stop], np.float32),
                                     device=args.device)
                # One set of draws per batch serves both the probabilities
                # and the scores, as one JAX key does.
                draws = model.prior.draw((num_class, stop - start, args.num_sample),
                                         generator, like=xb)
                probas.append(fitted.predict_proba(xb, args.num_sample, draws=draws)
                              .cpu().numpy())
                if y_eval is not None:
                    yb = torch.as_tensor(np.asarray(y_eval[start:stop]), device=args.device)
                    nll, cc = fitted.test_acc_nll(xb, yb, args.num_sample, draws=draws)
                    nll_sum += float(nll) * xb.shape[0]
                    corrects += int(cc)

        proba = np.concatenate(probas, axis=0)
        out = args.output or os.path.join(args.ckpt_dir, "predictions.npz")
        np.savez(out, proba=proba, label=np.argmax(proba, axis=1))
        logger.log(f"predicted {proba.shape[0]} points -> {out}")
        if y_eval is not None:
            n = x_in.shape[0]
            logger.log(f"NLL: {nll_sum / n:.5f}  ACC: {corrects * 100 / n:.2f}\n")
    except Exception:
        import traceback
        logger.log(f"\n{traceback.format_exc()}\nStopped")
        raise
    finally:
        logger.close()
