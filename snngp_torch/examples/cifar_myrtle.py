"""The north-star pipeline on the port: the Myrtle conv-NNGP Gram, its
Cholesky factor and the Student-t predictive (counterpart of
``examples/cifar_myrtle.py``).

    python -m snngp_torch.examples.cifar_myrtle --device cuda --image-size 32 \
        --depth 5 --n-train 1024 --n-test 256 --fused on --mlii 3 --mlii-n 256

The images are CIFAR-10's if its batches are under ./data/cifar10, else
seeded synthetic ones; the targets are the class labels, regressed. With
``--fused`` on (``auto``: a CUDA device and an image side of 8, 16 or 32)
the three Gram blocks are assembled by
:func:`snngp_torch.ops.myrtle_gram.myrtle_gram_tiled` (K7 on the card, its
plain version on the CPU) into host memory, resumable with
``--resume-gram``; with ``off`` they come from the full spatial-covariance
tier, tile by tile. ``--mlii N`` first fits (w_std, b_std, last_w_std, eps
and the Student-t a, b) by N steps of Adam on the marginal NLL: of an
``--mlii-n`` subset, through the fused Gram's scalar-tangent backward
(``--mlii-scope subset``), or of the whole training set (``full``), by the
closed-form gradient of :mod:`snngp_torch.models.mlii` over one augmented
tiled assembly a step (K7's tangent mode on the card, ``--fused-block``
tiles, a per-block profile cache, ``--mlii-panel`` S^{-1} panels),
resumable under ``<--resume-gram>/mlii``.

``--chol`` picks the factorization: ``inplace`` (``fit_spr(memory_lean=True)``,
the Gram factored in its own device buffer) for ``auto`` at N >= 32,768,
else ``xla`` (``torch.linalg``, cuSOLVER on the card). On one device
``blocked`` (:func:`snngp_torch.parallel.cholesky.blocked_cholesky`) runs
only when asked for: the JAX script's ``auto`` takes it from N = 4,096,
where it shards under GSPMD, but on one card it is panels of cuSOLVER's
work. On a mesh ``auto`` takes it from N = 4,096 as the JAX script does,
with its automatic panel (512 rows, grown so that there are at most 24).

``--devices N`` (or a mesh handed to :func:`main`, such as four shards of
one card) evaluates the Grams on a mesh: with ``--fused`` as row panels of
:func:`snngp_torch.ops.myrtle_gram.myrtle_gram_sharded` (no
``--resume-gram``, no ``--fused-block``), else each ``--tile`` row strip of
the full tier through :func:`snngp_torch.parallel.gram.sharded_gram`. The
rows of each Gram must divide the mesh. ``SPR(mesh=)`` then factors through
the blocked Cholesky whatever ``--chol`` says (512-row panels below 4,096
points, the automatic panel above), ``auto`` never takes the
memory-lean fit, and ``inplace`` is refused. An ML-II fit runs on one
device first, as in the JAX script.

``--bf16`` runs the Gram's pair state in bfloat16: the full tier's
(``--fused off``), or K7's (``--fused on``: its bf16 variant on the card,
its bf16 plain version on the CPU, as the JAX script does off the TPU). It
raises ``--eps`` to at least 1e-2 and scores the predictive with an extra
1e-2 y_std^2 of variance (the JAX script's numerics-validation quirk). The
Student-t scale factorization of a bf16 Gram needs ``--t-jitter 1e-2``: at
the default 1e-6 it is NaN, in both packages. The JAX dispatch knobs ``--scan-chunk`` / ``--remat`` raise
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from snngp_torch.data.classification import _load_cifar10_dir
from snngp_torch.data.resize import bilinear_resize
from snngp_torch.models import SPR, GaussianLikelihood, NNGPKernel, StudentTLikelihood, fit_spr
from snngp_torch.models import params as P
from snngp_torch.models.likelihoods import student_t_logpdf
from snngp_torch.nn.arch import get_myrtle_kernel
from snngp_torch.nn.full import get_myrtle_kernel as full_myrtle
from snngp_torch.nn.full import scan_tiled_gram
from snngp_torch.ops.myrtle_gram import myrtle_gram_sharded, myrtle_gram_tiled
from snngp_torch.parallel import get_mesh, sharded_gram
from snngp_torch.parallel.cholesky import blocked_cholesky
from snngp_torch.parallel.mesh import gather
from snngp_torch.utils import Adam, Profiler


def load_images(n, image_size, seed):
    """CIFAR-10 batches if cached under ./data, else seeded synthetic;
    (images [n, s, s, 3], labels [n]) as float32 numpy."""
    try:
        x, y, _ = _load_cifar10_dir("./data/cifar10", "train")
        x = x[:n] / 255.0
    except Exception:
        rng = np.random.RandomState(seed)
        x = rng.rand(n, 32, 32, 3)
        y = rng.randint(10, size=n)
    x = bilinear_resize(np.asarray(x, np.float32), image_size, image_size)
    return x, np.asarray(y[:n], np.float32)


def mlii_fit(args, x_sub, y_sub, device):
    """ML-II fit of the Myrtle kernel's scales and eps (and the Student-t
    a, b) on a training subset: full-batch Adam on the marginal NLL, with
    the Gram's scalar-tangent backward (``trainable_inputs=False``)."""
    def get_kernel_fn(w_std, b_std, last_w_std):
        return get_myrtle_kernel(args.depth, 1, "relu", w_std=w_std, b_std=b_std,
                                 last_w_std=last_w_std, trainable_inputs=False)

    kernel = NNGPKernel(get_kernel_fn, 1.0, 0.1, 1.0)
    lik = (StudentTLikelihood(args.alpha, args.beta) if args.mlii_method == "tp"
           else GaussianLikelihood())
    model = SPR(kernel, lik, x_sub, y_sub, 0.0, 1.0, eps=args.eps).to(device)
    opt = Adam(model)
    t0 = time.time()
    for i in range(args.mlii):
        opt.zero_grad()
        loss = model.loss()
        loss.backward()
        opt.update(args.mlii_lr)
        if i % max(1, args.mlii // 8) == 0 or i == args.mlii - 1:
            print(f"[mlii] step {i + 1}/{args.mlii}: nll {loss.item():.4f}")
    with torch.no_grad():
        w, b, l = (float(v) for v in kernel.get_params())
        eps = float(P.constrained_read(model.eps, model.bij))
        alpha, beta = args.alpha, args.beta
        if args.mlii_method == "tp":
            alpha, beta = (float(v) for v in lik._ab())
    hyper = dict(w_std=w, b_std=b, last_w_std=l)
    print(f"[mlii] {args.mlii} steps on N={x_sub.shape[0]} in {time.time() - t0:.1f}s -> "
          f"{hyper} eps {eps:.3e}"
          + (f" a {alpha:.3f} b {beta:.3f}" if args.mlii_method == "tp" else ""))
    return hyper, eps, alpha, beta


def mlii_full(args, x_train, y_train, hyper, device):
    """Full-scope ML-II (:func:`snngp_torch.models.mlii.mlii_fit_full`) over
    the whole training set, from ``hyper`` and ``--eps`` (and ``--alpha`` /
    ``--beta`` for tp); returns (hyper, eps, alpha, beta)."""
    from snngp_torch.models.mlii import mlii_fit_full
    from snngp_torch.ops.myrtle_gram import myrtle_gram_scale_grads, myrtle_profile_tangents

    def aug_builder(w, b, l):
        return lambda xa, xb, profiles=None: myrtle_gram_scale_grads(
            xa, xb, depth=args.depth, act="relu", w_std=w, b_std=b, last_w_std=l,
            profiles=profiles)

    def profile_builder(w, b):
        # the per-block profile cache: one profile recursion a block a step
        return lambda xb: myrtle_profile_tangents(xb, depth=args.depth, act="relu",
                                                  w_std=w, b_std=b)

    resume = os.path.join(args.resume_gram, "mlii") if args.resume_gram else None
    tp = args.mlii_method == "tp"
    hyper, eps, ab, _ = mlii_fit_full(
        aug_builder, torch.as_tensor(x_train, device=device), y_train, steps=args.mlii,
        lr=args.mlii_lr, block=args.fused_block, init_hyper=hyper, eps=args.eps,
        ab=(args.alpha, args.beta) if tp else None, panel=args.mlii_panel,
        resume_dir=resume, profile_builder=profile_builder, device=device)
    alpha, beta = ab if tp else (args.alpha, args.beta)
    return hyper, eps, alpha, beta


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--n-train", type=int, default=128)
    ap.add_argument("--n-test", type=int, default=32)
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--tile", type=int, default=8,
                    help="tile of the full-tier assembly (--fused off)")
    ap.add_argument("--depth", type=int, default=5, choices=[5, 7, 10])
    ap.add_argument("--alpha", type=float, default=2.0)
    ap.add_argument("--beta", type=float, default=2.0)
    ap.add_argument("--eps", type=float, default=1e-4,
                    help="absolute regularizer of the train Gram (K + eps I)")
    ap.add_argument("--bf16", action="store_true",
                    help="the Gram's pair state in bfloat16, on the full tier or the fused "
                         "Gram (eps raised to 1e-2)")
    ap.add_argument("--scan-chunk", type=int, default=0,
                    help="JAX dispatch knob (lax.scan chunks): not ported")
    ap.add_argument("--remat", action="store_true", help="JAX dispatch knob: not ported")
    ap.add_argument("--devices", type=int, default=1,
                    help="evaluate the Grams on a mesh of this many devices of --device")
    ap.add_argument("--fused", choices=["auto", "on", "off"], default="auto",
                    help="assemble the Grams with the fused Myrtle Gram (K7 on the "
                         "card); auto = a CUDA device and an image side of 8, 16 or 32")
    ap.add_argument("--fused-block", type=int, default=512,
                    help="block of the fused assembly")
    ap.add_argument("--resume-gram", default="",
                    help="directory for resumable fused-Gram assembly: each Gram in an "
                         ".npy memmap with a block bitmap, flushed per block")
    ap.add_argument("--mlii", type=int, default=0,
                    help="ML-II steps on an --mlii-n training subset first")
    ap.add_argument("--mlii-n", type=int, default=512,
                    help="subset size for the ML-II fit (subset scope only)")
    ap.add_argument("--mlii-scope", choices=["subset", "full"], default="subset",
                    help="subset: autograd through the fused Gram on an --mlii-n "
                         "subset; full: the exact full-Gram gradient at tiled scale, "
                         "one augmented assembly (K, dK/dw, dK/db) + factorization + "
                         "streamed S^-1 panel contractions a step (models/mlii.py)")
    ap.add_argument("--mlii-panel", type=int, default=2048,
                    help="S^-1 panel width of the full-scope contraction")
    ap.add_argument("--mlii-method", choices=["gp", "tp"], default="tp")
    ap.add_argument("--mlii-lr", type=float, default=1e-2)
    ap.add_argument("--chol", choices=["auto", "xla", "blocked", "inplace"], default="auto",
                    help="factorization: torch.linalg (xla), blocked panels (blocked), the "
                         "memory-lean fit in the Gram's own buffer (inplace); auto = "
                         "inplace at N >= 32768, else xla; on a mesh blocked at "
                         "N >= 4096")
    ap.add_argument("--t-jitter", type=float, default=1e-6,
                    help="absolute jitter on the scaled Gram (b/a) K of the Student-t "
                         "data scale")
    ap.add_argument("--var-floor", type=float, default=1e-6,
                    help="posterior-variance floor relative to the prior test variance")
    return ap


def _chol_route(chol, n_train, mesh=None):
    """(memory_lean, chol_fn) of ``fit_spr`` for ``--chol`` at ``n_train``.
    On a ``mesh``, ``auto`` from 4,096 points is the blocked factorization
    with its automatic panel (at most 24 panels), as in the JAX script;
    below that ``SPR`` installs its blocked factorization for a ``chol_fn``
    of None. One device keeps its own ``auto``: in place from 32,768
    points, else ``torch.linalg``."""
    if chol == "inplace" and mesh is not None:
        raise SystemExit("--chol inplace is a single-device kernel (donated fori-loop "
                         "carry); with --devices use --chol blocked, which shards under "
                         "GSPMD.")
    memory_lean = chol == "inplace" or (chol == "auto" and n_train >= 32768
                                        and mesh is None)
    blocked = chol == "blocked" or (chol == "auto" and mesh is not None and n_train >= 4096)
    return memory_lean, (blocked_cholesky if blocked else None)


def _strips(kernel_fn, x1, x2, tile, mesh):
    """K(x1, x2) from the full tier on a mesh, one [tile, N2] row strip at a
    time through ``sharded_gram`` (the JAX script's ``tiled_gram``), into a
    host array."""
    n1 = x1.shape[0]
    if n1 % tile:
        raise ValueError("pad inputs to the tile size")
    out = np.zeros((n1, x2.shape[0]), np.float32)
    with torch.no_grad():
        for i in range(0, n1, tile):
            strip = gather(sharded_gram(kernel_fn, x1[i:i + tile], mesh, x2=x2))
            out[i:i + tile] = strip.float().cpu().numpy()
    return out


def _check_unported(args):
    if args.scan_chunk or args.remat:
        raise NotImplementedError("--scan-chunk / --remat batch JAX dispatches; the port "
                                  "dispatches eagerly and does not take them")


def main(argv=None, mesh=None):
    """Run the pipeline; returns {"nll", "phases_s", "hyper", "mlii_s"} (the
    last the wall time of the ML-II fit, 0 without ``--mlii``). ``mesh``
    takes the place of the one ``--devices`` would build."""
    args = _parser().parse_args(argv)
    _check_unported(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: CUDA is not available")
    device = torch.device(args.device)
    if mesh is None and args.devices > 1:
        mesh = get_mesh(args.devices, device=device)
    fused = (args.fused == "on"
             or (args.fused == "auto" and device.type == "cuda"
                 and args.image_size in (8, 16, 32)))
    # --bf16 holds on both paths, as in the JAX script off the TPU: the full
    # tier's state, or K7's pair state (its bf16 variant on the card, the
    # bf16 plain version on the CPU).
    fused_dtype = torch.bfloat16 if args.bf16 and fused else None

    x, y = load_images(args.n_train + args.n_test, args.image_size, seed=0)
    x_train, x_test = x[:args.n_train], x[args.n_train:]
    y_mean = np.float32(np.mean(y[:args.n_train]))
    y_std = np.float32(np.std(y[:args.n_train]))
    y_train = (y[:args.n_train] - y_mean) / y_std

    hyper = dict(w_std=1.0, b_std=0.1, last_w_std=1.0)
    t0 = time.perf_counter()
    if args.mlii and args.mlii_scope == "full":
        hyper, args.eps, args.alpha, args.beta = mlii_full(args, x_train, y_train, hyper,
                                                           device)
    elif args.mlii:
        n_fit = min(args.mlii_n, args.n_train)
        hyper, args.eps, args.alpha, args.beta = mlii_fit(
            args, x_train[:n_fit], y_train[:n_fit], device)
    mlii_s = time.perf_counter() - t0

    # bf16 Gram entries carry ~1e-2 relative noise: the solve needs a
    # regularizer to match (the JAX script's rule).
    if args.bf16 and args.eps < 1e-2:
        args.eps = 1e-2
    xt_train = torch.as_tensor(x_train, device=device)
    xt_test = torch.as_tensor(x_test, device=device)
    prof = Profiler()

    if fused and mesh is not None:
        def gram(a, b, symmetric, name=""):
            shards = myrtle_gram_sharded(a, None if symmetric else b, mesh, depth=args.depth,
                                         act="relu", dtype=fused_dtype, **hyper)
            return gather(shards).cpu().numpy()
    elif fused:
        if args.resume_gram:
            os.makedirs(args.resume_gram, exist_ok=True)

        def gram(a, b, symmetric, name=""):
            resume = (os.path.join(args.resume_gram, f"gram_{name}.npy")
                      if args.resume_gram else None)
            return myrtle_gram_tiled(a, None if symmetric else b, depth=args.depth,
                                     act="relu", block=args.fused_block, log=print,
                                     resume_path=resume, dtype=fused_dtype, **hyper)
    else:
        kfn = full_myrtle(args.depth, 1, "relu",
                          dtype=torch.bfloat16 if args.bf16 else None, **hyper)

        def gram(a, b, symmetric, name=""):
            if mesh is not None:
                return _strips(kfn, a, b, args.tile, mesh)
            return scan_tiled_gram(kfn, a, None if symmetric else b, tile=args.tile)

    with prof.phase("gram_train"):
        k_dd = gram(xt_train, xt_train, True, "train")
    with prof.phase("gram_cross"):
        k_td = gram(xt_test, xt_train, False, "cross")
    with prof.phase("gram_test"):
        k_tt = gram(xt_test, xt_test, True, "test")

    # --eps is absolute; fit_spr applies the trace-relative add_diag_reg,
    # so convert: eps_rel tr(K) / N == args.eps.
    eps_rel = args.eps / (float(np.trace(k_dd)) / args.n_train)

    def kernel_builder(w_std, b_std, last_w_std):
        return get_myrtle_kernel(args.depth, 1, "relu", w_std=w_std, b_std=b_std,
                                 last_w_std=last_w_std, trainable_inputs=False)

    memory_lean, chol_fn = _chol_route(args.chol, args.n_train, mesh)

    kernel = NNGPKernel(kernel_builder, hyper["w_std"], hyper["b_std"], hyper["last_w_std"])
    model = SPR(kernel, StudentTLikelihood(args.alpha, args.beta, chol_fn=chol_fn), x_train,
                y_train, y_mean, y_std, eps=eps_rel, mesh=mesh).to(device)
    y_test_n = torch.as_tensor((y[args.n_train:] - y_mean) / y_std, device=device)
    with torch.no_grad():
        with prof.phase("fit"):
            fitted = fit_spr(model, memory_lean=memory_lean, gram=k_dd,
                             var_floor=args.var_floor, t_jitter=args.t_jitter)
        if memory_lean:
            del k_dd                      # the factor holds the one N x N buffer
        with prof.phase("predictive"):
            k_tt_diag = np.diagonal(k_tt).copy()
            if args.bf16:
                # The JAX script's bf16 quirk: ~1e-2 relative Gram noise takes
                # an additive variance the library's scoring does not model.
                mean_d, var_d = fitted.predict_given(k_td, k_tt_diag)
                var_d = var_d + 1e-2 * float(y_std) ** 2
                y_den = y_test_n * float(y_std) + float(y_mean)
                nll = -torch.mean(student_t_logpdf(y_den, fitted.state["cond_df"], mean_d,
                                                   torch.sqrt(var_d)))
            else:
                nll = fitted.test_nll_given(k_td, k_tt_diag, y_test_n)
    print(prof.report())
    total = sum(prof.totals.values())
    print(f"\nN={args.n_train} Myrtle-{args.depth} ({args.image_size}x{args.image_size}) "
          f"pipeline total: {total:.2f}s  t-predictive NLL (de-normalized, reference "
          f"semantics): {float(nll):.4f}")
    return dict(nll=float(nll), phases_s=dict(prof.totals), hyper=hyper, mlii_s=mlii_s,
                bf16_effective=args.bf16)


if __name__ == "__main__":
    main()
