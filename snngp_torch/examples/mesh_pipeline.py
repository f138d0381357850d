"""The pipeline on a device mesh, end to end (counterpart of
``examples/mesh_pipeline.py``):

    sharded NNGP Gram (row panels over the mesh)
      -> block-cyclic distributed Cholesky
      -> Student-t conditional predictive

with the seconds of each phase and, unless ``--no-parity``, the check
against the same pipeline on one device (mean rtol 1e-4 / atol 1e-5, NLL
rtol 1e-4). On the CPU the mesh is shards of the one CPU device:

    python -m snngp_torch.examples.mesh_pipeline --devices 8 --cpu --n-train 256

Without ``--cpu`` the mesh is ``--devices`` CUDA cards, which must exist.
A caller may hand ``main`` a mesh of its own, such as four shards of one
card (``get_mesh(devices=["cuda:0"] * 4)``); the shards then run one after
another, so the times are not a multi-card time.

``main`` first calls :func:`~snngp_torch.parallel.mesh.init_distributed`,
as the JAX script's docstring tells pods to, which is a no-op in a plain
run. Under ``torchrun`` it joins the ranks (``--dist-backend``: NCCL, the
default on CUDA, or gloo, the default with ``--cpu``), the mesh spans them
with ``--devices / ranks`` shards on each rank's device, and only rank 0
prints:

    torchrun --standalone --nproc-per-node 2 -m snngp_torch.examples.mesh_pipeline \
        --cpu --devices 2 --n-train 256 --eps 1e-1

Architectures: ``--arch mlp`` (any ``--image-size``; x is flattened; the
fused Gram, K1 on the card) or ``--arch myrtle`` (square 8, 16 or 32 pixel
images; the fused Myrtle Gram, K7 on the card, where the JAX script uses
the full tier).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from snngp_torch.nn import arch
from snngp_torch.ops.linalg import add_jitter, chol_quad_form, chol_solve, cholesky
from snngp_torch.ops.mvt import multivariate_t_logpdf
from snngp_torch.parallel import get_mesh, sharded_gram
from snngp_torch.parallel.cholesky import cyclic_cholesky
from snngp_torch.parallel.mesh import gather, init_distributed


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="emulate the mesh with shards of the CPU")
    ap.add_argument("--n-train", type=int, default=256)
    ap.add_argument("--n-test", type=int, default=32)
    ap.add_argument("--arch", choices=["mlp", "myrtle"], default="mlp")
    ap.add_argument("--image-size", type=int, default=8)
    ap.add_argument("--depth", type=int, default=3, help="mlp depth / myrtle {5,7,10}")
    ap.add_argument("--block", type=int, default=0,
                    help="cyclic-Cholesky panel size (0 = n_train/(4*devices))")
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--df", type=float, default=4.0, help="Student-t 2a")
    ap.add_argument("--no-parity", action="store_true",
                    help="skip the single-device reference run (large N)")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                    help="the process group's backend under torchrun (default: nccl on "
                         "CUDA, gloo with --cpu)")
    return ap


def _data(args):
    """The JAX script's seeded inputs, targets and kernel."""
    rng = np.random.RandomState(0)
    n = args.n_train + args.n_test
    if args.arch == "myrtle":
        s = args.image_size
        x = rng.rand(n, s, s, 3).astype(np.float32)
        kfn = arch.get_myrtle_kernel(args.depth if args.depth in (5, 7, 10) else 5, 1, "relu",
                                     w_std=1.0, b_std=0.1, last_w_std=1.0)
    else:
        x = rng.randn(n, args.image_size ** 2).astype(np.float32)
        kfn = arch.get_mlp_kernel(args.depth, act="relu", w_std=1.0, b_std=0.3,
                                  last_w_std=1.0)
    y = rng.randn(args.n_train).astype(np.float32)
    return x, y, kfn


def predictive(chol, k_td, k_tt, y, df):
    """Conditional-t predictive mean and NLL at zero targets."""
    n_train, n_test = y.shape[0], k_td.shape[0]
    mean = k_td @ chol_solve(chol, y[:, None])[:, 0]
    v = torch.linalg.solve_triangular(chol, k_td.mT, upper=False)
    cov = k_tt - v.mT @ v
    d = df + chol_quad_form(chol, y)
    t_cov = (d / (df + n_train)) * cov
    nll = -torch.mean(multivariate_t_logpdf(
        torch.zeros(n_test, dtype=y.dtype, device=y.device), mean, add_jitter(t_cov, 1e-4),
        torch.tensor(df + n_train, dtype=y.dtype, device=y.device)))
    return mean, nll


def main(argv=None, mesh=None):
    """Run the pipeline; returns {"nll", "phases_s", "parity_nll"} (the last
    None with ``--no-parity``, and on a rank other than 0)."""
    args = _parser().parse_args(argv)
    if mesh is None:
        device = "cpu" if args.cpu else "cuda"
        init_distributed(backend=args.dist_backend or ("gloo" if args.cpu else "nccl"),
                         device=device)
        mesh = get_mesh(args.devices, device=device)
    root = mesh.local_device()
    lead = mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    n_train, n_test, df = args.n_train, args.n_test, args.df
    if n_train % mesh.size:
        raise SystemExit(f"--n-train must divide the mesh size {mesh.size}")
    block = args.block or max(8, n_train // (4 * mesh.size))

    x_np, y_np, kfn = _data(args)
    x = torch.as_tensor(x_np, device=root)
    y = torch.as_tensor(y_np, device=root)
    xt, xs = x[:n_train], x[n_train:]

    def sync():
        if root.type == "cuda":
            torch.cuda.synchronize(root)

    phases = {}

    def timed(label, fn, *a):
        sync()
        t0 = time.perf_counter()
        out = fn(*a)
        sync()
        phases[label] = time.perf_counter() - t0
        say(f"  {label:<28s} {phases[label]:8.2f} s")
        return out

    ranks = f", ranks {mesh.ranks.reshape(-1).tolist()}" if mesh.distributed else ""
    say(f"mesh: {tuple(mesh.devices.shape)} on {[str(d) for d in mesh.device_list()]}{ranks}; "
        f"N={n_train} (+{n_test} test), arch={args.arch}, cyclic block={block}")
    with torch.no_grad():
        t_all = time.perf_counter()
        k_dd = timed("gram_train (sharded)", lambda: gather(sharded_gram(kfn, xt, mesh), root))
        k_td = timed("gram_cross (sharded)",
                     lambda: gather(sharded_gram(kfn, xs, mesh, x2=xt), root))
        k_tt = timed("gram_test", lambda: kfn(xs, xs, get="nngp"))
        chol = timed("cyclic_cholesky",
                     lambda: cyclic_cholesky(add_jitter(k_dd, args.eps), mesh, block=block))
        del k_dd
        mean, nll = timed("student-t predictive", predictive, chol, k_td, k_tt, y, df)
        say(f"  {'total':<28s} {time.perf_counter() - t_all:8.2f} s")
        say(f"predictive NLL: {float(nll):.6f}")
        del chol, k_td

        parity = None
        if not args.no_parity and lead:
            chol_s = cholesky(add_jitter(kfn(xt, xt, get="nngp"), args.eps))
            mean_s, nll_s = predictive(chol_s, kfn(xs, xt, get="nngp"), k_tt, y, df)
            np.testing.assert_allclose(mean.cpu().numpy(), mean_s.cpu().numpy(),
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(float(nll), float(nll_s), rtol=1e-4)
            parity = float(nll_s)
            say(f"parity vs single device: OK (NLL {parity:.6f})")
    return dict(nll=float(nll), phases_s=phases, parity_nll=parity)


if __name__ == "__main__":
    main()
