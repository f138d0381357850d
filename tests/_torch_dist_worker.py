"""Rank workers of tests/test_torch_dist.py: the port's mesh across the
ranks of a gloo process group on the CPU. Imports no JAX, so that the
spawned ranks do not.

:func:`run` joins the group through ``init_distributed`` (a ``file://``
rendezvous), runs every case of :data:`CASES` on a mesh of one shard a
rank (the Gram also on a 2 x 2 mesh), and pickles what it got to
``rank<r>.pkl``. Rank 0 then runs each case again on the port's mesh of
one process with as many shards (``ref``), in the same process and thread
count, so the two can be compared bit for bit.
"""

import pickle
import sys
from pathlib import Path

import numpy as np
import torch

HYPER = dict(w_std=1.3, b_std=0.4, last_w_std=0.9)      # tests/test_torch_mesh.py's
MLII_EPS = 3e-2
LOSS_EPS = 0.5
C, EB, EI = 3, 8, 6             # the CNN ELBO: 3 classes, batch 8, 6 inducing 8 x 8 x 3
S = 6                           # ELBO samples
STEPS = 3


def psd(n, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    a = rng.randn(n, n)
    return (a @ a.T / n + np.eye(n)).astype(dtype)


def gram_data():
    return np.random.RandomState(13).randn(32, 5).astype(np.float32)


def mlii_data():
    rng = np.random.RandomState(0)
    return rng.randn(64, 6).astype(np.float32), rng.randn(64).astype(np.float32)


def spr_data():
    rng = np.random.RandomState(31)
    return rng.randn(32, 3).astype(np.float32), rng.randn(32).astype(np.float32)


def cnn_data(seed=21):
    rng = np.random.RandomState(seed)
    z = rng.rand(EI, 8, 8, 3).astype(np.float32)
    x = rng.rand(EB, 8, 8, 3).astype(np.float32)
    y = rng.randint(C, size=EB)
    return z, x, y, rng


def myrtle_data():
    return np.random.RandomState(6).rand(8, 8, 8, 3).astype(np.float32)


def mlp_kernel():
    from snngp_torch.nn import arch
    return arch.get_mlp_kernel(2, 1, "relu", w_std=1.2, b_std=0.2, last_w_std=1.0)


def torch_aug(dtype=torch.float32):
    from snngp_torch.ops.gram import _reference_recursion
    w, b, l = (torch.tensor(HYPER[k], dtype=dtype) for k in ("w_std", "b_std", "last_w_std"))

    def aug(x1, x2):
        f = lambda wv, bv: _reference_recursion(x1, x2, 3, "relu", wv, bv, l, "mlp")  # noqa
        _, dkw = torch.func.jvp(lambda wv: f(wv, b), (w,), (torch.ones_like(w),))
        _, dkb = torch.func.jvp(lambda bv: f(w, bv), (b,), (torch.ones_like(b),))
        return f(w, b), dkw, dkb

    return aug


def spr_model(method, mesh):
    from snngp_torch.models import SPR, GaussianLikelihood, NNGPKernel, StudentTLikelihood
    from snngp_torch.nn import arch
    x, y = spr_data()
    kernel = NNGPKernel(lambda w, b, l: arch.get_mlp_kernel(2, act="relu", w_std=w, b_std=b,
                                                            last_w_std=l,
                                                            trainable_inputs=False),
                        1.2, 0.5, 0.9)
    lik = GaussianLikelihood() if method == "gp" else StudentTLikelihood(1.5, 2.5)
    return SPR(kernel, lik, x, y, 0.7, 1.3, eps=LOSS_EPS, mesh=mesh, chol_block=8)


def cnn_model(state):
    from snngp_torch.models import SVSP, GaussianPrior, NNGPKernel
    from snngp_torch.nn import arch
    z, _, _, _ = cnn_data()

    def kfn(w, b, l):
        return arch.get_cnn_kernel(2, C, "relu", w_std=w, b_std=b, last_w_std=l)

    model = SVSP(GaussianPrior(), NNGPKernel(kfn, 1.2, 0.1, 1.0), z, num_latent_gps=C,
                 eps=1e-3)
    model.load_state_dict(state)
    return model


def _grads(model):
    return {n: p.grad.detach().clone().numpy() for n, p in model.named_parameters()
            if p.grad is not None}


# -- the cases: each runs on ``mesh`` and returns numpy arrays and floats ----------------

def case_gram(mesh, mesh2d):
    from snngp_torch.parallel import mesh as M
    from snngp_torch.parallel.gram import sharded_gram
    x = torch.as_tensor(gram_data())
    kfn = mlp_kernel()
    panels = sharded_gram(kfn, x, mesh)
    out = {"1-D": M.gather(panels).numpy(),
           "local": [i for i, t in enumerate(panels) if t is not None]}
    if mesh2d is not None:
        out["2x2"] = M.gather(sharded_gram(kfn, x, mesh2d)).numpy()
    return out


def case_cholesky(mesh, mesh2d):
    from snngp_torch.parallel import mesh as M
    from snngp_torch.parallel.cholesky import cyclic_cholesky, distributed_cholesky
    out = {}
    for dtype in (np.float32, np.float64):
        a = torch.as_tensor(psd(64, seed=7, dtype=dtype))
        before = M.TRAFFIC["broadcast"]["calls"]
        out[f"cyclic {dtype.__name__}"] = cyclic_cholesky(a, mesh, block=8).numpy()
        out[f"cyclic broadcasts {dtype.__name__}"] = M.TRAFFIC["broadcast"]["calls"] - before
        out[f"pjit {dtype.__name__}"] = distributed_cholesky(a, mesh, block=8,
                                                             strategy="pjit").numpy()
    return out


def case_mlii(mesh, mesh2d):
    from snngp_torch.parallel.mlii import distributed_mlii_scalars, distributed_mlii_value_and_grad
    x, y = mlii_data()
    out = {}
    for name, ab in (("gp", None), ("tp", (2.0, 1.5))):
        out[name] = distributed_mlii_value_and_grad(
            torch_aug(), torch.as_tensor(x), y, mesh, last_w_std=HYPER["last_w_std"],
            eps=MLII_EPS, ab=ab, chol_block=4)
    out["scalars"] = distributed_mlii_scalars(torch_aug(), torch.as_tensor(x), y, mesh,
                                              eps=MLII_EPS, chol_block=4)
    return out


def case_spr(mesh, mesh2d):
    out = {}
    for method in ("gp", "tp"):
        model = spr_model(method, mesh)
        model.zero_grad()
        loss = model.loss()
        loss.backward()
        out[method] = (loss.item(), _grads(model))
    return out


def case_elbo(mesh, mesh2d, state, draws):
    _, x, y, _ = cnn_data()
    model = cnn_model(state)
    model.zero_grad()
    loss = model.loss(torch.as_tensor(x), torch.as_tensor(y), 100, S,
                      draws=torch.as_tensor(draws), mesh=mesh)
    loss.backward()
    return loss.item(), _grads(model)


def case_steps(mesh, mesh2d):
    from snngp_torch.utils import Adam, train_step
    model = spr_model("tp", mesh)
    opt = Adam(model)
    losses = [train_step(model, opt, 1e-2).item() for _ in range(STEPS)]
    return losses, {n: p.detach().clone().numpy() for n, p in model.named_parameters()}


def case_myrtle(mesh, mesh2d):
    from snngp_torch.ops.myrtle_gram import myrtle_gram_sharded
    from snngp_torch.parallel.mesh import gather
    shards = myrtle_gram_sharded(torch.as_tensor(myrtle_data()), None, mesh, depth=5,
                                 act="relu", w_std=1.0, b_std=0.1, last_w_std=1.0)
    return gather(shards).numpy()


def case_pipeline(mesh, mesh2d):
    """``examples/mesh_pipeline.py`` as torchrun runs it (the group is joined
    already: ``init_distributed`` returns at once), or on the given mesh of
    one process: its NLL and what it printed."""
    import contextlib
    import io
    from snngp_torch.examples import mesh_pipeline
    argv = ["--cpu", "--devices", str(mesh.size), "--n-train", "64", "--n-test", "8",
            "--eps", "1e-1"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = mesh_pipeline.main(argv, mesh=None if mesh.distributed else mesh)
    return res["nll"], res["parity_nll"], out.getvalue()


CASES = {"gram": case_gram, "cholesky": case_cholesky, "mlii": case_mlii, "spr": case_spr,
         "elbo": case_elbo, "steps": case_steps, "myrtle": case_myrtle,
         "pipeline": case_pipeline}


def run(rank, world, rendezvous, out_dir, elbo_state, elbo_draws):
    """One rank: join, run every case across the ranks (and on rank 0 on the
    one-process mesh), pickle the results."""
    torch.set_num_threads(1)
    from snngp_torch.parallel import mesh as M

    assert M.init_distributed(f"file://{rendezvous}", world, rank, backend="gloo")
    assert M.init_distributed() is True                  # idempotent
    info = {"device_count": M.device_count(), "device_count_cpu": M.device_count("cpu"),
            "jax": "jax" in sys.modules}
    mesh = M.get_mesh(device="cpu")
    mesh2d = M.get_mesh(shape=(2, 2), device="cpu") if 4 % world == 0 else None
    info["mesh"] = (mesh.size, mesh.ranks.tolist(), mesh.distributed, mesh.rank)
    extra = {"elbo": (elbo_state, elbo_draws)}
    got = {name: fn(mesh, mesh2d, *extra.get(name, ())) for name, fn in CASES.items()}
    info["traffic"] = {k: dict(v) for k, v in M.TRAFFIC.items()}
    ref = None
    if rank == 0:
        one = M.get_mesh(devices=["cpu"] * world)
        one2d = M.get_mesh(shape=(2, 2), devices=["cpu"] * 4) if mesh2d is not None else None
        assert not one.distributed
        ref = {name: fn(one, one2d, *extra.get(name, ())) for name, fn in CASES.items()}
    info["jax_after"] = "jax" in sys.modules
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump({"got": got, "ref": ref, "info": info}, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
