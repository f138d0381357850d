#!/usr/bin/env python3
"""The mesh across processes on the card: one rank of a ``torch.distributed``
group, run under torchrun; ``chip_smoke.py``'s phase 31 runs it.

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        snngp_torch/tools/dist_mesh.py --backend gloo --device cuda:0 \\
        --refs build/chip_smoke/dist_refs.npz

Each rank joins the group (``init_distributed``), builds a mesh of one
shard a rank on ``--device`` and, with its launch counts set to 0, runs
the parts of ``--parts`` at ``chip_smoke.py``'s sizes:

- ``gram``: the sharded K1 Gram at MESH_N x MESH_D, gathered on every
  rank, and ``cyclic_cholesky`` / ``distributed_cholesky`` (the row-panel
  "pjit" strategy) of it plus MESH_EPS, block MESH_BLOCK (``--gram-n`` changes N);
- ``spr``: ``SPR.loss`` on the mesh at phase 5's N = 10,000 and its
  gradients (K1 panels, K2 in the backward), twice (the second timed as
  the step, the first a fresh process's first call);
- ``mlii``: the distributed ML-II step at MESH_MLII_N images (K7's
  tangent mode): ``distributed_mlii_scalars`` and the closed form, gp and
  tp;
- ``elbo``: one CNN ``SVSP.loss(mesh=)`` and its gradients at the CIFAR
  shape (K3).

Then it reads its counts and checks, outside that window: the Grams and the
factors bit for bit against the port's mesh of one process with as many
shards on the same device (on rank 0), q and logdet S bit for bit and the
six ML-II sums within 1e-12 relative of it, the losses bit for bit against
it, and the ``spr`` / ``elbo`` gradients against the float64 references of
``--refs`` (phases 5 and 9), within 2x the single-device fp32 error. Every
rank's losses and gradients, and checksums of its Grams and factors, must
equal rank 0's, and no rank may import JAX. Rank 0 prints each rank's
seconds by part, its collectives' calls and bytes
(``snngp_torch.parallel.mesh.TRAFFIC``) and its launch counts, then one
JSON line (``[dist-json]``); any failed check exits 1.
Needs CUDA and ``chip_smoke.py`` beside the package; on a gloo group the
ranks may share one card (NCCL refuses two ranks on one card).
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
PARTS = ("gram", "spr", "mlii", "elbo")
SUMS_RTOL = 1e-12


def _timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _checksum(t, chunk=1 << 26):
    """Two int64 sums of a tensor's bits (plain and position-weighted), by
    chunks: equal bits give equal sums."""
    import torch
    bits = t.contiguous().view(-1).view(torch.int32)
    plain = weighted = 0
    for s in range(0, bits.numel(), chunk):
        b = bits[s:s + chunk].long()
        w = (torch.arange(s, s + b.numel(), device=t.device) % 65521) + 1
        plain += int(b.sum())
        weighted += int((b * w).sum())
    return [plain, weighted]


def _gram_inputs(smoke, n):
    import torch
    from snngp_torch.nn import arch
    x = np.random.RandomState(25).randn(n, smoke.MESH_D).astype(np.float32)
    kfn = arch.get_mlp_kernel(3, act="relu", w_std=1.0, b_std=0.3, last_w_std=1.0)
    return torch.as_tensor(x, device="cuda"), kfn


def run_gram(smoke, mesh, n):
    """(results kept for the checks, seconds by step)."""
    from snngp_torch.parallel import distributed_cholesky, sharded_gram
    from snngp_torch.parallel.cholesky import cyclic_cholesky
    from snngp_torch.parallel.mesh import gather
    x, kfn = _gram_inputs(smoke, n)
    gram, t_gram = _timed(lambda: gather(sharded_gram(kfn, x, mesh)))
    s = gram.clone()
    s.diagonal().add_(smoke.MESH_EPS)
    cyc, t_cyc = _timed(lambda: cyclic_cholesky(s, mesh, block=smoke.MESH_BLOCK))
    pjit, t_pjit = _timed(lambda: distributed_cholesky(s, mesh, block=smoke.MESH_BLOCK,
                                                       strategy="pjit"))
    return (dict(gram=gram, cyclic=cyc, pjit=pjit),
            {"sharded_gram": t_gram, "cyclic_cholesky": t_cyc, "pjit_cholesky": t_pjit})


def check_gram(smoke, one, got, n):
    """Bitwise against the one-process mesh (rank 0)."""
    from snngp_torch.parallel import distributed_cholesky, sharded_gram
    from snngp_torch.parallel.cholesky import cyclic_cholesky
    from snngp_torch.parallel.mesh import gather
    x, kfn = _gram_inputs(smoke, n)
    out = {}
    ref = gather(sharded_gram(kfn, x, one))
    out["gram bitwise"] = bool((ref == got["gram"]).all())
    ref.diagonal().add_(smoke.MESH_EPS)
    for name, fn in (("cyclic", lambda: cyclic_cholesky(ref, one, block=smoke.MESH_BLOCK)),
                     ("pjit", lambda: distributed_cholesky(ref, one, block=smoke.MESH_BLOCK,
                                                           strategy="pjit"))):
        lfac = fn()
        out[f"{name} bitwise"] = bool((lfac == got[name]).all())
        del lfac
    return out


def _spr_model(smoke, mesh):
    import functools
    import torch
    from snngp_torch.parallel.cholesky import blocked_cholesky
    xs, ys, _, y_mean, y_std = smoke._serving_data()
    model = smoke._model(xs, ys, y_mean, y_std, fused=True, dtype=torch.float32,
                         eps=smoke.TRAIN_EPS)
    model.mesh = mesh
    model.likelihood.chol_fn = functools.partial(blocked_cholesky, block=512)
    return model


def run_spr(smoke, mesh):
    """Twice: the first call in a fresh process also pays for the libraries'
    first use; the second is the one kept and timed as the step."""
    model = _spr_model(smoke, mesh)
    _, t_first = _timed(lambda: smoke._loss_and_grads(model))
    (loss, _, g), t = _timed(lambda: smoke._loss_and_grads(model))
    return (dict(loss=loss, g=g.cpu().numpy()),
            {"spr_loss_and_grads (first call)": t_first, "spr_loss_and_grads": t})


def check_spr(smoke, one, got, refs):
    loss = smoke._loss_and_grads(_spr_model(smoke, one))[0]
    g64 = refs["spr_g64"]
    err = float(np.linalg.norm(got["g"] - g64) / np.linalg.norm(g64))
    bar = 2.0 * max(float(refs["spr_kernel_err"]), 1e-6)
    return {"loss bitwise": loss == got["loss"], "gradient err": err, "gradient bar": bar,
            "gradient ok": err <= bar}


def _mlii_inputs(smoke):
    import torch
    xm, ym = smoke._mlii_mesh_data()
    return torch.as_tensor(xm, device="cuda"), ym


def run_mlii(smoke, mesh):
    from snngp_torch.models.mlii import closed_form_value_and_grad
    from snngp_torch.parallel.mlii import distributed_mlii_scalars
    xm, ym = _mlii_inputs(smoke)
    (q, logdet, sums), t = _timed(lambda: distributed_mlii_scalars(
        smoke._mesh_aug(), xm, ym, mesh, eps=smoke.MLII_EPS))
    last = smoke.MLII_HYPER["last_w_std"]
    out = {"q": q, "logdet": logdet, "sums": sums}
    for method, ab in (("gp", None), ("tp", smoke.MLII_AB)):
        out[method] = closed_form_value_and_grad(q, logdet, xm.shape[0], *sums, last_w_std=last,
                                                 eps=smoke.MLII_EPS, ab=ab)
    return out, {"distributed_mlii": t}


def check_mlii(smoke, one, got):
    from snngp_torch.parallel.mlii import distributed_mlii_scalars
    xm, ym = _mlii_inputs(smoke)
    q, logdet, sums = distributed_mlii_scalars(smoke._mesh_aug(), xm, ym, one,
                                               eps=smoke.MLII_EPS)
    rel = max(abs(a - b) / abs(b) for a, b in zip(got["sums"], sums))
    finite = all(np.isfinite(got[m][0]) for m in ("gp", "tp"))
    return {"q and logdet bitwise": (q, logdet) == (got["q"], got["logdet"]),
            "sums rel": rel, "sums ok": rel <= SUMS_RTOL, "finite": finite}


def _elbo_inputs(smoke):
    import torch
    x, y, z, num_class = smoke._svsp_data()
    nb = smoke.SVSP_NB
    model = smoke._svsp_model("svgp", z, num_class, network="cnn", eps=1e-2)
    draws = smoke._cast_draws(smoke._svsp_draws("svgp", num_class, nb), torch.float32)
    xb = torch.as_tensor(x[:nb], device="cuda", dtype=torch.float32)
    yb = torch.as_tensor(y[:nb], device="cuda")
    return model, xb, yb, x.shape[0], draws


def run_elbo(smoke, mesh):
    model, xb, yb, n, draws = _elbo_inputs(smoke)
    (loss, g), t = _timed(lambda: smoke._mesh_loss_and_grads(model, xb, yb, n, draws, mesh))
    return dict(loss=loss, g=g.cpu().numpy()), {"cnn_elbo_and_grads": t}


def check_elbo(smoke, one, got, refs):
    model, xb, yb, n, draws = _elbo_inputs(smoke)
    loss = smoke._mesh_loss_and_grads(model, xb, yb, n, draws, one)[0]
    g64 = refs["elbo_g64"]
    err = float(np.linalg.norm(got["g"] - g64) / np.linalg.norm(g64))
    bar = 2.0 * max(float(refs["elbo_kernel_err"]), 1e-6)
    return {"loss bitwise": loss == got["loss"], "gradient err": err, "gradient bar": bar,
            "gradient ok": err <= bar}


def _digest(part, got):
    """What every rank must hold alike: values, or checksums of big tensors."""
    if part == "gram":
        return {k: _checksum(v) for k, v in got.items()}
    if part == "mlii":
        return {k: got[k] for k in ("q", "logdet", "sums", "gp", "tp")}
    return {"loss": got["loss"], "g": got["g"].tolist()}


def _failed(checks):
    bad = []
    for part, c in checks.items():
        for k, v in c.items():
            if isinstance(v, bool) and not v:
                bad.append(f"{part}: {k}")
    return bad


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", choices=["gloo", "nccl"], default="nccl")
    ap.add_argument("--device", default="cuda", help="each rank's device (default "
                    "cuda:LOCAL_RANK)")
    ap.add_argument("--parts", nargs="+", choices=PARTS, default=list(PARTS))
    ap.add_argument("--gram-n", type=int, default=0, help="the gram part's N (default MESH_N)")
    ap.add_argument("--refs", help="float64 gradient references (.npz) for spr and elbo")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    import torch
    import torch.distributed as dist
    from snngp_torch.ops import _build
    from snngp_torch.parallel import mesh as M

    if not torch.cuda.is_available():
        print("dist_mesh: CUDA is not available", file=sys.stderr)
        return 2
    if not M.init_distributed(backend=args.backend, device=args.device):
        print("dist_mesh: no process group to join (run it under torchrun)", file=sys.stderr)
        return 2
    rank, world = dist.get_rank(), dist.get_world_size()
    import snngp_torch  # noqa: F401  (precision policy)
    for name in ("gram", "conv_gram", "myrtle_gram"):
        _build.load(name)
    mesh = M.get_mesh(device=args.device)
    one = M.get_mesh(devices=[mesh.local_device()] * world)
    refs = dict(np.load(args.refs)) if args.refs else None
    n = args.gram_n or smoke.MESH_N

    smoke._reset_launches()                 # the path across the ranks starts here
    got, seconds = {}, {}
    for part in args.parts:
        if part == "gram":
            got[part], t = run_gram(smoke, mesh, n)
        else:
            got[part], t = {"spr": run_spr, "mlii": run_mlii, "elbo": run_elbo}[part](smoke,
                                                                                     mesh)
        seconds.update(t)
    launches = smoke._launches()            # ends here
    traffic = {k: dict(v) for k, v in M.TRAFFIC.items()}
    digests = {part: _digest(part, got[part]) for part in args.parts}
    checks = {}
    if rank == 0:
        for part in args.parts:
            if part == "gram":
                checks[part] = check_gram(smoke, one, got[part], n)
            elif part == "mlii":
                checks[part] = check_mlii(smoke, one, got[part])
            elif refs is not None:
                checks[part] = {"spr": check_spr, "elbo": check_elbo}[part](
                    smoke, one, got[part], refs)
    del got
    torch.cuda.empty_cache()
    mine = {"rank": rank, "device": str(mesh.local_device()), "seconds": seconds,
            "traffic": traffic, "launches": launches, "digests": digests,
            "jax": "jax" in sys.modules}
    ranks = [None] * world
    dist.all_gather_object(ranks, mine)
    if rank == 0:
        same = all(r["digests"] == ranks[0]["digests"] for r in ranks)
        checks["ranks"] = {"identical": same, "no jax": not any(r["jax"] for r in ranks)}
        for r in ranks:
            print(f"[dist] rank {r['rank']} on {r['device']} ({args.backend}, {world} ranks): "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in r["seconds"].items()))
            print(f"[dist] rank {r['rank']} collectives: " + ", ".join(
                f"{k} {v['calls']} calls {v['bytes']} B" for k, v in r["traffic"].items()))
            print(f"[dist] rank {r['rank']} launches {r['launches']}")
        print(f"[dist] checks {json.dumps(checks)}")
        total = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
        bad = _failed(checks)
        print("[dist-json] " + json.dumps({
            "backend": args.backend, "world": world, "parts": args.parts, "n": n,
            "launches": total, "ranks": [{k: r[k] for k in ("rank", "device", "seconds",
                                                            "traffic", "launches")}
                                         for r in ranks],
            "checks": checks, "failed": bad}), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 1 if rank == 0 and _failed(checks) else 0


if __name__ == "__main__":
    sys.exit(main())
