"""Mesh-distributed full-Gram ML-II step (counterpart of
``snngp/parallel/mlii.py``).

One exact gradient of the marginal NLL over the mesh:

- the augmented Gram (K, dK/dw_std, dK/db_std) as row panels, shard d
  running the augmented kernel for its rows against the whole batch
  (:func:`sharded_aug_gram`; on the card K7's tangent mode,
  :func:`snngp_torch.ops.myrtle_gram.myrtle_gram_scale_grads`);
- the block-cyclic factorization of S = K + eps I
  (:func:`~snngp_torch.parallel.cholesky.cyclic_cholesky`);
- alpha = S^{-1} y, q and logdet S by the panel solves
  (:func:`~snngp_torch.parallel.cholesky.blocked_triangular_solve`);
- each shard solves the S^{-1} columns of its rows (S^{-1} is symmetric, so
  they are its rows too) and contracts them against its own dK row panels;
  the six scalars are summed over the shards.

The contractions accumulate in float64, the inner sums too (as the port's
single-device :func:`~snngp_torch.models.mlii.full_gram_mlii_value_and_grad`
does; JAX's multiply alpha in float32), and the scalars become the loss and
gradients by the same closed form. Each shard holds the whole factor, as in
the JAX package. On a mesh across ranks each rank runs its own shards, the
factorization broadcasts each strip from its owner's rank, and the six sums
are one all-reduce.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from snngp_torch.models.mlii import closed_form_value_and_grad
from snngp_torch.parallel.cholesky import (_axis_devices, blocked_triangular_solve,
                                           cyclic_cholesky)
from snngp_torch.parallel.mesh import Mesh, Shards, broadcast, gather, reduce_sum

__all__ = ["sharded_aug_gram", "distributed_mlii_scalars", "distributed_mlii_value_and_grad"]


def sharded_aug_gram(aug_fn: Callable, x: torch.Tensor, mesh: Mesh, axis_name: str = "data"):
    """(K, dK/dw_std, dK/db_std) as row panels: three lists with one
    [N / P, N] tensor per shard, on its device; shard d runs ``aug_fn`` on
    its rows of ``x`` against the whole of ``x`` (on a mesh across ranks,
    this rank's shards; None for another rank's). ``x.shape[0]`` must divide
    the mesh axis (pad upstream)."""
    devs = _axis_devices(mesh, axis_name)
    if x.shape[0] % len(devs):
        raise ValueError(f"{x.shape[0]} rows do not divide over {len(devs)} shards")
    panels = [aug_fn(xb.to(dev), x.to(dev)) if mesh.is_local(d) else (None,) * 3
              for d, (xb, dev) in enumerate(zip(x.chunk(len(devs)), devs))]
    return tuple(Shards(p, mesh) for p in zip(*panels))


def _shard_scalars(d, l_fac, alpha, dkw_r, dkb_r):
    """Shard d's six float64 sums: <S^{-1}, dK/dw>, <S^{-1}, dK/db> and
    tr S^{-1} over its rows, alpha^T dK/dw alpha and alpha^T dK/db alpha
    over its rows, and |alpha|^2 over its rows."""
    ln, n = dkw_r.shape
    rows = d * ln + torch.arange(ln, device=l_fac.device)
    e = torch.zeros((n, ln), dtype=l_fac.dtype, device=l_fac.device)
    e[rows, torch.arange(ln, device=l_fac.device)] = 1.0
    sinv_cols = torch.linalg.solve_triangular(
        l_fac.mT, torch.linalg.solve_triangular(l_fac, e, upper=False), upper=True)
    sinv_rows = sinv_cols.mT.double()                               # [ln, n]
    a64 = alpha.double()
    a_rows = a64[rows]
    return torch.stack([
        torch.sum(sinv_rows * dkw_r.double()), torch.sum(sinv_rows * dkb_r.double()),
        torch.sum(sinv_cols[rows, torch.arange(ln, device=l_fac.device)].double()),
        a_rows @ (dkw_r.double() @ a64), a_rows @ (dkb_r.double() @ a64),
        torch.sum(a_rows * a_rows)])


def distributed_mlii_scalars(aug_fn: Callable, x: torch.Tensor, y, mesh: Mesh, *, eps,
                             axis_name: str = "data", chol_block: int = 128):
    """The closed form's inputs over ``mesh``: (q, logdet S, the six float64
    sums of :func:`_shard_scalars` summed over the shards). Every rank
    gathers S and factors it with the others
    (:func:`~snngp_torch.parallel.cholesky.cyclic_cholesky`), so each holds
    the whole factor and alpha; each rank contracts its own shards' rows,
    and one all-reduce sums the six scalars (JAX's ``psum``)."""
    devs = _axis_devices(mesh, axis_name)
    n, p = x.shape[0], len(devs)
    if n % p:
        raise ValueError(f"n={n} must divide the mesh axis ({p})")
    root = mesh.local_device()
    with torch.no_grad():
        k, dkw, dkb = sharded_aug_gram(aug_fn, x, mesh, axis_name)
        s = gather(k, root)
        y = torch.as_tensor(y, dtype=s.dtype).reshape(-1).to(root)
        del k
        s.diagonal().add_(float(eps))
        l_fac = cyclic_cholesky(s, mesh, block=min(chol_block, n // p), axis_name=axis_name)
        del s
        u = l_fac.mT                          # the panel solves take U^T U
        z = blocked_triangular_solve(u, y, trans=True)
        alpha = blocked_triangular_solve(u, z, trans=False)
        q = float(torch.dot(z, z))
        logdet_s = float(2.0 * torch.sum(torch.log(torch.diagonal(l_fac))))
        local = list(dict.fromkeys(d for i, d in enumerate(devs) if mesh.is_local(i)))
        on = dict(zip(local, zip(broadcast(l_fac, local), broadcast(alpha, local))))
        parts = Shards([_shard_scalars(d, *on[dev], w, b) if mesh.is_local(d) else None
                        for d, (dev, w, b) in enumerate(zip(devs, dkw, dkb))], mesh)
        sums = reduce_sum(parts, root).tolist()
    return q, logdet_s, sums


def distributed_mlii_value_and_grad(
        aug_fn: Callable, x: torch.Tensor, y, mesh: Mesh, *, last_w_std, eps,
        ab: Optional[Tuple] = None, axis_name: str = "data", chol_block: int = 128
        ) -> Tuple[float, Dict[str, float]]:
    """One exact full-Gram ML-II gradient over ``mesh``: ``(loss, grads)``
    with the contract of
    :func:`~snngp_torch.models.mlii.full_gram_mlii_value_and_grad`, the
    per-datapoint marginal NLL and constrained-space gradients over
    ``{w_std, b_std, last_w_std, eps[, a, b]}`` (``ab=(a, b)`` selects the
    Student-t marginal), as Python floats, in the dtype of ``aug_fn``'s
    tiles; on a mesh across ranks, the same on every rank."""
    q, logdet_s, sums = distributed_mlii_scalars(aug_fn, x, y, mesh, eps=eps,
                                                 axis_name=axis_name, chol_block=chol_block)
    return closed_form_value_and_grad(q, logdet_s, x.shape[0], *sums, last_w_std=last_w_std,
                                      eps=eps, ab=ab)
