"""Sharded N x N Gram construction (counterpart of ``snngp/parallel/gram.py``).

Each shard evaluates the kernel for its block of rows on its own device, so
the O(N^2 depth) recursion is split over the mesh with no traffic between
shards until the solve stage. On the card each block is one launch of the
fused Gram (K1 for the MLP / dense-ResNet kernels, K3 for the CNN, K7 for
Myrtle). On a mesh across ranks each rank runs its own shards.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from snngp_torch.parallel.mesh import Mesh, Shards

__all__ = ["sharded_gram"]


def _blocks(x: torch.Tensor, parts: int, what: str) -> List[torch.Tensor]:
    if x.shape[0] % parts:
        raise ValueError(f"{what} has {x.shape[0]} rows, not divisible by the mesh axis "
                         f"({parts}); pad upstream")
    return list(x.chunk(parts))


def sharded_gram(kernel_fn, x: torch.Tensor, mesh: Mesh, axis_name: str = "data",
                 x2: Optional[torch.Tensor] = None, check_vma: bool = True):
    """Mesh-sharded Gram K[i, j] = kernel_fn(x_i, x2_j), as shards.

    1-D mesh: the row panels, a list with one [N / P, N2] tensor per shard
    on its device: shard d evaluates its rows of ``x`` against the whole of
    ``x2`` (one kernel launch a shard).

    2-D mesh (``get_mesh(shape=(r, c))``): the tiles, a list of r rows of c
    tiles: shard (i, j) evaluates row block i of ``x`` against column block
    j of ``x2``. Without ``x2`` a tile whose row and column blocks are the
    same rows gets one block object as both operands, which the fused Grams
    take as their symmetric launch.

    Each rank evaluates its own shards only; another rank's entry is None
    (``x`` and ``x2`` are whole on every rank).
    :func:`~snngp_torch.parallel.mesh.gather` assembles either layout into
    one tensor, on every rank. The leading dims must divide the mesh axes
    (pad upstream). ``check_vma`` is accepted for the JAX package's
    signature (a shard_map check there) and does nothing here."""
    del check_vma
    same = x2 is None
    x2 = x if same else x2
    if len(mesh.axis_names) >= 2:
        rows, cols = mesh.devices.shape[:2]
        xr, xc = _blocks(x, rows, "x"), _blocks(x2, cols, "x2")
        tiles = []
        for i in range(rows):
            row = []
            for j in range(cols):
                if not mesh.is_local(i * cols + j):
                    row.append(None)
                    continue
                dev = mesh.devices[i, j]
                a = xr[i].to(dev)
                diag = same and rows == cols and i == j
                row.append(kernel_fn(a, a if diag else xc[j].to(dev), get="nngp"))
            tiles.append(row)
        return Shards(tiles, mesh)
    if mesh.axis_names[0] != axis_name:
        raise ValueError(f"no mesh axis {axis_name!r} in {mesh.axis_names}")
    devs = mesh.device_list()
    return Shards([kernel_fn(xb.to(dev), x2.to(dev), get="nngp") if mesh.is_local(d) else None
                   for d, (xb, dev) in enumerate(zip(_blocks(x, len(devs), "x"), devs))], mesh)
