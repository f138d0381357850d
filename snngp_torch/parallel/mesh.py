"""Device mesh of one process (counterpart of ``snngp/parallel/mesh.py``).

The JAX mesh is single-controller: one process owns every device of a
``jax.sharding.Mesh`` and XLA inserts the collectives. The port keeps that
model: a :class:`Mesh` is a grid of ``torch.device``s held by one process,
a shard is a tensor on its shard's device, and a sharded array is a list of
shards (:func:`gather` joins them). What JAX writes as a ``psum`` or a
broadcast is :func:`reduce_sum` / :func:`broadcast` across the shards'
devices: ``.to(device)`` copies and a plain sum, which are the tensor itself
where a device repeats.

Divergences from the JAX package:

- ``get_mesh(n)`` on CUDA raises when fewer than n cards exist (JAX returns
  a smaller mesh); on the CPU it gives n shards of the one CPU device, as
  the JAX tests' forced host device count does;
- ``get_mesh(devices=[...])`` takes an explicit device list, repeats
  allowed: four shards on ``cuda:0`` run every line of the mesh code on one
  card (one after another, so their times are not a multi-card time);
- ``init_distributed`` is the single-process no-op; a coordinator (a
  multi-host launch) raises ``NotImplementedError``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "device_count", "init_distributed", "get_mesh", "broadcast",
           "reduce_sum", "gather"]


class Mesh:
    """A grid of ``torch.device``s with named axes (``jax.sharding.Mesh``'s
    ``devices``, ``axis_names``, ``shape`` and ``size``). Devices may repeat."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> List[torch.device]:
        """The shards' devices in row-major order."""
        return list(self.devices.reshape(-1))

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.device_list()]})"


def device_count(device_type: str = "cuda") -> int:
    """The distinct devices of ``device_type`` this process sees: the CUDA
    cards, or 1 for the CPU."""
    if device_type == "cpu":
        return 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, **kwargs) -> bool:
    """The multi-host hook of the JAX package. A single process with no
    coordinator configured is the supported runtime: returns False. A
    coordinator address (argument or environment) raises
    ``NotImplementedError``: the port's mesh lives in one process."""
    have_env = any(os.environ.get(k) for k in
                   ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                    "MEGASCALE_COORDINATOR_ADDRESS"))
    if coordinator_address is None and num_processes is None and not have_env:
        return False
    raise NotImplementedError("multi-host meshes are not ported: the port's mesh is one "
                              "process over the devices it sees")


def _devices_of(n: Optional[int], device) -> List[torch.device]:
    device = torch.device(device)
    if device.type == "cpu":
        return [device] * (1 if n is None else n)
    if device.type != "cuda":
        raise ValueError(f"no mesh over {device.type} devices")
    have = device_count("cuda")
    first = device.index or 0
    want = have - first if n is None else n
    if want < 1 or first + want > have:
        raise ValueError(f"a mesh of {want} CUDA devices from cuda:{first} needs "
                         f"{first + want} cards; this machine has {have}")
    return [torch.device("cuda", first + i) for i in range(want)]


def get_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
             shape: Optional[Sequence[int]] = None,
             axis_names: Tuple[str, ...] = ("rows", "cols"), *,
             devices: Optional[Sequence] = None, device="cuda") -> Mesh:
    """Device mesh: 1-D ``(axis_name,)`` by default, or N-D via ``shape``
    (``get_mesh(shape=(2, 2))`` is a ``("rows", "cols")`` mesh).

    The shards' devices are ``devices`` when given (repeats allowed), else
    the first ``n_devices`` (or ``prod(shape)``) CUDA cards from ``device``'s
    index, or that many shards of the CPU for ``device="cpu"``; too few
    cards is an error."""
    size = int(np.prod(shape)) if shape is not None else n_devices
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if size is not None and size != len(devs):
            raise ValueError(f"a mesh of {size} shards over {len(devs)} devices")
    else:
        devs = _devices_of(size, device)
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    if shape is None:
        return Mesh(grid, (axis_name,))
    names = tuple(axis_names[:len(shape)])
    if len(names) != len(shape):
        raise ValueError("axis_names must cover every mesh dim")
    return Mesh(grid.reshape(tuple(shape)), names)


def broadcast(t: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``t`` on every device of the list, one entry each. On ``t``'s own
    device the entry is ``t`` itself: no copy."""
    return [t.to(d) for d in devices]


def reduce_sum(tensors: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The sum of the shards' tensors, on ``device`` (a ``psum``)."""
    out = tensors[0].to(device)
    for t in tensors[1:]:
        out = out + t.to(device)
    return out


def gather(shards, device=None) -> torch.Tensor:
    """One tensor from row panels (a list of tensors) or from a 2-D mesh's
    tiles (a list of rows of tiles), on ``device`` (default: the first
    shard's)."""
    if isinstance(shards[0], (list, tuple)):
        device = shards[0][0].device if device is None else device
        rows = [torch.cat([t.to(device) for t in row], dim=1) for row in shards]
        return torch.cat(rows)
    device = shards[0].device if device is None else device
    return torch.cat([t.to(device) for t in shards])
