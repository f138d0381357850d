"""Device mesh over one process or over the ranks of a process group
(counterpart of ``snngp/parallel/mesh.py``).

A :class:`Mesh` is a grid of shards, each a (rank, ``torch.device``) pair.
Without :func:`init_distributed` every shard is on rank 0, this process: a
grid of the devices it sees, as JAX's single-controller mesh. After
:func:`init_distributed` has joined a ``torch.distributed`` process group,
``get_mesh`` spans every rank's devices in rank order, as
``jax.devices()`` spans the processes after ``jax.distributed.initialize``.

A sharded array is a list with one entry per shard, in the mesh's
row-major order (a list of rows of tiles on a 2-D mesh): the tensor where
the shard is this process's, None where it is another rank's. What JAX
writes as a ``psum``, a broadcast or an all-gather is :func:`reduce_sum`,
:func:`broadcast` or :func:`gather`: between the shards of one rank
``.to(device)`` copies and a plain sum (the tensor itself where a device
repeats); across ranks ``dist.all_reduce``, ``dist.broadcast`` and an
all-gather into one tensor. On a gloo group a CUDA tensor crosses ranks
through a host copy (gloo has no all-gather of CUDA tensors), in every
collective. :data:`TRAFFIC` counts each collective's calls and bytes.

Autograd across ranks uses the conjugate pair of tensor-parallel training:
:func:`to_shards` is the identity on the inputs of the sharded region whose
backward sums their gradients over the ranks, and :func:`gather`'s backward
returns each rank the rows of the cotangent of its own shards. Every rank
then computes the loss from the gathered array, so every rank must compute
the same loss, bit for bit, from the same inputs.

Divergences from the JAX package:

- ``get_mesh(n)`` on CUDA raises when fewer than n cards exist (JAX returns
  a smaller mesh); on the CPU it gives n shards of the one CPU device, as
  the JAX tests' forced host device count does;
- ``get_mesh(devices=[...])`` takes an explicit device list, repeats
  allowed, and is a mesh of this process alone, also after a join: four
  shards on ``cuda:0`` run every line of the mesh code on one card (one
  after another, so their times are not a multi-card time);
- after a join a rank holds one device (``cuda:LOCAL_RANK`` by default),
  and ``get_mesh`` puts ``n / ranks`` shards on it;
- ``init_distributed`` also reads the environment that ``torchrun`` sets,
  and takes the backend as ``backend=`` (NCCL on CUDA, gloo on the CPU).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "device_count", "init_distributed", "get_mesh", "broadcast",
           "reduce_sum", "gather", "to_shards", "gather_rows_to", "TRAFFIC"]

# The collectives across ranks this process took part in: calls and bytes
# (the payload of a broadcast or an all-reduce, an all-gather's whole
# output, the rows received or sent by gather_rows_to).
TRAFFIC: Dict[str, Dict[str, int]] = {
    name: {"calls": 0, "bytes": 0} for name in ("broadcast", "all_reduce", "all_gather",
                                                 "rows")}
_COORDINATOR_ENV = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                    "MEGASCALE_COORDINATOR_ADDRESS")


def _dist():
    import torch.distributed as dist
    return dist


def _joined() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


class Mesh:
    """A grid of shards with named axes (``jax.sharding.Mesh``'s ``devices``,
    ``axis_names``, ``shape`` and ``size``): ``devices`` the shards'
    ``torch.device``s (repeats allowed), ``ranks`` their ranks, ``group``
    the process group across which the mesh spans (None: this process
    alone)."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...],
                 ranks: Optional[np.ndarray] = None, group=None):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.ranks = np.zeros(devices.shape, dtype=int) if ranks is None else ranks
        self.group = group
        flat = self.ranks.reshape(-1)
        if np.any(np.diff(flat) < 0):
            raise ValueError("a mesh's shards must be in rank order")
        self.rank = _dist().get_rank(group) if group is not None else 0
        self.world = int(flat.max()) + 1
        self.backend = _dist().get_backend(group) if group is not None else None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def distributed(self) -> bool:
        """Whether the mesh spans a process group (collectives run, even on
        a group of one rank)."""
        return self.group is not None

    def device_list(self) -> List[torch.device]:
        """The shards' devices in row-major order."""
        return list(self.devices.reshape(-1))

    def is_local(self, shard: int) -> bool:
        """Whether shard ``shard`` (row-major index) is this process's."""
        return int(self.ranks.reshape(-1)[shard]) == self.rank

    def rank_of(self, shard: int) -> int:
        return int(self.ranks.reshape(-1)[shard])

    def local_device(self) -> torch.device:
        """This process's first shard's device."""
        return next(d for i, d in enumerate(self.device_list()) if self.is_local(i))

    def __repr__(self):
        where = "" if self.group is None else f", ranks {self.ranks.reshape(-1).tolist()}"
        return f"Mesh({self.shape}, {[str(d) for d in self.device_list()]}{where})"


class Shards(list):
    """A sharded array: a list of shards that knows its mesh."""

    def __init__(self, items, mesh: Mesh):
        super().__init__(items)
        self.mesh = mesh


def device_count(device_type: str = "cuda") -> int:
    """The devices a mesh may span: after a join one a rank, the world size
    (``jax.device_count()``'s global count); else the CUDA cards this process
    sees, or 1 for the CPU."""
    if _joined():
        return _dist().get_world_size()
    if device_type == "cpu":
        return 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _rank_device(device, rank: Optional[int] = None) -> torch.device:
    """This rank's device: ``device`` with its index, ``cuda`` being
    ``cuda:LOCAL_RANK`` (torchrun's; else the rank modulo the cards)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        rank = _dist().get_rank() if rank is None else rank
        local = rank % max(torch.cuda.device_count(), 1)
    return torch.device("cuda", int(local))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, **kwargs) -> bool:
    """Join a ``torch.distributed`` process group (the JAX package's
    ``jax.distributed.initialize``). Call it once in every process before
    building meshes; afterwards ``device_count()`` and ``get_mesh`` span the
    ranks.

    The coordinator is ``coordinator_address`` (``host:port``, or an
    ``init_method`` URL such as ``file:///path``), else the first of the
    environment names JAX reads (``JAX_COORDINATOR_ADDRESS``,
    ``COORDINATOR_ADDRESS``, ``MEGASCALE_COORDINATOR_ADDRESS``), else
    torchrun's ``MASTER_ADDR:MASTER_PORT``. The world size and this rank
    are ``num_processes`` / ``process_id``, else ``WORLD_SIZE`` / ``RANK``.
    ``backend=`` (default: NCCL where CUDA is available, else gloo) and
    ``device=`` (this rank's device, for NCCL's current device; default
    ``cuda:LOCAL_RANK``) are taken from ``kwargs``; the rest go to
    ``torch.distributed.init_process_group``.

    Returns True once joined (at once if already joined), False with no
    coordinator configured: the single-process runtime, as JAX's."""
    if _joined():
        return True
    env = os.environ
    addr = coordinator_address or next((env[k] for k in _COORDINATOR_ENV if env.get(k)), None)
    if addr is None and env.get("MASTER_ADDR") and env.get("WORLD_SIZE") and env.get("RANK"):
        addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if addr is None and num_processes is None:
        return False
    if addr is None:
        raise ValueError("num_processes without a coordinator address")
    try:
        world = int(num_processes if num_processes is not None else env["WORLD_SIZE"])
        rank = int(process_id if process_id is not None else env["RANK"])
    except KeyError as e:
        raise ValueError(f"a coordinator without {e.args[0]}: pass num_processes and "
                         "process_id") from None
    backend = kwargs.pop("backend", None) or ("nccl" if torch.cuda.is_available() else "gloo")
    device = kwargs.pop("device", "cuda")
    if backend == "nccl":
        torch.cuda.set_device(_rank_device(device, rank))
    _dist().init_process_group(backend, init_method=addr if "://" in addr else f"tcp://{addr}",
                               world_size=world, rank=rank, **kwargs)
    return True


def _devices_of(n: Optional[int], device) -> List[torch.device]:
    device = torch.device(device)
    if device.type == "cpu":
        return [device] * (1 if n is None else n)
    if device.type != "cuda":
        raise ValueError(f"no mesh over {device.type} devices")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    first = device.index or 0
    want = have - first if n is None else n
    if want < 1 or first + want > have:
        raise ValueError(f"a mesh of {want} CUDA devices from cuda:{first} needs "
                         f"{first + want} cards; this machine has {have}")
    return [torch.device("cuda", first + i) for i in range(want)]


def _rank_grid(size: Optional[int], device):
    """(devices, ranks) of a mesh across the joined ranks: size / world
    shards on each rank's device, in rank order."""
    dist = _dist()
    world = dist.get_world_size()
    size = world if size is None else size
    if size % world:
        raise ValueError(f"a mesh of {size} shards over {world} ranks")
    mine = _rank_device(device)
    if mine.type == "cuda" and mine.index >= torch.cuda.device_count():
        raise ValueError(f"rank {dist.get_rank()} has no {mine}")
    names = [None] * world
    dist.all_gather_object(names, str(mine))
    per = size // world
    return ([torch.device(names[r]) for r in range(world) for _ in range(per)],
            [r for r in range(world) for _ in range(per)])


def get_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
             shape: Optional[Sequence[int]] = None,
             axis_names: Tuple[str, ...] = ("rows", "cols"), *,
             devices: Optional[Sequence] = None, device="cuda") -> Mesh:
    """Device mesh: 1-D ``(axis_name,)`` by default, or N-D via ``shape``
    (``get_mesh(shape=(2, 2))`` is a ``("rows", "cols")`` mesh).

    The shards' devices are ``devices`` when given (repeats allowed; a mesh
    of this process alone). Else, after :func:`init_distributed`, the mesh
    spans every rank, ``n_devices`` (or ``prod(shape)``, default one a rank)
    shards in rank order, each rank's on its own ``device`` (``cuda`` is
    ``cuda:LOCAL_RANK``). Else the first ``n_devices`` CUDA cards from
    ``device``'s index, or that many shards of the CPU for ``device="cpu"``;
    too few cards is an error."""
    size = int(np.prod(shape)) if shape is not None else n_devices
    ranks, group = None, None
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if size is not None and size != len(devs):
            raise ValueError(f"a mesh of {size} shards over {len(devs)} devices")
    elif _joined():
        devs, rank_list = _rank_grid(size, device)
        group = _dist().group.WORLD
        ranks = np.asarray(rank_list)
    else:
        devs = _devices_of(size, device)
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    if shape is None:
        return Mesh(grid, (axis_name,), ranks, group)
    names = tuple(axis_names[:len(shape)])
    if len(names) != len(shape):
        raise ValueError("axis_names must cover every mesh dim")
    shape = tuple(shape)
    return Mesh(grid.reshape(shape), names, None if ranks is None else ranks.reshape(shape),
                group)


# -- collectives across ranks ------------------------------------------------------------

def _count(name: str, t: torch.Tensor):
    TRAFFIC[name]["calls"] += 1
    TRAFFIC[name]["bytes"] += t.numel() * t.element_size()


def _staged(t: torch.Tensor, mesh: Mesh, copy: bool = False) -> torch.Tensor:
    """The buffer a collective on ``mesh`` takes: a host copy of a CUDA
    tensor on a gloo group, else ``t`` (a copy of it with ``copy``, for a
    collective that writes its input)."""
    if mesh.backend == "gloo" and t.is_cuda:
        return t.detach().contiguous().cpu()
    t = t.detach().contiguous()
    return t.clone() if copy else t


def _all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    buf = _staged(t, mesh, copy=True)
    _dist().all_reduce(buf, group=mesh.group)
    _count("all_reduce", buf)
    return buf.to(t.device)


def _broadcast(t: torch.Tensor, mesh: Mesh, src: int) -> torch.Tensor:
    """``t`` of rank ``src`` on every rank; the other ranks pass a buffer of
    its shape and dtype."""
    buf = _staged(t, mesh)
    _dist().broadcast(buf, src=src, group=mesh.group)
    _count("broadcast", buf)
    return t if mesh.rank == src else buf.to(t.device)


def _all_gather(part: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``part`` (one shape on every rank), concatenated along
    dim 0 in rank order."""
    dist = _dist()
    src = _staged(part, mesh)
    out = torch.empty((mesh.world * part.shape[0],) + tuple(part.shape[1:]),
                      dtype=part.dtype, device=src.device)
    gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather_into(out, src, group=mesh.group)
    _count("all_gather", out)
    return out.to(part.device)


class _RankGather(torch.autograd.Function):
    """The all-gather of the shards' parts; its backward returns this rank
    the cotangent's rows of its own part (every rank holds the same loss)."""

    @staticmethod
    def forward(ctx, part, mesh):
        ctx.rows = (mesh.rank * part.shape[0], (mesh.rank + 1) * part.shape[0])
        return _all_gather(part, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rows[0]:ctx.rows[1]], None


class _ShardInputs(torch.autograd.Function):
    """The identity on the sharded region's inputs; its backward sums their
    gradients over the ranks, in one all-reduce."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        have = [g for g in grads if g is not None]
        if not have:
            return (None,) + grads
        flat = torch.cat([g.reshape(-1).to(have[0].dtype) for g in have])
        total = _all_reduce(flat, ctx.mesh)
        out, at = [], 0
        for g in grads:
            if g is None:
                out.append(None)
            else:
                out.append(total[at:at + g.numel()].view_as(g).to(g.dtype))
                at += g.numel()
        return (None, *out)


def to_shards(mesh: Mesh, *xs: torch.Tensor):
    """``xs`` as the inputs of ``mesh``'s sharded region (the kernel's
    hyperparameters, the inducing inputs): the tensors themselves on a mesh
    of one process; across ranks an identity whose backward all-reduces
    their gradients, so that each gets every rank's shards' share once."""
    if not mesh.distributed:
        return xs
    return _ShardInputs.apply(mesh, *xs)


def broadcast(t: torch.Tensor, devices: Sequence[torch.device], *, mesh: Optional[Mesh] = None,
              src: int = 0) -> List[torch.Tensor]:
    """``t`` on every device of the list, one entry each. On ``t``'s own
    device the entry is ``t`` itself: no copy. On a mesh across ranks, first
    ``t`` of rank ``src`` reaches every rank (the others pass a buffer of
    its shape and dtype), and ``devices`` are this rank's."""
    if mesh is not None and mesh.distributed:
        t = _broadcast(t, mesh, src)
    return [t.to(d) for d in devices]


def reduce_sum(tensors: Sequence[Optional[torch.Tensor]], device) -> torch.Tensor:
    """The sum of the shards' tensors, on ``device`` (a ``psum``): this
    rank's entries (None for another rank's), then, when the list is a
    sharded array of a mesh across ranks, an all-reduce."""
    local = [t for t in tensors if t is not None]
    out = local[0].to(device)
    for t in local[1:]:
        out = out + t.to(device)
    mesh = getattr(tensors, "mesh", None)
    if mesh is not None and mesh.distributed:
        out = _all_reduce(out, mesh)
    return out


def gather(shards, device=None) -> torch.Tensor:
    """One tensor from row panels (a list of tensors) or from a 2-D mesh's
    tiles (a list of rows of tiles), on ``device`` (default: the first
    local shard's). For a sharded array of a mesh across ranks the ranks'
    shards, all of one shape, are all-gathered: every rank gets the whole
    tensor, and the backward gives each rank the cotangent of its own
    shards."""
    tiled = isinstance(shards[0], (list, tuple))
    mesh = getattr(shards, "mesh", None)
    if mesh is None or not mesh.distributed:
        if tiled:
            device = shards[0][0].device if device is None else device
            rows = [torch.cat([t.to(device) for t in row], dim=1) for row in shards]
            return torch.cat(rows)
        device = shards[0].device if device is None else device
        return torch.cat([t.to(device) for t in shards])
    flat = [t for row in shards for t in row] if tiled else list(shards)
    local = [t for t in flat if t is not None]
    device = local[0].device if device is None else torch.device(device)
    part = torch.stack([t.to(device) for t in local]) if len(local) > 1 else \
        local[0].to(device).unsqueeze(0)
    full = _RankGather.apply(part, mesh)                    # [shards, *shard shape]
    if not tiled:
        return full.flatten(0, 1)
    cols = len(shards[0])
    tiles = full.unbind(0)
    return torch.cat([torch.cat(tiles[i:i + cols], dim=1) for i in range(0, len(tiles), cols)])


def gather_rows_to(t: Optional[torch.Tensor], mesh: Mesh, dst: int, rows: Sequence[int],
                   like: torch.Tensor) -> Optional[torch.Tensor]:
    """Each rank's block of rows (``t``: ``rows[rank]`` rows shaped like
    ``like`` past dim 0; None for none) concatenated in rank order on rank
    ``dst``, on ``like``'s device, by point-to-point sends; None on the
    other ranks. On a mesh of one process: ``t``."""
    if not mesh.distributed:
        return t
    dist = _dist()
    if mesh.rank != dst:
        if rows[mesh.rank]:
            buf = _staged(t, mesh)
            dist.send(buf, dst=dst, group=mesh.group)
            _count("rows", buf)
        return None
    parts = []
    for r, n in enumerate(rows):
        if not n:
            continue
        if r == dst:
            parts.append(t.to(like.device))
            continue
        buf = torch.empty((n,) + tuple(like.shape[1:]), dtype=like.dtype,
                          device="cpu" if mesh.backend == "gloo" else like.device)
        dist.recv(buf, src=r, group=mesh.group)
        _count("rows", buf)
        parts.append(buf.to(like.device))
    return torch.cat(parts)
