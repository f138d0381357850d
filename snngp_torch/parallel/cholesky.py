"""Blocked, in-place and distributed Cholesky factorizations (counterpart of
``snngp/parallel/cholesky.py``).

- :func:`blocked_cholesky`: the right-looking panel algorithm in torch ops,
  differentiable by autograd (``SPR.loss`` on a mesh differentiates
  through it). Each block column is kept from its diagonal block down, so
  the trailing updates touch the lower triangle only.
- :func:`inplace_blocked_cholesky`: the memory-lean factorization. It
  factors inside the caller's buffer and returns the UPPER factor U (A =
  U^T U) with its strict lower triangle zeroed, the JAX package's layout.
  On a row-major buffer U is the lower factor of its transpose view, which
  is column-major, so cuSOLVER's ``potrf`` (LAPACK's on the CPU) writes it
  in place: ``torch.linalg.cholesky_ex(a.mT, out=(a.mT, info))``. The JAX
  package's fori-loop exists only because XLA could not otherwise alias
  the buffer.
- :func:`blocked_triangular_solve`: the panel solve against such a factor,
  O(N block) working memory (no copy of the factor).
- :func:`cyclic_cholesky`: block columns dealt round-robin over the mesh's
  shards, one panel broadcast a step (across ranks, from the owner's
  rank), with one-step lookahead.
- :func:`distributed_cholesky`: ``strategy="pjit"`` splits every trailing
  update by rows over the shards (the layout GSPMD gives the JAX package's
  row-sharded blocked kernel, one panel gather and one broadcast a step),
  ``"cyclic"`` is :func:`cyclic_cholesky`.

The diagonal blocks go through :func:`snngp_torch.ops.linalg.cholesky`, so
they are symmetrized as ``jnp.linalg.cholesky`` symmetrizes, and a block
that is not PD puts NaN on its diagonal, which every later block inherits.

Divergences from the JAX package: sizes that are not a multiple of the
block get a ragged last block instead of an identity pad; the factor of a
mesh factorization is returned whole on the input's device, on every rank
of a mesh across ranks (JAX: a global array sharded by columns); ``inplace_blocked_cholesky`` reads the upper
triangle of its input (the row panels JAX's reads), and ``block`` does not
change its result (cuSOLVER and LAPACK block internally).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from snngp_torch.ops.linalg import _nan_where_failed, cholesky
from snngp_torch.parallel.mesh import Mesh, broadcast, gather_rows_to

__all__ = ["blocked_cholesky", "inplace_blocked_cholesky",
           "blocked_triangular_solve", "cyclic_cholesky",
           "distributed_cholesky"]


def _dividing_block(n: int, target: int = 1024, floor: int = 128):
    """Largest block <= target that divides n, or None if all are < floor
    (CIFAR-10's 50,000 takes 1,000): equal panels at north-star sizes."""
    for b in range(min(target, n), floor - 1, -1):
        if n % b == 0:
            return b
    return None


def _auto_block(n: int) -> int:
    """The JAX package's default panel: 512, grown (in multiples of 256) so
    that there are at most 24 panels."""
    block = 512
    if n // block > 24:
        per_panel = -(-n // 24)
        block = -(-per_panel // 256) * 256
    return block


def _starts(n: int, block: int) -> List[int]:
    if block < 1:
        raise ValueError(f"block {block} < 1")
    return list(range(0, n, min(block, n)))


def _factor_column(col: torch.Tensor, panel_inverse: bool = False) -> torch.Tensor:
    """The strip [L_kk; L_below] of a block column given from its diagonal
    block down: L_kk = chol(A_kk), L_below L_kk^T = A_below."""
    w = col.shape[1]
    lkk = cholesky(col[:w])
    if col.shape[0] == w:
        return lkk
    if panel_inverse:
        # trtri + gemm: the tall operand is a plain matmul
        eye = torch.eye(w, dtype=col.dtype, device=col.device)
        below = col[w:] @ torch.linalg.solve_triangular(lkk.mT, eye, upper=True, left=False)
    else:
        below = torch.linalg.solve_triangular(lkk.mT, col[w:], upper=True, left=False)
    return torch.cat([lkk, below])


def _update(piece: torch.Tensor, strip: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """A rank-w update of a piece of a later block column, out of place:
    ``piece`` holds global rows from ``rows`` of the block column starting
    at global column ``cols``; row / column offsets are relative to the
    strip's first row."""
    w = piece.shape[1]
    return piece - strip[rows:rows + piece.shape[0]] @ strip[cols:cols + w].mT


def _assemble_lower(strips, starts, n, like: torch.Tensor) -> torch.Tensor:
    """The [n, n] lower factor from its strips, on ``like``'s device."""
    out = torch.zeros((n, n), dtype=like.dtype, device=like.device)
    for s, strip in zip(starts, strips):
        out[s:, s:s + strip.shape[1]] = strip.to(like.device)
    return out


def blocked_cholesky(a: torch.Tensor, block: Optional[int] = None,
                     panel_inverse: bool = False) -> torch.Tensor:
    """Lower Cholesky factor of PSD ``a`` by right-looking block panels.

    Each step factors the diagonal block, solves the panel below it
    (L21 L11^T = A21, a [rest, b] triangular solve, or with
    ``panel_inverse=True`` one [b, b] inverse and a matmul: the MAGMA-style
    trtri + gemm panel) and subtracts its rank-b update from the later block
    columns, each from its own diagonal block down: ~n^3/6 multiplies, as
    LAPACK's potrf. Every step is out of place, so autograd differentiates
    it. ``block=None`` is 512, grown so that there are at most 24 panels."""
    n = a.shape[-1]
    starts = _starts(n, _auto_block(n) if block is None else block)
    cols = [a[s:, s:e] for s, e in zip(starts, starts[1:] + [n])]
    strips = []
    for k, s in enumerate(starts):
        strip = _factor_column(cols[k], panel_inverse)
        cols[k] = None
        for c in range(k + 1, len(starts)):
            off = starts[c] - s
            cols[c] = _update(cols[c], strip, off, off)
        strips.append(strip)
    return _assemble_lower(strips, starts, n, a)


def inplace_blocked_cholesky(a: torch.Tensor, block: Optional[int] = None) -> torch.Tensor:
    """Memory-lean Cholesky: factors ``a`` inside its own buffer and returns
    it as the UPPER factor U (A = U^T U), strict lower triangle zeroed:
    ``U.mT`` is :func:`~snngp_torch.ops.linalg.cholesky`'s lower factor,
    ``logdet = 2 sum(log(diag(U)))``; solve with
    :func:`blocked_triangular_solve`. Peak memory is the one N^2 buffer plus
    the factorization's workspace. ``a`` must be a contiguous square float
    tensor outside autograd; its contents are consumed (the JAX package
    donates it). Reads the upper triangle. A factorization that fails puts
    NaN on the diagonal. ``block`` is accepted for the JAX package's
    signature: the library blocks internally, so it does not change the
    result."""
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"a square matrix is needed; got {tuple(a.shape)}")
    if not a.is_contiguous():
        raise ValueError("inplace_blocked_cholesky factors a contiguous (row-major) buffer")
    if a.requires_grad:
        raise ValueError("inplace_blocked_cholesky overwrites its input: detach it first")
    if block is not None and block < 1:
        raise ValueError(f"block {block} < 1")
    info = torch.empty((), dtype=torch.int32, device=a.device)
    with torch.no_grad():
        # U^T (a.mT's lower factor) overwrites a.mT, a column-major view:
        # one buffer, written by potrf in place.
        lower, info = torch.linalg.cholesky_ex(a.mT, out=(a.mT, info))
        _nan_where_failed(lower, info)
    return a


def blocked_triangular_solve(u: torch.Tensor, b: torch.Tensor, *, trans: bool = False,
                             block: Optional[int] = None) -> torch.Tensor:
    """Solve ``U^T x = b`` (``trans=True``, forward substitution) or
    ``U x = b`` (``trans=False``, back substitution) for an UPPER factor
    with a zeroed strict lower triangle (:func:`inplace_blocked_cholesky`'s
    result), panel by panel: [block, block] triangular solves and products
    against the solved rows. The working memory is O(n block + n r): the
    factor is read in slices, never copied (``torch.cholesky_solve`` copies
    its factor into a column-major buffer, an N^2 copy). ``b`` is [n] or
    [n, r]. ``block=None``: the largest block <= 1,024 that divides n, else
    1,024 with a ragged last panel. Outside autograd (the solution is
    written panel by panel in place)."""
    n = u.shape[-1]
    squeeze = b.ndim == 1
    rhs = b[:, None] if squeeze else b
    if block is None:
        block = _dividing_block(n) or min(1024, n)
    starts = _starts(n, block)
    ends = starts[1:] + [n]
    x = torch.empty((n, rhs.shape[1]), dtype=u.dtype, device=u.device)
    with torch.no_grad():
        if trans:
            for s, e in zip(starts, ends):
                # rows of U[:s, s:e] above the block meet the solved x[:s];
                # those below it are structurally zero
                r = rhs[s:e] - u[:s, s:e].mT @ x[:s] if s else rhs[s:e]
                x[s:e] = torch.linalg.solve_triangular(u[s:e, s:e].mT, r, upper=False)
        else:
            for s, e in zip(reversed(starts), reversed(ends)):
                r = rhs[s:e] - u[s:e, e:] @ x[e:] if e < n else rhs[s:e]
                x[s:e] = torch.linalg.solve_triangular(u[s:e, s:e], r, upper=True)
    return x[:, 0] if squeeze else x


def _axis_devices(mesh: Mesh, axis_name: str) -> List[torch.device]:
    if mesh.axis_names != (axis_name,):
        raise ValueError(f"a 1-D mesh over {axis_name!r} is needed; have {mesh.axis_names}")
    return mesh.device_list()


def _on_each(strip: Optional[torch.Tensor], devices, mesh: Mesh, owner: int, shape,
             like: torch.Tensor):
    """The step's one broadcast: the strip from shard ``owner``'s rank to
    every rank (another rank receives it into a buffer of ``shape`` on its
    own device), then on each distinct device of ``devices`` (this rank's).
    Returns (the strip on this rank, {device: strip})."""
    if mesh.distributed:
        if strip is None:
            strip = torch.empty(shape, dtype=like.dtype, device=mesh.local_device())
        strip = broadcast(strip, [strip.device], mesh=mesh, src=mesh.rank_of(owner))[0]
    uniq = list(dict.fromkeys(devices))
    return strip, dict(zip(uniq, broadcast(strip, uniq)))


def cyclic_cholesky(a: torch.Tensor, mesh: Mesh, block: int = 512,
                    axis_name: str = "data") -> torch.Tensor:
    """Block-cyclic column-panel Cholesky over the mesh (ScaLAPACK's 1-D
    right-looking factorization).

    Block column k lives on shard k mod P, so the trailing work stays
    balanced as the active submatrix shrinks. Each step: the owner factors
    its diagonal block and solves the panel below it; one broadcast sends
    the panel to the shards (the JAX package's psum; across ranks one
    ``dist.broadcast`` from the owner's rank); with one-step lookahead,
    column k + 1 alone is updated and its panel factored before the bulk
    update of every shard's later columns, so the next broadcast does not
    wait for the bulk products. Out of place throughout, so autograd
    differentiates it (on a mesh of one process). ``a`` is whole on every
    rank; each rank keeps every strip, so each returns the whole lower
    factor on ``a``'s device."""
    devs = _axis_devices(mesh, axis_name)
    p = len(devs)
    n = a.shape[-1]
    starts = _starts(n, block)
    ends = starts[1:] + [n]
    owner = [k % p for k in range(len(starts))]
    mine = [mesh.is_local(d) for d in range(p)]
    cols = [a[s:, s:e].to(devs[owner[k]]) if mine[owner[k]] else None
            for k, (s, e) in enumerate(zip(starts, ends))]
    strips = []
    cand = _factor_column(cols[0]) if mine[owner[0]] else None
    cols[0] = None
    for k, s in enumerate(starts):
        later = [devs[o] for o in owner[k + 1:] if mine[o]]
        cand, on = _on_each(cand, later, mesh, owner[k], (n - s, ends[k] - s), a)
        strips.append(cand)
        if k + 1 == len(starts):
            break
        nxt = k + 1
        off = starts[nxt] - s
        cand = None
        if mine[owner[nxt]]:
            cols[nxt] = _update(cols[nxt], on[devs[owner[nxt]]], off, off)   # lookahead
            cand = _factor_column(cols[nxt])
        cols[nxt] = None
        for d in range(p):                                               # bulk update
            if not mine[d]:
                continue
            for c in range(nxt + 1 + (d - nxt - 1) % p, len(starts), p):
                off = starts[c] - s
                cols[c] = _update(cols[c], on[devs[owner[c]]], off, off)
    return _assemble_lower(strips, starts, n, a)


def _row_panel_cholesky(a: torch.Tensor, mesh: Mesh, block: Optional[int],
                        axis_name: str) -> torch.Tensor:
    """Right-looking blocked Cholesky with every trailing update split by
    rows over the shards: shard d holds rows [r_d, r_{d+1}) of each block
    column's lower part. Each step gathers block column k to the first
    shard (across ranks: each rank sends its rows to the first shard's
    rank), which factors its strip; one broadcast sends the strip to the
    shards, and each updates its own rows of the later columns."""
    devs = _axis_devices(mesh, axis_name)
    n = a.shape[-1]
    starts = _starts(n, _auto_block(n) if block is None else block)
    ends = starts[1:] + [n]
    step = -(-n // len(devs))
    bounds = [(min(d * step, n), min((d + 1) * step, n)) for d in range(len(devs))]
    mine = [mesh.is_local(d) for d in range(len(devs))]
    first = devs[0] if mine[0] else mesh.local_device()
    # pieces[c][d]: global rows [max(r0, s_c), r1) of block column c, on shard d
    pieces = [[a[max(r0, s):r1, s:e].to(dev) if max(r0, s) < r1 and ok else None
               for (r0, r1), dev, ok in zip(bounds, devs, mine)]
              for s, e in zip(starts, ends)]
    local_devs = [dev for dev, ok in zip(devs, mine) if ok]
    strips = []
    for k, (s, e) in enumerate(zip(starts, ends)):
        held = [t.to(first) for t in pieces[k] if t is not None]
        rows = [0] * mesh.world
        for d, (r0, r1) in enumerate(bounds):
            rows[mesh.rank_of(d)] += max(r1 - max(r0, s), 0)
        col = gather_rows_to(torch.cat(held) if held else None, mesh, mesh.rank_of(0), rows,
                             torch.empty((0, e - s), dtype=a.dtype, device=first))
        strip = _factor_column(col) if mine[0] else None
        pieces[k] = None
        strip, on = _on_each(strip, local_devs, mesh, 0, (n - s, e - s), a)
        for c in range(k + 1, len(starts)):
            for d, (r0, _) in enumerate(bounds):
                piece = pieces[c][d]
                if piece is not None:
                    pieces[c][d] = _update(piece, on[devs[d]], max(r0, starts[c]) - s,
                                           starts[c] - s)
        strips.append(strip)
    return _assemble_lower(strips, starts, n, a)


def distributed_cholesky(a: torch.Tensor, mesh: Optional[Mesh] = None,
                         block: Optional[int] = None, axis_name: str = "data",
                         strategy: str = "pjit") -> torch.Tensor:
    """Distributed blocked Cholesky over a mesh: ``strategy="pjit"`` splits
    every trailing update by rows over the shards, ``"cyclic"`` is
    :func:`cyclic_cholesky`. ``mesh=None`` or a mesh of one shard runs
    :func:`blocked_cholesky`."""
    if mesh is None or mesh.size == 1:
        return blocked_cholesky(a, block=block)
    if strategy == "cyclic":
        return cyclic_cholesky(a, mesh, block=block or 512, axis_name=axis_name)
    if strategy != "pjit":
        raise ValueError(f"unknown strategy {strategy!r}")
    return _row_panel_cholesky(a, mesh, block, axis_name)
