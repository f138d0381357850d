"""Resumable host assembly of large matrices from device tiles, shared by
:func:`snngp_torch.ops.myrtle_gram.myrtle_gram_tiled` (one Gram) and
:func:`snngp_torch.models.mlii.tiled_aug_gram` (K, dK/dw_std, dK/db_std).

The outputs are float32 host arrays, or ``.npy`` memmaps with a per-tile
bitmap (the JAX package's resume layout, so either package resumes the
other's files). Tile t + 1 is launched before tile t is written: tile t's
copies go to pinned host memory behind an event as soon as it is launched,
so the host writes tile t to its arrays while the device runs tile t + 1.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["assemble_tiles"]


def _start_copy(tiles):
    """Enqueue the tiles' copies to the host; returns ``(host, event)``.
    On the card the copies go to pinned memory behind an event that
    completes with them, before any later launch; CPU tiles pass as they
    are (event None)."""
    if tiles[0].device.type == "cpu":
        return [t.numpy() for t in tiles], None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
            for t in tiles]
    event = torch.cuda.Event()
    event.record()
    return host, event


def _open_resumable(paths, done_path, shape, n_tiles, what, label, log):
    """The output memmaps and the tile bitmap: those on disk if all are
    there, else new ones."""
    if all(os.path.exists(p) for p in paths) and os.path.exists(done_path):
        outs = [np.lib.format.open_memmap(p, mode="r+") for p in paths]
        done = np.load(done_path)
        if outs[0].shape != tuple(shape) or done.shape[0] != n_tiles:
            raise ValueError(
                f"{paths[0]} holds a {outs[0].shape} array / {done.shape[0]}-{what} bitmap; "
                f"expected {tuple(shape)} / {n_tiles}: different data or block size")
        if log is not None:
            log(f"{label}: resuming, {int(done.sum())}/{n_tiles} {what}s already done")
        return outs, done
    outs = [np.lib.format.open_memmap(p, mode="w+", dtype=np.float32, shape=tuple(shape))
            for p in paths]
    done = np.zeros(n_tiles, bool)
    np.save(done_path, done)
    return outs, done


def assemble_tiles(todo: Sequence[Tuple[int, int]], launch: Callable, shape, *,
                   count: int = 1, mirror: bool = False,
                   paths: Optional[Sequence[str]] = None, done_path: Optional[str] = None,
                   log=None, label: str = "assemble_tiles", what: str = "tile"
                   ) -> List[np.ndarray]:
    """``count`` host float32 arrays of ``shape`` from device tiles.

    ``launch(i, j)`` returns ``count`` [h, w] tensors, the tiles whose
    top-left corner is (i, j), for each (i, j) of ``todo`` in order.
    ``mirror`` also writes each tile's transpose at (j, i) when j > i (the
    upper triangle of symmetric outputs).

    ``paths`` (one ``.npy`` per output) and ``done_path`` (a bool bitmap
    over ``todo``) make the assembly resumable: memmaps flushed and the
    tile's bit saved after every tile; a re-run with the same files skips
    the tiles already done. ``log`` gets ``"<label>: <what> t/n"`` every 8
    tiles and at the last."""
    if paths is not None and len(paths) != count:
        raise ValueError(f"{len(paths)} paths for {count} outputs")
    if paths is None:
        outs, done = [np.zeros(shape, np.float32) for _ in range(count)], None
    else:
        outs, done = _open_resumable(paths, done_path, shape, len(todo), what, label, log)

    def commit(t, i, j, copy):
        host, event = copy
        if event is not None:
            event.synchronize()
        for out, tile in zip(outs, host):
            piece = np.asarray(tile)                     # a pinned tensor or an array
            h, w = piece.shape
            out[i:i + h, j:j + w] = piece
            if mirror and j > i:
                out[j:j + w, i:i + h] = piece.T
        if done is not None:     # the done bit is set once the tile is on disk
            for out in outs:
                out.flush()
            done[t] = True
            np.save(done_path, done)
        if log is not None and (t % 8 == 0 or t == len(todo) - 1):
            log(f"{label}: {what} {t + 1}/{len(todo)}")

    pending = None
    with torch.no_grad():
        for t, (i, j) in enumerate(todo):
            if done is not None and done[t]:
                continue
            copy = _start_copy(launch(i, j))
            if pending is not None:
                commit(*pending)
            pending = (t, i, j, copy)
        if pending is not None:
            commit(*pending)
    return outs
