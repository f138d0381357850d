"""Fused Myrtle conv-NNGP Gram (K7) and its scale-tangent mode; counterpart
of ``snngp/ops/pallas/myrtle_gram.py``.

The Myrtle-5/7/10 kernel (``nn.full.get_myrtle_kernel``) carries the full
[hw, hw] pixel-pair covariance of each pair of images through conv groups
of (1,1,1) / (2,2,1) / (3,3,2) same-offset 3 x 3 stencils and dual
activations, three exact 2 x 2 average pools, the global average pool and
the dense readout. The full tier materializes that state (4 MB a pair at
32 x 32); the fused Gram runs the whole recursion per pair and writes one
number (and, in the tangent mode, one number per scale tangent).

**The Delta-slab decomposition** (the kernel's and the plain versions'
order). The stencil ``K'[p1, p2] = mean_d K[p1 + d, p2 + d]`` keeps the
offset Delta = p2 - p1, and the moment and the activation are pointwise. So
inside a conv group the state splits into (2r - 1)^2 independent slabs, one
per Delta, each an (r - |Delta_i|) x (r - |Delta_j|) image with its own zero
boundary, on which a conv is a 3 x 3 box mean and the activation reads the
profile of p1 on side a and of p1 + Delta on side b. A 2 x 2 pool sends
every entry of slab Delta to exactly one entry of pooled slab
floor(Delta / 2) or ceil(Delta / 2), per axis. Pools and the GAP are
linear, and pool + GAP is the mean over the last conv group's entries.

The slabs run in a fixed order: rows Delta_i ascending, and within a row
three waves (Delta_j even; = 1 mod 4; = 3 mod 4), whose slabs send their
pooled sums to disjoint targets. Each pooled entry therefore receives its
(up to nine) partial sums in one order, which both versions follow; the
GAP accumulates in float64. Stage 2 (resolution h/2) runs a row of pooled
slabs as soon as the stage-1 rows feeding it are done; stage 3 (h/4) runs
last. See ``csrc/myrtle_gram.cu`` for the kernel's side.

- :func:`myrtle_var_profiles`: the per-sample pre-activation variances of
  every conv layer (the N-linear recursion, plain PyTorch, chunked over
  samples); :func:`myrtle_profile_tangents` adds their (w_std, b_std)
  tangents by forward-mode AD.
- :func:`myrtle_gram_plain`, :func:`myrtle_gram_tangents_plain`: the plain
  versions, on the kernels' own inputs (packed profiles, scales); what a
  CPU tensor runs and the oracle of the kernels.
- :func:`myrtle_gram_cuda` (K7, ``myrtle_gram_kernel``; ``state=bf16``
  its bf16 pair-state variant), :func:`myrtle_gram_tangents_cuda` (its
  scale-tangent mode, ``myrtle_gram_tangents_kernel``): launch the kernels
  on a CUDA tensor, or raise. All run one pair recursion, whose stage 1
  streams the slabs through registers; ``same=True`` runs each pair of
  K(x, x) once. ``LAUNCHES`` counts them ("myrtle", "myrtle_bf16",
  "myrtle_grads").
- :func:`myrtle_gram`: one ``torch.autograd.Function`` with the JAX
  package's ``trainable_inputs`` contract (True: backward by autograd
  through the full tier, x cotangents included; False: zero x cotangents
  and the scale cotangents from the tangent mode), and its ``dtype``: a
  bf16 pair state (forward only) runs K7's bf16 variant on the card and
  the bf16 plain version on the CPU, rounding where the JAX package's bf16
  kernel does (``_PlainRecursion``).
- :func:`myrtle_gram_scale_grads` returns (K, dK/dw_std, dK/db_std);
  :func:`myrtle_gram_tiled` assembles a large Gram block by block into host
  memory, resumable from an ``.npy`` memmap; :func:`myrtle_gram_sharded`
  evaluates it as shards over a device mesh.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from snngp_torch.ops import _build
from snngp_torch.ops.gram import _ACT_T, _ACT_T_PARTIALS, _ACTS
from snngp_torch.ops.tiled import assemble_tiles
from snngp_torch.utils.profiling import span

__all__ = ["MYRTLE_GROUPS", "myrtle_var_profiles", "myrtle_profile_tangents",
           "myrtle_gram_plain", "myrtle_gram_tangents_plain", "myrtle_gram_cuda",
           "myrtle_gram_tangents_cuda", "myrtle_gram", "myrtle_gram_scale_grads",
           "myrtle_gram_tiled", "myrtle_gram_sharded", "pack_profiles", "LAUNCHES"]

MYRTLE_GROUPS = {5: (1, 1, 1), 7: (2, 2, 1), 10: (3, 3, 2)}

# Launches of each CUDA kernel in this process; the wrappers add one per
# launch. "myrtle" is K7, "myrtle_bf16" its bf16 pair-state variant,
# "myrtle_grads" its scale-tangent mode.
LAUNCHES = {"myrtle": 0, "myrtle_bf16": 0, "myrtle_grads": 0}

# A ``dtype`` argument's pair state: None, the input's own dtype (float32
# for the kernels; the plain versions also run float64 witnesses), or
# bfloat16.
_STATES = {None: None, torch.float32: None, "float32": None, torch.bfloat16: torch.bfloat16,
           "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def _state_dtype(dtype):
    """The pair state for a ``dtype`` argument: None (the input's dtype) for
    None, torch.float32 or "float32"; torch.bfloat16 for torch.bfloat16,
    "bf16" or "bfloat16"."""
    try:
        return _STATES[dtype]
    except (KeyError, TypeError):
        raise ValueError(f"dtype {dtype!r}: the fused Myrtle Gram's pair state is float32 "
                         "or bfloat16") from None

_TANGENT_MODES = {"w": 0, "b": 1, "wb": 2}
# The kernels' warps a block (csrc/myrtle_gram.cu kWarps, both modes) and
# the largest image side they take (one slab column a lane).
WARPS = 16
_MAX_H = 32
_MAX_C = 8
# Pooled-state bytes one chunk of the plain versions may hold: the card's
# 80 GB take larger chunks, and so fewer passes of small launches.
_PLAIN_BYTES = {"cpu": 1 << 30, "cuda": 8 << 30}


# -- variance profiles (plain PyTorch: the JAX package computes them in XLA) --------

def myrtle_var_profiles(x: torch.Tensor, groups: Sequence[int], act: str, w_std, b_std,
                        chunk: Optional[int] = None):
    """Pre-activation spatial-diagonal variances for every conv layer of the
    Myrtle stack: the per-sample full-covariance recursion (``nn.full``
    ConvF / ActF / AvgPoolF on [h, w, h, w] states), chunked over samples
    so that the peak is one chunk's state. Returns a list of [N, r, r]
    tensors, one per conv (r = its resolution)."""
    from snngp_torch.nn.full import _conv_pair, _pool_axis_pair
    from snngp_torch.nn.layers import _erf_t, _relu_t
    t_fn = {"relu": _relu_t, "erf": _erf_t}[act]
    w2 = w_std * w_std
    b2 = b_std * b_std
    n, h, _, c = x.shape
    if chunk is None:
        chunk = 128 if h <= 16 else 32

    def run(xc):
        cov = torch.einsum("nabc,ndec->nabde", xc, xc) / c
        outs = []
        for reps in groups:
            for _ in range(reps):
                cov = w2 * _conv_pair(cov, (3, 3), (1, 1)) + b2
                v = torch.einsum("nijij->nij", cov)
                outs.append(v)
                cov = t_fn(cov, v[:, :, :, None, None], v[:, None, None, :, :])
            cov = _pool_axis_pair(_pool_axis_pair(cov, 2, 1), 2, 3)
        return outs

    parts = [run(x[i:i + chunk]) for i in range(0, n, chunk)]
    return [torch.cat(layer) for layer in zip(*parts)]


def _profiles_with_tangents(x, groups, act, w_std, b_std):
    """Variance profiles and their forward-mode tangents in w_std and b_std
    (the JAX package's ``jax.jvp``; ``_relu_t`` carries its analytic JVP,
    finite on the spatial diagonal where c = 1). Returns (profiles,
    tangents) with tangents[l] of shape [N, 2, r, r], axis 1 = (d/dw, d/db)."""
    # Forward-mode AD outside inference mode, where a caller's
    # torch.inference_mode() changed the tangents on the card (torch 2.11).
    with torch.inference_mode(False):
        w = torch.as_tensor(w_std, dtype=x.dtype, device=x.device)
        b = torch.as_tensor(b_std, dtype=x.dtype, device=x.device)
        p, dw = torch.func.jvp(lambda ww: myrtle_var_profiles(x, groups, act, ww, b),
                               (w,), (torch.ones_like(w),))
        _, db = torch.func.jvp(lambda bb: myrtle_var_profiles(x, groups, act, w, bb),
                               (b,), (torch.ones_like(b),))
    return list(p), [torch.stack([a, c], dim=1) for a, c in zip(dw, db)]


def myrtle_profile_tangents(x, *, depth: int = 5, act: str = "relu", w_std=1.0,
                            b_std=0.0):
    """Per-sample variance profiles and their (d/dw_std, d/db_std) tangents
    for one block of samples: ``(profiles, tangents)``, lists of [N, r, r] /
    [N, 2, r, r], one per conv layer. Pass pairs of them to
    :func:`myrtle_gram_scale_grads` (``profiles=``) so that a block met in
    many Gram tiles pays its profile recursion once."""
    with torch.no_grad():
        return _profiles_with_tangents(x, MYRTLE_GROUPS[depth], act, w_std, b_std)


def pack_profiles(profiles):
    """[N, r, r] per layer (or [N, 2, r, r]) -> one contiguous [N, P] (or
    [N, 2, P]) row per sample, the layers in order: the kernels' layout."""
    lead = profiles[0].shape[:-2]
    return torch.cat([p.reshape(*lead, -1) for p in profiles], dim=-1).contiguous()


def _layers(h, groups):
    """(resolution, offset into a packed profile row) of every conv layer."""
    out, off = [], 0
    for stage, reps in enumerate(groups):
        r = h >> stage
        for _ in range(reps):
            out.append((r, off))
            off += r * r
    return out


# -- the slab geometry, shared by the plain versions and the kernel ------------------

def _span(r, d):
    return r - abs(d)


def _lo(d):
    return max(0, -d)


def _cum(r, d):
    """Entries of the slabs d' < d along one axis: sum over d' in
    [-(r - 1), d) of (r - |d'|)."""
    if d <= 0:
        k = r + d - 1
        return k * (k + 1) // 2
    return r * (r + 1) // 2 + (d - 1) * (2 * r - d) // 2


def _waves(r):
    """The offsets d in (-r, r) of one slab row, in the order the kernel
    runs them: even d, then d = 1 mod 4, then d = 3 mod 4."""
    ds = range(-(r - 1), r)
    return ([d for d in ds if d % 2 == 0], [d for d in ds if d % 4 == 1],
            [d for d in ds if d % 4 == 3])


def _targets(d, r):
    """(pooled offset P, e = d - 2P, source parities e1) of the 2 x 2 pool
    on one axis: an even d feeds P = d/2 from both parities, an odd d feeds
    (d - 1)/2 from even p1 and (d + 1)/2 from odd p1; P must lie in
    (-r/2, r/2)."""
    out = []
    for p in sorted({d // 2, -((-d) // 2)}):
        if abs(p) < r // 2:
            e = d - 2 * p
            out.append((p, {0: (0, 1), 1: (0,), -1: (1,)}[e]))
    return out


def _stencil(z):
    """3 x 3 box sum / 9 on the last two axes, zeros off the slab, in the
    kernel's order: column sums (z + left) + right, row sums (zc + up) +
    down, then / 9."""
    zc = z.clone()
    zc[..., :, 1:] += z[..., :, :-1]
    zc[..., :, :-1] += z[..., :, 1:]
    zr = zc.clone()
    zr[..., 1:, :] += zc[..., :-1, :]
    zr[..., :-1, :] += zc[..., 1:, :]
    return zr / 9.0


class _PlainRecursion:
    """The slab recursion for a block of pairs [n1, n2] in plain PyTorch:
    states are lists (primal, then the tangents carried), slabs [n1, n2,
    ni, nj]. ``tsel`` lists the tangents carried (0 = d/dw, 1 = d/db).

    ``state`` is the pair state's dtype, None for the inputs' own (float32,
    or float64 for a witness). bfloat16 (the forward only) rounds
    where the JAX package's bf16 kernel does: the fp32 moment once; every op
    of the recursion (each stencil add, the / 9, w^2 *, + b^2, with w^2,
    b^2 and the profiles themselves rounded); the dual activation, computed
    in fp32 from its bf16 inputs, once on the way out; and each pooled entry
    once, when its stage reads it: the pools sum in fp32 into fp32 pooled
    states. The GAP sums in float64 and the result is fp32."""

    def __init__(self, x1, x2, prof1, prof2, dprof1, dprof2, scales, groups, act, tsel,
                 state=None):
        self.x1, self.x2 = x1, x2
        state = x1.dtype if state is None else state
        self.bf16 = state == torch.bfloat16
        if self.bf16:
            prof1, prof2 = prof1.to(state), prof2.to(state)
            scales = torch.cat([scales[:2].to(state).float(), scales[2:]])
        self.prof1, self.prof2, self.dprof1, self.dprof2 = prof1, prof2, dprof1, dprof2
        self.scales = scales
        self.state = state
        self.groups, self.act, self.tsel = groups, act, tsel
        self.h = x1.shape[1]
        self.layers = _layers(self.h, groups)

    def moment(self, di, dj):
        h = self.h
        ni, nj, i0, j0 = _span(h, di), _span(h, dj), _lo(di), _lo(dj)
        a = self.x1[:, i0:i0 + ni, j0:j0 + nj, :][:, None]
        b = self.x2[:, i0 + di:i0 + di + ni, j0 + dj:j0 + dj + nj, :][None]
        acc = a[..., 0] * b[..., 0]
        for ch in range(1, a.shape[-1]):
            acc = acc + a[..., ch] * b[..., ch]
        k = (acc * self.scales[3]).to(self.state)
        return [k] + [torch.zeros_like(k) for _ in self.tsel]

    def _rows(self, prof, l, i0, j0, ni, nj, side):
        r, off = self.layers[l]
        rows = prof[..., off:off + r * r].reshape(*prof.shape[:-1], r, r)
        rows = rows[..., i0:i0 + ni, j0:j0 + nj]
        return rows[:, None] if side == 1 else rows[None]

    def convs(self, states, r, di, dj, l0, g):
        """g convs (stencil, scale, activation) of layers l0 .. l0 + g - 1 on
        one slab."""
        w2, b2 = self.scales[0], self.scales[1]
        ni, nj, i0, j0 = _span(r, di), _span(r, dj), _lo(di), _lo(dj)
        for l in range(l0, l0 + g):
            v1 = self._rows(self.prof1, l, i0, j0, ni, nj, 1)
            v2 = self._rows(self.prof2, l, i0 + di, j0 + dj, ni, nj, 2)
            if self.bf16:
                u = w2.to(self.state) * _stencil(states[0]) + b2.to(self.state)
                states = [_ACT_T[self.act](u.float(), v1.float(), v2.float()).to(self.state)]
                continue
            if not self.tsel:
                states = [_ACT_T[self.act](w2 * _stencil(states[0]) + b2, v1, v2)]
                continue
            two = (2.0 * self.scales[4], 2.0 * self.scales[5])
            sk = _stencil(states[0])
            t, tk, tv1, tv2 = _ACT_T_PARTIALS[self.act](w2 * sk + b2, v1, v2)
            out = [t]
            for z, ti in zip(states[1:], self.tsel):
                du = w2 * _stencil(z) + (two[0] * sk if ti == 0 else two[1])
                dv1 = self._rows(self.dprof1[:, ti], l, i0, j0, ni, nj, 1)
                dv2 = self._rows(self.dprof2[:, ti], l, i0 + di, j0 + dj, ni, nj, 2)
                out.append(tk * du + tv1 * dv1 + tv2 * dv2)
            states = out
        return states

    @staticmethod
    def pool_into(states, r, di, dj, dest):
        """Add the 2 x 2 pool of one slab at resolution r to the pooled
        slabs it feeds; ``dest(P_i, P_j)`` gives their [n1, n2, Ni, Nj] views
        (one per state). Each pooled entry gets 1/16 of the sum of its 1, 2
        or 4 sources in this slab, in (row parity, column parity) order."""
        r2 = r // 2
        for pi, opts_i in _targets(di, r):
            ni_t, i0_t = _span(r2, pi), _lo(pi)
            for pj, opts_j in _targets(dj, r):
                nj_t, j0_t = _span(r2, pj), _lo(pj)
                views = dest(pi, pj)
                for z, view in zip(states, views):
                    acc = None
                    for ei in opts_i:
                        ui = 2 * i0_t + ei - _lo(di)
                        for ej in opts_j:
                            uj = 2 * j0_t + ej - _lo(dj)
                            src = z[..., ui:ui + 2 * ni_t - 1:2,
                                    uj:uj + 2 * nj_t - 1:2].to(view.dtype)
                            acc = src if acc is None else acc + src
                    view += 0.0625 * acc

    def run(self):
        h = self.h
        g0, g1, g2 = self.groups
        r2, r3 = h // 2, h // 4
        n1, n2 = self.x1.shape[0], self.x2.shape[0]
        ns = 1 + len(self.tsel)
        like = dict(dtype=self.x1.dtype, device=self.x1.device)
        pooled2 = [torch.zeros((n1, n2, r2 ** 4), **like) for _ in range(ns)]
        pooled3 = [torch.zeros((n1, n2, r3 ** 4), **like) for _ in range(ns)]

        def slab_view(bufs, r, pi, pj):
            ni, nj = _span(r, pi), _span(r, pj)
            off = _cum(r, pi) * r * r + ni * _cum(r, pj)
            return [b[..., off:off + ni * nj].view(n1, n2, ni, nj) for b in bufs]

        for di in range(-(h - 1), h):
            for wave in _waves(h):
                for dj in wave:
                    states = self.convs(self.moment(di, dj), h, di, dj, 0, g0)
                    self.pool_into(states, h, di, dj,
                                   lambda pi, pj: slab_view(pooled2, r2, pi, pj))
            m = (di - 1) // 2
            if di % 2 and m > -r2:          # pooled row m is complete: stage 2
                for wave in _waves(r2):
                    for pj in wave:
                        states = self.convs([v.to(self.state, copy=True)
                                             for v in slab_view(pooled2, r2, m, pj)],
                                            r2, m, pj, g0, g1)
                        self.pool_into(states, r2, m, pj,
                                       lambda qi, qj: slab_view(pooled3, r3, qi, qj))
        totals = [torch.zeros((n1, n2), dtype=torch.float64, device=self.x1.device)
                  for _ in range(ns)]
        for qi in range(-(r3 - 1), r3):
            for qj in range(-(r3 - 1), r3):
                states = self.convs([v.to(self.state) for v in slab_view(pooled3, r3, qi, qj)],
                                    r3, qi, qj, g0 + g1, g2)
                for t, z in zip(totals, states):
                    t += z.double().sum(dim=(2, 3))
        scale = self.scales[2].double() / float(r3 ** 4)
        return [(t * scale).to(self.x1.dtype) for t in totals]


def _plain(x1, x2, prof1, prof2, dprof1, dprof2, scales, depth, act, tsel, state=None):
    """Chunk the first operand's rows so that one chunk's pooled stage-2
    states stay within _PLAIN_BYTES."""
    groups = MYRTLE_GROUPS[depth]
    h = x1.shape[1]
    per_row = 4 * (1 + len(tsel)) * x2.shape[0] * ((h // 2) ** 4 + h * h)
    rows = max(1, _PLAIN_BYTES.get(x1.device.type, 1 << 30) // per_row)
    parts = []
    for i in range(0, x1.shape[0], rows):
        sl = slice(i, i + rows)
        parts.append(_PlainRecursion(
            x1[sl], x2, prof1[sl], prof2, None if dprof1 is None else dprof1[sl], dprof2,
            scales, groups, act, tsel, state).run())
    return [torch.cat(p) for p in zip(*parts)]


def myrtle_gram_plain(x1, x2, prof1, prof2, scales, *, depth: int, act: str, state=None):
    """K7's plain PyTorch version, on the kernel's own inputs: images x1
    [N1, h, h, C], x2 [N2, h, h, C], packed variance profiles prof1 [N1, P],
    prof2 [N2, P] (:func:`pack_profiles`) and ``scales`` = [w^2, b^2,
    last^2, 1/C]. The slab recursion in the kernel's order, chunked over
    x1's rows, in the inputs' dtype; ``state=torch.bfloat16`` carries the
    pair state of fp32 inputs in bfloat16, rounded at the JAX package's
    points (see ``_PlainRecursion``), with an fp32 result."""
    return _plain(x1, x2, prof1, prof2, None, None, scales, depth, act, (), state)[0]


def myrtle_gram_tangents_plain(x1, x2, prof1, prof2, dprof1, dprof2, scales, *,
                               depth: int, act: str, tangents: str = "wb"):
    """The scale-tangent mode's plain version: (K, dK/dw_std, dK/db_std)
    for ``tangents="wb"``, (K, dK/dw_std) or (K, dK/db_std) for "w" / "b".
    ``dprof1`` [N1, 2, P] and ``dprof2`` [N2, 2, P] are the packed profile
    tangents (axis 1 = d/dw, d/db); ``scales`` = [w^2, b^2, last^2, 1/C, w,
    b]. Each conv adds 2 w S(k) to dK/dw and 2 b to dK/db; the activation's
    partials serve every tangent."""
    tsel = {"w": (0,), "b": (1,), "wb": (0, 1)}[tangents]
    return tuple(_plain(x1, x2, prof1, prof2, dprof1, dprof2, scales, depth, act, tsel))


# -- the CUDA kernels ----------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("myrtle_gram")
    for fn in (lib.snngp_myrtle_gram_f32, lib.snngp_myrtle_gram_bf16):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fn = lib.snngp_myrtle_gram_tangents_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.snngp_myrtle_error_string.argtypes = [ctypes.c_int]
    lib.snngp_myrtle_error_string.restype = ctypes.c_char_p
    return lib


def tangent_smem_floats(h, ns):
    """Shared-memory floats of one block (WARPS warps) carrying ns
    states (1 in the forward, 2 or 3 in the tangent mode): two rows of
    pooled stage-2 slabs (2 (h/2)^3 a state), the whole stage-3 state
    ((h/4)^4 a state), and one (h/2)^2 column-sum plane a warp for stages 2
    and 3; stage 1 streams its slabs through registers."""
    return 2 * ns * (h // 2) ** 3 + ns * (h // 4) ** 4 + WARPS * (h // 2) ** 2


def _check_cuda_inputs(tensors, depth, act, p, same):
    """Check what both kernels take; ``same=True`` (mirror the upper
    triangle) only where every second operand is its first."""
    x1, x2 = tensors["x1"], tensors["x2"]
    if same and x1.shape[0] != x2.shape[0]:
        raise ValueError(f"same=True needs one operand twice; got n1 = {x1.shape[0]}, "
                         f"n2 = {x2.shape[0]}")
    for name in ("x", "prof", "dprof") if same else ():
        a, b = tensors.get(name + "1"), tensors.get(name + "2")
        if a is not None and (a.data_ptr(), a.shape, a.stride()) != (b.data_ptr(), b.shape,
                                                                     b.stride()):
            raise ValueError(f"same=True needs one operand twice; {name}2 is not {name}1")
    h = x1.shape[1] if x1.ndim == 4 else 0
    if h > _MAX_H:
        raise ValueError(f"{h} x {h} images: the Myrtle kernels take h <= {_MAX_H} "
                         "(one slab column a lane)")
    if act not in _ACTS:
        raise KeyError(f"unsupported act '{act}'")
    if depth not in MYRTLE_GROUPS:
        raise ValueError(f"depth {depth} is not a Myrtle depth (5, 7, 10)")
    for name, t in tensors.items():
        if t.device != x1.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the Myrtle kernels need every "
                             f"input on one CUDA device ({x1.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the Myrtle kernels take float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if x1.ndim != 4 or x2.ndim != 4 or x1.shape[1:] != x2.shape[1:]:
        raise ValueError(f"x1, x2 must be [N, h, h, C] images of one shape; got "
                         f"{tuple(x1.shape)}, {tuple(x2.shape)}")
    n1, h, w, c = x1.shape
    n2 = x2.shape[0]
    if h != w or h < 8 or h & (h - 1):
        raise ValueError(f"{h} x {w} images: the Myrtle kernels take square power-of-two "
                         "images of at least 8 x 8 (three 2 x 2 pools)")
    if min(n1, n2) < 1 or not 1 <= c <= _MAX_C:
        raise ValueError(f"x1 {tuple(x1.shape)}, x2 {tuple(x2.shape)}: need N >= 1 and "
                         f"1 <= C <= {_MAX_C}")
    if n1 > 65535:
        raise ValueError(f"n1 = {n1} exceeds the kernel's grid")
    if tensors["prof1"].shape[-1] != p or tensors["prof2"].shape[-1] != p:
        raise ValueError(f"profiles {tuple(tensors['prof1'].shape)}, "
                         f"{tuple(tensors['prof2'].shape)} do not hold {p} values a sample")
    return n1, n2, h, c


def _profile_len(h, depth):
    return sum(r * r for r, _ in _layers(h, MYRTLE_GROUPS[depth]))


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.snngp_myrtle_error_string(err).decode()})")


def myrtle_gram_cuda(x1, x2, prof1, prof2, scales, *, depth: int, act: str,
                     same: bool = False, state=None):
    """Launch K7 (``csrc/myrtle_gram.cu``) on the current stream; same inputs
    and result as :func:`myrtle_gram_plain`. ``same=True`` says that x2 (and
    its profiles) are x1's: the kernel runs each pair b >= a once and
    mirrors it, so K comes out bitwise symmetric. ``state`` is a pair
    state as :func:`_state_dtype` gives it: torch.bfloat16 launches the
    bf16 pair-state variant (``myrtle_gram_kernel`` with a bf16 state, fp32
    inputs and output), None the fp32 kernel; any other value raises."""
    if state not in (None, torch.bfloat16):
        raise ValueError(f"state {state!r}: K7 takes the pair state None (float32) or "
                         "torch.bfloat16; _state_dtype normalises a dtype argument")
    h = x1.shape[1] if x1.ndim == 4 else 0
    n1, n2, h, c = _check_cuda_inputs(dict(x1=x1, x2=x2, prof1=prof1, prof2=prof2,
                                           scales=scales), depth, act,
                                      _profile_len(h, depth), same)
    if prof1.shape != (n1, prof1.shape[-1]) or prof2.shape != (n2, prof2.shape[-1]):
        raise ValueError("profiles must be [N, P]")
    if scales.shape != (4,):
        raise ValueError(f"scales must be [4]; got {tuple(scales.shape)}")
    g0, g1, g2 = MYRTLE_GROUPS[depth]
    lib = _lib()
    bf16 = state == torch.bfloat16
    fn = lib.snngp_myrtle_gram_bf16 if bf16 else lib.snngp_myrtle_gram_f32
    out = torch.empty((n1, n2), dtype=torch.float32, device=x1.device)
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x1.data_ptr(), x2.data_ptr(), prof1.data_ptr(), prof2.data_ptr(),
                 scales.data_ptr(), out.data_ptr(), n1, n2, h, c, g0, g1, g2, _ACTS[act],
                 int(same), stream)
    _raise_on(lib, err, "Myrtle Gram kernel" + (" (bf16 state)" if bf16 else ""))
    LAUNCHES["myrtle_bf16" if bf16 else "myrtle"] += 1
    return out


def myrtle_gram_tangents_cuda(x1, x2, prof1, prof2, dprof1, dprof2, scales, *,
                              depth: int, act: str, tangents: str = "wb", same: bool = False):
    """Launch K7's scale-tangent mode (``csrc/myrtle_gram.cu``) on the current
    stream; same inputs and results as :func:`myrtle_gram_tangents_plain`.
    ``same=True`` says that x2 (and its profiles) are x1's: the kernel runs
    each pair b >= a once and mirrors it, so K and both tangents come out
    bitwise symmetric."""
    h = x1.shape[1] if x1.ndim == 4 else 0
    n1, n2, h, c = _check_cuda_inputs(
        dict(x1=x1, x2=x2, prof1=prof1, prof2=prof2, dprof1=dprof1, dprof2=dprof2,
             scales=scales), depth, act, _profile_len(h, depth), same)
    p = prof1.shape[-1]
    if dprof1.shape != (n1, 2, p) or dprof2.shape != (n2, 2, p):
        raise ValueError(f"profile tangents {tuple(dprof1.shape)}, {tuple(dprof2.shape)} "
                         f"must be [N, 2, {p}]")
    if scales.shape != (6,):
        raise ValueError(f"scales must be [6]; got {tuple(scales.shape)}")
    mode = _TANGENT_MODES[tangents]
    ns = 3 if tangents == "wb" else 2
    g0, g1, g2 = MYRTLE_GROUPS[depth]
    lib = _lib()
    out = torch.empty((ns, n1, n2), dtype=torch.float32, device=x1.device)
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.snngp_myrtle_gram_tangents_f32(
            x1.data_ptr(), x2.data_ptr(), prof1.data_ptr(), prof2.data_ptr(),
            dprof1.data_ptr(), dprof2.data_ptr(), scales.data_ptr(), out.data_ptr(),
            n1, n2, h, c, g0, g1, g2, _ACTS[act], mode, int(same), stream)
    _raise_on(lib, err, "Myrtle Gram tangent kernel")
    LAUNCHES["myrtle_grads"] += 1
    return tuple(out.unbind())


# -- dispatch and autograd -----------------------------------------------------------

def _check_shape(x):
    h = x.shape[1]
    if x.ndim != 4 or x.shape[2] != h or h < 8 or h & (h - 1):
        raise ValueError(f"images {tuple(x.shape)}: the fused Myrtle Gram takes square "
                         "power-of-two [N, h, h, C] images with h >= 8 (three 2 x 2 pools)")


def _scales(x1, w, b, last, tangents):
    like = dict(dtype=x1.dtype, device=x1.device)
    vals = [w * w, b * b, last * last, torch.full((), 1.0 / x1.shape[-1], **like)]
    vals += [w, b] if tangents else []
    return torch.stack([torch.as_tensor(v, **like) for v in vals])


def _use_kernel(x, plain):
    """The device dispatch: the kernels for a CUDA tensor, the plain
    versions for a CPU tensor or when asked (``plain``)."""
    return not plain and x.device.type != "cpu"


def _forward(x1, x2, w, b, last, depth, act, same, plain=False, state=None):
    groups = MYRTLE_GROUPS[depth]
    with span("k7.profiles"):
        p1 = pack_profiles(myrtle_var_profiles(x1, groups, act, w, b))
        p2 = p1 if same else pack_profiles(myrtle_var_profiles(x2, groups, act, w, b))
    xc1 = x1.contiguous()
    xc2 = xc1 if same else x2.contiguous()
    args = (xc1, xc2, p1, p2, _scales(x1, w, b, last, False))
    if not _use_kernel(x1, plain):
        return myrtle_gram_plain(*args, depth=depth, act=act, state=state)
    return myrtle_gram_cuda(*args, depth=depth, act=act, same=same, state=state)


def _tangents(x1, x2, w, b, last, depth, act, profiles=None, tangents="wb", plain=False):
    """(K, dK/dw, dK/db) (or one tangent) through the tangent mode, with
    the profiles and their tangents computed here unless given as
    ``((p1, d1), (p2, d2))``. ``x2 is x1`` launches the kernel's symmetric
    mode (each pair of K(x, x) once), with x1's profiles on both sides."""
    same = x2 is x1
    with span("k7.profiles"):
        if profiles is None:
            groups = MYRTLE_GROUPS[depth]
            pr1 = _profiles_with_tangents(x1, groups, act, w, b)
            pr2 = pr1 if same else _profiles_with_tangents(x2, groups, act, w, b)
        else:
            pr1, pr2 = profiles
        p1, d1 = pack_profiles(pr1[0]), pack_profiles(pr1[1])
        p2, d2 = (p1, d1) if same or pr2 is pr1 else (pack_profiles(pr2[0]),
                                                      pack_profiles(pr2[1]))
    xc1 = x1.contiguous()
    xc2 = xc1 if same else x2.contiguous()
    args = (xc1, xc2, p1, p2, d1, d2, _scales(x1, w, b, last, True))
    kw = dict(depth=depth, act=act, tangents=tangents)
    if not _use_kernel(x1, plain):
        return myrtle_gram_tangents_plain(*args, **kw)
    return myrtle_gram_tangents_cuda(*args, **kw, same=same)


def _reference(x1, x2, depth, act, w, b, last):
    """The full tier's Gram, the backward surrogate of the
    ``trainable_inputs=True`` contract."""
    from snngp_torch.nn.full import get_myrtle_kernel
    return get_myrtle_kernel(depth, 1, act, w_std=w, b_std=b, last_w_std=last)(
        x1, x2, get="nngp")


class _MyrtleGram(torch.autograd.Function):
    """Fused Myrtle Gram with the JAX package's two backward contracts.
    ``plain=True`` runs the plain versions on any device: the float64
    oracle of a gradient check on the card; the public entry points never
    set it. ``state`` is the forward's pair-state dtype; a bf16 forward
    has only the ``trainable_inputs=True`` backward, through the fp32 full
    tier, as in the JAX package."""

    @staticmethod
    def forward(ctx, x1, x2, w, b, last, depth, act, trainable_inputs, same, plain=False,
                state=None):
        ctx.save_for_backward(x1, x2, w, b, last)
        ctx.conf = (depth, act, trainable_inputs, same, plain)
        with span("k7.forward"):
            return _forward(x1, x2, w, b, last, depth, act, same, plain, state)

    @staticmethod
    def backward(ctx, g):
        with span("k7.tangents"):
            return _MyrtleGram._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
        x1, x2, w, b, last = ctx.saved_tensors
        depth, act, trainable_inputs, same, plain = ctx.conf
        if trainable_inputs:
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(need)
                          for t, need in zip((x1, x2, w, b, last), ctx.needs_input_grad)]
                a1, a2, ww, bb, ll = leaves
                k = _reference(a1, a1 if same else a2, depth, act, ww, bb, ll)
                wanted = [t for t in leaves if t.requires_grad]
                grads = iter(torch.autograd.grad(k, wanted, g, allow_unused=True))
            out = [next(grads) if t.requires_grad else None for t in leaves]
            return (*out, None, None, None, None, None, None)

        with torch.no_grad():
            k, dkw, dkb = _tangents(x1, x1 if same else x2, w, b, last, depth, act,
                                    plain=plain)
            # K = last^2 t, so dK/dlast = (2 / last) K; 0 at last = 0 (K = 0 there).
            lf = last.double()
            dkl = (2.0 * k.double() / lf) if float(lf) != 0.0 else torch.zeros_like(k.double())
            g64 = g.double()
            sums = [torch.sum(g64 * t.double()) for t in (dkw, dkb)] + [torch.sum(g64 * dkl)]
        gw, gb, gl = (s.to(v.dtype) for s, v in zip(sums, (w, b, last)))
        zero_x = [torch.zeros_like(x) if need else None
                  for x, need in zip((x1, x2), ctx.needs_input_grad[:2])]
        return (*zero_x, gw, gb, gl, None, None, None, None, None, None)


def myrtle_gram(x1: torch.Tensor, x2: Optional[torch.Tensor] = None, *, depth: int = 5,
                act: str = "relu", w_std=1.0, b_std=0.0, last_w_std=1.0, dtype=None,
                trainable_inputs: bool = True) -> torch.Tensor:
    """Fused Myrtle-{5,7,10} NNGP Gram of [N, h, h, C] images (h a power of
    two, >= 8): equals ``nn.full.get_myrtle_kernel(depth, ...)(x1, x2,
    get="nngp")``. K7 on a CUDA tensor, its plain version on a CPU tensor.

    ``trainable_inputs=True``: the backward recomputes through the full tier
    (x cotangents included; affordable only at small N). ``False``: only the
    three scales are differentiated, by one tangent-mode pass (dK/dw, dK/db;
    dK/dlast = (2 / last) K), and x1 / x2 get zero cotangents.

    ``dtype``: the pair state's, float32 (None) or bfloat16
    (``torch.bfloat16``, "bf16", "bfloat16"): the bf16 variant of K7 on a
    CUDA tensor, the bf16 plain version on a CPU tensor, with the fp32
    moment, pools and GAP of the JAX package's bf16 kernel and ~1e-2
    relative noise on the entries. The result is float32 either way. A bf16
    state is forward-only: ``trainable_inputs=False`` raises ``ValueError``
    (scalar-tangent gradients are fp32-only)."""
    if act not in _ACT_T:
        raise KeyError(f"unsupported act '{act}'")
    state = _state_dtype(dtype)
    if not trainable_inputs and state is not None:
        raise ValueError("scalar-tangent gradients (trainable_inputs=False) are fp32-only")
    if depth not in MYRTLE_GROUPS:
        raise ValueError(f"depth {depth} is not a Myrtle depth (5, 7, 10)")
    same = x2 is None or x2 is x1
    x2 = x1 if x2 is None else x2
    _check_shape(x1)
    like = dict(dtype=x1.dtype, device=x1.device)
    w = torch.as_tensor(w_std, **like)
    b = torch.as_tensor(b_std, **like)
    last = torch.as_tensor(last_w_std, **like)
    return _MyrtleGram.apply(x1, x2, w, b, last, depth, act, trainable_inputs, same, False,
                             state)


def myrtle_gram_scale_grads(x1, x2=None, *, depth: int = 5, act: str = "relu", w_std=1.0,
                            b_std=0.0, last_w_std=1.0, split: Optional[bool] = None,
                            profiles=None):
    """(K, dK/dw_std, dK/db_std) from one pass of the tangent mode, which
    carries both tangents at every image size. dK/dlast_w_std = (2 / last)
    K is not returned (compute it from K).

    ``split`` is accepted for the JAX package's signature: there it splits
    the pass in two to fit the TPU's 16 MB scoped VMEM at 32 x 32; the
    values are the same either way, and the port always runs one pass.
    ``profiles=((prof1, tang1), (prof2, tang2))`` feeds precomputed
    per-block profiles from :func:`myrtle_profile_tangents`."""
    del split
    if act not in _ACT_T:
        raise KeyError(f"unsupported act '{act}'")
    same = x2 is None or x2 is x1
    x2 = x1 if x2 is None else x2
    _check_shape(x1)
    like = dict(dtype=x1.dtype, device=x1.device)
    with torch.no_grad():
        w, b, last = (torch.as_tensor(v, **like) for v in (w_std, b_std, last_w_std))
        return _tangents(x1, x1 if same else x2, w, b, last, depth, act, profiles)


def myrtle_gram_tiled(x1, x2=None, *, depth: int = 5, act: str = "relu", w_std=1.0,
                      b_std=0.0, last_w_std=1.0, block: int = 512, log=None, dtype=None,
                      resume_path: Optional[str] = None):
    """Assemble a large Myrtle Gram from [block, block] fused-Gram calls into
    a host numpy array (float32). Symmetric inputs (``x2 is None``) compute
    only the upper-triangle blocks and mirror them.

    ``resume_path`` makes the assembly resumable: the Gram lives in an
    ``.npy`` memmap at that path with a block bitmap ``<path>.done.npy``,
    flushed after every block, in the JAX package's layout (either package
    resumes the other's file). A re-run with the same path skips the
    blocks already done.

    Block t + 1 is launched before block t is written to the host array
    (:func:`snngp_torch.ops.tiled.assemble_tiles`), so the host's write and
    the resume flush overlap the card's work. Ragged last blocks are not
    padded (the kernel takes any N)."""
    symmetric = x2 is None
    x2e = x1 if symmetric else x2
    n1, n2 = x1.shape[0], x2e.shape[0]
    todo = [(i, j) for i in range(0, n1, block)
            for j in range(i if symmetric else 0, n2, block)]

    def launch(i, j):
        # A diagonal block of K(x, x) is K(x_i, x_i): one operand, so the
        # kernel's symmetric launch.
        diag = symmetric and i == j
        return (myrtle_gram(x1[i:i + block], None if diag else x2e[j:j + block],
                            depth=depth, act=act, w_std=w_std, b_std=b_std,
                            last_w_std=last_w_std, dtype=dtype),)

    paths = None if resume_path is None else [resume_path]
    done_path = None if resume_path is None else resume_path + ".done.npy"
    (out,) = assemble_tiles(todo, launch, (n1, n2), mirror=symmetric, paths=paths,
                            done_path=done_path, log=log, label="myrtle_gram_tiled",
                            what="block")
    return out


def myrtle_gram_sharded(x1: torch.Tensor, x2: Optional[torch.Tensor], mesh, *, depth: int = 5,
                        act: str = "relu", w_std=1.0, b_std=0.0, last_w_std=1.0, dtype=None):
    """The fused Myrtle Gram as shards over ``mesh``, in
    :func:`~snngp_torch.parallel.gram.sharded_gram`'s layout: row panels on a
    1-D mesh (shard d runs one K7 launch of its rows of ``x1`` against all of
    ``x2``), tiles on a 2-D mesh (a square mesh's diagonal tiles of K(x, x)
    are K7's symmetric launch). ``x2=None`` is K(x1, x1). The leading dims
    must divide the mesh axes; :func:`~snngp_torch.parallel.mesh.gather`
    joins the shards."""
    from snngp_torch.parallel.gram import sharded_gram

    def kernel_fn(a, b, get="nngp"):
        if get != "nngp":
            raise ValueError(f"the fused Myrtle Gram computes the nngp only, not {get!r}")
        return myrtle_gram(a, b, depth=depth, act=act, w_std=w_std, b_std=b_std,
                           last_w_std=last_w_std, dtype=dtype)

    return sharded_gram(kernel_fn, x1, mesh, x2=x2)
