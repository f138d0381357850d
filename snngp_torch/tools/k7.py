#!/usr/bin/env python3
"""Build and check K7 (``csrc/myrtle_gram.cu``: the forward,
``myrtle_gram_kernel``, its bf16 pair-state variant, and the scale-tangent
mode, ``myrtle_gram_tangents_kernel``) alone, in about three minutes on one
card.

    python3 snngp_torch/tools/k7.py [--step]

Prints the card's name and power limit and the ptxas report of every
instantiation of both kernels (registers, spills), then runs
``chip_smoke.py``'s phase-14 cases of both modes at 8 x 8 and 16 x 16 and
its symmetric ones against the plain version with the smoke's gates (1e-5,
or for the relu symmetric tangent case at 16 x 16 within 2x the plain fp32
version's error against float64; bitwise repeat; bitwise symmetric K and
tangents for a symmetric launch), and times both modes at the head shape
(200 x 200 pairs of 32 x 32 x 3, Myrtle-5, relu, symmetric; wb for the
tangent mode) with the kernel alone: one warm-up call, then one timed
call, each beside its bound. Then ``chip_smoke.py``'s bf16 phase (14
(bf16)): the bf16 variant against its bf16 plain version and the fp32
kernel at 8 x 8 and 16 x 16 and at the head shape, where the bf16 and fp32
forwards are timed in turns.

``--step`` also times one Myrtle-5 SVSP svgp step at the smoke's shape
(after one untimed step), split by phase. ``--blocks N ...`` builds copies
of ``myrtle_gram.cu`` whose forward asks ``__launch_bounds__`` for N
blocks an SM (``kForwardBlocks``) into ``build/k7_blocks/``, prints their
ptxas reports and times the fp32 and bf16 forwards at the head shape on
the tree's build and on each copy, in turns (the builds in order, then
reversed). Needs nvcc and one CUDA card.
"""

import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def _step(cs):
    x, y, z, num_class = cs._svsp_data()
    cs._svsp_steps("myrtle svgp", "svgp", x, y, z, num_class,
                   {"myrtle": 3, "myrtle_grads": 3}, trainable_inputs=False,
                   network="myrtle", steps=1)


def _head(cs, MG, margs, mode):
    """Time one call of either mode at the head shape after a warm-up
    call, beside its bound; gate: repeatable, symmetric and finite."""
    import torch

    if mode:
        fn = lambda: MG.myrtle_gram_tangents_cuda(  # noqa: E731
            *margs, depth=5, act="relu", tangents=mode, same=True)
    else:
        fn = lambda: (MG.myrtle_gram_cuda(*margs, depth=5, act="relu", same=True),)  # noqa: E731
    first = fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    again = fn()
    stop.record()
    stop.synchronize()
    ms = start.elapsed_time(stop)
    nbytes = (cs._read_bytes(margs)
              + 4 * sum(g.numel() for g in first))
    bound, by = cs.bound_ms(nbytes, *cs.k7_ops(200, 200, 32, 3, 5, "relu", True, len(mode)))
    repeat = all(torch.equal(a, b) for a, b in zip(first, again))
    sym = max((g - g.T).abs().max().item() for g in first)
    finite = all(bool(torch.isfinite(g).all()) for g in first)
    print(f"[k7] head {cs.K7_HEAD} {mode or 'fwd'}: {ms:.3f} ms, bound {bound:.3f} ms ({by}, "
          f"{100 * bound / ms:.2f}%), repeat {repeat}, max|K-K^T| {sym:.3e}, finite {finite}")
    if not (repeat and sym == 0.0 and finite):
        raise AssertionError(f"the head shape's {mode or 'forward'} launch is not "
                             "repeatable, symmetric and finite")


def _variant(blocks, own):
    """myrtle_gram.cu with kForwardBlocks = ``blocks``, built and loaded,
    with the ctypes signatures of ``own`` (the tree's library)."""
    from snngp_torch.ops import _build

    lib, report = _build.build_variant("myrtle_gram", {"kForwardBlocks": blocks},
                                       REPO / "build" / "k7_blocks" / f"myrtle_gram_{blocks}.so")
    for line in report:
        if line.startswith("myrtle_gram_kernel"):
            print(f"[blocks {blocks}] ptxas {line}")
    for fn in ("snngp_myrtle_gram_f32", "snngp_myrtle_gram_bf16",
               "snngp_myrtle_gram_tangents_f32", "snngp_myrtle_error_string"):
        getattr(lib, fn).argtypes = getattr(own, fn).argtypes
        getattr(lib, fn).restype = getattr(own, fn).restype
    return lib


def _blocks(cs, MG, margs, specs):
    """The head shape's fp32 and bf16 forwards on the tree's build and on
    each kForwardBlocks copy, one warm-up and one timed call each, the
    builds in order and then reversed."""
    import torch

    libs = {f"tree ({cs.K7_HEAD})": MG._lib()}
    for blocks in specs:
        libs[f"{blocks} blocks"] = _variant(blocks, libs[next(iter(libs))])
    own = MG._lib
    try:
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                MG._lib = lambda lib=libs[name]: lib  # noqa: E731
                for state in (None, torch.bfloat16):
                    MG.myrtle_gram_cuda(*margs, depth=5, act="relu", same=True, state=state)
                    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    MG.myrtle_gram_cuda(*margs, depth=5, act="relu", same=True, state=state)
                    stop.record()
                    stop.synchronize()
                    print(f"[blocks] {name} {'bfloat16' if state else 'float32'}: "
                          f"{start.elapsed_time(stop):.3f} ms")
    finally:
        MG._lib = own


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--step", action="store_true", help="also time one Myrtle-5 SVSP step")
    ap.add_argument("--blocks", nargs="*", type=int, default=[], metavar="N",
                    help="time forward builds with these __launch_bounds__ minimum blocks")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k7: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from snngp_torch.ops import _build
    from snngp_torch.ops import myrtle_gram as MG

    print(cs.card())
    t0 = time.perf_counter()
    _build.load("myrtle_gram")
    print(f"[k7] myrtle_gram.cu built in {time.perf_counter() - t0:.1f} s")
    # Template arguments: the forward's (act, g0, bf16), the tangent mode's
    # (act, tangents, g0); act 0 is relu, 1 erf.
    for line in _build.ptxas_report("myrtle_gram"):
        print(f"ptxas {line}")

    rng = np.random.RandomState(14)
    t0 = time.perf_counter()
    failed = []
    with torch.inference_mode():
        for label, n1, n2, h, same, depth, act, mode, vs_fp64 in cs._k7_cases():
            if h <= 16 or same:
                x1, x2 = cs._conv_inputs(rng, n1, n2, h, h, 3, same)
                try:
                    cs._k7_check(label, x1, x2, depth, act, mode, vs_fp64=vs_fp64)
                except AssertionError as err:
                    print(f"[k7] FAILED: {err}")
                    failed.append(f"{act}/{label}/{mode or 'fwd'}")
        print(f"[k7] cases checked in {time.perf_counter() - t0:.1f} s")
        x = torch.as_tensor(rng.randn(cs.SVSP_NI, 32, 32, 3).astype(np.float32),
                            device="cuda")
        margs = cs._myrtle_args(x, x, 5, "relu", False)
        _head(cs, MG, margs, "")
        _head(cs, MG, cs._myrtle_args(x, x, 5, "relu", True), "wb")
        if args.blocks:
            _blocks(cs, MG, margs, args.blocks)
    try:
        cs.phase14_k7_bf16()
    except AssertionError as err:
        print(f"[k7] FAILED: {err}")
        failed.append("bf16")
    if args.step:
        _step(cs)
    if failed:
        print(f"[k7] failed cases: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
