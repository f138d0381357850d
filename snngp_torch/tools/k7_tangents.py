#!/usr/bin/env python3
"""Build and check K7's scale-tangent mode (``csrc/myrtle_gram.cu``,
``myrtle_gram_tangents_kernel``) alone, in about a minute on one card.

    python3 snngp_torch/tools/k7_tangents.py [--step]

Prints the card's name and power limit, the ptxas report of every
instantiation of the tangent kernel (registers, spills), then runs
``chip_smoke.py``'s phase-14 tangent cases at 8 x 8 and 16 x 16 and its
symmetric ones against the plain version with the smoke's gates (1e-5, or
for the relu symmetric case at 16 x 16 within 2x the plain fp32 version's
error against float64; bitwise repeat; bitwise symmetric K and tangents
for a symmetric launch), and times the head shape (200 x 200 pairs of
32 x 32 x 3, Myrtle-5, relu, wb, symmetric) with the kernel alone: one
warm-up call, then one timed call, beside its bound.

``--step`` also times one Myrtle-5 SVSP svgp step at the smoke's shape
(after one untimed step), split by phase. Needs nvcc and one CUDA card.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def _card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed")


def _ptxas(_build):
    """The tangent kernel's lines of ptxas's report, one per instantiation."""
    lines = _build.library_path("myrtle_gram").with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "tangents" in line:
            for follow in lines[i + 1:i + 4]:
                if "registers" in follow or "spill" in follow:
                    print(f"ptxas {line.split('Compiling entry function', 1)[-1].strip()}: "
                          f"{follow.split(':', 1)[-1].strip()}")


def _step(cs):
    x, y, z, num_class = cs._svsp_data()
    cs._svsp_steps("myrtle svgp", "svgp", x, y, z, num_class,
                   {"myrtle": 3, "myrtle_grads": 3}, trainable_inputs=False,
                   network="myrtle", steps=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--step", action="store_true", help="also time one Myrtle-5 SVSP step")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k7_tangents: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from snngp_torch.ops import _build
    from snngp_torch.ops import myrtle_gram as MG

    _card()
    t0 = time.perf_counter()
    _build.load("myrtle_gram")
    print(f"[k7] myrtle_gram.cu built in {time.perf_counter() - t0:.1f} s")
    _ptxas(_build)

    rng = np.random.RandomState(14)
    t0 = time.perf_counter()
    failed = []
    with torch.inference_mode():
        for label, n1, n2, h, same, depth, act, mode, vs_fp64 in cs._k7_cases():
            if mode and (h <= 16 or same):
                x1, x2 = cs._conv_inputs(rng, n1, n2, h, h, 3, same)
                try:
                    cs._k7_check(label, x1, x2, depth, act, mode, vs_fp64=vs_fp64)
                except AssertionError as err:
                    print(f"[k7] FAILED: {err}")
                    failed.append(label)
        print(f"[k7] cases checked in {time.perf_counter() - t0:.1f} s")
        x = torch.as_tensor(rng.randn(cs.SVSP_NI, 32, 32, 3).astype(np.float32),
                            device="cuda")
        margs = cs._myrtle_args(x, x, 5, "relu", True)
        kw = dict(depth=5, act="relu", tangents="wb", same=True)
        first = MG.myrtle_gram_tangents_cuda(*margs, **kw)
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        again = MG.myrtle_gram_tangents_cuda(*margs, **kw)
        stop.record()
        stop.synchronize()
        ms = start.elapsed_time(stop)
        nbytes = (sum(t.numel() * 4 for t in {id(t): t for t in margs}.values())
                  + 4 * sum(g.numel() for g in first))
        bound, by = cs.bound_ms(nbytes, *cs.k7_ops(200, 200, 32, 3, 5, "relu", True, 2))
        repeat = all(torch.equal(a, b) for a, b in zip(first, again))
        sym = max((g - g.T).abs().max().item() for g in first)
        finite = all(bool(torch.isfinite(g).all()) for g in first)
        print(f"[k7] head {cs.K7_HEAD} wb: {ms:.3f} ms, bound {bound:.3f} ms ({by}, "
              f"{100 * bound / ms:.2f}%), repeat {repeat}, max|K-K^T| {sym:.3e}, "
              f"finite {finite}")
        if not (repeat and sym == 0.0 and finite):
            raise AssertionError("the head shape's tangent launch is not repeatable, "
                                 "symmetric and finite")
    if args.step:
        _step(cs)
    if failed:
        print(f"[k7] failed cases: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
