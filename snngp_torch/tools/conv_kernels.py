#!/usr/bin/env python3
"""Build and check the CNN and WideResNet kernels alone, in a few minutes on
one card: K3 and K4 (``csrc/conv_gram.cu``: ``conv_gram_kernel``,
``conv_gram_grads_kernel``), K5 and K6 (``csrc/resnet_conv_gram.cu``:
``resnet_tail_kernel``, ``resnet_strided_kernel``).

    python3 snngp_torch/tools/conv_kernels.py [--step]

Prints the card's name and power limit and the ptxas report of every
instantiation (registers, spills), then runs ``chip_smoke.py``'s phases 7, 8
and 11 with their gates (every K3, K5 and K6 case within 1e-5 of max|K| of
the plain version, every K4 sum within 1e-5 of sum |g dK|, a second launch
bitwise equal, every symmetric launch bitwise symmetric), and prints the
head shapes' times beside their bounds (K3 and K4: 200 x 200 pairs of
32 x 32 x 3, depth 4, relu, symmetric; K5: 200 x 200 pairs of 32 x 32, four
blocks with the conv shortcut, relu, symmetric; K6: 200 x 200 pairs, 32 ->
16, relu, symmetric).

``--step`` also times three svgp ELBO steps each of the CNN and of the
WideResNet, and three CNN svgp steps with frozen inducing inputs (K4's
backward), at the smoke's SVSP shape (after one untimed step), split by
phase. Needs nvcc and one CUDA card.
"""

import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def _steps(cs):
    """Three svgp steps each of the CNN, of the CNN with frozen inducing
    inputs and of the WideResNet, split by phase (the Gram phase is the
    kernels')."""
    x, y, z, num_class = cs._svsp_data()
    cs._svsp_steps("cnn svgp", "svgp", x, y, z, num_class, {"conv_gram": 3}, steps=3)
    cs._svsp_steps("cnn svgp frozen", "svgp", x, y, z, num_class,
                   {"conv_gram": 3, "conv_gram_grads": 3}, trainable_inputs=False, steps=3)
    want = {"resnet_tail": 3 * (1 + 3 * (cs.SVSP_DEPTH > 1)), "resnet_strided": 9}
    cs._svsp_steps("resnet svgp", "svgp", x, y, z, num_class, want, network="resnet",
                   steps=3)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--step", action="store_true",
                    help="also time three CNN and three WideResNet SVSP steps")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))

    import torch

    if not torch.cuda.is_available():
        print("conv_kernels: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from snngp_torch.ops import _build

    print(cs.card())
    # Template arguments: act (0 relu, 1 erf); for K5 also the blocks a
    # launch and the conv shortcut.
    for name in ("conv_gram", "resnet_conv_gram"):
        t0 = time.perf_counter()
        _build.load(name)
        print(f"[conv] {name}.cu built in {time.perf_counter() - t0:.1f} s")
        for line in _build.ptxas_report(name):
            print(f"ptxas {name}: {line}")

    with torch.inference_mode():
        t0 = time.perf_counter()
        k3_rows, _ = cs.phase7_k3_vs_plain()
        print(f"[conv] phase 7 checked in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        k56_rows, _ = cs.phase11_k5_k6_vs_plain()
        print(f"[conv] phase 11 checked in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k4_rows = cs.phase8_k4_vs_plain()
    print(f"[conv] phase 8 checked in {time.perf_counter() - t0:.1f} s")
    for kernel, rows, head in (("K3", k3_rows, cs.K34_HEAD), ("K4", k4_rows, cs.K34_HEAD),
                               ("K5", k56_rows["K5"], cs.K5_HEAD),
                               ("K6", k56_rows["K6"], cs.K6_HEAD)):
        r = rows[head]
        print(f"[conv] head {kernel} {head}: {r['ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.2f}%), plain "
              f"{r['plain_ms']:.3f} ms")
    if args.step:
        _steps(cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
