#!/usr/bin/env python3
"""Classification and the pipeline on the mesh alone on one card:
``chip_smoke.py``'s phases 26-28 with their gates.

    python3 snngp_torch/tools/mesh_cls.py

Prints the card's name and power limit, builds the kernels (phase 0), runs
the float64 gradient references of phases 9, 12 and 15, the single-device
ELBO steps that phase 26 prints its steps beside (MESH_ELBO_STEPS each),
phase 10 (whose ``cls ts`` NLL and Monte Carlo tolerance phase 27 is held
to) and phase 28's references, then phases 26-28 in their launch window
(K3-K7 and K7's tangent mode must launch; K1 and K2 must not) and phase
28's Gram and NLL comparisons. Needs one CUDA card.
"""

import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def main():
    sys.path.insert(0, str(REPO))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("mesh_cls: CUDA is not available")
    import chip_smoke as cs
    import snngp_torch  # noqa: F401  (precision policy)

    t0 = time.perf_counter()
    cs._phase(0, cs.phase0_setup)
    checks = {f"cnn {m}": v for m, v in
              cs._phase("9 (gradient checks)", cs.phase9_svsp_gradients).items()}
    checks["resnet svgp"] = cs._phase("12 (gradient check)", cs.phase12_resnet_gradient)
    checks["myrtle svgp"] = cs._phase("15 (gradient check)", cs.phase15_myrtle_gradient)
    x, y, z, num_class = cs._svsp_data()
    single = {label: cs._svsp_steps(f"one device {label}", method, x, y, z, num_class, want,
                                    trainable, network=network, steps=steps)
              for label, method, network, trainable, want, steps in (
                  ("svgp", "svgp", "cnn", True, {"conv_gram": 3}, cs.MESH_ELBO_STEPS),
                  ("svtp frozen", "svtp", "cnn", False,
                   {"conv_gram": 3, "conv_gram_grads": 3}, cs.MESH_ELBO_STEPS),
                  ("resnet svgp", "svgp", "resnet", True,
                   {"resnet_tail": 12, "resnet_strided": 9}, cs.MESH_ELBO_STEPS),
                  ("myrtle svtp", "svtp", "myrtle", False,
                   {"myrtle": 3, "myrtle_grads": 3}, cs.MYRTLE_STEPS))}
    cls10 = cs._phase(10, cs.phase10_cls_cli)
    cs.mesh_cls_window(checks, single, cls10)
    print(f"[done] {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
