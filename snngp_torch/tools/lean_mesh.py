#!/usr/bin/env python3
"""The memory-lean fit and the regression mesh alone on one card:
``chip_smoke.py``'s phases 24 and 25 with their gates, in about two
minutes.

    python3 snngp_torch/tools/lean_mesh.py

Prints the card's name and power limit, builds the kernels (phase 0), runs
phase 2 (the serving fit whose float64 requests phase 24 is held to) and
the single-device ML-II gradients of phase 5 (fp32 kernels and float64
through the plain tier, phase 25's bar), then phase 24's and 25's
references, and phases 24-25 in their launch window (K1, K2 and K7's
tangent mode must launch). First it prints how far forward-mode AD
(``torch.func.jvp``) of the Myrtle variance profiles moves under
``torch.inference_mode()`` on this torch, and checks that
``myrtle_profile_tangents`` gives the same tangents in both modes. Needs one
CUDA card.
"""

import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def _inference_mode_tangents():
    """The raw jvp of the Myrtle-5 profiles in and out of inference mode
    (printed: a property of the installed torch), then the port's profile
    tangents in both modes (gate: equal)."""
    import numpy as np
    import torch
    from snngp_torch.ops import myrtle_gram as MG

    x = torch.as_tensor(np.random.RandomState(251).randn(8, 32, 32, 3).astype(np.float32),
                        device="cuda")
    groups = MG.MYRTLE_GROUPS[5]

    def raw():
        w = torch.tensor(1.0, device="cuda")
        b = torch.tensor(0.1, device="cuda")
        return torch.func.jvp(lambda ww: MG.myrtle_var_profiles(x, groups, "relu", ww, b),
                              (w,), (torch.ones_like(w),))[1]

    out = raw()
    with torch.inference_mode():
        inf = raw()
    print(f"[tangents] torch {torch.__version__}: raw jvp of the profiles, inference mode "
          "against not, max diff per layer "
          + " ".join(f"{(a - b).abs().max().item():.3e}" for a, b in zip(out, inf)))
    ref = MG.myrtle_profile_tangents(x, depth=5, w_std=1.0, b_std=0.1)[1]
    with torch.inference_mode():
        got = MG.myrtle_profile_tangents(x, depth=5, w_std=1.0, b_std=0.1)[1]
    if not all(torch.equal(a, b) for a, b in zip(ref, got)):
        raise AssertionError("myrtle_profile_tangents depends on inference mode")
    print("[tangents] myrtle_profile_tangents: equal in both modes")


def main():
    sys.path.insert(0, str(REPO))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("lean_mesh: CUDA is not available")
    import chip_smoke as cs
    import snngp_torch  # noqa: F401  (precision policy)

    t0 = time.perf_counter()
    cs._phase(0, cs.phase0_setup)
    _inference_mode_tangents()
    data = cs._serving_data()
    with torch.inference_mode():
        cs._warm_up(data)
        _, errs, ref64 = cs._phase(2, cs.phase2_serving, data)
    x, y, _, y_mean, y_std = data
    grads = {}
    for name, fused, dtype in (("kernel", True, torch.float32),
                               ("plain fp64", False, torch.float64)):
        model = cs._model(x, y, y_mean, y_std, fused=fused, dtype=dtype, eps=cs.TRAIN_EPS)
        grads[name] = cs._loss_and_grads(model)[2]
        del model
        torch.cuda.empty_cache()
    g64 = grads["plain fp64"]
    kernel_err = ((grads["kernel"] - g64).norm() / g64.norm()).item()
    print(f"[train] single-device fp32 gradient rel err {kernel_err:.3e} against float64")
    lean = cs._lean_data()
    with torch.inference_mode():
        cs._phase("24 (K1 rows)", cs.phase24_k1_rows, lean)
        refs = cs._phase("25 (references)", cs.phase25_references)
    cs._reset_launches()
    with torch.inference_mode():
        cs._phase(24, cs.phase24_lean, data, ref64, errs["kernel"], lean)
    cs._phase(25, cs.phase25_mesh, data, refs, dict(g64=g64, kernel_err=kernel_err))
    cs._read_launches("lean and mesh regression", ["gram", "gram_grads", "myrtle_grads"])
    print(f"[done] {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
