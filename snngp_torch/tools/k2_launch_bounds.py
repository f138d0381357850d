#!/usr/bin/env python3
"""Time K2 (``csrc/gram.cu``) built three ways that differ only in the
``__launch_bounds__`` of ``gram_grads_kernel``: the default (ptxas picks the
register count), ``(256, 1)`` and ``(256, 2)``; on one card, in one process,
at 10,000 x 16, depth 4, two rounds in alternating order.

    python3 snngp_torch/tools/k2_launch_bounds.py

Prints each build's ptxas report for K2 and, per instance, the times of
every build and whether the three builds' sums agree bitwise. The builds go
to ``build/k2_launch_bounds/``. Needs nvcc and one CUDA card.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from snngp_torch.ops import _build  # noqa: E402
from snngp_torch.ops import gram as G  # noqa: E402

BOUNDS = {"default": "(kThreads)", "min 1 block": "(kThreads, 1)",
          "min 2 blocks": "(kThreads, 2)"}
DECL = "__global__ void __launch_bounds__(kThreads)\ngram_grads_kernel("


def _build_variant(name, bounds, src, out_dir):
    cu = out_dir / f"gram_{name.replace(' ', '_')}.cu"
    cu.write_text(src.replace(DECL, f"__global__ void __launch_bounds__{bounds}\n"
                                    "gram_grads_kernel("))
    so = cu.with_suffix(".so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr)
    lines = proc.stdout.splitlines() + proc.stderr.splitlines()
    report = [f"{lines[i - 1].strip()}, {line.split(':', 1)[1].strip()}"
              for i, line in enumerate(lines)
              if "registers" in line and i >= 2 and "gram_grads" in lines[i - 2]]
    print(f"{name}: " + " | ".join(report))
    lib = ctypes.CDLL(str(so))
    lib.snngp_gram_grads_f32.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.snngp_gram_grads_f32.restype = ctypes.c_int
    lib.snngp_error_string.argtypes = [ctypes.c_int]
    lib.snngp_error_string.restype = ctypes.c_char_p
    return lib


def main():
    if not torch.cuda.is_available():
        print("k2_launch_bounds: CUDA is not available", file=sys.stderr)
        return 2
    src = (REPO / "snngp_torch" / "csrc" / "gram.cu").read_text()
    if src.count(DECL) != 1:
        raise RuntimeError("gram_grads_kernel's declaration changed; update DECL")
    out_dir = REPO / "build" / "k2_launch_bounds"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: _build_variant(name, b, src, out_dir) for name, b in BOUNDS.items()}
    rng = np.random.RandomState(0)
    with torch.inference_mode():
        x = torch.as_tensor(rng.randn(10_000, 16).astype(np.float32), device="cuda")
        g = torch.as_tensor(rng.randn(10_000, 10_000).astype(np.float32), device="cuda")
        for mode in ("mlp", "resnet"):
            for act in ("relu", "erf"):
                args = cs._k2_inputs(x, x, mode, act)
                kw = dict(depth=cs.DEPTH, act=act, mode=mode)
                times, sums = {name: [] for name in libs}, {}
                for order in (list(libs), list(libs)[::-1]):
                    for name in order:
                        G._gram_lib = lambda lib=libs[name]: lib  # noqa: E731
                        sums[name] = G.gram_grads_cuda(*args, g, **kw)
                        times[name].append(cs._time_ms(
                            lambda: G.gram_grads_cuda(*args, g, **kw), reps=10))
                same = all(torch.equal(s, sums["default"]) for s in sums.values())
                print(f"{mode}/{act}: " + "  ".join(
                    f"{name} {' '.join(f'{t:.4f}' for t in ts)} ms"
                    for name, ts in times.items()) + f"  sums bitwise equal: {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
