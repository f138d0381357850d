#!/usr/bin/env python3
"""Build, check and time K1 and K2 (``csrc/gram.cu``: ``gram_kernel``,
``gram_grads_kernel``) alone, in a few minutes on one card.

    python3 snngp_torch/tools/gram_kernels.py [--step] [--tree DIR]
                                              [--blocks K1:K2 ...]

Prints the card's name and power limit and the ptxas report of every
instantiation (registers, spills), runs ``chip_smoke.py``'s phases 1 and 4
with their gates (every K1 case within 1e-5 of max|K| of the plain version,
every K2 sum within 1e-5 of sum |g dK|), then times both kernels, by CUDA
events around a loop of launches, at the heads (10,000 x 16 against itself,
depth 4, the four mode / act variants; K2 on a random cotangent) and at the
serving request's cross shape (1,000 x 10,000), beside their bounds.

``--step`` also times ten ML-II steps (N = 10,000, D = 16, depth-4 ReLU MLP,
Student-t; split by phase) and three serving fits with four 1,000-point
requests each, after a warm-up, at ``chip_smoke.py``'s shapes.

``--tree DIR`` takes ``snngp_torch`` and ``chip_smoke.py`` from another
checkout (a parent commit, unpacked with ``git archive``), so that one call
can time both trees in turns (parent, change, change, parent); a tree whose
wrappers take no ``same`` runs every pair of K(x, x).

``--blocks K1:K2 ...`` builds copies of ``gram.cu`` with other minimum
blocks an SM in the kernels' ``__launch_bounds__`` (``kGramBlocks``,
``kGradsBlocks``) into ``build/gram_blocks/`` and times the heads of each
build and of the tree's own in alternating order (checks skipped).

Needs nvcc and one CUDA card.
"""

import argparse
import inspect
import statistics
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
HEAD_N, CROSS_N1 = 10_000, 1_000
REPS = 20


def _same_kw(fn, same):
    """``same=True`` where the tree's wrapper takes it."""
    return {"same": True} if same and "same" in inspect.signature(fn).parameters else {}


def _cases(cs, G):
    """(label, K1 call, K2 call, K1 bound, K2 bound) at the heads and the
    cross shape, mlp / resnet x relu / erf."""
    import torch

    rng = np.random.RandomState(11)
    x = torch.as_tensor(rng.randn(HEAD_N, cs.SERVE_D).astype(np.float32), device="cuda")
    xq = torch.as_tensor(rng.randn(CROSS_N1, cs.SERVE_D).astype(np.float32), device="cuda")
    g_head = torch.as_tensor(rng.randn(HEAD_N, HEAD_N).astype(np.float32), device="cuda")
    g_cross = g_head[:CROSS_N1].contiguous()
    out = []
    for mode in ("mlp", "resnet"):
        for act in ("relu", "erf"):
            for shape, (a, b, g) in (("head", (x, x, g_head)), ("cross", (xq, x, g_cross))):
                sym = b is a
                args = cs._k2_inputs(a, b, mode, act)
                if sym:   # one tensor for both operands, as _Gram passes them
                    args[1], args[3], args[5] = args[0], args[2], args[4]
                kw = dict(depth=cs.DEPTH, act=act, mode=mode)
                k1_args = (*args[:4], args[6][:4].contiguous())
                k1_kw = {**kw, **_same_kw(G.gram_cuda, sym)}
                k2_kw = {**kw, **_same_kw(G.gram_grads_cuda, sym)}
                n1, n2, d = a.shape[0], b.shape[0], a.shape[1]
                k1_bound = cs.bound_ms(cs._read_bytes(k1_args) + n1 * n2 * 4,
                                       cs.k1_ops(n1, n2, d, cs.DEPTH, act, mode, sym))
                k2_bound = cs.bound_ms(cs._read_bytes(args) + g.numel() * 4,
                                       *cs.k2_ops(n1, n2, d, cs.DEPTH, act, mode, sym))
                out.append((f"{mode}/{act}/{shape} {n1}x{n2}",
                            lambda k1_args=k1_args, k1_kw=k1_kw: G.gram_cuda(*k1_args, **k1_kw),
                            lambda args=args, g=g, k2_kw=k2_kw: G.gram_grads_cuda(*args, g, **k2_kw),
                            k1_bound, k2_bound))
    return out


def _time_cases(cs, cases, label=""):
    """Prints each kernel's mean time over REPS launches (CUDA events)."""
    for name, k1, k2, k1_bound, k2_bound in cases:
        for kernel, fn, (bound, by) in (("K1", k1, k1_bound), ("K2", k2, k2_bound)):
            ms = cs._time_ms(fn, reps=REPS)
            print(f"[gram]{label} {kernel} {name:26s} {ms:.4f} ms  bound {bound:.4f} ms ({by}, "
                  f"{100 * bound / ms:.2f}%)")


def _variant(k1_blocks, k2_blocks, build, own):
    """gram.cu with other __launch_bounds__ minimum blocks, built and loaded,
    with the ctypes signatures of ``own`` (the tree's library)."""
    from snngp_torch.ops import _build
    lib, report = _build.build_variant(
        "gram", {"kGramBlocks": k1_blocks, "kGradsBlocks": k2_blocks},
        build / f"gram_{k1_blocks}_{k2_blocks}.so")
    for line in report:
        print(f"[blocks {k1_blocks}:{k2_blocks}] ptxas {line}")
    for fn in ("snngp_gram_f32", "snngp_gram_grads_f32", "snngp_gram_blocks",
               "snngp_error_string"):
        getattr(lib, fn).argtypes = getattr(own, fn).argtypes
        getattr(lib, fn).restype = getattr(own, fn).restype
    return lib


def _blocks(cs, G, specs):
    """The heads of the tree's build and of each variant, in alternating
    order (two rounds)."""
    libs = {"tree": G._gram_lib()}
    for spec in specs:
        k1_blocks, k2_blocks = (int(v) for v in spec.split(":"))
        libs[spec] = _variant(k1_blocks, k2_blocks, REPO / "build" / "gram_blocks", libs["tree"])
    cases = [c for c in _cases(cs, G) if "/head" in c[0]]
    own = G._gram_lib
    try:
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                G._gram_lib = lambda lib=libs[name]: lib  # noqa: E731
                _time_cases(cs, cases, label=f" [{name}]")
    finally:
        G._gram_lib = own


def _ml2_steps(cs, data, steps=10):
    """Ten warm ML-II steps (lr 0: the parameters stay as fitted), each split
    by phase on the synchronized host clock."""
    import torch
    from snngp_torch.utils import Adam, Profiler, train_step

    x, y, _, y_mean, y_std = data
    model = cs._model(x, y, y_mean, y_std, fused=True, dtype=torch.float32, eps=cs.TRAIN_EPS)
    opt = Adam(model)
    for _ in range(2):
        train_step(model, opt, 0.0)
    cs._sync()
    totals, phases = [], {}
    for _ in range(steps):
        prof = Profiler()
        train_step(model, opt, 0.0, prof)
        for k, v in prof.totals.items():
            phases.setdefault(k, []).append(1e3 * v)
        totals.append(1e3 * sum(prof.totals.values()))
    print(f"[step] ML-II step: median {statistics.median(totals):.3f} ms, min "
          f"{min(totals):.3f}, max {max(totals):.3f} over {steps}; phases (median) "
          + "  ".join(f"{k} {statistics.median(v):.3f}" for k, v in phases.items()))


def _serving(cs, data, reps=3):
    """Serving fits (Gram, factorization) and four 1,000-point requests
    each, after one warm-up serve."""
    import torch

    x, y, x_req, y_mean, y_std = data
    cs._warm_up(data)
    for i in range(reps):
        model = cs._model(x, y, y_mean, y_std, fused=True, dtype=torch.float32)
        _, _, t = cs._serve(model, x_req, timed=False)
        print(f"[step] serve {i}: fit gram {1e3 * t['gram_s']:.3f} ms  cholesky+solves "
              f"{1e3 * t['factor_s']:.3f} ms  requests "
              + " ".join(f"{1e3 * s:.3f}" for s in t["request_s"]) + " ms")
        del model


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--step", action="store_true",
                    help="also time ML-II steps and serving fits / requests")
    ap.add_argument("--tree", type=Path, default=REPO,
                    help="the checkout whose snngp_torch and chip_smoke.py run")
    ap.add_argument("--blocks", nargs="*", default=[], metavar="K1:K2",
                    help="time builds with these __launch_bounds__ minimum blocks")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.tree.resolve()))

    import torch

    if not torch.cuda.is_available():
        print("gram_kernels: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from snngp_torch.ops import _build
    from snngp_torch.ops import gram as G

    print(cs.card())
    print(f"[gram] tree {args.tree.resolve()}")
    t0 = time.perf_counter()
    _build.load("gram")
    print(f"[gram] gram.cu built in {time.perf_counter() - t0:.1f} s")
    for line in _build.ptxas_report("gram"):
        print(f"ptxas gram: {line}")

    if args.blocks:
        with torch.inference_mode():
            _blocks(cs, G, args.blocks)
        return 0
    data = cs._serving_data()
    with torch.inference_mode():
        t0 = time.perf_counter()
        cs.phase1_kernel_vs_plain()
        print(f"[gram] phase 1 checked in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    x_train, cot = cs.ml2_cotangent(data)
    with torch.inference_mode():
        cs.phase4_k2_vs_plain(x_train, cot)
        print(f"[gram] phase 4 checked in {time.perf_counter() - t0:.1f} s")
        del x_train, cot
        _time_cases(cs, _cases(cs, G))
    if args.step:
        _ml2_steps(cs, data)
        _serving(cs, data)
    return 0


if __name__ == "__main__":
    sys.exit(main())
