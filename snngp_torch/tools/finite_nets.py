#!/usr/bin/env python3
"""The ensemble and the paper figures alone on one card: ``chip_smoke.py``'s
phases 22 and 23 with their gates, in about a minute.

    python3 snngp_torch/tools/finite_nets.py [--steps]

Prints the card's name and power limit, runs ``ens tr`` at both ``-mp``
settings and ``ens ts`` on the card and the CPU (phase 22), the three
figure panels at the notebook's sizes and the 8-member card / CPU check
(phase 23), and checks that none of K1-K7 launched.

``--steps`` also times the figures' SGD steps on 500 members at width 512,
500 steps each, eager and from a CUDA graph (eager, graph, graph, eager),
``full`` and ``last``, checks that both give the same params, and prints a
``torch.profiler`` table of 20 eager ``full`` steps (the device time by
kernel). Needs one CUDA card.
"""

import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def _steps():
    import torch
    from snngp_torch.examples import paper_figures as fig

    dev = torch.device("cuda")
    x, y, _, _ = fig._make_dataset()
    xt, yt = torch.tensor(x, device=dev), torch.tensor(y, device=dev)
    params = fig.init_members(torch.Generator(device=dev).manual_seed(10), 500)
    sigma = torch.tensor(fig.sample_sigmas(10, 1.0, 1.0, 500), dtype=torch.float32,
                         device=dev)
    warmup, runs = fig.GRAPH_WARMUP, {}
    try:
        for mode in ("eager", "graph", "graph", "eager"):
            fig.GRAPH_WARMUP = 10 ** 9 if mode == "eager" else warmup
            for last in (False, True):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fig.sgd_train(params, sigma, xt, yt, 500, 1e-3, last_only=last)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / 500 * 1e3
                runs.setdefault((mode, last), []).append(out)
                print(f"[steps] {mode} {'last' if last else 'full'}: {ms:.3f} ms a step",
                      flush=True)
        for last in (False, True):
            a, b = runs["eager", last][0], runs["graph", last][0]
            diff = max(float((pa - pb).abs().max())
                       for la, lb in zip(a, b) for pa, pb in zip(la, lb))
            print(f"[steps] {'last' if last else 'full'}: eager against graph, max |dparam| "
                  f"{diff:.3e}")
            if diff:
                raise AssertionError("the graph's params differ from the eager run's")
        fig.GRAPH_WARMUP = 10 ** 9
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fig.sgd_train(params, sigma, xt, yt, 20, 1e-3, last_only=False)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))
    finally:
        fig.GRAPH_WARMUP = warmup


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", action="store_true",
                    help="also time the figures' SGD steps, eager and from a CUDA graph")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("finite_nets: CUDA is not available")
    import chip_smoke as cs
    import snngp_torch  # noqa: F401  (precision policy)

    print(cs.card())
    t0 = time.perf_counter()
    cs._reset_launches()
    cs._phase(22, cs.phase22_ensemble)
    cs._phase(23, cs.phase23_figures)
    cs._phase("23 (members check)", cs.phase23_members_check)
    launched = cs._read_launches("ensemble + figures", [])
    if any(launched.values()):
        raise AssertionError(f"the ensemble and the figures launched {launched}")
    if args.steps:
        _steps()
    print(f"[done] {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
