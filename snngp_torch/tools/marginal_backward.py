#!/usr/bin/env python3
"""Time the ML-II marginal's backward and the inverse it takes, alone, on
one card.

    python3 snngp_torch/tools/marginal_backward.py [--n 10000] [--reps 5]

Prints the card's name and power limit, then, by CUDA events around each
call (fp32, TF32 off, after a warm-up), at N x N:

- S^-1 from the lower factor L: ``inverse_from_factor`` (the port's, by
  block columns, 2 N^3 / 3 flops of matrix products) at three block sizes
  and ``torch.cholesky_inverse`` (two triangular solves, 2 N^3);
- the backward of ``multivariate_t_logpdf`` through ``quad_logdet``'s
  closed form and, with ``chol_fn=cholesky``, autograd through the factor
  (the route the closed form replaces), each after its own forward;
- each inverse's and each route's gradient against float64, as max |err|
  over max |float64 value|;
- a ``torch.profiler`` table of the kernels of one closed-form backward and
  of one ``torch.cholesky_inverse``.

Needs one CUDA card.
"""

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def _time_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _row(label, times, flops=None):
    med = statistics.median(times)
    rate = f"  {flops / med / 1e9:.1f} TFLOP/s" if flops else ""
    print(f"{label:<46} median {med:9.3f} ms  [{min(times):.3f} - {max(times):.3f}]{rate}",
          flush=True)
    return med


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=10_000)
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from snngp_torch.ops import linalg as L
    from snngp_torch.ops.mvt import multivariate_t_logpdf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; N = {args.n}")

    n, dev = args.n, "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(n, n, generator=gen, device=dev)
    s = torch.addmm(torch.eye(n, device=dev), a, a.mT, alpha=1.0 / n)
    del a
    chol = torch.linalg.cholesky(s)
    ref = torch.cholesky_inverse(chol.double())
    scale = ref.abs().max()

    def err(m):
        return float((m.double() - ref).abs().max() / scale)

    flops = 2 * n ** 3 / 3
    print("\nS^-1 from the factor (2 N^3 / 3 flops for the rate):")
    kept = L._BLOCK
    for block in (256, 512, 1024):
        L._BLOCK = block
        label = f"inverse_from_factor, block {block}" + (" (kept)" if block == kept else "")
        _row(label, _time_ms(lambda: L.inverse_from_factor(chol), args.reps), flops)
        print(f"{'':<46} error {err(L.inverse_from_factor(chol)):.3e}")
    L._BLOCK = kept
    _row("torch.cholesky_inverse", _time_ms(lambda: torch.cholesky_inverse(chol), args.reps),
         flops)
    print(f"{'':<46} error {err(torch.cholesky_inverse(chol)):.3e}")

    print("\nbackward of multivariate_t_logpdf (S, x, loc, df):")
    x = torch.randn(n, generator=gen, device=dev)
    loc = 0.1 * torch.randn(n, generator=gen, device=dev)
    df = torch.tensor(4.0, device=dev)

    def grads(route, dtype=torch.float32):
        leaves = [t.detach().to(dtype).requires_grad_() for t in (s, x, loc, df)]
        kw = {"chol_fn": L.cholesky} if route == "autograd" else {}
        val = multivariate_t_logpdf(leaves[1], leaves[2], leaves[0], leaves[3], **kw)
        return val, leaves

    want = torch.autograd.grad(*grads("autograd", torch.float64))
    for route in ("closed", "autograd"):
        times = []
        for _ in range(args.reps + 1):
            val, leaves = grads(route)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            got = torch.autograd.grad(val, leaves)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        _row(f"{route} backward", times[1:])
        errs = [float((g.double() - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]
        print(f"{'':<46} loss {val.item():.9g}; errors (S, x, loc, df) "
              + ", ".join(f"{e:.3e}" for e in errs))
        del got, val, leaves

    from torch.profiler import ProfilerActivity, profile

    for label in ("closed-form backward", "torch.cholesky_inverse"):
        val, leaves = grads("closed")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if label == "closed-form backward":
                torch.autograd.grad(val, leaves)
            else:
                torch.cholesky_inverse(chol)
            torch.cuda.synchronize()
        print(f"\nkernels of one {label}:")
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=14,
                                        max_name_column_width=70))

    return 0


if __name__ == "__main__":
    sys.exit(main())
