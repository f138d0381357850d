#!/usr/bin/env python3
"""Loops of ``torch.profiler`` captures in fresh processes, importing only
``torch``: whether a capture loses the card's kernel records, and after
what.

    python3 snngp_torch/tools/trace_repro.py [--captures 24] [--k1]

Each case runs in a process of its own, with an environment of its own
(``TEARDOWN_CUPTI`` / ``DISABLE_CUPTI_LAZY_REINIT``, read by Kineto, the
profiler's back end), and makes ``--captures`` captures of one small
kernel, with some work between them:

- ``none``: nothing;
- ``gpu``: 200 ms of matrix products, not profiled;
- ``libs``: a cuSOLVER factorization, an eigensolver, a cuDNN convolution
  and an FFT, not profiled;
- ``heavy``: one capture of 3,000 small kernels (a training step's worth
  of records), then the loop of small captures;
- ``graph``: a CUDA graph captured once, replayed between the captures;
- ``many``: 250,000 launches of a one-element kernel between the captures
  (a long process's count of launches: K7's plain versions launch ~120,000
  kernels a Gram block);
- ``memory``: all but 2 GiB of the card's free memory held in one tensor
  through the captures;
- ``age``: ``--gap`` seconds (default 15) of matrix products between the
  captures, each product waited for;
- ``idle``: ``--gap`` seconds of sleep between the captures.

The small kernel is one elementwise op (one launch), add, mul and sub in
turn (``--kernels`` of them a capture, which stays open ``--pad`` seconds
after they end). For every capture the
case prints its kernel records (copies and fills left out) against its
host launch calls (a whole capture holds as many records as launches, and
a record that reached the wrong capture would show as more), the first
record's start less the first launch call's (``skew_us``) and its seconds
into the loop. ``--k1``
launches the repo's K1 (``snngp_torch.ops.gram``, built from
``csrc/gram.cu``: 24 launches with its per-row factors) as the small
kernel instead, which imports the port. One JSON line a case, then a
summary. Needs one CUDA card; ~13 min for a run of the cases but ``age``
and ``idle``, which take ``--gap`` seconds a capture: run them alone
(``--case age``). ``--case C`` runs one
case in this process and prints its JSON line.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CASES = ["none", "gpu", "libs", "heavy", "graph", "many", "memory", "age", "idle"]
MANY = 250_000
ENVS = {"default": {}, "TEARDOWN_CUPTI=0": {"TEARDOWN_CUPTI": "0"},
        "DISABLE_CUPTI_LAZY_REINIT=1": {"DISABLE_CUPTI_LAZY_REINIT": "1"}}
OPS = ["add", "mul", "sub"]


def _records(prof):
    """(the card's kernel records, host launch calls, the first record's
    start less the first launch call's in us, None without a record)."""
    import torch
    events = prof.events()
    card = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]
    calls = [e for e in events if "LaunchKernel" in e.name]
    skew = (min(e.time_range.start for e in card) - min(e.time_range.start for e in calls)
            if card and calls else None)
    return card, len(calls), skew


def run_case(case, captures, k1, gap=15.0, kernels=1, pad=0.0):
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    x = torch.randn(2048, 16, device="cuda")
    one = torch.zeros(1, device="cuda")
    a = torch.randn(4096, 4096, device="cuda")
    if k1:
        sys.path.insert(0, str(REPO))
        from snngp_torch.ops import gram as G

    def small(i):
        if k1:
            G.mlp_gram(x, x, depth=4, act="relu", w_std=1.0, b_std=0.3, last_w_std=1.0)
        else:
            getattr(torch, OPS[i % 3])(x, 1.5)

    held = None
    if case == "memory":
        free, _ = torch.cuda.mem_get_info()
        held = torch.empty(free - (2 << 30), dtype=torch.uint8, device="cuda")
    graph = None
    if case == "graph":
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            b = a @ a
        torch.cuda.current_stream().wait_stream(s)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            b = a @ a
            b.mul_(0.5)

    def between():
        if case == "gpu":
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.2:
                a @ a
            torch.cuda.synchronize()
        elif case == "age":
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < gap:
                a @ a
                torch.cuda.synchronize()
        elif case == "idle":
            time.sleep(gap)
        elif case == "libs":
            s = a @ a.T / 4096 + torch.eye(4096, device="cuda")
            torch.linalg.cholesky(s)
            torch.linalg.eigvalsh(s[:512, :512])
            torch.nn.functional.conv2d(torch.randn(8, 3, 32, 32, device="cuda"),
                                       torch.randn(16, 3, 3, 3, device="cuda"))
            torch.fft.rfft(a)
            torch.cuda.synchronize()
        elif case == "graph":
            graph.replay()
            torch.cuda.synchronize()
        elif case == "many":
            for _ in range(MANY):
                one.add_(1.0)
            torch.cuda.synchronize()

    out = {"case": case, "env": {k: os.environ.get(k) for k in
                                 ("TEARDOWN_CUPTI", "DISABLE_CUPTI_LAZY_REINIT")},
           "torch": torch.__version__, "cuda": torch.version.cuda, "captures": [],
           "held_bytes": 0 if held is None else held.numel()}
    small(0)
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    if case == "heavy":
        with profile(activities=acts) as prof:
            for i in range(3000):
                x.add_(0.0)
            torch.cuda.synchronize()
        card, launches, _ = _records(prof)
        out["heavy"] = [len(card), launches]
    for i in range(captures):
        between()
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            for _ in range(kernels):
                small(i)
            torch.cuda.synchronize()
            time.sleep(pad)
        card, launches, skew = _records(prof)
        out["captures"].append({"kernels": len(card), "launches": launches, "skew_us": skew,
                                "at_s": round(time.perf_counter() - t_start, 1)})
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--captures", type=int, default=24)
    ap.add_argument("--k1", action="store_true", help="capture the repo's K1")
    ap.add_argument("--case", choices=CASES, help="run one case in this process")
    ap.add_argument("--gap", type=float, default=15.0,
                    help="seconds between captures of the age and idle cases")
    ap.add_argument("--kernels", type=int, default=1, help="small kernels a capture")
    ap.add_argument("--pad", type=float, default=0.0,
                    help="seconds a capture stays open after its kernels end")
    args = ap.parse_args()
    if args.case:
        print(json.dumps(run_case(args.case, args.captures, args.k1, args.gap, args.kernels,
                                  args.pad)), flush=True)
        return 0
    summary = []
    for env_name, env in ENVS.items():
        for case in CASES[:-2]:
            cmd = [sys.executable, __file__, "--case", case, "--captures", str(args.captures)]
            if args.k1:
                cmd.append("--k1")
            proc = subprocess.run(cmd, env={**os.environ, **env}, capture_output=True,
                                  text=True, timeout=600)
            if proc.returncode != 0:
                print(f"[repro] {env_name} {case}: exit {proc.returncode}\n"
                      f"{proc.stderr[-3000:]}", flush=True)
                summary.append((env_name, case, "failed"))
                continue
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            caps = res["captures"]
            whole = sum(c["kernels"] == c["launches"] for c in caps)
            empty = sum(c["kernels"] == 0 for c in caps)
            extra = sum(c["kernels"] > c["launches"] for c in caps)
            print(f"[repro] {env_name} {case}: " + json.dumps(res), flush=True)
            print(f"[repro] {env_name} {case}: {whole}/{len(caps)} whole, {empty} empty, "
                  f"{extra} with more records than launches; per capture (kernels/"
                  "launches): " + " ".join(f"{c['kernels']}/{c['launches']}" for c in caps),
                  flush=True)
            summary.append((env_name, case, f"{whole}/{len(caps)} whole, {empty} empty"))
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
