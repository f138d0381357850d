#!/usr/bin/env python3
"""Run ``chip_smoke.py`` with a ``torch.profiler`` probe after every phase,
to see when in a long process the profiler stops recording the card's
kernels.

    python3 snngp_torch/tools/trace_probe.py > build/trace_probe.log

After each phase the probe captures one K1 launch (K(x, x) of 2,048 x 16)
three times: with no pause, and with 20 ms and 200 ms of sleep before and
after the launch inside the capture. For each capture it prints the
card's records against the host's kernel launch calls (the card's
records include the launch's three host-to-device copies, so a whole
capture shows 27 / 24), whether K1's ``gram_kernel`` is among them, and
the first record's start less the first launch call's. The probe's K1
launches are taken back out of the smoke's launch counts. Needs nvcc and
one CUDA card; takes the smoke's time plus about a second a phase.
"""

import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]


def probe(smoke, tag):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from snngp_torch.ops import gram as G

    x = torch.as_tensor(np.random.RandomState(30).randn(2048, 16).astype(np.float32),
                        device="cuda")

    def once(pad):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            G.mlp_gram(x, x, depth=smoke.DEPTH, act="relu", w_std=smoke.W_STD,
                       b_std=smoke.B_STD, last_w_std=smoke.LAST_W_STD)
            torch.cuda.synchronize()
            time.sleep(pad)
        events = prof.events()
        card = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        calls = [e for e in events if "LaunchKernel" in e.name]
        skew = (min(e.time_range.start for e in card) - min(e.time_range.start for e in calls)
                if card and calls else float("nan"))
        gram = any("gram_kernel" in e.name for e in card)
        return (f"pad {pad}: card records {len(card)}/{len(calls)} launches, gram {gram}, "
                f"first record - first launch {skew:.1f} us")

    saved = G.LAUNCHES["gram"]
    parts = [once(pad) for pad in (0.0, 0.02, 0.2)]
    G.LAUNCHES["gram"] = saved
    print(f"[probe] after {tag}: " + " | ".join(parts), flush=True)


def main():
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke

    run = smoke._phase

    def phase(number, fn, *args):
        out = run(number, fn, *args)
        probe(smoke, number)
        return out

    smoke._phase = phase
    return smoke.main()


if __name__ == "__main__":
    sys.exit(main())
