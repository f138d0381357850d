"""The one general generator of traffic. A mix (``traffic/<name>.json``)
names its kind and parameters; the kind's function makes the work from the
seed, runs the set-up's part of it, and then drives the system for the
window. Two kinds:

- ``steps``: training steps in a closed loop, each loss read on the host
  (a step returns its loss's terms as host numbers, ``{"loss": ...}``).
  ``feed`` is ``full`` (every step on the whole training set) or
  ``shuffled`` (batches of the system's size from a seeded reshuffle of the
  training set each epoch, as ``DataLoader(shuffle=True)`` draws them; only
  whole batches). The first ``checked_steps`` steps run in the set-up
  through the same call and feed; their loss terms, the first gradient as the
  optimizer holds it, and the parameters' change over them are what the
  comparison reads.
- ``requests``: one client sending requests back to back, each waiting for
  its reply. Each request is what ``reg ts`` sends: the test split of the
  configuration's data, ``test_per_train`` test points for each training
  row (the 0.8 / 0.1 / 0.1 split: 0.125), in one ``predict`` call. Request
  i sends block i mod ``pool_requests`` of a pool of test points made on
  the device from the seed and held on the host, as a client holds its
  payload. The set-up fits the model and serves
  ``warm_requests`` requests.

Both kinds drive one client in a closed loop: a step or request is sent
when the last has finished.

In a traced run (``--trace 1``) the window opens with one profiler capture
of whole steps or requests lasting ``capture_seconds``; the rest of the
window runs plain (requests) or with the port's ``Profiler`` phases
(steps), which wait for the device at every phase boundary.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark.seeds import generator, host_random


class Records:
    """What a run hands the metrics and the comparison."""

    def __init__(self, kind):
        self.kind = kind
        self.window_start = None     # host clock, after the set-up
        self.window_s = None
        self.units = []              # per unit: dict(start, end, points, work, ok)
        self.checked = None          # the steps' snapshot (steps)
        self.answers = {}            # request index -> (points offset, m, mean, var)
        self.capture = None          # benchmark.capture.Capture of the traced stretch
        self.captured = 0            # units inside the capture
        self.phases = None           # Profiler totals over the rest of the window
        self.profiled = 0            # units under the Profiler
        self.rest_points = 0         # points served after the capture (requests)
        self.rest_s = None
        self.pool = None             # the requests' test points, on the host


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def feeds(mix, system, seed):
    """The feed of every step, in order."""
    if mix["feed"] == "full":
        while True:
            yield None
    n, batch = system.num_train, system.batch
    epoch = 0
    while True:
        order = list(range(n))
        host_random(seed, f"epoch{epoch}").shuffle(order)
        for i in range(0, n - batch + 1, batch):
            yield np.asarray(order[i:i + batch], dtype=np.int64)
        epoch += 1


def run_steps(system, mix, seed, seconds, trace, device, capture_fn):
    rec = Records("steps")
    feed = feeds(mix, system, seed)
    checked = mix["checked_steps"]
    system.record = checked
    p0 = system.params()
    terms, grad1 = [], None
    for i in range(checked):
        terms.append(system.step(next(feed)))
        if i == 0:
            grad1 = system.optimizer_grads()
    p_end = system.params()
    rec.checked = {"terms": terms, "grad1": grad1,
                   "change": {n: p_end[n] - p0[n] for n in p0}}
    work = system.step_work()
    _sync(device)

    def one():
        t = time.perf_counter()
        with torch.profiler.record_function("bench.step"):
            loss = system.step(next(feed), prof)["loss"]
        rec.units.append(dict(start=t, end=time.perf_counter(), points=0, work=work,
                              ok=math.isfinite(loss)))

    prof = None
    rec.window_start = time.perf_counter()
    if trace:
        def stretch():
            t = time.perf_counter()
            while not rec.units or time.perf_counter() - t < mix["capture_seconds"]:
                one()
        rec.capture = capture_fn(stretch, system.launches)
        rec.captured = len(rec.units)
        from snngp_torch.utils import Profiler
        prof = Profiler()
    while time.perf_counter() - rec.window_start < seconds:
        one()
    _sync(device)
    rec.window_s = time.perf_counter() - rec.window_start
    if prof is not None:
        rec.profiled = len(rec.units) - rec.captured
        rec.phases = dict(prof.totals)
    return rec


def run_requests(system, mix, seed, seconds, trace, device, capture_fn):
    rec = Records("requests")
    m = round(mix["test_per_train"] * system.num_train)
    cycle = mix["pool_requests"]
    d = system.data["x"].shape[1]
    gen = generator(seed, "requests", device)
    pool = torch.randn(cycle * m, d, generator=gen, device=device).cpu().numpy()
    system.fit()
    work = system.request_work(m)

    def serve(i, keep):
        off = (i % cycle) * m
        xs = pool[off:off + m]
        t = time.perf_counter()
        with torch.profiler.record_function("bench.request"):
            mean, var = system.request(torch.from_numpy(xs).to(device))
            mean, var = mean.cpu().numpy(), var.cpu().numpy()
        end = time.perf_counter()
        if keep:
            rec.answers[i] = (off, m, mean, var)
            rec.units.append(dict(start=t, end=end, points=m, work=work,
                                  ok=bool(np.isfinite(mean).all() and np.isfinite(var).all())))
        return end

    for i in range(mix["warm_requests"]):
        serve(i, False)
    _sync(device)
    rec.window_start = time.perf_counter()
    count = 0
    if trace:
        def stretch():
            nonlocal count
            t = time.perf_counter()
            while count == 0 or time.perf_counter() - t < mix["capture_seconds"]:
                serve(count, True)
                count += 1
        rec.capture = capture_fn(stretch, system.launches)
        rec.captured = count
    rest = time.perf_counter()
    end = rest
    while end - rec.window_start < seconds:
        end = serve(count, True)
        count += 1
    rec.window_s = end - rec.window_start
    rec.rest_s = end - rest
    rec.rest_points = sum(u["points"] for u in rec.units[rec.captured:])
    rec.pool = pool
    return rec


KINDS = {"steps": run_steps, "requests": run_requests}
