"""The comparison that decides ``correct``: what the timed path produced,
against the configuration's plain reference, once the window has closed.

- ``steps``: the set-up's checked steps (the first steps of the very object
  the window drives, through its own call and feed). The reference follows
  them from the configuration's initial values on the same inputs. Numbers:
  ``<term>_gap``, the largest relative gap of a term of a step's loss
  (``loss``, and for the ELBO also ``nll``, its data term); ``grad_gap``, the
  worst leaf's gap between the norms of the first gradient (as the
  optimizer holds it after one step); ``change_gap``, the same of the
  parameters' change over the checked steps, leaving out the leaves whose
  reference gradient is under a thousandth of the median leaf's (they move
  under Adam by round-off alone); ``median_change_gap``, the median of the
  same leaves' gaps of the change, among those the reference moves. A
  leaf's gap is over the larger of its reference norm and the median
  leaf's. A cell's limits name the numbers it compares, and may also name one
  leaf's own number, ``grad_gap.<leaf>`` (its gap over its own norm), where
  the worst leaf's noise hides a fault that only that leaf shows.
- ``requests``: a sample of the requests served in the window, drawn from
  the seed, with the largest among them. Numbers: ``mean_gap`` and
  ``var_gap``, the largest gap of a predictive mean or variance over the
  largest reference value of the sample. The control serves from the
  reference's float32 fit with TF32 products in each request's cross Gram,
  solve and contractions (``requests_reference``).

``steps_numbers`` and ``requests_numbers`` read the same numbers for any
stand-in of the program (``benchmark/calibrate.py``: the control, the
faults).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.common import Arith, leaf_gaps, worst_leaf_gap
from benchmark.seeds import host_random

ROUNDOFF = 1e-3   # of the median leaf's gradient: a leaf below it moves by round-off


def steps_numbers(got, ref, leaves=None, extra=()):
    """The numbers; ``leaves`` (a dict) receives the leaf behind each
    worst-leaf number. ``extra`` names numbers of one leaf,
    ``grad_gap.<leaf>`` or ``change_gap.<leaf>``: the gap between the norms
    of that leaf on the two sides over its own reference norm."""
    numbers = {}
    for key in ref["terms"][0]:
        gaps = [abs(a[key] - b[key]) / abs(b[key]) for a, b in zip(got["terms"], ref["terms"])]
        numbers[f"{key}_gap"] = max(gaps) if all(np.isfinite(gaps)) else float("inf")
    norms = {n: float(ref["grad1"][n].norm()) for n in ref["grad1"]}
    median = float(np.median(list(norms.values())))
    still = {n for n, v in norms.items() if v < ROUNDOFF * median}
    grad_gap, grad_leaf = worst_leaf_gap(got["grad1"], ref["grad1"])
    change_gap, change_leaf = worst_leaf_gap(got["change"], ref["change"], skip=still)
    frozen = {n for n in ref["change"] if float(ref["change"][n].norm()) == 0.0}
    change_gaps = leaf_gaps(got["change"], ref["change"], skip=still | frozen)
    if leaves is not None:
        leaves.update(grad_gap=grad_leaf, change_gap=change_leaf)
    numbers.update(grad_gap=grad_gap, change_gap=change_gap,
                   median_change_gap=float(np.median(list(change_gaps.values())))
                   if change_gaps else 0.0)
    for key in extra:
        what, leaf = key.split(".", 1)
        side = {"grad_gap": "grad1", "change_gap": "change"}[what]
        mine, want = float(got[side][leaf].norm()), float(ref[side][leaf].norm())
        numbers[key] = abs(mine - want) / want if want > 0 else float("inf")
    return numbers


def steps_reference(reference, config, data, inputs, count, precision="float64"):
    return reference.train(config, data, count, inputs, precision)


def check_steps(system, reference, config, rec, extra=()):
    got = rec.checked
    ref = steps_reference(reference, config, system.data, system.recorded,
                          len(got["terms"]))
    return steps_numbers(got, ref, extra=extra)


def sample(rec, count, seed):
    """The requests compared: the largest, and others drawn from the seed."""
    done = sorted(rec.answers)
    largest = max(done, key=lambda i: rec.answers[i][1])
    rest = [i for i in done if i != largest]
    host_random(seed, "check").shuffle(rest)
    return [largest] + sorted(rest[:count - 1])


def requests_numbers(answers, ref_answers):
    dm = max(float(np.max(np.abs(a[0] - r[0]))) for a, r in zip(answers, ref_answers))
    dv = max(float(np.max(np.abs(a[1] - r[1]))) for a, r in zip(answers, ref_answers))
    sm = max(float(np.max(np.abs(r[0]))) for r in ref_answers)
    sv = max(float(np.max(np.abs(r[1]))) for r in ref_answers)
    gaps = {"mean_gap": dm / sm, "var_gap": dv / sv}
    return {k: (v if np.isfinite(v) else float("inf")) for k, v in gaps.items()}


def requests_reference(reference, config, data, points, precision="float64"):
    """The reference's (mean, var) for each [m, D] host array of ``points``.
    The control, ``precision`` "tf32", fits in float32 (a TF32 factor of the
    N x N Gram fails) and serves with TF32 products: the precision below
    the configuration's, in the work that each request does."""
    if precision == "tf32":
        state = dict(reference.fit(config, data, "float32"), ar=Arith("tf32"))
    else:
        state = reference.fit(config, data, precision)
    out = []
    dev = data["x"].device
    for xs in points:
        mean, var = reference.predict(state, torch.from_numpy(xs).to(dev))
        out.append((mean.double().cpu().numpy(), var.double().cpu().numpy()))
    return out


def check_requests(system, reference, config, rec, count, seed):
    picked = sample(rec, count, seed)
    answers = [(rec.answers[i][2], rec.answers[i][3]) for i in picked]
    points = [rec.pool[rec.answers[i][0]:rec.answers[i][0] + rec.answers[i][1]]
              for i in picked]
    return requests_numbers(answers, requests_reference(reference, config, system.data,
                                                        points))
