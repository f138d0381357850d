"""The readings that the limits of ``benchmark/limits/<cell>.json`` are set
from, on the chip at the cell's own size:

- the program's numbers on many seeds (the lower reading: their largest);
- the control's: the plain reference computed in the precision below the
  configuration's (TF32 products for float32 with TF32 off), put in the
  program's place and compared with the float64 reference by the same
  numbers (the upper reading: their smallest); in serving, TF32 in each
  request's work on the reference's float32 fit;
- for training cells, the faults of a step: ``unchanged`` (the optimizer
  leaves the state as it was) and ``half`` (half of the batch left out, the
  mean taken over the rest); for serving, ``altered`` (every answer's first
  mean moved by a tenth of the targets' scale where it is produced) and
  ``scaled`` (every variance 2% high where it is produced, as a wrong
  Student-t scale would make it).

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 ... \\
        [--control 1 2 3] [--faults half] [--fault-seeds 1 2 3] [--seconds 3]

Each reading is printed as one JSON line. A training cell's readings need
no window; a serving cell's seed serves a short window at the cell's load
(``--seconds``) and compares the requests a run compares.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from benchmark import capture, check, drive
from benchmark.reference.common import worst_leaf_gap
from benchmark.run import HERE, ROOT, find, load_module


def fault_unchanged(system):
    """The optimizer's update leaves every parameter as it was."""
    for opt in getattr(system, "opts", None) or [system.opt]:
        opt.update = lambda lr: None


def fault_half(system):
    """Half of the batch left out, the mean taken over the rest."""
    if system.batch is None:           # ML-II: the marginal of the first half of the rows
        half = system.num_train // 2
        system.model.x_data = system.model.x_data[:half]
        system.model.y_data = system.model.y_data[:half]
        return
    loss = system.model.loss

    def half_loss(x, y, num_train, num_samples, draws=None, **kw):
        from snngp_torch.ops.mvt import TDraws
        h = x.shape[0] // 2
        half = TDraws(draws.normal[..., :h], draws.gamma[..., :h])
        return loss(x[:h], y[:h], num_train, num_samples, draws=half, **kw)
    system.model.loss = half_loss


def fault_altered(system):
    """Each answer's first predictive mean moved by 0.1 y_std."""
    request = system.request
    shift = 0.1 * system.data["y_std"]

    def altered(x):
        mean, var = request(x)
        mean = mean.clone()
        mean[0] += shift
        return mean, var
    system.request = altered


def fault_scaled(system):
    """Every predictive variance 2% high."""
    request = system.request

    def scaled(x):
        mean, var = request(x)
        return mean, var * 1.02
    system.request = scaled


FAULTS = {"unchanged": fault_unchanged, "half": fault_half, "altered": fault_altered,
          "scaled": fault_scaled}


def _per_leaf(got, ref):
    return {what: {n: round(worst_leaf_gap({n: got[what][n]}, {n: ref[what][n]})[0], 6)
                   for n in ref[what]} for what in ("grad1", "change")}


def _free(system):
    for name in ("model", "opt", "opts", "fitted"):
        if hasattr(system, name):
            setattr(system, name, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def readings(spec, cell, seed, control, faults, seconds, device="cuda", config=None,
             witness=True, mix=None):
    """The program's, the control's and each fault's numbers for one seed;
    with the control also the float32 witness's (the plain reference in
    the configuration's own precision), unless ``witness`` is off."""
    if config is None:
        cfg = {c["name"]: c for c in spec["configs"]}[cell["config"]]
        config = json.loads((ROOT / cfg["file"]).read_text())
    if mix is None:
        mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    system_mod = load_module(HERE / "systems" / f"{cell['config']}.py")
    reference = load_module(HERE / "reference" / f"{cell['config']}.py")
    out = []

    def program(fault=None):
        system = system_mod.System(config, seed, device)
        if fault:
            FAULTS[fault](system)
        rec = drive.KINDS[mix["kind"]](system, mix, seed, seconds, False, device,
                                       capture.capture)
        _free(system)
        return system, rec

    limits = json.loads((HERE / "limits" / f"{cell['name']}.json").read_text())
    extra = [k for k in limits if "." in k]
    if mix["kind"] == "steps":
        system, rec = program()
        steps = len(rec.checked["terms"])
        ref = check.steps_reference(reference, config, system.data, system.recorded, steps)
        leaves = {}
        out.append(("program", check.steps_numbers(rec.checked, ref, leaves, extra)))
        if control and witness:
            plain = check.steps_reference(reference, config, system.data, system.recorded,
                                          steps, precision="float32")
            out.append(("float32", check.steps_numbers(plain, ref, extra=extra)))
            print(f"seed {seed}: float32: each leaf's own gap {_per_leaf(plain, ref)}",
                  file=sys.stderr)
        if control:
            low = check.steps_reference(reference, config, system.data, system.recorded,
                                        steps, precision="tf32")
            out.append(("control", check.steps_numbers(low, ref, extra=extra)))
            print(f"seed {seed}: control: each leaf's own gap {_per_leaf(low, ref)}",
                  file=sys.stderr)
        for fault in faults:
            _, frec = program(fault)
            out.append((fault, check.steps_numbers(frec.checked, ref, extra=extra)))
            print(f"seed {seed}: {fault}: each leaf's own gap {_per_leaf(frec.checked, ref)}",
                  file=sys.stderr)
        print(f"seed {seed}: the program's worst leaves {leaves}; terms "
              f"{rec.checked['terms']} against {ref['terms']}; each leaf's own gap "
              f"{_per_leaf(rec.checked, ref)}", file=sys.stderr)
        return out

    system, rec = program()
    picked = check.sample(rec, mix["check_requests"], seed)
    points = [rec.pool[rec.answers[i][0]:rec.answers[i][0] + rec.answers[i][1]]
              for i in picked]
    ref = check.requests_reference(reference, config, system.data, points)
    answers = [(rec.answers[i][2], rec.answers[i][3]) for i in picked]
    out.append(("program", check.requests_numbers(answers, ref)))
    if control and witness:
        plain = check.requests_reference(reference, config, system.data, points, "float32")
        out.append(("float32", check.requests_numbers(plain, ref)))
    if control:
        low = check.requests_reference(reference, config, system.data, points, "tf32")
        out.append(("control", check.requests_numbers(low, ref)))
    for fault in faults:
        _, frec = program(fault)
        fanswers = [(frec.answers[i][2], frec.answers[i][3]) for i in picked
                    if i in frec.answers]
        out.append((fault, check.requests_numbers(fanswers, ref[:len(fanswers)])))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", type=int, nargs="*", default=[])
    parser.add_argument("--faults", nargs="*", default=[], choices=sorted(FAULTS))
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=None)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--no-witness", action="store_true",
                        help="leave out the float32 witness beside the control")
    args = parser.parse_args(argv)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = find(spec, args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fault_seeds = args.seeds if args.fault_seeds is None else args.fault_seeds
    for seed in args.seeds:
        t = time.perf_counter()
        got = readings(spec, cell, seed, seed in args.control,
                       args.faults if seed in fault_seeds else [], args.seconds,
                       witness=not args.no_witness)
        for who, numbers in got:
            print(json.dumps({"workload": cell["name"], "seed": seed, "who": who,
                              "numbers": numbers}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
