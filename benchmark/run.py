"""The benchmark of snngp_torch: one cell of ``BENCHMARK.json``, on the
machine it is started on.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The harness is driven by names. A cell names a configuration and a traffic
mix; it finds

- ``benchmark/configs/<config>.json``: the configuration as it is run,
- ``benchmark/systems/<config>.py``: how the program (``snngp_torch``) is
  built for it, and how the benchmark makes its data from the seed,
- ``benchmark/reference/<config>.py``: its plain reference,
- ``benchmark/traffic/<mix>.json``: the mix, read by ``benchmark.drive``,
- ``benchmark/limits/<cell>.json``: the limit of each number compared,
- ``benchmark/metrics/<metric>.py``: the metric's reader; a metric named
  ``<family>.<cell>`` without a file of its own is read by its family's
  ``benchmark/metrics/<family>.py``.

With ``--trace 0`` it reports the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics from one profiler capture (and the
``Profiler`` phases after it). It exits 2 without enough CUDA cards, and 4
if ``jax``, ``jaxlib``, ``flax`` or the JAX package ``snngp`` (compared by
whole top-level module name) is loaded once the window has closed; then it
prints no result. Its last line on standard output is the result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "snngp"})
PROGRAM_STATE = ("model", "opt", "opts", "fitted")


def load_module(path):
    """A module from a file named after a cell, configuration or metric."""
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.stem}".replace(".", "_")
                                                  .replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules(names=None):
    """Loaded modules whose top-level name is one of FORBIDDEN, whole:
    ``snngp_torch`` is not ``snngp``."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)


def reader(name):
    """The reader of metric ``name``: its own file, or its family's."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path).read


def find(spec, workload):
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; it has {sorted(cells)}")
    return cells[workload]


def reported(spec, cell, trace):
    """The metrics this cell reports: with ``trace`` its per-layer ones."""
    def listed(m):
        return "workloads" not in m or cell["name"] in m["workloads"]
    e2e = [m for m in spec["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in names)]


def finite(value):
    """``value`` with every float that is not finite (a gap read as NaN or
    infinity) replaced by None: the result line is strict JSON."""
    if isinstance(value, dict):
        return {k: finite(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [finite(v) for v in value]
    if isinstance(value, float) and not math.isfinite(value):
        return None
    return value


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def run_cell(spec, cell, seed, seconds, trace, device, config=None, mix=None, t0=None,
             patch=None):
    """One run of ``cell``: set-up, window, metrics, then the comparison.
    ``config`` and ``mix`` replace the files' contents, and ``patch(system)``
    changes the system before its set-up (the tests' small sizes and
    planted faults on the CPU)."""
    import torch

    from benchmark import capture, check, drive

    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    if config is None:
        config = json.loads((ROOT / cfg_entry["file"]).read_text())
    if mix is None:
        mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{cell['name']}.json").read_text())
    system_mod = load_module(HERE / "systems" / f"{cell['config']}.py")
    reference = load_module(HERE / "reference" / f"{cell['config']}.py")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    system = system_mod.System(config, seed, device)
    if patch is not None:
        patch(system)
    rec = drive.KINDS[mix["kind"]](system, mix, seed, seconds, trace, device,
                                   capture.capture)
    rec.setup_s = rec.window_start - (_T0 if t0 is None else t0)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if rec.capture is not None:
        rec.capture = rec.capture.reduce()
    metrics = {}
    for m in reported(spec, cell, trace):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    for name in PROGRAM_STATE:          # the program's state goes before the reference
        if hasattr(system, name):
            setattr(system, name, None)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if mix["kind"] == "steps":
        numbers = check.check_steps(system, reference, config, rec,
                                    extra=[k for k in limits if "." in k])
    else:
        numbers = check.check_requests(system, reference, config, rec,
                                       mix["check_requests"], seed)
    compared = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    window = rec.units
    result = {"correct": correct, "attempted": len(window),
              "failed": sum(not u["ok"] for u in window), "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                         "count": cell["chips"], "memory_peak_bytes": peak}}
    if trace and rec.capture is not None:
        result["device"]["busy_s"] = rec.capture.busy_s
        result["device"]["window_s"] = rec.capture.window_s
        result["breakdown"] = {"device_ops": rec.capture.top_ops(),
                               "idle_gaps": rec.capture.idle_gaps()}
    result["compared"] = compared
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    build = ROOT / "build"      # every cache at a fixed path inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = find(spec, args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {card()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr, flush=True)
    # The configurations state float32 with TF32 off.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    result = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the result's process: {', '.join(bad)}", file=sys.stderr)
        return 4
    peak = result["device"]["memory_peak_bytes"]
    print(f"memory peak {peak} bytes; attempted {result['attempted']}, failed "
          f"{result['failed']}; " + "; ".join(f"{k} {v['value']}" for k, v in
                                              result["metrics"].items()),
          file=sys.stderr)
    for name, v in result["compared"].items():
        print(f"compared {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
