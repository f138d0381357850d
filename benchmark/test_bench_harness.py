"""The harness on the CPU: discovery by name, the contract's shape of
``BENCHMARK.json``, the whole-name check for JAX, and whole runs of each
cell at tiny sizes (the look for a chip skipped), correct as they are and
not correct with a fault planted in the timed path."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import calibrate, run

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = {c["name"]: c for c in SPEC["workloads"]}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_the_spec_has_the_contracts_keys_and_shapes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
    for c in SPEC["configs"]:
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and 1 <= len(c["why"]) <= 200
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(CELLS)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_each_cell_finds_its_pieces_by_name(cell):
    c = CELLS[cell]
    for path in (f"configs/{c['config']}.json", f"systems/{c['config']}.py",
                 f"reference/{c['config']}.py", f"traffic/{c['traffic']}.json",
                 f"limits/{cell}.json"):
        assert (HERE / path).is_file(), path
    mix = json.loads((HERE / "traffic" / f"{c['traffic']}.json").read_text())
    assert mix["kind"] in ("steps", "requests")
    e2e = {m["name"] for m in run.reported(SPEC, c, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = run.reported(SPEC, c, True)
    assert layer and all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
def test_each_metric_has_a_reader(metric):
    """A metric's own file, or for ``<family>.<cell>`` its family's."""
    assert callable(run.reader(metric))


def test_the_jax_check_compares_whole_top_level_names():
    assert run.forbidden_modules(["snngp_torch", "snngp_torch.ops.gram", "numpy",
                                  "jax_utils", "flaxen"]) == []
    assert run.forbidden_modules(["snngp.ops", "jaxlib.xla_client", "jax", "flax.linen",
                                  "snngp_torch"]) == ["flax", "jax", "jaxlib", "snngp"]


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the run exits 2 and prints no result; in a
    directory that holds only the benchmark it fails too."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", "mlp4-t.mlii", "--seed",
           "1", "--seconds", "1", "--trace", "0"]
    done = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert done.returncode == 2 and done.stdout == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=120)
    assert done.returncode != 0 and done.stdout == ""


def small(cell):
    """The cell's configuration and mix at sizes a CPU test holds."""
    c = CELLS[cell]
    cfg = json.loads((HERE / "configs" / f"{c['config']}.json").read_text())
    mix = json.loads((HERE / "traffic" / f"{c['traffic']}.json").read_text())
    if c["config"] == "mlp4-t":
        cfg["data"]["num_train"] = 256
    else:
        cfg["data"].update(num_train=120, image=[8, 8, 3])
        cfg["model"]["num_inducing"] = 10
        cfg["train"].update(batch=8, num_samples=6)
    if mix["kind"] == "requests":
        mix.update(pool_requests=4, warm_requests=1, check_requests=6)
    mix["capture_seconds"] = 0.1
    return cfg, mix


def _run(cell, patch=None, trace=False, seed=2 ** 31 + 977):
    cfg, mix = small(cell)
    return run.run_cell(SPEC, CELLS[cell], seed, 0.3, trace, "cpu", config=cfg, mix=mix,
                        patch=patch)


@pytest.mark.parametrize("cell,trace", [(c, t) for c in sorted(CELLS) for t in (False, True)])
def test_a_sound_run_is_correct(cell, trace):
    result = _run(cell, trace=trace)
    assert result["correct"], result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    names = {m["name"] for m in run.reported(SPEC, CELLS[cell], trace)}
    assert set(result["metrics"]) <= names
    assert list(result)[-1] == "compared"
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {"setup_s"} < set(result["metrics"])


FAULTS = [("mlp4-t.mlii", "unchanged"), ("mlp4-t.mlii", "half"),
          ("myrtle5-t.elbo", "unchanged"), ("myrtle5-t.elbo", "half"),
          ("mlp4-t.serve", "altered"), ("mlp4-t.serve", "scaled")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    result = _run(cell, patch=calibrate.FAULTS[fault])
    assert not result["correct"], result["compared"]


def control_size(cell):
    """Sizes at which a CPU test holds the control and the control reads
    as it does at the cell's own size (the ELBO needs an inducing set about
    as ill-conditioned as the cell's: 40 images of 8 x 8). None for ML-II:
    at N = 10,000 the control's TF32 factor fails outright, while at the
    sizes a CPU test holds (N = 256 or 1,024) its error passes every limit;
    on the card the test runs each cell at its own size."""
    cfg, mix = small(cell)
    if cell == "mlp4-t.mlii":
        return None
    if cell == "myrtle5-t.elbo":
        cfg["data"]["num_train"] = 400
        cfg["model"]["num_inducing"] = 40
        cfg["train"].update(batch=16, num_samples=8)
    return cfg, mix


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 12])
def test_the_control_is_not_correct(cell, seed):
    """The reference in TF32 put in the program's place fails at least one
    of the cell's limits, where the program passes them all: at the cell's
    own size on a CUDA card, at a small size on the CPU."""
    import torch
    if torch.cuda.is_available():
        device, cfg, mix = "cuda", None, None
    else:
        sizes = control_size(cell)
        if sizes is None:
            pytest.skip("TF32's error at the cell's size needs the card")
        device, (cfg, mix) = "cpu", sizes
    limits = json.loads((HERE / "limits" / f"{cell}.json").read_text())
    got = dict(calibrate.readings(SPEC, CELLS[cell], seed, True, [], 3.0, device=device,
                                  config=cfg, witness=False, mix=mix))
    assert all(got["program"][k] <= v for k, v in limits.items()), got["program"]
    assert any(not got["control"][k] <= v for k, v in limits.items()), got["control"]
