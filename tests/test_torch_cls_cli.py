"""Port parity, end to end: ``python -m snngp_torch --device cpu cls tr / ts /
pr`` against the JAX package's ``run.py cls ...`` on the synthetic set
(8 x 8 x 1, 10 classes; -nd 300 -ni 20 -nb 50 -nh 1 -e 1), checkpoints and
``resume.state`` read across the two packages.

Tolerances:
- the epoch-0 checkpoint (the initial parameters, before any draw): rtol
  1e-6, softplus inverse round-off;
- test NLLs of one checkpoint evaluated by the two packages: atol 5e-3.
  The packages draw different Monte Carlo samples (JAX keys, torch
  generators). With S = 10,000 samples, the per-image estimate
  log mean_s p_s has standard error CV(p_s) / sqrt(S) <= 1e-2 for these
  near-uniform predictive probabilities (CV <= 1); over 200 test images
  the difference of the two means has standard error <= sqrt(2) 1e-2 /
  sqrt(200) = 1e-3, and the bar is 5 of those;
- ``cls pr`` against ``cls ts`` of the port on one checkpoint and seed:
  rtol 1e-5 (the same draws, the fitted predictor's products in another
  order).
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from snngp.utils.checkpoint import load_named as jload_named

from snngp_torch.__main__ import main as torch_cli
from snngp_torch.utils import load_named

from _torch_parity import to_numpy  # noqa: F401  (sets the thread count)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ["cls", "tr", "-m", "svtp", "-dn", "synthetic", "-nd", "300", "-ni", "20",
         "-nb", "50", "-nh", "1", "-e", "1", "-ns", "8", "-nvs", "16", "-q"]
MC_ATOL = 5e-3


def _epochs(argv, n):
    """argv with ``-e n``."""
    i = argv.index("-e")
    return [*argv[:i + 1], str(n), *argv[i + 2:]]


def _jax_cli(argv):
    sys.path.insert(0, REPO)
    import run as run_mod
    run_mod.main(argv)


def _port(argv):
    torch_cli(["--device", "cpu", *argv])


def _test_nll(ckpt, runner):
    shutil.rmtree(os.path.join(ckpt, "test"), ignore_errors=True)
    runner(["cls", "ts", "-dn", "synthetic", "-cd", ckpt, "-nd", "200", "-q"])
    (log,) = os.listdir(os.path.join(ckpt, "test"))
    text = open(os.path.join(ckpt, "test", log)).read()
    assert "Traceback" not in text, text
    return float(text.split("NLL:")[-1].split()[0])


def _state_leaves(ckpt):
    with np.load(os.path.join(ckpt, "resume.state")) as data:
        return ([data[f"p{i}"] for i in range(int(data["num_params"]))],
                int(data["num_opt"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cls"))
    _jax_cli([*TRAIN, "-cr", root, "-cn", "jax"])
    _port([*TRAIN, "-cr", root, "-cn", "torch"])
    return root


def test_initial_checkpoint_and_meta_match_jax(runs):
    want = jload_named(os.path.join(runs, "jax", "000.npz"))
    got = load_named(os.path.join(runs, "torch", "000.npz"))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6)
    np.testing.assert_array_equal(got["inducing_variable"], want["inducing_variable"])
    meta_j = np.load(os.path.join(runs, "jax", "meta.npy"), allow_pickle=True).item()
    meta_t = np.load(os.path.join(runs, "torch", "meta.npy"), allow_pickle=True).item()
    for key in ("method", "network", "num_hiddens", "activation", "num_inducing",
                "alpha", "beta", "last_w_std"):
        assert meta_t[key] == meta_j[key]
    text = open(os.path.join(runs, "torch", "train.log")).read()
    assert "[  0]  NLL:" in text and "[  1]  nELBO:" in text and "Traceback" not in text


def test_svtp_freezes_last_w_std(runs):
    init = load_named(os.path.join(runs, "torch", "000.npz"))
    params, num_opt = _state_leaves(os.path.join(runs, "torch"))
    assert num_opt == 1 + 2 * 9                     # one Adam over nine leaves
    np.testing.assert_array_equal(params[3], init["kernel.last_w_std"])
    assert not np.array_equal(params[4], init["kernel.w_std"])


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_checkpoints_are_read_by_the_other_package(runs, writer):
    ckpt = os.path.join(runs, writer)
    own, other = (_port, _jax_cli) if writer == "torch" else (_jax_cli, _port)
    got, want = _test_nll(ckpt, other), _test_nll(ckpt, own)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, atol=MC_ATOL)


def test_cls_pr_matches_cls_ts(runs, tmp_path):
    ckpt = os.path.join(runs, "torch")
    nll_ts = _test_nll(ckpt, _port)
    out = str(tmp_path / "pred.npz")
    _port(["cls", "pr", "-dn", "synthetic", "-cd", ckpt, "-nd", "200", "-o", out, "-q"])
    text = open(os.path.join(ckpt, "predict", "predict.log")).read()
    np.testing.assert_allclose(float(text.split("NLL:")[-1].split()[0]), nll_ts, rtol=1e-5)
    pred = np.load(out)
    assert pred["proba"].shape == (200, 10) and pred["label"].shape == (200,)
    np.testing.assert_allclose(pred["proba"].sum(axis=1), 1.0, rtol=1e-5)


def test_resume_from_a_jax_resume_state(runs, tmp_path):
    shutil.copytree(os.path.join(runs, "jax"), tmp_path / "run")
    _port([*_epochs(TRAIN, 2), "-cr", str(tmp_path), "-cn", "run", "-rs"])
    text = open(tmp_path / "run" / "train.log").read()
    assert "at epoch 1" in text and "[  2]  nELBO:" in text and "[  1]  nELBO:" not in text
    assert _state_leaves(str(tmp_path / "run"))[1] == 19


def test_resize_and_two_optimizers_cross_load(tmp_path):
    # -r 2 halves the images before the inducing init; -lr2 trains the
    # prior with a second optimizer, whose state follows the first in
    # resume.state, and (the reference's quirk) drops the svtp freeze.
    args = [*TRAIN, "-r", "2", "-lr2", "1e-3", "-cr", str(tmp_path)]
    _jax_cli([*args, "-cn", "jax"])
    _port([*args, "-cn", "torch"])
    want = jload_named(str(tmp_path / "jax" / "000.npz"))["inducing_variable"]
    got = load_named(str(tmp_path / "torch" / "000.npz"))["inducing_variable"]
    assert got.shape == (20, 4, 4, 1)
    np.testing.assert_array_equal(got, want)
    params, num_opt = _state_leaves(str(tmp_path / "torch"))
    assert num_opt == 2 * (1 + 2 * 9)
    init = load_named(str(tmp_path / "torch" / "000.npz"))
    assert not np.array_equal(params[3], init["kernel.last_w_std"])
    resume = [*_epochs(args, 2), "-rs"]
    _jax_cli([*resume, "-cn", "torch"])         # JAX resumes the port's state
    _port([*resume, "-cn", "jax"])              # and the port JAX's
    for who in ("torch", "jax"):
        text = open(tmp_path / who / "train.log").read()
        assert "at epoch 1" in text and "[  2]  nELBO:" in text, text
    assert np.isfinite(_test_nll(str(tmp_path / "jax"), _port))


def test_scan_epoch_runs_the_same_loop(tmp_path):
    _port([*TRAIN, "-cr", str(tmp_path), "-cn", "loop"])
    _port([*TRAIN, "-cr", str(tmp_path), "-cn", "sck", "-sck"])
    loop, _ = _state_leaves(str(tmp_path / "loop"))
    sck, _ = _state_leaves(str(tmp_path / "sck"))
    for a, b in zip(loop, sck):
        np.testing.assert_array_equal(a, b)

    def epochs(name):
        lines = open(tmp_path / name / "train.log").read().splitlines()
        return [line for line in lines if line.startswith("[")]

    assert epochs("loop") == epochs("sck")


def test_freeze_inducing_keeps_the_inducing_inputs(tmp_path):
    _port([*TRAIN, "-cr", str(tmp_path), "-cn", "f", "--freeze-inducing"])
    params, _ = _state_leaves(str(tmp_path / "f"))
    init = load_named(str(tmp_path / "f" / "000.npz"))
    np.testing.assert_array_equal(params[1], init["inducing_variable"])
    assert "--freeze-inducing" in open(tmp_path / "f" / "train.log").read()


@pytest.mark.parametrize("network", ["myrtle"])
def test_unported_networks_raise_and_log(network, tmp_path, monkeypatch):
    # Every network and the mesh are ported; a failure inside the run (here
    # -r 2 halves the 8 x 8 images to 4 x 4, which Myrtle's three pools do
    # not take) is logged before it is re-raised.
    monkeypatch.setenv("SNNGP_MESH_DEVICES", "1")
    with pytest.raises(ValueError, match="AvgPool"):
        _port([*_epochs(TRAIN, 1), "-n", network, "-nh", "5", "-r", "2", "-cr",
               str(tmp_path), "-cn", "x"])
    text = open(tmp_path / "x" / "train.log").read()
    assert "Traceback" in text and "Stopped" in text


def test_mesh_is_not_ported(tmp_path, monkeypatch):
    # The mesh is ported: SNNGP_MESH_DEVICES=4 trains with the batch-sharded
    # ELBO (batches of 40; tests/test_torch_mesh_cls_cli.py holds it against
    # one device) and its checkpoint scores in cls ts.
    monkeypatch.setenv("SNNGP_MESH_DEVICES", "4")
    nb = TRAIN.index("-nb") + 1
    _port([*TRAIN[:nb], "40", *TRAIN[nb + 1:], "-cr", str(tmp_path), "-cn", "x"])
    text = open(tmp_path / "x" / "train.log").read()
    assert "Mesh: 4 devices (batch-sharded ELBO)" in text and "Traceback" not in text
    nelbo = float(text.split("[  1]  nELBO:")[1].split()[0])
    assert np.isfinite(nelbo)
    monkeypatch.setenv("SNNGP_MESH_DEVICES", "1")
    assert np.isfinite(_test_nll(str(tmp_path / "x"), _port))


def test_cuda_device_without_cuda_is_an_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        torch_cli([*TRAIN, "-cr", str(tmp_path), "-cn", "x"])
