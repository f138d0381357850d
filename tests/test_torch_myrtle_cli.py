"""Port parity for Myrtle classification: ``python -m snngp_torch --device
cpu cls tr / ts / pr -n myrtle`` against ``run.py cls ... -n myrtle`` on the
synthetic set (8 x 8 x 1, 10 classes; -nd 120 -ni 10 -nb 40 -nh 5 -e 1), and
``SNNGPClassifier(network="myrtle")``.

Tolerances:
- the epoch-0 checkpoints (the initial parameters): rtol 1e-6, softplus
  inverse round-off; the inducing inputs bit-identical to their
  class-proportional init, before and after training (they are frozen);
- test NLLs of one checkpoint evaluated by the two packages on 100 images
  at 10,000 samples: atol 7e-3. The packages draw different Monte Carlo
  samples; per image log mean_s p_s has standard error CV(p_s) / sqrt(S)
  <= 1e-2 (CV <= 1 for these near-uniform probabilities), so the
  difference of two 100-image means has standard error <= sqrt(2) 1e-2 /
  10 = 1.4e-3, and the bar is 5 of those;
- ``cls pr`` against ``cls ts`` on one checkpoint and seed: rtol 1e-5.
"""

import os
import shutil
import sys

import numpy as np
import pytest

from snngp.utils.checkpoint import load_named as jload_named

from snngp_torch.__main__ import main as torch_cli
from snngp_torch.cli.classification import _inducing_init
from snngp_torch.data.classification import get_train_dataset
from snngp_torch.utils import load_named

from _torch_parity import to_numpy  # noqa: F401  (sets the thread count)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ["cls", "tr", "-m", "svtp", "-n", "myrtle", "-dn", "synthetic", "-nd", "120",
         "-ni", "10", "-nb", "40", "-nh", "5", "-e", "1", "-ns", "4", "-nvs", "8", "-q"]
MC_ATOL = 7e-3


def _jax_cli(argv):
    sys.path.insert(0, REPO)
    import run as run_mod
    run_mod.main(argv)


def _port(argv):
    torch_cli(["--device", "cpu", *argv])


def _test_nll(ckpt, runner):
    shutil.rmtree(os.path.join(ckpt, "test"), ignore_errors=True)
    runner(["cls", "ts", "-dn", "synthetic", "-cd", ckpt, "-nd", "100", "-q"])
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
    root = str(tmp_path_factory.mktemp("myrtle"))
    _jax_cli([*TRAIN, "-cr", root, "-cn", "jax"])
    _port([*TRAIN, "-cr", root, "-cn", "torch"])
    return root


def test_inducing_inputs_frozen_and_initial_checkpoint_matches_jax(runs):
    want = jload_named(os.path.join(runs, "jax", "000.npz"))
    got = load_named(os.path.join(runs, "torch", "000.npz"))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6)
    (x, y), _, (num_class, _, _) = get_train_dataset("synthetic", num_data=120, seed=10)
    init, _ = _inducing_init(x, y, num_class, 10)
    for who in ("torch", "jax"):
        params, _ = _state_leaves(os.path.join(runs, who))
        np.testing.assert_array_equal(params[1], init.astype(np.float32))
    np.testing.assert_array_equal(got["inducing_variable"], init.astype(np.float32))
    text = open(os.path.join(runs, "torch", "train.log")).read()
    assert "Myrtle kernel: inducing inputs fixed" in text and "Traceback" not in text
    meta = np.load(os.path.join(runs, "torch", "meta.npy"), allow_pickle=True).item()
    assert meta["network"] == "myrtle" and meta["num_hiddens"] == 5


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
    _port(["cls", "pr", "-dn", "synthetic", "-cd", ckpt, "-nd", "100", "-o", out, "-q"])
    text = open(os.path.join(ckpt, "predict", "predict.log")).read()
    np.testing.assert_allclose(float(text.split("NLL:")[-1].split()[0]), nll_ts, rtol=1e-5)
    assert np.load(out)["proba"].shape == (100, 10)


@pytest.mark.parametrize("resumer", ["torch", "jax"])
def test_resume_state_crosses_packages(runs, tmp_path, resumer):
    """Each package resumes the other's resume.state (epoch 1 -> 2); the
    inducing inputs stay at their init and their Adam moments at zero."""
    writer = "jax" if resumer == "torch" else "torch"
    shutil.copytree(os.path.join(runs, writer), tmp_path / "run")
    i = TRAIN.index("-e")
    argv = [*TRAIN[:i + 1], "2", *TRAIN[i + 2:], "-cr", str(tmp_path), "-cn", "run", "-rs"]
    (_port if resumer == "torch" else _jax_cli)(argv)
    text = open(tmp_path / "run" / "train.log").read()
    assert "at epoch 1" in text and "[  2]  nELBO:" in text, text
    params, num_opt = _state_leaves(str(tmp_path / "run"))
    before, _ = _state_leaves(os.path.join(runs, writer))
    np.testing.assert_array_equal(params[1], before[1])


@pytest.mark.parametrize("depth", [4, 6])
def test_depth_must_be_a_myrtle_depth(depth, tmp_path):
    argv = [*TRAIN, "-cr", str(tmp_path), "-cn", "x"]
    argv[argv.index("-nh") + 1] = str(depth)
    for runner in (_port, _jax_cli):
        with pytest.raises(ValueError, match="Myrtle depth"):
            runner(argv)
    assert not os.path.exists(tmp_path / "x" / "train.log")


def test_classifier_fit_predict_myrtle():
    """As tests/test_sklearn.py::test_classifier_fit_predict_myrtle: the
    inducing inputs stay at their class-proportional init while the ELBO
    trains."""
    from snngp_torch.sklearn import SNNGPClassifier
    rng = np.random.RandomState(1)
    n = 48
    x = rng.rand(n, 8, 8, 1).astype(np.float32)
    y = (x.mean(axis=(1, 2, 3)) > 0.5).astype(int)
    est = SNNGPClassifier(method="svgp", network="myrtle", num_hiddens=5, num_inducing=8,
                          num_samples=8, batch_size=24, epochs=1, eps=1e-2, device="cpu")
    z0 = None
    est.fit(x, y)
    proba = est.predict_proba(x, num_samples=50)
    assert proba.shape == (n, 2)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, atol=1e-3)
    assert np.all(np.isfinite(est.losses_))
    counts = np.bincount(y)
    per_class = np.round(8 * counts / counts.sum()).astype(int)
    z0 = np.concatenate([x[y == c][:max(per_class[c], 1)] for c in range(2)])
    np.testing.assert_array_equal(to_numpy(est.model_.inducing_variable), z0)
    with pytest.raises(ValueError, match="Myrtle depth"):
        SNNGPClassifier(network="myrtle", num_hiddens=4, device="cpu").fit(x, y)
