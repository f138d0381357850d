"""Port parity of WideResNet classification, end to end: ``python -m
snngp_torch --device cpu cls tr / ts / pr -n resnet`` against the JAX
package's ``run.py cls ... -n resnet`` on the synthetic set (8 x 8 x 1, 10
classes; the flags of tests/test_cli_smoke.py's WideResNet run: -nd 120
-ni 10 -nb 40 -ns 4 -nvs 8 -nh 1 -e 1), checkpoints read across the two
packages, and ``SNNGPClassifier(network="resnet")``.

Tolerances (those of tests/test_torch_cls_cli.py):
- the epoch-0 checkpoint (the initial parameters, before any draw): rtol
  1e-6, softplus inverse round-off;
- test NLLs of one checkpoint evaluated by the two packages: atol 5e-3, five
  standard errors of the difference of two Monte Carlo estimates with
  10,000 samples over 200 near-uniform test images;
- ``cls pr`` against ``cls ts`` of the port on one checkpoint and seed:
  rtol 1e-5 (the same draws, the fitted predictor's products in another
  order).
"""

import os
import shutil
import sys

import numpy as np
import pytest

from snngp.utils.checkpoint import load_named as jload_named

from snngp_torch.__main__ import main as torch_cli
from snngp_torch.sklearn import SNNGPClassifier
from snngp_torch.utils import load_named

from _torch_parity import to_numpy  # noqa: F401  (sets the thread count)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ["cls", "tr", "-m", "svgp", "-n", "resnet", "-dn", "synthetic", "-nd", "120",
         "-ni", "10", "-nb", "40", "-ns", "4", "-nvs", "8", "-nh", "1", "-e", "1", "-q"]
MC_ATOL = 5e-3


def _jax_cli(argv):
    sys.path.insert(0, REPO)
    import run as run_mod
    run_mod.main(argv)


def _port(argv):
    torch_cli(["--device", "cpu", *argv])


def _log_nll(path):
    text = open(path).read()
    assert "Traceback" not in text, text
    return float(text.split("NLL:")[-1].split()[0])


def _test_nll(ckpt, runner):
    shutil.rmtree(os.path.join(ckpt, "test"), ignore_errors=True)
    runner(["cls", "ts", "-dn", "synthetic", "-cd", ckpt, "-nd", "200", "-q"])
    (log,) = os.listdir(os.path.join(ckpt, "test"))
    return _log_nll(os.path.join(ckpt, "test", log))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cls_resnet"))
    _jax_cli([*TRAIN, "-cr", root, "-cn", "jax"])
    _port([*TRAIN, "-cr", root, "-cn", "torch"])
    return root


def test_initial_checkpoint_and_meta_match_jax(runs):
    want = jload_named(os.path.join(runs, "jax", "000.npz"))
    got = load_named(os.path.join(runs, "torch", "000.npz"))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6)
    meta = np.load(os.path.join(runs, "torch", "meta.npy"), allow_pickle=True).item()
    assert meta["network"] == "resnet"
    text = open(os.path.join(runs, "torch", "train.log")).read()
    assert "[  0]  NLL:" in text and "[  1]  nELBO:" in text and "Traceback" not in text


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
    nll_pr = _log_nll(os.path.join(ckpt, "predict", "predict.log"))
    np.testing.assert_allclose(nll_pr, nll_ts, rtol=1e-5)
    pred = np.load(out)
    assert pred["proba"].shape == (200, 10) and pred["label"].shape == (200,)
    np.testing.assert_allclose(pred["proba"].sum(axis=1), 1.0, rtol=1e-5)


def test_freeze_inducing_keeps_the_inducing_inputs(tmp_path):
    _port([*TRAIN, "-cr", str(tmp_path), "-cn", "f", "--freeze-inducing"])
    init = load_named(str(tmp_path / "f" / "000.npz"))["inducing_variable"]
    with np.load(str(tmp_path / "f" / "resume.state")) as state:
        np.testing.assert_array_equal(state["p1"], init)
    assert "--freeze-inducing" in open(tmp_path / "f" / "train.log").read()


def test_resnet_classifier_fits_and_predicts():
    rng = np.random.RandomState(12)
    x = rng.randn(30, 6, 5, 1).astype(np.float32)
    y = rng.randint(3, size=30) * 2 + 1          # labels {1, 3, 5}
    x += y[:, None, None, None] * 0.5
    clf = SNNGPClassifier(method="svtp", network="resnet", num_hiddens=1, num_inducing=6,
                          num_samples=8, batch_size=15, epochs=1, device="cpu")
    assert clf.fit(x, y) is clf
    assert clf.losses_.shape == (2,) and np.all(np.isfinite(clf.losses_))
    proba = clf.predict_proba(x[:5], num_samples=64)
    assert proba.shape == (5, 3)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, rtol=1e-5)
    assert set(clf.predict(x)) <= {1, 3, 5}
    assert 0.0 <= clf.score(x, y) <= 1.0
