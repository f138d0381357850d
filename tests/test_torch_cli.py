"""Port parity, end to end: a checkpoint trained by the JAX CLI (``reg tr``)
served by the port's ``python -m snngp_torch --device cpu reg ts / reg pr``
against the JAX CLI's ``reg ts / reg pr`` on the same checkpoint.

Tolerance rtol 5e-3, as tests/test_cli_smoke.py:47-51 sets it between two
programs: the syn-normal Gram's near-singular predictive variances (~1e-5)
amplify fp32 reassociation to ~1e-3 relative on the NLL and the variances.
"""

import os
import sys

import numpy as np
import pytest
import torch

from snngp_torch.__main__ import main as torch_cli

from _torch_parity import to_numpy  # noqa: F401  (sets the thread count)

RTOL = 5e-3


def _jax_cli(argv):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import run as run_mod
    run_mod.main(argv)


def _nll(path):
    text = open(path).read()
    assert "Traceback" not in text, text
    return float(text.split("NLL:")[-1].split()[0])


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt"))
    _jax_cli(["reg", "tr", "-m", "tp", "-dn", "syn-normal", "-cr", root, "-cn", "run",
              "-t", "2", "-vi", "1", "-pi", "1", "-nh", "2", "-eps", "1e-2", "-q"])
    path = os.path.join(root, "run")
    assert any(f.endswith(".npz") for f in os.listdir(path)), "no checkpoint"
    return path


def test_reg_ts_matches_jax(ckpt_dir):
    _jax_cli(["reg", "ts", "-cd", ckpt_dir, "-q"])
    want = _nll(os.path.join(ckpt_dir, "test", "test.log"))
    torch_cli(["--device", "cpu", "reg", "ts", "-cd", ckpt_dir, "-q"])
    got = _nll(os.path.join(ckpt_dir, "test", "test.log"))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_reg_pr_matches_jax(ckpt_dir, tmp_path):
    out_j, out_t = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    _jax_cli(["reg", "pr", "-cd", ckpt_dir, "-o", out_j, "-q"])
    want_nll = _nll(os.path.join(ckpt_dir, "predict", "predict.log"))
    torch_cli(["--device", "cpu", "reg", "pr", "-cd", ckpt_dir, "-o", out_t, "-q"])
    got_nll = _nll(os.path.join(ckpt_dir, "predict", "predict.log"))
    np.testing.assert_allclose(got_nll, want_nll, rtol=RTOL)
    want, got = np.load(out_j), np.load(out_t)
    assert got["mean"].shape == want["mean"].shape == got["var"].shape
    assert np.all(np.isfinite(got["mean"])) and np.all(got["var"] > 0)
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=RTOL,
                               atol=RTOL * np.abs(want["mean"]).max())
    # The Student-t variances carry one scalar factor d / (2a + N), where
    # d = 2a + y^T ((b/a) K + 1e-6 I)^-1 y is solved against the near-singular
    # syn-normal Gram with only the reference's 1e-6 jitter: fp32 round-off
    # moves d by ~2e-2 between the frameworks. So: the variances agree to
    # RTOL up to one common factor, and that factor is within 5e-2 of 1.
    ratio = got["var"] / want["var"]
    np.testing.assert_allclose(ratio, ratio.mean(), rtol=RTOL)
    np.testing.assert_allclose(ratio.mean(), 1.0, rtol=5e-2)


def test_reg_pr_fitted_state_cache(ckpt_dir, tmp_path):
    fitted = str(tmp_path / "fitted.npz")
    log = os.path.join(ckpt_dir, "predict", "predict.log")
    args = ["--device", "cpu", "reg", "pr", "-cd", ckpt_dir, "-fs", fitted,
            "-o", str(tmp_path / "p.npz"), "-q"]
    torch_cli(args)
    first = _nll(log)
    assert os.path.isfile(fitted) and "saved fitted state" in open(log).read()
    torch_cli(args)
    assert "loaded fitted state" in open(log).read()
    np.testing.assert_allclose(_nll(log), first, rtol=1e-6)


def test_cuda_device_without_cuda_is_an_error(ckpt_dir):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        torch_cli(["reg", "ts", "-cd", ckpt_dir, "-q"])


def test_failure_is_logged_and_reraised(tmp_path):
    # The JAX CLI logs the traceback and exits 0; the port re-raises.
    ckpt = tmp_path / "bad"
    ckpt.mkdir()
    from snngp_torch.utils import save_params
    save_params(str(ckpt / "000.npz"), {"eps": np.float32(0.1)})
    np.save(ckpt / "meta.npy", dict(args=dict(method="gp", data_name="no-such-data",
                                              last_w_std=1.0)))
    with pytest.raises(KeyError, match="no-such-data"):
        torch_cli(["--device", "cpu", "reg", "ts", "-cd", str(ckpt), "-q"])
    text = open(ckpt / "test" / "test.log").read()
    assert "Traceback" in text and "Stopped" in text
