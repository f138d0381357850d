"""Port parity for the north-star pipeline: ``python -m
snngp_torch.examples.cifar_myrtle`` against ``examples/cifar_myrtle.py`` on
the JAX CPU path, and the predictor pieces it needs (``fit_spr(var_floor=)``,
``FittedSPR.predict_given`` / ``test_nll_given``, the ``var_floor`` state
key in either package's fitted-state file).

Tolerances:
- the ML-II fit's hyperparameters after 2 steps: rtol 1e-5 (fp32 Grams
  ~1e-7 apart, moved by two Adam steps of 1e-2);
- the pipeline's predictive NLL: atol 2e-3. The train Gram is regularized
  by eps = 1e-4 absolute against entries ~0.1, a condition number ~1e4
  that amplifies the packages' ~1e-7 Gram differences to ~1e-3 in the
  solves (without ML-II the JAX script gives 2.5177, the port's full tier
  2.5173 and its fused Gram 2.5171 at these sizes);
- the predictor pieces: rtol 1e-4, as tests/test_torch_predictor.py.
"""

import os
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snngp.models import (SPR as JSPR, FittedSPR as JFitted, NNGPKernel as JKernel,
                          StudentTLikelihood as JStudent, fit_spr as jfit_spr)
from snngp.nn import arch as jarch

from snngp_torch.examples import cifar_myrtle as example
from snngp_torch.models import SPR, FittedSPR, NNGPKernel, StudentTLikelihood, fit_spr
from snngp_torch.nn import arch as tarch

from _torch_parity import randn, to_numpy, to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--image-size", "8", "--n-train", "64", "--n-test", "16", "--mlii", "2",
        "--mlii-n", "32"]
RTOL = 1e-4


def _parse(out):
    hyper = out.split("->")[1].split("}")[0] + "}"
    nll = float(out.split("reference semantics):")[-1].split()[0])
    return eval(hyper), nll   # the scripts print a dict of floats


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX script with ARGS, in a directory without ./data/cifar10 (the
    seeded synthetic images)."""
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("jax_cifar"))
    saved = sys.argv
    sys.argv = ["cifar_myrtle.py", *ARGS]
    try:
        from io import StringIO
        from contextlib import redirect_stdout
        buf = StringIO()
        with redirect_stdout(buf):
            runpy.run_path(os.path.join(REPO, "examples", "cifar_myrtle.py"),
                           run_name="__main__")
        return _parse(buf.getvalue())
    finally:
        sys.argv = saved
        os.chdir(cwd)


@pytest.mark.parametrize("fused", ["off", "on"])
def test_example_matches_the_jax_script(jax_run, fused, tmp_path, monkeypatch, capsys):
    """fused off: the full tier tile by tile, as the JAX script on the CPU;
    fused on: myrtle_gram_tiled, K7's plain version on the CPU."""
    monkeypatch.chdir(tmp_path)
    result = example.main(["--device", "cpu", *ARGS, "--fused", fused, "--fused-block", "24"])
    nll = result["nll"]
    hyper, printed = _parse(capsys.readouterr().out)
    assert result["hyper"] == hyper
    assert sorted(result["phases_s"]) == ["fit", "gram_cross", "gram_test", "gram_train",
                                          "predictive"]
    want_hyper, want_nll = jax_run
    assert np.isfinite(nll) and abs(printed - nll) < 1e-4
    for k in want_hyper:
        np.testing.assert_allclose(hyper[k], want_hyper[k], rtol=1e-5)
    np.testing.assert_allclose(nll, want_nll, atol=2e-3)
    out = capsys.readouterr().out
    assert "Traceback" not in out


# --devices (with and without full-scope ML-II) and --bf16 off the fused
# path run (tests/test_torch_mesh_cls_cli.py); the JAX dispatch knobs raise.
@pytest.mark.parametrize("flags", [["--scan-chunk", "4"], ["--remat"]])
def test_unported_flags_raise(flags, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError):
        example.main(["--device", "cpu", "--image-size", "8", "--n-train", "8",
                      "--n-test", "8", *flags])


@pytest.mark.parametrize("chol", ["blocked", "inplace"])
def test_chol_routes_match_xla(chol, tmp_path, monkeypatch):
    """--chol blocked (blocked_cholesky) and inplace (the memory-lean fit)
    give the NLL of --chol xla: rtol 1e-5, one fp32 Gram factored three
    ways, regularized by eps = 1e-1 absolute (condition number ~1e2)."""
    monkeypatch.chdir(tmp_path)
    args = ["--device", "cpu", "--image-size", "8", "--n-train", "48", "--n-test", "8",
            "--fused", "on", "--fused-block", "16", "--eps", "1e-1", "--t-jitter", "1e-1"]
    want = example.main([*args, "--chol", "xla"])["nll"]
    got = example.main([*args, "--chol", chol])["nll"]
    assert np.isfinite(want)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("chol, n, lean, blocked", [
    ("auto", 4095, False, False), ("auto", 4096, False, False),
    ("auto", 32767, False, False), ("auto", 32768, True, False),
    ("xla", 65536, False, False), ("blocked", 64, False, True),
    ("inplace", 64, True, False)])
def test_chol_route_per_n(chol, n, lean, blocked):
    """--chol auto is the memory-lean fit from N = 32,768 and cuSOLVER below;
    blocked_cholesky runs only when --chol blocked asks for it."""
    memory_lean, chol_fn = example._chol_route(chol, n)
    assert memory_lean is lean
    assert (chol_fn is example.blocked_cholesky) is blocked
    assert blocked or chol_fn is None


def test_cuda_device_without_cuda_is_an_error(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="CUDA"):
        example.main(["--image-size", "8", "--n-train", "8", "--n-test", "8"])


def _data(n=24):
    return randn(12, (n, 3), (n,), (9, 3), (9,))


def _models(x, y):
    jk = JKernel(lambda w, b, l: jarch.get_mlp_kernel(2, act="relu", w_std=w, b_std=b,
                                                      last_w_std=l), 1.2, 0.5, 0.9)
    tk = NNGPKernel(lambda w, b, l: tarch.get_mlp_kernel(2, act="relu", w_std=w, b_std=b,
                                                         last_w_std=l), 1.2, 0.5, 0.9)
    jm = JSPR(jk, JStudent(1.5, 2.5), x, y, jnp.array(0.7), jnp.array(1.3), eps=1e-3)
    tm = SPR(tk, StudentTLikelihood(1.5, 2.5), x, y, 0.7, 1.3, eps=1e-3)
    return jm, tm


# A floor this large clips most test variances, so the clipped branch is
# what is compared.
FLOOR = 0.5


def test_var_floor_and_given_pieces_match_jax():
    x, y, x_test, y_test = _data()
    jm, tm = _models(x, y)
    jfit = jfit_spr(jm, jm.init_params(), var_floor=FLOOR)
    with torch.no_grad():
        fit = fit_spr(tm, var_floor=FLOOR)
        k_td = tm.kernel.K(tm.kernel.get_kernel_fn(), to_torch(x_test), tm.x_data)
        k_tt = tm.kernel.K(tm.kernel.get_kernel_fn(), to_torch(x_test))
        pairs = [(fit.predict(to_torch(x_test)), jfit.predict(x_test)),
                 (fit.predict_given(k_td, torch.diagonal(k_tt)),
                  jfit.predict_given(to_numpy(k_td), np.diagonal(to_numpy(k_tt)).copy()))]
        nll = float(fit.test_nll_given(k_td.numpy(), np.diagonal(to_numpy(k_tt)).copy(),
                                       to_torch(y_test)))
    want_nll = float(jfit.test_nll_given(to_numpy(k_td), np.diagonal(to_numpy(k_tt)).copy(),
                                         y_test))
    np.testing.assert_allclose(nll, want_nll, rtol=RTOL)
    for (mean, var), (jmean, jvar) in pairs:
        np.testing.assert_allclose(to_numpy(mean), np.asarray(jmean), rtol=RTOL,
                                   atol=RTOL * float(np.abs(jmean).max()))
        np.testing.assert_allclose(to_numpy(var), np.asarray(jvar), rtol=RTOL)
    # The floor is active: without it the variances differ.
    with torch.no_grad():
        _, free = fit_spr(tm).predict(to_torch(x_test))
    assert not torch.allclose(free, pairs[0][0][1])


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_var_floor_fitted_state_cross_loads(writer, tmp_path):
    x, y, x_test, y_test = _data()
    jm, tm = _models(x, y)
    path = str(tmp_path / "fitted.npz")
    if writer == "torch":
        with torch.no_grad():
            fit_spr(tm, var_floor=FLOOR).save(path)
        assert float(np.load(path)["var_floor"]) == np.float32(FLOOR)
        got = float(JFitted.load(path, jm).test_nll(x_test, y_test))
    else:
        jfit_spr(jm, jm.init_params(), var_floor=FLOOR).save(path)
        with torch.no_grad():
            got = float(FittedSPR.load(path, tm).test_nll(*to_torch(x_test, y_test)))
    want = float(jfit_spr(jm, jm.init_params(), var_floor=FLOOR).test_nll(x_test, y_test))
    np.testing.assert_allclose(got, want, rtol=RTOL)
