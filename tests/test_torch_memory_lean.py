"""Port parity: the memory-lean fit, ``fit_spr(memory_lean=True)``, against
the JAX package's, and its upper-factor states saved in either package and
served in the other.

Tolerances: float32 within 1e-5 of the largest entry of the reference (plus
rtol 1e-5). The toy models regularize with eps = 1 (relative) and the
Student-t scale factor with t_jitter = 1, so the factored matrices have
condition numbers ~20, where two factorization orders and the two
packages' fp32 Grams (~1.7e-7 apart) differ by ~1e-6. Float64 against a
numpy solve: 1e-12, round-off.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snngp.models import (SPR as JSPR, FittedSPR as JFitted, GaussianLikelihood as JGauss,
                          NNGPKernel as JKernel, StudentTLikelihood as JStudent,
                          fit_spr as jfit_spr)
from snngp.nn import arch as jarch

from snngp_torch.models import (SPR, FittedSPR, GaussianLikelihood, NNGPKernel,
                                StudentTLikelihood, fit_spr)
from snngp_torch.models import params as P
from snngp_torch.nn import arch as tarch
from snngp_torch.ops import linalg as TL

from _torch_parity import randn, to_numpy, to_torch

EPS = 1.0          # relative diag_reg of the toy models
T_JITTER = 1.0     # absolute jitter of the Student-t scale factor
TOL = 1e-5


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(to_numpy(got).astype(np.float64), want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _data(seed=21, n=48):
    x, y, x_test, y_test = randn(seed, (n, 3), (n,), (9, 3), (9,))
    return x, y, x_test, y_test


def _jax_model(method, x, y):
    kernel = JKernel(lambda w, b, l: jarch.get_mlp_kernel(2, act="relu", w_std=w, b_std=b,
                                                          last_w_std=l), 1.2, 0.5, 0.9)
    lik = JGauss() if method == "gp" else JStudent(1.5, 2.5)
    return JSPR(kernel, lik, x, y, jnp.array(0.7), jnp.array(1.3), eps=EPS)


def _torch_model(method, x, y):
    kernel = NNGPKernel(lambda w, b, l: tarch.get_mlp_kernel(2, act="relu", w_std=w,
                                                             b_std=b, last_w_std=l),
                        1.2, 0.5, 0.9)
    lik = GaussianLikelihood() if method == "gp" else StudentTLikelihood(1.5, 2.5)
    return SPR(kernel, lik, x, y, 0.7, 1.3, eps=EPS)


def _gram(model):
    with torch.no_grad():
        return model._gram(model.kernel.get_kernel_fn()).numpy()


@pytest.mark.parametrize("method", ["gp", "tp"])
def test_lean_fit_matches_jax(method):
    """Both packages fit the same Gram: the upper factor, alpha and the
    Student-t scalars."""
    x, y, _, _ = _data()
    tm, jm = _torch_model(method, x, y), _jax_model(method, x, y)
    k = _gram(tm)
    want = jfit_spr(jm, jm.init_params(), memory_lean=True, gram=k, t_jitter=T_JITTER).state
    got = fit_spr(tm, memory_lean=True, gram=k, t_jitter=T_JITTER).state
    assert sorted(got) == sorted(want)
    assert int(got["chol_lower"]) == 0 and got["chol_lower"].dtype == torch.int32
    assert np.all(np.tril(to_numpy(got["chol"]), -1) == 0)
    for key in ("chol", "alpha") + (("d", "cond_df", "scale_ba") if method == "tp" else ()):
        _close(got[key], want[key])


@pytest.mark.parametrize("method", ["gp", "tp"])
def test_lean_fit_equals_the_default_fit(method):
    """Without ``gram`` (the Student-t fit computes the Gram twice): the same
    predictions as the default fit, whose factor is the lower one."""
    x, y, x_test, y_test = _data(seed=22)
    model = _torch_model(method, x, y)
    with torch.no_grad():
        lean = fit_spr(model, memory_lean=True, t_jitter=T_JITTER, var_floor=1e-6)
        full = fit_spr(model, t_jitter=T_JITTER, var_floor=1e-6)
        _close(lean.state["chol"].mT, full.state["chol"])
        for g, w in zip(lean.predict(to_torch(x_test)), full.predict(to_torch(x_test))):
            _close(g, to_numpy(w))
        _close(lean.test_nll(*to_torch(x_test, y_test)),
               to_numpy(full.test_nll(*to_torch(x_test, y_test))))


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("method", ["gp", "tp"])
def test_lean_state_serves_in_either_package(writer, method, tmp_path):
    x, y, x_test, y_test = _data(seed=23)
    jm, tm = _jax_model(method, x, y), _torch_model(method, x, y)
    path = str(tmp_path / "lean.npz")
    if writer == "jax":
        jfit_spr(jm, jm.init_params(), memory_lean=True, t_jitter=T_JITTER).save(path)
    else:
        with torch.no_grad():
            fit_spr(tm, memory_lean=True, t_jitter=T_JITTER).save(path)
    jf, tf = JFitted.load(path, jm), FittedSPR.load(path, tm)
    assert not tf._chol_lower and not jf._chol_lower
    with torch.no_grad():
        for g, w in zip(tf.predict(to_torch(x_test)), jf.predict(x_test)):
            _close(g, w)
        _close(tf.test_nll(*to_torch(x_test, y_test)), jf.test_nll(x_test, y_test))


def test_upper_factor_serving_solves_by_panels(monkeypatch):
    """Serving a lean state reads the factor in [block, block] pieces: no
    ``torch.cholesky_solve`` and no triangular solve against the whole
    factor (either would copy it)."""
    x, y, x_test, _ = _data(seed=24, n=2100)
    model = _torch_model("tp", x, y)
    with torch.no_grad():
        fitted = fit_spr(model, memory_lean=True, t_jitter=T_JITTER)
    solves = []
    real = torch.linalg.solve_triangular

    def spy(a, b, **kw):
        solves.append(a.shape[-1])
        return real(a, b, **kw)

    def refuse(*a, **kw):
        raise AssertionError("cholesky_solve copies its factor")

    monkeypatch.setattr(torch.linalg, "solve_triangular", spy)
    monkeypatch.setattr(torch, "cholesky_solve", refuse)
    with torch.no_grad():
        fitted.predict(to_torch(x_test))
        fitted._solve(fitted.state["chol"], model.y_data[:, None])
    assert solves and max(solves) == 700           # 2,100 = 3 panels of 700


def test_lean_fit_keeps_host_grams_and_consumes_device_grams():
    x, y, _, _ = _data(seed=25)
    for method in ("gp", "tp"):
        model = _torch_model(method, x, y)
        host = _gram(model)
        before = host.copy()
        with torch.no_grad():
            fit_spr(model, memory_lean=True, gram=host, t_jitter=T_JITTER)
        np.testing.assert_array_equal(host, before)
    # A device tensor of the model's dtype is factored in its own storage
    # (the JAX package donates it), as the default path never does.
    model = _torch_model("gp", x, y)
    dev = torch.as_tensor(_gram(model).copy())
    with torch.no_grad():
        fitted = fit_spr(model, memory_lean=True, gram=dev)
    assert fitted.state["chol"].data_ptr() == dev.data_ptr()
    # The Student-t fit stages a device gram to the host and leaves it be.
    model = _torch_model("tp", x, y)
    dev = torch.as_tensor(_gram(model).copy())
    keep = dev.clone()
    with torch.no_grad():
        fit_spr(model, memory_lean=True, gram=dev, t_jitter=T_JITTER)
    assert torch.equal(dev, keep)


def test_lean_fit_float64_round_off():
    x, y, _, _ = _data(seed=26)
    model = _torch_model("gp", x, y).to(torch.float64)
    with torch.no_grad():
        k = model._gram(model.kernel.get_kernel_fn()).numpy()
        fitted = fit_spr(model, memory_lean=True)
    eps = P.constrained_read(model.eps, model.bij).item()   # EPS, rounded through fp32
    reg = eps * np.trace(k) / k.shape[0]
    want = np.linalg.solve(k + reg * np.eye(k.shape[0]), model.y_data.numpy())
    _close(fitted.state["alpha"][:, 0], want, 1e-12)


def test_in_place_regularizer_is_bitwise_the_copy():
    k = torch.as_tensor(_psd_like(30))
    want = TL.add_diag_reg(k, 1e-3)
    ptr = k.data_ptr()
    got = TL._add_diag_reg_(k, 1e-3)
    assert got.data_ptr() == ptr and torch.equal(got, want)


def _psd_like(n):
    a = np.random.RandomState(27).randn(n, n).astype(np.float32)
    return a @ a.T / n
