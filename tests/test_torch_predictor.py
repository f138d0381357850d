"""Port parity: the model layer (snngp_torch/models) against snngp.models.

SPR.test_nll, fit_spr / FittedSPR.predict / test_nll for the Gaussian (gp)
and Student-t (tp) likelihoods on the same numpy data and parameters; the
fitted-state .npz and the checkpoint .npz must load in either package.

Tolerance for the model outputs: rtol 1e-4. The two frameworks' fp32 Grams
differ by ~1e-7 relative; the regularized train Gram (eps = 1e-3 of its mean
diagonal) has a condition number ~1e3, which amplifies that to ~1e-4 in the
solves. Within one framework the fitted path equals SPR.test_nll at 3e-5
(tests/test_predictor.py).

The fitted variances are held against a float64 fit instead
(``assert_fp32_reach``, ceilings in VAR_REACH): between the two packages
they differ by 2.9e-5 to 1.21e-4 of themselves with the host's MKL code
path, so a 1e-4 bar between them passed on one host and failed on another.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snngp.models import (SPR as JSPR, FittedSPR as JFitted,
                          GaussianLikelihood as JGauss, NNGPKernel as JKernel,
                          StudentTLikelihood as JStudent, fit_spr as jfit_spr)
from snngp.models import bijectors as JB
from snngp.models.params import named_leaves as j_named_leaves
from snngp.nn import arch as jarch
from snngp.utils import load_named as j_load_named, save_params as j_save_params

from snngp_torch.models import (SPR, FittedSPR, GaussianLikelihood, NNGPKernel,
                                StudentTLikelihood, fit_spr)
from snngp_torch.models import bijectors as TB
from snngp_torch.models.params import from_jax_named, named_leaves
from snngp_torch.nn import arch as tarch
from snngp_torch.utils import load_named, save_params

from _torch_parity import assert_fp32_reach, randn, to_numpy, to_torch

RTOL = 1e-4
# Ceilings of assert_fp32_reach on the fitted variance: each package's fp32
# error against a float64 fit, relative to its largest entry, within 4x the
# largest error either package showed on MKL's COMPATIBLE, SSE4_2, AVX, AVX2
# and AVX512 code paths and on AVX512 with one thread (beside each).
# test_var_reach_refuses_a_wrong_result holds each against a wrong result.
VAR_REACH = {"gp": 2e-5,     # largest 5.77e-6: the port, AVX2
             "tp": 1.2e-4}   # largest 3.12e-5: the port, AVX2
JAX_NAMES = {"gp": ["eps", "kernel.b_std", "kernel.last_w_std", "kernel.w_std"],
             "tp": ["eps", "kernel.b_std", "kernel.last_w_std", "kernel.w_std",
                    "likelihood.a", "likelihood.b"]}


def _data(n=24):
    x, y, x_test, y_test = randn(11, (n, 3), (n,), (9, 3), (9,))
    return x, y, x_test, y_test


def _jax_model(method, x, y):
    kernel = JKernel(lambda w, b, l: jarch.get_mlp_kernel(2, act="relu", w_std=w,
                                                          b_std=b, last_w_std=l),
                     1.2, 0.5, 0.9)
    lik = JGauss() if method == "gp" else JStudent(1.5, 2.5)
    return JSPR(kernel, lik, x, y, jnp.array(0.7), jnp.array(1.3), eps=1e-3)


def _torch_model(method, x, y):
    kernel = NNGPKernel(lambda w, b, l: tarch.get_mlp_kernel(2, act="relu", w_std=w,
                                                             b_std=b, last_w_std=l),
                        1.2, 0.5, 0.9)
    lik = GaussianLikelihood() if method == "gp" else StudentTLikelihood(1.5, 2.5)
    return SPR(kernel, lik, x, y, 0.7, 1.3, eps=1e-3)


@pytest.mark.parametrize("method", ["gp", "tp"])
def test_parameters_carry_the_jax_names_and_values(method):
    x, y, _, _ = _data()
    jparams = _jax_model(method, x, y).init_params()
    model = _torch_model(method, x, y)
    assert [n for n, _ in model.named_parameters()] == JAX_NAMES[method]
    assert [n for n, _ in j_named_leaves(jparams)] == JAX_NAMES[method]
    for (_, got), (_, want) in zip(named_leaves(model), j_named_leaves(jparams)):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-6)


def test_from_jax_named_round_trips():
    x, y, _, _ = _data()
    named = {n: np.float32(0.1 * i - 0.25) for i, n in enumerate(JAX_NAMES["tp"])}
    model = _torch_model("tp", x, y)
    model.load_state_dict(from_jax_named(named))
    back = {n: to_numpy(v) for n, v in named_leaves(model)}
    assert back.keys() == named.keys()
    for n in named:
        assert back[n] == named[n]


def test_softplus_bijector_matches():
    v = np.array([1e-3, 0.5, 3.0, 19.9, 25.0, 100.0], np.float32)
    np.testing.assert_allclose(to_numpy(TB.positive().inverse(to_torch(v))),
                               np.asarray(JB.positive().inverse(v)), rtol=1e-6)
    r = np.array([-5.0, 0.0, 2.0, 30.0], np.float32)
    np.testing.assert_allclose(to_numpy(TB.positive()(to_torch(r))),
                               np.asarray(JB.positive()(r)), rtol=1e-6)


@pytest.mark.parametrize("method", ["gp", "tp"])
def test_spr_test_nll_matches(method):
    x, y, x_test, y_test = _data()
    jm = _jax_model(method, x, y)
    want = float(jm.test_nll(jm.init_params(), x_test, y_test))
    with torch.inference_mode():
        got = float(_torch_model(method, x, y).test_nll(*to_torch(x_test, y_test)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def _fitted_var64(model, x_test, **fit_kw):
    """The fitted variance of a float64 copy of ``model``: the port's code
    in float64 on the same fp32 inputs and parameters."""
    with torch.no_grad():
        return fit_spr(copy.deepcopy(model).double(), **fit_kw).predict(
            to_torch(x_test, dtype=torch.float64))[1]


@pytest.mark.parametrize("method", ["gp", "tp"])
def test_fitted_predict_matches(method):
    x, y, x_test, _ = _data()
    jm = _jax_model(method, x, y)
    jmean, jvar = jfit_spr(jm, jm.init_params()).predict(x_test)
    model = _torch_model(method, x, y)
    mean, var = fit_spr(model).predict(to_torch(x_test))
    assert mean.shape == (9,) and var.shape == (9,) and bool((var > 0).all())
    # The mean's error is absolute: RTOL times its largest entry (~1.7) covers
    # entries that sit near zero.
    np.testing.assert_allclose(to_numpy(mean), np.asarray(jmean), rtol=RTOL,
                               atol=RTOL * float(np.abs(jmean).max()))
    assert_fp32_reach(var, jvar, _fitted_var64(model, x_test), VAR_REACH[method],
                      f"fitted {method} var")


@pytest.mark.parametrize("method", ["gp", "tp"])
def test_var_reach_refuses_a_wrong_result(method):
    """Each VAR_REACH ceiling refuses a stated mistake's float64 variance,
    rounded to fp32, that moves the result by a few times the ceiling or
    more: for tp the Student-t jitter at 2e-6 in place of 1e-6 (3.7e-4); for
    gp the relative regularizer over N - 1 points in place of N (eps tr(K) /
    (N - 1), 1.7e-3)."""
    x, y, x_test, _ = _data()
    jm = _jax_model(method, x, y)
    jvar = jfit_spr(jm, jm.init_params()).predict(x_test)[1]
    model = _torch_model(method, x, y)
    right = _fitted_var64(model, x_test)
    if method == "tp":
        wrong = _fitted_var64(model, x_test, t_jitter=2e-6)
    else:
        n = x.shape[0]
        wrong = _fitted_var64(SPR(model.kernel, model.likelihood, x, y, 0.7, 1.3,
                                  eps=1e-3 * n / (n - 1)), x_test)
    name = f"fitted {method} var"
    assert_fp32_reach(right.float(), jvar, right, VAR_REACH[method], name)
    with pytest.raises(AssertionError, match="the port errs"):
        assert_fp32_reach(wrong.float(), jvar, right, VAR_REACH[method], name)


@pytest.mark.parametrize("method", ["gp", "tp"])
def test_fitted_test_nll_chunked_matches(method):
    # batch=4 splits the 9 test points into 4 + 4 + 1.
    x, y, x_test, y_test = _data()
    jm = _jax_model(method, x, y)
    jfit = jfit_spr(jm, jm.init_params())
    fitted = fit_spr(_torch_model(method, x, y))
    want = float(jfit.test_nll(x_test, y_test, batch=4))
    got = float(fitted.test_nll(*to_torch(x_test, y_test), batch=4))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # Chunking changes only the blocking of the small matmuls: fp32
    # reassociation, which the gp NLL (~97, from tiny variances) shows at
    # ~2e-6 relative.
    unchunked = float(fitted.test_nll(*to_torch(x_test, y_test)))
    np.testing.assert_allclose(got, unchunked, rtol=1e-5)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_fitted_state_cross_loads(writer, tmp_path):
    x, y, x_test, y_test = _data()
    jm = _jax_model("tp", x, y)
    path = str(tmp_path / "fitted.npz")
    if writer == "torch":
        fit_spr(_torch_model("tp", x, y)).save(path)
        loaded = JFitted.load(path, jm)
        got = float(loaded.test_nll(x_test, y_test))
        want = float(jfit_spr(jm, jm.init_params()).test_nll(x_test, y_test))
    else:
        jfit_spr(jm, jm.init_params()).save(path)
        loaded = FittedSPR.load(path, _torch_model("tp", x, y))
        got = float(loaded.test_nll(*to_torch(x_test, y_test)))
        want = float(fit_spr(_torch_model("tp", x, y)).test_nll(*to_torch(x_test, y_test)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_checkpoint_cross_loads(writer, tmp_path):
    x, y, _, _ = _data()
    path = str(tmp_path / "000.npz")
    model = _torch_model("tp", x, y)
    jparams = _jax_model("tp", x, y).init_params()
    if writer == "torch":
        save_params(path, model)
        named = j_load_named(path)
    else:
        j_save_params(path, jparams)
        named = load_named(path)
    assert list(named) == JAX_NAMES["tp"]
    model.load_state_dict(from_jax_named(named))
    for (_, got), (_, want) in zip(named_leaves(model), j_named_leaves(jparams)):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-6)


def test_unported_fit_options_raise():
    # memory_lean fits (the upper factor; test_torch_memory_lean.py) and
    # extendable fits do, but not together, as in JAX.
    x, y, _, _ = _data()
    model = _torch_model("gp", x, y)
    with torch.no_grad():
        assert int(fit_spr(model, memory_lean=True).state["chol_lower"]) == 0
    with pytest.raises(ValueError, match="pick one"):
        fit_spr(model, memory_lean=True, extendable=True)
    with torch.no_grad():
        assert "reg" in fit_spr(model, extendable=True).state


def test_gram_argument_is_used_as_given():
    x, y, x_test, _ = _data()
    model = _torch_model("gp", x, y)
    with torch.no_grad():
        gram = model._gram(model.kernel.get_kernel_fn())
        a = fit_spr(model).predict(to_torch(x_test))
        b = fit_spr(model, gram=gram).predict(to_torch(x_test))
    for u, v in zip(a, b):
        np.testing.assert_array_equal(to_numpy(u), to_numpy(v))
