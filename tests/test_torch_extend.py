"""Port parity: extendable serving and upper-factor fitted states.

``chol_append`` (both orientations), ``fit_spr(extendable=True)``,
``FittedSPR.extend``, fitted states written by either package (extendable,
and the JAX package's memory-lean upper-factor states) loaded, served and
extended by the other, ``SNNGPRegressor(extendable=True).add_data``,
``reg pr --add-x / --add-y`` and ``snngp_torch.examples.online_regression``,
all on the same numpy inputs as the JAX package.

Tolerances (each plus 1e-5 of the largest entry, for entries that nearly
cancel, such as a posterior variance or a mean near zero):

- rtol 1e-5 where both packages start from the same arrays: ``chol_append``
  on the same blocks, and a JAX state served from the same Gram pieces
  (``predict_given``);
- rtol 1e-4 where each package builds its own Grams (``predict``,
  ``extend``): the two fp32 MLP Grams differ by ~1.7e-7 of max|K|, and the
  regularized train Gram (eps = 5e-2 of its mean diagonal) has a condition
  number ~5e2, which amplifies that to ~1e-5 on the means (measured); the
  1e-4 of tests/test_torch_predictor.py;
- rtol 1e-3 on Student-t variances of an upper-factor state: they carry d,
  solved against (b/a) K + 1e-6 I (the reference's jitter), whose
  condition number is far above the regularized Gram's;
- the extended Student-t d and variance, and the estimator's extended mean,
  std and d, each package against a float64 fit of the same bordered matrix
  under the fixed ceilings of REACH (``assert_fp32_reach``): there both
  packages sit at the fp32 limit of that solve, and the port's error moves
  by up to 5x with the host's MKL code path while JAX's does not, so a bar
  between the two (or on the port at a multiple of JAX's error) passed on
  one host and failed on another;
- between the two CLIs, whose paths differ end to end, on the near-singular
  syn-normal Gram: rtol 5e-3, tests/test_cli_smoke.py's bar.
"""

import copy
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snngp.models import (SPR as JSPR, FittedSPR as JFitted, GaussianLikelihood as JGauss,
                          NNGPKernel as JKernel, StudentTLikelihood as JStudent,
                          fit_spr as jfit_spr)
from snngp.nn import arch as jarch
from snngp.ops.linalg import chol_append as jchol_append
from snngp.sklearn import SNNGPRegressor as JRegressor

from snngp_torch.__main__ import main as torch_cli
from snngp_torch.models import (SPR, FittedSPR, GaussianLikelihood, NNGPKernel,
                                StudentTLikelihood, fit_spr)
from snngp_torch.models import params as P
from snngp_torch.nn import arch as tarch
from snngp_torch.ops.linalg import chol_append
from snngp_torch.sklearn import SNNGPRegressor
from snngp_torch.utils import save_params

from _torch_parity import assert_fp32_reach, randn, to_numpy, to_torch

RTOL = 1e-5
GRAM_RTOL = 1e-4    # each package's own Grams
T_VAR_RTOL = 1e-3   # Student-t variances through d
CLI_RTOL = 5e-3
EPS = 5e-2          # relative diag_reg of the toy models
# Ceilings of assert_fp32_reach: each package's fp32 error against a float64
# fit of the same bordered matrix (_bordered_fit64), relative to its largest
# entry, within 4x the largest error either package showed on MKL's
# COMPATIBLE, SSE4_2, AVX, AVX2 and AVX512 code paths and on AVX512 with one
# thread (beside each). test_reach_refuses_a_wrong_result holds each against
# a wrong result.
REACH = {
    "add_data mean": 5e-5,   # largest 1.50e-5: the port, SSE4_2 / AVX
    "add_data std": 1e-3,    # largest 2.56e-4: the port, AVX512
    "add_data d": 2e-3,      # largest 5.17e-4: the port, AVX512
    "extend var": 4e-4,      # largest 1.21e-4: the port, COMPATIBLE
    "extend d": 4e-4,        # largest 1.23e-4: the port, COMPATIBLE
}


def _close(got, want, rtol=RTOL, atol_rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(to_numpy(got), want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max())


def _data(seed=11, n=40, m=8):
    x, y, x_new, y_new, x_test = randn(seed, (n, 3), (n,), (m, 3), (m,), (9, 3))
    return x, y, x_new, y_new, x_test


def _jax_model(method, x, y):
    kernel = JKernel(lambda w, b, l: jarch.get_mlp_kernel(2, act="relu", w_std=w, b_std=b,
                                                          last_w_std=l),
                     1.2, 0.5, 0.9)
    lik = JGauss() if method == "gp" else JStudent(1.5, 2.5)
    return JSPR(kernel, lik, x, y, jnp.array(0.7), jnp.array(1.3), eps=EPS)


def _torch_model(method, x, y):
    kernel = NNGPKernel(lambda w, b, l: tarch.get_mlp_kernel(2, act="relu", w_std=w,
                                                             b_std=b, last_w_std=l),
                        1.2, 0.5, 0.9)
    lik = GaussianLikelihood() if method == "gp" else StudentTLikelihood(1.5, 2.5)
    return SPR(kernel, lik, x, y, 0.7, 1.3, eps=EPS)


def _spd(rng, n):
    a = rng.randn(n, n)
    return (a @ a.T / n + np.eye(n)).astype(np.float32)


# -- chol_append ----------------------------------------------------------------------

@pytest.mark.parametrize("lower", [True, False])
def test_chol_append_matches_jax(lower):
    rng = np.random.RandomState(3)
    full = _spd(rng, 30)
    a, k_nb, k_bb = full[:24, :24], full[:24, 24:], full[24:, 24:]
    chol = np.linalg.cholesky(a.astype(np.float64)).astype(np.float32)
    if not lower:
        chol = np.ascontiguousarray(chol.T)
    want = np.asarray(jchol_append(jnp.asarray(chol), jnp.asarray(k_nb), jnp.asarray(k_bb),
                                   lower=lower))
    got = chol_append(*to_torch(chol, k_nb, k_bb), lower=lower)
    _close(got, want)
    direct = np.linalg.cholesky(full.astype(np.float64))
    _close(got, direct if lower else direct.T, rtol=1e-4)


def test_chol_append_not_pd_gives_nan():
    rng = np.random.RandomState(4)
    full = _spd(rng, 12)
    chol = torch.linalg.cholesky(torch.as_tensor(full[:8, :8]))
    out = chol_append(chol, torch.as_tensor(full[:8, 8:]), -torch.eye(4))
    assert torch.isnan(torch.diagonal(out)[8:]).all()
    assert torch.isfinite(out[:8, :8]).all()


# -- fit_spr(extendable=True) / extend -------------------------------------------------

def _extended(method):
    """(the port's, the JAX package's) extendable fit of ``_data()``,
    extended by its new points, and the test inputs."""
    x, y, x_new, y_new, x_test = _data()
    jm = _jax_model(method, x, y)
    want = jfit_spr(jm, jm.init_params(), extendable=True)
    got = fit_spr(_torch_model(method, x, y), extendable=True)
    _close(got.state["reg"], want.state["reg"], rtol=GRAM_RTOL)
    with torch.no_grad():
        got = got.extend(*to_torch(x_new, y_new))
    assert got.model.num_data == x.shape[0] + x_new.shape[0]
    return got, want.extend(x_new, y_new), x_test


@pytest.mark.parametrize("method", ["gp", "tp"])
def test_extend_matches_jax(method):
    # The Student-t d = 2a + y^T((b/a) K + 1e-6 I)^{-1} y, and the variance
    # that carries it, are held against the float64 fit: here JAX's d errs
    # by 7.6e-6 and the port's by 6.4e-5 to 1.23e-4 with the MKL code path,
    # through the same steps; over 40 other seeds the two packages' errors
    # have the same spread (medians 3.4e-5 and 4.6e-5 on AVX512).
    got, want, x_test = _extended(method)
    with torch.no_grad():
        (gm, gv), (wm, wv) = got.predict(to_torch(x_test)), want.predict(x_test)
    _close(gm, wm, rtol=GRAM_RTOL)
    if method == "gp":
        _close(gv, wv, rtol=GRAM_RTOL)
    else:
        ref = _served64(_bordered_fit64(got), x_test)
        assert_fp32_reach(gv, wv, ref["var"], REACH["extend var"], "extend var")
        assert_fp32_reach(got.state["d"], want.state["d"], ref["d"], REACH["extend d"],
                          "extend d")
        assert float(got.state["cond_df"]) == float(want.state["cond_df"])


@pytest.mark.parametrize("method", ["gp", "tp"])
def test_extend_equals_a_fit_of_the_bordered_matrix(method):
    # The frozen regularizer goes on the new diagonal block: an extended
    # predictor equals a direct factorization of the same bordered matrix.
    x, y, x_new, y_new, x_test = _data(seed=12)
    model = _torch_model(method, x, y)
    with torch.no_grad():
        fitted = fit_spr(model, extendable=True)
        ext = fitted.extend(*to_torch(x_new, y_new))
        k = model.kernel.K(model.kernel.get_kernel_fn(), to_torch(np.concatenate([x, x_new])))
        k = k + fitted.state["reg"] * torch.eye(k.shape[0])
        chol = torch.linalg.cholesky(k)
        _close(ext.state["chol"], chol, rtol=1e-4)
        want = torch.cholesky_solve(ext.model.y_data[:, None], chol)
        _close(ext.state["alpha"], want, rtol=1e-4)


def test_extend_needs_an_extendable_fit():
    x, y, x_new, y_new, _ = _data()
    fitted = fit_spr(_torch_model("gp", x, y))
    with pytest.raises(ValueError, match="extendable"):
        fitted.extend(*to_torch(x_new, y_new))


# -- states written by either package ----------------------------------------------------

@pytest.mark.parametrize("method", ["gp", "tp"])
def test_jax_memory_lean_state_loads_and_serves(method, tmp_path):
    x, y, _, _, x_test = _data()
    jm = _jax_model(method, x, y)
    jf = jfit_spr(jm, jm.init_params(), memory_lean=True)
    assert int(jf.state["chol_lower"]) == 0
    path = str(tmp_path / "lean.npz")
    jf.save(path)
    loaded = FittedSPR.load(path, _torch_model(method, x, y))
    assert not loaded._chol_lower
    y_test = randn(5, (9,))[0]
    with torch.no_grad():
        for g, w in zip(loaded.predict(to_torch(x_test)), jf.predict(x_test)):
            _close(g, w, rtol=GRAM_RTOL)
        _close(loaded.test_nll(*to_torch(x_test, y_test)), jf.test_nll(x_test, y_test),
               rtol=GRAM_RTOL)
        k_td = jm.kernel.K(jm.kernel.get_kernel_fn(jf.params["kernel"]), x_test, x)
        k_tt = jnp.diag(jm.kernel.K(jm.kernel.get_kernel_fn(jf.params["kernel"]), x_test))
        for g, w in zip(loaded.predict_given(np.asarray(k_td), np.asarray(k_tt)),
                        jf.predict_given(k_td, k_tt)):
            _close(g, w)
        _close(loaded.test_nll_given(np.asarray(k_td), np.asarray(k_tt), to_torch(y_test)),
               jf.test_nll_given(k_td, k_tt, y_test))


@pytest.mark.parametrize("method", ["gp", "tp"])
def test_upper_factor_state_extends(method, tmp_path):
    # An extendable state in the upper orientation (a memory-lean fit's
    # factor with the extendable keys): extend grows U, as in JAX.
    x, y, x_new, y_new, x_test = _data(seed=13)
    jm = _jax_model(method, x, y)
    jf = jfit_spr(jm, jm.init_params(), extendable=True)
    state = dict(jf.state)
    state["chol"] = jnp.asarray(np.ascontiguousarray(np.asarray(state["chol"]).T))
    state["chol_lower"] = jnp.asarray(0, jnp.int32)
    if method == "tp":
        state["chol_t"] = jnp.asarray(np.ascontiguousarray(np.asarray(state["chol_t"]).T))
    ju = JFitted(jm, jf.params, state)
    path = str(tmp_path / "upper.npz")
    ju.save(path)
    loaded = FittedSPR.load(path, _torch_model(method, x, y))
    want = ju.extend(x_new, y_new)
    with torch.no_grad():
        got = loaded.extend(*to_torch(x_new, y_new))
        assert int(got.state["chol_lower"]) == 0
        (gm, gv), (wm, wv) = got.predict(to_torch(x_test)), want.predict(x_test)
        _close(gm, wm, rtol=GRAM_RTOL)
        _close(gv, wv, rtol=GRAM_RTOL if method == "gp" else T_VAR_RTOL)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_extendable_state_cross_loads_and_extends(writer, tmp_path):
    x, y, x_new, y_new, x_test = _data(seed=14)
    jm = _jax_model("tp", x, y)
    tm = _torch_model("tp", x, y)
    path = str(tmp_path / "ext.npz")
    if writer == "jax":
        jfit_spr(jm, jm.init_params(), extendable=True).save(path)
        ref = JFitted.load(path, jm)
    else:
        with torch.no_grad():
            fit_spr(tm, extendable=True).save(path)
        ref = JFitted.load(path, jm)
    assert "reg" in ref.state and "chol_t" in ref.state
    want = ref.extend(x_new, y_new)
    got = FittedSPR.load(path, _torch_model("tp", x, y))
    with torch.no_grad():
        got = got.extend(*to_torch(x_new, y_new))
        for g, w in zip(got.predict(to_torch(x_test)), want.predict(x_test)):
            _close(g, w, rtol=GRAM_RTOL)


def test_extended_state_round_trips(tmp_path):
    # Saved, reloaded and extended again: bitwise the in-memory result.
    x, y, x_new, y_new, x_test = _data(seed=15)
    y_more = randn(6, (x_test.shape[0],))[0]
    with torch.no_grad():
        ext = fit_spr(_torch_model("tp", x, y), extendable=True).extend(*to_torch(x_new,
                                                                                  y_new))
        path = str(tmp_path / "ext.npz")
        ext.save(path)
        back = FittedSPR.load(path, _torch_model("tp", to_numpy(ext.model.x_data),
                                                 to_numpy(ext.model.y_data)))
        got = back.extend(*to_torch(x_test, y_more))
        want = ext.extend(*to_torch(x_test, y_more))
    for key in ("chol", "alpha", "chol_t", "d", "reg"):
        np.testing.assert_array_equal(to_numpy(got.state[key]), to_numpy(want.state[key]))


# -- the estimator, the CLI and the example ------------------------------------------------

def _bordered_fit64(fitted, t_jitter=1e-6, frozen_reg=True):
    """A fresh float64 fit of the bordered matrix that ``extend`` factored:
    K + reg I with the frozen regularizer, and the Student-t factor of
    (b/a) K + 1e-6 I (fit_spr's and extend's jitter), on a float64 copy of
    the extended model. The mistakes of test_reach_refuses_a_wrong_result:
    another ``t_jitter``; ``frozen_reg=False``, the regularizer re-derived
    from the grown Gram (eps tr(K) / N, as a refit would apply it)."""
    from snngp_torch.ops.linalg import chol_quad_form, chol_solve, cholesky

    model = copy.deepcopy(fitted.model).double()
    k = model.kernel.K(model.kernel.get_kernel_fn(), model.x_data)
    eye = torch.eye(k.shape[0], dtype=torch.float64)
    a, b = model.likelihood._ab()
    y = model.y_data
    reg = (float(fitted.state["reg"]) if frozen_reg
           else float(P.constrained_read(model.eps, model.bij) * torch.trace(k) / k.shape[0]))
    chol_t = cholesky((b / a) * k + t_jitter * eye)
    chol = cholesky(k + reg * eye)
    return FittedSPR(model, {"chol": chol, "alpha": chol_solve(chol, y[:, None]),
                             "y_mean": model.y_mean, "y_std": model.y_std,
                             "d": 2.0 * a + chol_quad_form(chol_t, y),
                             "cond_df": 2.0 * a + k.shape[0], "scale_ba": b / a})


def _added():
    """(the port's, the JAX package's) SNNGPRegressor fitted on seed 16's data
    and grown by ``add_data``, and the test inputs."""
    x, y, x_new, y_new, x_test = _data(seed=16)
    kw = dict(method="tp", num_hiddens=2, eps=EPS, extendable=True)
    want = JRegressor(**kw).fit(x, y).add_data(x_new, y_new)
    got = SNNGPRegressor(**kw, device="cpu").fit(x, y).add_data(x_new, y_new)
    assert got.model_.num_data == want.model_.num_data == 48
    return got, want, x_test


def _served64(fitted, x_test):
    """{"mean", "std", "var", "d"} of a float64 fitted state at ``x_test``."""
    with torch.no_grad():
        mean, var = fitted.predict(to_torch(x_test, dtype=torch.float64))
    return {"mean": mean, "std": torch.sqrt(var), "var": var, "d": fitted.state["d"]}


def test_regressor_add_data_matches_jax():
    # Each package's fp32 mean, std and d against a float64 fit of the same
    # bordered matrix. d goes through (b/a) K + 1e-6 I, of condition number
    # 3.25e5 here: both packages sit at the fp32 limit of that solve, where
    # the port's d errs by 1.05e-4 to 5.17e-4 with the MKL code path and
    # JAX's by 1.99e-4 on every path. The stds are tied to each other too
    # (rtol T_VAR_RTOL).
    got, want, x_test = _added()
    (gm, gs), (wm, ws) = got.predict(x_test, return_std=True), want.predict(x_test,
                                                                            return_std=True)
    ref = _served64(_bordered_fit64(got.fitted_), x_test)
    for name, g, w in (("mean", gm, wm), ("std", gs, ws),
                       ("d", got.fitted_.state["d"], want.fitted_.state["d"])):
        assert_fp32_reach(g, w, ref[name], REACH[f"add_data {name}"], f"add_data {name}")
    _close(gs, ws, rtol=T_VAR_RTOL)


@pytest.mark.parametrize("name", list(REACH))
def test_reach_refuses_a_wrong_result(name):
    """Each REACH ceiling refuses a stated mistake's float64 result, rounded
    to fp32, on the same inputs, while the float64 fit itself passes. For d,
    the std and the variance: the Student-t jitter at 2e-6 in place of 1e-6
    (it moves d by 1.27% at seed 16, 0.124% at seed 11). For the mean, which
    the jitter does not move: the regularizer re-derived from the grown Gram
    in place of the frozen one (0.95% of max|mean| at seed 16)."""
    case, quantity = name.split()
    if case == "add_data":
        got, want, x_test = _added()
        fitted = got.fitted_
        mean, std = want.predict(x_test, return_std=True)
        jax_value = {"mean": mean, "std": std, "d": want.fitted_.state["d"]}[quantity]
    else:
        fitted, want, x_test = _extended("tp")
        jax_value = {"var": want.predict(x_test)[1], "d": want.state["d"]}[quantity]
    mistake = (dict(frozen_reg=False) if quantity == "mean" else dict(t_jitter=2e-6))
    right = _served64(_bordered_fit64(fitted), x_test)[quantity]
    wrong = _served64(_bordered_fit64(fitted, **mistake), x_test)[quantity]
    assert_fp32_reach(right.float(), jax_value, right, REACH[name], name)
    with pytest.raises(AssertionError, match="the port errs"):
        assert_fp32_reach(wrong.float(), jax_value, right, REACH[name], name)


def _jax_cli(argv):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import run as run_mod
    run_mod.main(argv)


def _checkpoint(root):
    """A JAX-format reg checkpoint of a tp MLP on syn-normal (raw values)."""
    from snngp_torch.models.bijectors import positive
    inv = positive().inverse
    raw = lambda v: inv(torch.tensor(v, dtype=torch.float32)).numpy()  # noqa: E731
    os.makedirs(root)
    save_params(os.path.join(root, "000.npz"), {
        "eps": raw(1e-2),
        "kernel": {"w_std": raw(1.3), "b_std": raw(0.3), "last_w_std": raw(1.0)},
        "likelihood": {"a": raw(2.0), "b": raw(0.02)},
    })
    np.save(os.path.join(root, "meta.npy"), dict(args=dict(
        method="tp", network="mlp", data_name="syn-normal", num_hiddens=2,
        activation="relu", w_std=1.3, b_std=0.3, last_w_std=1.0, alpha=2.0, beta=0.02,
        epsilon=1e-2)))


def test_reg_pr_add_x_matches_jax(tmp_path):
    ckpt = str(tmp_path / "ck")
    _checkpoint(ckpt)
    rng = np.random.RandomState(17)
    add_x, add_y = str(tmp_path / "ax.npy"), str(tmp_path / "ay.npy")
    np.save(add_x, rng.randn(6, 1).astype(np.float32))
    np.save(add_y, rng.randn(6).astype(np.float32))
    log = os.path.join(ckpt, "predict", "predict.log")
    out = {}
    for who, run in (("jax", _jax_cli), ("torch", lambda a: torch_cli(["--device", "cpu",
                                                                         *a]))):
        fs = str(tmp_path / f"{who}.fs.npz")
        common = ["reg", "pr", "-cd", ckpt, "-o", str(tmp_path / f"{who}.npz"), "-fs", fs,
                  "-q"]
        run(common)                                  # a plain, non-extendable cache
        run([*common, "-ax", add_x, "-ay", add_y])   # refit once, rewrite, extend
        text = open(log).read()
        assert "refitting with extendable=True" in text and "refreshed" in text
        assert "extended conditioning set by 6 -> 86 points" in text
        run([*common, "-ax", add_x, "-ay", add_y])   # the rewritten cache extends
        text = open(log).read()
        assert "loaded fitted state" in text and "refitting" not in text
        out[who] = (float(text.split("NLL:")[-1].split()[0]),
                    np.load(str(tmp_path / f"{who}.npz")))
    np.testing.assert_allclose(out["torch"][0], out["jax"][0], rtol=CLI_RTOL)
    np.testing.assert_allclose(out["torch"][1]["mean"], out["jax"][1]["mean"], rtol=CLI_RTOL,
                               atol=CLI_RTOL * np.abs(out["jax"][1]["mean"]).max())
    with pytest.raises(ValueError, match="go together"):
        torch_cli(["--device", "cpu", "reg", "pr", "-cd", ckpt, "-ax", add_x, "-q"])


def test_online_regression_example_matches_jax(capsys, monkeypatch):
    import runpy
    from snngp_torch.examples import online_regression

    flags = ["--n0", "48", "--batch", "16", "--rounds", "2", "--n-test", "24", "--dim", "4"]
    rows = online_regression.main(["--device", "cpu", *flags])
    assert [r[0] for r in rows] == [48, 64, 80]
    capsys.readouterr()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.setattr(sys, "argv", ["online_regression.py", *flags])
    runpy.run_path(os.path.join(root, "examples", "online_regression.py"),
                   run_name="__main__")
    want = [float(line.split("test NLL")[-1]) for line in capsys.readouterr().out.splitlines()
            if "test NLL" in line]
    # The JAX script prints four decimals.
    np.testing.assert_allclose([r[3] for r in rows], want, atol=1e-4 + 1e-5)
