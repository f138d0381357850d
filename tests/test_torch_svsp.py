"""Port parity of sparse variational classification: the softmax
estimators, the priors' KLs and samplers, the SVSP linear-algebra guards,
``SVSP.loss`` / ``test_acc_nll`` with their gradients, ``fit_svsp`` /
``FittedSVSP`` and their files, and ``SNNGPClassifier``, each against the
JAX package on the same numpy inputs.

Random draws: the port is fed the standard variates JAX used, recovered
from the same key — ``jax.random.normal(key, (S, C, B))`` for
``multivariate_normal`` (which draws its normals from the key it is given),
and for ``jax.random.t`` the split key's normal and Gamma(df / 2) draws
(``key_n, key_g = split(key)``). Only the samplers themselves are tested
statistically.

Tolerances:
- estimators, KLs, the guards and the losses: rtol 1e-5 (fp32 round-off
  through a few reductions; slogdet and Cholesky factors of a 5 x 5
  inducing Gram);
- gradients of the ELBO: rtol 1e-4 with an atol of 1e-5 of the largest
  entry, the ``SPR.loss`` bar of tests/test_torch_grad.py (gradients
  through two fp32 factorizations and an eigh);
- the sampler statistics: 5 standard errors of the moment estimates.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from snngp.models import SVSP as JSVSP, NNGPKernel as JK, GaussianPrior as JG
from snngp.models import InverseGammaPrior as JI
from snngp.models.params import named_leaves as jnamed
from snngp.models.predictor import FittedSVSP as JFitted, fit_svsp as jfit_svsp
from snngp.nn.arch import get_cnn_kernel as jcnn
from snngp.ops import linalg as jlinalg
from snngp.ops import softmax as jsoftmax
from snngp.ops.mvt import multivariate_t as jmvt

from snngp_torch.models import SVSP as TSVSP, NNGPKernel as TK, GaussianPrior as TG
from snngp_torch.models import InverseGammaPrior as TI
from snngp_torch.models.params import from_jax_named
from snngp_torch.models.predictor import FittedSVSP as TFitted, fit_svsp as tfit_svsp
from snngp_torch.nn.arch import get_cnn_kernel as tcnn
from snngp_torch.ops import linalg as tlinalg
from snngp_torch.ops import softmax as tsoftmax
from snngp_torch.ops.mvt import TDraws, draw_t, multivariate_t as tmvt, standard_t
from snngp_torch.parallel import get_mesh
from snngp_torch.parallel.cholesky import blocked_cholesky
from snngp_torch.sklearn import SNNGPClassifier
from snngp_torch.utils import Adam, Profiler, svsp_train_step

from _torch_parity import randn, to_numpy, to_torch

B, I, C, S = 6, 5, 3, 7
SHAPES = {"8x8x1": (8, 8, 1), "6x5x2": (6, 5, 2)}


def _close(got, want, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=rtol, atol=atol)


# -- estimators, KLs, guards ----------------------------------------------------

def test_softmax_estimators_match():
    # Training: mean of log-softmax; testing: log of mean probability.
    (f,) = randn(1, (C, B, S))
    y = np.random.RandomState(2).randint(C, size=B)
    ft, yt = to_torch(f), torch.as_tensor(y)
    _close(tsoftmax.get_true_values(ft, yt), jsoftmax.get_true_values(f, y))
    _close(tsoftmax.log_likelihood(ft, yt), jsoftmax.log_likelihood(f, y))
    _close(tsoftmax.test_log_likelihood(ft, yt), jsoftmax.test_log_likelihood(f, y))
    assert int(tsoftmax.get_correct_count(ft, yt)) == int(jsoftmax.get_correct_count(f, y))
    assert tsoftmax.log_likelihood(ft, yt) < tsoftmax.test_log_likelihood(ft, yt)


def _kl_inputs(seed):
    (a, q_mu, q) = randn(seed, (I, I), (C, I), (C, I))
    k_ii = a @ a.T + 0.5 * np.eye(I, dtype=np.float32)
    return k_ii, np.linalg.inv(k_ii).astype(np.float32), q_mu, np.abs(q) + 0.1


def test_kl_divergences_match():
    k_ii, k_inv, q_mu, q_sqrt = _kl_inputs(3)
    args_j = (k_ii, k_inv, q_mu, q_sqrt, I, C)
    args_t = (*to_torch(k_ii, k_inv, q_mu, q_sqrt), I, C)
    _close(TG().kl_divergence(*args_t), JG().kl_divergence({}, *args_j))
    jp, tp = JI(2.0, 3.0), TI(2.0, 3.0)
    jparams = jp.init_params()
    jparams["a"] = jparams["a"] + 0.3
    with torch.no_grad():
        tp.a.add_(0.3)
    _close(tp.kl_divergence(*args_t), jp.kl_divergence(jparams, *args_j))
    a, b = torch.tensor(1.7), torch.tensor(2.4)
    _close(tp.kl_divergence2(*args_t, a, b), jp.kl_divergence2(*args_j, 1.7, 2.4))


def test_psd_safety_lift_matches():
    # A no-op on a well-conditioned PD matrix (bitwise), a lift of the
    # smallest eigenvalue to mult * eps * max_eig otherwise, batched.
    k_ii, *_ = _kl_inputs(4)
    t = to_torch(k_ii)
    assert torch.equal(tlinalg.psd_safety_lift(t), t)
    bad = k_ii.copy()
    bad[0, 0] -= 50.0
    batch = np.stack([k_ii, bad])
    got = tlinalg.psd_safety_lift(to_torch(batch), mult=I)
    _close(got, jlinalg.psd_safety_lift(batch, mult=I), rtol=1e-5, atol=1e-5)
    assert torch.linalg.eigvalsh(got[1].double()).min() > 0


@pytest.mark.parametrize("kind", ["pd", "indefinite"])
def test_pinv_psd_eigh_and_its_inverse_rule_backward_match(kind):
    k_ii, *_ = _kl_inputs(5)
    if kind == "indefinite":
        k_ii = k_ii.copy()
        k_ii[0, 0] -= 50.0
    (g,) = randn(6, (I, I))
    want = np.asarray(jlinalg.pinv_psd_eigh(k_ii))
    want_grad = np.asarray(jax.grad(
        lambda m: jnp.sum(jnp.asarray(g) * jlinalg.pinv_psd_eigh(m)))(k_ii))
    m = torch.tensor(k_ii, requires_grad=True)
    got = tlinalg.pinv_psd_eigh(m)
    (torch.as_tensor(g) * got).sum().backward()
    scale = np.abs(want).max()
    _close(got, want, rtol=1e-4, atol=1e-5 * scale)
    _close(m.grad, want_grad, rtol=1e-4, atol=1e-5 * np.abs(want_grad).max())


def test_inv_psd_matches_and_nans_where_not_pd():
    k_ii, *_ = _kl_inputs(7)
    _close(tlinalg.inv_psd(to_torch(k_ii)), jlinalg.inv_psd(k_ii), rtol=1e-5, atol=1e-6)
    assert torch.isnan(tlinalg.inv_psd(to_torch(-k_ii))).all()


# -- samplers -------------------------------------------------------------------

def test_multivariate_t_with_injected_draws_matches_and_differentiates_df():
    (mean,) = randn(8, (C, B))
    cov = np.stack([np.eye(B, dtype=np.float32) * 0.5 + 0.1] * C)
    key = random.PRNGKey(4)
    key_n, key_g = random.split(key)
    draws = TDraws(to_torch(np.asarray(random.normal(key_n, (S, C, B)))),
                   to_torch(np.asarray(random.gamma(key_g, jnp.float32(1.6), (S, C, B)))))

    def f_jax(df):
        return jnp.sum(jnp.sin(jmvt(key, df, mean, cov, shape=(S, C))))

    want, want_grad = jax.value_and_grad(f_jax)(jnp.float32(3.2))
    df = torch.tensor(3.2, requires_grad=True)
    got = torch.sum(torch.sin(tmvt(df, *to_torch(mean, cov), shape=(S, C), draws=draws)))
    got.backward()
    _close(got, want, rtol=1e-5)
    _close(df.grad, want_grad, rtol=1e-4)


@pytest.mark.parametrize("prior", ["gaussian", "inverse-gamma"])
def test_sample_f_iid_with_injected_draws_matches(prior):
    (mean, a) = randn(10, (C, B), (C, B, B))
    cov = np.einsum("cij,ckj->cik", a, a)
    key = random.PRNGKey(5)
    if prior == "gaussian":
        jp, tp, jparams = JG(), TG(), {}
        draws = to_torch(np.asarray(random.normal(key, (C, B, S))))
    else:
        jp, tp = JI(2.0, 2.0), TI(2.0, 2.0)
        jparams = jp.init_params()
        key_n, key_g = random.split(key)
        draws = TDraws(to_torch(np.asarray(random.normal(key_n, (C, B, S)))),
                       to_torch(np.asarray(random.gamma(key_g, jnp.float32(2.0), (C, B, S)))))
    want = jp.sample_f_iid(jparams, key, mean, cov, S)
    got = tp.sample_f_iid(*to_torch(mean, cov), S, draws=draws)
    _close(got, want, rtol=1e-5, atol=1e-6)


def test_samplers_draw_the_right_distributions():
    # Statistical checks of the generator path: Student-t with df = 5 has
    # mean 0 and variance df / (df - 2); the correlated Gaussian draws have
    # the requested covariance.
    gen = torch.Generator().manual_seed(0)
    n = 200_000
    x = standard_t(torch.tensor(5.0), draw_t(torch.tensor(5.0), (n,), gen)).double()
    assert abs(x.mean().item()) < 5 * np.sqrt(5 / 3 / n)
    assert abs(x.var().item() - 5 / 3) < 5 * 0.05   # the t variance's se ~ 0.04 at df 5
    cov = torch.tensor([[1.0, 0.6], [0.6, 2.0]])
    f = TG().sample_f(torch.zeros(1, 2), cov[None], 50_000, gen)      # [1, 2, S]
    emp = torch.cov(f[0].double())
    assert torch.allclose(emp, cov.double(), atol=5 * np.sqrt(2 * 2.0 ** 2 / 50_000))


# -- the SVSP model -------------------------------------------------------------

def _models(method, shape, seed=11):
    """The JAX and the port's SVSP built from one numpy seed, the port's
    loaded from the JAX parameter dict by ``from_jax_named``."""
    rng = np.random.RandomState(seed)
    z = rng.randn(I, *shape).astype(np.float32)
    jk = JK(lambda w, b, l: jcnn(2, C, "relu", w_std=w, b_std=b, last_w_std=l), 1.2, 0.1, 1.0)
    tk = TK(lambda w, b, l: tcnn(2, C, "relu", w_std=w, b_std=b, last_w_std=l), 1.2, 0.1, 1.0)
    jp, tp = (JG(), TG()) if method == "svgp" else (JI(2.0, 2.0), TI(2.0, 2.0))
    jm = JSVSP(jp, jk, z, num_latent_gps=C, eps=1e-3)
    tm = TSVSP(tp, tk, z, num_latent_gps=C, eps=1e-3)
    params = jm.init_params()
    params["q_mu"] = jnp.asarray(0.3 * rng.randn(C, I).astype(np.float32))
    params["q_sqrt"] = params["q_sqrt"] + jnp.asarray(0.2 * rng.randn(C, I).astype(np.float32))
    tm.load_state_dict(from_jax_named(jax.tree.map(np.asarray, params)))
    x = rng.randn(B, *shape).astype(np.float32)
    y = rng.randint(C, size=B)
    return jm, tm, params, x, y


def _draws(method, params, key, shape):
    if method == "svgp":
        return to_torch(np.asarray(random.normal(key, shape)))
    a = jax.nn.softplus(params["prior"]["a"])
    key_n, key_g = random.split(key)
    return TDraws(to_torch(np.asarray(random.normal(key_n, shape))),
                  to_torch(np.asarray(random.gamma(key_g, a, shape))))


@pytest.mark.parametrize("method", ["svgp", "svtp"])
def test_parameters_carry_the_jax_names(method):
    jm, tm, params, _, _ = _models(method, SHAPES["8x8x1"])
    want = {n: np.asarray(v) for n, v in jnamed(params)}
    got = {n: to_numpy(p) for n, p in tm.named_parameters()}
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n])


@pytest.mark.parametrize("method", ["svgp", "svtp"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_elbo_and_its_gradients_match(method, shape):
    jm, tm, params, x, y = _models(method, SHAPES[shape])
    key = random.PRNGKey(3)
    (want, (want_ll, want_kl)), grads = jax.value_and_grad(
        lambda p: jm.loss(p, key, x, y, 100, S, aux=True), has_aux=True)(params)
    got, (got_ll, got_kl) = tm.loss(to_torch(x), torch.as_tensor(y), 100, S,
                                    draws=_draws(method, params, key, (S, C, B)), aux=True)
    got.backward()
    _close(got, want)
    _close(got_ll, want_ll)
    _close(got_kl, want_kl)
    want_g = dict(jnamed(grads))
    for name, p in tm.named_parameters():
        wg = np.asarray(want_g[name])
        _close(p.grad, wg, rtol=1e-4, atol=1e-5 * np.abs(wg).max())


@pytest.mark.parametrize("method", ["svgp", "svtp"])
def test_test_acc_nll_and_its_gradients_match(method):
    jm, tm, params, x, y = _models(method, SHAPES["6x5x2"])
    key = random.PRNGKey(6)
    (want_nll, want_cc), grads = jax.value_and_grad(
        lambda p: jm.test_acc_nll(p, key, x, y, S), has_aux=True)(params)
    got_nll, got_cc = tm.test_acc_nll(to_torch(x), torch.as_tensor(y), S,
                                      draws=_draws(method, params, key, (C, B, S)))
    got_nll.backward()
    _close(got_nll, want_nll)
    assert int(got_cc) == int(want_cc)
    want_g = dict(jnamed(grads))
    for name, p in tm.named_parameters():
        wg = np.asarray(want_g[name])
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        _close(got, wg, rtol=1e-4, atol=1e-5 * max(np.abs(wg).max(), 1e-30))


def test_mesh_and_chol_fn_are_not_ported():
    # Both are ported: SVSP(chol_fn=) keeps the factorization, SVSP(mesh=)
    # installs the blocked one with chol_block (tests/test_torch_mesh_cls.py
    # holds both against the JAX package); on this well-conditioned inducing
    # Gram the ELBO equals the eigh path's (rtol 1e-5).
    z = np.zeros((2, 4, 4, 1), np.float32)
    chol = functools.partial(blocked_cholesky, block=2)
    assert TSVSP(TG(), TK(lambda *a: None), z, chol_fn=chol).chol_fn is chol
    meshed = TSVSP(TG(), TK(lambda *a: None), z, mesh=get_mesh(2, device="cpu"),
                   chol_block=4)
    assert meshed.chol_fn.func is blocked_cholesky and meshed.chol_fn.keywords == {"block": 4}
    jm, tm, params, x, y = _models("svtp", SHAPES["8x8x1"])
    draws = _draws("svtp", params, random.PRNGKey(3), (S, C, B))
    with torch.no_grad():
        want = tm.loss(to_torch(x), torch.as_tensor(y), 100, S, draws=draws)
        tm.chol_fn = chol
        got = tm.loss(to_torch(x), torch.as_tensor(y), 100, S, draws=draws)
    _close(got, to_numpy(want))


def test_svsp_train_step_reports_each_phase():
    _, tm, _, x, y = _models("svtp", SHAPES["8x8x1"])
    prof = Profiler()
    opt = Adam(tm)
    before = tm.kernel.w_std.detach().clone()
    loss = svsp_train_step(tm, [opt], [1e-2], to_torch(x), torch.as_tensor(y), 100, S,
                           torch.Generator().manual_seed(0), prof)
    assert torch.isfinite(loss)
    assert set(prof.totals) == {"gram", "posterior", "sampling+likelihood", "backward",
                                "optimizer"}
    assert not torch.equal(before, tm.kernel.w_std.detach())


# -- fitted predictor -----------------------------------------------------------

@pytest.mark.parametrize("method", ["svgp", "svtp"])
def test_fitted_svsp_matches(method):
    jm, tm, params, x, y = _models(method, SHAPES["8x8x1"])
    jf = jfit_svsp(jm, params)
    with torch.no_grad():
        tf = tfit_svsp(tm)
        xt = to_torch(x)
        for name in ("z", "k_ii_inv", "k_rel_inv", "w", "q_sqrt"):
            scale = np.abs(np.asarray(jf.state[name])).max()
            _close(tf.state[name], jf.state[name], rtol=1e-4, atol=1e-5 * scale)
        want_mean, want_cov = jf.predict_f(x)
        got_mean, got_cov = tf.predict_f(xt)
        _close(got_mean, want_mean, rtol=1e-4, atol=1e-6)
        _close(got_cov, want_cov, rtol=1e-4, atol=1e-6)
        key = random.PRNGKey(7)
        draws = _draws(method, params, key, (C, B, S))
        want_nll, want_cc = jf.test_acc_nll(key, x, y, S)
        got_nll, got_cc = tf.test_acc_nll(xt, torch.as_tensor(y), S, draws=draws)
        _close(got_nll, want_nll, rtol=1e-5)
        assert int(got_cc) == int(want_cc)
        _close(tf.predict_proba(xt, S, draws=draws), jf.predict_proba(key, x, S),
               rtol=1e-5, atol=1e-7)
        # SVSP.test_acc_nll and the fitted predictor agree on the same draws.
        nll, _ = tm.test_acc_nll(xt, torch.as_tensor(y), S, draws=draws)
        _close(got_nll, to_numpy(nll), rtol=1e-5)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_fitted_svsp_files_cross_load(writer, tmp_path):
    jm, tm, params, x, _ = _models("svtp", SHAPES["8x8x1"])
    path = str(tmp_path / "fitted.npz")
    if writer == "jax":
        jfit_svsp(jm, params).save(path)
        _, tm2, _, _, _ = _models("svtp", SHAPES["8x8x1"], seed=99)
        loaded = TFitted.load(path, tm2)
        want = jfit_svsp(jm, params).predict_f(x)[1]
        got = loaded.predict_f(to_torch(x))[1]
    else:
        with torch.no_grad():
            tfit_svsp(tm).save(path)
        loaded = JFitted.load(path, jm)
        want = jfit_svsp(jm, params).predict_f(x)[1]
        got = loaded.predict_f(x)[1]
    _close(got, want, rtol=1e-4, atol=1e-6)


def test_fitted_svsp_loads_a_cholesky_factor_state(tmp_path):
    # States saved before the eigh pseudo-inverse hold chol_rel, the lower
    # factor of the relative-reg inducing Gram.
    jm, tm, params, x, _ = _models("svgp", SHAPES["8x8x1"])
    jf = jfit_svsp(jm, params)
    state = {k: np.asarray(v) for k, v in jf.state.items()
             if k not in ("k_rel_inv", "w")}
    k_rel = np.linalg.inv(np.asarray(jf.state["k_rel_inv"], np.float64))
    state["chol_rel"] = np.linalg.cholesky((k_rel + k_rel.T) / 2).astype(np.float32)
    for name, leaf in jnamed(params):
        state["param:" + name] = np.asarray(leaf)
    path = str(tmp_path / "old.npz")
    np.savez(path, **state)
    with torch.no_grad():
        loaded = TFitted.load(path, tm)
        _close(loaded.state["k_rel_inv"], jf.state["k_rel_inv"], rtol=1e-3, atol=1e-4)
        _close(loaded.predict_f(to_torch(x))[0], jf.predict_f(x)[0], rtol=1e-3, atol=1e-5)


# -- the estimator --------------------------------------------------------------

def test_classifier_fits_predicts_and_follows_the_protocol():
    rng = np.random.RandomState(12)
    x = rng.randn(40, 6, 5, 1).astype(np.float32)
    y = rng.randint(3, size=40) * 2 + 1          # labels {1, 3, 5}
    x += y[:, None, None, None] * 0.5
    clf = SNNGPClassifier(method="svgp", num_hiddens=1, num_inducing=9, num_samples=8,
                          batch_size=20, epochs=1, device="cpu")
    assert clf.fit(x, y) is clf
    assert clf.losses_.shape == (2,) and np.all(np.isfinite(clf.losses_))
    proba = clf.predict_proba(x[:5], num_samples=64)
    assert proba.shape == (5, 3)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(proba, clf.predict_proba(x[:5], num_samples=64))
    assert set(clf.predict(x)) <= {1, 3, 5}
    assert 0.0 <= clf.score(x, y) <= 1.0
    assert clf.get_params()["device"] == "cpu"
    assert clf.set_params(epochs=2).epochs == 2
    # network="mlp" on flat features, against the JAX facade: the same
    # protocol, classes, inducing init and kernel (Gram blocks of the fitted
    # scales through either package's builder, rtol 1e-5); the fits differ
    # by their Monte Carlo draws.
    from snngp.sklearn import SNNGPClassifier as JClassifier
    xf = x.reshape(40, -1)
    kw = dict(method="svtp", network="mlp", num_hiddens=2, num_inducing=9, num_samples=8,
              batch_size=20, epochs=1)
    mlp, jmlp = SNNGPClassifier(**kw, device="cpu"), JClassifier(**kw)
    assert mlp.fit(xf, y) is mlp and jmlp.fit(xf, y) is jmlp
    assert set(mlp.get_params()) == set(jmlp.get_params()) | {"device"}
    np.testing.assert_array_equal(mlp.classes_, jmlp.classes_)
    assert mlp.losses_.shape == (2,) and np.all(np.isfinite(mlp.losses_))
    z0 = np.concatenate([xf[y == c][:3] for c in (1, 3, 5)])
    np.testing.assert_array_equal(to_numpy(mlp.model_.inducing_variable).shape, z0.shape)
    w, b, last = (float(v) for v in mlp.model_.kernel.get_params())
    want = jmlp.model_.kernel._get_kernel_fn(w, b, last)(xf[:6], z0, get="nngp")
    with torch.no_grad():
        got = mlp.model_.kernel._get_kernel_fn(w, b, last)(to_torch(xf[:6]), to_torch(z0))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-5)
    proba, jproba = mlp.predict_proba(xf[:5], num_samples=64), jmlp.predict_proba(xf[:5])
    assert proba.shape == jproba.shape == (5, 3)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, rtol=1e-5)
    assert set(mlp.predict(xf)) <= {1, 3, 5}
    assert 0.0 <= mlp.score(xf, y) <= 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SNNGPClassifier(device="cuda").fit(x, y)
