"""Port parity: full-Gram ML-II (snngp_torch/models/mlii.py) against
snngp/models/mlii.py on the same numpy inputs.

The augmented tiles come from the MLP NNGP recursion with forward-mode
tangents in each package (the pattern of tests/test_mlii.py): cheap on the
CPU, and the machinery does not depend on the kernel. The Myrtle wiring
(``cifar_myrtle --mlii-scope full``) runs at 8 x 8 through K7's plain
version.

Tolerances: the scalar functions rtol 1e-6 (float32 arithmetic on the same
numbers). ``full_gram_mlii_value_and_grad`` on the same host arrays: loss
rtol 1e-5; gradients rtol 1e-4 for the Student-t marginal, and for the
Gaussian marginal 2e-4 against JAX: the two packages factor the same fp32
matrix with different algorithms (JAX a blocked in-place upper
factorization, the port LAPACK's lower), the condition number of S is
~1.4e3 (JAX's d/db_std lands 1.4e-4 from float64). Against a float64
numpy closed form on its own tiles the port's gradients are held to rtol
1e-5, and its alpha^T dK alpha (float64 inner sums, where JAX's are
float32) to rtol 1e-10. ``mlii_fit_full`` after two Adam
steps: rtol 1e-4 on w_std, eps and a. Assemblies and resumes: the tiles of
one package are compared with the same package's tiles at rtol 1e-6; across
packages at rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from snngp.models import mlii as J
from snngp.ops.pallas.gram import _reference_recursion as j_recursion

from snngp_torch.models import mlii as T
from snngp_torch.ops.gram import _reference_recursion as t_recursion

from _torch_parity import to_numpy

DEPTH = 3
ACT = "relu"
HYPER = dict(w_std=1.3, b_std=0.4, last_w_std=0.9)
EPS0 = 3e-2
A0, B0 = 2.0, 1.5


def _data(n=96, d=6, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(n, d).astype(np.float32), rng.randn(n).astype(np.float32)


def _jax_aug_builder(w_std, b_std, last_w_std):
    w, b, l = (jnp.asarray(v, jnp.float32) for v in (w_std, b_std, last_w_std))

    @jax.jit
    def aug(x1, x2):
        f = lambda wv, bv: j_recursion(x1, x2, DEPTH, ACT, wv, bv, l)  # noqa: E731
        _, dkw = jax.jvp(lambda wv: f(wv, b), (w,), (jnp.ones_like(w),))
        _, dkb = jax.jvp(lambda bv: f(w, bv), (b,), (jnp.ones_like(b),))
        return f(w, b), dkw, dkb

    return aug


def _torch_aug_builder(w_std, b_std, last_w_std):
    w, b, l = (torch.tensor(float(v)) for v in (w_std, b_std, last_w_std))

    def aug(x1, x2):
        f = lambda wv, bv: t_recursion(x1, x2, DEPTH, ACT, wv, bv, l, "mlp")  # noqa: E731
        _, dkw = torch.func.jvp(lambda wv: f(wv, b), (w,), (torch.ones_like(w),))
        _, dkb = torch.func.jvp(lambda bv: f(w, bv), (b,), (torch.ones_like(b),))
        return f(w, b), dkw, dkb

    return aug


def _jax_aug(x, block=32, **kw):
    return [np.asarray(a) for a in J.tiled_aug_gram(_jax_aug_builder(**HYPER),
                                                     jnp.asarray(x), block=block, **kw)]


def _quiet(*_args, **_kw):
    pass


@pytest.mark.parametrize("ab", [None, (A0, B0), (3.0, 0.5)])
@pytest.mark.parametrize("q", [0.5, 87.0])
def test_scalar_functions_match_jax(ab, q):
    want = float(J.marginal_nll_from_scalars(q, -12.5, 96, ab=ab))
    got = float(T.marginal_nll_from_scalars(q, -12.5, 96, ab=ab))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(T.gram_cotangent_coeffs(q, 96, ab=ab),
                               J.gram_cotangent_coeffs(q, 96, ab=ab), rtol=1e-12)


@pytest.mark.parametrize("method", ["gp", "tp"])
def test_value_and_grad_matches_jax(method):
    x, y = _data()
    k, dkw, dkb = _jax_aug(x)
    ab = (A0, B0) if method == "tp" else None
    kw = dict(last_w_std=HYPER["last_w_std"], eps=EPS0, ab=ab, panel=40)  # 40: a tail panel
    loss_j, g_j = J.full_gram_mlii_value_and_grad(k, dkw, dkb, y, **kw)
    k_before = k.copy()
    loss_t, g_t = T.full_gram_mlii_value_and_grad(k, dkw, dkb, y, **kw, device="cpu")
    np.testing.assert_array_equal(k, k_before)       # the host Gram is not written
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    assert g_t.keys() == g_j.keys()
    for name in g_j:
        np.testing.assert_allclose(g_t[name], g_j[name], rtol=1e-4 if ab else 2e-4,
                                   err_msg=name)
    if ab is None:    # the Gaussian gradient against float64
        n = k.shape[0]
        s_inv = np.linalg.inv(k.astype(np.float64) + EPS0 * np.eye(n))
        alpha = s_inv @ y.astype(np.float64)
        for name, dk in (("w_std", dkw), ("b_std", dkb)):
            dk = dk.astype(np.float64)
            want = ((s_inv * dk).sum() - alpha @ dk @ alpha) / (2 * n)
            np.testing.assert_allclose(g_t[name], want, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("method", ["gp", "tp"])
def test_value_and_grad_against_float64_on_its_tiles(method):
    """Every constrained gradient against float64 numpy on the same fp32
    tiles, dK/deps = I and dK/dlast_w_std = (2 / last) K included."""
    x, y = _data()
    k, dkw, dkb = T.tiled_aug_gram(_torch_aug_builder(**HYPER), torch.as_tensor(x), block=32)
    ab = (A0, B0) if method == "tp" else None
    _, got = T.full_gram_mlii_value_and_grad(k, dkw, dkb, y, last_w_std=HYPER["last_w_std"],
                                             eps=EPS0, ab=ab, panel=40, device="cpu")
    n = k.shape[0]
    s_inv = np.linalg.inv(k.astype(np.float64) + EPS0 * np.eye(n))
    alpha = s_inv @ y.astype(np.float64)
    c_inv, c_aa = T.gram_cotangent_coeffs(float(y @ alpha), n, ab=ab)
    dks = dict(w_std=dkw, b_std=dkb, eps=np.eye(n), last_w_std=2.0 / HYPER["last_w_std"] * k)
    for name, dk in dks.items():
        dk = dk.astype(np.float64)
        want = c_inv * (s_inv * dk).sum() + c_aa * alpha @ dk @ alpha
        np.testing.assert_allclose(got[name], want, rtol=1e-5, err_msg=name)


def test_quad_host_accumulates_in_float64():
    """alpha^T dK alpha on a Gram-like fp32 matrix (a large shared part) and
    a vector whose terms cancel: float64 inner sums (rtol 1e-10; a float32
    matrix-vector product lands ~3e-4 away)."""
    rng = np.random.RandomState(3)
    a = (1.0 + 1e-3 * rng.randn(600, 600)).astype(np.float32)
    a = (a + a.T) / 2
    v = rng.randn(600).astype(np.float32)
    v -= v.mean()
    want = v.astype(np.float64) @ a.astype(np.float64) @ v.astype(np.float64)
    np.testing.assert_allclose(T._quad_host(a, v, chunk=256), want, rtol=1e-10)


def test_tiled_aug_gram_matches_jax_and_caches_profiles():
    x, _ = _data(n=80)            # 80 = 2 x 32 + a ragged 16
    want = _jax_aug(x)
    aug0 = _torch_aug_builder(**HYPER)
    calls, seen = [], []

    def profile_fn(xb):
        calls.append(xb.shape[0])
        return xb.sum(dim=1)

    def aug(x1, x2, profiles=None):
        seen.append(x1 is x2)
        torch.testing.assert_close(profiles[0], x1.sum(dim=1), rtol=0, atol=0)
        torch.testing.assert_close(profiles[1], x2.sum(dim=1), rtol=0, atol=0)
        return aug0(x1, x2)

    got = T.tiled_aug_gram(aug, torch.as_tensor(x), block=32, profile_fn=profile_fn)
    assert calls == [32, 32, 16]                       # once per block, not per tile
    assert seen == [True, False, False, True, False, True]   # one object on the diagonal
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6 * np.abs(w).max())
        np.testing.assert_array_equal(g[32:, :32], g[:32, 32:].T)     # mirrored tiles


def test_resume_finishes_a_jax_directory(tmp_path):
    x, _ = _data(n=64)
    rdir = str(tmp_path / "aug")
    fresh = T.tiled_aug_gram(_torch_aug_builder(**HYPER), torch.as_tensor(x), block=32)
    J.tiled_aug_gram(_jax_aug_builder(**HYPER), jnp.asarray(x), block=32, resume_dir=rdir)
    done = np.load(f"{rdir}/aug.done.npy")
    done[1] = False                      # clear the off-diagonal tile
    np.save(f"{rdir}/aug.done.npy", done)
    for name in ("k", "dkw", "dkb"):
        m = np.lib.format.open_memmap(f"{rdir}/aug_{name}.npy", mode="r+")
        m[:32, 32:] = -1.0
        m[32:, :32] = -1.0
        m.flush()
        del m
    lines = []
    got = T.tiled_aug_gram(_torch_aug_builder(**HYPER), torch.as_tensor(x), block=32,
                           resume_dir=rdir, log=lines.append)
    assert "resuming, 2/3 tiles already done" in lines[0]
    assert np.load(f"{rdir}/aug.done.npy").all()
    for g, w in zip(got, fresh):
        np.testing.assert_array_equal(g[:32, 32:], w[:32, 32:])    # the port's own tile
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6 * np.abs(w).max())
    # ... and the JAX package finishes a directory the port started.
    rdir2 = str(tmp_path / "aug2")
    T.tiled_aug_gram(_torch_aug_builder(**HYPER), torch.as_tensor(x), block=32,
                     resume_dir=rdir2)
    done = np.load(f"{rdir2}/aug.done.npy")
    done[2] = False
    np.save(f"{rdir2}/aug.done.npy", done)
    back = J.tiled_aug_gram(_jax_aug_builder(**HYPER), jnp.asarray(x), block=32,
                            resume_dir=rdir2)
    for g, w in zip(back, fresh):
        np.testing.assert_allclose(np.asarray(g), w, rtol=1e-5, atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_state_cross_loads(writer, tmp_path):
    path = str(tmp_path / "mlii_state.npz")
    rng = np.random.RandomState(5)
    names = ["eps", "kernel.b_std", "kernel.last_w_std", "kernel.w_std", "likelihood.a",
             "likelihood.b"]
    vals = {n: rng.randn(3).astype(np.float32) for n in names}   # param, mu, nu
    if writer == "jax":
        from snngp.models import params as JP
        from snngp.utils.optim import AdamState
        tree = lambda i: JP.unflatten_named({n: jnp.asarray(v[i])  # noqa: E731
                                             for n, v in vals.items()})
        J.MLIIFullState(tree(0), AdamState(step=jnp.asarray(4, jnp.int32), mu=tree(1),
                                           nu=tree(2)), 7).save(path)
        st = T.MLIIFullState.load(path)
        assert st.step == 7 and int(st.opt_state.step) == 4
        assert st.opt_state.names == names
        for i, n in enumerate(names):
            np.testing.assert_array_equal(to_numpy(dict(st.params.named_parameters())[n]),
                                          vals[n][0])
            np.testing.assert_array_equal(to_numpy(st.opt_state.mu[i]), vals[n][1])
            np.testing.assert_array_equal(to_numpy(st.opt_state.nu[i]), vals[n][2])
    else:
        params = T._Raw({n: torch.tensor(v[0]) for n, v in vals.items()})
        opt = T.Adam(params)
        opt.load_state_leaves([np.int32(4), *(vals[n][1] for n in names),
                               *(vals[n][2] for n in names)])
        T.MLIIFullState(params, opt, 7).save(path)
        st = J.MLIIFullState.load(path)
        from snngp.models.params import named_leaves
        assert st.step == 7 and int(st.opt_state.step) == 4
        for (n, p), (_, m), (_, v) in zip(named_leaves(st.params),
                                          named_leaves(st.opt_state.mu),
                                          named_leaves(st.opt_state.nu)):
            np.testing.assert_array_equal(np.asarray(p), vals[n][0])
            np.testing.assert_array_equal(np.asarray(m), vals[n][1])
            np.testing.assert_array_equal(np.asarray(v), vals[n][2])


def test_fit_full_matches_jax_with_a_resume(tmp_path):
    x, y = _data(n=64)
    kw = dict(lr=5e-2, block=32, eps=EPS0, ab=(A0, B0), panel=64, log=_quiet)
    want = J.mlii_fit_full(_jax_aug_builder, jnp.asarray(x), y, steps=2,
                           init_hyper=dict(HYPER), **kw)
    rdir = str(tmp_path / "mlii")
    xt = torch.as_tensor(x)
    T.mlii_fit_full(_torch_aug_builder, xt, y, steps=1, init_hyper=dict(HYPER),
                    resume_dir=rdir, device="cpu", **kw)
    lines = []
    kw["log"] = lines.append
    hyper, eps, ab, losses = T.mlii_fit_full(_torch_aug_builder, xt, y, steps=2,
                                             init_hyper=dict(HYPER), resume_dir=rdir,
                                             device="cpu", **kw)
    assert lines[0] == "mlii_fit_full: resuming at step 1" and len(losses) == 1
    np.testing.assert_allclose(losses[0], want[3][1], rtol=1e-5)
    np.testing.assert_allclose(hyper["w_std"], want[0]["w_std"], rtol=1e-4)
    np.testing.assert_allclose(eps, want[1], rtol=1e-4)
    np.testing.assert_allclose(ab[0], want[2][0], rtol=1e-4)
    # The JAX package resumes from the port's state file.
    _, _, _, more = J.mlii_fit_full(_jax_aug_builder, jnp.asarray(x), y, steps=3,
                                    init_hyper=dict(HYPER), resume_dir=rdir,
                                    **dict(kw, log=_quiet))
    assert len(more) == 1 and np.isfinite(more[0])


def test_cifar_myrtle_full_scope_is_mlii_fit_full(tmp_path, monkeypatch, capsys):
    from snngp_torch.examples import cifar_myrtle as example
    from snngp_torch.ops.myrtle_gram import myrtle_gram_scale_grads, myrtle_profile_tangents

    monkeypatch.chdir(tmp_path)
    flags = ["--device", "cpu", "--image-size", "8", "--n-train", "24", "--n-test", "8",
             "--mlii", "1", "--mlii-scope", "full", "--fused-block", "16",
             "--mlii-panel", "16", "--resume-gram", str(tmp_path / "rg")]
    out = example.main(flags)
    assert np.isfinite(out["nll"])
    assert (tmp_path / "rg" / "mlii" / "mlii_state.npz").exists()

    x, y = example.load_images(32, 8, seed=0)
    y_train = (y[:24] - np.mean(y[:24])) / np.std(y[:24])

    def aug_builder(w, b, l):
        return lambda xa, xb, profiles=None: myrtle_gram_scale_grads(
            xa, xb, depth=5, w_std=w, b_std=b, last_w_std=l, profiles=profiles)

    hyper, eps, ab, _ = T.mlii_fit_full(
        aug_builder, torch.as_tensor(x[:24]), y_train, steps=1, lr=1e-2, block=16,
        init_hyper=dict(w_std=1.0, b_std=0.1, last_w_std=1.0), eps=1e-4, ab=(2.0, 2.0),
        panel=16, log=_quiet, device="cpu",
        profile_builder=lambda w, b: lambda xb: myrtle_profile_tangents(
            xb, depth=5, w_std=w, b_std=b))
    assert out["hyper"] == hyper
    assert "Traceback" not in capsys.readouterr().out
