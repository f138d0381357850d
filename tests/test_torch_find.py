"""Port parity: the Burr-XII grid search ``reg fd`` (snngp_torch/cli/find.py)
against snngp/cli/find.py.

The whole CLI on a small syn-normal grid in both packages (the logged
minima: the same cells, NLLs within rtol 5e-3, tests/test_cli_smoke.py's bar
between two programs on the near-singular syn-normal Gram), and the
importance-sampling lattice on the same inputs: the scipy draws (shared as
they are) and the device sampler with the JAX package's uniforms injected,
rtol 1e-5 (float32 arithmetic on the same numbers; the lattice's
logsumexp sums 200 terms).
"""

import os
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

from snngp.cli import find as J

from snngp_torch.__main__ import main as torch_cli
from snngp_torch.cli import find as T

from _torch_parity import to_numpy, to_torch

CLI_RTOL = 5e-3
GRID = ["-dn", "syn-normal", "-wsl", "1", "1.4", "-bsl", "0.3", "-el", "1e-1", "1",
        "-al", "1", "2", "-bl", "1", "2", "-ns", "200", "-q"]


def _jax_cli(argv):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import run as run_mod
    run_mod.main(argv)


def _minima(log):
    """The two final lines: ((w, b, a, beta, eps), nll) and ((w, b, eps), nll)."""
    text = open(log).read()
    assert "Traceback" not in text, text
    out = []
    for line in text.strip().splitlines()[-2:]:
        cell, value = line.rsplit(": ", 1)
        out.append((cell, float(value)))
    return out


def test_reg_fd_minima_match_jax(tmp_path):
    _jax_cli(["reg", "fd", *GRID, "-cd", str(tmp_path / "jax")])
    torch_cli(["--device", "cpu", "reg", "find", *GRID, "-cd", str(tmp_path / "torch")])
    want = _minima(tmp_path / "jax" / "train.log")
    got = _minima(tmp_path / "torch" / "train.log")
    for (gc, gv), (wc, wv) in zip(got, want):
        assert gc == wc
        np.testing.assert_allclose(gv, wv, rtol=CLI_RTOL)
    text = open(tmp_path / "torch" / "train.log").read()
    assert "4 / 4 (2/2, 1/1, 2/2)" in text
    torch_cli(["--device", "cpu", "reg", "fd", *GRID, "-smp", "device",
               "-cd", str(tmp_path / "device")])
    assert all(np.isfinite(v) for _, v in _minima(tmp_path / "device" / "train.log"))


def _lattice_inputs(seed=3, n_train=40, n_test=7):
    rng = np.random.RandomState(seed)
    mean_ = rng.randn(n_test).astype(np.float32)
    y_ = (mean_ + 0.3 * rng.randn(n_test)).astype(np.float32)
    std_diag = (0.2 + rng.rand(n_test)).astype(np.float32)
    return dict(quad=np.float32(37.5), logdet_term=np.float32(-41.2), num_train=n_train,
                y_=y_, mean_=mean_, std_diag=std_diag, y_std=np.float32(1.7))


def _torch_inputs(kw):
    return {k: (to_torch(v) if isinstance(v, (np.ndarray, np.floating)) else v)
            for k, v in kw.items()}


def test_device_lattice_matches_jax_with_injected_uniforms():
    kw = _lattice_inputs()
    alphas, betas, s = [1.0, 2.0, 3.0], [1.0, 2.5], 200
    key = jax.random.PRNGKey(101)
    want = J._tnll_lattice_device(key, jnp.asarray(alphas, jnp.float32),
                                  jnp.asarray(betas, jnp.float32), s, **kw)
    # The same uniforms as the JAX function draws from its key.
    u = np.asarray(jax.random.uniform(key, (s,), minval=1e-7, maxval=1.0 - 1e-7))
    got = T.tnll_lattice(T.device_draws(to_torch(u), alphas, betas), **_torch_inputs(kw))
    assert got.shape == (3, 2)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-5)


def test_scipy_lattice_matches_jax():
    kw = _lattice_inputs(seed=4)
    alphas, betas, s = [1.0, 2.0], [1.0, 3.0], 200
    draws = T.scipy_draws(alphas, betas, s, "cpu")
    got = T.tnll_lattice(draws, **_torch_inputs(kw))
    from scipy import stats
    for i, a in enumerate(alphas):
        for j, b in enumerate(betas):
            q = stats.burr12.rvs(c=a, d=b, loc=0., scale=1., size=s, random_state=101)
            np.testing.assert_array_equal(to_numpy(draws[i, j]), q.astype(np.float32))
            want = J._tnll_lattice(jnp.asarray(q, jnp.float32), jnp.ones(s), **kw)
            np.testing.assert_allclose(float(got[i, j]), float(want), rtol=1e-5)


def test_device_uniforms_are_seeded_and_in_range():
    u = T.device_uniforms(1000, "cpu")
    assert u.shape == (1000,) and float(u.min()) >= 1e-7 and float(u.max()) <= 1 - 1e-7
    torch.testing.assert_close(u, T.device_uniforms(1000, "cpu"), rtol=0, atol=0)
    q = T.device_draws(u, [2.0], [3.0])[0, 0]
    np.testing.assert_allclose(to_numpy(q), to_numpy(((1 - u) ** (-1 / 3) - 1) ** 0.5),
                               rtol=1e-6)


def test_failed_factorization_falls_back_to_the_pseudo_determinant():
    # A Gram that is not PD (four well-separated positive eigenvalues, eight
    # negative ones): cholesky_ex fails, and the cell is scored on the
    # positive eigenpairs by the eigh pseudo-determinant, as in the JAX package.
    rng = np.random.RandomState(6)
    vec, _ = np.linalg.qr(rng.randn(12, 12))
    ev = np.array([4.0, 2.0, 1.0, 0.5] + [-0.01 * (i + 1) for i in range(8)])
    k = torch.as_tensor((vec * ev) @ vec.T, dtype=torch.float32)
    y = torch.as_tensor(rng.randn(12).astype(np.float32))
    assert int(torch.linalg.cholesky_ex(k)[1]) > 0
    base = -6.0 * np.log(2 * np.pi)
    quad, logdet_term = T._marginal_pieces(k, 0.0, y, base)
    z = vec.T @ y.double().numpy()
    np.testing.assert_allclose(float(quad), np.sum(z[:4] ** 2 / ev[:4]), rtol=1e-5)
    np.testing.assert_allclose(float(logdet_term), base - 0.5 * np.sum(np.log(ev[:4])),
                               rtol=1e-5)


def test_table_is_formatted_without_pandas():
    text = T.format_table([[1.23456, 2.0], [3.5, float("nan")]], [1.0, 2.0], [1.0, 3.0])
    assert text.splitlines() == ["                 1         3",
                                 "1           1.2346    2.0000",
                                 "2           3.5000       nan"]


def test_parser_matches_jax():
    import argparse

    def options(mod):
        parser = argparse.ArgumentParser()
        mod.add_subparser(parser.add_subparsers())
        sub = parser._subparsers._group_actions[0].choices["find"]
        return {a.dest: (a.option_strings, a.default, a.choices) for a in sub._actions}

    want, got = options(J), options(T)
    assert got.keys() == want.keys()
    for dest in want:
        assert got[dest] == want[dest], dest
