"""Port parity: snngp_torch/ops/linalg.py against snngp/ops/linalg.py.

Tolerances: rtol 1e-5 for solves against a well-conditioned SPD matrix
(condition number ~1e2 here: fp32 round-off times the condition number);
rtol 1e-6 for elementwise or diagonal-only operations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snngp.ops import linalg as JLA
from snngp.nn import arch as jarch

from snngp_torch.nn import arch as tarch
from snngp_torch.ops import linalg as TLA

from _torch_parity import assert_parity, randn, to_numpy, to_torch


def _spd(seed, n=12):
    (a,) = randn(seed, (n, n))
    return (a @ a.T / n + np.eye(n, dtype=np.float32)).astype(np.float32)


def test_add_jitter_and_diag_reg():
    a = _spd(0)
    assert_parity(lambda m: JLA.add_jitter(m, 1e-3), lambda m: TLA.add_jitter(m, 1e-3),
                  a, rtol=1e-6)
    assert_parity(lambda m: JLA.add_diag_reg(m, 1e-2), lambda m: TLA.add_diag_reg(m, 1e-2),
                  a, rtol=1e-6)


def test_cholesky_symmetrizes_like_jnp():
    # jnp.linalg.cholesky factors (A + A^T)/2; torch reads the lower
    # triangle only. Perturb the upper triangle so the two readings differ.
    a = _spd(1)
    a[0, 5] += 0.3
    want = np.asarray(jnp.linalg.cholesky(a))
    got = to_numpy(TLA.cholesky(to_torch(a)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    lower_only = to_numpy(torch.linalg.cholesky(to_torch(a)))
    assert np.abs(lower_only - want).max() > 1e-3


def test_cholesky_failure_gives_nan_like_jnp():
    # JAX returns a NaN lower triangle, the port a NaN diagonal (O(N), no
    # host sync); everything solved with either factor is NaN.
    a = _spd(2)
    a[3, 3] = -5.0  # not positive definite
    (b,) = randn(8, (12, 2))
    want = jnp.linalg.cholesky(a)
    got = TLA.cholesky(to_torch(a))
    assert np.isnan(np.asarray(want)[np.tril_indices(12)]).all()
    assert np.isnan(np.diag(to_numpy(got))).all()
    assert np.isnan(np.asarray(JLA.chol_solve(want, b))).all()
    assert np.isnan(to_numpy(TLA.chol_solve(got, to_torch(b)))).all()
    assert np.isnan(to_numpy(TLA.chol_quad_form(got, to_torch(b[:, 0])))).all()


def test_chol_solve_matches():
    a = _spd(3)
    (b,) = randn(4, (12, 2))
    assert_parity(lambda m, r: JLA.chol_solve(jnp.linalg.cholesky(m), r),
                  lambda m, r: TLA.chol_solve(TLA.cholesky(m), r), a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(12,), (12, 3)])
def test_chol_quad_form_matches(shape):
    a = _spd(5)
    (y,) = randn(6, shape)
    got, _ = assert_parity(lambda m, v: JLA.chol_quad_form(jnp.linalg.cholesky(m), v),
                           lambda m, v: TLA.chol_quad_form(TLA.cholesky(m), v),
                           a, y, rtol=1e-5)
    assert got.shape == shape[1:]


def test_gp_predict_matches():
    # The regularized train Gram's condition number is ~1.2e3, so fp32
    # solves carry ~1.2e3 x 6e-8 = 7e-5 relative error: rtol 2e-4.
    x, xt, y = randn(7, (30, 4), (9, 4), (30, 1))
    kw = dict(w_std=1.3, b_std=0.2, last_w_std=1.0)
    jm, jc = JLA.gp_predict(jarch.get_mlp_kernel(2, **kw), x, y, xt, diag_reg=1e-2)
    tm, tc = TLA.gp_predict(tarch.get_mlp_kernel(2, **kw), *to_torch(x, y, xt),
                            diag_reg=1e-2)
    np.testing.assert_allclose(to_numpy(tm), np.asarray(jm), rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(to_numpy(tc), np.asarray(jc), rtol=2e-4, atol=1e-6)
