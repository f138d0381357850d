"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Each parity test builds its inputs with numpy from a seed, runs the JAX
package's callable and the port's counterpart on the same arrays, and
compares the two with a tolerance stated at the call site. JAX stays on the
CPU (tests/conftest.py); data crosses between the frameworks as numpy.
"""

import numpy as np
import pytest
import torch

# The gate runs several xdist workers on few cores: one intra-op thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)


def randn(seed, *shapes):
    """float32 standard-normal arrays of the given shapes, from one seed."""
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def to_torch(*arrays, dtype=torch.float32):
    out = [torch.as_tensor(np.asarray(a), dtype=dtype) for a in arrays]
    return out[0] if len(out) == 1 else out


def to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_parity(jax_fn, torch_fn, *arrays, atol=0.0, rtol=0.0):
    """Run both callables on the same numpy inputs and compare."""
    want = to_numpy(jax_fn(*arrays))
    got = to_numpy(torch_fn(*[to_torch(a) for a in arrays]))
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    return got, want


def assert_fp32_reach(got, want, witness64, ceiling, name):
    """Hold the port's fp32 result ``got`` and the JAX package's ``want``
    each against ``witness64``, a float64 run of the same computation on the
    same fp32 inputs: each one's largest error, relative to max|witness|,
    stays under the fixed ``ceiling``. Both errors print under ``pytest -s``;
    returns them (port, JAX).

    The bar for results that sit at the fp32 limit of an ill-conditioned
    solve, where a bar between the two packages' results (or the port's
    error against a multiple of JAX's) compares one rounding with another
    and is decided by the host's BLAS code path. The ceiling is set from the
    largest error either package shows on any MKL code path, and JAX's error
    under it ties the witness (the port's code in float64) to the JAX
    package."""
    ref = np.asarray(to_numpy(witness64), np.float64)
    scale = np.abs(ref).max()
    err_t, err_j = (float(np.abs(np.asarray(to_numpy(v), np.float64) - ref).max() / scale)
                    for v in (got, want))
    print(f"{name} against float64, of max|{name}| {scale:.4g}: port {err_t:.3e}, "
          f"JAX {err_j:.3e} (ceiling {ceiling:.1e})")
    assert err_t <= ceiling, f"{name}: the port errs by {err_t:.3e} > {ceiling:.1e}"
    assert err_j <= ceiling, f"{name}: the JAX package errs by {err_j:.3e} > {ceiling:.1e}"
    return err_t, err_j


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test on a machine without one (the
    decision is made when the test runs, not when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (run on the card: "
                    "python -m pytest tests/ -k torch)")
    return torch.device("cuda", 0)


def dual_act_inputs(act, seed):
    """(k, v1, v2) float32 arrays for the dual activations' per-row factor
    form: random pairs with |c| <= 0.9, where the arccos / arcsin partials
    are well conditioned (their sqrt(1 - c^2) turns one ulp of c into
    ~1e-7 / (1 - c^2) of the result), then the corners:
    - a row of zero variance against a row of large variance (k = 0);
    - for relu, the diagonal k = +-v at variances that are powers of 4, so
      that both forms reach c = +-1 without rounding, and k = +-1.5
      sqrt(v1 v2), clipped to c = +-1 by both;
    - for erf, the diagonal k = v (c = 2 v / (1 + 2 v) < 1)."""
    rng = np.random.RandomState(seed)
    v1, v2 = 10.0 ** rng.uniform(-3, 3, size=(2, 400))
    rho = rng.uniform(-0.9, 0.9, size=400)
    if act == "relu":
        k = rho * np.sqrt(v1 * v2)
        diag = np.array([0.25, 1.0, 4.0, 16.0])
        corners = [(0.0, 0.0, 1e4), (0.0, 1e4, 0.0)]
        corners += [(s * v, v, v) for v in diag for s in (1.0, -1.0)]
        corners += [(s * 1.5 * np.sqrt(3.0 * 7.0), 3.0, 7.0) for s in (1.0, -1.0)]
    else:
        k = rho * np.sqrt((1.0 + 2.0 * v1) * (1.0 + 2.0 * v2)) / 2.0
        corners = [(0.0, 0.0, 1e4), (0.0, 1e4, 0.0)]
        corners += [(v, v, v) for v in (0.25, 1.0, 4.0)]
    ck, cv1, cv2 = np.array(corners).T
    return [np.concatenate([a, b]).astype(np.float32) for a, b in
            ((k, ck), (v1, cv1), (v2, cv2))]
