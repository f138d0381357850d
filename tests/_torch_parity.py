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


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test on a machine without one (the
    decision is made when the test runs, not when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (run on the card: "
                    "python -m pytest tests/ -k torch)")
    return torch.device("cuda", 0)
