"""Port parity on other MKL code paths than the host's own.

The regression-serving parity tests (tests/test_torch_predictor.py,
tests/test_torch_extend.py) and the layer-0 state's float64 bars
(tests/test_torch_layers.py) hold fp32 results at the limit of their
solves, where torch's MKL rounds differently on each of its code paths
(``MKL_CBWR``) and the JAX package's results do not move with it. The gate's own
run covers the path its host takes; each case here reruns those tests, in a
process of its own, on one more path, so that a bar that only one kind of
host passes fails on any host. ``MKL_CBWR`` is read when MKL loads, so it is
set before the process starts.
"""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ["tests/test_torch_predictor.py", "tests/test_torch_extend.py",
         "tests/test_torch_layers.py"]
# The two CLI / example tests run whole programs (~30 s together) and hold
# their results at 5e-3 and 1e-4 of a printed NLL, far above any code path's
# rounding.
SELECT = "not reg_pr_add_x and not online_regression"
TIMEOUT = 180


@pytest.mark.parametrize("path", ["COMPATIBLE", "AVX2"])
def test_regression_parity_holds_on_mkl_code_path(path):
    if not torch.backends.mkl.is_available():
        pytest.skip("torch is built without MKL: MKL_CBWR picks nothing")
    if torch.backends.cpu.get_cpu_capability() not in ("AVX2", "AVX512"):
        pytest.skip("the CPU lacks AVX2")
    env = dict(os.environ, MKL_CBWR=path, JAX_PLATFORMS="cpu")
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:xdist", "-p", "no:cacheprovider",
           "-p", "no:randomly", "-k", SELECT, *FILES]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=TIMEOUT)
    assert proc.returncode == 0 and " passed" in proc.stdout, (
        f"MKL_CBWR={path}: rc {proc.returncode}\n" + proc.stdout[-6000:] + proc.stderr[-2000:])
