"""The port never imports JAX: checked in a fresh interpreter, since this
test process has JAX loaded already (tests/conftest.py)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = ["snngp_torch", "snngp_torch.__main__", "snngp_torch.cli.regression",
           "snngp_torch.models.predictor", "snngp_torch.nn.arch",
           "snngp_torch.ops.gram", "snngp_torch.ops._build",
           "snngp_torch.utils.checkpoint", "snngp_torch.data.regression",
           "snngp_torch.sklearn", "snngp_torch.models.gp", "snngp_torch.ops.mvt",
           "snngp_torch.utils.optim", "snngp_torch.utils.profiling",
           "snngp_torch.utils.training", "snngp_torch.cli.classification",
           "snngp_torch.ops.conv_gram", "snngp_torch.ops.softmax",
           "snngp_torch.models.priors", "snngp_torch.data.classification",
           "snngp_torch.data.resize", "snngp_torch.ops.resnet_conv_gram",
           "snngp_torch.nn.full", "snngp_torch.ops.myrtle_gram",
           "snngp_torch.examples.cifar_myrtle", "snngp_torch.models.mlii",
           "snngp_torch.cli.find", "snngp_torch.examples.online_regression",
           "snngp_torch.cli.ensemble", "snngp_torch.nn.finite",
           "snngp_torch.examples.paper_figures", "snngp_torch.parallel",
           "snngp_torch.parallel.mesh", "snngp_torch.parallel.gram",
           "snngp_torch.parallel.cholesky", "snngp_torch.parallel.mlii",
           "snngp_torch.examples.mesh_pipeline"]


def _run(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("module", MODULES)
def test_import_leaves_jax_out(module):
    proc = _run(f"import importlib, sys; importlib.import_module({module!r}); "
                "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')))")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_precision_policy_and_no_pandas_for_synthetic_data():
    proc = _run("import sys, torch, snngp_torch\n"
                "from snngp_torch.data import get_dataset\n"
                "get_dataset('syn-t')\n"
                "print(torch.backends.cuda.matmul.allow_tf32, "
                "torch.backends.cudnn.allow_tf32, 'pandas' in sys.modules)")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "False", "False"]


def test_classification_data_needs_no_scipy_or_tfds_for_synthetic_sets():
    proc = _run("import sys, snngp_torch\n"
                "from snngp_torch.data.classification import get_train_dataset\n"
                "get_train_dataset('synthetic', num_data=50)\n"
                "print('scipy.io' in sys.modules, 'jax' in sys.modules)")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "False"]


def test_reg_fd_runs_without_pandas(tmp_path):
    # The card has no pandas: reg fd formats its tables without it.
    proc = _run("import sys\n"
                "from snngp_torch.__main__ import main\n"
                f"main(['--device', 'cpu', 'reg', 'fd', '-dn', 'syn-normal', '-cd', {str(tmp_path)!r}, "
                "'-wsl', '1', '-bsl', '0.3', '-el', '1e-1', '-al', '2', '-bl', '2', '-ns', '50', "
                "'-smp', 'device', '-q'])\n"
                "print('pandas' in sys.modules, 'jax' in sys.modules)")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "False"]
