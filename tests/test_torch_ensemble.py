"""Port parity, end to end: ``python -m snngp_torch --device cpu ens tr / ens
ts`` against the JAX package's ``run.py ens ...`` on the synthetic set
(8 x 8 x 1, 10 classes; -nd 200 -nb 100 -nc 8 -e 1; -nh 1 and -nh 2, the
JAX CLI's round-trip case, tests/test_cli_smoke.py:151-163), the port's
training started from JAX's initial params and ``last_w_std`` draw, and
member checkpoints (``NNN.npy``) read across the two packages.

Tolerances:
- valid NLLs of the two trainings: atol 1e-5 (one epoch of Adam at lr 1e-2
  over fp32 convolutions of two frameworks);
- ``ens ts`` of one set of checkpoints in either package: NLL atol 1e-5,
  accuracy equal.
"""

import argparse
import contextlib
import io
import os
import sys

import jax
import numpy as np
import pytest
import torch

from snngp.cli import ensemble as jens

import snngp_torch.cli as tcli
from snngp_torch.__main__ import main as torch_cli
from snngp_torch.cli import ensemble as tens

from _torch_parity import to_numpy  # noqa: F401  (sets the thread count)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, ALPHA, BETA = 10, 2.0, 2.0


def _train_argv(root, name, nh):
    return ["ens", "tr", "-m", "tp", "-dn", "synthetic", "-cr", root, "-cn", name,
            "-e", "1", "-nd", "200", "-nb", "100", "-nh", str(nh), "-nc", "8",
            "-s", str(SEED), "-q"]


def _jax_cli(argv):
    sys.path.insert(0, REPO)
    import run as run_mod
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run_mod.main(argv)
    return out.getvalue()


def _port_args(argv):
    parser = argparse.ArgumentParser()
    tcli.add_subparser(parser.add_subparsers(dest="command", required=True))
    args = parser.parse_args(argv)
    args.device = torch.device("cpu")
    return args


def _valid_nlls(ckpt):
    text = open(os.path.join(ckpt, "train.log")).read()
    assert "Traceback" not in text, text
    return [float(line.split("Valid NLL:")[1].split()[0])
            for line in text.splitlines() if "Valid NLL:" in line]


def _jax_test(dirs):
    out = _jax_cli(["ens", "ts", "-dn", "synthetic", "-cd", *dirs, "-nd", "100", "-q"])
    nll = float(out.split("test_nll =")[1].split()[0])
    acc = float(out.split("test_acc =")[1].split()[0])
    return nll, acc


def _port_test(dirs):
    return tens.test_main(_port_args(["ens", "ts", "-dn", "synthetic", "-cd", *dirs,
                                      "-nd", "100", "-q"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """nh -> (JAX run dir, port run dir), the port started from JAX's draws."""
    root = str(tmp_path_factory.mktemp("ens"))
    out = {}
    for nh in (1, 2):
        _jax_cli(_train_argv(root, f"jax{nh}", nh))
        key = jax.random.PRNGKey(SEED)     # snngp/cli/ensemble.py:124-146
        last_w_std = jens.invgamma(key, ALPHA, BETA)
        init_fn, _ = jens.get_cnn(nh, 8, 10, 1., 0., last_w_std)
        _, params = init_fn(key, (-1, 8, 8, 1))
        tens.train_main(_port_args(_train_argv(root, f"port{nh}", nh)),
                        init_params=jax.device_get(params), last_w_std=last_w_std)
        out[nh] = (os.path.join(root, f"jax{nh}"), os.path.join(root, f"port{nh}"))
    return out


@pytest.mark.parametrize("nh", [1, 2])
def test_train_from_jax_init_matches_jax(runs, nh):
    jax_dir, port_dir = runs[nh]
    want, got = _valid_nlls(jax_dir), _valid_nlls(port_dir)
    assert len(got) == len(want) == 3          # epoch 0, epoch 1, best
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for d in (jax_dir, port_dir):
        assert sorted(os.listdir(d)) == ["001.npy", "meta.npy", "train.log"]


@pytest.mark.parametrize("nh", [1, 2])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_read_in_either_package(runs, nh, writer):
    ckpt = runs[nh][0 if writer == "jax" else 1]
    want_nll, want_acc = _jax_test([ckpt])
    got_nll, got_acc = _port_test([ckpt])
    assert abs(got_nll - want_nll) <= 1e-5
    assert got_acc == want_acc


def test_two_members_average_their_logits(runs):
    """``ens ts`` over two members (one written by each package) averages
    member logits, then takes the loss, in both packages."""
    dirs = [runs[1][0], runs[2][1]]
    want_nll, want_acc = _jax_test(dirs)
    got_nll, got_acc = _port_test(dirs)
    assert abs(got_nll - want_nll) <= 1e-5 and got_acc == want_acc
    singles = [_port_test([d])[0] for d in dirs]
    assert got_nll != pytest.approx(singles[0]) and got_nll != pytest.approx(singles[1])


def test_port_seeded_cli_runs(tmp_path, capsys):
    """The CLI's own draws (a torch.Generator and a host Gamma seeded with
    -s), through ``python -m snngp_torch``; -mp default restores the TF32
    flags it turned on."""
    flags = lambda: (torch.backends.cuda.matmul.allow_tf32,  # noqa: E731
                     torch.backends.cudnn.allow_tf32)
    assert flags() == (False, False)
    seen = []
    original = tens.cross_entropy

    def spy(logits, y):
        seen.append(flags())
        return original(logits, y)

    tens.cross_entropy = spy
    try:
        root = str(tmp_path)
        torch_cli(["--device", "cpu", *_train_argv(root, "a", 1), "-mp", "default"])
        torch_cli(["--device", "cpu", "ens", "ts", "-dn", "synthetic", "-cd",
                   os.path.join(root, "a"), "-nd", "100", "-q"])
    finally:
        tens.cross_entropy = original
    assert seen and set(seen[:-1]) == {(True, True)} and seen[-1] == (False, False)
    assert flags() == (False, False)
    assert "test_nll =" in capsys.readouterr().out
    meta = np.load(os.path.join(root, "a", "meta.npy"), allow_pickle=True).item()
    assert meta["matmul_precision"] == "default" and "device" not in meta
    assert len(_valid_nlls(os.path.join(root, "a"))) == 3


def test_reference_quirks_are_kept(tmp_path):
    """Two reference-side defects, reproduced in both packages: ``-n
    resnet`` trains the CNN, and ``ens ts`` rebuilds every member with
    ReLU (the saved net_kwargs hold no activation), so an ``-act erf``
    member is scored as a ReLU net."""
    root = str(tmp_path)
    argv = [*_train_argv(root, "erf", 1), "-n", "resnet", "-act", "erf"]
    torch_cli(["--device", "cpu", *argv])
    ckpt = os.path.join(root, "erf")
    params, net_args = np.load(os.path.join(ckpt, "001.npy"), allow_pickle=True)
    assert [tuple(np.shape(p)) for layer in params for p in layer] == \
        [(3, 3, 1, 8), (8,), (8 * 8 * 8, 10), (10,)]          # Conv, Relu/Erf, Flatten, Dense
    got_nll, got_acc = _port_test([ckpt])
    assert (got_nll, got_acc) == pytest.approx(_jax_test([ckpt]), abs=1e-5)
    x, y = tens.get_test_dataset("synthetic", num_data=100, onehot=True)[0]
    xb, yb = torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(y, dtype=torch.float32)
    p = tens.params_from_jax(params)
    scored = {act: float(tens.cross_entropy(tens.get_cnn(*net_args, act=act).apply(p, xb), yb))
              for act in ("relu", "erf")}
    assert got_nll == pytest.approx(scored["relu"], abs=1e-6)
    assert abs(got_nll - scored["erf"]) > 1e-4
