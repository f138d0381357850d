"""Port parity of ML-II training: the objax-exact optimizers, the plateau
schedule, checkpoints and ``resume.state`` across the two packages, the
``SNNGPRegressor`` trajectory, and ``reg tr`` against the JAX CLI.

Tolerances:
- optimizers on one gradient sequence: rtol 1e-6 (the same fp32 formula);
- the 20-step regressor trajectory: rtol 1e-4, the ``SPR.loss`` bar
  (tests/test_torch_grad.py), since every step goes through an fp32
  Cholesky in each framework;
- logged NLLs of ``reg tr``: rtol 5e-3, as tests/test_cli_smoke.py:47-51
  sets it between two programs. The runs use Student-t b/a = 0.01: at
  b/a = 1 the predictive's hardcoded 1e-6 jitter meets syn-normal's
  near-rank-2 Gram and the two packages' valid NLLs differ by ~6e-3 at
  step 0, before any training.
"""

import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from snngp.models.params import named_leaves as jnamed
from snngp.utils import Adam as JAdam
from snngp.utils import ReduceLROnPlateau as JPlateau
from snngp.utils import SGD as JSGD
from snngp.utils import load_named as jload_named
from snngp.utils import name_mask
from snngp.utils.checkpoint import load_training_state as jload_state
from snngp.utils.checkpoint import save_training_state as jsave_state

from snngp_torch.__main__ import main as torch_cli
from snngp_torch.sklearn import SNNGPRegressor
from snngp_torch.utils import (SGD, Adam, Checkpointer, Profiler, ReduceLROnPlateau,
                               load_named, load_training_state, save_training_state)

from _torch_parity import to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 5e-3
CLI_ARGS = ["-m", "tp", "-a", "2", "-b", "0.02", "-dn", "syn-normal", "-vi", "10",
            "-pi", "10", "-nh", "2", "-eps", "1e-2", "-q"]


def _jax_cli(argv):
    sys.path.insert(0, REPO)
    import run as run_mod
    run_mod.main(argv)


# -- optimizers and schedule -----------------------------------------------------

class _Params(nn.Module):
    """Parameters named as an SPR's: ``eps``, ``kernel.*``, ``likelihood.*``."""

    def __init__(self, values):
        super().__init__()
        self.eps = nn.Parameter(torch.tensor(values["eps"]))
        self.kernel = nn.Module()
        for k, v in values["kernel"].items():
            setattr(self.kernel, k, nn.Parameter(torch.tensor(v)))


def _values(rng):
    return {"eps": np.float32(rng.randn()),
            "kernel": {"w_std": rng.randn(3).astype(np.float32),
                       "last_w_std": np.float32(rng.randn())}}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_optimizer_matches_jax_on_a_gradient_sequence(kind, masked):
    rng = np.random.RandomState(30)
    values = _values(rng)
    params = jax.tree.map(jnp.asarray, values)
    module = _Params(values)
    keep = (lambda n: "last_w_std" not in n) if masked else None
    jmask = name_mask(params, keep) if masked else None
    jopt = JAdam(mask=jmask) if kind == "adam" else JSGD(mask=jmask)
    topt = Adam(module, mask=keep) if kind == "adam" else SGD(module, mask=keep)
    state = jopt.init(params)
    for step in range(25):
        grads = jax.tree.map(lambda v: np.asarray(rng.randn(*np.shape(v)), np.float32),
                             values)
        lr = 1e-2 * 0.5 ** (step // 10)
        params, state = jopt.update(jax.tree.map(jnp.asarray, grads), state, params, lr)
        topt.zero_grad()
        for name, p in module.named_parameters():
            p.grad = torch.as_tensor(dict(jnamed(grads))[name])
        topt.update(lr)
    want = dict(jnamed(params))
    for name, p in module.named_parameters():
        np.testing.assert_allclose(to_numpy(p), np.asarray(want[name]), rtol=1e-6,
                                   err_msg=name)
    if masked:
        np.testing.assert_array_equal(to_numpy(module.kernel.last_w_std),
                                      values["kernel"]["last_w_std"])
    got_state = [to_numpy(t) for t in topt.state_leaves()]
    want_state = [np.asarray(t) for t in jax.tree_util.tree_leaves(state)]
    assert len(got_state) == len(want_state)
    for g, w in zip(got_state, want_state):
        np.testing.assert_allclose(g, w, rtol=1e-6)


def test_reduce_lr_on_plateau_matches_jax():
    rng = np.random.RandomState(31)
    metrics = np.cumsum(rng.randn(60) * 0.1) + 5.0
    jax_s, torch_s = (cls(lr=1e-2, factor=0.5, patience=3) for cls in (JPlateau,
                                                                       ReduceLROnPlateau))
    for m in metrics:
        assert jax_s.step(m) == torch_s.step(m)
        assert (jax_s.lr, jax_s.best, jax_s.num_bad_epochs, jax_s.last_epoch) == \
            (torch_s.lr, torch_s.best, torch_s.num_bad_epochs, torch_s.last_epoch)


def test_profiler_reports_each_phase():
    prof = Profiler()
    for _ in range(3):
        with prof.phase("a"):
            pass
    with prof.phase("b"):
        pass
    assert dict(prof.counts) == {"a": 3, "b": 1}
    assert "a" in prof.report() and "calls" in prof.report()


# -- checkpoints -----------------------------------------------------------------

def test_checkpointer_gates_on_best_loss_and_keeps_the_last_ten(tmp_path):
    module = _Params(_values(np.random.RandomState(32)))
    ckpt = Checkpointer(str(tmp_path))
    assert ckpt.step(0, 5.0, module) and not ckpt.step(1, 6.0, module)
    for i in range(2, 14):
        assert ckpt.step(i, 5.0 - i, module)
    assert Checkpointer.list_indices(str(tmp_path)) == list(range(4, 14))
    named = jload_named(str(tmp_path / "013.npz"))
    assert sorted(named) == sorted(load_named(str(tmp_path / "013.npz")))


def _jax_train_state(rng):
    from snngp.cli.regression import _build_model
    cfg = dict(network="mlp", num_hiddens=2, activation="relu", w_std=1.2, b_std=0.3,
               last_w_std=0.9, method="tp", alpha=2.0, beta=1.5, epsilon=1e-2)
    x, y = rng.randn(10, 3).astype(np.float32), rng.randn(10).astype(np.float32)
    model = _build_model(cfg, jnp.asarray(x), jnp.asarray(y), 0.0, 1.0)[0]
    return cfg, x, y, model.init_params()


def _torch_model(cfg, x, y):
    from snngp_torch.cli.regression import _build_model
    return _build_model(cfg, torch.as_tensor(x), torch.as_tensor(y), 0.0, 1.0)[0]


META = dict(step=20, lr=5e-3, sched_best=1.25, sched_bad=2, sched_epoch=2, best_loss=1.25)


@pytest.mark.parametrize("direction", ["jax to torch", "torch to jax"])
def test_resume_state_loads_in_the_other_package(direction, tmp_path):
    rng = np.random.RandomState(33)
    cfg, x, y, params = _jax_train_state(rng)
    jopt = JAdam()
    state = jopt.init(params)
    model = _torch_model(cfg, x, y)
    topt = Adam(model)
    for _ in range(3):   # both optimizers in a state that is not their initial one
        grads = jax.tree.map(lambda v: jnp.asarray(rng.randn(), jnp.float32), params)
        params, state = jopt.update(grads, state, params, 1e-2)
        topt.zero_grad()
        for name, p in model.named_parameters():
            p.grad = torch.as_tensor(np.asarray(dict(jnamed(grads))[name]))
        topt.update(1e-2)
    path = str(tmp_path / "resume.state")
    if direction == "jax to torch":
        jsave_state(path, params, state, META)
        meta = load_training_state(path, model, topt)
        got_p = [to_numpy(p) for _, p in sorted(model.named_parameters())]
        got_o = [to_numpy(t) for t in topt.state_leaves()]
        want_p = [np.asarray(v) for _, v in jnamed(params)]
        want_o = [np.asarray(t) for t in jax.tree_util.tree_leaves(state)]
    else:
        save_training_state(path, model, topt, META)
        params, state, meta = jload_state(path, params, state)
        got_p = [np.asarray(v) for _, v in jnamed(params)]
        got_o = [np.asarray(t) for t in jax.tree_util.tree_leaves(state)]
        want_p = [to_numpy(p) for _, p in sorted(model.named_parameters())]
        want_o = [to_numpy(t) for t in topt.state_leaves()]
    assert {k: float(v) for k, v in meta.items()} == META
    assert len(got_p) == len(want_p) == 6 and len(got_o) == len(want_o) == 13
    for g, w in zip(got_p + got_o, want_p + want_o):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# -- SNNGPRegressor ----------------------------------------------------------------

def test_regressor_20_step_trajectory_matches_jax():
    from snngp.sklearn import SNNGPRegressor as JRegressor
    rng = np.random.RandomState(34)
    x = rng.randn(60, 4).astype(np.float32)
    y = np.sin(x[:, 0]) + 0.1 * rng.randn(60).astype(np.float32) + 3.0
    kw = dict(method="tp", num_hiddens=2, b_std=0.3, eps=0.1, max_steps=20, lr=1e-2)
    want = JRegressor(**kw).fit(x, y)
    got = SNNGPRegressor(**kw, device="cpu").fit(x, y)
    assert got.losses_.shape == (20,) and np.all(np.diff(got.losses_) < 0)
    np.testing.assert_allclose(got.final_loss_, want.final_loss_, rtol=1e-4)
    want_params = dict(jnamed(want.params_))
    for name, p in got.model_.named_parameters():
        np.testing.assert_allclose(p.item(), float(want_params[name]), rtol=1e-4,
                                   err_msg=name)
    x_new = rng.randn(15, 4).astype(np.float32)
    for g, w in zip(got.predict(x_new, return_std=True), want.predict(x_new, return_std=True)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
    np.testing.assert_allclose(got.score(x, y), want.score(x, y), rtol=1e-4)
    np.testing.assert_allclose(got.neg_log_likelihood(x, y), want.neg_log_likelihood(x, y),
                               rtol=1e-4)


def test_regressor_protocol_and_what_is_not_ported():
    est = SNNGPRegressor(method="gp", num_hiddens=3, device="cpu")
    assert est.get_params()["device"] == "cpu"
    est.set_params(num_hiddens=2)
    x = np.random.RandomState(35).randn(20, 2).astype(np.float32)
    ext = SNNGPRegressor(method="gp", num_hiddens=2, extendable=True, device="cpu")
    assert ext.fit(x[:15], x[:15, 0]).add_data(x[15:], x[15:, 0]) is ext
    assert ext.model_.num_data == 20 and np.all(np.isfinite(ext.predict(x)))
    est.fit(x, x[:, 0])
    assert not hasattr(est, "losses_")   # max_steps=0 keeps the constructor values
    with pytest.raises(ValueError, match="extendable"):    # add_data needs extendable=True
        est.add_data(x, x[:, 0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SNNGPRegressor().fit(x, x[:, 0])


# -- reg tr against the JAX CLI ------------------------------------------------------

def _log_numbers(path):
    """Every number on the NLL / nll lines of a train.log, in order."""
    out = []
    for line in open(path).read().splitlines():
        assert "Traceback" not in line
        if "NLL:" in line or "nll:" in line:
            out += [float(t) for t in line.replace("[", " ").replace("]", " ").split()
                    if t[0].isdigit() or t[0] == "-"]
    return np.array(out)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One ``reg tr`` of each package on syn-normal, 20 steps."""
    root = str(tmp_path_factory.mktemp("train"))
    _jax_cli(["reg", "tr", *CLI_ARGS, "-t", "20", "-cr", root, "-cn", "jax"])
    torch_cli(["--device", "cpu", "reg", "tr", *CLI_ARGS, "-t", "20", "-cr", root,
               "-cn", "torch"])
    return root


def test_reg_tr_logs_the_jax_cli_nlls(trained):
    want = _log_numbers(os.path.join(trained, "jax", "train.log"))
    got = _log_numbers(os.path.join(trained, "torch", "train.log"))
    assert got.shape == want.shape and len(got) > 20
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_reg_tr_checkpoints_and_meta_load_in_either_package(trained):
    for run in ("jax", "torch"):
        ckpt_dir = os.path.join(trained, run)
        last = os.path.join(ckpt_dir, Checkpointer.FILE_FORMAT.format(
            Checkpointer.list_indices(ckpt_dir)[-1]))
        got, want = load_named(last), jload_named(last)
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])
    # The JAX CLI tests the port's checkpoint, the port the JAX one.
    nll = {}
    for run, cli in (("torch", lambda a: _jax_cli(a)),
                     ("jax", lambda a: torch_cli(["--device", "cpu", *a]))):
        ckpt_dir = os.path.join(trained, run)
        cli(["reg", "ts", "-cd", ckpt_dir, "-q"])
        text = open(os.path.join(ckpt_dir, "test", "test.log")).read()
        assert "Traceback" not in text, text
        nll[run] = float(text.split("NLL:")[-1].split()[0])
    np.testing.assert_allclose(nll["torch"], nll["jax"], rtol=RTOL)


def test_reg_tr_resumes_from_a_jax_resume_state(trained, tmp_path):
    for name in ("jax", "torch"):
        shutil.copytree(os.path.join(trained, "jax"), tmp_path / name)
    args = ["reg", "tr", *CLI_ARGS, "-t", "30", "-cr", str(tmp_path), "-rs"]
    _jax_cli([*args, "-cn", "jax"])
    torch_cli(["--device", "cpu", *args, "-cn", "torch"])
    logs = {name: str(tmp_path / name / "train.log") for name in ("jax", "torch")}
    text = open(logs["torch"]).read()
    assert "at step 20" in text and "[   30] nll:" in text and "[   10] nll:" not in text
    np.testing.assert_allclose(_log_numbers(logs["torch"]), _log_numbers(logs["jax"]),
                               rtol=RTOL)


def test_reg_tr_scan_chunk_and_profile_keep_the_math(trained, tmp_path):
    torch_cli(["--device", "cpu", "reg", "tr", *CLI_ARGS, "-t", "20", "-sck", "5",
               "-prof", "-cr", str(tmp_path), "-cn", "chunked"])
    log = str(tmp_path / "chunked" / "train.log")
    np.testing.assert_array_equal(_log_numbers(log),
                                  _log_numbers(os.path.join(trained, "torch", "train.log")))
    text = open(log).read()
    for phase in ("train", "gram", "cholesky+solves", "backward", "optimizer", "valid"):
        assert f"\n{phase} " in text
    with pytest.raises(SystemExit, match="scan-chunk"):
        torch_cli(["--device", "cpu", "reg", "tr", *CLI_ARGS, "-t", "20", "-sck", "3",
                   "-cr", str(tmp_path), "-cn", "bad"])


def test_reg_tr_mesh_is_not_ported_and_the_failure_is_reraised(trained, tmp_path,
                                                               monkeypatch):
    # The mesh is ported (tests/test_torch_mesh.py): two CPU shards log the
    # NLLs of one device. A failure, such as a malformed device count, is
    # still logged and re-raised.
    monkeypatch.setenv("SNNGP_MESH_DEVICES", "2")
    torch_cli(["--device", "cpu", "reg", "tr", *CLI_ARGS, "-t", "20", "-cr", str(tmp_path),
               "-cn", "mesh"])
    log = str(tmp_path / "mesh" / "train.log")
    assert "Mesh: 2 devices" in open(log).read()
    np.testing.assert_allclose(_log_numbers(log),
                               _log_numbers(os.path.join(trained, "torch", "train.log")),
                               rtol=RTOL)
    monkeypatch.setenv("SNNGP_MESH_DEVICES", "two")
    with pytest.raises(ValueError, match="two"):
        torch_cli(["--device", "cpu", "reg", "tr", *CLI_ARGS, "-t", "2", "-cr",
                   str(tmp_path), "-cn", "bad"])
    text = open(tmp_path / "bad" / "train.log").read()
    assert "Traceback" in text and "Stopped" in text
