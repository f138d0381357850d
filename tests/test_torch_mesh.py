"""Port parity of exact-GP regression on a mesh: ``SPR(mesh=)`` (the sharded
train Gram, the blocked factorization in the loss and the predictive, rows
padded to the mesh), ``distributed_mlii_value_and_grad``, ``reg tr`` / ``reg
ts`` with ``SNNGP_MESH_DEVICES=4`` and ``examples/mesh_pipeline.py``, against
the JAX package on its 8-device CPU mesh. The port's meshes are shards of
the CPU.

Tolerances:
- ``SPR.loss`` and its gradients, float32: rtol 1e-5 (plus 1e-5 of the
  largest gradient). eps = 0.5 absolute keeps S's condition number ~30,
  where the two packages' fp32 Grams and factorization orders differ by
  ~1e-6; float64 (mesh against one device in the port): 1e-12, round-off;
- the distributed ML-II step against the JAX package's: loss rtol 1e-5,
  gradients rtol 2e-4 (atol 1e-7), the JAX package's own bar between its
  distributed and single-device steps (tests/test_parallel_mlii.py), since
  the gradient's two terms cancel; in float64 against a numpy closed form:
  1e-12;
- the CLIs' logged NLLs: rtol 5e-3, tests/test_cli_smoke.py's bar between
  two programs;
- the pipeline's NLL: rtol 1e-4, the example's own parity bar.
"""

import os
import runpy
import sys
from contextlib import redirect_stdout
from io import StringIO

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snngp.models import (SPR as JSPR, GaussianLikelihood as JGauss, NNGPKernel as JKernel,
                          StudentTLikelihood as JStudent)
from snngp.models.mlii import full_gram_mlii_value_and_grad as jfull_mlii
from snngp.models.mlii import tiled_aug_gram as jtiled_aug_gram
from snngp.nn import arch as jarch
from snngp.ops.pallas.gram import _reference_recursion as j_recursion
from snngp.parallel import get_mesh as jget_mesh
from snngp.parallel.mlii import distributed_mlii_value_and_grad as jdist_mlii

from snngp_torch.__main__ import main as torch_cli
from snngp_torch.examples import mesh_pipeline
from snngp_torch.models import SPR, GaussianLikelihood, NNGPKernel, StudentTLikelihood
from snngp_torch.nn import arch as tarch
from snngp_torch.ops.gram import _reference_recursion as t_recursion
from snngp_torch.parallel import get_mesh
from snngp_torch.parallel.cholesky import blocked_cholesky
from snngp_torch.parallel.mlii import distributed_mlii_value_and_grad, sharded_aug_gram
from snngp_torch.parallel.mesh import gather

from _torch_parity import cuda_device, randn  # noqa: F401  (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = 1e-5
F64 = 1e-12
LOSS_EPS = 0.5
CLI_RTOL = 5e-3
CLI_ARGS = ["-m", "tp", "-a", "2", "-b", "0.02", "-dn", "syn-normal", "-vi", "5",
            "-pi", "5", "-nh", "2", "-eps", "1e-2", "-q"]


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=tol,
                               atol=tol * np.abs(want).max())


# -- SPR on a mesh -----------------------------------------------------------------------

def _jax_model(method, x, y, mesh):
    kernel = JKernel(lambda w, b, l: jarch.get_mlp_kernel(2, act="relu", w_std=w, b_std=b,
                                                          last_w_std=l), 1.2, 0.5, 0.9)
    lik = JGauss() if method == "gp" else JStudent(1.5, 2.5)
    return JSPR(kernel, lik, x, y, jnp.array(0.7), jnp.array(1.3), eps=LOSS_EPS, mesh=mesh,
                chol_block=8)


def _torch_model(method, x, y, mesh):
    kernel = NNGPKernel(lambda w, b, l: tarch.get_mlp_kernel(2, act="relu", w_std=w, b_std=b,
                                                             last_w_std=l,
                                                             trainable_inputs=False),
                        1.2, 0.5, 0.9)
    lik = GaussianLikelihood() if method == "gp" else StudentTLikelihood(1.5, 2.5)
    return SPR(kernel, lik, x, y, 0.7, 1.3, eps=LOSS_EPS, mesh=mesh, chol_block=8)


def _torch_loss_and_grads(model):
    model.zero_grad()
    loss = model.loss()
    loss.backward()
    return loss.item(), {n: p.grad.item() for n, p in model.named_parameters()}


@pytest.mark.parametrize("method", ["gp", "tp"])
def test_spr_loss_and_gradients_on_a_mesh_match_jax(method):
    """30 rows on 8 shards: both packages pad to 32 and slice back."""
    x, y = randn(31, (30, 3), (30,))
    jm = _jax_model(method, x, y, jget_mesh(8))
    params = jm.init_params()
    want_loss, want_g = jax.jit(jax.value_and_grad(jm.loss))(params)
    tm = _torch_model(method, x, y, get_mesh(8, device="cpu"))
    assert tm.chol_fn is tm.likelihood.chol_fn is not None
    assert tm.chol_fn.func is blocked_cholesky and tm.chol_fn.keywords == {"block": 8}
    loss, grads = _torch_loss_and_grads(tm)
    _close(loss, float(want_loss), F32)
    want = {".".join(k): float(v) for k, v in _flatten(want_g)}
    assert sorted(grads) == sorted(want)
    _close([grads[k] for k in sorted(want)], [want[k] for k in sorted(want)], F32)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("method", ["gp", "tp"])
def test_spr_on_a_mesh_equals_one_device_in_float64(method):
    """Loss, gradients and the predictive on 8 shards (30 rows: padded) and
    on one device, both in float64: round-off."""
    x, y, xt, yt = randn(32, (30, 3), (30,), (7, 3), (7,))
    out = []
    for mesh in (get_mesh(8, device="cpu"), None):
        model = _torch_model(method, x, y, mesh).to(torch.float64)
        loss, grads = _torch_loss_and_grads(model)
        with torch.no_grad():
            nll = model.test_nll(torch.as_tensor(xt, dtype=torch.float64),
                                 torch.as_tensor(yt, dtype=torch.float64)).item()
        out.append([loss, nll] + [grads[k] for k in sorted(grads)])
    _close(out[0], out[1], F64)


def test_spr_mesh_test_nll_matches_jax():
    x, y, xt, yt = randn(33, (32, 3), (32,), (8, 3), (8,))
    jm = _jax_model("tp", x, y, jget_mesh(8))
    want = float(jax.jit(jm.test_nll)(jm.init_params(), xt, yt))
    tm = _torch_model("tp", x, y, get_mesh(8, device="cpu"))
    with torch.no_grad():
        got = tm.test_nll(*(torch.as_tensor(a) for a in (xt, yt))).item()
    _close(got, want, 1e-4)   # the conditional-t NLL through d: 1e-6 jitter


# -- the distributed ML-II step ----------------------------------------------------------

HYPER = dict(w_std=1.3, b_std=0.4, last_w_std=0.9)
MLII_EPS = 3e-2


def _jax_aug():
    w, b, l = (jnp.asarray(HYPER[k], jnp.float32) for k in ("w_std", "b_std", "last_w_std"))

    def aug(x1, x2):
        f = lambda wv, bv: j_recursion(x1, x2, 3, "relu", wv, bv, l)  # noqa: E731
        _, dkw = jax.jvp(lambda wv: f(wv, b), (w,), (jnp.ones_like(w),))
        _, dkb = jax.jvp(lambda bv: f(w, bv), (b,), (jnp.ones_like(b),))
        return f(w, b), dkw, dkb

    return aug


def _torch_aug(dtype=torch.float32):
    w, b, l = (torch.tensor(HYPER[k], dtype=dtype) for k in ("w_std", "b_std", "last_w_std"))

    def aug(x1, x2):
        f = lambda wv, bv: t_recursion(x1, x2, 3, "relu", wv, bv, l, "mlp")  # noqa: E731
        _, dkw = torch.func.jvp(lambda wv: f(wv, b), (w,), (torch.ones_like(w),))
        _, dkb = torch.func.jvp(lambda bv: f(w, bv), (b,), (torch.ones_like(b),))
        return f(w, b), dkw, dkb

    return aug


def _mlii_data():
    rng = np.random.RandomState(0)
    return rng.randn(64, 6).astype(np.float32), rng.randn(64).astype(np.float32)


@pytest.mark.parametrize("ab", [None, (2.0, 1.5)])
def test_distributed_mlii_matches_jax(ab):
    x, y = _mlii_data()
    mesh = jget_mesh(8)
    want_loss, want_g = jax.jit(lambda xx, yy: jdist_mlii(
        _jax_aug(), xx, yy, mesh, last_w_std=HYPER["last_w_std"], eps=MLII_EPS, ab=ab,
        chol_block=4))(jnp.asarray(x), jnp.asarray(y))
    loss, grads = distributed_mlii_value_and_grad(
        _torch_aug(), torch.as_tensor(x), y, get_mesh(8, device="cpu"),
        last_w_std=HYPER["last_w_std"], eps=MLII_EPS, ab=ab, chol_block=4)
    np.testing.assert_allclose(loss, float(want_loss), rtol=F32)
    assert sorted(grads) == sorted(want_g)
    for name in grads:
        np.testing.assert_allclose(grads[name], float(want_g[name]), rtol=2e-4, atol=1e-7,
                                   err_msg=name)
    # and the JAX package's single-device closed form on its tiles
    k, dkw, dkb = jtiled_aug_gram(_jax_aug(), x, block=16)
    single_loss, single = jfull_mlii(k, dkw, dkb, y, last_w_std=HYPER["last_w_std"],
                                     eps=MLII_EPS, ab=ab, panel=24)
    np.testing.assert_allclose(loss, single_loss, rtol=F32)
    for name in grads:
        np.testing.assert_allclose(grads[name], single[name], rtol=2e-4, atol=1e-7)


@pytest.mark.parametrize("ab", [None, (2.0, 1.5)])
def test_distributed_mlii_float64_round_off(ab):
    """The step in float64 (4 shards) against the closed form written out in
    numpy float64 on the same tiles."""
    x, y = _mlii_data()
    x64 = torch.as_tensor(x, dtype=torch.float64)
    mesh = get_mesh(4, device="cpu")
    loss, grads = distributed_mlii_value_and_grad(
        _torch_aug(torch.float64), x64, y.astype(np.float64), mesh,
        last_w_std=HYPER["last_w_std"], eps=MLII_EPS, ab=ab, chol_block=8)
    k, dkw, dkb = (gather(p).numpy() for p in sharded_aug_gram(_torch_aug(torch.float64),
                                                               x64, mesh))
    n = len(y)
    s_inv = np.linalg.inv(k + MLII_EPS * np.eye(n))
    alpha = s_inv @ y
    q = y @ alpha
    if ab is None:
        c_aa = -1.0 / (2 * n)
    else:
        a, b = ab
        c_aa = -(a / b) * (2 * a + n) / (2 * n * (2 * a + (a / b) * q))
    g = s_inv / (2 * n) + c_aa * np.outer(alpha, alpha)
    want = {"w_std": np.sum(g * dkw), "b_std": np.sum(g * dkb),
            "last_w_std": np.sum(g * k) * 2 / HYPER["last_w_std"], "eps": np.trace(g)}
    for name, v in want.items():
        _close(grads[name], v, F64)
    logdet = np.linalg.slogdet(k + MLII_EPS * np.eye(n))[1]
    if ab is None:
        _close(loss, (q + logdet + n * np.log(2 * np.pi)) / (2 * n), 1e-6)  # fp32 formula
    with pytest.raises(ValueError, match="divide"):
        distributed_mlii_value_and_grad(_torch_aug(), torch.as_tensor(x[:30]), y[:30], mesh,
                                        last_w_std=1.0, eps=MLII_EPS)


# -- the CLI -----------------------------------------------------------------------------

def _jax_cli(argv):
    sys.path.insert(0, REPO)
    import run as run_mod
    run_mod.main(argv)


def _log_numbers(path):
    out = []
    for line in open(path).read().splitlines():
        assert "Traceback" not in line
        if "NLL:" in line or "nll:" in line:
            out += [float(t) for t in line.replace("[", " ").replace("]", " ").split()
                    if t[0].isdigit() or t[0] == "-"]
    return np.array(out)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """``reg tr`` of each package on a 4-shard mesh, 10 steps."""
    root = str(tmp_path_factory.mktemp("mesh_train"))
    saved = os.environ.get("SNNGP_MESH_DEVICES")
    os.environ["SNNGP_MESH_DEVICES"] = "4"
    try:
        _jax_cli(["reg", "tr", *CLI_ARGS, "-t", "10", "-cr", root, "-cn", "jax"])
        torch_cli(["--device", "cpu", "reg", "tr", *CLI_ARGS, "-t", "10", "-cr", root,
                   "-cn", "torch"])
    finally:
        if saved is None:
            os.environ.pop("SNNGP_MESH_DEVICES")
        else:
            os.environ["SNNGP_MESH_DEVICES"] = saved
    return root


def test_reg_tr_on_a_mesh_logs_the_jax_cli_nlls(mesh_runs):
    for run in ("jax", "torch"):
        assert "Mesh: 4 devices" in open(os.path.join(mesh_runs, run, "train.log")).read()
    want = _log_numbers(os.path.join(mesh_runs, "jax", "train.log"))
    got = _log_numbers(os.path.join(mesh_runs, "torch", "train.log"))
    assert got.shape == want.shape and len(got) > 10
    np.testing.assert_allclose(got, want, rtol=CLI_RTOL)


def test_reg_ts_of_mesh_checkpoints_matches_jax(mesh_runs):
    nll = {}
    for run, cli in (("torch", _jax_cli), ("jax", lambda a: torch_cli(["--device", "cpu", *a]))):
        ckpt_dir = os.path.join(mesh_runs, run)
        cli(["reg", "ts", "-cd", ckpt_dir, "-q"])
        text = open(os.path.join(ckpt_dir, "test", "test.log")).read()
        assert "Traceback" not in text, text
        nll[run] = float(text.split("NLL:")[-1].split()[0])
    np.testing.assert_allclose(nll["torch"], nll["jax"], rtol=CLI_RTOL)


def test_devices_flag_sets_the_mesh(tmp_path, monkeypatch):
    # setenv (not delenv of an absent name) records the variable, so that the
    # value the flag writes is taken away after the test.
    monkeypatch.setenv("SNNGP_MESH_DEVICES", "1")
    torch_cli(["--device", "cpu", "--devices", "2", "reg", "tr", *CLI_ARGS, "-t", "5",
               "-cr", str(tmp_path), "-cn", "m"])
    assert os.environ["SNNGP_MESH_DEVICES"] == "2"
    assert "Mesh: 2 devices" in open(tmp_path / "m" / "train.log").read()


# -- the pipeline ------------------------------------------------------------------------

# eps 0.1: at the scripts' default 1e-3 the regularized Gram's condition
# number takes two fp32 factorization orders past the parity bar (the JAX
# script fails its own gate there too)
PIPE = ["--devices", "8", "--cpu", "--n-train", "256", "--eps", "1e-1"]


def test_mesh_pipeline_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    """The JAX script's NLL (without its parity run) against the port's,
    which passes its own parity gate against one device."""
    saved = sys.argv
    sys.argv = ["mesh_pipeline.py", *PIPE, "--no-parity"]
    buf = StringIO()
    try:
        with redirect_stdout(buf):
            runpy.run_path(os.path.join(REPO, "examples", "mesh_pipeline.py"),
                           run_name="__main__")
    finally:
        sys.argv = saved
    want = float(buf.getvalue().split("predictive NLL:")[1].split()[0])
    result = mesh_pipeline.main(PIPE)
    assert result["parity_nll"] is not None
    assert sorted(result["phases_s"]) == sorted([
        "gram_train (sharded)", "gram_cross (sharded)", "gram_test", "cyclic_cholesky",
        "student-t predictive"])
    np.testing.assert_allclose(result["nll"], want, rtol=1e-4)
    assert "parity vs single device: OK" in capsys.readouterr().out


def test_mesh_pipeline_myrtle_and_a_given_mesh():
    result = mesh_pipeline.main(["--arch", "myrtle", "--n-train", "32", "--n-test", "8",
                                 "--devices", "4", "--eps", "1e-1"],
                                mesh=get_mesh(devices=["cpu"] * 4))
    assert np.isfinite(result["nll"]) and result["parity_nll"] is not None


def test_mesh_pipeline_on_cuda_needs_the_cards():
    if torch.cuda.device_count() >= 8:
        pytest.skip("this machine has 8 cards")
    with pytest.raises(ValueError, match="cards"):
        mesh_pipeline.main(["--devices", "8", "--n-train", "64"])


# -- the Myrtle scale tangents under inference mode --------------------------------------

def _tangents_in_both_modes(device):
    from snngp_torch.ops import myrtle_gram as MG
    x0 = np.random.RandomState(34).randn(6, 8, 8, 3).astype(np.float32)
    x = torch.as_tensor(x0, device=device)
    out = MG.myrtle_gram_scale_grads(x, x[:4], depth=5, w_std=1.0, b_std=0.1)
    with torch.inference_mode():
        xi = torch.as_tensor(x0, device=device)
        inf = MG.myrtle_gram_scale_grads(xi, xi[:4], depth=5, w_std=1.0, b_std=0.1)
    return out, inf


def test_myrtle_scale_tangents_do_not_depend_on_inference_mode():
    """The profile tangents are forward-mode AD, taken outside inference
    mode (on the card, torch 2.11's forward AD under inference mode gave
    other tangents; K was unchanged)."""
    for got, want in zip(*_tangents_in_both_modes("cpu")):
        assert torch.equal(got, want)


def test_myrtle_scale_tangents_do_not_depend_on_inference_mode_on_the_card(cuda_device):
    for got, want in zip(*_tangents_in_both_modes(cuda_device)):
        assert torch.equal(got, want)
