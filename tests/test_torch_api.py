"""Port parity of the JAX package's remaining public API: the package
exports (``snngp_torch.ops`` / ``.nn`` / ``.models`` and ``parallel``),
the linear-algebra helpers, the bijectors, ``Prior``, ``unflatten_named``,
``utils.profiling.trace`` and the CLI's ``-f/--fraction`` pre-flag.

Tolerances: the helpers' fp32 results against the JAX package's on the same
numpy inputs, rtol 1e-5 (one LU or Cholesky factorization of a
well-conditioned 6 x 6 matrix in either framework); the bijectors rtol
1e-6 (elementwise exp / log / softplus / expm1).
"""

import json
import os
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import snngp
import snngp.models as jmodels
import snngp.nn as jnn
import snngp.ops as jops
from snngp.models import bijectors as jbij
from snngp.models import params as jparams

import snngp_torch
import snngp_torch.models as tmodels
import snngp_torch.nn as tnn
import snngp_torch.ops as tops
from snngp_torch.__main__ import _take_fraction
from snngp_torch.__main__ import main as torch_cli
from snngp_torch.models import bijectors as tbij
from snngp_torch.models import params as tparams
from snngp_torch.utils import profiling
from snngp_torch.utils.profiling import trace

from _torch_parity import randn, to_numpy, to_torch


@pytest.mark.parametrize("jax_mod,torch_mod", [(jops, tops), (jnn, tnn), (jmodels, tmodels)],
                         ids=["ops", "nn", "models"])
def test_every_public_name_is_exported(jax_mod, torch_mod):
    missing = [n for n in jax_mod.__all__ if not hasattr(torch_mod, n)]
    assert not missing
    assert set(jax_mod.__all__) <= set(torch_mod.__all__)


def test_the_package_exports_parallel():
    assert set(snngp.__all__) <= set(snngp_torch.__all__)
    assert snngp_torch.parallel.get_mesh is not None


def _spd(seed, batch=()):
    (a,) = randn(seed, (*batch, 6, 6))
    return a @ np.swapaxes(a, -1, -2) / 6 + np.eye(6, dtype=np.float32)


@pytest.mark.parametrize("name", ["jitter", "logdet", "logdet_batched", "trace",
                                  "trace_batched", "split_kernel", "solve_psd", "inv_psd"])
def test_linalg_helpers_match_jax(name):
    mat = _spd(3, (2,) if name.endswith("batched") else ())
    (b,) = randn(4, (6, 2))
    if name == "jitter":
        want, got = [jops.jitter(5, 1e-3)], [tops.jitter(5, 1e-3)]
    elif name.startswith("logdet"):
        # A matrix with negative determinant: the sign enters the sum.
        mat = mat * np.array([-1, 1, 1, 1, 1, 1], np.float32)[:, None]
        want, got = [jops.logdet(mat)], [tops.logdet(to_torch(mat))]
    elif name.startswith("trace"):
        want, got = [jops.trace(mat)], [tops.trace(to_torch(mat))]
    elif name == "split_kernel":
        want, got = jops.split_kernel(mat, 2), tops.split_kernel(to_torch(mat), 2)
    elif name == "solve_psd":
        want, got = [jops.solve_psd(mat, b)], [tops.solve_psd(*to_torch(mat, b))]
    else:
        want, got = [jops.inv_psd(mat)], [tops.inv_psd(to_torch(mat))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("base,lower", [("exp", 0.0), ("exp", 0.5), ("softplus", 0.0),
                                        ("softplus", 1e-3), (None, None)])
def test_positive_bijectors_match_jax(base, lower):
    jb, tb = jbij.positive(lower, base), tbij.positive(lower, base)
    assert type(tb).__name__ == type(jb).__name__ and tb.lower == jb.lower
    assert isinstance(tb, tbij.PositiveBijector) and isinstance(tb, tbij.Bijector)
    x = np.linspace(-4.0, 30.0, 15, dtype=np.float32)
    y = np.linspace(0.6, 40.0, 15, dtype=np.float32)
    np.testing.assert_allclose(to_numpy(tb(to_torch(x))), np.asarray(jb(jnp.asarray(x))),
                               rtol=1e-6)
    np.testing.assert_allclose(to_numpy(tb.inverse(to_torch(y))),
                               np.asarray(jb.inverse(jnp.asarray(y))), rtol=1e-6, atol=1e-6)


def test_bijector_module_surface():
    assert tbij.DEFAULT_POSITIVE_MINIMUM == jbij.DEFAULT_POSITIVE_MINIMUM
    assert tbij.DEFAULT_POSITIVE_BIJECTOR == jbij.DEFAULT_POSITIVE_BIJECTOR
    with pytest.raises(KeyError, match="Unsupported bijector 'tanh'"):
        tbij.positive(base="tanh")
    with pytest.raises(NotImplementedError):
        tbij.triangular()
    with pytest.raises(TypeError):
        tbij.Bijector()
    # The parameter helpers take any positive bijector.
    exp = tbij.Exp(0.25)
    p = tparams.constrained_init(2.0, exp)
    np.testing.assert_allclose(p.item(), np.log(1.75), rtol=1e-6)
    np.testing.assert_allclose(tparams.constrained_read(p, exp).item(), 2.0, rtol=1e-6)


def test_priors_share_the_prior_base():
    from snngp_torch.models.priors import GaussianPrior, InverseGammaPrior
    assert isinstance(GaussianPrior(), tmodels.Prior)
    assert isinstance(InverseGammaPrior(2.0, 2.0), tmodels.Prior)
    assert issubclass(tmodels.Prior, torch.nn.Module)


def test_unflatten_named_matches_jax():
    named = {"eps": 1.0, "kernel.w_std": 2.0, "kernel.b_std": 3.0, "likelihood.a": 4.0,
             "a.b.c": 5.0}
    want = jparams.unflatten_named(named)
    assert tparams.unflatten_named(named) == want
    flat = dict(tparams.named_leaves(want))
    assert flat == named


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "t")) as logdir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert logdir == str(tmp_path / "t")
    files = [f for f in os.listdir(logdir) if f.endswith(".json")]
    assert len(files) == 1
    with open(os.path.join(logdir, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def _event(name, device):
    kind = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(name=name, device_type=kind)


@pytest.mark.parametrize("names,want", [
    ([("cudaLaunchKernel", 0), ("gram_kernel", 1), ("Memcpy HtoD", 1)], (1, 1)),
    ([("cudaLaunchKernel", 0), ("cuLaunchKernel", 0), ("gram_kernel", 1)], (1, 2)),
    ([("cudaLaunchKernel", 0), ("cudaMemcpyAsync", 0), ("Memset (Device)", 1)], (0, 1)),
    ([("aten::mm", 0)], (0, 0)),
])
def test_kernel_records_counts_kernels_against_launches(names, want):
    assert profiling.kernel_records([_event(n, d) for n, d in names]) == want


@pytest.mark.parametrize("kernel", [True, False])
def test_trace_warns_when_the_profiler_lost_kernels(kernel, tmp_path, monkeypatch):
    """A CUDA capture whose kernel records fall short of its launches warns;
    one that holds them does not."""
    events = [_event("cudaLaunchKernel", False)] + ([_event("gram_kernel", True)] if kernel
                                                    else [])

    class FakeProfile:
        def __init__(self, activities):
            assert torch.profiler.ProfilerActivity.CUDA in activities

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return events

        def export_chrome_trace(self, path):
            with open(path, "w") as fh:
                json.dump({"traceEvents": []}, fh)

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(profiling, "_sync", lambda: None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with trace(str(tmp_path)):
            pass
    lost = [w for w in caught if issubclass(w.category, RuntimeWarning)
            and "recorded 0 kernels for the block's 1 kernel launches" in str(w.message)]
    assert len(lost) == (0 if kernel else 1)
    assert len(os.listdir(tmp_path)) == 1


@pytest.mark.parametrize("argv,fraction,rest", [
    (["-f", "0.5", "reg", "pr", "-fs", "x.npz"], 0.5, ["reg", "pr", "-fs", "x.npz"]),
    (["--fraction=0.25", "cls", "tr", "-fi"], 0.25, ["cls", "tr", "-fi"]),
    (["--device", "cpu", "reg", "ts", "--fraction", "1", "-q"], 1.0,
     ["--device", "cpu", "reg", "ts", "-q"]),
    (["reg", "pr", "-f=0.1", "-fs", "y"], 0.1, ["reg", "pr", "-fs", "y"]),
    (["reg", "pr", "-fs", "y"], None, ["reg", "pr", "-fs", "y"]),
])
def test_fraction_takes_only_its_own_tokens(argv, fraction, rest):
    assert _take_fraction(argv) == (fraction, rest)


@pytest.mark.parametrize("argv", [["-f"], ["-f", "s"], ["--fraction=0"], ["-f", "1.5"]])
def test_fraction_refuses_bad_values(argv):
    with pytest.raises(SystemExit, match="fraction"):
        _take_fraction(argv)


def test_fraction_caps_the_card_and_is_ignored_on_the_cpu(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(torch.cuda, "set_per_process_memory_fraction",
                        lambda f, d=None: calls.append((f, d)))
    # A CPU run: the command runs, no cap is set; -fs reaches reg pr.
    root = str(tmp_path / "ck")
    torch_cli(["--device", "cpu", "-f", "0.5", "reg", "tr", "-m", "tp", "-a", "2", "-b", "0.02",
               "-dn", "syn-normal", "-t", "2", "-vi", "1", "-pi", "1", "-nh", "2", "-eps",
               "1e-2", "-cr", root, "-cn", "run", "-q"])
    fitted = str(tmp_path / "fitted.npz")
    torch_cli(["--device", "cpu", "reg", "pr", "-cd", os.path.join(root, "run"), "-fs",
               fitted, "-f", "0.5", "-q"])
    assert os.path.exists(fitted) and calls == []
    # On a card the cap is set on --device's index before the command runs.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(SystemExit):
        torch_cli(["--device", "cuda:1", "--fraction=0.25", "reg", "tr"])
    with pytest.raises(SystemExit):
        torch_cli(["-f", "0.75", "--device", "cuda", "reg", "tr"])
    assert calls == [(0.25, 1), (0.75, 0)]


def test_dash_fi_reaches_the_subcommand(capsys):
    with pytest.raises(SystemExit) as exc:
        torch_cli(["--device", "cpu", "cls", "tr", "-fi"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "fraction" not in err and "python -m snngp_torch" in err
