"""Port parity: ``python -m snngp_torch.examples.paper_figures`` against
``examples/paper_figures.py``, with JAX's dataset, sigma draws and initial
params handed to the port: 20 members at width 16, 50 SGD steps.

Tolerances, relative to the largest magnitude of JAX's array:
- float32, the samples of the ``initial`` and ``last`` panels: 1e-5
  (measured 1.4e-6);
- float64 (``jax.enable_x64``, the port in float64 on the same draws):
  ``draw_sinx``, the analytic mu / std of all three panels and the samples
  of all three: 1e-9 (measured <= 3e-13). In float32 the erf kernel at
  w_std 8 is ill-conditioned: the analytic posteriors' mu / std differ by
  up to 4e-4 between the two packages' fp32 kernels, and the fully trained
  member with the largest sigma by 9e-3 after 50 steps (every other member
  by <= 4e-6), so those are held in float64;
- ``ks_correspondence`` of the two packages on the same samples: equal.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch
from jax import random

from snngp_torch.examples import paper_figures as tfig

from _torch_parity import to_numpy  # noqa: F401  (sets the thread count)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, WIDTH, STEPS = 20, 16, 50
PANELS = {part: (alpha, beta) for part, alpha, beta in tfig.PANELS}


def _jax_module():
    spec = importlib.util.spec_from_file_location(
        "jax_paper_figures", os.path.join(REPO, "examples", "paper_figures.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jfig = _jax_module()


def _jax_draws(alpha, beta):
    """JAX's dataset, and the members' sigmas and initial params stacked
    [M, ...], drawn as its draw_corr draws them (examples/paper_figures.py:
    64-83, 180)."""
    key, *data = jfig._make_dataset(10, 5, 40, 0.1)
    sigmas, members = [], []
    for k in random.split(key, M):
        key_s, key_p = random.split(k)
        sigma = jfig._sample_last_scale(key_s, alpha, beta)
        sigmas.append(np.asarray(sigma))
        members.append(jax.device_get(jfig._erf_net(sigma, width=WIDTH).init(key_p, (-1, 1))[1]))
    params = tuple(tuple(np.stack(leaves) for leaves in zip(*layer))
                   for layer in zip(*members))
    return tuple(np.asarray(a) for a in data), np.array(sigmas), params


def _both(part, map_batch=7):
    alpha, beta = PANELS[part]
    dataset, sigmas, params = _jax_draws(alpha, beta)
    kw = dict(alpha=alpha, beta=beta, ensemble_size=M, train_steps=STEPS, width=WIDTH)
    want = jfig.draw_corr(part, map_batch=M, **kw)
    got = tfig.draw_corr(part, map_batch=map_batch, device="cpu", dataset=dataset,
                         sigmas=sigmas, params=params, **kw)
    return want, got


def _rel(got, want):
    """max |got - want| over max |want| (over 1 where want is all zeros: the
    initial panel's mu)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) or 1.0)


@pytest.mark.parametrize("part", ["initial", "last"])
def test_members_match_jax_fp32(part):
    want, got = _both(part)
    assert _rel(got["samples"], want["samples"]) <= 1e-5
    for idx in (20, 21):
        assert tfig.ks_correspondence(got, idx) == jfig.ks_correspondence(got, idx)


@pytest.mark.parametrize("part", ["initial", "last", "full"])
def test_panels_match_jax_float64(part):
    with jax.enable_x64(True):
        want, got = _both(part)
    assert want["samples"].dtype == np.float64
    for field in ("samples", "mu", "std"):
        assert _rel(got[field], want[field]) <= 1e-9, field
    assert got["nu"] == want["nu"]
    assert tfig.ks_correspondence(got, 21) == jfig.ks_correspondence(got, 21)


def test_draw_sinx_matches_jax_float64():
    with jax.enable_x64(True):
        want = jfig.draw_sinx(alpha=2.0, beta=2.0)
        _, *data = jfig._make_dataset(10, 5, 40, 0.1)
    got = tfig.draw_sinx(alpha=2.0, beta=2.0, device="cpu",
                         dataset=tuple(np.asarray(a) for a in data))
    for field in ("gp_mean", "gp_std", "t_std", "x_test", "y_test"):
        assert _rel(got[field], np.asarray(want[field])) <= 1e-9, field
    assert got["nu"] == want["nu"]


def test_default_dataset_is_the_notebooks():
    """The port's default dataset is JAX's PRNGKey(10) draws (within float32
    round-off of the linspace); another seed draws its own."""
    _, *want = jfig._make_dataset(10, 5, 40, 0.1)
    got = tfig._make_dataset(10, 5, 40, 0.1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=3e-7)
    other = tfig._make_dataset(11, 5, 40, 0.1)
    assert other[0].shape == (5, 1) and not np.allclose(other[0], got[0])


def test_main_runs_every_panel(tmp_path, capsys):
    """The script at a small size on the CPU, its own draws: finite KS
    statistics; the port's draws do not depend on --map-batch; the
    figures/ directory of the JAX package is refused as --outdir."""
    argv = ["--device", "cpu", "--ensemble-size", "12", "--train-steps", "5", "--width", "16",
            "--outdir", str(tmp_path)]
    out = tfig.main(argv + ["--map-batch", "12"])
    printed = capsys.readouterr().out
    assert set(out["panels"]) == {"initial", "last", "full"}
    for part, panel in out["panels"].items():
        assert 0.0 < panel["ks"] < 1.0 and f"{part:8s}: KS" in printed
    again = tfig.main(argv + ["--map-batch", "5"])
    for part in out["panels"]:
        np.testing.assert_allclose(again["panels"][part]["result"]["samples"],
                                   out["panels"][part]["result"]["samples"], rtol=1e-5)
    with pytest.raises(SystemExit):
        tfig.main(["--device", "cpu", "--outdir", os.path.join(REPO, "figures")])


def test_sgd_train_leaves_its_inputs():
    generator = torch.Generator().manual_seed(0)
    params = tfig.init_members(generator, 3, width=8)
    before = [p.clone() for layer in params for p in layer]
    x = torch.linspace(-1, 1, 5)[:, None]
    trained = tfig.sgd_train(params, torch.ones(3), x, torch.sin(x), 3, 1e-2, last_only=False)
    after = [p for layer in params for p in layer]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert not torch.equal(trained[0][0], params[0][0])
