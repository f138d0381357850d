"""Port parity of the classification side of the mesh, end to end: ``python
-m snngp_torch --device cpu cls tr`` with ``SNNGP_MESH_DEVICES=4`` (the
batch-sharded ELBO) against the same run on one device, its checkpoint in
the JAX package's ``cls ts``, and ``python -m
snngp_torch.examples.cifar_myrtle`` with ``--devices`` (fused and full tier,
after a full-scope ML-II fit) and ``--bf16`` (full tier and fused). The
port's meshes are shards of the CPU.

Tolerances:
- ``cls tr``'s nELBO lines on the mesh against one device: rtol 1e-5 (the
  same generator and draws; the Gram blocks in row panels);
- the mesh run's checkpoint in the two packages' ``cls ts``: atol 5e-3,
  the Monte Carlo bar of tests/test_torch_cls_cli.py;
- the pipeline's NLL on the mesh against one device: rtol 1e-4, the mesh
  example's own parity bar (the mesh factors through the blocked
  Cholesky, one device through ``torch.linalg``);
- ``--bf16`` (``--fused off`` or ``on``) against the JAX script: rtol 2e-2. The two
  packages round the bfloat16 pair state at other points; their Grams
  differ by up to 5.6e-3 of max|K| (each is 6.4e-3 from float32), and the
  NLL by 0.9% at these sizes. Both need ``--t-jitter 1e-2`` here: at the
  default 1e-6 the Student-t scale factorization of the bf16 Gram is NaN
  in both packages.
"""

import os
import runpy
import sys
from contextlib import redirect_stdout
from io import StringIO

import numpy as np
import pytest

from snngp_torch.__main__ import main as torch_cli
from snngp_torch.examples import cifar_myrtle as example
from snngp_torch.parallel import get_mesh
from snngp_torch.parallel import gram as G

from _torch_parity import to_numpy  # noqa: F401  (sets the thread count)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 270 training images in batches of 40: six batches the mesh of 4 divides,
# and a last one of 30 that it does not.
TRAIN = ["cls", "tr", "-m", "svtp", "-dn", "synthetic", "-nd", "300", "-ni", "20",
         "-nb", "40", "-nh", "1", "-e", "1", "-ns", "8", "-nvs", "16", "-q"]
MC_ATOL = 5e-3
IMAGES = ["--device", "cpu", "--image-size", "8", "--n-train", "32", "--n-test", "8"]


def _nelbos(path):
    return [float(line.split("nELBO:")[1].split()[0]) for line in open(path)
            if "nELBO:" in line and "NLL:" not in line]


def _test_nll(ckpt, runner):
    runner(["cls", "ts", "-dn", "synthetic", "-cd", ckpt, "-nd", "200", "-q"])
    (log,) = os.listdir(os.path.join(ckpt, "test"))
    text = open(os.path.join(ckpt, "test", log)).read()
    os.remove(os.path.join(ckpt, "test", log))
    assert "Traceback" not in text, text
    return float(text.split("NLL:")[-1].split()[0])


def _jax_cli(argv):
    sys.path.insert(0, REPO)
    import run as run_mod
    run_mod.main(argv)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``cls tr`` on 4 CPU shards (plain loop and ``-sck``) and on one
    device, with the batch sizes each ``sharded_gram`` call was given."""
    root = str(tmp_path_factory.mktemp("cls_mesh"))
    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        sharded = G.sharded_gram
        for name, env, extra in (("mesh", "4", []), ("sck", "4", ["-sck"]),
                                 ("one", "1", [])):
            calls[name] = []

            def recording(kernel_fn, x, *a, _log=calls[name], **kw):
                _log.append(x.shape[0])
                return sharded(kernel_fn, x, *a, **kw)

            mp.setattr(G, "sharded_gram", recording)
            mp.setenv("SNNGP_MESH_DEVICES", env)
            torch_cli(["--device", "cpu", *TRAIN, *extra, "-cr", root, "-cn", name])
    return root, calls


def test_cls_tr_on_a_mesh_matches_one_device(runs):
    root, _ = runs
    text = open(os.path.join(root, "mesh", "train.log")).read()
    assert "Mesh: 4 devices (batch-sharded ELBO)" in text and "Traceback" not in text
    assert "Mesh:" not in open(os.path.join(root, "one", "train.log")).read()
    got, want = _nelbos(os.path.join(root, "mesh", "train.log")), _nelbos(
        os.path.join(root, "one", "train.log"))
    assert len(got) == len(want) > 1 and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_only_batches_the_mesh_divides_are_sharded(runs):
    # Two row-panel Grams (k_bi, k_bb) for each of the six batches of 40;
    # the batch of 30 runs unsharded, and -sck (as in the JAX CLI) and one
    # device never shard.
    _, calls = runs
    assert calls["mesh"] == [40] * 12
    assert calls["sck"] == [] and calls["one"] == []


def test_the_mesh_checkpoint_scores_in_the_jax_cls_ts(runs):
    ckpt = os.path.join(runs[0], "mesh")
    got = _test_nll(ckpt, _jax_cli)
    want = _test_nll(ckpt, lambda argv: torch_cli(["--device", "cpu", *argv]))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, atol=MC_ATOL)


# -- cifar_myrtle on a mesh and in bf16 ----------------------------------------------------

@pytest.mark.parametrize("flags", [["--fused", "on"], ["--fused", "off"],
                                   ["--fused", "on", "--fused-block", "16", "--mlii", "1",
                                    "--mlii-scope", "full"]],
                         ids=["fused", "full tier", "full-scope ML-II"])
def test_cifar_myrtle_on_a_mesh_matches_one_device(flags, tmp_path, monkeypatch):
    """The ML-II fit runs on one device either way; the Grams of the mesh
    run are row panels (fused) or row strips (full tier) over 4 shards."""
    monkeypatch.chdir(tmp_path)
    want = example.main([*IMAGES, *flags])
    calls = []
    sharded = G.sharded_gram

    def recording(kernel_fn, x, *a, **kw):
        calls.append(x.shape[0])
        return sharded(kernel_fn, x, *a, **kw)

    monkeypatch.setattr(G, "sharded_gram", recording)
    monkeypatch.setattr(example, "sharded_gram", recording)
    got = example.main([*IMAGES, *flags, "--devices", "4"])
    # fused: the train, cross and test Grams; full tier: a call a strip of 8 rows
    assert calls == ([8] * 6 if "off" in flags else [32, 8, 8])
    assert got["hyper"] == want["hyper"]
    np.testing.assert_allclose(got["nll"], want["nll"], rtol=1e-4)


def test_a_mesh_takes_no_lean_fit(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    mesh = get_mesh(2, device="cpu")
    # auto on a mesh: the blocked factorization at its automatic panel from
    # 4,096 points (the JAX script's rule), SPR's own below; one device: in
    # place from 32,768, else torch.linalg.
    assert example._chol_route("auto", 40_000, mesh) == (False, example.blocked_cholesky)
    assert example._chol_route("auto", 4_096, mesh) == (False, example.blocked_cholesky)
    assert example._chol_route("auto", 4_095, mesh) == (False, None)
    assert example._chol_route("auto", 40_000) == (True, None)
    assert example._chol_route("auto", 4_096) == (False, None)
    with pytest.raises(SystemExit, match="--chol inplace is a single-device kernel"):
        example.main([*IMAGES, "--devices", "2", "--chol", "inplace"])


def test_auto_route_on_a_mesh_takes_the_automatic_panel():
    # --chol auto on a mesh passes blocked_cholesky with block=None, whose
    # panel is JAX's (snngp/parallel/cholesky.py:85-89): at N = 32,768, 22
    # panels of 1,536 rows (SPR(mesh=)'s own default is 64 of 512).
    from snngp_torch.parallel.cholesky import _auto_block, _starts
    assert _auto_block(32_768) == 1536 and len(_starts(32_768, 1536)) == 22
    assert _auto_block(4_096) == 512


def _jax_script(argv):
    saved = sys.argv
    sys.argv = ["cifar_myrtle.py", *argv]
    try:
        buf = StringIO()
        with redirect_stdout(buf):
            runpy.run_path(os.path.join(REPO, "examples", "cifar_myrtle.py"),
                           run_name="__main__")
        return float(buf.getvalue().split("reference semantics):")[-1].split()[0])
    finally:
        sys.argv = saved


def test_bf16_full_tier_matches_the_jax_script(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    flags = ["--image-size", "8", "--n-train", "32", "--n-test", "8", "--fused", "off",
             "--bf16", "--t-jitter", "1e-2"]
    got = example.main(["--device", "cpu", *flags])["nll"]
    np.testing.assert_allclose(got, _jax_script(flags), rtol=2e-2)
    # eps (default 1e-4) is raised to 1e-2 under bf16.
    assert example.main(["--device", "cpu", *flags, "--eps", "1e-2"])["nll"] == got
    assert example.main(["--device", "cpu", *flags, "--eps", "1e-1"])["nll"] != got


def test_bf16_with_the_fused_gram_off_the_card_raises(tmp_path, monkeypatch):
    """(The name is this test's first contract, when --bf16 --fused on
    raised off the card.) --bf16 --fused on: K7's bf16 plain version here,
    the JAX package's bf16 kernel in interpret mode there (its non-TPU
    branch), at the bf16 bar of this file (rtol 2e-2; they differ by 3.6e-3
    at these sizes). The JAX script's blocks are padded to --fused-block,
    hence 8."""
    import snngp.ops.pallas.myrtle_gram as mg

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(mg, "INTERPRET", True)
    flags = ["--image-size", "8", "--n-train", "16", "--n-test", "8", "--fused", "on",
             "--fused-block", "8", "--bf16", "--t-jitter", "1e-2"]
    got = example.main(["--device", "cpu", *flags])
    assert got["bf16_effective"]
    np.testing.assert_allclose(got["nll"], _jax_script(flags), rtol=2e-2)
    # eps (default 1e-4) is raised to 1e-2 under bf16, on the fused path too.
    assert example.main(["--device", "cpu", *flags, "--eps", "1e-2"])["nll"] == got["nll"]
