"""The WideResNet NNGP Student-t classifier against its plain reference
(``benchmark/reference/wrn4-t.py``, the one the benchmark's ``correct``
compares with), on CPU-only torch:

- the port's WideResNet Gram (``conv_resnet_gram``: K5's and K6's plain
  versions forward, the layer tier's recompute backward) and the gradients
  of w, b and last, in float64 at 1e-12 of the largest entry (the two
  compute the same sums in other orders);
- the panelled backward against one recompute of the whole pair grid, in
  float64 at relative 1e-10 (the same sums, split over panels);
- two SVTP steps (loss, data term and every leaf's gradient and change,
  with injected draws) against the reference;
- the reference with the conv shortcut dropped, a stated wrong result,
  refused by the Gram's tolerance;
- the cell's run at CPU sizes, correct as it is and not correct with the
  scales' gradients left out of the panelled backward; a dropped mirror
  cotangent caught by the check against one recompute;
- the state-size guard of K5, K6 and the front;
- K5's and K6's operations and bytes at the cell's shapes
  (``benchmark/counts_resnet.py``), as numbers.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import counts_resnet as CR  # noqa: E402
from benchmark.reference.common import Arith  # noqa: E402
from snngp_torch.ops import resnet_conv_gram as RG  # noqa: E402

F64 = torch.float64
W, B, LAST = 1.1, 0.2, 0.9
GRAM_TOL = 1e-12      # of the largest entry: float64 sums in other orders
REF_PATH = "benchmark/reference/wrn4-t.py"


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _load(REF_PATH, "wrn_reference")


def _images(seed, n, hw):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(n, hw, hw, 3, generator=gen, dtype=F64)


def _scales():
    return [torch.tensor(v, dtype=F64, requires_grad=True) for v in (W, B, LAST)]


def _port_gram(x1, x2, depth, scales, trainable_inputs=False):
    w, b, last = scales
    return RG.conv_resnet_gram(x1, x2, depth=depth, w_std=w, b_std=b, last_w_std=last,
                               trainable_inputs=trainable_inputs)


def _gaps(x1, x2, depth, same, shortcut=True):
    """The port's Gram and its scale gradients against the reference's:
    (the Gram's gap, the worst scale gradient's), each over the largest
    reference value."""
    scales = _scales()
    k = _port_gram(x1, x1 if same else x2, depth, scales)
    want, tangents = REF.gram(x1, x1 if same else x2, *(s.detach() for s in scales), depth,
                              Arith("float64"), same=same, block=7, shortcut=shortcut)
    g = torch.randn(k.shape, generator=torch.Generator().manual_seed(9), dtype=F64)
    got = torch.autograd.grad(k, scales, g)
    gram_gap = ((k - want).abs().max() / want.abs().max()).item()
    grad_gap = max(abs((a - (g * t).sum()) / (g * t).sum()).item()
                   for a, t in zip(got, tangents))
    return gram_gap, grad_gap


@pytest.mark.parametrize("same", [False, True], ids=["x1,x2", "x,x"])
@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("hw", [8, 16])
def test_the_gram_and_its_scale_gradients_match_the_plain_reference(hw, depth, same):
    gram_gap, grad_gap = _gaps(_images(1, 5, hw), _images(2, 4, hw), depth, same)
    assert gram_gap <= GRAM_TOL
    assert grad_gap <= 1e-10


@pytest.mark.parametrize("same", [False, True], ids=["x1,x2", "x,x"])
@pytest.mark.parametrize("depth", [1, 4])
def test_the_reference_without_the_conv_shortcut_is_refused(depth, same):
    gram_gap, _ = _gaps(_images(1, 5, 8), _images(2, 4, 8), depth, same, shortcut=False)
    assert gram_gap > 1e3 * GRAM_TOL


@pytest.mark.parametrize("same", [False, True], ids=["x1,x2", "x,x"])
@pytest.mark.parametrize("trainable", [False, True], ids=["frozen", "trainable"])
@pytest.mark.parametrize("panel", [1, 9, None], ids=["1x1", "3x3 ragged", "all rows"])
def test_the_panelled_backward_equals_one_recompute(panel, trainable, same, monkeypatch):
    monkeypatch.setattr(RG, "_PANEL_PAIRS", panel)
    x1 = _images(3, 5, 8).requires_grad_(True)
    x2 = x1 if same else _images(4, 4, 8).requires_grad_(True)
    scales = _scales()
    k = _port_gram(x1, x2, 1, scales, trainable_inputs=trainable)
    g = torch.randn(k.shape, generator=torch.Generator().manual_seed(5), dtype=F64)
    leaves = [x1, *scales] if same else [x1, x2, *scales]
    before = dict(RG.RECOMPUTE)
    got = torch.autograd.grad(k, leaves, g)
    # 5 x 5 on and below the diagonal: 15 pairs one by one, or 3 x 3 tiles
    # of 3 + 2 rows (9 + 6 + 4 pairs); 5 x 4: rows of 3 + 2, columns 3 + 1.
    want = {1: (15, 15) if same else (20, 20), 9: (3, 19) if same else (4, 20),
            None: (1, 25) if same else (1, 20)}[panel]
    assert (RG.RECOMPUTE["panels"] - before["panels"],
            RG.RECOMPUTE["pairs"] - before["pairs"]) == want
    with torch.enable_grad():
        one = RG._reference_recursion(x1, x2, 1, "relu", *scales)
    want = torch.autograd.grad(one, leaves, g)
    for name, a, c in zip(["x1"] + ([] if same else ["x2"]) + ["w", "b", "last"], got, want):
        if name.startswith("x") and not trainable:
            assert torch.count_nonzero(a) == 0, name
            continue
        assert ((a - c).abs().max() / c.abs().max()).item() <= 1e-10, name


def test_a_default_panel_fits_the_budget_and_tiles_the_lower_triangle():
    x = torch.zeros(3, 32, 32, 3)
    per_pair = 4 * 32 * 32 * (12 + 17 * 4)
    assert RG._panel_pairs(x, 4) == RG._CPU_BUDGET // per_pair
    panels = RG._panels(10, 10, 9, True)
    assert [(r.start, r.stop, c.start, c.stop) for r, c in panels] == [
        (0, 3, 0, 3), (3, 6, 0, 3), (3, 6, 3, 6), (6, 9, 0, 3), (6, 9, 3, 6), (6, 9, 6, 9),
        (9, 10, 0, 3), (9, 10, 3, 6), (9, 10, 6, 9), (9, 10, 9, 10)]
    assert [(r.stop - r.start, c.stop - c.start) for r, c in RG._panels(4, 10, 9, False)] == [
        (2, 4), (2, 4), (2, 2), (2, 4), (2, 4), (2, 2)]
    # The cell's K(Z, Z) at ~102,000 pairs a panel: four tiles of 250
    # (10 panels, 625,000 pairs), not 319 + 319 + 319 + 43; K(B, Z) whole.
    zz = RG._panels(1000, 1000, 102_000, True)
    assert len(zz) == 10 and {(r.stop - r.start, c.stop - c.start) for r, c in zz} == {
        (250, 250)}
    assert [(r.stop - r.start, c.stop - c.start) for r, c in RG._panels(100, 1000, 102_000,
                                                                        False)] == [
        (100, 1000)]
    assert [(r.stop - r.start, c.stop - c.start) for r, c in RG._panels(100, 1000, 91_500,
                                                                        False)] == [
        (100, 500), (100, 500)]


# -- SVTP steps ------------------------------------------------------------------------

def _config(depth=4):
    cfg = json.loads((ROOT / "benchmark" / "configs" / "wrn4-t.json").read_text())
    cfg["data"].update(num_train=60, image=[8, 8, 3])
    cfg["model"].update(num_inducing=6, depth=depth)
    cfg["train"].update(batch=5, num_samples=7)
    return cfg


def _data(cfg, seed=7):
    return _load("benchmark/systems/wrn4-t.py", "wrn_system").make_data(cfg, seed, "cpu")


def _inputs(cfg, steps, seed=4):
    gen = torch.Generator().manual_seed(seed)
    t, m = cfg["train"], cfg["model"]
    out = []
    for step in range(steps):
        shape = (t["num_samples"], cfg["data"]["num_class"], t["batch"])
        draws = (torch.randn(shape, generator=gen, dtype=F64),
                 torch._standard_gamma(torch.full(shape, m["alpha"], dtype=F64),
                                       generator=gen))
        out.append((torch.arange(step * t["batch"], (step + 1) * t["batch"]), draws))
    return out


def test_two_svtp_steps_follow_the_reference():
    """Two ELBO steps of the port's SVSP on the WideResNet kernel (frozen
    inducing images, float64) on the same batches and draws as the
    reference's. The port's raw parameters start from float32 values
    (``constrained_init``), so the two sides start ~1e-8 apart."""
    from snngp_torch.models import SVSP, InverseGammaPrior, NNGPKernel
    from snngp_torch.nn import arch
    from snngp_torch.ops.mvt import TDraws
    from snngp_torch.utils import Adam

    cfg = _config()
    m, t = cfg["model"], cfg["train"]
    data = _data(cfg)

    def kernel_fn(w, b, last):
        return arch.get_conv_resnet_kernel(m["depth"], 10, "relu", w_std=w, b_std=b,
                                           last_w_std=last, trainable_inputs=False)

    model = SVSP(InverseGammaPrior(m["alpha"], m["beta"]),
                 NNGPKernel(kernel_fn, m["w_std"], m["b_std"], m["last_w_std"]), data["z"],
                 num_latent_gps=10, eps=m["epsilon"]).to(dtype=F64)
    opt = Adam(model, mask=lambda n: "last_w_std" not in n and "inducing" not in n)
    inputs = _inputs(cfg, 2)
    p0 = {n: p.detach().clone() for n, p in zip(opt.names, opt.params)}
    losses, nlls = [], []
    for step, (idx, draws) in enumerate(inputs):
        opt.zero_grad()
        loss, (nll, _) = model.loss(data["x"][idx].double(), data["y"][idx],
                                    cfg["data"]["num_train"], t["num_samples"],
                                    draws=TDraws(*draws), aux=True)
        loss.backward()
        assert torch.count_nonzero(model.inducing_variable.grad) == 0
        if step == 0:
            grads = {n: p.grad.detach().clone() for n, p in zip(opt.names, opt.params)}
        opt.update(t["lr"])
        losses.append(loss.item())
        nlls.append(nll.item())
    ref = REF.train(cfg, dict(data, x=data["x"].double(), z=data["z"].double()), 2, inputs)
    assert list(REF.NAMES) == opt.names
    for key, mine in (("loss", losses), ("nll", nlls)):
        torch.testing.assert_close(torch.tensor([s[key] for s in ref["terms"]], dtype=F64),
                                   torch.tensor(mine, dtype=F64), rtol=1e-7, atol=0)
    for n, p in zip(opt.names, opt.params):
        torch.testing.assert_close(ref["grad1"][n], grads[n], rtol=1e-5, atol=1e-11)
        torch.testing.assert_close(ref["change"][n], (p - p0[n]).detach(), rtol=1e-5,
                                   atol=1e-11)


@pytest.mark.parametrize("fault", [None, "scales"])
def test_a_fault_in_the_panelled_backward_is_not_correct(fault, monkeypatch):
    """The cell's whole run with panels of at most 9 pairs (K(Z, Z) in 10
    panels, 6 off the diagonal): correct as it is; not correct by the
    cell's own limits with the scales' gradients left out of the backward
    (``FAULTS["scales"]`` of ``benchmark/systems/wrn4-t.py``)."""
    from benchmark import run
    from benchmark.test_bench_harness import CELLS, SPEC, small
    monkeypatch.setattr(RG, "_PANEL_PAIRS", 9)
    faults = _load("benchmark/systems/wrn4-t.py", "wrn_system").FAULTS
    cfg, mix = small("wrn4-t.elbo")      # 10 inducing images of 8 x 8, batch 8
    result = run.run_cell(SPEC, CELLS["wrn4-t.elbo"], 2 ** 31 + 613, 0.3, False, "cpu",
                          config=cfg, mix=mix, patch=faults[fault] if fault else None)
    assert result["correct"] == (fault is None), result["compared"]
    assert RG._panel_grads.__name__ == "_panel_grads"


def test_a_dropped_mirror_cotangent_fails_the_one_recompute_check(monkeypatch):
    """``FAULTS["mirror"]``'s fault (an off-diagonal panel of K(x, x)
    without g[c, r]^T) moves w's gradient by far more than the panelled
    backward's check against one recompute allows. At the cell's size
    float32 moves w's gradient by up to 3.9 of itself, and the fault by
    7.1 or more, too close for a limit of ``correct``: this check, and the
    JAX package's ``vjp`` at the same panels, are what hold the mirror."""
    system = _load("benchmark/systems/wrn4-t.py", "wrn_system")
    monkeypatch.setattr(RG, "_PANEL_PAIRS", 9)
    monkeypatch.setattr(RG, "_panel_grads", system._drop_mirror(RG._panel_grads))
    x = _images(3, 5, 8)
    scales = _scales()
    k = _port_gram(x, x, 1, scales)
    g = torch.randn(k.shape, generator=torch.Generator().manual_seed(5), dtype=F64)
    g = g + g.mT
    got = torch.autograd.grad(k, scales, g)
    with torch.enable_grad():
        want = torch.autograd.grad(RG._reference_recursion(x, x, 1, "relu", *scales), scales,
                                   g)
    assert ((got[0] - want[0]).abs() / want[0].abs()).item() > 1e-2


def test_the_plain_reference_imports_neither_package():
    code = ("import sys, importlib.util as u; "
            f"s = u.spec_from_file_location('r', {REF_PATH!r}); "
            "s.loader.exec_module(u.module_from_spec(s)); "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'jax', 'jaxlib', 'flax', 'snngp', 'snngp_torch'}))")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "[]"


# -- the state-size guard --------------------------------------------------------------

BIG = 46_341          # 46,341^2 > 2^31 - 1 pairs of one pixel


def test_the_front_refuses_a_state_past_2_31_elements():
    x = torch.zeros(BIG, 1, 1, 3)
    w2, b2 = torch.tensor(1.0), torch.tensor(0.0)
    with pytest.raises(ValueError, match="row blocks"):
        RG._front(x, x, w2, b2, True)
    RG._check_state_size((1000, 1000, 1024))          # the cell's K(Z, Z): 1.02e9
    with pytest.raises(ValueError, match="row blocks"):
        RG._check_state_size((1449, 1449, 1024))


@pytest.mark.parametrize("kernel", ["K5", "K6"])
def test_the_kernel_wrappers_refuse_a_state_past_2_31_elements(kernel):
    """Checked before any other argument (meta tensors hold no storage); a
    state under the limit passes the guard and fails on its device."""
    def call(n, hw):
        k = torch.empty(n, n, hw, device="meta")
        v = torch.empty(8, n, hw, device="meta")
        scales = torch.empty(2, device="meta")
        if kernel == "K5":
            return RG.resnet_tail_cuda(k, v, v, scales, nblocks=4, act="relu", h=hw, w=1,
                                       same=True)
        vi, vm = v[0], v[0, :, :(hw + 1) // 2]
        return RG.strided_cuda(k, (vi, vm), (vi, vm), scales, act="relu", h=hw, w=1,
                               same=True)

    before = dict(RG.LAUNCHES)
    with pytest.raises(ValueError, match="row blocks"):
        call(BIG, 1)
    with pytest.raises(ValueError, match="on meta"):
        call(1448, 1024)
    assert RG.LAUNCHES == before


# -- K5 / K6 counts --------------------------------------------------------------------

# (fp32 operations, bytes) of each launch of one Gram at 32 x 32, depth 4,
# relu: K5 at 32 x 32 (four blocks, conv shortcut), 16 x 16, 8 x 8 and
# 4 x 4 (three blocks each); K6 at 32, 16 and 8.
COUNTS = {
    (1000, 1000, True): {
        "k5": [(95_839_744_000, 6_178_816_008), (17_297_280_000, 1_542_656_008),
               (4_324_320_000, 385_664_008), (1_081_080_000, 96_416_008)],
        "k6": [(12_940_928_000, 3_079_168_008), (3_235_232_000, 769_792_008),
               (808_808_000, 192_448_008)]},
    (100, 1000, False): {
        "k5": [(19_148_800_000, 855_244_808), (3_456_000_000, 211_558_408),
               (864_000_000, 52_889_608), (216_000_000, 13_222_408)],
        "k6": [(2_585_600_000, 517_632_008), (646_400_000, 129_408_008),
               (161_600_000, 32_352_008)]},
}


@pytest.mark.parametrize("shape", sorted(COUNTS), ids=["K(B,Z)", "K(Z,Z)"])
def test_k5_k6_counts_at_the_cells_shapes(shape):
    n1, n2, same = shape
    want = COUNTS[shape]
    got_k5 = [(CR.k5_ops(n1, n2, h * h, nb, "relu", mis, same), CR.k5_bytes(n1, n2, h * h,
                                                                               nb, same))
              for h, nb, mis in ((32, 4, True), (16, 3, False), (8, 3, False), (4, 3, False))]
    got_k6 = [(CR.k6_ops(n1, n2, h, h, "relu", same), CR.k6_bytes(n1, n2, h, h, same))
              for h in (32, 16, 8)]
    assert got_k5 == want["k5"] and got_k6 == want["k6"]
    launches = CR.gram_launches(n1, n2, 32, 32, 4, "relu", same)
    for key in ("k5", "k6"):     # 3.35 TB/s and 67 TFLOP/s
        assert launches[key] == pytest.approx([max(b / 3.35e12, o / 67e12)
                                               for o, b in want[key]], rel=1e-12)
