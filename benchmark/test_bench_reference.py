"""The plain references against float64 computations at tiny sizes (CPU):
the port's own plain tiers and models run in float64, an independent
computation of the same mathematics, and the TF32 control's arithmetic."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from benchmark.reference.common import Arith, relu_dual, round_tf32, softplus

HERE = Path(__file__).resolve().parent
F64 = torch.float64


def _load(name):
    spec = importlib.util.spec_from_file_location(f"ref_{name.replace('-', '_')}",
                                                  HERE / "reference" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MLP = _load("mlp4-t")
MYRTLE = _load("myrtle5-t")
AR = Arith("float64")


def _config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0e-5])
    got = round_tf32(x)
    assert got[0] == 1.0 and got[1] == 1.0 + 2 ** -10
    assert got[2] == 1.0                          # a tie goes to the even mantissa
    assert got[3] == 1.0 + 2 ** -9
    rel = ((got - x).abs() / x.abs()).max()
    assert rel <= 2 ** -11


def test_the_controls_factor_and_solves_err_at_tf32_not_fp32():
    torch.manual_seed(0)
    a = torch.randn(200, 200, dtype=F64)
    spd = a @ a.T + 200 * torch.eye(200, dtype=F64)
    b = torch.randn(200, 3, dtype=F64)
    low = Arith("tf32", block=48)
    chol = low.chol(spd.float())
    exact = torch.linalg.cholesky(spd)
    err = ((chol.double() - exact).abs().max() / exact.abs().max()).item()
    assert 1e-6 < err < 1e-3
    for trans in (False, True):
        want = torch.linalg.solve_triangular(exact.mT if trans else exact, b, upper=trans)
        got = low.trsm(chol, b.float(), trans=trans).double()
        assert ((got - want).abs().max() / want.abs().max()).item() < 1e-3
    assert torch.equal(AR.chol(spd), exact)


def test_relu_dual_tangents_match_autograd_off_the_diagonal():
    torch.manual_seed(1)
    v1 = torch.rand(5, 1, dtype=F64) + 0.5
    v2 = torch.rand(1, 4, dtype=F64) + 0.5
    k = 0.3 * torch.randn(5, 4, dtype=F64)
    dk, dv1, dv2 = torch.randn_like(k), torch.randn_like(v1), torch.randn_like(v2)
    _, (dt,) = relu_dual(k, v1, v2, [dk], [dv1], [dv2])
    want = torch.func.jvp(lambda a, b, c: relu_dual(a, b, c)[0], (k, v1, v2), (dk, dv1, dv2))[1]
    torch.testing.assert_close(dt, want, rtol=1e-10, atol=1e-12)


def _mlp_layer_kernel(w, b, last, depth=4):
    from snngp_torch.nn import arch, layers
    return layers.kernel_fn_of(arch.get_mlp_layer(depth, 1, "relu", w, b, last))


def test_mlp_gram_and_tangents_match_the_layer_tier_in_float64():
    torch.manual_seed(2)
    x1, x2 = torch.randn(7, 5, dtype=F64), torch.randn(6, 5, dtype=F64)
    w, b, last = (torch.tensor(v, dtype=F64, requires_grad=True) for v in (1.3, 0.2, 0.9))
    want = _mlp_layer_kernel(w, b, last)(x1, x2, get="nngp")
    got, tangents = MLP.gram(x1, x2, w.detach(), b.detach(), last.detach(), 4, AR,
                             tangents=True)
    torch.testing.assert_close(got, want.detach(), rtol=1e-12, atol=1e-14)
    g = torch.randn_like(want)
    auto = torch.autograd.grad((g * want).sum(), (w, b, last))
    for t, a in zip(tangents, auto):
        torch.testing.assert_close((g * t).sum(), a, rtol=1e-10, atol=1e-13)
    diag = MLP.gram(x1, x1, w.detach(), b.detach(), last.detach(), 4, AR, diag=True)
    torch.testing.assert_close(diag, torch.diagonal(_mlp_layer_kernel(w, b, last)(x1, x1))
                               .detach(), rtol=1e-12, atol=1e-14)


def _mlp_config(n=48):
    cfg = _config("mlp4-t")
    cfg["data"]["num_train"] = n
    return cfg


def _mlp_data(cfg, seed=5):
    spec = importlib.util.spec_from_file_location("sys_mlp", HERE / "systems" / "mlp4-t.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_data(cfg, seed, "cpu")


def _port_spr(cfg, data, dtype=F64, eps=None):
    from snngp_torch.models import SPR, NNGPKernel, StudentTLikelihood
    m = cfg["model"]
    kernel = NNGPKernel(lambda w, b, l: _mlp_layer_kernel(w, b, l, m["num_hiddens"]),
                        m["w_std"], m["b_std"], m["last_w_std"])
    model = SPR(kernel, StudentTLikelihood(m["alpha"], m["beta"]), data["x"], data["y"],
                data["y_mean"], data["y_std"], eps=m["epsilon"] if eps is None else eps)
    return model.to(dtype=dtype)


def test_mlp_training_follows_the_ports_float64_steps():
    """Three ML-II steps: the reference against the port's plain layer tier,
    likelihood and Adam, all in float64. The port's raw parameters start
    from float32 values (``constrained_init``), so the two sides start
    ~1e-8 apart."""
    from snngp_torch.utils import Adam, train_step
    cfg = _mlp_config()
    data = _mlp_data(cfg)
    model = _port_spr(cfg, data)
    opt = Adam(model)
    p0 = {n: p.detach().clone() for n, p in zip(opt.names, opt.params)}
    losses = []
    for i in range(3):
        losses.append(float(train_step(model, opt, cfg["train"]["lr"])))
        if i == 0:
            grad1 = {n: m / 0.1 for n, m in zip(opt.names, opt.mu)}
    ref = MLP.train(cfg, data, 3)
    assert list(MLP.NAMES) == opt.names
    torch.testing.assert_close(torch.tensor([t["loss"] for t in ref["terms"]], dtype=F64),
                               torch.tensor(losses, dtype=F64), rtol=1e-7, atol=0)
    for n, p in zip(opt.names, opt.params):
        torch.testing.assert_close(ref["grad1"][n], grad1[n].detach(), rtol=1e-6, atol=1e-12)
        torch.testing.assert_close(ref["change"][n], (p - p0[n]).detach(), rtol=1e-6,
                                   atol=1e-12)


def test_mlp_predictor_matches_the_ports_float64_fit():
    from snngp_torch.models import fit_spr
    cfg = _mlp_config()
    data = _mlp_data(cfg)
    model = _port_spr(cfg, data, eps=cfg["serve"]["epsilon"])
    xt = torch.randn(9, cfg["data"]["num_features"], dtype=F64)
    with torch.no_grad():
        want = fit_spr(model, t_jitter=cfg["serve"]["t_jitter"]).predict(xt)
    got = MLP.predict(MLP.fit(cfg, data), xt)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-12)   # float32 raw start


def _full_myrtle(w, b, last):
    from snngp_torch.nn.full import get_myrtle_kernel
    return get_myrtle_kernel(5, 1, "relu", w_std=w, b_std=b, last_w_std=last)


def test_myrtle_gram_and_tangents_match_the_full_tier_in_float64():
    torch.manual_seed(3)
    x1, x2 = torch.randn(3, 8, 8, 3, dtype=F64), torch.randn(2, 8, 8, 3, dtype=F64)
    w, b, last = (torch.tensor(v, dtype=F64, requires_grad=True) for v in (1.2, 0.3, 0.8))
    for a, c, same in ((x1, x2, False), (x1, x1, True)):
        want = _full_myrtle(w, b, last)(a, c, get="nngp")
        got, tangents = MYRTLE.gram(a, c, w.detach(), b.detach(), last.detach(), AR, same=same)
        torch.testing.assert_close(got, want.detach(), rtol=1e-11, atol=1e-14)
        g = torch.randn_like(want)
        auto = torch.autograd.grad((g * want).sum(), (w, b, last))
        for t, ag in zip(tangents, auto):
            torch.testing.assert_close((g * t).sum(), ag, rtol=1e-9, atol=1e-13)


def _myrtle_config():
    cfg = _config("myrtle5-t")
    cfg["data"].update(num_train=60, image=[8, 8, 3])
    cfg["model"]["num_inducing"] = 6
    cfg["train"].update(batch=5, num_samples=7)
    return cfg


def test_myrtle_elbo_steps_follow_the_ports_float64_steps():
    """Two ELBO steps on the same batches and draws: the reference against
    the port's SVSP on the full tier, in float64."""
    from snngp_torch.models import SVSP, InverseGammaPrior, NNGPKernel
    from snngp_torch.ops.mvt import TDraws
    from snngp_torch.utils import Adam
    cfg = _myrtle_config()
    spec = importlib.util.spec_from_file_location("sys_myrtle",
                                                  HERE / "systems" / "myrtle5-t.py")
    sysmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sysmod)
    data = sysmod.make_data(cfg, 7, "cpu")
    m, t = cfg["model"], cfg["train"]
    kernel = NNGPKernel(_full_myrtle, m["w_std"], m["b_std"], m["last_w_std"])
    model = SVSP(InverseGammaPrior(m["alpha"], m["beta"]), kernel, data["z"],
                 num_latent_gps=10, eps=m["epsilon"]).to(dtype=F64)
    opt = Adam(model, mask=lambda n: "last_w_std" not in n and "inducing" not in n)
    gen = torch.Generator().manual_seed(4)
    inputs, losses, nlls = [], [], []
    p0 = {n: p.detach().clone() for n, p in zip(opt.names, opt.params)}
    for step in range(2):
        idx = torch.arange(step * t["batch"], (step + 1) * t["batch"])
        shape = (t["num_samples"], 10, t["batch"])
        draws = (torch.randn(shape, generator=gen, dtype=F64),
                 torch._standard_gamma(torch.full(shape, m["alpha"], dtype=F64),
                                       generator=gen))
        inputs.append((idx, draws))
        opt.zero_grad()
        loss, (nll, _) = model.loss(data["x"][idx].double(), data["y"][idx],
                                    cfg["data"]["num_train"], t["num_samples"],
                                    draws=TDraws(*draws), aux=True)
        loss.backward()
        model.inducing_variable.grad.zero_()     # frozen inputs: zero cotangents
        if step == 0:
            grads = {n: p.grad.detach().clone() for n, p in zip(opt.names, opt.params)}
        opt.update(t["lr"])
        losses.append(float(loss))
        nlls.append(float(nll))
    data64 = dict(data, x=data["x"].double(), z=data["z"].double())
    ref = MYRTLE.train(cfg, data64, 2, inputs)
    assert list(MYRTLE.NAMES) == opt.names
    for key, mine in (("loss", losses), ("nll", nlls)):
        torch.testing.assert_close(torch.tensor([t[key] for t in ref["terms"]], dtype=F64),
                                   torch.tensor(mine, dtype=F64), rtol=1e-7, atol=0)
    for n, p in zip(opt.names, opt.params):
        torch.testing.assert_close(ref["grad1"][n], grads[n], rtol=1e-5, atol=1e-11)
        torch.testing.assert_close(ref["change"][n], (p - p0[n]).detach(), rtol=1e-5,
                                   atol=1e-11)


def test_softplus_inverse_round_trips():
    from benchmark.reference.common import softplus_inv
    for v in (1e-8, 1e-2, 1.0, 2.0, 25.0):
        assert softplus(torch.tensor(softplus_inv(v), dtype=F64)).item() == pytest.approx(
            v, rel=1e-12)
