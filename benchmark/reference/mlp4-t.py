"""Plain reference of ``mlp4-t``: exact Student-t process regression on the
depth-4 ReLU MLP NNGP (Lee et al., ICLR 2022; the reference's
``experiments/regression/train.py``), in plain PyTorch and float64.

- the NNGP recursion of an L-layer ReLU MLP: k = x1 . x2 / D, then L times
  k <- T(w^2 k + b^2) with T the arccos kernel of the layer's variances,
  then K = last^2 k; tangents in w and b carried forward;
- the ML-II objective: the negative log-density of a multivariate Student-t
  with df = 2a and scale (b / a) (K + eps I), over N; its gradient through
  dL/dK and the Gram's tangents; objax's Adam on the softplus-raw leaves;
- the fitted predictor: the serving configuration's relative regularizer
  eps mean(diag K), the conditional-t degrees of freedom 2a + N and data
  scale d.

Nothing here comes from the program: the inputs are the benchmark's, the
parameters start from the configuration's values.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.common import Adam, Arith, relu_dual, softplus, softplus_inv

NAMES = ("eps", "kernel.b_std", "kernel.last_w_std", "kernel.w_std",
         "likelihood.a", "likelihood.b")
ROWS = 2048   # Gram rows a block


def initial(config):
    m = config["model"]
    values = {"eps": m["epsilon"], "kernel.b_std": m["b_std"],
              "kernel.last_w_std": m["last_w_std"], "kernel.w_std": m["w_std"],
              "likelihood.a": m["alpha"], "likelihood.b": m["beta"]}
    return {n: softplus_inv(values[n]) for n in NAMES}


def gram(x1, x2, w, b, last, depth, ar, tangents=False, diag=False):
    """K(x1, x2) (``diag``: only K(x_i, x_i)) and, with ``tangents``,
    [dK/dw, dK/db, dK/dlast]."""
    d = x1.shape[1]
    if diag:
        k = (x1 * x1).sum(1) / d
    else:
        k = ar.mm(x1, x2.T) / d
    v1 = (x1 * x1).sum(1) / d
    v2 = v1 if diag else (x2 * x2).sum(1) / d
    zero = torch.zeros_like
    dk = [zero(k), zero(k)] if tangents else None
    dv1 = [zero(v1), zero(v1)]
    dv2 = [zero(v2), zero(v2)]
    w2, b2 = w * w, b * b
    for _ in range(depth):
        if tangents:
            dk = [2 * w * k + w2 * dk[0], w2 * dk[1] + 2 * b]
        dv1 = [2 * w * v1 + w2 * dv1[0], w2 * dv1[1] + 2 * b]
        dv2 = [2 * w * v2 + w2 * dv2[0], w2 * dv2[1] + 2 * b]
        k, v1, v2 = w2 * k + b2, w2 * v1 + b2, w2 * v2 + b2
        if diag:
            k, dk = k / 2, [t / 2 for t in dk] if tangents else None
        else:
            k, dk = relu_dual(k, v1[:, None], v2[None, :],
                              dk, [t[:, None] for t in dv1], [t[None, :] for t in dv2]) \
                if tangents else relu_dual(k, v1[:, None], v2[None, :])
        v1, v2 = v1 / 2, v2 / 2          # T(v, v, v) = v / 2
        dv1, dv2 = [t / 2 for t in dv1], [t / 2 for t in dv2]
    out = last * last * k
    if not tangents:
        return out
    return out, [last * last * dk[0], last * last * dk[1], 2 * last * k]


def _blocked_gram(x, w, b, last, depth, ar, tangents):
    parts = [gram(x[i:i + ROWS], x, w, b, last, depth, ar, tangents)
             for i in range(0, x.shape[0], ROWS)]
    if not tangents:
        return torch.cat(parts)
    return torch.cat([p[0] for p in parts]), [torch.cat([p[1][j] for p in parts])
                                              for j in range(3)]


def t_marginal_nll(k, y, eps, a, b, ar):
    """-log p(y) / N for y ~ MVT(df = 2a, 0, (b / a) (K + eps I))."""
    n = y.shape[0]
    eye = torch.eye(n, dtype=k.dtype, device=k.device)
    chol = ar.chol((b / a) * (k + eps * eye))
    z = ar.trsm(chol, y[:, None])[:, 0]
    quad = torch.sum(z * z)
    df = 2 * a
    half = 0.5 * (df + n)
    logp = (-half * torch.log1p(quad / df) - 0.5 * n * torch.log(df * math.pi)
            + torch.lgamma(half) - torch.lgamma(0.5 * df)
            - torch.sum(torch.log(torch.diagonal(chol))))
    return -logp / n


def loss_and_grads(raw, x, y, depth, ar):
    """The ML-II loss at the raw leaves ``raw`` and its gradient in each."""
    val = {n: softplus(raw[n]) for n in NAMES}
    with torch.no_grad():
        k, dk = _blocked_gram(x, val["kernel.w_std"], val["kernel.b_std"],
                              val["kernel.last_w_std"], depth, ar, True)
    k = k.requires_grad_(True)
    leaves = {n: raw[n].detach().clone().requires_grad_(True)
              for n in ("eps", "likelihood.a", "likelihood.b")}
    loss = t_marginal_nll(k, y, softplus(leaves["eps"]), softplus(leaves["likelihood.a"]),
                          softplus(leaves["likelihood.b"]), ar)
    loss.backward()
    g = k.grad
    grads = {n: leaves[n].grad for n in leaves}
    for name, dk_i in zip(("kernel.w_std", "kernel.b_std", "kernel.last_w_std"), dk):
        grads[name] = torch.sum(g * dk_i) * torch.sigmoid(raw[name])
    return loss.detach(), grads


def train(config, data, steps, inputs=None, precision="float64"):
    """``steps`` ML-II steps from the configuration's initial values (each on
    the whole training set, so ``inputs`` is not read):
    {"terms": [{"loss": ...}, ...], "grad1": {leaf: g}, "change": {leaf: p_steps -
    p_0}}."""
    ar = Arith(precision)
    dev = data["x"].device
    x = data["x"].to(ar.dtype)
    y = data["y"].to(ar.dtype)
    depth = config["model"]["num_hiddens"]
    raw0 = {n: torch.tensor(v, dtype=ar.dtype, device=dev) for n, v in initial(config).items()}
    raw = dict(raw0)
    opt = Adam(NAMES, NAMES)
    terms, grad1 = [], None
    for _ in range(steps):
        loss, grads = loss_and_grads(raw, x, y, depth, ar)
        terms.append({"loss": float(loss)})
        grad1 = grad1 or {n: grads[n].detach().double().cpu() for n in NAMES}
        raw = opt.update(raw, grads, config["train"]["lr"])
    change = {n: (raw[n] - raw0[n]).double().cpu() for n in NAMES}
    return {"terms": terms, "grad1": grad1, "change": change}


def fit(config, data, precision="float64"):
    """The fitted predictor at the initial values, with the serving
    configuration's relative regularizer."""
    ar = Arith(precision)
    m = config["model"]
    x = data["x"].to(ar.dtype)
    y = data["y"].to(ar.dtype)
    n = x.shape[0]
    raw = initial(config)
    w, b, last, a, bb = (softplus(torch.tensor(raw[k], dtype=torch.float64)).item()
                         for k in ("kernel.w_std", "kernel.b_std", "kernel.last_w_std",
                                   "likelihood.a", "likelihood.b"))
    eps = config["serve"]["epsilon"]
    depth = m["num_hiddens"]
    k = _blocked_gram(x, w, b, last, depth, ar, False)
    eye = torch.eye(n, dtype=k.dtype, device=k.device)
    reg = eps * torch.diagonal(k).mean()
    chol = ar.chol(k + reg * eye)
    alpha = ar.trsm(chol, ar.trsm(chol, y[:, None]), trans=True)
    chol_t = ar.chol((bb / a) * k + config["serve"]["t_jitter"] * eye)
    z = ar.trsm(chol_t, y[:, None])
    d = 2 * a + torch.sum(z * z)
    del k, chol_t
    scale = (d / (2 * a + n)) * (bb / a) * data["y_std"] ** 2
    return dict(ar=ar, x=x, chol=chol, alpha=alpha, scale=scale, hyper=(w, b, last),
                depth=depth, y_mean=data["y_mean"], y_std=data["y_std"])


def predict(state, xt):
    """Predictive mean and variance at the test points ``xt`` [m, D]."""
    ar = state["ar"]
    xt = xt.to(ar.dtype)
    w, b, last = state["hyper"]
    k_td = gram(xt, state["x"], w, b, last, state["depth"], ar)
    k_tt = gram(xt, xt, w, b, last, state["depth"], ar, diag=True)
    mean = ar.mm(k_td, state["alpha"])[:, 0]
    v = ar.trsm(state["chol"], k_td.T)
    var = k_tt - torch.sum(v * v, dim=0)
    return mean * state["y_std"] + state["y_mean"], var * state["scale"]
