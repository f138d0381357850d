"""Paper-figure reproduction (counterpart of ``examples/paper_figures.py``;
reference ``sample.ipynb``): finite-network ensembles with an
inverse-gamma-mixed last-layer scale against the analytic NNGP / NTK
Student-t predictive.

    python -m snngp_torch.examples.paper_figures --device cuda

- :func:`draw_sinx`: the exact NNGP posterior (Gaussian) against the
  conditional Student-t posterior, df = 2 alpha + N, on y = sin x.
- :func:`draw_corr`: an ensemble of erf MLPs (width 512, last-layer scale
  sigma = sqrt(InvGamma(alpha, beta)) a member) at init (``initial``),
  after SGD on the last layer (``last``) or on every layer (``full``),
  against the Student-t of the NNGP prior, the NNGP posterior or the NTK
  posterior.
- :func:`ks_correspondence`: the Kolmogorov-Smirnov statistic between an
  ensemble's marginal at a test point and that Student-t.

The members are batched: their params are stacked ``[M, ...]`` and run
through ``torch.func.vmap`` of the layer tier's ``apply``, with each
member's sigma an argument of the batched apply (JAX closes over a traced
sigma inside ``vmap``). A step forms the gradient of the members' summed
losses, which is each member's own, and updates every member in place; on
the card one step is captured in a CUDA graph and replayed.
``last`` computes the hidden features once and forms only the last layer's
gradient: the JAX package zeroes the other gradients, which leaves the
hidden params, and so the features, as they are. ``--map-batch`` members
train together.

The dataset is the notebook's (the JAX package's draws at seed 10, kept
here as numbers; other seeds draw from numpy). The sigma draws (a numpy
generator seeded with ``seed``) and the initial params (a
``torch.Generator`` on the device, seeded with ``seed``) are the port's own.
Each can be handed in instead (``dataset=``, ``sigmas=``, ``params=``), so
that JAX's draws give JAX's numbers. The figure
(matplotlib, optional) goes to ``--outdir``, ``build/figures`` by default.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
from scipy import stats as osp

from snngp_torch.nn import layers as L
from snngp_torch.ops.linalg import add_jitter, gp_predict

WIDTH = 512
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def target_fn(x):
    return np.sin(x)


def _hidden_layers(w_std=8.0, b_std=0.05, width=WIDTH):
    return [L.Dense(width, w_std=w_std, b_std=b_std), L.Erf(),
            L.Dense(width, w_std=w_std, b_std=b_std), L.Erf(),
            L.Dense(width, w_std=w_std, b_std=b_std), L.Erf()]


def _erf_net(last_w_std, w_std=8.0, b_std=0.05, width=WIDTH):
    return L.serial(*_hidden_layers(w_std, b_std, width), L.Dense(1, w_std=last_w_std))


def _kernel_fn(w_std=8.0, b_std=0.05, last_w_std=1.0):
    return L.kernel_fn_of(_erf_net(last_w_std, w_std, b_std))


# The notebook's five training points (seed 10, noise 0.1), as the JAX
# package draws them from PRNGKey(10): the panels probe test points 20 and 21
# (x = 0.08, 0.24), which lie between them. A dataset of the port's own
# draws may put a training point on a probe, where the posterior's std is
# ~0.01 and 10,000 SGD steps leave the ensemble far from it.
NOTEBOOK_TRAIN = (
    [-2.919760227203369, -0.14615511894226074, 2.042348623275757, 1.2203971147537231,
     0.42618900537490845],
    [-0.36441221833229065, -0.3838256597518921, 0.8963342905044556, 0.9084872007369995,
     0.6234034299850464],
)


def _make_dataset(seed=10, train_num=5, test_num=40, noise_scale=0.1):
    """(x_train [n, 1], y_train [n, 1], x_test [t, 1], y_test [t, 1]) as
    float32 numpy: the notebook's training points at its seed, size and
    noise; otherwise x_train uniform on [-pi, pi) and y = sin x + noise from
    a numpy generator seeded with ``seed``."""
    start, stop = -np.pi, np.pi
    if (seed, train_num, noise_scale) == (10, 5, 0.1):
        x_train, y_train = (np.array(v, np.float32)[:, None] for v in NOTEBOOK_TRAIN)
    else:
        rng = np.random.default_rng(seed)
        x_train = rng.uniform(start, stop, size=(train_num, 1)).astype(np.float32)
        y_train = (target_fn(x_train)
                   + noise_scale * rng.standard_normal((train_num, 1))).astype(np.float32)
    x_test = np.linspace(start, stop, num=test_num, dtype=np.float32)[:, None]
    return x_train, y_train, x_test, target_fn(x_test)


def _as_tensors(arrays, device):
    """Copies on ``device``, in the arrays' own float dtype (float32 from
    :func:`_make_dataset`; float64 runs every panel in float64)."""
    return [torch.tensor(np.asarray(a), device=device) for a in arrays]


# ---------------------------------------------------------------------------
# Finite-network ensemble members, batched
# ---------------------------------------------------------------------------

def sample_sigmas(seed, alpha, beta, ensemble_size):
    """sigma = sqrt(InvGamma(alpha, beta)) a member (notebook sample_network),
    from a host numpy generator."""
    return np.sqrt(beta / np.random.default_rng(seed).gamma(alpha, size=ensemble_size))


def init_members(generator, ensemble_size, width=WIDTH):
    """Initial params of ``ensemble_size`` members, each drawn by the layer
    tier's ``init``, stacked ``[M, ...]`` leaf by leaf."""
    net = _erf_net(1.0, width=width)
    members = [net.init(generator, (-1, 1))[1] for _ in range(ensemble_size)]
    return tuple(tuple(torch.stack(leaves) for leaves in zip(*layer))
                 for layer in zip(*members))


def _hidden_apply(hidden, x):
    """One member's last hidden layer on x."""
    return L.serial(*_hidden_layers(width=hidden[0][0].shape[-1])).apply(hidden, x)


def _readout_apply(last, sigma, h):
    """One member's readout; ``sigma`` is its last-layer scale."""
    return L.Dense(1, w_std=sigma).apply(last, h)


def _member_apply(params, sigma, x):
    return _readout_apply(params[-1], sigma, _hidden_apply(tuple(params[:-1]), x))


# Every member at once: params and sigmas stacked [M, ...], x shared.
_batched_apply = torch.func.vmap(_member_apply, in_dims=(0, 0, None))
_batched_hidden = torch.func.vmap(_hidden_apply, in_dims=(0, None))
_batched_readout = torch.func.vmap(_readout_apply)


def sgd_train(params, sigma, x_train, y_train, steps, lr, last_only):
    """``steps`` of plain SGD on each member's 0.5 mean((f - y)^2); returns
    the trained params (copies: the inputs stay as they are)."""
    params = tuple(tuple(p.detach().clone() for p in layer) for layer in params)
    if last_only:
        with torch.no_grad():
            h = _batched_hidden(tuple(params[:-1]), x_train)
        leaves = list(params[-1])
        loss_fn = lambda: _batched_readout(params[-1], sigma, h)  # noqa: E731
    else:
        leaves = [p for layer in params for p in layer]
        loss_fn = lambda: _batched_apply(params, sigma, x_train)  # noqa: E731

    def step():
        f = loss_fn()
        loss = (0.5 * ((f - y_train) ** 2).mean(dim=(1, 2))).sum()
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():    # p - lr g in one pass over p and g
            torch._foreach_add_(leaves, grads, alpha=-lr)

    for p in leaves:
        p.requires_grad_(True)
    _repeat(step, steps, x_train.device)
    for p in leaves:
        p.requires_grad_(False)
    return params


GRAPH_WARMUP = 3


def _repeat(step, n, device):
    """``step()`` n times. On the card, GRAPH_WARMUP eager steps on a side
    stream, then one CUDA graph of a step replayed for the rest: the host's
    dispatch of a step (vmap, autograd) costs more than the card's work."""
    if device.type != "cuda" or n <= GRAPH_WARMUP:
        for _ in range(n):
            step()
        return
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(GRAPH_WARMUP):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):     # recorded, not run
        step()
    for _ in range(n - GRAPH_WARMUP):
        graph.replay()


# ---------------------------------------------------------------------------
# Figures
# ---------------------------------------------------------------------------

def draw_sinx(train_num=5, test_num=40, alpha=1.0, beta=1.0, seed=10, noise_scale=0.1,
              device="cuda", dataset=None):
    """GP against conditional Student-t posterior on y = sin x (notebook
    cell 3)."""
    x_train, y_train, x_test, y_test = dataset or _make_dataset(seed, train_num, test_num,
                                                                noise_scale)
    xt, yt, xs = _as_tensors((x_train, y_train, x_test), device)
    kfn = _kernel_fn(w_std=1.0, b_std=0.05)
    mean, cov = gp_predict(kfn, xt, yt, xs, diag_reg=1e-4)
    mean = mean.cpu().numpy().reshape(-1)
    cov = cov.cpu().numpy()
    std = np.sqrt(np.diag(cov))

    k_tr = kfn(xt, xt, get="nngp").cpu().numpy()
    nu = 2 * alpha + train_num
    y = np.asarray(y_train)
    d = nu + (y.T @ np.linalg.solve(k_tr + 1e-4 * np.eye(train_num), y)).item()
    p = nu + train_num
    t_std = np.sqrt(np.diag(beta / alpha * d / p * cov))

    return dict(x_train=np.asarray(x_train), y_train=y,
                x_test=np.asarray(x_test).reshape(-1), y_test=np.asarray(y_test).reshape(-1),
                gp_mean=mean, gp_std=std, t_mean=mean, t_std=t_std, nu=nu)


def _analytic(part, xt, yt, xs, alpha, beta):
    """(mu, cov) of the Student-t the ensemble should follow."""
    train_num, test_num = xt.shape[0], xs.shape[0]
    if part == "initial":
        kfn = _kernel_fn(last_w_std=1.0)
        return (torch.zeros(test_num, dtype=xs.dtype, device=xs.device),
                beta / alpha * kfn(xs, xs, get="nngp"))
    kfn = _kernel_fn()
    if part == "last":
        mean, cov1 = gp_predict(kfn, xt, yt, xs, diag_reg=1e-4)
        return mean.flatten(), beta / alpha * cov1
    if part == "full":
        # The NTK posterior: a gradient-descent-trained ensemble converges to
        # the NTK predictive (the notebook's get="ntk").
        theta_dd = kfn(xt, xt, get="ntk")
        theta_td = kfn(xs, xt, get="ntk")
        k_tt = kfn(xs, xs, get="nngp")
        k_td = kfn(xs, xt, get="nngp")
        k_dd = kfn(xt, xt, get="nngp")
        a = torch.linalg.solve(add_jitter(theta_dd, 1e-4 * torch.trace(theta_dd) / train_num),
                               torch.eye(train_num, dtype=xt.dtype, device=xt.device))
        m = theta_td @ a
        cov1 = k_tt - m @ k_td.T - k_td @ m.T + m @ k_dd @ m.T
        return (m @ yt).flatten(), beta / alpha * cov1
    raise ValueError(part)


def draw_corr(part, train_num=5, test_num=40, alpha=1.0, beta=1.0, seed=10,
              noise_scale=0.1, learning_rate=1e-3, ensemble_size=500, train_steps=10000,
              map_batch=50, width=WIDTH, device="cuda", dataset=None, sigmas=None,
              params=None):
    """The ensemble's samples at every test point against the analytic
    Student-t (notebook cells 1-2): ``part`` is initial, last or full.
    ``sigmas`` ([M]) and ``params`` (stacked ``[M, ...]``, nested tuples of
    arrays or tensors) replace the seeded draws."""
    x_train, y_train, x_test, _ = dataset or _make_dataset(seed, train_num, test_num,
                                                           noise_scale)
    xt, yt, xs = _as_tensors((x_train, y_train, x_test), device)
    mu, cov = _analytic(part, xt, yt, xs, alpha, beta)
    std = torch.sqrt(torch.diag(cov))

    if sigmas is None:
        sigmas = sample_sigmas(seed, alpha, beta, ensemble_size)
    sigma = torch.as_tensor(np.asarray(sigmas), dtype=xt.dtype, device=device)
    if params is None:
        generator = torch.Generator(device=device).manual_seed(seed)
        params = init_members(generator, ensemble_size, width)
    params = tuple(tuple(torch.as_tensor(p, device=device) for p in layer) for layer in params)

    chunks = []
    for i in range(0, ensemble_size, map_batch):
        chunk = tuple(tuple(p[i:i + map_batch] for p in layer) for layer in params)
        s = sigma[i:i + map_batch]
        if part != "initial":
            chunk = sgd_train(chunk, s, xt, yt, train_steps, learning_rate,
                              last_only=(part == "last"))
        with torch.no_grad():
            chunks.append(_batched_apply(chunk, s, xs).cpu().numpy())
    samples = np.squeeze(np.concatenate(chunks), axis=2).T   # [test_num, M]
    return dict(samples=samples, nu=2 * alpha, mu=mu.cpu().numpy(), std=std.cpu().numpy())


def ks_correspondence(result, idx):
    """KS statistic between the ensemble's marginal and the analytic
    Student-t at test point ``idx``."""
    s = result["samples"][idx]
    return osp.kstest(s, "t", args=(result["nu"], result["mu"][idx],
                                    result["std"][idx])).statistic


PANELS = [("initial", 2.0, 2.0), ("last", 2.0, 2.0), ("full", 1.0, 1.0)]


def main(argv=None):
    """Every panel at the notebook's sizes by default; prints each panel's
    seconds and KS statistic and returns them (``panels``: part -> dict of
    ``ks``, ``idx``, ``seconds``), with the sin x panel (``sinx``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--outdir", default=os.path.join("build", "figures"))
    ap.add_argument("--ensemble-size", type=int, default=500)
    ap.add_argument("--train-steps", type=int, default=10000)
    ap.add_argument("--map-batch", type=int, default=50,
                    help="members trained together in one batch")
    ap.add_argument("--width", type=int, default=WIDTH,
                    help="finite-network width (512 = notebook; wider shrinks the "
                         "finite-width gap the KS test detects)")
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: CUDA is not available")
    if os.path.abspath(a.outdir) == os.path.join(REPO, "figures"):
        raise SystemExit("--outdir figures/ holds the JAX package's figures; pick another")
    device = torch.device(a.device)
    os.makedirs(a.outdir, exist_ok=True)

    sinx = draw_sinx(alpha=2.0, beta=2.0, device=device)
    print(f"sinx: GP std[20]={sinx['gp_std'][20]:.4f}  "
          f"t std[20]={sinx['t_std'][20]:.4f}  (nu={sinx['nu']})")

    panels = {}
    for part, alpha, beta in PANELS:
        t0 = time.perf_counter()
        r = draw_corr(part, alpha=alpha, beta=beta, ensemble_size=a.ensemble_size,
                      train_steps=a.train_steps, map_batch=a.map_batch, width=a.width,
                      device=device)
        seconds = time.perf_counter() - t0
        idx = 21 if part != "last" else 20
        ks = ks_correspondence(r, idx)
        print(f"{part:8s}: KS(ensemble, analytic t) at test idx {idx}: {ks:.4f}  "
              f"({seconds:.2f} s)")
        panels[part] = dict(result=r, idx=idx, ks=ks, seconds=seconds)

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipped figure rendering")
    else:
        _render(plt, sinx, panels, a.outdir)
    return dict(sinx=sinx, panels=panels)


def _render(plt, sinx, panels, outdir):
    fig, axes = plt.subplots(1, 5, figsize=(17.5, 3.5))
    for ax, kind, label in ((axes[0], "gp", "Gaussian"), (axes[1], "t", "Student's t")):
        mean, std = sinx[f"{kind}_mean"], sinx[f"{kind}_std"]
        ax.scatter(sinx["x_train"], sinx["y_train"], color="r")
        ax.plot(sinx["x_test"], sinx["y_test"], "k--", label="sin x")
        ax.plot(sinx["x_test"], mean, "g", label=label)
        ax.fill_between(sinx["x_test"], mean - 2 * std, mean + 2 * std, color="g", alpha=0.1)
        ax.legend(loc="upper left")
    for axi, (part, panel) in zip(axes[2:], panels.items()):
        r, idx = panel["result"], panel["idx"]
        u = np.linspace(-10, 10, 200)
        axi.hist(r["samples"][idx], bins=40, density=True, alpha=0.6, label="Sampled")
        axi.plot(u, osp.t.pdf(u, r["nu"], loc=r["mu"][idx], scale=r["std"][idx]),
                 linewidth=3, label="Predicted")
        axi.set_title(part)
        axi.legend(loc="upper right")
    fig.tight_layout()
    path = os.path.join(outdir, "corr.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
