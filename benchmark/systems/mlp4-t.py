"""``mlp4-t`` on the program: the depth-4 ReLU MLP NNGP under a Student-t
likelihood, built as ``reg tr -m tp`` builds it, trained by ``train_step``
and served by ``fit_spr`` / ``FittedSPR.predict``.

The benchmark makes the data here, on the device, from the seed; the
program receives only the tensors.
"""

from __future__ import annotations

import math

import torch

from benchmark import counts as C
from benchmark.seeds import generator

BETA1 = 0.9   # Adam's first-moment decay: the gradient is mu_1 / (1 - BETA1)


def make_data(config, seed, device):
    """N rows x ~ N(0, I_D), y = sin(2 x.u) + 0.5 cos(x_0) + 0.1 noise,
    normalized as ``reg tr`` normalizes its targets."""
    n, d = config["data"]["num_train"], config["data"]["num_features"]
    gen = generator(seed, "data", device)
    x = torch.randn(n, d, generator=gen, device=device)
    u = torch.randn(d, generator=gen, device=device) / math.sqrt(d)
    y = (torch.sin(2.0 * x @ u) + 0.5 * torch.cos(x[:, 0])
         + 0.1 * torch.randn(n, generator=gen, device=device)).double()
    y_mean, y_std = y.mean().item(), y.std().item()
    return {"x": x, "y": ((y - y_mean) / y_std).float(), "y_mean": y_mean, "y_std": y_std}


class System:
    def __init__(self, config, seed, device):
        from snngp_torch.models import SPR, NNGPKernel, StudentTLikelihood
        from snngp_torch.nn import arch
        from snngp_torch.utils import Adam

        self.config = config
        self.device = device
        self.data = make_data(config, seed, device)
        m = config["model"]
        self.depth = m["num_hiddens"]

        def get_kernel_fn(w, b, last):
            return arch.get_mlp_kernel(self.depth, act=m["activation"], w_std=w, b_std=b,
                                       last_w_std=last, trainable_inputs=False)

        def spr(eps):
            kernel = NNGPKernel(get_kernel_fn, m["w_std"], m["b_std"], m["last_w_std"])
            d = self.data
            return SPR(kernel, StudentTLikelihood(m["alpha"], m["beta"]), d["x"], d["y"],
                       d["y_mean"], d["y_std"], eps=eps).to(device)

        self.spr = spr
        self.model = spr(m["epsilon"])
        self.opt = Adam(self.model)
        self.lr = config["train"]["lr"]
        self.num_train = self.data["x"].shape[0]
        self.batch = None          # ML-II steps take the whole training set
        self.fitted = None
        self.record = 0
        self.recorded = []         # every step sees the same inputs: nothing to record

    # -- training -----------------------------------------------------------------
    def step(self, feed, prof=None):
        from snngp_torch.utils import train_step
        return {"loss": train_step(self.model, self.opt, self.lr, prof).item()}

    def params(self):
        return {n: p.detach().double().cpu().clone()
                for n, p in zip(self.opt.names, self.opt.params)}

    def optimizer_grads(self):
        """The first step's gradient as Adam holds it: mu_1 / (1 - beta1)."""
        return {n: (m / (1.0 - BETA1)).detach().double().cpu()
                for n, m in zip(self.opt.names, self.opt.mu)}

    def step_work(self):
        """One step's launches and the least time of its counted work: K1
        and K2 on K(x, x), the Cholesky factor, the solve, and A^-1 for
        the backward."""
        n, d, depth = self.num_train, self.data["x"].shape[1], self.depth
        k1 = C.k1_launch(n, n, d, depth, same=True)
        k2 = C.k2_launch(n, n, d, depth, same=True)
        linalg = C.least_s(0, C.cholesky_flops(n) + C.trsm_flops(n, 1)
                           + C.inverse_from_factor_flops(n))
        return {"launches": {"k1": [k1], "k2": [k2]}, "least_s": k1 + k2 + linalg}

    # -- serving --------------------------------------------------------------------
    def fit(self):
        """The fitted predictor at the initial kernel and likelihood, with the
        serving configuration's relative regularizer."""
        from snngp_torch.models import fit_spr
        serve = self.config["serve"]
        with torch.inference_mode():
            self.fitted = fit_spr(self.spr(serve["epsilon"]), t_jitter=serve["t_jitter"])

    def request(self, x):
        with torch.inference_mode():
            return self.fitted.predict(x)

    def request_work(self, m):
        """A request of m points: K1 on K(xt, X) and on K(xt, xt) (the
        program's test Gram); the algorithm's work counts the cross Gram,
        the m test variances, the solve against the factor (read once) and
        the two contractions."""
        n, d, depth = self.num_train, self.data["x"].shape[1], self.depth
        cross = C.k1_launch(m, n, d, depth)
        test = C.k1_launch(m, m, d, depth, same=True)
        diag = C.least_s(4 * m * d, C.k1_ops(m, 1, d, depth, "relu", "mlp", False))
        solve = C.least_s(4 * (n * (n + 1) // 2 + 2 * n * m), C.trsm_flops(n, m))
        contract = C.least_s(0, 2 * C.gemv_flops(n, m))
        return {"launches": {"k1": [cross, test]},
                "least_s": cross + diag + solve + contract}

    # -- the program's launch counters ---------------------------------------------
    def launches(self):
        from snngp_torch.ops import gram as G
        return {"k1": G.LAUNCHES["gram"], "k2": G.LAUNCHES["gram_grads"]}
