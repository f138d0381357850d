"""``myrtle5-t`` on the program: ``cls tr -n myrtle -m svtp`` at the
classification defaults (200 inducing images, frozen; batch 100; 100
samples; ``last_w_std`` frozen; Adam at 1e-2), one ELBO step being
``svsp_train_step``'s body with the benchmark's draws (``SVSP.loss(...,
draws=, aux=True)``, which also hands back the ELBO's data term, the
backward, the optimizer's update).

The benchmark makes the images, labels, inducing set and every step's
standard variates here, on the device, from the seed.
"""

from __future__ import annotations

import contextlib

import torch

from benchmark import counts as C
from benchmark.seeds import generator

BETA1 = 0.9


def make_data(config, seed, device):
    """synthetic32 on the card: ten class blobs, N(0, 16^2) pixel noise,
    clipped to [0, 255] and truncated as uint8 images are, standardized as
    the synthetic sets are ((x / 255 - 0.5) / 0.5); the inducing set takes
    the first images of each class in proportion to the class's share
    (largest remainders, so that it has exactly ``num_inducing``)."""
    n, (h, w, c), nc = (config["data"]["num_train"], config["data"]["image"],
                        config["data"]["num_class"])
    gen = generator(seed, "data", device)
    labels = torch.randint(nc, (n,), generator=gen, device=device)
    s = h / 8.0
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    cls = torch.arange(nc, device=device)
    cy, cx = (cls // 4).float(), (cls % 4).float()
    blobs = torch.exp(-((yy[None] - s * (1.5 + 2 * cy)[:, None, None]) ** 2
                        + (xx[None] - s * (1.5 + 2 * cx)[:, None, None]) ** 2) / (4.0 * s * s))
    img = blobs[labels][..., None] * 255.0 + 16.0 * torch.randn(n, h, w, c, generator=gen,
                                                                 device=device)
    x = (torch.floor(torch.clamp(img, 0.0, 255.0)) / 255.0 - 0.5) / 0.5
    ni = config["model"]["num_inducing"]
    counts = torch.bincount(labels, minlength=nc).double().cpu()
    share = ni * counts / n
    per = torch.floor(share).long()
    extra = ni - int(per.sum())
    per[torch.argsort(share - per, descending=True)[:extra]] += 1
    z = torch.cat([x[labels == ci][:int(k)] for ci, k in enumerate(per.tolist())])
    return {"x": x, "y": labels, "z": z.contiguous()}


class System:
    def __init__(self, config, seed, device):
        from snngp_torch.models import SVSP, InverseGammaPrior, NNGPKernel
        from snngp_torch.nn import arch
        from snngp_torch.utils import Adam

        self.config = config
        self.device = device
        m, t = config["model"], config["train"]
        self.data = make_data(config, seed, device)
        self.num_train = self.data["x"].shape[0]
        self.batch = t["batch"]
        self.num_samples = t["num_samples"]
        self.num_class = config["data"]["num_class"]
        self.alpha = m["alpha"]
        self.lr = t["lr"]

        def get_kernel_fn(w, b, last):
            return arch.get_myrtle_kernel(m["depth"], self.num_class, m["activation"],
                                          w_std=w, b_std=b, last_w_std=last,
                                          trainable_inputs=not m["freeze_inducing"])

        kernel = NNGPKernel(get_kernel_fn, m["w_std"], m["b_std"], m["last_w_std"])
        self.model = SVSP(InverseGammaPrior(m["alpha"], m["beta"]), kernel, self.data["z"],
                          num_latent_gps=self.num_class, eps=m["epsilon"]).to(device)

        def keep(name):
            if m["freeze_last_w_std"] and "last_w_std" in name:
                return False
            return not (m["freeze_inducing"] and "inducing_variable" in name)

        self.opts = [Adam(self.model, mask=keep)]
        self.draws = generator(seed, "draws", device)
        self.recorded = []          # (batch indices, draws) of the checked steps
        self.record = 0

    # -- training -----------------------------------------------------------------
    def _draws(self):
        shape = (self.num_samples, self.num_class, self.batch)
        normal = torch.randn(shape, generator=self.draws, device=self.device)
        alpha = torch.full(shape, self.alpha, device=self.device)
        return normal, torch._standard_gamma(alpha, generator=self.draws)

    def step(self, feed, prof=None):
        from snngp_torch.ops.mvt import TDraws

        phase = prof.phase if prof is not None else (lambda name: contextlib.nullcontext())
        idx = torch.as_tensor(feed, device=self.device)
        xb, yb = self.data["x"][idx], self.data["y"][idx]
        normal, gamma = self._draws()
        if len(self.recorded) < self.record:
            self.recorded.append((idx.clone(), (normal.clone(), gamma.clone())))
        for opt in self.opts:
            opt.zero_grad()
        loss, (nll, _) = self.model.loss(xb, yb, self.num_train, self.num_samples,
                                         draws=TDraws(normal, gamma), aux=True, phase=phase)
        with phase("backward"):
            loss.backward()
        with phase("optimizer"):
            for opt in self.opts:
                opt.update(self.lr)
        return {"loss": loss.item(), "nll": nll.item()}

    def params(self):
        opt = self.opts[0]
        return {n: p.detach().double().cpu().clone() for n, p in zip(opt.names, opt.params)}

    def optimizer_grads(self):
        opt = self.opts[0]
        return {n: (m / (1.0 - BETA1)).detach().double().cpu()
                for n, m in zip(opt.names, opt.mu)}

    def step_work(self):
        """One step's launches: K7 on K(Z, Z), K(X, Z) and K(X, X), then its
        tangent mode (dK/dw, dK/db) on the same three blocks; the counted
        work is theirs (the [B, I] and [I, I] linear algebra beside them is
        under 0.1% and not counted)."""
        ni, nb = self.data["z"].shape[0], self.batch
        h, _, c = self.config["data"]["image"]
        depth = self.config["model"]["depth"]
        blocks = ((ni, ni, True), (nb, ni, False), (nb, nb, True))
        fwd = [C.k7_launch(n1, n2, h, c, depth, same=same) for n1, n2, same in blocks]
        wb = [C.k7_launch(n1, n2, h, c, depth, same=same, tangents=2)
              for n1, n2, same in blocks]
        return {"launches": {"k7_fwd": fwd, "k7_wb": wb}, "least_s": sum(fwd) + sum(wb)}

    def launches(self):
        from snngp_torch.ops import myrtle_gram as MG
        return {"k7_fwd": MG.LAUNCHES["myrtle"], "k7_wb": MG.LAUNCHES["myrtle_grads"]}
