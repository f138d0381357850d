"""``wrn4-t`` on the program: ``cls tr -n resnet -m svtp --freeze-inducing
-ni 1000`` (the WideResNet NNGP at depth 4; 1,000 frozen inducing images;
batch 100; 100 samples; ``last_w_std`` frozen; Adam at 1e-2), one ELBO step
being ``svsp_train_step``'s body with the benchmark's draws, as
``myrtle5-t``'s system runs it (``SVSP.loss(..., draws=, aux=True)``, the
backward, the optimizer's update).

The images, labels, inducing set and every step's standard variates are
made as ``myrtle5-t``'s are (its ``make_data`` and draws), on the device,
from the seed.

The counted work of a step (``mfu``): K5's and K6's launches on K(Z, Z),
K(X, Z) and K(X, X), twice: once for the forward, and once as the least
work of the Gram's backward, which is at least one forward whatever
implements it (the port recomputes through the layer tier). As for
``myrtle5-t``, the [B, I] and [I, I] linear algebra of the posterior (the
Cholesky inverse, the eigh pseudo-inverse and their products, ~1e10
operations at 1,000 inducing images, under 0.2 ms at the peak) is not
counted.

``FAULTS`` plants a fault in the Gram's panelled backward for the step's
duration (``_panel_grads`` of ``snngp_torch.ops.resnet_conv_gram``
replaced): ``mirror``, an off-diagonal panel of K(x, x) takes g[r, c]
without g[c, r]^T; ``scales``, no panel adds its gradients of w, b and
last, which stay zero. Each is a ``patch(system)`` as
``benchmark.calibrate.FAULTS`` are.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

from benchmark import counts_resnet as CR


def _myrtle_system():
    path = Path(__file__).resolve().parent / "myrtle5-t.py"
    spec = importlib.util.spec_from_file_location("benchmark_systems_myrtle5_t", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_MYRTLE = _myrtle_system()
make_data = _MYRTLE.make_data


class System(_MYRTLE.System):
    """``myrtle5-t``'s system (its step, draws, parameters and gradients)
    on the WideResNet kernel."""

    def __init__(self, config, seed, device):
        from snngp_torch.models import SVSP, InverseGammaPrior, NNGPKernel
        from snngp_torch.nn import arch
        from snngp_torch.utils import Adam

        from benchmark.seeds import generator

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
            return arch.get_conv_resnet_kernel(m["depth"], self.num_class, m["activation"],
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

    def step_work(self):
        """One step's K5 / K6 launches on the three Gram blocks, and the
        counted least time: those launches twice (forward and backward)."""
        ni, nb = self.data["z"].shape[0], self.batch
        h, w, _ = self.config["data"]["image"]
        m = self.config["model"]
        launches = {"k5": [], "k6": []}
        for n1, n2, same in ((ni, ni, True), (nb, ni, False), (nb, nb, True)):
            for key, times in CR.gram_launches(n1, n2, h, w, m["depth"], m["activation"],
                                               same).items():
                launches[key] += times
        return {"launches": launches,
                "least_s": 2 * sum(sum(times) for times in launches.values())}

    def launches(self):
        """No launch counter the capture checks by ``benchmark.counts``' keys:
        K5's and K6's readers (``counts_resnet.roofline``) check their own
        kernels' count against the captured steps' launches."""
        return {}


def _planted(wrap):
    def plant(system):
        from snngp_torch.ops import resnet_conv_gram as RG
        step, real = system.step, RG._panel_grads

        def faulty_step(feed, prof=None):
            RG._panel_grads = wrap(real)
            try:
                return step(feed, prof)
            finally:
                RG._panel_grads = real
        system.step = faulty_step
    return plant


def _drop_mirror(real):
    def panel(x1, x2, g, r, c, same, *rest):
        if same and r != c:
            g = g.clone()
            g[c, r] = 0.0
        return real(x1, x2, g, r, c, same, *rest)
    return panel


def _zero_scales(real):
    def panel(x1, x2, g, r, c, same, need_x, scales, gx, gs, depth, act):
        return real(x1, x2, g, r, c, same, need_x, scales, gx, [None] * len(gs), depth, act)
    return panel


FAULTS = {"mirror": _planted(_drop_mirror), "scales": _planted(_zero_scales)}
