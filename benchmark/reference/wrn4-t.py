"""Plain reference of ``wrn4-t``: the sparse variational Student-t process
(SVTP) classifier of Lee et al. (ICLR 2022) on the WideResNet NNGP of
Zagoruyko & Komodakis (BMVC 2016), in plain PyTorch and float64, computing
in the precision of an ``benchmark.reference.common.Arith``. It imports
nothing of either package; the tests hold the port to it on the CPU.

The network: a 3 x 3 conv, then four groups of ``depth`` pre-activation
blocks with strides 1, 2, 2, 2, then Flatten and Dense. A block is
FanOut(2) -> [relu, conv 3 x 3 (stride s), relu, conv 3 x 3] in parallel
with [identity, or a 3 x 3 stride-s conv shortcut on each group's first
block] -> FanInSum. Its NNGP carries one [H, W] state for each pair of
images (the covariance of matched pixels, which a Flatten readout needs):

- input:    S[p] = x1[p] . x2[p] / C
- conv:     S'[p] = w^2 / 9 sum_d S[p + d] + b^2 over the 3 x 3 offsets d,
            zero outside the image; a stride-2 conv reads that stencil at
            the lattice points (2i + o, 2j + o), o = 1 for an even extent and
            0 for an odd one (SAME padding)
- relu:     S'[p] = T(S[p], v1[p], v2[p]), T the arccos kernel and v each
            image's own variance at the pixel
- sum:      the two branches' states added
- readout:  K = last^2 mean_p S

The tangents dS/dw and dS/db are carried forward with the analytic
partials of T, so the Gram is computed in blocks of pairs without an
autograd graph; dK/dlast = 2 K / last. The control (``Control``) rounds
the operands of the input moment and each conv's input to TF32, as a TF32
product or convolution would, and the ELBO's products as ``myrtle5-t``'s
reference does, but factors in float32: TF32 is a mode of cuBLAS's
products and cuDNN's convolutions (``allow_tf32``), not of cuSOLVER's
Cholesky, and at K(Z, Z)'s condition (~1.7e5) a factor whose trailing
updates are TF32 products fails outright, which leaves the control NaN in
every number.

Where it departs from the layer tier (``get_conv_resnet_layer``):

- an image's variance map is the state of its self pair (x, x) through the
  same recursion, where the layer tier carries it by the closed form
  (relu halves it); the two agree to round-off;
- the Gram's derivatives come from forward-mode tangents, not from
  autograd's reverse mode through the layers;
- K(x, x) computes the pairs j <= i and mirrors them;
- ``shortcut=False`` drops the groups' conv shortcut (each group's first
  block is then its main branch alone): a stated wrong result, for tests
  that must tell it apart.

The ELBO, its gradients, the initial values and Adam are ``myrtle5-t``'s
reference's (``neg_elbo``, ``initial``, ``NAMES``), on this Gram.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import torch
import torch.nn.functional as F

from benchmark.reference.common import Adam, Arith, relu_dual, softplus

PAIRS = 16384           # image pairs a block


def _myrtle_reference():
    path = Path(__file__).resolve().parent / "myrtle5-t.py"
    spec = importlib.util.spec_from_file_location("benchmark_reference_myrtle5_t", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_ELBO = _myrtle_reference()
NAMES = _ELBO.NAMES


def _box(s, stride):
    """The 3 x 3 mean of [P, H, W] states, zero outside; at stride 2 read
    at the lattice points."""
    h, w = s.shape[-2:]
    p = F.pad(s, (1, 1, 1, 1))
    out = sum(p[:, i:i + h, j:j + w] for i in range(3) for j in range(3)) / 9.0
    if stride == 2:
        out = out[:, (h + 1) % 2::2, (w + 1) % 2::2]
    return out


def _conv(s, ds, w, b, stride, ar):
    box, dw, db = (_box(ar.op(t), stride) for t in (s, *ds))
    return w * w * box + b * b, [2 * w * box + w * w * dw, w * w * db + 2 * b]


def recursion(xa, xb, w, b, depth, ar, profiles=None, shortcut=True):
    """The states of the pairs (xa[i], xb[i]) ([P, H, W, C] each): (K / last^2
    [P], its tangents [d/dw, d/db], the profiles). Without ``profiles`` the
    pairs are self pairs (xa is xb) and the variance entering each relu is
    their own state, returned as the profiles (per relu: the variance
    [P, H', W'] and its two tangents); with ``profiles`` = (pa, pb) the
    variances come from those."""
    s = (ar.op(xa) * ar.op(xb)).sum(-1) / xa.shape[-1]
    s, ds = _conv(s, [torch.zeros_like(s), torch.zeros_like(s)], w, b, 1, ar)
    own = []

    def relu(s, ds):
        if profiles is None:
            own.append((s, ds))
            (va, dva), (vb, dvb) = own[-1], own[-1]
        else:
            (va, dva), (vb, dvb) = profiles[0][len(own)], profiles[1][len(own)]
            own.append(None)
        return relu_dual(s, va, vb, ds, dva, dvb)

    def block(s, ds, stride, mismatch):
        t1, dt1 = relu(s, ds)
        c1, dc1 = _conv(t1, dt1, w, b, stride, ar)
        t2, dt2 = relu(c1, dc1)
        main, dmain = _conv(t2, dt2, w, b, 1, ar)
        if mismatch and not shortcut:
            return main, dmain
        sc, dsc = _conv(s, ds, w, b, stride, ar) if mismatch else (s, ds)
        return main + sc, [a + c for a, c in zip(dmain, dsc)]

    for group in range(4):
        for i in range(depth):
            s, ds = block(s, ds, 2 if group and not i else 1, i == 0)
    return s.mean(dim=(1, 2)), [t.mean(dim=(1, 2)) for t in ds], own


def _profiles(x, w, b, depth, ar, block, shortcut):
    per = [recursion(x[i:i + block], x[i:i + block], w, b, depth, ar, shortcut=shortcut)[2]
           for i in range(0, x.shape[0], block)]
    return [(torch.cat([p[l][0] for p in per]),
             [torch.cat([p[l][1][j] for p in per]) for j in range(2)])
            for l in range(len(per[0]))]


def gram(x1, x2, w, b, last, depth, ar, same=False, block=PAIRS, shortcut=True):
    """(K, [dK/dw, dK/db, dK/dlast]) of [n1, H, W, C] against [n2, H, W, C]
    images; ``same`` computes each pair of K(x, x) once and mirrors it."""
    p1 = _profiles(x1, w, b, depth, ar, block, shortcut)
    p2 = p1 if same else _profiles(x2, w, b, depth, ar, block, shortcut)
    n1, n2 = x1.shape[0], x2.shape[0]
    ii, jj = torch.meshgrid(torch.arange(n1), torch.arange(n2), indexing="ij")
    keep = (jj <= ii) if same else torch.ones_like(ii, dtype=torch.bool)
    ii, jj = ii[keep].to(x1.device), jj[keep].to(x1.device)
    k = torch.zeros(n1, n2, dtype=x1.dtype, device=x1.device)
    dk = [torch.zeros_like(k), torch.zeros_like(k)]

    def take(prof, idx):
        return [(v[idx], [t[idx] for t in dv]) for v, dv in prof]

    for i in range(0, ii.numel(), block):
        a, c = ii[i:i + block], jj[i:i + block]
        val, dval, _ = recursion(x1[a], x2[c], w, b, depth, ar, (take(p1, a), take(p2, c)),
                                 shortcut)
        for t, v in zip([k, *dk], [val, *dval]):
            t[a, c] = v
            if same:
                t[c, a] = v
    return last * last * k, [last * last * dk[0], last * last * dk[1], 2 * last * k]


def loss_and_grads(raw, xb, yb, draws, config, ar, block=PAIRS):
    """One batch's (loss, -ll) and every leaf's gradient; the inducing
    inputs are frozen (zero gradient)."""
    m = config["model"]
    z, xb = raw["inducing_variable"].to(ar.dtype), xb.to(ar.dtype)
    w, b, last = (softplus(raw[n]).to(ar.dtype)
                  for n in ("kernel.w_std", "kernel.b_std", "kernel.last_w_std"))
    with torch.no_grad():
        kzz, dzz = gram(z, z, w, b, last, m["depth"], ar, same=True, block=block)
        kxz, dxz = gram(xb, z, w, b, last, m["depth"], ar, block=block)
        kxx, dxx = gram(xb, xb, w, b, last, m["depth"], ar, same=True, block=block)
    grams = [t.requires_grad_(True) for t in (kzz, kxz, kxx)]
    names = ("eps", "prior.a", "prior.b", "q_mu", "q_sqrt")
    leaves = {n: raw[n].detach().to(ar.dtype).clone().requires_grad_(True) for n in names}
    try:
        loss, nll = _ELBO.neg_elbo(*grams, yb, [d.to(ar.dtype) for d in draws], leaves,
                                   config["data"]["num_train"], m["alpha"], m["beta"], ar)
        loss.backward()
    except torch.linalg.LinAlgError:
        # An eigensolver that does not converge (on a covariance a failed
        # factor left NaN) reads as NaN, as a failed factor does.
        nan = torch.tensor(float("nan"), dtype=torch.float64)
        return (nan, nan), {n: torch.full_like(raw[n], float("nan"), dtype=torch.float64)
                            for n in NAMES}
    grads = {n: leaves[n].grad for n in names}
    grads["inducing_variable"] = torch.zeros_like(raw["inducing_variable"])
    for j, name in enumerate(("kernel.w_std", "kernel.b_std", "kernel.last_w_std")):
        total = sum(torch.sum(g.grad * d[j]) for g, d in zip(grams, (dzz, dxz, dxx)))
        grads[name] = total * torch.sigmoid(raw[name].to(ar.dtype))
    return (loss.detach(), nll.detach()), {n: grads[n].to(torch.float64) for n in NAMES}


class Control(Arith):
    """``Arith("tf32")`` with the Cholesky factor in float32."""

    def __init__(self):
        super().__init__("tf32")

    def chol(self, a):
        chol, info = torch.linalg.cholesky_ex((a + a.mT) * 0.5)
        return chol + torch.where(info > 0, math.nan, 0.0)[..., None, None]


def train(config, data, steps, inputs, precision="float64", block=PAIRS):
    """``steps`` ELBO steps on the recorded batches and draws ``inputs`` (a
    list of (batch indices, (normals, gammas))) from the configuration's
    initial values: {"terms" (each step's loss and -ll), "grad1",
    "change"}."""
    ar = Control() if precision == "tf32" else Arith(precision)
    m = config["model"]
    raw0 = _ELBO.initial(config, data["z"])
    raw = dict(raw0)
    keep = [n for n in NAMES if n != "inducing_variable"
            and not (m["freeze_last_w_std"] and n == "kernel.last_w_std")]
    opt = Adam(NAMES, keep)
    terms, grad1 = [], None
    for idx, draws in inputs[:steps]:
        (loss, nll), grads = loss_and_grads(raw, data["x"][idx], data["y"][idx], draws,
                                            config, ar, block)
        terms.append({"loss": float(loss), "nll": float(nll)})
        grad1 = grad1 or {n: grads[n].detach().cpu() for n in NAMES}
        raw = opt.update(raw, grads, config["train"]["lr"])
    change = {n: (raw[n] - raw0[n]).double().cpu() for n in NAMES}
    return {"terms": terms, "grad1": grad1, "change": change}
