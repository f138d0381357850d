"""Plain reference of ``myrtle5-t``: the sparse variational Student-t
process (SVTP) classifier of Lee et al. (ICLR 2022) on the Myrtle-5 NNGP
of Shankar et al. (ICML 2020), in plain PyTorch and float64.

The Myrtle-5 NNGP of [N, h, h, C] images carries, for each pair of images,
the covariance of every pixel of one with every pixel of the other, an
[h, h, h, h] state:

- input:    S[p, q] = x1[p] . x2[q] / C
- conv:     S'[p, q] = w^2 / 9 sum_d S[p + d, q + d] + b^2 over the 3 x 3
            offsets d, zero outside the image (taps couple equal offsets)
- relu:     S'[p, q] = T(S[p, q], v1[p], v2[q]), T the arccos kernel and v
            each image's own variance at the pixel (its self state's
            diagonal, carried by the same recursion on the pair (x, x))
- pool:     2 x 2 means over p and over q
- readout:  K = last^2 mean_{p, q} S (global average pool, dense)

Myrtle-5 is conv, relu, pool, conv, relu, pool, conv, relu, pool, readout.
The tangents dS/dw and dS/db are carried forward with the analytic
partials of T; dK/dlast = 2 K / last.

The ELBO (the reference's ``spax/models.py``): the inducing-side inverse
(K_ii + eps I)^-1, the relative-regularized (K_ii + r I)^+ by eigh, the
marginal covariance of the batch, correlated Student-t draws
mean + chol((b / a) cov) t with t = n sqrt(a / g) from the benchmark's
standard normals n and Gamma(alpha) variates g (g differentiated in a by
implicit reparameterization), the mean log-softmax likelihood and the
Gaussian and inverse-gamma KL terms. Its gradients come from autograd on
the Gram blocks and the other leaves, and the kernel's through dL/dK and
the Gram's tangents.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.common import F32_EPS, Adam, Arith, relu_dual, softplus, softplus_inv

GROUPS = (1, 1, 1)      # Myrtle-5: one conv at each of the three resolutions
PAIRS = 64              # image pairs a block


def _box(s):
    """sum over the 3 x 3 offsets d of s[..., p + d, q + d] / 9 on
    [P, h, h, h, h] states (zero outside), as two separable passes."""
    h = s.shape[1]
    p = F.pad(s, (0, 0, 1, 1, 0, 0, 1, 1))
    a = p[:, 0:h, :, 0:h] + p[:, 1:h + 1, :, 1:h + 1] + p[:, 2:h + 2, :, 2:h + 2]
    p = F.pad(a, (1, 1, 0, 0, 1, 1))
    return (p[:, :, 0:h, :, 0:h] + p[:, :, 1:h + 1, :, 1:h + 1]
            + p[:, :, 2:h + 2, :, 2:h + 2]) / 9.0


def _pool(s):
    n, h = s.shape[0], s.shape[1]
    r = h // 2
    return s.reshape(n, r, 2, r, 2, r, 2, r, 2).mean(dim=(2, 4, 6, 8))


def _diag(s):
    return torch.einsum("pijij->pij", s)


def recursion(xa, xb, w, b, ar, profiles=None):
    """The pair states of the pairs (xa[i], xb[i]) ([P, h, h, C] each)
    through Myrtle-5: (GAP [P], its tangents [dw, db]). Without
    ``profiles`` the pairs are self pairs (xa is xb) and their variances are
    their own diagonals, which are returned as the profiles (per conv: the
    variance [P, r, r] and its tangents); with ``profiles`` = (pa, pb) the
    variances come from those."""
    c = xa.shape[-1]
    s = torch.einsum("pabc,pdec->pabde", ar.op(xa), ar.op(xb)) / c
    ds = [torch.zeros_like(s), torch.zeros_like(s)]
    w2, b2 = w * w, b * b
    own = []
    layer = 0
    for reps in GROUPS:
        for _ in range(reps):
            box = _box(ar.op(s))
            dbox = [_box(ar.op(t)) for t in ds]
            s = w2 * box + b2
            ds = [2 * w * box + w2 * dbox[0], w2 * dbox[1] + 2 * b]
            if profiles is None:
                v, dv = _diag(s), [_diag(t) for t in ds]
                own.append((v, dv))
                va = vb = v
                dva = dvb = dv
            else:
                (va, dva), (vb, dvb) = profiles[0][layer], profiles[1][layer]
            s, ds = relu_dual(s, va[:, :, :, None, None], vb[:, None, None, :, :], ds,
                              [t[:, :, :, None, None] for t in dva],
                              [t[:, None, None, :, :] for t in dvb])
            layer += 1
        s, ds = _pool(s), [_pool(t) for t in ds]
    gap = s.mean(dim=(1, 2, 3, 4))
    dgap = [t.mean(dim=(1, 2, 3, 4)) for t in ds]
    return gap, dgap, own


def _profiles(x, w, b, ar):
    """Every image's variance profile and its tangents, from its self pair."""
    per = []
    for i in range(0, x.shape[0], PAIRS):
        xi = x[i:i + PAIRS]
        per.append(recursion(xi, xi, w, b, ar)[2])
    layers = len(per[0])
    return [(torch.cat([p[l][0] for p in per]),
             [torch.cat([p[l][1][j] for p in per]) for j in range(2)]) for l in range(layers)]


def gram(x1, x2, w, b, last, ar, same=False):
    """(K, [dK/dw, dK/db, dK/dlast]) of [n1, h, h, C] against [n2, h, h, C]
    images; ``same`` computes each pair of K(x, x) once and mirrors it."""
    p1 = _profiles(x1, w, b, ar)
    p2 = p1 if same else _profiles(x2, w, b, ar)
    n1, n2 = x1.shape[0], x2.shape[0]
    ii, jj = torch.meshgrid(torch.arange(n1), torch.arange(n2), indexing="ij")
    keep = (jj <= ii) if same else torch.ones_like(ii, dtype=torch.bool)
    ii, jj = ii[keep].to(x1.device), jj[keep].to(x1.device)
    k = torch.zeros(n1, n2, dtype=x1.dtype, device=x1.device)
    dk = [torch.zeros_like(k), torch.zeros_like(k)]

    def take(prof, idx):
        return [(v[idx], [t[idx] for t in dv]) for v, dv in prof]

    for i in range(0, ii.numel(), PAIRS):
        a, bb = ii[i:i + PAIRS], jj[i:i + PAIRS]
        gap, dgap, _ = recursion(x1[a], x2[bb], w, b, ar, (take(p1, a), take(p2, bb)))
        k[a, bb] = gap
        for t, dt in zip(dk, dgap):
            t[a, bb] = dt
        if same:
            k[bb, a] = gap
            for t, dt in zip(dk, dgap):
                t[bb, a] = dt
    kk = last * last * k
    return kk, [last * last * dk[0], last * last * dk[1], 2 * last * k]


# -- the ELBO ------------------------------------------------------------------------

NAMES = ("eps", "inducing_variable", "kernel.b_std", "kernel.last_w_std", "kernel.w_std",
         "prior.a", "prior.b", "q_mu", "q_sqrt")


def _lift(mat, mult=1.0):
    """The working precision's safety lift: the smallest eigenvalue raised
    to mult eps_fp32 max_eig where it lies below that (detached)."""
    sym = ((mat + mat.mT) * 0.5).detach()
    ev = torch.linalg.eigvalsh(sym)
    boost = torch.clamp(mult * F32_EPS * ev[..., -1] - ev[..., 0], min=0.0)
    return mat + boost[..., None, None] * torch.eye(mat.shape[-1], dtype=mat.dtype,
                                                     device=mat.device)


class _PinvEigh(torch.autograd.Function):
    """(A)^+ by eigh with eigenvalues floored at max_eig eps_fp32, whose
    derivative is the inverse's, -A^+ dA A^+."""

    @staticmethod
    def forward(ctx, mat):
        ev, vec = torch.linalg.eigh((mat + mat.mT) * 0.5)
        ev = torch.maximum(ev, ev[..., -1:] * F32_EPS)
        inv = (vec / ev[..., None, :]) @ vec.mT
        ctx.save_for_backward(inv)
        return inv

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return -(inv.mT @ g @ inv.mT)


class _Gamma(torch.autograd.Function):
    """The gamma variate g drawn at shape a, differentiable in a at fixed
    quantile (implicit reparameterization)."""

    @staticmethod
    def forward(ctx, a, g):
        ctx.save_for_backward(a, g)
        return g.clone()

    @staticmethod
    def backward(ctx, grad):
        a, g = ctx.saved_tensors
        return grad * torch._standard_gamma_grad(a, g), None


def neg_elbo(kzz, kxz, kxx, y, draws, leaves, num_train, alpha, beta, ar):
    """The negative ELBO per data point of one batch, and its data term -ll."""
    eps = softplus(leaves["eps"])
    q_sqrt = softplus(leaves["q_sqrt"])
    q_mu = leaves["q_mu"]
    a, b = softplus(leaves["prior.a"]), softplus(leaves["prior.b"])
    ni, nc = kzz.shape[0], q_mu.shape[0]
    eye = torch.eye(ni, dtype=kzz.dtype, device=kzz.device)
    kii_inv = torch.cholesky_inverse(ar.chol(_lift(kzz + eps * eye)))
    a_b = ar.mm(kxz, kii_inv)
    r = eps * torch.diagonal(kzz).mean()
    rel_inv = _PinvEigh.apply(kzz + r * eye)
    b_b = kxx - ar.mm(ar.mm(kxz, rel_inv), kxz.T)
    mean = ar.mm(q_mu, a_b.T)                                        # [C, B]
    cov = ar.mm(a_b[None] * q_sqrt[:, None, :], a_b.T[None]) + b_b[None]
    cov = _lift(cov, mult=cov.shape[-1])
    normal, gamma = draws                                            # [S, C, B]
    factor = ar.chol((b / a) * cov)
    half_df = a.expand(normal.shape)
    t = normal * torch.sqrt(half_df / _Gamma.apply(half_df, gamma))
    f = mean + torch.einsum("cij,scj->sci", ar.op(factor), ar.op(t))  # [S, C, B]
    lsm = torch.log_softmax(f, dim=1)
    idx = y.long()[None, None, :].expand(f.shape[0], 1, f.shape[2])
    ll = torch.gather(lsm, 1, idx).mean()
    sign, logabs = torch.linalg.slogdet(kzz)
    logdet_k = sign * logabs * nc
    logdet_q = torch.sum(torch.log(q_sqrt))
    tr = torch.sum(torch.diagonal(kii_inv)[None, :] * q_sqrt)
    quad = torch.einsum("ci,ij,cj->", q_mu, kii_inv, q_mu)
    gauss = 0.5 * ((logdet_k - logdet_q) - ni * nc + tr + quad * (a / b))
    ig = (alpha * torch.log(b / beta) - torch.lgamma(a) + math.lgamma(alpha)
          + (a - alpha) * torch.digamma(a) + (beta - b) * (a / b))
    return -ll + (gauss + ig) / num_train, -ll


def initial(config, z):
    m = config["model"]
    nc, ni = config["data"]["num_class"], z.shape[0]
    dt = dict(dtype=torch.float64, device=z.device)
    one = lambda v: torch.tensor(softplus_inv(v), **dt)  # noqa: E731
    return {"eps": one(m["epsilon"]), "inducing_variable": z.double(),
            "kernel.b_std": one(m["b_std"]), "kernel.last_w_std": one(m["last_w_std"]),
            "kernel.w_std": one(m["w_std"]), "prior.a": one(m["alpha"]),
            "prior.b": one(m["beta"]), "q_mu": torch.zeros(nc, ni, **dt),
            "q_sqrt": torch.full((nc, ni), softplus_inv(1.0), **dt)}


def loss_and_grads(raw, xb, yb, draws, config, ar):
    m = config["model"]
    z = raw["inducing_variable"].to(ar.dtype)
    xb = xb.to(ar.dtype)
    w, b, last = (softplus(raw[n]).to(ar.dtype)
                  for n in ("kernel.w_std", "kernel.b_std", "kernel.last_w_std"))
    with torch.no_grad():
        kzz, dzz = gram(z, z, w, b, last, ar, same=True)
        kxz, dxz = gram(xb, z, w, b, last, ar)
        kxx, dxx = gram(xb, xb, w, b, last, ar, same=True)
    grams = [t.requires_grad_(True) for t in (kzz, kxz, kxx)]
    names = ("eps", "prior.a", "prior.b", "q_mu", "q_sqrt")
    leaves = {n: raw[n].detach().to(ar.dtype).clone().requires_grad_(True) for n in names}
    loss, nll = neg_elbo(*grams, yb, [d.to(ar.dtype) for d in draws], leaves,
                         config["data"]["num_train"], m["alpha"], m["beta"], ar)
    loss.backward()
    grads = {n: leaves[n].grad for n in names}
    grads["inducing_variable"] = torch.zeros_like(raw["inducing_variable"])  # frozen inputs
    for j, name in enumerate(("kernel.w_std", "kernel.b_std", "kernel.last_w_std")):
        total = sum(torch.sum(g.grad * d[j]) for g, d in zip(grams, (dzz, dxz, dxx)))
        grads[name] = total * torch.sigmoid(raw[name].to(ar.dtype))
    return (loss.detach(), nll.detach()), {n: grads[n].to(torch.float64) for n in NAMES}


def train(config, data, steps, inputs, precision="float64"):
    """``steps`` ELBO steps on the recorded batches and draws ``inputs``
    (a list of (batch indices, (normals, gammas))) from the configuration's
    initial values: {"terms" (each step's loss and data term -ll), "grad1",
    "change"}."""
    ar = Arith(precision)
    m = config["model"]
    raw0 = initial(config, data["z"])
    raw = dict(raw0)
    keep = [n for n in NAMES if n != "inducing_variable"
            and not (m["freeze_last_w_std"] and n == "kernel.last_w_std")]
    opt = Adam(NAMES, keep)
    terms, grad1 = [], None
    for idx, draws in inputs[:steps]:
        (loss, nll), grads = loss_and_grads(raw, data["x"][idx], data["y"][idx], draws,
                                            config, ar)
        terms.append({"loss": float(loss), "nll": float(nll)})
        grad1 = grad1 or {n: grads[n].detach().cpu() for n in NAMES}
        raw = opt.update(raw, grads, config["train"]["lr"])
    change = {n: (raw[n] - raw0[n]).double().cpu() for n in NAMES}
    return {"terms": terms, "grad1": grad1, "change": change}
