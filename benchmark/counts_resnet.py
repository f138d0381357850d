"""The operations and bytes of the port's WideResNet Gram kernels, K5
(``resnet_tail_kernel``: stride-1 residual blocks) and K6
(``resnet_strided_kernel``: a group's leading stride-2 block), counted from
their shapes, and the launches of one Gram with their least times.

Frozen copies of ``chip_smoke.py``'s ``k5_ops`` and ``k6_ops`` and of its
byte count for them (each input read once, the state's triangle for K(x, x),
every output written once), on the counting rules of ``benchmark.counts``.
"""

from __future__ import annotations

import re

from benchmark.counts import dual_act_ops, least_s, pairs

MAX_TAIL_BLOCKS = 4     # K5's blocks a launch (csrc/resnet_conv_gram.cu kMaxTailBlocks)

# The device kernels by work key and the pattern of the profiler's name.
KERNELS = {"k5": re.compile(r"\bresnet_tail_kernel\b"),
           "k6": re.compile(r"\bresnet_strided_kernel\b")}


def kernel_key(name):
    """The work key of a device kernel's profiler name ("k5", "k6"), or None."""
    for key, pattern in KERNELS.items():
        if pattern.search(name):
            return key
    return None


def _half(n):
    return -(-n // 2)


def k5_ops(n1, n2, hw, nblocks, act, mismatch, same):
    """fp32 operations of K5: per pixel and block two dual activations, two
    stencils (4 adds and a divide each), the FMA of c1 and the residual
    update (an FMA and an add); a conv shortcut adds a third stencil, its
    FMA and an add."""
    a = dual_act_ops(act, False)
    return pairs(n1, n2, same) * hw * (nblocks * (2 * a + 15) + (7 if mismatch else 0))


def k6_ops(n1, n2, h, w, act, same):
    """fp32 operations of K6: t1 at every full-resolution pixel; the column
    sums of t1 and of k at the lattice columns (2 adds each); at each
    reduced pixel the two lattice row sums with their divides (3 each) and
    FMAs, t2, the reduced stencil (5), its FMA and the final add."""
    a = dual_act_ops(act, False)
    hr, wr = _half(h), _half(w)
    return pairs(n1, n2, same) * (h * w * a + 4 * h * wr + hr * wr * (a + 18))


def k5_bytes(n1, n2, hw, nblocks, same):
    """The state's pairs, the variance rows [2 nblocks, n, hw] of each
    operand (once for K(x, x)), the two scales and the state written."""
    rows = 2 * nblocks * hw * (n1 if same else n1 + n2)
    return 4 * (pairs(n1, n2, same) * hw + rows + 2 + n1 * n2 * hw)


def k6_bytes(n1, n2, h, w, same):
    """The state's pairs, each operand's variance rows entering the two
    activations ([n, hw] and [n, hwr]), the two scales and the reduced
    state written."""
    hwr = _half(h) * _half(w)
    rows = (h * w + hwr) * (n1 if same else n1 + n2)
    return 4 * (pairs(n1, n2, same) * h * w + rows + 2 + n1 * n2 * hwr)


def gram_launches(n1, n2, h, w, depth, act="relu", same=False):
    """One WideResNet Gram's launches with their least times (seconds):
    {"k5": [...], "k6": [...]} in launch order. Group 1 runs its ``depth``
    blocks (the first with the conv shortcut) through K5; each of groups
    2-4 opens with one K6 and runs its other ``depth - 1`` blocks through
    K5, at most MAX_TAIL_BLOCKS blocks a launch."""
    out = {"k5": [], "k6": []}

    def tail(h, w, nblocks, mismatch):
        for first in range(0, nblocks, MAX_TAIL_BLOCKS):
            nb = min(MAX_TAIL_BLOCKS, nblocks - first)
            out["k5"].append(least_s(k5_bytes(n1, n2, h * w, nb, same),
                                     k5_ops(n1, n2, h * w, nb, act, mismatch and not first,
                                            same)))

    tail(h, w, depth, True)
    for _ in range(3):
        out["k6"].append(least_s(k6_bytes(n1, n2, h, w, same), k6_ops(n1, n2, h, w, act, same)))
        h, w = _half(h), _half(w)
        if depth > 1:
            tail(h, w, depth - 1, False)
    return out


def roofline(rec, key):
    """K5's or K6's share of its roofline in a traced run (%): the counted
    least time of its launches in the captured units over their device
    time there. None where the capture holds no such launch, or fewer or
    more of them than the captured units launched (a lost record)."""
    if rec.capture is None or not rec.captured:
        return None
    least = [t for u in rec.units[:rec.captured] for t in u["work"]["launches"].get(key, ())]
    times = [(e - s) * 1e-6 for n, s, e in rec.capture.device_ops if kernel_key(n) == key]
    if not least or len(times) != len(least) or sum(times) <= 0:
        return None
    return 100.0 * sum(least) / sum(times)
