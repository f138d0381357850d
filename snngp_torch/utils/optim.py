"""Optimizers with objax's update semantics (counterpart of
``snngp/utils/optim.py``).

The reference trains with ``objax.optimizer.Adam`` / ``SGD``. Parity of the
learned hyperparameters needs objax's exact Adam:

    t <- t + 1
    lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)
    m <- m + (1 - beta1) (g - m)
    v <- v + (1 - beta2) (g^2 - v)
    p <- p - lr_t * m / (sqrt(v) + eps)

``torch.optim.Adam`` puts eps inside the bias correction (its denominator is
sqrt(v / (1 - beta2^t)) + eps), so it is not a substitute.

An optimizer holds a module's parameters in sorted dotted-name order, the
order of the JAX package's parameter pytree, and updates them in place from
their ``.grad``. ``mask``, a predicate over dotted names, freezes the
parameters it rejects (their moments still update, as in the JAX package).
``state_leaves`` / ``load_state_leaves`` give the state in the JAX
package's pytree order — Adam: ``step``, then ``mu``, then ``nu`` — which
:mod:`snngp_torch.utils.checkpoint` writes to and reads from ``resume.state``.
All arithmetic stays on the parameters' device: a step needs no host sync.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

__all__ = ["Adam", "SGD"]


class _Optimizer:
    def __init__(self, module, mask: Optional[Callable[[str], bool]] = None):
        from snngp_torch.models.params import named_leaves   # models import ops, ops utils
        named = named_leaves(module)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.keep = [mask is None or bool(mask(n)) for n in self.names]

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def _assign(self, new_values):
        for p, new, keep in zip(self.params, new_values, self.keep):
            if keep:
                p.copy_(new)


class Adam(_Optimizer):
    def __init__(self, module, beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8, mask=None):
        super().__init__(module, mask)
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        like = self.params[0]
        self.step = torch.zeros((), dtype=torch.int32, device=like.device)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def update(self, lr):
        t = self.step + 1
        tf = t.to(self.params[0].dtype)
        lr_t = lr * torch.sqrt(1.0 - self.beta2 ** tf) / (1.0 - self.beta1 ** tf)
        grads = [p.grad for p in self.params]
        self.mu = [m + (1.0 - self.beta1) * (g - m) for m, g in zip(self.mu, grads)]
        self.nu = [v + (1.0 - self.beta2) * (g * g - v) for v, g in zip(self.nu, grads)]
        self._assign([p - lr_t * m / (torch.sqrt(v) + self.eps)
                      for p, m, v in zip(self.params, self.mu, self.nu)])
        self.step = t

    def state_leaves(self) -> List[torch.Tensor]:
        return [self.step, *self.mu, *self.nu]

    def load_state_leaves(self, leaves):
        n = len(self.params)
        if len(leaves) != 1 + 2 * n:
            raise ValueError(f"Adam state for {n} parameters has {1 + 2 * n} leaves; "
                             f"got {len(leaves)}")
        dev = self.params[0].device
        self.step = torch.as_tensor(leaves[0], dtype=torch.int32, device=dev)
        self.mu = [torch.as_tensor(v, dtype=p.dtype, device=dev)
                   for v, p in zip(leaves[1:1 + n], self.params)]
        self.nu = [torch.as_tensor(v, dtype=p.dtype, device=dev)
                   for v, p in zip(leaves[1 + n:], self.params)]


class SGD(_Optimizer):
    @torch.no_grad()
    def update(self, lr):
        self._assign([p - lr * p.grad for p in self.params])

    def state_leaves(self) -> List[torch.Tensor]:
        return []

    def load_state_leaves(self, leaves):
        if len(leaves):
            raise ValueError(f"SGD has no state; got {len(leaves)} leaves")
