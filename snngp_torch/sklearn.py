"""scikit-learn-style estimator facade over the port's model layer
(counterpart of ``snngp/sklearn.py``).

- :class:`SNNGPRegressor` packages exact-inference NNGP regression (``SPR``)
  with ``method="gp"`` (Gaussian) or ``"tp"`` (Student-t scale mixture),
  optional ML-II hyperparameter training and repeated prediction through
  the fitted-state predictor; ``extendable=True`` lets ``add_data`` grow
  the conditioning set without a refit.
- :class:`SNNGPClassifier` packages sparse variational classification
  (``SVSP``) with ``method="svgp"`` / ``"svtp"`` on the MLP NNGP of flat
  features or the CNN, WideResNet or Myrtle NNGP of images, minibatch ELBO
  training and MC ``predict_proba``.

Both follow the fit/predict contract: ``__init__`` only stores
hyperparameters, ``fit`` returns ``self``, learned attributes end in ``_``,
and ``get_params`` / ``set_params`` make them clone- and
grid-search-compatible. sklearn itself is not required.

``device`` (default ``"cuda"``) names where the data, the parameters and
every Gram live; asking for CUDA on a machine without it is an error, not a
quiet CPU run.
"""

from __future__ import annotations

import numpy as np
import torch

from snngp_torch.models.predictor import fit_spr
from snngp_torch.utils.optim import SGD, Adam
from snngp_torch.utils.training import train_step

__all__ = ["SNNGPRegressor", "SNNGPClassifier"]


class _EstimatorBase:
    """Minimal sklearn estimator protocol (no sklearn dependency)."""

    _param_names: tuple = ()

    def get_params(self, deep: bool = True):
        return {k: getattr(self, k) for k in self._param_names}

    def set_params(self, **kwargs):
        for k, v in kwargs.items():
            if k not in self._param_names:
                raise ValueError(f"Invalid parameter {k!r} for "
                                 f"{type(self).__name__}")
            setattr(self, k, v)
        return self

    def __repr__(self):
        args = ", ".join(f"{k}={getattr(self, k)!r}" for k in self._param_names)
        return f"{type(self).__name__}({args})"


def _device(name) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={name!r}: CUDA is not available on this machine "
                           "(pass device='cpu' to run on the CPU)")
    return device


class SNNGPRegressor(_EstimatorBase):
    """Exact NNGP / Student-t process regression with fit/predict semantics.

    Parameters mirror ``reg tr`` flags: ``method`` gp|tp, ``network``
    mlp|resnet, depth / activation / scale hyperparameters, ``alpha`` /
    ``beta`` for the Student-t scale mixture, jitter ``eps``.
    ``max_steps > 0`` runs full-batch ML-II on the marginal likelihood
    (Adam/SGD on the scale scalars, the likelihood parameters and eps —
    exactly the CLI's training loss); ``max_steps=0`` keeps the constructor
    hyperparameters. ``fit`` normalizes the targets (train mean / std) and
    hoists the O(N^3) train-side solve into a fitted predictor, so
    ``predict`` / ``score`` cost O(N x n) per call.

    ``seed`` is accepted for grid-search compatibility but unused: fitting
    is deterministic.
    """

    _param_names = ("method", "network", "num_hiddens", "activation",
                    "w_std", "b_std", "last_w_std", "alpha", "beta", "eps",
                    "optimizer", "lr", "max_steps", "normalize_y", "seed",
                    "extendable", "device")

    def __init__(self, method="tp", network="mlp", num_hiddens=4,
                 activation="relu", w_std=1.0, b_std=1e-8, last_w_std=1.0,
                 alpha=2.0, beta=2.0, eps=1e-6, optimizer="adam", lr=1e-2,
                 max_steps=0, normalize_y=True, seed=10, extendable=False,
                 device="cuda"):
        self.method = method
        self.network = network
        self.num_hiddens = num_hiddens
        self.activation = activation
        self.w_std = w_std
        self.b_std = b_std
        self.last_w_std = last_w_std
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        self.optimizer = optimizer
        self.lr = lr
        self.max_steps = max_steps
        self.normalize_y = normalize_y
        self.seed = seed
        self.extendable = extendable
        self.device = device

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device_)

    # -- sklearn protocol --------------------------------------------------

    def fit(self, X, y, profiler=None):
        """Build the model, run ``max_steps`` ML-II steps, fit the predictor.

        ``losses_`` holds the loss of every step (before its update);
        ``profiler`` (a :class:`~snngp_torch.utils.profiling.Profiler`)
        splits each step into its synchronized phases."""
        from snngp_torch.cli.regression import _build_model

        self.device_ = _device(self.device)
        X = self._tensor(X)
        y = np.asarray(y, np.float32).reshape(-1)
        if self.normalize_y:
            y_mean, y_std = float(y.mean()), float(y.std() or 1.0)
        else:
            y_mean, y_std = 0.0, 1.0
        y_n = self._tensor((y - y_mean) / y_std)

        cfg = dict(network=self.network, num_hiddens=self.num_hiddens,
                   activation=self.activation, w_std=self.w_std,
                   b_std=self.b_std, last_w_std=self.last_w_std,
                   method=self.method, alpha=self.alpha, beta=self.beta,
                   epsilon=self.eps)
        model, _ = _build_model(cfg, X, y_n, y_mean, y_std)

        if self.max_steps:
            opt = Adam(model) if self.optimizer == "adam" else SGD(model)
            losses = [train_step(model, opt, self.lr, profiler)
                      for _ in range(self.max_steps)]
            self.losses_ = torch.stack(losses).cpu().numpy()
            self.final_loss_ = float(self.losses_[-1])

        self.model_ = model
        with torch.inference_mode():
            self.fitted_ = fit_spr(model, extendable=self.extendable)
        return self

    def add_data(self, X, y):
        """Grow the fitted training set incrementally (O(N^2 m), no refit).

        Needs ``extendable=True`` at construction. The new targets are
        normalized with the fit-time statistics; the hyperparameters are not
        retrained (call ``fit`` on the combined data for that)."""
        with torch.inference_mode():
            self.fitted_ = self.fitted_.extend(self._tensor(X),
                                               self._tensor(np.asarray(y).reshape(-1)))
        self.model_ = self.fitted_.model
        return self

    def predict(self, X, return_std: bool = False):
        """De-normalized predictive mean (and optionally its std)."""
        with torch.inference_mode():
            mean, var = self.fitted_.predict(self._tensor(X))
            if return_std:
                return mean.cpu().numpy(), torch.sqrt(var).cpu().numpy()
            return mean.cpu().numpy()

    def score(self, X, y):
        """R^2 of the predictive mean (sklearn regressor convention)."""
        y = np.asarray(y, np.float64).reshape(-1)
        pred = np.asarray(self.predict(X), np.float64)
        ss_res = float(((y - pred) ** 2).sum())
        ss_tot = float(((y - y.mean()) ** 2).sum())
        return 1.0 - ss_res / ss_tot if ss_tot else 0.0

    def neg_log_likelihood(self, X, y):
        """Mean predictive NLL on raw-scale targets (the paper's metric)."""
        s = self.fitted_.state
        with torch.inference_mode():
            y_n = (self._tensor(np.asarray(y, np.float32).reshape(-1))
                   - s["y_mean"]) / s["y_std"]
            return float(self.fitted_.test_nll(self._tensor(X), y_n))


class SNNGPClassifier(_EstimatorBase):
    """Sparse variational NNGP / Student-t process classification.

    Parameters mirror ``cls tr`` flags: ``method`` svgp|svtp, the kernel's
    network (``"cnn"``, ``"resnet"``, the conv WideResNet, or ``"myrtle"``
    for [N, H, W, C] images, with ``num_hiddens`` the Myrtle depth 5, 7 or
    10, which freezes the inducing inputs and takes scalar-only kernel
    gradients as ``cls tr -n myrtle`` does; ``"mlp"`` for [N, D] features,
    whose Gram blocks are K1 on the card and whose backward, the inducing
    inputs being trained, is the layer tier's), depth / activation /
    scales, ``alpha`` / ``beta`` of the svtp prior, jitter ``eps``, the
    inducing-point count, the ELBO's MC sample count and the minibatch
    schedule. ``fit`` initializes the inducing points class-proportionally
    (the first samples of each class, as the CLI does), trains the ELBO
    with Adam / SGD, and hoists the inducing-side solves into a fitted
    predictor for ``predict_proba``.

    The minibatch order and the MC draws come from ``torch.Generator``s
    seeded with ``seed`` (fit) and ``seed + 1`` (every ``predict_proba``
    call), so repeated calls agree; they are not the JAX package's draws.
    """

    _param_names = ("method", "network", "num_hiddens", "activation",
                    "w_std", "b_std", "last_w_std", "alpha", "beta", "eps",
                    "num_inducing", "num_samples", "batch_size", "epochs",
                    "optimizer", "lr", "seed", "device")

    def __init__(self, method="svtp", network="cnn", num_hiddens=4,
                 activation="relu", w_std=1.0, b_std=0.0, last_w_std=1.0,
                 alpha=2.0, beta=2.0, eps=1e-6, num_inducing=100,
                 num_samples=100, batch_size=64, epochs=10,
                 optimizer="adam", lr=1e-2, seed=10, device="cuda"):
        self.method = method
        self.network = network
        self.num_hiddens = num_hiddens
        self.activation = activation
        self.w_std = w_std
        self.b_std = b_std
        self.last_w_std = last_w_std
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        self.num_inducing = num_inducing
        self.num_samples = num_samples
        self.batch_size = batch_size
        self.epochs = epochs
        self.optimizer = optimizer
        self.lr = lr
        self.seed = seed
        self.device = device

    def fit(self, X, y, profiler=None):
        """Build the model, train ``epochs`` epochs of minibatch ELBO steps,
        fit the predictor. ``losses_`` holds every step's loss (before its
        update); ``profiler`` splits each step into its synchronized
        phases (see :func:`~snngp_torch.utils.training.svsp_train_step`)."""
        from snngp_torch.cli.classification import _make_model
        from snngp_torch.models.predictor import fit_svsp
        from snngp_torch.nn.arch import get_mlp_kernel
        from snngp_torch.utils.training import svsp_train_step

        if self.network == "myrtle" and self.num_hiddens not in (5, 7, 10):
            raise ValueError("network='myrtle' uses num_hiddens as the Myrtle depth: "
                             f"one of 5, 7, 10 (got {self.num_hiddens})")
        self.device_ = _device(self.device)
        X = np.asarray(X, np.float32)
        y = np.asarray(y).reshape(-1)
        self.classes_ = np.unique(y)
        num_class = len(self.classes_)
        y_idx = np.searchsorted(self.classes_, y)

        counts = np.bincount(y_idx, minlength=num_class)
        per_class = np.round(self.num_inducing * counts / counts.sum()).astype(int)
        z = np.concatenate([X[y_idx == c][:max(per_class[c], 1)] for c in range(num_class)])
        get_kernel_fn = None
        if self.network == "mlp":
            def get_kernel_fn(w, b, l):
                return get_mlp_kernel(self.num_hiddens, num_class, self.activation,
                                      w_std=w, b_std=b, last_w_std=l)
        model = _make_model(self.method, self.network, self.num_hiddens, self.activation,
                            self.w_std, self.b_std, self.last_w_std, self.alpha, self.beta,
                            num_class, z, self.eps,
                            get_kernel_fn=get_kernel_fn).to(self.device_)
        opt_cls = Adam if self.optimizer == "adam" else SGD
        if self.network == "myrtle":   # the inducing inputs stay at their init
            opt = opt_cls(model, mask=lambda n: "inducing_variable" not in n)
        else:
            opt = opt_cls(model)
        xt = torch.as_tensor(X, device=self.device_)
        yt = torch.as_tensor(y_idx, device=self.device_)
        gen = torch.Generator(device=self.device_).manual_seed(self.seed)
        num_train = X.shape[0]
        losses = []
        for _ in range(self.epochs):
            order = torch.randperm(num_train, generator=gen, device=self.device_)
            for lo in range(0, num_train, self.batch_size):
                idx = order[lo:lo + self.batch_size]
                losses.append(svsp_train_step(model, [opt], [self.lr], xt[idx], yt[idx],
                                              num_train, self.num_samples, gen, profiler))
        self.losses_ = torch.stack(losses).cpu().numpy() if losses else np.zeros(0)
        self.final_loss_ = float(self.losses_[-1]) if losses else float("nan")
        self.model_ = model
        with torch.no_grad():
            self.fitted_ = fit_svsp(model)
        return self

    def predict_proba(self, X, num_samples: int = 1000):
        """Mean MC predictive class probabilities [n, n_classes]."""
        gen = torch.Generator(device=self.device_).manual_seed(self.seed + 1)
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(X, np.float32), device=self.device_)
            return self.fitted_.predict_proba(x, num_samples, generator=gen).cpu().numpy()

    def predict(self, X):
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)]

    def score(self, X, y):
        """Accuracy (sklearn classifier convention)."""
        y = np.asarray(y).reshape(-1)
        return float((self.predict(X) == y).mean())
