"""Softmax Monte-Carlo likelihood estimators for sampled latent functions
(counterpart of ``snngp/ops/softmax.py``; rebuilds ``spax/utils.py:47-74``).

All take ``sampled_f`` of shape [C, B, S] (class, batch, sample) and integer
labels [B]. The train / test asymmetry of the reference is kept: training
uses the mean of the log-softmax (a lower bound, :func:`log_likelihood`),
testing the log of the mean probability (the MC predictive,
:func:`test_log_likelihood`).
"""

from __future__ import annotations

import math

import torch

__all__ = ["get_true_values", "log_likelihood", "test_log_likelihood",
           "get_correct_count"]


def get_true_values(value: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """value[label[b], b, s] -> [B, S] (spax/utils.py:47-51)."""
    idx = label.long()[None, :, None].expand((1,) + value.shape[1:])
    return torch.gather(value, 0, idx).squeeze(0)


def log_likelihood(sampled_f: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Training estimator: mean over samples of the log-softmax at the true
    label (spax/utils.py:54-58)."""
    true_lsm = get_true_values(torch.log_softmax(sampled_f, dim=0), label)
    return torch.mean(torch.mean(true_lsm, dim=0))


def test_log_likelihood(sampled_f: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Test estimator: log of the mean predictive probability, logsumexp -
    log S (spax/utils.py:61-66)."""
    num_samples = sampled_f.shape[2]
    true_lsm = get_true_values(torch.log_softmax(sampled_f, dim=0), label)
    return torch.mean(torch.logsumexp(true_lsm, dim=1) - math.log(num_samples))


def get_correct_count(sampled_f: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Correct predictions; the prediction is the argmax over classes of the
    sample-aggregated log-softmax (spax/utils.py:69-74)."""
    lsm = torch.log_softmax(sampled_f, dim=0)
    y_pred = torch.argmax(torch.logsumexp(lsm, dim=2), dim=0)
    return torch.sum(y_pred == label)
