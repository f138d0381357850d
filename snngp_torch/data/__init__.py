"""Dataset layer: UCI/synthetic regression (numpy; no torch, no JAX)."""

import numpy as _np


def permute_dataset(x, y, seed=0):
    """Seeded permutation (reference regression/data.py:292-295)."""
    idx = _np.random.RandomState(seed).permutation(x.shape[0])
    return x[idx], y[idx]


from snngp_torch.data.regression import (  # noqa: E402
    DATASETS as REGRESSION_DATASETS, get_dataset, split_dataset,
)

__all__ = ["REGRESSION_DATASETS", "get_dataset", "permute_dataset", "split_dataset"]
