"""Port parity: snngp_torch.data is a numpy copy of snngp.data (which cannot
be imported without JAX); the synthetic datasets, the split and the CLI's
double permutation must give byte-identical arrays."""

import numpy as np
import pytest

from snngp.cli.regression import _load_splits as j_load_splits
from snngp.data import permute_dataset as j_permute
from snngp.data.regression import get_dataset as j_get_dataset, split_dataset as j_split

from snngp_torch.cli.regression import _load_splits as t_load_splits
from snngp_torch.data import permute_dataset as t_permute
from snngp_torch.data.regression import get_dataset as t_get_dataset, split_dataset as t_split

from _torch_parity import to_numpy


def _flatten(tree):
    if isinstance(tree, (tuple, list)):
        return [a for t in tree for a in _flatten(t)]
    return [np.asarray(to_numpy(tree))]


@pytest.mark.parametrize("name", ["syn-normal", "syn-t"])
def test_synthetic_dataset_bytes_identical(name, tmp_path):
    jx, jy = j_get_dataset(name, root=str(tmp_path))
    tx, ty = t_get_dataset(name, root=str(tmp_path))
    assert jx.tobytes() == tx.tobytes() and jy.tobytes() == ty.tobytes()


@pytest.mark.parametrize("name", ["syn-normal", "syn-t"])
def test_permute_and_split_bytes_identical(name, tmp_path):
    x, y = t_get_dataset(name, root=str(tmp_path))
    want = j_split(*j_permute(x, y, seed=10), train=0.8, valid=0.1, test=0.1)
    got = t_split(*t_permute(x, y, seed=10), train=0.8, valid=0.1, test=0.1)
    for a, b in zip(_flatten(got), _flatten(want)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [10, 3])
def test_cli_splits_bytes_identical(seed, tmp_path):
    # The CLI's seeded train/valid re-permutation, as float32 tensors.
    want = j_load_splits("syn-t", str(tmp_path), seed)
    got = t_load_splits("syn-t", str(tmp_path), seed, "cpu")
    for a, b in zip(_flatten(got), _flatten(want)):
        assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()
