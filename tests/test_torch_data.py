"""Port parity: snngp_torch.data is a numpy copy of snngp.data (which cannot
be imported without JAX); the synthetic datasets, the splits, the CLI's
double permutation, the classification variants, the host resize and the
DataLoader's batches must be byte-identical."""

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


# -- classification data (snngp_torch/data/classification.py, resize.py) ------

from snngp.data import classification as jcls  # noqa: E402
from snngp.data.resize import bilinear_resize as j_resize  # noqa: E402
from snngp.utils.training import DataLoader as JLoader  # noqa: E402

from snngp_torch.data import classification as tcls  # noqa: E402
from snngp_torch.data.resize import bilinear_resize as t_resize  # noqa: E402
from snngp_torch.utils import DataLoader as TLoader  # noqa: E402


def _assert_same_bytes(got, want):
    for a, b in zip(_flatten(got), _flatten(want)):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name,num_data", [
    ("synthetic", None), ("synthetic", 300), ("synthetic32", 500),
    ("synthetic/ood", None), ("synthetic/ood/3,5", 400),
    ("synthetic/noisy_label", 300), ("synthetic/imbalanced", None)])
def test_classification_train_split_bytes_identical(name, num_data, tmp_path):
    # The valid split, num_data, the OOD class drop and the other variants.
    kw = dict(name=name, root=str(tmp_path), num_data=num_data, valid_prop=0.1, seed=3)
    got = tcls.get_train_dataset(**kw)
    want = jcls.get_train_dataset(**kw)
    _assert_same_bytes(got[:2], want[:2])
    assert got[2] == want[2]


@pytest.mark.parametrize("name,num_data", [("synthetic", None), ("synthetic32", 200)])
def test_classification_test_split_bytes_identical(name, num_data, tmp_path):
    got = tcls.get_test_dataset(name, root=str(tmp_path), num_data=num_data, onehot=True)
    want = jcls.get_test_dataset(name, root=str(tmp_path), num_data=num_data, onehot=True)
    _assert_same_bytes(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize("shape,out", [((5, 8, 8, 1), (4, 4)), ((3, 32, 32, 3), (16, 16)),
                                       ((2, 6, 5, 2), (9, 7)), ((2, 8, 8, 1), (8, 8))])
def test_bilinear_resize_bytes_identical(shape, out):
    x = np.random.RandomState(0).rand(*shape)
    got, want = t_resize(x, *out), j_resize(x, *out)
    assert got.dtype == want.dtype == np.float32 and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("shuffle,batch", [(True, 7), (False, 7), (False, None)])
def test_data_loader_gives_the_same_batches(shuffle, batch):
    # Same shuffle stream: random.Random(seed), the seed incremented per epoch.
    x = np.arange(40, dtype=np.float64).reshape(20, 2)
    y = np.arange(20)
    jl = JLoader(x, y, batch_size=batch, shuffle=shuffle, seed=4)
    tl = TLoader(x, y, batch_size=batch, shuffle=shuffle, seed=4)
    assert len(tl) == len(jl) and tl.num_data == jl.num_data
    for _ in range(2):                       # two epochs
        got, want = list(tl), list(jl)
        assert len(got) == len(want)
        _assert_same_bytes(got, want)
