"""Classification datasets (a numpy copy of ``snngp/data/classification.py``,
which cannot be imported without JAX; it rebuilds
``experiments/classification/data.py``).

Same named-config registry (MNIST / KMNIST / Fashion / EMNIST / CIFAR-10 /
SVHN + corrupted variants), same transforms (``ood`` class-drop,
``imbalanced`` exp/step per-class counts, ``noisy_label`` random relabel) and
fixed normalization stats.

Backend: the reference loads through tensorflow_datasets
(``data.py:152-158``). Here loading is pluggable, in order of preference:

1. tensorflow_datasets when importable (drop-in),
2. raw files cached under ``<root>/<name>/`` (MNIST-family IDX, CIFAR-10
   python pickle batches),
3. the always-available deterministic ``synthetic`` dataset (seeded class
   blobs) used by tests and offline smoke runs.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as np

__all__ = ["DATASETS", "get_train_dataset", "get_test_dataset", "parse_dataset"]


def _variants(base, ood=(1, 4, 8)):
    return {
        f"{base}/default": (base, "default", None),
        f"{base}/ood": (base, "ood", ood),
        f"{base}/imbalanced": (base, "imbalanced", ("exp", .5)),
        f"{base}/noisy_label": (base, "noisy_label", 0.1),
    }


DATASETS_DICT = {
    **_variants("mnist"),
    "mnist/shot_noise": ("mnist_corrupted/shot_noise", "corrupted", None),
    "mnist/impulse_noise": ("mnist_corrupted/impulse_noise", "corrupted", None),
    "mnist/spatter": ("mnist_corrupted/spatter", "corrupted", None),
    "mnist/glass_blur": ("mnist_corrupted/glass_blur", "corrupted", None),
    "mnist/zigzag": ("mnist_corrupted/zigzag", "corrupted", None),
    **_variants("kmnist"),
    **_variants("fashion_mnist"),
    "emnist/default": ("emnist/letters", "default", None),
    "emnist/ood": ("emnist/letters", "ood", (1, 4, 8)),
    "emnist/imbalanced": ("emnist/letters", "imbalanced", ("exp", .5)),
    "emnist/noisy_label": ("emnist/letters", "noisy_label", 0.1),
    **_variants("cifar10"),
    **{f"cifar10/{c}_{s}": (f"cifar10_corrupted/{c}_{s}", "corrupted", None)
       for c in ["fog", "impulse_noise", "shot_noise", "spatter", "frost", "snow"]
       for s in [1, 5]},
    "svhn/default": ("svhn_cropped", "default", None),
    "svhn/ood": ("svhn_cropped", "ood", (1, 4, 8)),
    "svhn/imbalanced": ("svhn_cropped", "imbalanced", ("exp", .5)),
    "svhn/noisy_label": ("svhn_cropped", "noisy_label", 0.1),
    # Offline-friendly synthetic datasets (ours; not in the reference).
    # synthetic32 is the CIFAR-shaped (32x32x3) variant: it exercises the
    # fused 32x32 Pallas conv kernels in the classification pipeline with no
    # cached data.
    **_variants("synthetic", ood=(1, 2)),
    **_variants("synthetic32", ood=(1, 2)),
}

DATASETS = list(DATASETS_DICT.keys())

DATASET_FORMATTER = {
    "ood": lambda option: ",".join(map(str, option)),
    "imbalanced": lambda option: f"{option[0]}{option[1]}",
    "noisy_label": lambda option: str(option),
}


def permute_dataset(x, y, seed=0):
    from snngp_torch.data import permute_dataset as _canonical
    return _canonical(x, y, seed=seed)


def _one_hot(y, num_class):
    """``jax.nn.one_hot`` as float32 numpy."""
    return np.eye(num_class, dtype=np.float32)[y]


def get_num_class_data(num_data_per_class, num_class, mode="exp", factor=1):
    """Per-class counts for the imbalanced transform (data.py:78-88)."""
    if mode == "exp":
        d = np.exp(np.arange(num_class) * factor)
    elif mode == "step":
        d = np.arange(0, num_class) + 1 / factor
    else:
        raise ValueError("Unknown mode")
    d = d / np.max(d) * num_data_per_class
    return np.round(d).astype(int).tolist()


def parse_dataset(name):
    """Name grammar: base[/detail[/option]] (data.py:91-130)."""
    tokens = name.split("/")
    base_name = tokens[0]
    detail_name = tokens[1] if len(tokens) > 1 else "default"
    option = None

    if len(tokens) > 2:
        if detail_name == "ood":
            try:
                option = list(map(int, tokens[2].split(",")))
            except Exception:
                raise ValueError(f"Invalid OOD option: {tokens[2]}")
        elif detail_name == "imbalanced":
            if tokens[2].startswith("exp"):
                option = ("exp", float(tokens[2][3:]))
            elif tokens[2].startswith("step"):
                option = ("step", float(tokens[2][4:]))
            else:
                raise ValueError(f"Invalid imbalanced option {tokens[2]}")
        elif detail_name == "noisy_label":
            try:
                option = float(tokens[2])
            except Exception:
                raise ValueError(f"Invalid noisy label option: {tokens[2]}")

    dname = f"{base_name}/{detail_name}"
    if dname not in DATASETS_DICT:
        raise ValueError(f"Unsupported dataset: {dname}")

    base, detail, default_option = DATASETS_DICT[dname]
    if option is None:
        option = default_option
    clean_name = dname
    if option is not None:
        clean_name += "/" + DATASET_FORMATTER[detail](option)
    return (base, detail, option), clean_name


def normalize_dataset(name, x_data):
    """Fixed channel stats (data.py:133-146); synthetic uses the MNIST stats."""
    if "mnist" in name or "synthetic" in name:
        x_mean, x_std = np.array((0.5,)), np.array((0.5,))
    elif "cifar" in name or "svhn" in name:
        x_mean = np.array((0.4914, 0.4822, 0.4465))
        x_std = np.array((0.2023, 0.1994, 0.2010))
    else:
        return x_data
    edim = list(range(x_data.ndim - 1))
    x_mean = np.expand_dims(x_mean, axis=edim)
    x_std = np.expand_dims(x_std, axis=edim)
    return (x_data - x_mean) / x_std


# ---------------------------------------------------------------------------
# Raw loading backends
# ---------------------------------------------------------------------------

_SYNTH_CLASSES = 10
_SYNTH_SHAPE = (8, 8, 1)


def _load_synthetic(split, shape=_SYNTH_SHAPE):
    """Deterministic class-blob images in [0, 255] uint8-like floats.

    Blob centers/radii scale with resolution so the 8x8 stream stays
    bit-identical to round 1 while 32x32x3 gives a CIFAR-shaped workload.
    """
    # Pool sizes are part of the synthetic RNG-stream contract (tests pin
    # values at the defaults); SNNGP_SYNTH_N grows the train pool for
    # design-scale benchmarking (a different n is a DIFFERENT stream — the
    # per-class draws interleave differently).
    n = (int(os.environ.get("SNNGP_SYNTH_N", "4096"))
         if split == "train" else 1024)
    seed = 1234 if split == "train" else 4321
    rs = np.random.RandomState(seed)
    labels = rs.randint(_SYNTH_CLASSES, size=n)
    h, w, c = shape
    s = h / 8.0
    yy, xx = np.mgrid[0:h, 0:w]
    imgs = np.zeros((n, h, w, c), np.float64)
    for ci in range(_SYNTH_CLASSES):
        cy, cx = divmod(ci, 4)
        blob = np.exp(-(((yy - s * (1.5 + 2 * cy)) ** 2
                         + (xx - s * (1.5 + 2 * cx)) ** 2) / (4.0 * s * s)))
        mask = labels == ci
        imgs[mask] = blob[None, :, :, None] * 255.0
    imgs += rs.normal(scale=16.0, size=imgs.shape)
    imgs = np.clip(imgs, 0, 255)
    return imgs.astype(np.uint8), labels.astype(np.int64), _SYNTH_CLASSES


def _read_idx(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zero, dtype, dims = struct.unpack(">HBB", f.read(4))
        shape = struct.unpack(">" + "I" * dims, f.read(4 * dims))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


_MNIST_FILES = {
    "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}

# EMNIST distributes IDX files with a per-split prefix naming scheme.
_EMNIST_FILES = {
    "train": ("emnist-letters-train-images-idx3-ubyte",
              "emnist-letters-train-labels-idx1-ubyte"),
    "test": ("emnist-letters-test-images-idx3-ubyte",
             "emnist-letters-test-labels-idx1-ubyte"),
}


def _load_idx_dir(dirpath, split, names=None, num_class=10, label_offset=0):
    imgs_name, labels_name = (names or _MNIST_FILES)[split]
    for suffix in ("", ".gz"):
        ip = os.path.join(dirpath, imgs_name + suffix)
        lp = os.path.join(dirpath, labels_name + suffix)
        if os.path.isfile(ip) and os.path.isfile(lp):
            x = _read_idx(ip)[..., None]
            y = _read_idx(lp).astype(np.int64) + label_offset
            return x, y, num_class
    raise FileNotFoundError(f"no IDX files for split {split} under {dirpath}")


def _load_cifar10_dir(dirpath, split):
    batch_dir = os.path.join(dirpath, "cifar-10-batches-py")
    if not os.path.isdir(batch_dir):
        batch_dir = dirpath
    names = ([f"data_batch_{i}" for i in range(1, 6)] if split == "train"
             else ["test_batch"])
    xs, ys = [], []
    for nm in names:
        with open(os.path.join(batch_dir, nm), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        ys.append(np.array(d[b"labels"], np.int64))
    return np.concatenate(xs), np.concatenate(ys), 10


def _load_raw(base, split, root):
    """(images uint8 [N,H,W,C], labels int [N], num_class)."""
    if base == "synthetic":
        return _load_synthetic(split)
    if base == "synthetic32":
        return _load_synthetic(split, shape=(32, 32, 3))

    try:
        import tensorflow_datasets as tfds  # optional
        ds_builder = tfds.builder(base)
        ds, = tfds.as_numpy(tfds.load(
            base, data_dir=root, split=[split], batch_size=-1,
            as_dataset_kwargs=dict(shuffle_files=False)))
        return (ds["image"], ds["label"],
                ds_builder.info.features["label"].num_classes)
    except ImportError:
        pass

    local = os.path.join(os.path.expanduser(root), base.replace("/", "_"))
    if base in ("mnist", "kmnist", "fashion_mnist") or base.startswith("mnist_corrupted"):
        return _load_idx_dir(local, split)
    if base == "emnist/letters":
        # EMNIST labels are 1-indexed (1..26) with 37 tfds classes for the
        # letters config; shift to 0-based with 26 classes for raw files.
        return _load_idx_dir(local, split, names=_EMNIST_FILES,
                             num_class=26, label_offset=-1)
    if base == "cifar10":
        return _load_cifar10_dir(local, split)
    if base == "svhn_cropped":
        return _load_svhn_dir(local, split)
    raise RuntimeError(
        f"tensorflow_datasets unavailable and no local files for '{base}' under "
        f"{local}; cache the raw dataset there or use 'synthetic'")


def _load_svhn_dir(dirpath, split):
    """SVHN cropped-digits .mat files (train_32x32.mat / test_32x32.mat)."""
    from scipy.io import loadmat
    mat = loadmat(os.path.join(dirpath, f"{split}_32x32.mat"))
    x = np.transpose(mat["X"], (3, 0, 1, 2))        # [N, 32, 32, 3]
    y = mat["y"].reshape(-1).astype(np.int64) % 10  # label '10' means digit 0
    return x, y, 10


# ---------------------------------------------------------------------------
# Public API (train/test pipelines, data.py:149-259)
# ---------------------------------------------------------------------------

def get_train_dataset(name, root="./data", num_data=None, valid_prop=0.1,
                      normalize=True, onehot=False, seed=0):
    (base, detail, option), clean_name = parse_dataset(name)
    x_data, y_data, num_class = _load_raw(base, "train", root)
    x_data = x_data / 255.
    y_data = np.array(y_data)

    debug_msg = ""

    if detail == "noisy_label":
        noise_prob = option
        idx = (np.random.RandomState(seed).uniform(size=y_data.shape[0]) < noise_prob)
        noise_label = np.random.RandomState(seed).randint(num_class, size=np.sum(idx))
        y_data[idx] = noise_label
        debug_msg = f"{np.sum(idx)} / {y_data.shape[0]} (noisy labels)"
    elif detail == "ood":
        out_labels = option
        idx = np.all(np.vstack([(y_data != label)[None, :] for label in out_labels]), axis=0)
        x_data, y_data = x_data[idx], y_data[idx]
        data_in_class = [str(np.sum(y_data == label)) for label in range(num_class)]
        debug_msg = str(data_in_class) + " (data / class)"

    x_data, y_data = permute_dataset(x_data, y_data, seed=seed)

    if num_data is None:
        num_data = x_data.shape[0]

    if detail == "imbalanced":
        mode, factor = option
        data_class = []
        for class_idx in range(num_class):
            idx = y_data == class_idx
            data_class.append((x_data[idx], y_data[idx]))
        min_per_class = min(v[0].shape[0] for v in data_class)
        num_train_per_class = int(min_per_class * (1 - valid_prop))
        num_valid_per_class = min_per_class - num_train_per_class
        num_class_data = get_num_class_data(min_per_class, num_class,
                                            mode=mode, factor=factor)
        num_valid = num_class * num_valid_per_class
        if num_valid:
            x_valid = np.concatenate([x[-num_valid_per_class:] for (x, _) in data_class])
            y_valid = np.concatenate([y[-num_valid_per_class:] for (_, y) in data_class])
        x_train = np.concatenate([x[:nt] for nt, (x, _) in zip(num_class_data, data_class)])
        y_train = np.concatenate([y[:nt] for nt, (_, y) in zip(num_class_data, data_class)])
        x_train, y_train = permute_dataset(x_train, y_train, seed=seed)
        if num_valid:
            data_in_class = [str(np.sum(y_train == l) + np.sum(y_valid == l))
                             for l in range(num_class)]
        else:
            data_in_class = [str(np.sum(y_train == l)) for l in range(num_class)]
        debug_msg = str(data_in_class) + " (data / class)"
    else:
        num_valid = int(num_data * valid_prop)
        num_train = num_data - num_valid
        x_train, y_train = x_data[:num_train], y_data[:num_train]
        if num_valid:
            x_valid, y_valid = x_data[-num_valid:], y_data[-num_valid:]

    if normalize:
        x_train = normalize_dataset(clean_name, x_train)
        if num_valid:
            x_valid = normalize_dataset(clean_name, x_valid)

    if onehot:
        y_train = _one_hot(y_train, num_class)
        if num_valid:
            y_valid = _one_hot(y_valid, num_class)

    if num_valid:
        return (x_train, y_train), (x_valid, y_valid), (num_class, clean_name, debug_msg)
    return (x_train, y_train), (num_class, clean_name, debug_msg)


def get_test_dataset(name, root="./data", num_data=None, normalize=True, onehot=False):
    (base, detail, _), clean_name = parse_dataset(name)
    if detail in ["ood", "imbalanced", "noisy_label"]:
        raise KeyError(f"Test dataset doesn't support {detail} dataset")

    x_test, y_test, num_class = _load_raw(base, "test", root)
    x_test = x_test / 255.
    y_test = np.array(y_test)

    if num_data is not None:
        x_test, y_test = permute_dataset(x_test, y_test, seed=109)
        x_test, y_test = x_test[:num_data], y_test[:num_data]

    if normalize:
        x_test = normalize_dataset(clean_name, x_test)

    if onehot:
        y_test = _one_hot(y_test, num_class)

    return (x_test, y_test), (num_class, clean_name)
