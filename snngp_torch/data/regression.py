"""Regression datasets: a numpy copy of ``snngp/data/regression.py``
(importing ``snngp.data`` pulls in JAX), tested to give byte-identical
arrays. The one change: ``pandas`` is imported only by the loaders of UCI
text tables, so the synthetic datasets load without it.

The JAX package's notes on the datasets follow.

Regression datasets (rebuilds ``experiments/regression/data.py``).

13 datasets: 11 real (UCI/OpenML/sic97, downloaded on demand) + 2 synthetic
GP draws with Normal / Student-t noise. The synthetic generators and the
permute/split/normalize pipeline reproduce the reference *bit-for-bit*
(fixed ``np.random.RandomState`` seeds; train-stat normalization with
``nan_to_num``; ``data.py:219-295``) — parity of every downstream number
depends on identical data order.

Network-restricted environments: downloads degrade to a clear error naming
the file to place under ``<root>/<name>/``; the synthetic datasets and any
locally cached files always work.
"""

from __future__ import annotations

import math
import os
import urllib.request
import zipfile

import numpy as np

__all__ = ["DATASETS", "get_dataset", "permute_dataset", "split_dataset"]

DATASETS = [
    "boston", "concrete", "energy", "kin8nm", "naval", "plant",
    "wine-red", "wine-white", "yacht", "airfoil", "sic97",
    "syn-normal", "syn-t",
]

DATASET_URLS = {
    "concrete": {
        "Concrete_Data.xls": "http://archive.ics.uci.edu/ml/machine-learning-databases/concrete/compressive/Concrete_Data.xls",
    },
    "energy": {
        "ENB2012_data.xlsx": "http://archive.ics.uci.edu/ml/machine-learning-databases/00242/ENB2012_data.xlsx",
    },
    "kin8nm": {
        "dataset_2175_kin8nm.csv": "https://www.openml.org/data/get_csv/3626/dataset_2175_kin8nm.csv",
    },
    "naval": {
        "UCI CBM Dataset.zip": "http://archive.ics.uci.edu/ml/machine-learning-databases/00316/UCI%20CBM%20Dataset.zip",
    },
    "plant": {
        "CCPP.zip": "http://archive.ics.uci.edu/ml/machine-learning-databases/00294/CCPP.zip",
    },
    "wine": {
        "winequality-red.csv": "http://archive.ics.uci.edu/ml/machine-learning-databases/wine-quality/winequality-red.csv",
        "winequality-white.csv": "http://archive.ics.uci.edu/ml/machine-learning-databases/wine-quality/winequality-white.csv",
    },
    "yacht": {
        "yacht_hydrodynamics.data": "http://archive.ics.uci.edu/ml/machine-learning-databases/00243/yacht_hydrodynamics.data",
    },
    "airfoil": {
        "airfoil_self_noise.dat": "https://archive.ics.uci.edu/ml/machine-learning-databases/00291/airfoil_self_noise.dat",
    },
    "sic97": {
        "sic97data_01.zip": "https://wiki.52north.org/pub/AI_GEOSTATS/AI_GEOSTATSData/sic97data_01.zip",
    },
}


def _download_url(url: str, filepath: str) -> None:
    try:
        print(f"Download {url} to {filepath}")
        urllib.request.urlretrieve(url, filepath)
    except Exception:
        if url.startswith("https"):
            # https -> http fallback (reference data.py:83-94).
            urllib.request.urlretrieve(url.replace("https:", "http:", 1), filepath)
        else:
            raise


def _download_dataset(name: str, root: str, needs: str = None) -> None:
    """Fetch ``name``'s registry files unless ``needs`` (the repo-relative
    file the loader actually reads — e.g. a zip's extracted member, or a
    local CSV conversion of an Excel original) already exists."""
    root = os.path.expanduser(root)
    if needs is not None:
        target = os.path.join(root, needs)
        if (os.path.exists(target) or os.path.exists(target + ".csv")
                or os.path.exists(os.path.splitext(target)[0] + ".csv")):
            return
    path = os.path.join(root, name)
    os.makedirs(path, exist_ok=True)
    for filename, url in DATASET_URLS[name].items():
        filepath = os.path.join(path, filename)
        # A local CSV conversion next to an Excel original satisfies the
        # loader (_read_excel_or_csv) — don't force a download over it.
        if any(os.path.isfile(c) for c in
               (filepath + ".csv", os.path.splitext(filepath)[0] + ".csv")):
            continue
        if not os.path.isfile(filepath):
            try:
                _download_url(url, filepath)
            except Exception as e:
                raise RuntimeError(
                    f"Could not download {url}; place the file manually at "
                    f"{filepath} (offline environment?)") from e
            if filename.endswith(".zip"):
                with zipfile.ZipFile(filepath, "r") as z:
                    z.extractall(path)


def _parse_boston_file(path: str):
    """Parse a local Boston Housing dump into (x [N,13], y [N]).

    Accepts both historical layouts (both reduce to a stream of numeric
    tokens in 14-column records — 13 features then MEDV):

    - UCI ``housing.data``: one record per line, 14 whitespace-separated
      fixed-width columns;
    - StatLib ``boston`` dump: a prose header followed by records wrapped
      over two lines (11 + 3 values).

    Non-numeric (header/prose) lines are skipped; the surviving numeric
    tokens must form complete 14-column records.
    """
    values = []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            try:
                row = [float(t) for t in toks]
            except ValueError:
                continue  # header / prose line
            values.extend(row)
    if not values or len(values) % 14 != 0:
        raise RuntimeError(
            f"{path} does not parse as 14-column Boston Housing records "
            f"(got {len(values)} numeric values)")
    data = np.asarray(values, dtype=np.float64).reshape(-1, 14)
    return data[:, :13], data[:, 13]


def _load_boston(root: str = "./data"):
    """Boston Housing (reference: ``sklearn.datasets.load_boston``,
    ``experiments/regression/data.py:120-123``). sklearn >= 1.2 removed the
    loader, so reconstruct from a locally cached original-source file:
    ``<root>/boston/housing.data`` (UCI) or ``<root>/boston/boston``
    (StatLib), falling back to legacy sklearn when present."""
    root = os.path.expanduser(root)
    for fname in ("housing.data", "boston", "boston.txt"):
        path = os.path.join(root, "boston", fname)
        if os.path.isfile(path):
            return _parse_boston_file(path)
    try:
        from sklearn.datasets import load_boston  # noqa: removed in >= 1.2
        return load_boston(return_X_y=True)
    except ImportError:
        pass
    raise RuntimeError(
        "load_boston removed from sklearn and no local copy found; place "
        f"housing.data under {os.path.join(root, 'boston')}/ "
        "(original UCI or StatLib layout both parse)")


def _read_excel_or_csv(path: str):
    """``pd.read_excel`` with a CSV fallback: environments without an Excel
    engine (xlrd/openpyxl are not in this image) can place a one-time CSV
    conversion next to the original (same name, ``.csv`` suffix appended or
    extension swapped) and the loader slices identical columns."""
    import pandas as pd
    for cand in (path + ".csv", os.path.splitext(path)[0] + ".csv"):
        if not os.path.exists(path) and os.path.exists(cand):
            return pd.read_csv(cand)
    try:
        return pd.read_excel(path)
    except ImportError:
        for cand in (path + ".csv", os.path.splitext(path)[0] + ".csv"):
            if os.path.exists(cand):
                return pd.read_csv(cand)
        raise


_PANDAS_TABLES = ("kin8nm", "naval", "wine-red", "wine-white", "yacht",
                  "airfoil", "sic97")


def get_dataset(name: str, root: str = "./data"):
    if name in _PANDAS_TABLES:
        import pandas as pd

    if name == "boston":
        x, y = _load_boston(root)

    elif name == "concrete":
        _download_dataset(name, root, needs="concrete/Concrete_Data.xls")
        data = _read_excel_or_csv(os.path.join(root, "concrete/Concrete_Data.xls")).to_numpy()
        x, y = data[:, :8], data[:, 8]

    elif name == "energy":
        _download_dataset(name, root, needs="energy/ENB2012_data.xlsx")
        data = _read_excel_or_csv(os.path.join(root, "energy/ENB2012_data.xlsx")).to_numpy()
        x, y = data[:, :8], data[:, 8]

    elif name == "kin8nm":
        _download_dataset(name, root, needs="kin8nm/dataset_2175_kin8nm.csv")
        data = pd.read_csv(os.path.join(root, "kin8nm/dataset_2175_kin8nm.csv")).to_numpy()
        x, y = data[:, :8], data[:, 8]

    elif name == "naval":
        _download_dataset(name, root, needs="naval/UCI CBM Dataset/data.txt")
        data = pd.read_table(os.path.join(root, "naval/UCI CBM Dataset/data.txt"),
                             sep=r"\s+").to_numpy()
        x, y = data[:, :16], data[:, 16]

    elif name == "plant":
        _download_dataset(name, root, needs="plant/CCPP/Folds5x2_pp.xlsx")
        data = _read_excel_or_csv(os.path.join(root, "plant/CCPP/Folds5x2_pp.xlsx")).to_numpy()
        x, y = data[:, :4], data[:, 4]

    elif name in ("wine-red", "wine-white"):
        _download_dataset("wine", root, needs="wine/winequality-red.csv" if name == "wine-red" else "wine/winequality-white.csv")
        fname = "winequality-red.csv" if name == "wine-red" else "winequality-white.csv"
        data = pd.read_csv(os.path.join(root, "wine", fname), delimiter=";").to_numpy()
        x, y = data[:, :11], data[:, 11]

    elif name == "yacht":
        _download_dataset(name, root, needs="yacht/yacht_hydrodynamics.data")
        data = pd.read_table(os.path.join(root, "yacht/yacht_hydrodynamics.data"),
                             sep=r"\s+").to_numpy()
        x, y = data[:, :6], data[:, 6]

    elif name == "airfoil":
        _download_dataset(name, root, needs="airfoil/airfoil_self_noise.dat")
        data = pd.read_table(os.path.join(root, "airfoil/airfoil_self_noise.dat"),
                             sep=r"\s+", header=None).to_numpy()
        x, y = data[:, :5], data[:, 5]

    elif name == "sic97":
        _download_dataset(name, root, needs="sic97/sic_full.dat")
        data = pd.read_table(os.path.join(root, "sic97/sic_full.dat"), sep=",",
                             index_col=0, skiprows=6, header=None).to_numpy()
        x, y = data[:, :2], data[:, 2]

    elif name == "syn-normal":
        # GP draw with RBF kernel + Normal(0, 0.2) noise (data.py:219-226).
        num = 100
        rs = np.random.RandomState(829)
        x = np.linspace(-num / 2, num / 2, num)[:, None]
        cov = np.exp(-0.5 * (x - x.T) ** 2)
        y = rs.multivariate_normal(mean=np.zeros(num), cov=cov, size=1).flatten() \
            + rs.standard_normal(size=num) * 0.2

    elif name == "syn-t":
        # GP draw + Student-t(df=1) * 0.8 noise (data.py:228-236).
        num = 300
        rs = np.random.RandomState(761)
        x = np.linspace(-num / 2, num / 2, num)[:, None]
        cov = np.exp(-0.5 * (x - x.T) ** 2)
        y = rs.multivariate_normal(mean=np.zeros(num), cov=cov, size=1).flatten() \
            + rs.standard_t(df=1, size=num) * 0.8

    else:
        raise KeyError(f"Unsupported dataset '{name}'")

    return x, y


def split_dataset(x, y, train, valid, test, normalize_x=True, normalize_y=True):
    """0.8/0.1/0.1 split with train-stat normalization (data.py:244-289)."""
    fractions = train + valid + test
    if not math.isclose(fractions, 1.0) and fractions > 1.0:
        raise ValueError("Sum of fractions exceed 1.0")

    train_num = int(train * len(x))
    valid_num = int(valid * len(x))
    x_train, y_train = x[:train_num], y[:train_num]
    x_valid, y_valid = x[train_num: train_num + valid_num], y[train_num: train_num + valid_num]
    if math.isclose(fractions, 1.0):
        x_test, y_test = x[train_num + valid_num:], y[train_num + valid_num:]
    else:
        test_num = int(test * len(x))
        x_test = x[train_num + valid_num: train_num + valid_num + test_num]
        y_test = y[train_num + valid_num: train_num + valid_num + test_num]

    if normalize_x:
        x_std = np.std(x_train, axis=0)
        x_mean = np.mean(x_train, axis=0)
        x_train = np.nan_to_num((x_train - x_mean) / x_std)
        x_valid = np.nan_to_num((x_valid - x_mean) / x_std)
        x_test = np.nan_to_num((x_test - x_mean) / x_std)

    if normalize_y:
        y_std = np.std(y_train, axis=0)
        y_mean = np.mean(y_train, axis=0)
        y_train = (y_train - y_mean) / y_std
        y_valid = (y_valid - y_mean) / y_std
        y_test = (y_test - y_mean) / y_std
    else:
        y_std, y_mean = 1.0, 0.0

    return (x_train, y_train), (x_valid, y_valid), (x_test, y_test), (y_std, y_mean)


def permute_dataset(x, y, seed=0):
    """Seeded permutation (data.py:292-295)."""
    from snngp_torch.data import permute_dataset as _canonical
    return _canonical(x, y, seed=seed)
