"""The benchmark's frozen counters against ``chip_smoke.py``'s, at the
shapes of the three cells (CPU)."""

import json
import sys
from pathlib import Path

import pytest
import torch

from benchmark import counts as C

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def _config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


MLP = _config("mlp4-t")
N, D, DEPTH = MLP["data"]["num_train"], MLP["data"]["num_features"], MLP["model"]["num_hiddens"]
MYRTLE = _config("myrtle5-t")
NI, NB = MYRTLE["model"]["num_inducing"], MYRTLE["train"]["batch"]
H, _, CH = MYRTLE["data"]["image"]
M = round(N * 0.125)   # a request: the test split of the 0.8 / 0.1 / 0.1 split
# (n1, n2, same): K(x, x) of ML-II, a request's cross and test Grams, two
# shapes off the tile grid, and the three Gram blocks of an ELBO step.
GRAM_SHAPES = [(N, N, True), (M, N, False), (M, M, True), (64, N, False),
               (4096, 4096, True)]
MYRTLE_SHAPES = [(NI, NI, True), (NB, NI, False), (NB, NB, True)]


@pytest.mark.parametrize("n1,n2,same", GRAM_SHAPES)
def test_k1_k2_ops_match_the_smoke(smoke, n1, n2, same):
    assert C.k1_ops(n1, n2, D, DEPTH, "relu", "mlp", same) == smoke.k1_ops(
        n1, n2, D, DEPTH, "relu", "mlp", same)
    assert C.k2_ops(n1, n2, D, DEPTH, "relu", "mlp", same) == smoke.k2_ops(
        n1, n2, D, DEPTH, "relu", "mlp", same)


@pytest.mark.parametrize("n1,n2,same", MYRTLE_SHAPES)
@pytest.mark.parametrize("tangents", [0, 2])
def test_k7_ops_match_the_smoke(smoke, n1, n2, same, tangents):
    assert C.k7_ops(n1, n2, H, CH, 5, "relu", same, tangents) == smoke.k7_ops(
        n1, n2, H, CH, 5, "relu", same, tangents)


def test_peaks_and_bound_match_the_smoke(smoke):
    assert (C.H100_BYTES_PER_S, C.H100_FP32_PER_S, C.H100_FP64_PER_S, C.H100_BF16_PER_S) == (
        smoke.H100_BYTES_PER_S, smoke.H100_FP32_PER_S, smoke.H100_FP64_PER_S,
        smoke.H100_BF16_PER_S)
    for args in [(1e9, 1e12), (1e12, 1e9, 1e9), (5e8, 3e11, 2e10, 0)]:
        assert C.least_s(*args) * 1e3 == pytest.approx(smoke.bound_ms(*args)[0], rel=1e-12)


@pytest.mark.parametrize("n1,n2,same", GRAM_SHAPES[:3] + [(1001, 333, False)])
def test_k1_k2_bytes_match_the_smokes_tensors(smoke, n1, n2, same):
    """The bytes from shapes equal ``_read_bytes`` of the tensors the smoke
    hands K1 and K2, plus their outputs."""
    x1 = torch.empty(n1, D)
    x2 = x1 if same else torch.empty(n2, D)
    v1 = torch.empty(DEPTH + 1, n1)
    v2 = v1 if same else torch.empty(DEPTH + 1, n2)
    k1_in = [x1, x2, v1, v2, torch.empty(4)]
    assert C.k1_bytes(n1, n2, D, DEPTH, same) == smoke._read_bytes(k1_in) + n1 * n2 * 4
    dv1 = torch.empty(DEPTH + 1, 2, n1)
    dv2 = dv1 if same else torch.empty(DEPTH + 1, 2, n2)
    k2_in = [x1, x2, v1, v2, dv1, dv2, torch.empty(7)]
    partials = 3 * C._tiles(n1, n2, same) * 8      # K2's fp64 partial sums a block
    assert C.k2_bytes(n1, n2, D, DEPTH, same) == (smoke._read_bytes(k2_in) + n1 * n2 * 4
                                                   + partials)


def test_tiles_follow_the_launch_grid():
    """csrc/gram.cu ``launch_blocks``: 64 x 64 tiles, the lower triangle's
    for K(x, x)."""
    assert C._tiles(10_000, 10_000, True) == 157 * 158 // 2
    assert C._tiles(4096, 10_000, False) == 64 * 157
    assert C._tiles(65, 1, False) == 2


@pytest.mark.parametrize("h", [8, 16, 32])
def test_myrtle_profile_len_matches_the_port(h):
    from snngp_torch.ops import myrtle_gram as MG
    assert C.myrtle_profile_len(h, 5) == MG._profile_len(h, 5)
    assert C.MYRTLE_GROUPS == MG.MYRTLE_GROUPS


@pytest.mark.parametrize("n1,n2,same", MYRTLE_SHAPES)
@pytest.mark.parametrize("tangents", [0, 2])
def test_k7_bytes_match_the_smokes_tensors(smoke, n1, n2, same, tangents):
    p = C.myrtle_profile_len(H, 5)
    x1 = torch.empty(n1, H, H, CH)
    x2 = x1 if same else torch.empty(n2, H, H, CH)
    p1 = torch.empty(n1, p)
    p2 = p1 if same else torch.empty(n2, p)
    args = [x1, x2, p1, p2]
    if tangents:
        d1 = torch.empty(n1, 2, p)
        args += [d1, d1 if same else torch.empty(n2, 2, p), torch.empty(6)]
    else:
        args += [torch.empty(4)]
    outputs = 4 * n1 * n2 * (1 + tangents)
    assert C.k7_bytes(n1, n2, H, CH, 5, same, tangents) == smoke._read_bytes(args) + outputs


def test_kernel_names_map_to_their_keys():
    assert C.kernel_key("void gram_kernel<0, 0>(float const*, float*)") == "k1"
    assert C.kernel_key("void gram_grads_kernel<0, 0>(float const*)") == "k2"
    assert C.kernel_key("void myrtle_gram_kernel<0, 1, false>(Args)") == "k7_fwd"
    assert C.kernel_key("myrtle_gram_tangents_kernel(Args)") == "k7_wb"
    assert C.kernel_key("void conv_gram_kernel<0>(float const*)") is None
    assert C.kernel_key("ampere_sgemm_128x64_nn") is None


def test_the_algorithms_counts():
    assert C.cholesky_flops(3) == 9.0
    assert C.inverse_from_factor_flops(3) == 18.0
    assert C.trsm_flops(10, 4) == 400
    assert C.gemv_flops(10, 4) == 80
