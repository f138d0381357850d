"""The port's build helpers (snngp_torch/ops/_build.py) on the CPU: the
library key and the ptxas report, on a source tree and an nvcc log made
here (no nvcc is run)."""

import pytest

from snngp_torch.ops import _build

# nvcc's -Xptxas -v lines for three instantiations: int template arguments,
# a bool among them, and a kernel without any.
LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__e7d1_19_resnet_conv_gram_cu_7961\
18resnet_tail_kernelILi0ELi4ELb1EEEvPKfS2_S2_S2_PfiiNS_3GeoEi' for 'sm_90a'
ptxas info    : Function properties for _ZN52_GLOBAL__N__e7d1_19_resnet_conv_gram_cu_7961\
18resnet_tail_kernelILi0ELi4ELb1EEEvPKfS2_S2_S2_PfiiNS_3GeoEi
    56 bytes stack frame, 56 bytes spill stores, 112 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers, 56 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__65f2_7_gram_cu_b0d5\
11gram_kernelILi1ELi0EEEvPKfS2_S2_S2_S2_Pfiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__65f2_7_gram_cu_b0d5\
11gram_kernelILi1ELi0EEEvPKfS2_S2_S2_S2_Pfiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads

ptxas info    : Used 48 registers, used 1 barriers, 16896 bytes smem
ptxas info    : Compiling entry function '_Z12copy_kernelPKfPfi' for 'sm_90a'
ptxas info    : Function properties for _Z12copy_kernelPKfPfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 8 registers
"""

WANT = [
    "resnet_tail_kernel<0, 4, 1>: 56 bytes stack frame, 56 bytes spill stores, 112 bytes "
    "spill loads; Used 64 registers, used 0 barriers, 56 bytes cumulative stack size",
    "gram_kernel<1, 0>: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; "
    "Used 48 registers, used 1 barriers, 16896 bytes smem",
    "copy_kernel: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; "
    "Used 8 registers",
]


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A csrc/ with one source and one header, building into tmp_path."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "s.cuh"\n')
    (src / "s.cuh").write_text("// header\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


@pytest.mark.parametrize("line", range(len(WANT)),
                         ids=["bool-template", "int-template", "no-template"])
def test_ptxas_report_gives_each_instantiation_its_spills_and_registers(csrc, line):
    log = _build.library_path("k").with_suffix(".log")
    log.parent.mkdir(parents=True)
    log.write_text(LOG)
    report = _build.ptxas_report("k")
    assert len(report) == len(WANT)
    assert report[line] == WANT[line]


def test_ptxas_report_is_empty_without_a_build(csrc):
    assert _build.ptxas_report("k") == []


@pytest.mark.parametrize("edited", ["k.cu", "s.cuh"])
def test_library_key_follows_the_source_and_its_headers(csrc, edited):
    before = _build.library_path("k")
    assert before.parent == _build.BUILD_DIR and before.suffix == ".so"
    assert _build.library_path("k") == before
    (csrc / edited).write_text((csrc / edited).read_text() + "// edited\n")
    assert _build.library_path("k") != before


@pytest.mark.parametrize("constants", [{"kAbsent": 2}, {"kTwice": 2}])
def test_build_variant_edits_only_a_single_constant(csrc, tmp_path, constants):
    # A constant that is absent, or defined twice, is refused before nvcc runs.
    (csrc / "k.cu").write_text("constexpr int kTwice = 1;\nconstexpr int kTwice = 1;\n")
    with pytest.raises(RuntimeError, match="no single"):
        _build.build_variant("k", constants, tmp_path / "v" / "k.so")
    assert not (tmp_path / "v").exists()
