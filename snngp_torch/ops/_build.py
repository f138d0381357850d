"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers) and is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under the
repository's ``build/kernels/`` directory, keyed by a hash of the source, the
``csrc/*.cuh`` headers and the flags, so an edited source or header rebuilds
and an unchanged one loads at once.
``nvcc``'s output (including ``-Xptxas -v``: registers, shared memory and
spills per kernel) is kept beside the library as ``.log``;
:func:`ptxas_report` reads it.

Nothing here runs at import: a machine without ``nvcc`` imports the port and
uses the plain PyTorch versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load", "library_path", "build_variant", "ptxas_report", "parse_ptxas",
           "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# No --use_fast_math: it changes sqrtf / division / acosf accuracy, and the
# kernels are held to fp32 parity with their plain versions. No implicit
# conversion between __nv_bfloat16 and float: a bf16 state converts only by
# the intrinsics (__float2bfloat16_rn, __bfloat162float), where it rounds.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-D__CUDA_NO_BFLOAT16_CONVERSIONS__")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built on this machine")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, for its current source, the
    headers beside it and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` unless its library exists, then load it."""
    out = library_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return ctypes.CDLL(str(out))


def build_variant(name: str, constants: dict, out: Path):
    """A copy of ``csrc/<name>.cu`` with each ``constexpr int <NAME> = <n>;``
    of ``constants`` set to its value, built into the library ``out`` (the
    copy beside it) and loaded: (the library, its :func:`ptxas_report`
    lines). For tools that time other build constants, such as a kernel's
    ``__launch_bounds__`` minimum blocks."""
    src = (CSRC / f"{name}.cu").read_text()
    for constant, value in constants.items():
        src, count = re.subn(rf"constexpr int {constant} = \d+;",
                             f"constexpr int {constant} = {value};", src)
        if count != 1:
            raise RuntimeError(f"{name}.cu has no single {constant}")
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    cu = out.with_suffix(".cu")
    cu.write_text(src)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(out), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {cu.name}:\n{proc.stderr}")
    return ctypes.CDLL(str(out)), parse_ptxas(proc.stdout + proc.stderr)


def ptxas_report(name: str) -> list:
    """One line per kernel instantiation of ``csrc/<name>.cu``'s build, from
    the ``.log`` beside its library: the kernel with its template arguments
    if it has any (ints, and bools as 0 / 1), then ptxas's spill and
    register lines, e.g. ``conv_gram_kernel<0>: 0 bytes stack frame, ...;
    Used 48 registers, ...``. Empty if the library has no log."""
    log = library_path(name).with_suffix(".log")
    return parse_ptxas(log.read_text()) if log.exists() else []


def parse_ptxas(text: str) -> list:
    """:func:`ptxas_report`'s lines from the text of an ``nvcc -Xptxas -v``
    run."""
    entries = {}   # kernel<targs> -> its lines, in the log's order
    facts = None
    for line in text.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"([a-z_]+_kernel)(?:I((?:L\w\d+E)+)E)?", line)
            targs = f"<{', '.join(re.findall(r'L\w(\d+)E', m[2]))}>" if m and m[2] else ""
            facts = entries.setdefault(m[1] + targs, []) if m else None
        elif facts is not None and ("registers" in line or "spill" in line):
            facts.append(line.split(":", 1)[-1].strip())
    return [f"{entry}: {'; '.join(facts)}" for entry, facts in entries.items()]
