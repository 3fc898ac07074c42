"""A host compiler's syntax pass over the port's CUDA sources
(``betty_tpu_torch/csrc/*.cu``), for a machine without ``nvcc``: each
source and the headers beside it are copied with their kernel launches
(``<<<...>>>``) stripped, and ``g++ -std=c++17 -fsyntax-only`` parses them
against the stand-in CUDA headers of ``tests/cuda_stub``, which define the
execution-space keywords away and declare the runtime's types and device
intrinsics. Every template the C entry points instantiate is checked, so a
C++ typo shows here and not first in ``nvcc`` on the card. Inline PTX is
not checked (only ``nvcc`` reads it). Skips where ``g++`` is missing.

    python -m pytest tests/test_torch_csrc_syntax.py -q
"""

import re
import shutil
import subprocess
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parents[1] / "betty_tpu_torch" / "csrc"
STUBS = Path(__file__).resolve().parent / "cuda_stub"
LAUNCH = re.compile(r"<<<.*?>>>", re.S)  # launches span lines in the sources


@pytest.mark.parametrize("source", sorted(p.name for p in CSRC.glob("*.cu")))
def test_cuda_source_parses_with_host_compiler(source, tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    for path in list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")):
        (tmp_path / path.name).write_text(LAUNCH.sub("", path.read_text()))
    out = subprocess.run(
        [gxx, "-std=c++17", "-fsyntax-only", "-x", "c++", "-Wno-unknown-pragmas",
         "-I", str(STUBS), str(tmp_path / source)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr

