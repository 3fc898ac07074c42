"""The port's CUDA build (``betty_tpu_torch/ops/_build.py``) with a stand-in
``nvcc``: one compiler process per source, started together, each library
keyed by the hash of its source and the headers it includes and reused, and
a failed build raising with the compiler's output and leaving nothing
behind."""

import os
import shutil
import stat

import pytest

from betty_tpu_torch.ops import _build

FAKE_NVCC = """#!/bin/sh
# writes the -o target and a ptxas-like line; fails when FAKE_NVCC_FAIL names the source
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift ;;
    *.cu) src="$1" ;;
  esac
  shift
done
case "$src" in *"$FAKE_NVCC_FAIL"*) echo "error in $src"; exit 1 ;; esac
echo "ptxas info    : Used 14 registers ($src)"
sleep 0.2
echo built > "$out"
"""


@pytest.fixture
def fake_cuda(tmp_path, monkeypatch):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("BETTY_TORCH_BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setenv("FAKE_NVCC_FAIL", "no-such-source")
    monkeypatch.setattr(_build, "BUILD_LOGS", {})
    monkeypatch.setattr(_build, "BUILD_SECONDS", {})
    return tmp_path / "kernels"


def test_build_all_builds_every_source_once(fake_cuda):
    assert _build.sources() == ["flash_multi", "flash_single", "vector_ops"]
    paths = _build.build_all()
    assert set(paths) == {"flash_multi", "flash_single", "vector_ops"}
    for name, path in paths.items():
        assert path.parent == fake_cuda and path.read_text() == "built\n"
        assert path.name.startswith(f"lib{name}_") and path.suffix == ".so"
        assert f"{name}.cu" in _build.BUILD_LOGS[name]
        assert 0.0 < _build.BUILD_SECONDS[name] < 60.0
    # the only files left are the three libraries
    assert sorted(os.listdir(fake_cuda)) == sorted(p.name for p in paths.values())
    # reused while the sources are unchanged: no second compile
    _build.BUILD_SECONDS.clear()
    assert _build.build_all() == paths and _build.BUILD_SECONDS == {}


def test_failed_build_raises_and_leaves_nothing(fake_cuda, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "vector_ops")
    with pytest.raises(RuntimeError, match="vector_ops.cu: nvcc failed"):
        _build.build_all()
    assert sorted(os.listdir(fake_cuda)) == sorted(
        _build.library_path(name).name for name in ("flash_multi", "flash_single"))


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of ``csrc`` that ``_build`` reads, free to edit."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setenv("BETTY_TORCH_BUILD_DIR", str(tmp_path / "kernels"))
    return csrc


def test_editing_a_header_changes_the_library_path(csrc_copy):
    """A library is keyed by its source and every header it includes, so an
    edited header is not served by a library built before the edit."""
    csrc = csrc_copy
    assert sorted(p.name for p in _build.source_files("flash_single")) == [
        "flash_common.cuh", "flash_fp32.cuh", "flash_mma.cuh", "flash_single.cu"]
    assert sorted(p.name for p in _build.source_files("flash_multi")) == [
        "flash_common.cuh", "flash_fp32.cuh", "flash_mma.cuh", "flash_multi.cu"]
    assert [p.name for p in _build.source_files("vector_ops")] == ["vector_ops.cu"]
    before = {name: _build.library_path(name) for name in _build.sources()}
    assert before == {name: _build.library_path(name) for name in _build.sources()}
    header = csrc / "flash_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.sources()}
    assert after["flash_multi"] != before["flash_multi"]
    assert after["flash_single"] != before["flash_single"]
    assert after["vector_ops"] == before["vector_ops"]


def test_editing_the_tensor_core_header_rebuilds_both_flash_libraries(csrc_copy):
    """``flash_mma.cuh`` is included by both flash sources (the bf16 B1 and
    B2 of ``flash_single.cu`` run on its bodies too): editing it changes
    both flash libraries' paths and leaves ``vector_ops``'s."""
    before = {name: _build.library_path(name) for name in _build.sources()}
    header = csrc_copy / "flash_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.sources()}
    assert after["flash_multi"] != before["flash_multi"]
    assert after["flash_single"] != before["flash_single"]
    assert after["vector_ops"] == before["vector_ops"]


def test_editing_the_fp32_header_rebuilds_flash_multi_only(csrc_copy):
    """``flash_fp32.cuh`` (the float32 bodies) is included by both flash
    sources (float32 B3-B5 in ``flash_multi.cu``, float32 B1 and B2 in
    ``flash_single.cu``): editing it changes both flash libraries' paths and
    leaves only ``vector_ops``'s."""
    before = {name: _build.library_path(name) for name in _build.sources()}
    header = csrc_copy / "flash_fp32.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.sources()}
    assert after["flash_multi"] != before["flash_multi"]
    assert after["flash_single"] != before["flash_single"]
    assert after["vector_ops"] == before["vector_ops"]
