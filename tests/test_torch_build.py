"""The port's CUDA build (``betty_tpu_torch/ops/_build.py``) with a stand-in
``nvcc``: one compiler process per source, started together, each library
keyed by its source's hash and reused, and a failed build raising with the
compiler's output and leaving nothing behind."""

import os
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
    assert _build.sources() == ["flash_single", "vector_ops"]
    paths = _build.build_all()
    assert set(paths) == {"flash_single", "vector_ops"}
    for name, path in paths.items():
        assert path.parent == fake_cuda and path.read_text() == "built\n"
        assert path.name.startswith(f"lib{name}_") and path.suffix == ".so"
        assert f"{name}.cu" in _build.BUILD_LOGS[name]
        assert 0.0 < _build.BUILD_SECONDS[name] < 60.0
    # the only files left are the two libraries
    assert sorted(os.listdir(fake_cuda)) == sorted(p.name for p in paths.values())
    # reused while the sources are unchanged: no second compile
    _build.BUILD_SECONDS.clear()
    assert _build.build_all() == paths and _build.BUILD_SECONDS == {}


def test_failed_build_raises_and_leaves_nothing(fake_cuda, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "vector_ops")
    with pytest.raises(RuntimeError, match="vector_ops.cu: nvcc failed"):
        _build.build_all()
    assert sorted(os.listdir(fake_cuda)) == [_build.library_path("flash_single").name]
