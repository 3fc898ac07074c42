"""The kernels of ``betty_tpu_torch/csrc/*.cu`` against the lists in
``chip_smoke.py`` that decide which checks each kernel gets on the card:
``MMA_LIBS`` (tensor-core kernels: ``HMMA`` at every head dim, no spill at
D64) and ``FP32_KERNELS`` (float32 CUDA-core bodies: no spill, no
``HMMA``, at least 8 FFMA per shared load in every product loop). Every
name in those lists must be a ``__global__`` kernel of the library it is
listed under, and every flash kernel must be in one of them or in the
explicit list of kernels still on the first CUDA-core loops, so that a
redesigned kernel cannot escape the SASS and spill checks; the profile's
labels (``KERNEL_SYMBOLS``) must name every kernel. Parses the sources, on
the CPU."""

import re
from pathlib import Path

import pytest

import chip_smoke

CSRC = Path(__file__).resolve().parents[1] / "betty_tpu_torch" / "csrc"
KERNEL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
# float32 B1 and B2: the CUDA-core FMA loops of flash_common.cuh / flash_single.cu
CUDA_CORE_LOOPS = {"flash_single": ("fwd_kernel", "bwd_kernel")}
FLASH_LIBS = ("flash_multi", "flash_single")


def kernels(lib):
    return set(KERNEL.findall((CSRC / f"{lib}.cu").read_text()))


def test_sources_are_the_three_libraries():
    assert sorted(p.stem for p in CSRC.glob("*.cu")) == ["flash_multi", "flash_single",
                                                        "vector_ops"]


@pytest.mark.parametrize("lib", FLASH_LIBS)
def test_tensor_core_list_names_kernels_of_its_library(lib):
    listed = chip_smoke.MMA_LIBS[lib]
    assert listed and set(listed) <= kernels(lib), (listed, kernels(lib))


def test_fp32_list_names_kernels_of_flash_multi():
    """``sass_report`` reads FP32_KERNELS from flash_multi's SASS."""
    assert set(chip_smoke.FP32_KERNELS) <= kernels("flash_multi")


@pytest.mark.parametrize("lib", FLASH_LIBS)
def test_every_flash_kernel_gets_a_check(lib):
    checked = (set(chip_smoke.MMA_LIBS.get(lib, ())) | set(chip_smoke.FP32_KERNELS)
               | set(CUDA_CORE_LOOPS.get(lib, ())))
    assert kernels(lib) == kernels(lib) & checked, kernels(lib) - checked


@pytest.mark.parametrize("lib", FLASH_LIBS)
def test_no_kernel_is_in_two_lists(lib):
    lists = (set(chip_smoke.MMA_LIBS.get(lib, ())), set(chip_smoke.FP32_KERNELS),
             set(CUDA_CORE_LOOPS.get(lib, ())))
    assert sum(len(x) for x in lists) == len(set().union(*lists))


@pytest.mark.parametrize("lib", FLASH_LIBS + ("vector_ops",))
def test_profile_labels_every_kernel(lib):
    assert kernels(lib) <= set(chip_smoke.KERNEL_SYMBOLS), kernels(lib) - set(
        chip_smoke.KERNEL_SYMBOLS)
