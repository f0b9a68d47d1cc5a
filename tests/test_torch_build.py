"""ops/build.py names each kernel library by a hash of what it is built
from: the source, every shared header `csrc/*.cuh` and the nvcc flags. A
header edit must change the name of every library, or a stale `.so` in
`_build/` would be loaded. These tests run without nvcc: they only compute
names."""

import shutil

import pytest

from acezero_tpu_torch.ops import build
from acezero_tpu_torch.ops import fused_head as fh

KERNELS = (fh.KERNEL, fh.KERNEL_BWD)


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    d = tmp_path / "csrc"
    d.mkdir()
    for f in list(build.CSRC.glob("*.cu")) + list(build.CSRC.glob("*.cuh")):
        shutil.copy(f, d)
    monkeypatch.setattr(build, "CSRC", d)
    return d


def test_the_kernels_include_the_shared_header():
    for name in KERNELS:
        assert '#include "hopper.cuh"' in (build.CSRC / f"{name}.cu").read_text()
    assert (build.CSRC / "hopper.cuh").exists()


def test_the_target_is_stable(csrc):
    assert [build._target(n) for n in KERNELS] == [build._target(n) for n in KERNELS]
    assert all(build._target(n).parent == build.BUILD_DIR for n in KERNELS)


def test_a_header_edit_changes_every_target(csrc):
    before = {n: build._target(n) for n in KERNELS}
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    after = {n: build._target(n) for n in KERNELS}
    assert all(before[n] != after[n] for n in KERNELS)


def test_a_new_header_changes_every_target(csrc):
    before = {n: build._target(n) for n in KERNELS}
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert all(before[n] != build._target(n) for n in KERNELS)


def test_a_source_edit_changes_only_its_target(csrc):
    before = {n: build._target(n) for n in KERNELS}
    src = csrc / f"{fh.KERNEL}.cu"
    src.write_text(src.read_text() + "\n// an edit\n")
    assert build._target(fh.KERNEL) != before[fh.KERNEL]
    assert build._target(fh.KERNEL_BWD) == before[fh.KERNEL_BWD]
