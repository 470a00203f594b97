"""The port's kernel build keys each library on everything its source
includes: editing a shared header (``csrc/*.cuh``) must change the library
path, so a stale ``.so`` is never loaded. No nvcc is needed: only the
path is computed."""
import shutil

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    monkeypatch.setenv(build.BUILD_ENV, str(tmp_path / "build"))
    return copy


def test_sources_are_all_present():
    assert build.SOURCES == ("sc_matmul", "paged_attention", "flash_attention",
                             "sc_bitops")
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()
    assert (build.CSRC / "sc_attention.cuh").is_file()


@pytest.mark.parametrize("name", build.SOURCES)
def test_header_bytes_change_every_library_path(csrc, name):
    before = build.library_path(name)
    assert before.parent == csrc.parent / "build"
    header = csrc / "sc_attention.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = build.library_path(name)
    assert after != before
    # a new header counts too, and the path is stable when nothing changes
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path(name) not in (before, after)
    assert build.library_path(name) == build.library_path(name)


def test_source_bytes_change_only_their_library(csrc):
    paths = {name: build.library_path(name) for name in build.SOURCES}
    src = csrc / "flash_attention.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    assert build.library_path("flash_attention") != paths["flash_attention"]
    assert build.library_path("sc_matmul") == paths["sc_matmul"]
