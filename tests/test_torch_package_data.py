"""The port's package data: an installed (non-editable) ``repro_torch``
builds its kernels from the sources it ships, so every CUDA source and
every header a source includes must match a ``package-data`` pattern of
``pyproject.toml``."""
import fnmatch
import re
import tomllib
from pathlib import Path

import pytest

from repro_torch.kernels import build

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "src" / "repro_torch"


def _patterns() -> list[str]:
    doc = tomllib.loads((ROOT / "pyproject.toml").read_text())
    return doc["tool"]["setuptools"]["package-data"]["repro_torch"]


def _shipped(path: Path) -> bool:
    rel = path.relative_to(PACKAGE).as_posix()
    return any(fnmatch.fnmatchcase(rel, pat) for pat in _patterns())


@pytest.mark.parametrize("source", sorted(p.name for p in
                                          build.CSRC.iterdir()))
def test_every_quoted_include_and_source_is_package_data(source):
    path = build.CSRC / source
    assert _shipped(path), f"{source} is not package data"
    for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', path.read_text(),
                           re.MULTILINE):
        header = (path.parent / name).resolve()
        assert header.is_file(), f"{source} includes a missing {name}"
        assert _shipped(header), f"{source} includes {name}, not package data"


def test_every_built_source_is_shipped():
    for name in build.SOURCES:
        assert _shipped(build.CSRC / f"{name}.cu"), name
    # the hash that names a library reads every header: all are shipped
    for header in build.CSRC.glob("*.cuh"):
        assert _shipped(header), header.name
