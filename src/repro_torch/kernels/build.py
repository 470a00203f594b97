"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on its own with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which the
wrappers load with ``ctypes``. Nothing includes PyTorch's headers, so a
build takes seconds. The build happens at first use, from the checkout's
sources only, into ``build/repro_torch_kernels/`` at the repository root
(``$REPRO_TORCH_BUILD_DIR`` overrides it), under a name keyed by a hash of
the source, every shared header (``csrc/*.cuh``) and the flags — an edited
source or header never loads a stale library.

:func:`build` starts one ``nvcc`` per source at once and waits for all, so
building every kernel costs about as long as the slowest one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from repro_torch.errors import KernelLaunchError

__all__ = ["SOURCES", "build", "load", "check", "library_path", "ptxas_log",
           "build_root", "source_hash", "direct"]

CSRC = Path(__file__).resolve().parent / "csrc"
#: Every kernel source of the port, by library name.
SOURCES = ("sc_matmul", "paged_attention", "flash_attention", "sc_bitops")
BUILD_ENV = "REPRO_TORCH_BUILD_DIR"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def build_root() -> Path:
    env = os.environ.get(BUILD_ENV)
    if env:
        return Path(env)
    return CSRC.parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise KernelLaunchError(
        "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, /usr/local/cuda "
        "and $PATH): the CUDA kernels are built from source at first use")


def source_hash(name: str) -> str:
    """The kernel's version: a hash of its source, every shared header
    and the flags, which names its library (and keys the autotuner's
    entries for it)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_root() / f"lib{name}-{source_hash(name)}.so"


def ptxas_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` reported for ``name`` (registers, shared
    memory, spills per kernel), or "" before the first build."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names: tuple[str, ...] = SOURCES) -> dict[str, float]:
    """Compile every listed source that has no library yet, all at once;
    returns the seconds each build took (0.0 for a cached library)."""
    root = build_root()
    root.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise KernelLaunchError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a non-zero ``cudaError_t`` (a refused
    launch never runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise KernelLaunchError(f"{what}: CUDA error {rc} at launch")


def direct(*tensors) -> bool:
    """Whether a kernel wrapper may call its custom operator's
    implementation as a plain function: every operand a plain tensor and
    no dispatch mode active. A ``DTensor``, a ``FakeTensor`` or a mode
    (the dry run's counting) must meet the operator, which sends them to
    its sharding rule or its fake implementation; a plain tensor gains
    nothing from the dispatcher, which costs an eager decode step tens
    of milliseconds (PERF.md)."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    import torch
    return (all(type(t) is torch.Tensor for t in tensors)
            and _get_current_dispatch_mode() is None)
