"""Autotuner of the port's CUDA kernels (port of
``repro/kernels/autotune.py``): per-shape launch plans swept on the card,
one JSON cache on disk, resolved before every CUDA graph capture.

Tuned subspaces — each knob is an argument of its kernel's C entry, and
none changes the order of a sum, so every candidate gives the bits of the
default plan (the first point of each grid, today's ``plan()``):

* SC-GEMM (:class:`KernelConfig`) — rows a block ``mr`` and the K range a
  block ``kc``, hence the K split (``kernels/sc_matmul.py::plan``'s
  choices). Partials are int32 counts, added exactly in any order. A
  batched launch (one MoE projection of E experts) is keyed apart
  (``:e<E>``) and its K split counts every expert's tiles.
* bit-parallel stream multiply (:class:`StreamConfig`) — ``block_rows``,
  rows of 128 elements a block.
* flash attention (:class:`FlashConfig`) — query heads and m-tiles a block
  (``flash_attention.plan``). A row's tile, slot and key tiles depend on
  its position alone. The SC quantization ``group`` is part of the result
  and is never tuned.
* paged decode attention (:class:`PagedConfig`) — a one-point grid: see
  the class.

Keys carry the op family, the shape, the dtype and SC bits, the mode
(``cuda``, or ``cpu`` where the plain versions are timed, which says
nothing of the card), the device's name and SM count, and the kernel's
version (``build.source_hash``): a winner never serves another card or an
edited kernel.

A sweep times operands of its own, drawn from a numpy seed, never the
caller's tensors, so it writes no caller's output and no step's static
buffer. It puts the kernel wrappers' launch counters back afterwards, so a
counter counts the caller's launches only; :data:`sweeps` counts sweeps. A
sweep synchronizes, so it must not run inside a CUDA graph's warm-up or
capture: there the tuner is lookup-only (:func:`lookup_only`,
``launch.steps.capture``) and a miss raises ``KernelLaunchError``; the
capture's tuning pass (``launch.steps.tune``) sweeps first.

Entry points:

* :func:`get_or_tune` / :func:`get_or_tune_stream` / :func:`get_or_tune_flash`
  / :func:`get_or_tune_paged` — cached lookup, sweep on a miss; used by the
  ``ops.py`` wrappers' tuned paths and by ``sc_proj``.
* :func:`choose_impl` — the dispatch behind ``sc_matmul(..., impl="auto")``.
* :class:`AutotuneCache` — the JSON cache (``$REPRO_TORCH_AUTOTUNE_CACHE``
  or ``~/.cache/repro_torch/autotune.json``; never the JAX package's file,
  whose documents each package would discard as foreign).
"""
from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import json
import math
import os
import tempfile
import threading
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from repro_torch.errors import KernelLaunchError

from . import build
from .flash_attention import (BLOCK_Q, MMA_MAX_WARPS, SC_ITEMS, SC_THREADS,
                              SMEM_MAX, m_tile_count, plan as flash_plan,
                              smem_bytes as flash_smem_bytes)
from .paged_attention import RANKS
from .sc_bitops import MAX_BLOCK_ROWS
from .sc_matmul import (A_SMEM_ENTRIES, K_BLOCK_MAX, K_STAGE, TILE_N,
                        PackedWeight, plan as gemm_plan, plane_dtype,
                        row_tile)

__all__ = [
    "KernelConfig",
    "StreamConfig",
    "FlashConfig",
    "PagedConfig",
    "AutotuneCache",
    "candidate_configs",
    "candidate_stream_configs",
    "candidate_flash_configs",
    "candidate_paged_configs",
    "autotune",
    "get_or_tune",
    "get_or_tune_stream",
    "get_or_tune_flash",
    "get_or_tune_paged",
    "choose_impl",
    "best_of_us",
    "default_cache_path",
    "bucket_m",
    "lookup_only",
    "SKINNY_M_MAX",
]

CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
#: What a document of this cache says it is: any other file on the path
#: (the JAX package's tuner's included) reads as empty.
CACHE_KIND = "repro_torch.autotune"
CACHE_VERSION = 1

#: Largest M treated as "skinny" (decode-shaped: one token per sequence, so
#: M = live batch). Skinny problems share a bucketed cache key — see
#: :func:`bucket_m`.
SKINNY_M_MAX = 64

#: Row counts of an SC-GEMM block the kernel is compiled for.
MR_OPTIONS = (1, 2, 4, 8, 16)
#: Blocks per SM the SC-GEMM grid's K splits aim for (the default plan's
#: ``BLOCKS_PER_SM`` is one of them).
SPLIT_TARGETS = (1, 2, 4, 8)

#: Sweeps run since the process started (or since a caller set it to 0).
sweeps = 0
_LOOKUP_ONLY = 0


def bucket_m(m: int) -> int:
    """Bucket class for the M extent of a GEMM tuning key.

    Decode-time projections see M = the live batch, which fluctuates with
    serving load. Bucketing skinny M to the next power of two (8, 16, 32,
    64) makes every decode batch size in a bucket resolve to one tuned
    config instead of sweeping (and caching) per exact batch size;
    prefill-sized M (> SKINNY_M_MAX) keeps its exact extent.
    """
    if m > SKINNY_M_MAX:
        return m
    b = 8
    while b < m:
        b *= 2
    return b


@contextlib.contextmanager
def lookup_only():
    """Inside the block every ``get_or_tune*`` miss raises
    ``KernelLaunchError`` instead of sweeping (a CUDA graph's warm-up and
    capture: a sweep synchronizes, and it would time nothing there)."""
    global _LOOKUP_ONLY
    _LOOKUP_ONLY += 1
    try:
        yield
    finally:
        _LOOKUP_ONLY -= 1


# -------------------------------------------------------------- the knobs

@dataclass(frozen=True)
class KernelConfig:
    """One SC-GEMM launch plan: ``mr`` rows a block and ``kc`` the K range
    a block (a multiple of ``K_STAGE``); the K split is ``ceil(K / kc)``
    ranges, whose int32 partials meet in the same launch."""
    mr: int = 16
    kc: int = 512

    def splits(self, k: int) -> int:
        return max(1, -(-k // self.kc))

    def fits(self) -> bool:
        """The wrapper's limits: a block's quantized rows fit its
        ``A_SMEM_ENTRIES`` shared-memory entries, and a thread's packed
        lanes hold at most ``K_BLOCK_MAX / 32`` k rows."""
        return self.kc <= K_BLOCK_MAX and self.mr * self.kc <= A_SMEM_ENTRIES

    def is_valid(self) -> bool:
        return (self.mr in MR_OPTIONS and self.kc >= K_STAGE
                and self.kc % K_STAGE == 0)


@dataclass(frozen=True)
class StreamConfig:
    """Tuning point of the stream kernel: rows of 128 elements a block
    (``block_rows`` x 32 threads)."""
    block_rows: int = MAX_BLOCK_ROWS

    def fits(self) -> bool:
        return self.block_rows <= MAX_BLOCK_ROWS

    def is_valid(self) -> bool:
        return self.block_rows > 0


@dataclass(frozen=True)
class FlashConfig:
    """Tuning point of the flash kernel: query heads a block serves and
    m-tiles (16 query positions each) a block covers."""
    heads: int = 1
    m_tiles: int = 1

    def fits(self, path: str, d: int, group: int, esz: int) -> bool:
        """What the kernel takes on ``path`` ("mma", "f32" or "sc"): shared
        memory within ``SMEM_MAX``; a bf16 block of at most
        ``MMA_MAX_WARPS`` warps (one per head and m-tile); one m-tile a
        block on the other paths, and on the SC path every row's outputs
        within its ``SC_ITEMS`` a thread."""
        if flash_smem_bytes(path, self.heads, self.m_tiles, d, group,
                            esz) > SMEM_MAX:
            return False
        if path == "mma":
            return self.heads * self.m_tiles <= MMA_MAX_WARPS
        if self.m_tiles != 1:
            return False
        return path != "sc" or \
            BLOCK_Q * self.heads <= SC_ITEMS * (SC_THREADS // -(-d // 4))

    def is_valid(self) -> bool:
        return self.heads > 0 and self.m_tiles > 0


@dataclass(frozen=True)
class PagedConfig:
    """The paged kernel's one plan. Its only launch knob, the ranks of the
    cluster that split a slot's keys, is a compile-time constant
    (``kRanks`` = ``RANKS``), and the ranks merge their partials in rank
    order: another rank count would sum in another order and give other
    bits. So the grid has one point; the tuner still keys and times it,
    and :func:`candidate_paged_configs` is the kernel's eligibility
    gate."""
    ranks: int = RANKS

    def fits(self) -> bool:
        return self.ranks == RANKS

    def is_valid(self) -> bool:
        return self.ranks > 0


# ------------------------------------------------------------ the cache

def default_cache_path() -> Path:
    env = os.environ.get(CACHE_ENV)
    if env:
        return Path(env)
    base = Path(os.environ.get("XDG_CACHE_HOME", str(Path.home() / ".cache")))
    return base / "repro_torch" / "autotune.json"


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _mode(device) -> str:
    """Key segment for where the candidates ran: ``cuda`` (the kernels) or
    ``cpu`` (their plain versions, whose timings say nothing of the
    card)."""
    return "cuda" if torch.device(device).type == "cuda" else "cpu"


_INFO: dict = {}


def device_info(device) -> tuple[str, int]:
    """(name, SMs) of a CUDA device, read once; ("cpu", 0) on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu", 0
    dev = _device(dev)
    if dev.index not in _INFO:
        props = torch.cuda.get_device_properties(dev)
        _INFO[dev.index] = (props.name, props.multi_processor_count)
    return _INFO[dev.index]


_VERSIONS: dict = {}


def _backend(device, kernel: str) -> str:
    """Key segment for the device and the kernel: the device's name and SM
    count and the kernel's source hash."""
    name, sms = device_info(device)
    if kernel not in _VERSIONS:
        _VERSIONS[kernel] = build.source_hash(kernel)
    safe = name.replace(":", "_").replace(" ", "_")
    return f"{safe}:sm{sms}:{_VERSIONS[kernel]}"


def _dtype(dtype) -> str:
    return str(dtype).removeprefix("torch.")


class AutotuneCache:
    """Persistent key -> config map, stored as one JSON document.

    Keys are built by the ``key*`` staticmethods and always carry the op
    family, the device and kernel (``backend``) and the mode, so CPU
    timings never serve the card, nor one card's another's.
    """

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = Path(path) if path is not None else default_cache_path()
        self._entries: dict[str, dict] = {}
        self._load()

    @staticmethod
    def key(m: int, k: int, n: int, bits: int, *, dtype="float32",
            device="cuda", backend: str | None = None,
            experts: int = 0) -> str:
        """SC-GEMM: ``dtype`` is the A operand's (float rows of the fused
        entry, or a signed plane). Skinny M extents are bucketed
        (:func:`bucket_m`). A batched launch of ``experts`` problems (a
        MoE projection) ends in ``:e<experts>``; an unbatched key has no
        such suffix."""
        backend = backend or _backend(device, "sc_matmul")
        return (f"sc_gemm:{_mode(device)}:{backend}:m{bucket_m(m)}:k{k}"
                f":n{n}:{_dtype(dtype)}:b{bits}"
                + (f":e{experts}" if experts else ""))

    @staticmethod
    def stream_key(size: int, bits: int, *, device="cuda",
                   backend: str | None = None) -> str:
        """``size`` is the flat element count of int32 magnitudes."""
        backend = backend or _backend(device, "sc_bitops")
        return f"sc_stream:{_mode(device)}:{backend}:s{size}:b{bits}"

    @staticmethod
    def flash_key(b: int, h: int, kv: int, sq: int, tiles: int, skv: int,
                  d: int, causal: bool, *, group: int, dtype="float32",
                  sc_bits: int | None = None, device="cuda",
                  backend: str | None = None) -> str:
        """``tiles`` is the launch's m-tile count (``m_tile_count``: the
        worst case for an offset held on the card, whose value the host
        never reads). The SC variant (``sc<bits>``; ``sc0`` = float) and
        its quantization ``group`` change the work a tile does."""
        backend = backend or _backend(device, "flash_attention")
        c = "causal" if causal else "full"
        return (f"flash:{_mode(device)}:{backend}:b{b}:h{h}:kv{kv}:sq{sq}"
                f":mt{tiles}:skv{skv}:d{d}:{_dtype(dtype)}:{c}:grp{group}"
                f":sc{sc_bits or 0}")

    @staticmethod
    def paged_key(c: int, kv: int, g: int, d: int, block: int,
                  max_blocks: int, window: int | None, *, dtype="float32",
                  sc_bits: int | None = None, device="cuda",
                  backend: str | None = None) -> str:
        """The whole page-walk geometry is static per serving layout
        (capacity, heads, page size, table width), so it all goes in the
        key, with the window and the SC variant."""
        backend = backend or _backend(device, "paged_attention")
        return (f"paged:{_mode(device)}:{backend}:c{c}:kv{kv}:g{g}:d{d}"
                f":blk{block}:mb{max_blocks}:w{window or 0}:{_dtype(dtype)}"
                f":sc{sc_bits or 0}")

    def _load(self) -> None:
        self._entries = self._read_disk()

    def _read_disk(self) -> dict[str, dict]:
        """Current on-disk entries; {} for a missing, torn, foreign or
        stale file. Never fatal: the affected keys simply re-tune."""
        try:
            doc = json.loads(self.path.read_text())
        except (OSError, ValueError):
            return {}
        if not isinstance(doc, dict) or doc.get("kind") != CACHE_KIND \
                or doc.get("version") != CACHE_VERSION:
            return {}
        entries = doc.get("entries")
        if not isinstance(entries, dict):
            return {}
        return {k: v for k, v in entries.items() if isinstance(v, dict)}

    def get(self, key: str, cls: type = KernelConfig):
        """The entry at ``key`` as a ``cls``, or None when it is missing or
        invalid (a field missing, not an int, or out of range)."""
        ent = self._entries.get(key)
        if ent is None:
            return None
        names = [f.name for f in dataclasses.fields(cls)]
        if any(type(ent.get(f)) is not int for f in names):
            return None
        cfg = cls(**{f: ent[f] for f in names})
        return cfg if cfg.is_valid() else None

    def entry(self, key: str) -> dict | None:
        """The raw entry (the config's fields, ``tuned_at``, ``us_per_call``
        and what the sweep recorded beside it)."""
        ent = self._entries.get(key)
        return dict(ent) if ent is not None else None

    def keys(self) -> list[str]:
        return list(self._entries)

    def put(self, key: str, cfg, *, elapsed_us: float | None = None,
            **info) -> None:
        ent = asdict(cfg)
        ent["tuned_at"] = time.time()
        if elapsed_us is not None:
            ent["us_per_call"] = elapsed_us
        ent.update(info)
        self._entries[key] = ent
        self._save()

    @property
    def lock_path(self) -> Path:
        """The file whose exclusive ``flock`` serialises the writers of the
        cache, beside it."""
        return self.path.with_name(self.path.name + ".lock")

    def _save(self) -> None:
        """Best-effort persist; an unwritable path (the cache's or its
        lock's) degrades to in-memory.

        Concurrent-writer safe: under an exclusive ``flock`` on
        :attr:`lock_path` (and, for the threads of one process, a
        process-wide lock around it) the on-disk document is re-read,
        merged under this instance's keys and replaced atomically (written
        to a temporary file, then renamed), so every writer's keys
        survive and a reader never sees a torn file.
        """
        tmp = None
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with _SAVE_LOCK, open(self.lock_path, "a") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                merged = self._read_disk()
                merged.update(self._entries)
                self._entries = merged
                doc = {"kind": CACHE_KIND, "version": CACHE_VERSION,
                       "entries": merged}
                fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                           prefix=self.path.name,
                                           suffix=".tmp")
                with os.fdopen(fd, "w") as f:
                    json.dump(doc, f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
                tmp = None
        except OSError:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    def __len__(self) -> int:
        return len(self._entries)


#: Held around a writer's ``flock`` (``AutotuneCache._save``), so the
#: threads of one process exclude each other whatever ``flock`` does
#: between their descriptors.
_SAVE_LOCK = threading.Lock()
_DEFAULT_CACHES: dict[Path, AutotuneCache] = {}


def _default_cache() -> AutotuneCache:
    """Process-wide AutotuneCache per resolved path: keyed on the path so
    a change of ``$REPRO_TORCH_AUTOTUNE_CACHE`` takes effect, and reused
    so a lookup on the hot path reads no file."""
    path = default_cache_path()
    cache = _DEFAULT_CACHES.get(path)
    if cache is None:
        cache = _DEFAULT_CACHES[path] = AutotuneCache(path)
    return cache


# ------------------------------------------------------------ candidate grids

def _unique(cands: Iterable) -> list:
    out = []
    for c in cands:
        if c not in out:
            out.append(c)
    return out


def candidate_configs(m: int, k: int, n: int, *, sms: int = 0,
                      batch: int = 1) -> list[KernelConfig]:
    """The SC-GEMM grid for a launch of ``batch`` (M, K, N) problems on a
    card of ``sms`` SMs (0 on the CPU): first today's
    :func:`sc_matmul.plan`, then every row tile up to the one covering M,
    each with the K splits that give the grid 1, 2, 4 and 8 blocks an SM
    where K allows, and no split. Every candidate fits the wrapper's
    limits."""
    mr0, kc0, _ = gemm_plan(m, n, k, sms, batch)
    cands = [KernelConfig(mr0, kc0)]
    cover = row_tile(m)
    k_cap = -(-k // K_STAGE) * K_STAGE
    for mr in MR_OPTIONS:
        if mr > cover:
            break
        kc_max = max(K_STAGE, min(K_BLOCK_MAX,
                                  A_SMEM_ENTRIES // mr // K_STAGE * K_STAGE))
        tiles = -(-n // TILE_N) * -(-max(m, 1) // mr) * batch
        for target in SPLIT_TARGETS:
            splits = max(1, min(-(-target * sms // tiles), -(-k // K_STAGE)))
            kc = -(-max(-(-k // splits), 1) // K_STAGE) * K_STAGE
            cands.append(KernelConfig(mr, min(kc, kc_max)))
        cands.append(KernelConfig(mr, min(k_cap, kc_max)))
    return [c for c in _unique(cands) if c.is_valid() and c.fits()]


def candidate_stream_configs(size: int) -> list[StreamConfig]:
    """Block widths for the stream kernel: today's default
    (``MAX_BLOCK_ROWS``) first, then the narrower powers of two a problem
    of ``size`` elements fills."""
    rows = max(-(-size // 128), 1)
    return _unique([StreamConfig()] + [StreamConfig(w) for w in (1, 2, 4)
                                       if w <= rows])


def candidate_flash_configs(b: int, h: int, kv: int, sq: int, d: int, *,
                            group: int, q_offset: int | torch.Tensor = 0,
                            sc_bits: int | None = None, esz: int = 2,
                            sms: int = 0) -> list[FlashConfig]:
    """(heads, m-tiles) grid of the flash kernel: today's
    :func:`flash_attention.plan` first, then heads 1, 2, 4, 8 and G (at
    most G) with m-tiles 1, 2, 4, 8 (at most the launch's) on the bf16
    tensor-core path, one m-tile on the others, every point fitting the
    kernel (:meth:`FlashConfig.fits`)."""
    p = flash_plan(b, h, kv, sq, d, group, q_offset, sc_bits, esz=esz,
                   sms=sms)
    g = h // kv
    tiles = m_tile_count(sq, q_offset)
    heads = sorted({x for x in (1, 2, 4, 8, g) if x <= g})
    m_tiles = [x for x in (1, 2, 4, 8) if x <= tiles] if p.path == "mma" \
        else [1]
    cands = [FlashConfig(p.heads, p.m_tiles)] + [
        FlashConfig(x, y) for x in heads for y in m_tiles]
    return [c for c in _unique(cands)
            if c.is_valid() and c.fits(p.path, d, group, esz)]


def candidate_paged_configs(kv: int, g: int, *,
                            sc: bool = False) -> list[PagedConfig]:
    """The paged kernel's grid: its one plan (:class:`PagedConfig`) for
    every layout it serves, none for float single-KV-head full-MHA (``KV
    == 1``, ``G == 1``), which stays on the gathered path; the SC variant
    serves every head layout. ``models.layers._paged_kernel_eligible``
    reads this gate."""
    if not sc and g == 1 and kv == 1:
        return []
    return [PagedConfig()]


# -------------------------------------------------------------------- sweeps

#: Cycles of the sleep kernel queued before a timed call on the card: the
#: host enqueues the events and the call while it runs, so the events time
#: the device's work, not the host's launch.
SLEEP_CYCLES = 200_000
#: Bytes written between timed calls on the card to evict the 50 MB L2
#: cache: a projection on the main path finds its weight cold.
FLUSH_BYTES = 64 << 20
_FLUSH: dict = {}


def best_of_us(call: Callable[[], object], iters: int,
               device=None) -> float:
    """Best-of-``iters`` time (µs) of ``call`` after one warm-up.

    On the card each sample is CUDA events around one call, queued behind
    a short sleep kernel and an L2 flush; on the CPU the host clock. Best
    of, not mean: noise only ever adds time.
    """
    call()
    dev = torch.device("cpu" if device is None else device)
    best = math.inf
    if dev.type != "cuda":
        for _ in range(max(iters, 1)):
            t0 = time.perf_counter()
            call()
            best = min(best, time.perf_counter() - t0)
        return best * 1e6
    dev = _device(dev)
    flush = _FLUSH.get(dev.index)
    if flush is None:
        flush = _FLUSH[dev.index] = torch.empty(FLUSH_BYTES // 4,
                                                dtype=torch.int32, device=dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(max(iters, 1)):
        torch.cuda._sleep(SLEEP_CYCLES)
        flush.zero_()
        start.record()
        call()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e3)
    return best


def _no_plan(t) -> bool:
    """A tensor no launch plan is looked up or swept for: a ``DTensor``
    (its global shape is no launch's; its shards launch at the default
    plan) or a tensor without data (fake or on ``meta``)."""
    from torch._subclasses.fake_tensor import is_fake
    from repro_torch.parallel.context import is_dtensor
    return is_dtensor(t) or t.device.type == "meta" or is_fake(t)


def _may_sweep(key: str) -> None:
    if _LOOKUP_ONLY or (torch.cuda.is_available()
                        and torch.cuda.is_current_stream_capturing()):
        raise KernelLaunchError(
            f"autotune: no plan cached for {key} inside a lookup-only scope "
            f"(a CUDA graph's warm-up or capture); run the step once with "
            f"sweeps allowed first (launch.steps.tune)")


def _sweep(cands: Sequence, time_one: Callable[[object], float], what: str):
    """Time every candidate; returns (best, its µs, [µs of each]). The
    kernel wrappers' launch counters are put back afterwards."""
    global sweeps
    if not cands:
        raise ValueError(f"no tuning candidates for {what}")
    from .ops import launch_counters
    counters = launch_counters()
    before = {name: c.launches for name, c in counters.items()}
    try:
        times = [time_one(cfg) for cfg in cands]
    finally:
        for name, c in counters.items():
            c.launches = before[name]
    sweeps += 1
    i = int(np.argmin(times))
    return cands[i], times[i], times


#: Values drawn with numpy for a synthetic operand; a larger operand
#: repeats them (the kernels' work does not depend on the values).
SYNTH_BLOCK = 1 << 20


def _synth(shape, seed: int, dtype: torch.dtype, device,
           lo: int | None = None, hi: int | None = None) -> torch.Tensor:
    """A seeded operand of ``shape``: standard normal floats, or integers
    in ``[lo, hi]``."""
    numel = math.prod(shape)
    rng = np.random.default_rng(seed)
    n0 = max(min(numel, SYNTH_BLOCK), 1)
    if lo is None:
        vals = torch.from_numpy(rng.standard_normal(n0).astype(np.float32))
    else:
        vals = torch.from_numpy(rng.integers(lo, hi + 1, size=n0,
                                             dtype=np.int32))
    t = vals.to(device=device, dtype=dtype)
    if n0 < numel:
        t = t.repeat(-(-numel // n0))
    return t[:numel].reshape(shape)


def _gemm_operands(m: int, k: int, n: int, bits: int, a_dtype, fused: bool,
                   device, experts: int = 0):
    """Synthetic SC-GEMM operands: float rows and a packed weight (the
    fused entry; ``experts`` > 0 a batched one and rows ``(E, M, K)``), or
    two signed planes (the counts entry)."""
    lim = (1 << bits) - 1
    pdt = plane_dtype(bits)
    if fused:
        ldb = -(-n // 8) * 8
        lead = (experts,) if experts else ()
        plane = _synth((*lead, k, ldb), k * 7919 + n, pdt, device, -lim, lim)
        scale = torch.full(lead, 1.0 / lim, dtype=torch.float32,
                           device=device)
        return (_synth((*lead, m, k), m * 7919 + k, a_dtype, device),
                PackedWeight(plane, scale, bits, (k, n), experts))
    return (_synth((m, k), m * 7919 + k, pdt, device, -lim, lim),
            _synth((k, n), k * 7919 + n, pdt, device, -lim, lim))


def _gemm_call(a, b, bits: int, cfg: KernelConfig):
    from .sc_matmul import sc_linear, sc_matmul_counts_signed
    if isinstance(b, PackedWeight):
        return sc_linear(a, b, config=cfg)
    return sc_matmul_counts_signed(a, b, bits=bits, config=cfg)


def autotune(a, b, *, bits: int = 8,
             candidates: Sequence[KernelConfig] | None = None,
             iters: int = 3, max_candidates: int | None = None
             ) -> tuple[KernelConfig, float]:
    """Sweep the SC-GEMM grid on live operands — float rows ``a (M, K)``
    (``(E, M, K)`` for a batched pack) and a :class:`PackedWeight` ``b``
    (the fused entry), or signed planes ``a (M, K)``, ``b (K, N)`` — and
    return (best config, best µs)."""
    m, k = a.shape[-2:]
    n = b.shape[1]
    batch = 1
    if isinstance(b, PackedWeight):
        bits, batch = b.bits, max(b.experts, 1)
    cands = list(candidates if candidates is not None else candidate_configs(
        m, k, n, sms=device_info(a.device)[1], batch=batch))
    if max_candidates is not None:
        cands = cands[:max_candidates]
    best, us, _ = _sweep(
        cands, lambda c: best_of_us(lambda: _gemm_call(a, b, bits, c),
                                    iters, a.device),
        f"SC-GEMM ({m},{k})x({k},{n})")
    return best, us


def get_or_tune(a, b, *, bits: int = 8, cache: AutotuneCache | None = None,
                candidates: Sequence[KernelConfig] | None = None,
                iters: int = 3) -> KernelConfig:
    """Cached SC-GEMM plan for the problem of ``a (M, K)`` and ``b`` (a
    :class:`PackedWeight`, whose bits win, or a ``(K, N)`` plane); sweeps
    on a miss. A batched pack of E experts takes rows ``a (E, M, K)``: one
    launch of E problems, keyed apart (``:e<E>``) and swept over the same
    grid counted for all E (:func:`candidate_configs`). Only the shapes,
    dtypes and device of ``a`` and ``b`` are read: the sweep times
    synthetic operands of the same kind, at ``bucket_m(M)`` rows, so one
    winner serves every batch in a bucket."""
    if _no_plan(a):
        return None
    m, k = a.shape[-2:]
    n = b.shape[1]
    fused = isinstance(b, PackedWeight)
    experts = b.experts if fused else 0
    if fused:
        bits = b.bits
    m = bucket_m(m)
    dev = a.device
    cache = cache if cache is not None else _default_cache()
    key = cache.key(m, k, n, bits, dtype=a.dtype, device=dev,
                    experts=experts)
    hit = cache.get(key, KernelConfig)
    if hit is not None and hit.fits():
        return hit
    _may_sweep(key)
    default = candidates is None
    cands = list(candidates) if not default else candidate_configs(
        m, k, n, sms=device_info(dev)[1], batch=max(experts, 1))
    x, w = _gemm_operands(m, k, n, bits, a.dtype, fused, dev, experts)
    cfg, us, times = _sweep(
        cands, lambda c: best_of_us(lambda: _gemm_call(x, w, bits, c),
                                    iters, dev), key)
    del x, w
    cache.put(key, cfg, elapsed_us=us, candidates=len(cands),
              default_us=times[0] if default else None)
    return cfg


def get_or_tune_stream(x, y, *, bits: int = 8,
                       cache: AutotuneCache | None = None,
                       candidates: Sequence[StreamConfig] | None = None,
                       iters: int = 3) -> StreamConfig:
    """Cached ``block_rows`` of the stream kernel for operands of ``x``'s
    size (flat int32 magnitudes below ``2**bits``)."""
    from .sc_bitops import sc_stream_mul_cuda
    size = x.numel()
    dev = x.device
    cache = cache if cache is not None else _default_cache()
    key = cache.stream_key(size, bits, device=dev)
    hit = cache.get(key, StreamConfig)
    if hit is not None and hit.fits():
        return hit
    _may_sweep(key)
    default = candidates is None
    cands = list(candidates) if not default else \
        candidate_stream_configs(size)
    hi = (1 << bits) - 1
    xs = _synth((size,), size, torch.int32, dev, 0, hi)
    ys = _synth((size,), size + 1, torch.int32, dev, 0, hi)
    cfg, us, times = _sweep(
        cands, lambda c: best_of_us(
            lambda: sc_stream_mul_cuda(xs, ys, bits=bits,
                                       block_rows=c.block_rows),
            iters, dev), key)
    del xs, ys
    cache.put(key, cfg, elapsed_us=us, candidates=len(cands),
              default_us=times[0] if default else None)
    return cfg


def get_or_tune_flash(q, k, v, *, causal: bool = True,
                      q_offset: int | torch.Tensor = 0, group: int = 64,
                      sc_bits: int | None = None,
                      cache: AutotuneCache | None = None,
                      candidates: Sequence[FlashConfig] | None = None,
                      iters: int = 3) -> FlashConfig:
    """Cached (heads, m-tiles) of the flash kernel for ``q (B, H, Sq, D)``
    and ``k, v (B, KV, Skv, D)`` at ``q_offset``. An offset held on the
    card keys and sweeps the worst-case launch (``m_tile_count``) and is
    swept at the deepest chunk, ``Skv - Sq``; its value is never read."""
    if _no_plan(q):
        return None
    from .flash_attention import flash_attention
    b, h, sq, d = q.shape
    _, kv, skv, _ = k.shape
    dev = q.device
    esz = q.element_size()
    tiles = m_tile_count(sq, q_offset)
    cache = cache if cache is not None else _default_cache()
    key = cache.flash_key(b, h, kv, sq, tiles, skv, d, causal, group=group,
                          dtype=q.dtype, sc_bits=sc_bits, device=dev)
    path = flash_plan(b, h, kv, sq, d, group, q_offset, sc_bits,
                      esz=esz).path
    hit = cache.get(key, FlashConfig)
    if hit is not None and hit.fits(path, d, group, esz):
        return hit
    _may_sweep(key)
    default = candidates is None
    cands = list(candidates) if not default else candidate_flash_configs(
        b, h, kv, sq, d, group=group, q_offset=q_offset, sc_bits=sc_bits,
        esz=esz, sms=device_info(dev)[1])
    qs = _synth((b, h, sq, d), sq * 31 + d, q.dtype, dev)
    ks = _synth((b, kv, skv, d), skv * 31 + d, q.dtype, dev)
    vs = _synth((b, kv, skv, d), skv * 37 + d, q.dtype, dev)
    off = q_offset
    if isinstance(q_offset, torch.Tensor):
        off = torch.tensor(max(skv - sq, 0), dtype=torch.int32, device=dev)
    cfg, us, times = _sweep(
        cands, lambda c: best_of_us(
            lambda: flash_attention(qs, ks, vs, causal=causal, q_offset=off,
                                    group=group, sc_bits=sc_bits, config=c),
            iters, dev), key)
    del qs, ks, vs
    cache.put(key, cfg, elapsed_us=us, candidates=len(cands),
              default_us=times[0] if default else None)
    return cfg


def get_or_tune_paged(q, k_pages, v_pages, tables, q_positions, *,
                      window: int | None = None,
                      sc_bits: int | None = None,
                      cache: AutotuneCache | None = None,
                      candidates: Sequence[PagedConfig] | None = None,
                      iters: int = 3) -> PagedConfig:
    """Cached plan of the paged kernel for ``q (C, KV, G, D)``, pages
    ``(P, block, KV, D)`` and ``tables (C, MB)``: a one-point grid
    (:class:`PagedConfig`), looked up, and on a miss timed once over a
    synthetic pool whose tables are full and whose slots sit at their last
    position (the walk's worst case)."""
    if _no_plan(q):
        return None
    from .paged_attention import paged_attention
    c, kv, g, d = q.shape
    block = k_pages.shape[1]
    mb = tables.shape[1]
    dev = q.device
    cache = cache if cache is not None else _default_cache()
    key = cache.paged_key(c, kv, g, d, block, mb, window, dtype=q.dtype,
                          sc_bits=sc_bits, device=dev)
    hit = cache.get(key, PagedConfig)
    if hit is not None and hit.fits():
        return hit
    _may_sweep(key)
    default = candidates is None
    cands = list(candidates) if not default else candidate_paged_configs(
        kv, g, sc=sc_bits is not None)
    pages = c * mb + 1
    qs = _synth((c, kv, g, d), kv * 31 + d, q.dtype, dev)
    ks = _synth((pages, block, kv, d), block * 31 + d, q.dtype, dev)
    vs = _synth((pages, block, kv, d), block * 37 + d, q.dtype, dev)
    tbl = torch.from_numpy((np.arange(c * mb, dtype=np.int64) * 7919
                            % max(pages - 1, 1)).reshape(c, mb)
                           .astype(np.int32)).to(dev)
    qp = torch.full((c,), mb * block - 1, dtype=torch.int32, device=dev)
    cfg, us, times = _sweep(
        cands, lambda cf: best_of_us(
            lambda: paged_attention(qs, ks, vs, tbl, qp, window=window,
                                    sc_bits=sc_bits), iters, dev), key)
    del qs, ks, vs
    cache.put(key, cfg, elapsed_us=us, candidates=len(cands),
              default_us=times[0] if default else None)
    return cfg


def choose_impl(m: int, k: int, n: int, *, bits: int = 8,
                device=None) -> str:
    """Implementation behind ``sc_matmul(..., impl="auto")``: on the card
    the kernel with its tuned plan (``"pallas_tuned"``) for every shape —
    the kernel takes every SC-GEMM whose counts float32 holds exactly, and
    its wrapper refuses the rest, as every path must; on the CPU, where
    the kernel's plain version would only repeat the formulation, the
    plain ``"mxu_split"``, the JAX package's off-TPU answer. ``device``
    None is the card."""
    del m, k, n, bits
    dev = torch.device("cuda" if device is None else device)
    return "pallas_tuned" if dev.type == "cuda" else "mxu_split"
