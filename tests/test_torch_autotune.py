"""The port's autotuner (``repro_torch.kernels.autotune``) against the JAX
package's (``repro.kernels.autotune``), on the CPU: bucketing, candidate
grids and their first points, the JSON cache's behaviour (round trip,
stale, torn, foreign and invalid documents, concurrent writers, an
unwritable path), sweeps and hits, the R4 key rule, ``choose_impl``, the
tuned SC-GEMM's counts and the tuned stream multiplier against the JAX
package's, the tuned dispatch of a forward, and a capture's tuning pass
with the graph replaced by a test double. The card's side (every candidate
bitwise equal to the default plan, a captured step after its tuning pass)
is in ``tests/test_torch_gpu.py``.
"""
import ast
import dataclasses
import json
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.rules import CacheKeyCompleteness
from repro.core.sc_matmul import sc_matmul as jsc_matmul
from repro.core.sc_numerics import recover_counts as jrecover
from repro.kernels import autotune as jtune
from repro.kernels import ops as jops
from repro_torch.analysis.rules import \
    CacheKeyCompleteness as PortCacheKeyCompleteness
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.configs.shapes import Shape, sc_gemm_problems
from repro_torch.core.sc_matmul import sc_matmul
from repro_torch.errors import KernelLaunchError
from repro_torch.kernels import autotune, flash_attention, ops
from repro_torch.kernels import sc_matmul as skm
from repro_torch.kernels.autotune import (CACHE_KIND, CACHE_VERSION,
                                          AutotuneCache, FlashConfig,
                                          KernelConfig, PagedConfig,
                                          StreamConfig)
from repro_torch.kernels.paged_attention import RANKS
from repro_torch.kernels.sc_bitops import MAX_BLOCK_ROWS
from repro_torch.launch import steps
from repro_torch.models import bind, layers

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = dict(device="cpu", backend="cpu:sm0:v")


@pytest.fixture(autouse=True)
def _tuner_cache(tmp_path, monkeypatch):
    """Both packages' caches in the test's own directory, never the
    default paths."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------- bucketing

@pytest.mark.parametrize("m", range(1, 301))
def test_bucket_m_equals_the_jax_package(m):
    assert autotune.bucket_m(m) == jtune.bucket_m(m)
    assert autotune.SKINNY_M_MAX == jtune.SKINNY_M_MAX


def test_the_key_buckets_skinny_m_only():
    k3 = AutotuneCache.key(3, 256, 128, 8, **CPU)
    k8 = AutotuneCache.key(8, 256, 128, 8, **CPU)
    k9 = AutotuneCache.key(9, 256, 128, 8, **CPU)
    k65 = AutotuneCache.key(65, 256, 128, 8, **CPU)
    assert k3 == k8 != k9
    assert ":m8:" in k8 and ":m16:" in k9 and ":m65:" in k65


# ------------------------------------------------------------ candidates

GEMM_SHAPES = [(1, 64, 32), (4, 960, 960), (8, 960, 49152), (16, 2560, 960),
               (64, 960, 2560), (128, 14336, 3584), (128, 3584, 32000),
               (300, 100, 70), (5, 33, 17)]


@pytest.mark.parametrize("sms", [0, 132])
@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_sc_gemm_candidates_are_valid_and_pruned(m, k, n, sms):
    cands = autotune.candidate_configs(m, k, n, sms=sms)
    assert cands and len(cands) == len(set(cands))
    cover = min(1 << (max(m, 1) - 1).bit_length(), 16)
    for c in cands:
        assert c.is_valid() and c.fits()
        assert c.mr <= cover                      # no row tile past M
        assert c.kc % skm.K_STAGE == 0 and c.kc <= skm.K_BLOCK_MAX
        assert c.mr * c.kc <= skm.A_SMEM_ENTRIES
        assert c.splits(k) * c.kc >= k > (c.splits(k) - 1) * c.kc
    # no split at all is always a candidate where the rows fit
    assert any(c.splits(k) == 1 for c in cands) or \
        -(-k // skm.K_STAGE) * skm.K_STAGE > skm.K_BLOCK_MAX // cover


@pytest.mark.parametrize("sms", [0, 132])
@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_sc_gemm_grid_starts_at_todays_plan(m, k, n, sms):
    mr, kc, splits = skm.plan(m, n, k, sms)
    first = autotune.candidate_configs(m, k, n, sms=sms)[0]
    assert first == KernelConfig(mr, kc) and first.splits(k) == splits


@pytest.mark.parametrize("batch", [1, 32, 128])
@pytest.mark.parametrize("m,k,n", [(64, 4096, 1536), (64, 1536, 4096),
                                   (64, 5120, 8192), (4, 96, 40)])
def test_batched_grid_starts_at_the_batched_plan(m, k, n, batch):
    """A launch of ``batch`` expert problems: the same grid, today's plan
    for the whole launch first (its K split counting every expert's
    tiles), every point valid; one problem is the unbatched grid."""
    mr, kc, splits = skm.plan(m, n, k, 132, batch)
    cands = autotune.candidate_configs(m, k, n, sms=132, batch=batch)
    assert cands[0] == KernelConfig(mr, kc) and cands[0].splits(k) == splits
    assert all(c.is_valid() and c.fits() for c in cands)
    if batch == 1:
        assert cands == autotune.candidate_configs(m, k, n, sms=132)
    # more tiles never ask for more K ranges
    assert splits <= skm.plan(m, n, k, 132)[2]


def test_a_batched_launch_keys_apart_and_tunes_once(tmp_path, monkeypatch):
    """``:e<E>`` ends a batched key only (unbatched keys keep their form),
    and ``get_or_tune`` of rows ``(E, M, K)`` and a batched pack sweeps
    once under it, then hits for every batch of the bucket."""
    plain = AutotuneCache.key(64, 96, 40, 8, **CPU)
    batched = AutotuneCache.key(64, 96, 40, 8, experts=4, **CPU)
    assert batched == plain + ":e4" and ":e" not in plain
    pw = skm.pack_weight(torch.as_tensor(_normal(1, (4, 96, 40))), 8)
    cache = AutotuneCache(tmp_path / "tune.json")
    cands = autotune.candidate_configs(16, 96, 40, batch=4)
    timer = _Timer([9.0, 3.0] + [5.0] * len(cands))
    monkeypatch.setattr(autotune, "best_of_us", timer)
    sweeps = autotune.sweeps
    cfg = autotune.get_or_tune(torch.zeros((4, 16, 96)), pw, cache=cache)
    assert cfg == cands[1] and autotune.sweeps == sweeps + 1
    assert cache.keys() == [cache.key(16, 96, 40, 8, dtype=torch.float32,
                                      device="cpu", experts=4)]
    with autotune.lookup_only():
        assert autotune.get_or_tune(torch.zeros((4, 9, 96)), pw,
                                    cache=cache) == cfg


@pytest.mark.parametrize("m", [1, 3, 4, 8, 9, 33, 64])
def test_skinny_m_tiles(m):
    """A decode batch sweeps at its bucket: the grid offers every row tile
    up to the bucket's (GEMV-like 1, 2, 4 ... rows), the bucket's own
    first, and none larger."""
    b = autotune.bucket_m(m)
    cands = autotune.candidate_configs(b, 960, 960, sms=132)
    tiles = {c.mr for c in cands}
    assert cands[0].mr == min(b, 16)
    assert tiles == {t for t in autotune.MR_OPTIONS if t <= min(b, 16)}


@pytest.mark.parametrize("size", [1, 100, 128, 129, 511, 4096, 1 << 24])
def test_stream_candidates(size):
    cands = autotune.candidate_stream_configs(size)
    assert cands[0] == StreamConfig(MAX_BLOCK_ROWS)    # ops' default
    assert StreamConfig().block_rows == 8
    rows = -(-size // 128)
    for c in cands:
        assert c.is_valid() and c.fits()
        assert c.block_rows == MAX_BLOCK_ROWS or c.block_rows <= rows
    assert not StreamConfig(MAX_BLOCK_ROWS + 1).fits()


FLASH_SHAPES = [  # b, h, kv, sq, d, group, offset (-1: a tensor offset)
    (1, 15, 5, 16, 64, 64, -1), (1, 15, 5, 64, 64, 64, 0),
    (1, 32, 32, 128, 112, 64, -1), (1, 28, 4, 2048, 128, 64, 0),
    (2, 8, 8, 40, 64, 1024, 7), (1, 4, 1, 16, 128, 2048, 0)]


def _offset(off):
    return torch.tensor(3, dtype=torch.int32) if off < 0 else off


@pytest.mark.parametrize("esz,bits", [(2, None), (4, None), (2, 8), (4, 4)],
                         ids=["bf16", "f32", "sc8-bf16", "sc4-f32"])
@pytest.mark.parametrize("geom", FLASH_SHAPES)
def test_flash_candidates_are_valid_and_start_at_todays_plan(geom, esz,
                                                             bits):
    b, h, kv, sq, d, group, off = geom
    q_offset = _offset(off)
    for sms in (0, 132):
        p = flash_attention.plan(b, h, kv, sq, d, group, q_offset, bits,
                                 esz=esz, sms=sms)
        cands = autotune.candidate_flash_configs(
            b, h, kv, sq, d, group=group, q_offset=q_offset, sc_bits=bits,
            esz=esz, sms=sms)
        assert cands[0] == FlashConfig(p.heads, p.m_tiles)
        assert len(cands) == len(set(cands))
        tiles = flash_attention.m_tile_count(sq, q_offset)
        for c in cands:
            assert c.is_valid() and c.fits(p.path, d, group, esz)
            assert c.heads <= h // kv and c.m_tiles <= max(tiles, 1)
            t = flash_attention.plan(b, h, kv, sq, d, group, q_offset, bits,
                                     esz=esz, heads=c.heads,
                                     m_tiles=c.m_tiles)
            assert t.smem_bytes <= flash_attention.SMEM_MAX
            if p.path != "mma":
                assert c.m_tiles == 1
            else:
                assert c.heads * c.m_tiles <= flash_attention.MMA_MAX_WARPS
                assert t.threads == 32 * c.heads * c.m_tiles


def test_flash_resource_check_refuses_what_the_kernel_refuses():
    assert not FlashConfig(4, 4).fits("mma", 64, 64, 2)      # 16 warps
    assert not FlashConfig(1, 2).fits("f32", 64, 64, 4)      # one m-tile
    assert not FlashConfig(16, 1).fits("f32", 128, 64, 4)    # shared memory
    assert not FlashConfig(8, 1).fits("sc", 128, 2048, 2)    # shared memory
    assert FlashConfig(1, 1).fits("sc", 128, 2048, 2)


@pytest.mark.parametrize("kv,g", [(1, 1), (2, 1), (5, 3), (1, 8), (32, 1)])
@pytest.mark.parametrize("sc", [False, True])
def test_paged_grid_is_one_point_and_the_eligibility_gate(kv, g, sc):
    cands = autotune.candidate_paged_configs(kv, g, sc=sc)
    assert cands in ([], [PagedConfig()])
    assert PagedConfig().ranks == RANKS and PagedConfig().fits()
    assert not PagedConfig(RANKS // 2).fits()
    assert bool(cands) == layers._paged_kernel_eligible(
        g, kv, None, sc_bits=8 if sc else None)
    assert bool(cands) == (sc or (kv, g) != (1, 1))


# --------------------------------------------------------------------- cache

def test_cache_roundtrip_across_instances(tmp_path):
    path = tmp_path / "tune.json"
    cache = AutotuneCache(path)
    key = cache.key(64, 200, 40, 8, **CPU)
    assert cache.get(key) is None
    cfg = KernelConfig(mr=4, kc=128)
    cache.put(key, cfg, elapsed_us=123.4, candidates=7)
    assert cache.get(key) == cfg
    reloaded = AutotuneCache(path)
    assert len(reloaded) == 1 and reloaded.get(key) == cfg
    doc = json.loads(path.read_text())
    assert doc["version"] == CACHE_VERSION and doc["kind"] == CACHE_KIND
    assert doc["entries"][key]["us_per_call"] == pytest.approx(123.4)
    assert reloaded.entry(key)["candidates"] == 7


def test_keys_carry_mode_device_and_kernel_version():
    k_cpu = AutotuneCache.key(64, 200, 40, 8, device="cpu")
    k_card = AutotuneCache.key(64, 200, 40, 8, device="cuda",
                               backend="NVIDIA_H100:sm132:abc")
    assert k_cpu.startswith("sc_gemm:cpu:cpu:sm0:") and \
        k_card.startswith("sc_gemm:cuda:NVIDIA_H100:sm132:abc:")
    version = autotune.build.source_hash("sc_matmul")
    assert f":{version}:" in k_cpu
    assert AutotuneCache.key(64, 200, 40, 8, dtype=torch.bfloat16,
                             **CPU).endswith(":bfloat16:b8")
    f_dev = AutotuneCache.flash_key(1, 15, 5, 16, flash_attention.m_tile_count(
        16, torch.tensor(0, dtype=torch.int32)), 64, 64, True, group=64,
        **CPU)
    f_host = AutotuneCache.flash_key(1, 15, 5, 16, flash_attention.m_tile_count(
        16, 0), 64, 64, True, group=64, **CPU)
    assert ":mt2:" in f_dev and ":mt1:" in f_host
    assert ":sc0" in f_host and AutotuneCache.flash_key(
        1, 15, 5, 16, 1, 64, 64, True, group=64, sc_bits=8,
        **CPU).endswith(":sc8")
    p = AutotuneCache.paged_key(4, 5, 3, 64, 64, 4, None, **CPU)
    assert p.startswith("paged:cpu:") and ":w0:" in p
    assert AutotuneCache.stream_key(100, 12, **CPU).startswith("sc_stream:")


@pytest.mark.parametrize("doc", [
    {"kind": CACHE_KIND, "version": CACHE_VERSION - 1},
    {"kind": CACHE_KIND, "version": CACHE_VERSION + 1},
    {"version": CACHE_VERSION},                          # no kind
    {"kind": "repro.autotune", "version": CACHE_VERSION},
    {"version": jtune.CACHE_VERSION}],                   # the JAX tuner's
    ids=["stale", "future", "kindless", "foreign-kind", "jax-document"])
def test_cache_discards_stale_and_foreign_documents(tmp_path, doc):
    path = tmp_path / "tune.json"
    key = AutotuneCache.key(8, 512, 512, 8, **CPU)
    path.write_text(json.dumps(doc | {"entries": {key: {"mr": 8,
                                                         "kc": 256}}}))
    cache = AutotuneCache(path)
    assert len(cache) == 0 and cache.get(key) is None
    cache.put(key, KernelConfig(4, 64))
    healed = json.loads(path.read_text())
    assert healed["kind"] == CACHE_KIND
    assert healed["version"] == CACHE_VERSION and len(healed["entries"]) == 1


@pytest.mark.parametrize("text", ["{not json", '{"kind": "repro_torch.auto',
                                  "", "[1, 2]"])
def test_cache_tolerates_torn_and_corrupt_files(tmp_path, text):
    path = tmp_path / "tune.json"
    path.write_text(text)
    cache = AutotuneCache(path)
    assert len(cache) == 0
    cache.put(cache.key(1, 2, 3, 8, **CPU), KernelConfig())
    assert len(AutotuneCache(path)) == 1


def test_cache_tolerates_foreign_entries_table(tmp_path):
    path = tmp_path / "tune.json"
    head = {"kind": CACHE_KIND, "version": CACHE_VERSION}
    path.write_text(json.dumps(head | {"entries": ["not", "a", "map"]}))
    assert len(AutotuneCache(path)) == 0
    path.write_text(json.dumps(head | {"entries": {
        "good": {"mr": 8, "kc": 128}, "bad": 42}}))
    cache = AutotuneCache(path)
    assert len(cache) == 1 and cache.get("good") == KernelConfig(8, 128)


@pytest.mark.parametrize("entry", [
    {"mr": 3, "kc": 128}, {"mr": 8, "kc": 100}, {"mr": 8, "kc": 0},
    {"mr": 8}, {"mr": "8", "kc": 128}, {"mr": 8.0, "kc": 128},
    {"mr": True, "kc": 128}])
def test_cache_ignores_an_invalid_entry(tmp_path, entry):
    cache = AutotuneCache(tmp_path / "tune.json")
    key = cache.key(4, 4, 4, 8, **CPU)
    cache._entries[key] = entry
    assert cache.get(key) is None


def test_a_hit_the_kernel_cannot_take_is_a_miss(tmp_path):
    """An entry that is valid but beyond the wrapper's limits (a scribbled
    file) is swept again, never launched."""
    cache = AutotuneCache(tmp_path / "tune.json")
    a = torch.zeros((4, 64))
    pw = skm.pack_weight(torch.ones((64, 32)), 8)
    key = cache.key(4, 64, 32, 8, dtype=torch.float32, device="cpu")
    cache._entries[key] = {"mr": 16, "kc": 8192}
    assert cache.get(key) == KernelConfig(16, 8192)
    cfg = autotune.get_or_tune(a, pw, cache=cache, iters=1)
    assert cfg.fits() and cache.get(key) == cfg


def test_cache_concurrent_writers_merge(tmp_path):
    path = tmp_path / "tune.json"
    c1, c2 = AutotuneCache(path), AutotuneCache(path)
    k1 = c1.key(128, 256, 128, 8, **CPU)
    k2 = c2.key(256, 512, 256, 8, **CPU)
    c1.put(k1, KernelConfig(16, 128))
    c2.put(k2, KernelConfig(16, 256))
    merged = AutotuneCache(path)
    assert merged.get(k1) == KernelConfig(16, 128)
    assert merged.get(k2) == KernelConfig(16, 256)


def _survivors(path, tags, n):
    merged = AutotuneCache(path)
    return {t: [i for i in range(n)
                if merged.get(f"sc_gemm:cpu:x:m{t}:k{i}:n1:float32:b8")
                == KernelConfig(8, 64)] for t in tags}


def _check_merge(path, tags, n):
    """Every writer's keys survive (the writers hold the cache's file lock
    from the re-read to the rename), and the document is never torn."""
    doc = json.loads(path.read_text())
    assert doc["kind"] == CACHE_KIND and doc["version"] == CACHE_VERSION
    alive = _survivors(path, tags, n)
    assert all(v == list(range(n)) for v in alive.values()), alive


def test_cache_concurrent_writer_threads(tmp_path):
    path = tmp_path / "tune.json"
    tags, n = ("a", "b", "c", "d"), 10
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def writer(tag):
            cache = AutotuneCache(path)
            for i in range(n):
                cache.put(f"sc_gemm:cpu:x:m{tag}:k{i}:n1:float32:b8",
                          KernelConfig(8, 64), elapsed_us=1.0 + i)

        threads = [threading.Thread(target=writer, args=(t,)) for t in tags]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    _check_merge(path, tags, n)


def test_cache_concurrent_writer_processes(tmp_path):
    path = tmp_path / "tune.json"
    writer = textwrap.dedent("""
        import sys, time
        from repro_torch.kernels.autotune import AutotuneCache, KernelConfig
        path, tag = sys.argv[1], sys.argv[2]
        cache = AutotuneCache(path)
        for i in range(10):
            cache.put(f"sc_gemm:cpu:x:m{tag}:k{i}:n1:float32:b8",
                      KernelConfig(8, 64), elapsed_us=1.0 + i)
            time.sleep(0.01)
    """)
    procs = [subprocess.Popen(
        [sys.executable, "-c", writer, str(path), tag],
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path), "OMP_NUM_THREADS": "1"})
        for tag in ("a", "b")]
    for p in procs:
        assert p.wait(timeout=120) == 0
    _check_merge(path, ("a", "b"), 10)


def test_cache_unwritable_path_degrades_to_memory():
    cache = AutotuneCache("/proc/nonexistent-dir/tune.json")
    key = cache.key(1, 2, 3, 8, **CPU)
    cache.put(key, KernelConfig())
    assert cache.get(key) == KernelConfig()


def test_cache_unwritable_lock_degrades_to_memory(tmp_path):
    """A lock file that cannot be opened (here a directory stands at its
    path) leaves the cache in memory, as an unwritable cache does."""
    cache = AutotuneCache(tmp_path / "tune.json")
    cache.lock_path.mkdir()
    key = cache.key(1, 2, 3, 8, **CPU)
    cache.put(key, KernelConfig())
    assert cache.get(key) == KernelConfig()
    assert not cache.path.exists()
    assert [p.name for p in tmp_path.iterdir()] == [cache.lock_path.name]


def test_default_path_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv(autotune.CACHE_ENV)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert autotune.default_cache_path() == \
        tmp_path / "repro_torch" / "autotune.json"
    assert autotune.CACHE_ENV != jtune.CACHE_ENV
    assert autotune.default_cache_path() != jtune.default_cache_path()


# ----------------------------------------------------------------- sweeps

class _Timer:
    """A counting stand-in for ``best_of_us``: each call runs the call
    once and returns the next preset time."""

    def __init__(self, times):
        self.times, self.calls = list(times), 0

    def __call__(self, call, iters, device=None):
        call()
        self.calls += 1
        return self.times[(self.calls - 1) % len(self.times)]


def test_get_or_tune_sweeps_then_hits_the_cache(tmp_path, monkeypatch):
    a = torch.as_tensor(_normal(0, (5, 96)))
    pw = skm.pack_weight(torch.as_tensor(_normal(1, (96, 40))), 8)
    cache = AutotuneCache(tmp_path / "tune.json")
    cands = autotune.candidate_configs(8, 96, 40)
    timer = _Timer([9.0, 3.0] + [5.0] * len(cands))
    monkeypatch.setattr(autotune, "best_of_us", timer)
    sweeps = autotune.sweeps
    cfg = autotune.get_or_tune(a, pw, cache=cache)
    assert timer.calls == len(cands) and cfg == cands[1]
    assert autotune.sweeps == sweeps + 1 and len(cache) == 1
    ent = cache.entry(cache.key(5, 96, 40, 8, device="cpu"))
    assert ent["us_per_call"] == 3.0 and ent["default_us"] == 9.0
    assert ent["candidates"] == len(cands)
    # every batch of the bucket is a hit: no timer call, no sweep
    for m in (1, 8):
        rows = torch.zeros((m, 96))
        assert autotune.get_or_tune(rows, pw, cache=cache) == cfg
    with autotune.lookup_only():
        assert autotune.get_or_tune(a, pw, cache=cache) == cfg
    assert timer.calls == len(cands) and autotune.sweeps == sweeps + 1
    # a new cache instance on the file hits too
    assert autotune.get_or_tune(a, pw, cache=AutotuneCache(
        tmp_path / "tune.json")) == cfg
    assert timer.calls == len(cands)


def test_autotune_returns_the_best_of_candidates(monkeypatch):
    a = torch.as_tensor(_normal(2, (16, 32)))
    pw = skm.pack_weight(torch.as_tensor(_normal(3, (32, 16))), 8)
    cands = [KernelConfig(16, 32), KernelConfig(8, 32), KernelConfig(4, 32)]
    monkeypatch.setattr(autotune, "best_of_us", _Timer([7.0, 8.0, 2.5]))
    assert autotune.autotune(a, pw, candidates=cands) == (cands[2], 2.5)
    cfg, us = autotune.autotune(a, pw, candidates=cands, max_candidates=2)
    assert cfg in cands[:2] and us > 0


def test_best_of_us_times_on_the_host_clock_off_the_card():
    calls = []
    us = autotune.best_of_us(lambda: calls.append(1), 3, "cpu")
    assert us >= 0 and len(calls) == 4            # one warm-up, 3 samples


def test_a_sweep_puts_the_launch_counters_back():
    counters = ops.launch_counters()
    before = {n: c.launches for n, c in counters.items()}

    def launching(cfg):
        for c in counters.values():
            c.launches += 5
        return float(cfg)

    assert autotune._sweep([3, 1, 2], launching, "probe")[:2] == (1, 1.0)
    assert {n: c.launches for n, c in counters.items()} == before
    with pytest.raises(ValueError, match="no tuning candidates"):
        autotune._sweep([], launching, "probe")


def test_a_miss_inside_lookup_only_raises_and_sweeps_nothing(tmp_path):
    cache = AutotuneCache(tmp_path / "tune.json")
    a = torch.zeros((4, 64))
    pw = skm.pack_weight(torch.ones((64, 32)), 8)
    sweeps = autotune.sweeps
    with autotune.lookup_only():
        with pytest.raises(KernelLaunchError, match="lookup-only"):
            autotune.get_or_tune(a, pw, cache=cache)
        with pytest.raises(KernelLaunchError, match="lookup-only"):
            autotune.get_or_tune_stream(torch.zeros(10, dtype=torch.int32),
                                        torch.zeros(10, dtype=torch.int32),
                                        cache=cache)
    assert autotune.sweeps == sweeps and len(cache) == 0
    autotune.get_or_tune(a, pw, cache=cache, iters=1)     # outside: sweeps
    assert autotune.sweeps == sweeps + 1


def test_synthetic_operands_are_seeded_and_repeat_past_the_block():
    a = autotune._synth((3, 5), 7, torch.float32, "cpu")
    b = autotune._synth((3, 5), 7, torch.float32, "cpu")
    assert torch.equal(a, b)
    big = autotune._synth((3, autotune.SYNTH_BLOCK), 1, torch.int16, "cpu",
                          -255, 255)
    assert big.dtype == torch.int16 and int(big.abs().max()) <= 255
    assert torch.equal(big[1], big[0]) and not torch.equal(big[0, :9],
                                                           big[0, 1:10])


def test_flash_and_paged_tuners_key_sweep_and_hit(tmp_path):
    """On the CPU the flash and paged tuners key, time (their plain
    versions) and cache; an offset held on the card keys the worst-case
    launch; the paged grid is its one point."""
    cache = AutotuneCache(tmp_path / "tune.json")
    q = torch.as_tensor(_normal(4, (1, 6, 16, 16)))
    kv = torch.as_tensor(_normal(5, (1, 2, 32, 16)))
    off = torch.tensor(8, dtype=torch.int32)
    cfg = autotune.get_or_tune_flash(q, kv, kv, q_offset=off, group=8,
                                     cache=cache, iters=1)
    cands = autotune.candidate_flash_configs(1, 6, 2, 16, 16, group=8,
                                             q_offset=off, esz=4)
    assert cfg in cands
    (key,) = cache.keys()
    assert ":mt2:" in key and ":float32:" in key and key.endswith(":sc0")
    sweeps = autotune.sweeps
    with autotune.lookup_only():
        assert autotune.get_or_tune_flash(q, kv, kv, q_offset=off, group=8,
                                          cache=cache) == cfg
    assert autotune.sweeps == sweeps
    pq = torch.as_tensor(_normal(6, (3, 2, 3, 16)))
    pages = torch.as_tensor(_normal(7, (7, 4, 2, 16)))
    tables = torch.arange(6, dtype=torch.int32).reshape(3, 2)
    pos = torch.tensor([0, 3, 7], dtype=torch.int32)
    assert autotune.get_or_tune_paged(pq, pages, pages, tables, pos,
                                      sc_bits=8, cache=cache,
                                      iters=1) == PagedConfig()
    assert any(k.startswith("paged:cpu:") and k.endswith(":sc8")
               for k in cache.keys())


# -------------------------------------------------- R4: key completeness

def _r4(src: str, path: str = "src/repro_torch/kernels/autotune.py",
        rule=CacheKeyCompleteness):
    return list(rule().check(ast.parse(src), src, path))


def test_the_ports_cache_keys_pass_r4():
    """The JAX package's R4 and the port's own (``repro_torch.analysis``)
    agree on the port's key builders."""
    src = (SRC / "repro_torch" / "kernels" / "autotune.py").read_text()
    for rule in (CacheKeyCompleteness, PortCacheKeyCompleteness):
        assert _r4(src, rule=rule) == []
        # the rule reads the key builders: a key without the device/kernel
        # segment, or without the mode, is a finding
        broken = src.replace(
            'f"sc_gemm:{_mode(device)}:{backend}:m{bucket_m(m)}',
            'f"sc_gemm:m{bucket_m(m)}')
        assert broken != src and len(_r4(broken, rule=rule)) == 1
        broken = src.replace('f"sc_stream:{_mode(device)}:{backend}:s{size}',
                             'f"sc_stream:{backend}:s{size}')
        assert broken != src and len(_r4(broken, rule=rule)) == 1


# ---------------------------------------------------------- choose_impl

@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (4, 128, 128), (8, 64, 128),
                                   (64, 960, 49152), (512, 512, 512),
                                   (2048, 4096, 4096), (3, 5000, 7)])
@pytest.mark.parametrize("bits", [4, 8, 12])
def test_choose_impl_equals_the_jax_package_off_the_card(m, k, n, bits):
    want = jtune.choose_impl(m, k, n, bits=bits)
    assert autotune.choose_impl(m, k, n, bits=bits, device="cpu") == want
    assert autotune.choose_impl(m, k, n, bits=bits,
                                device="cuda") == "pallas_tuned"


# --------------------------------------------- tuned paths vs the JAX tuner

@pytest.mark.parametrize("row_quant", [True, False])
@pytest.mark.parametrize("m,k,n,bits", [(40, 96, 24, 8), (5, 70, 33, 6)])
def test_pallas_tuned_counts_equal_the_jax_packages(m, k, n, bits,
                                                     row_quant, tmp_path):
    a, b = _normal(m * 3 + k, (m, k)), _normal(n * 5 + k, (k, n))
    j = jsc_matmul(jnp.asarray(a), jnp.asarray(b), bits=bits,
                   impl="pallas_tuned", row_quant=row_quant)
    t = sc_matmul(torch.as_tensor(a), torch.as_tensor(b), bits=bits,
                  impl="pallas_tuned", row_quant=row_quant)
    np.testing.assert_array_equal(
        jrecover(t.numpy(), a, b, bits=bits, row_quant=row_quant),
        jrecover(np.asarray(j), a, b, bits=bits, row_quant=row_quant))
    doc = json.loads((tmp_path / "autotune.json").read_text())
    dtype = "float32" if row_quant else str(skm.plane_dtype(bits))[6:]
    assert list(doc["entries"]) == [AutotuneCache.key(
        m, k, n, bits, dtype=dtype, device="cpu")]


def test_tuned_stream_multiply_equals_the_jax_packages(tmp_path):
    rng = np.random.default_rng(9)
    x = rng.integers(0, 256, size=(3, 700)).astype(np.int32)
    y = rng.integers(0, 256, size=(3, 700)).astype(np.int32)
    want = np.asarray(jops.sc_stream_mul(jnp.asarray(x.reshape(-1)),
                                         jnp.asarray(y.reshape(-1)), bits=8,
                                         tune=True)).reshape(3, 700)
    got = ops.sc_stream_mul(torch.as_tensor(x), torch.as_tensor(y), bits=8,
                            tune=True)
    np.testing.assert_array_equal(got.numpy(), want)
    doc = json.loads((tmp_path / "autotune.json").read_text())
    (key,) = doc["entries"]
    assert key.startswith("sc_stream:cpu:") and key.endswith(":s2100:b8")
    assert doc["entries"][key]["block_rows"] in (1, 2, 4, 8)


# -------------------------------------------------------- tuned dispatch

_DISPATCH_CFG = ModelConfig(
    name="dispatch-probe", family="dense", n_layers=2, d_model=48, n_heads=4,
    n_kv_heads=2, head_dim=12, d_ff=96, vocab_size=64, dtype="float32",
    loss_chunk=16).validate()


def test_a_tuned_forward_keys_every_problem_and_equals_ref(tmp_path):
    """A prefill with ``sc_impl="pallas_tuned"`` writes one ``sc_gemm:``
    key for each of ``sc_gemm_problems`` at its shape (the projections at
    32 rows, the head at the batch's 2) and its hidden state and logits
    equal ``"ref"``'s."""
    cfg = dataclasses.replace(_DISPATCH_CFG, use_sc_gemm=True,
                              sc_impl="pallas_tuned").validate()
    m = bind(cfg, "cpu")
    params = m.init_params(0)
    batch = {"tokens": torch.ones((2, 16), dtype=torch.int32)}
    with torch.no_grad():
        hidden, _ = m.forward_hidden(params, batch)
        logits, _ = m.prefill_step(params, batch)
    assert bool(torch.isfinite(hidden).all())
    doc = json.loads((tmp_path / "autotune.json").read_text())
    keys = {k for k in doc["entries"] if k.startswith("sc_gemm:")}
    shape = Shape("probe", 16, 2, "prefill")
    assert keys == {AutotuneCache.key(mm, k, n, 8, device="cpu")
                    for mm, k, n in sc_gemm_problems(cfg, shape)}
    ref = bind(dataclasses.replace(cfg, sc_impl="ref"), "cpu")
    with torch.no_grad():
        assert torch.equal(hidden, ref.forward_hidden(params, batch)[0])
        assert torch.equal(logits, ref.prefill_step(params, batch)[0])


def test_the_card_resolves_auto_through_the_tuner_only_there(monkeypatch):
    """``"auto"`` on the CPU never reaches the tuner (no sweep, no file);
    ``"pallas_tuned"`` does."""
    cfg = dataclasses.replace(ARCHS["smollm-360m"].reduced(dtype="float32"),
                              use_sc_gemm=True, sc_impl="auto").validate()
    seen = []
    real = autotune.get_or_tune
    monkeypatch.setattr(autotune, "get_or_tune",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    from repro_torch.core import sc_layers
    monkeypatch.setattr(sc_layers, "get_or_tune", autotune.get_or_tune)
    x = torch.as_tensor(_normal(8, (3, 64)))
    w = torch.as_tensor(_normal(9, (64, 16)))
    pw = skm.pack_weight(w, 8)
    auto = sc_layers.sc_proj(x, w, cfg, pw)
    assert not seen
    tuned = sc_layers.sc_proj(x, w, dataclasses.replace(
        cfg, sc_impl="pallas_tuned"), pw)
    assert seen == [1] and torch.equal(auto, tuned)


# ------------------------------------------------ the capture's tuning pass

def _tuning_capture(step):
    """The test double of ``steps.capture``: its tuning pass, then its
    warm-up runs eagerly inside the lookup-only scope (no graph on the
    CPU)."""
    steps.tune(step)
    swept = autotune.sweeps
    with autotune.lookup_only():
        for _ in range(steps.WARMUP_RUNS):
            step.reset()
            step.run()
        step.reset()
    step.capture_sweeps = autotune.sweeps - swept
    step.captures += 1


@pytest.fixture
def doubled(monkeypatch):
    passes = []
    real = steps.tune
    monkeypatch.setattr(steps, "tune",
                        lambda step: passes.append(step) or real(step))
    monkeypatch.setattr(steps, "capture", _tuning_capture)
    steps.clear_decode_steps()
    yield passes
    steps.clear_decode_steps()


def _tuned_cfg():
    return dataclasses.replace(
        ARCHS["smollm-360m"].reduced(dtype="float32"), use_sc_gemm=True,
        sc_impl="pallas_tuned", attn_kernel="pallas_tuned",
        paged_attn_kernel="pallas_tuned").validate()


def test_a_doubled_capture_tunes_once_then_looks_up(doubled):
    """Each capture runs its tuning pass once; every sweep happens there
    and none in the lookup-only warm-up; a second engine of the shape
    captures nothing and sweeps nothing; streams equal the eager engine's
    on the same tuned plans."""
    from repro_torch.serving import Engine, Request
    cfg = _tuned_cfg()
    params = bind(cfg, "cpu").init_params(0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, size=(n,)).astype(np.int32)
               for n in (6, 9, 4)]

    def requests(tag):
        return [Request(uid=f"{tag}{i}", prompt=p, max_new_tokens=4)
                for i, p in enumerate(prompts)]

    kw = dict(device="cpu", capacity=2, max_seq=16, block=4, chunk=4,
              prefix_cache=False)
    sweeps0 = autotune.sweeps
    eng = Engine(cfg, params, graphs=True, **kw)
    res = eng.run(requests("a"))
    entries = [eng._decode, *eng.prefill_steps().values()]
    assert len(doubled) == len(entries) >= 2
    assert all(s.captures == 1 and s.capture_sweeps == 0 for s in entries)
    assert sum(s.tuning_sweeps for s in entries) == \
        autotune.sweeps - sweeps0 > 0
    swept = autotune.sweeps
    again = Engine(cfg, params, graphs=True, **kw)
    again_res = again.run(requests("b"))
    assert len(doubled) == len(entries) and autotune.sweeps == swept
    eager = Engine(cfg, params, graphs=False, **kw).run(requests("c"))
    for r, s, e in zip(res, again_res, eager):
        np.testing.assert_array_equal(r.tokens, e.tokens)
        np.testing.assert_array_equal(s.tokens, e.tokens)


def test_a_miss_inside_the_lookup_only_scope_raises(doubled, tmp_path,
                                                     monkeypatch):
    """Without its tuning pass a step's first run inside the lookup-only
    scope finds an empty cache and raises, sweeping nothing."""
    cfg = _tuned_cfg()
    m = bind(cfg, "cpu")
    step = steps.DecodeStep(m, m.init_params(0), m.init_cache(2, 8),
                            capacity=2)
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "empty.json"))
    sweeps = autotune.sweeps
    with autotune.lookup_only(), pytest.raises(KernelLaunchError,
                                               match="lookup-only"):
        step.run()
    assert autotune.sweeps == sweeps
    assert steps.tune(step) > 0 and step.tuning_sweeps > 0
    with autotune.lookup_only():
        step.run()
