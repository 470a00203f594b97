"""The paged decode kernel's launch plan (``kernels/paged_attention.py``
``plan``, ``rank_tiles``), held on the CPU: the kernel itself is CUDA and
runs only on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).

The plan is a pure function of the shapes. These tests hold what the
kernel's correctness and invariances rest on: shared memory fits a block
for every registered model, the SC score workspace is taken exactly when
a rank's share of scores does not fit its budget, and which rank walks a
key tile depends on the key index alone — never on the page size, the
table width or the other slots.
"""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.paged_attention import (RANKS, SC_ROW_SMEM_BYTES,
                                                 TILE, plan, rank_tiles)

torch.set_num_threads(2)

#: Dynamic shared memory a Hopper block may use (232,448 bytes).
SMEM_MAX = 227 * 1024
CSRC = Path(pa.__file__).resolve().parent / "csrc" / "paged_attention.cu"


def _share(row_keys):
    """Score slots a rank keeps per query row, counted independently: the
    row's tiles dealt round-robin over the ranks, rank 0 the first."""
    tiles = -(-row_keys // TILE)
    return -(-tiles // RANKS) * TILE


@pytest.mark.parametrize("keys", [4096, 32768])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_shared_memory_fits_every_registered_config(arch, keys):
    cfg = ARCHS[arch]
    g, d = cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    for esz in (2, 4):
        for bits in (None, 4, 8):
            for block in (16, 64, 256):
                p = plan(4, cfg.n_kv_heads, g, d, block, keys // block, bits,
                         esz=esz)
                assert p.smem_bytes <= SMEM_MAX, (esz, bits, block, p)
                assert p.grid == (RANKS, 4, cfg.n_kv_heads)


@pytest.mark.parametrize("g", [1, 3, 4, 16])
def test_workspace_is_chosen_exactly_when_a_share_exceeds_its_budget(g):
    # the longest row whose share still fits, then one tile more
    fits = SC_ROW_SMEM_BYTES // (4 * g) // TILE * TILE * RANKS
    for row_keys in (TILE, fits - TILE, fits - 1, fits, fits + 1,
                     fits + TILE, 4 * fits):
        share = _share(row_keys)
        p = plan(2, 5, g, 64, 1, row_keys, 8)
        assert p.share == share
        if g * share * 4 > SC_ROW_SMEM_BYTES:
            assert p.workspace == (2, 5, RANKS, g, share), row_keys
        else:
            assert p.workspace is None, row_keys
    assert plan(2, 5, g, 64, 1, fits, 8).workspace is None
    assert plan(2, 5, g, 64, 1, fits + 1, 8).workspace is not None


@pytest.mark.parametrize("window", [None, 1, 7, 300, 5000])
@pytest.mark.parametrize("pos", [-1, 0, 31, 32, 255, 700, 1000, 4095, 9599])
def test_tile_owner_depends_on_the_key_index_alone(pos, window):
    """Every tile the slot attends is walked by exactly one rank, the one
    congruent to its index, in ascending order, whatever the table's row
    length (page size times table width) as long as the row holds pos."""
    last = pos
    first = max(0, pos - window + 1) if window else 0
    want = list(range(first // TILE, last // TILE + 1)) if pos >= 0 else []
    for row_keys in (pos + 1, pos + 17, 2 * pos + 64, 10240):
        if row_keys <= 0:
            continue
        walked = []
        for rank in range(RANKS):
            tiles = list(rank_tiles(rank, pos, row_keys, window))
            assert tiles == sorted(tiles)
            assert all(t % RANKS == rank for t in tiles)
            assert len(tiles) * TILE <= _share(row_keys)
            walked += tiles
        assert sorted(walked) == want


def test_a_row_longer_than_the_table_is_cut_at_its_end():
    assert list(rank_tiles(0, 5000, 1024)) == list(range(0, 32, RANKS))
    assert list(rank_tiles(3, 5000, 1024, window=2000)) == []


@pytest.mark.parametrize("bits", [None, 4, 8])
def test_plan_depends_on_the_batch_only_through_the_grid(bits):
    one = plan(1, 5, 3, 64, 64, 4, bits)
    for c in (2, 4, 64, 256):
        many = plan(c, 5, 3, 64, 64, 4, bits)
        assert many.grid == (RANKS, c, 5)
        assert many._replace(grid=one.grid, workspace=one.workspace) == one


@pytest.mark.parametrize("bits", [None, 8])
def test_plan_does_not_depend_on_the_page_size_at_one_row_length(bits):
    plans = {block: plan(4, 5, 3, 64, block, 4096 // block, bits)
             for block in (16, 32, 64, 128, 256, 4096)}
    assert len(set(plans.values())) == 1


def test_constants_match_the_kernel_source():
    src = CSRC.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kRanks"]) == RANKS
    assert int(consts["kTile"]) == TILE
    assert int(consts["kThreads"]) == pa.THREADS


@pytest.mark.parametrize("entry,path", [
    ("paged_attention_f32", "float"), ("paged_attention_bf16", "float"),
    ("paged_attention_sc_f32", "sc"), ("paged_attention_sc_bf16", "sc")])
def test_argument_types_match_the_c_entries(entry, path):
    """ctypes passes what ARGTYPES says: a pointer typed as an int would be
    cut to 32 bits, a float passed as an int reinterpreted."""
    src = CSRC.read_text()
    m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src)
    kinds = {"void*": "ptr", "int": "int",
             "float": "float"}
    params = [re.sub(r"\s+\w+$", "", p.strip()).replace("const ", "")
              .replace(" ", "") for p in m.group(1).split(",")]
    want = [kinds[p] for p in params]
    names = {pa._PTR: "ptr", pa._I32: "int", pa._F32: "float"}
    assert [names[t] for t in pa.ARGTYPES[path]] == want
