"""The flash kernel's launch plan (``kernels/flash_attention.py`` ``plan``,
``smem_bytes``, ``row_tile``), held on the CPU: the kernel itself is CUDA
and runs only on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).

The plan is a pure function of the shapes. These tests hold what the
kernel's correctness and invariances rest on: shared memory fits a block
for every registered config whose attention the kernel serves, at the
registered group (1024) and at ``MAX_GROUP``; the C constants and entry
signatures agree with the wrapper; and a query row's m-tile and slot
depend on its absolute position alone, so a chunk and the one-shot call
place it alike.
"""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import (BLOCK_Q, MAX_D, MAX_GROUP,
                                                 SMEM_MAX, TILE_K, plan,
                                                 row_tile, smem_bytes)
from repro_torch.models.layers import _flash_kernel_eligible

torch.set_num_threads(2)

CSRC = Path(fa.__file__).resolve().parent / "csrc" / "flash_attention.cu"


def _eligible(cfg) -> bool:
    """A config whose prefill attention the kernel serves on some layer:
    causal, no window on that layer, no softcap, at its head dim and
    group."""
    if cfg.family == "ssm":
        return False
    return any(_flash_kernel_eligible(causal=True, window=w,
                                      logit_softcap=cfg.attn_softcap,
                                      bf16_probs=False,
                                      kv_block=cfg.kv_block,
                                      d=cfg.head_dim)
               for w in cfg.windows)


ELIGIBLE = sorted(n for n, c in ARCHS.items() if _eligible(c))


def test_the_kernel_serves_every_dense_family_it_served_before():
    """MAX_D and MAX_GROUP cover every registered config that the kernel
    is meant for: smollm, qwen2, qwen2.5 and musicgen widths among them."""
    for name in ("smollm-360m", "qwen2-7b", "qwen2.5-14b", "musicgen-large",
                 "qwen2-vl-2b", "qwen3-moe-235b-a22b", "zamba2-7b",
                 "llama4-maverick-400b-a17b"):
        assert name in ELIGIBLE, name
    assert all(ARCHS[n].head_dim <= MAX_D for n in ELIGIBLE)
    assert all(ARCHS[n].kv_block <= MAX_GROUP for n in ELIGIBLE)


@pytest.mark.parametrize("group", [1024, MAX_GROUP])
@pytest.mark.parametrize("arch", ELIGIBLE)
def test_shared_memory_fits_every_eligible_config(arch, group):
    cfg = ARCHS[arch]
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for esz in (2, 4):
        for bits in (None, 2, 4, 8):
            for sq, off in ((2048, 0), (16, 2032), (64, 0), (5, 290)):
                p = plan(2, h, kv, sq, d, group, off, bits, esz=esz)
                assert p.smem_bytes <= SMEM_MAX, (esz, bits, sq, p)
                assert 1 <= p.heads <= h // kv
                assert p.threads <= 1024 and p.threads % 32 == 0
                assert p.grid[1] == kv * -(-(h // kv) // p.heads)
                assert p.grid[2] == 2


@pytest.mark.parametrize("arch", ["smollm-360m", "musicgen-large"])
def test_sc_blocks_share_every_head_of_a_kv_head_at_the_registered_group(
        arch):
    """At group 1024 and D 64 one SC block serves all G heads of its KV
    head, so each K and V row is quantized once per block for all of
    them."""
    cfg = ARCHS[arch]
    g = cfg.n_heads // cfg.n_kv_heads
    for esz in (2, 4):
        p = plan(1, cfg.n_heads, cfg.n_kv_heads, 2048, cfg.head_dim, 1024,
                 0, 8, esz=esz)
        assert p.heads == g and p.grid[1] == cfg.n_kv_heads


@pytest.mark.parametrize("g", [1, 2, 3, 4, 5, 7, 8, 16])
def test_bf16_blocks_hold_every_head_up_to_eight_warps(g):
    p = plan(1, 4 * g, 4, 2048, 128, 1024, 0, None, esz=2)
    assert p.path == "mma"
    assert p.heads == min(g, 8)
    assert p.threads == 32 * p.heads * p.m_tiles <= 256
    assert p.heads * p.m_tiles >= min(4, 128)
    assert p.grid == (-(-128 // p.m_tiles), 4 * -(-g // p.heads), 1)


@pytest.mark.parametrize("sq,off", [(16, 0), (16, 48), (64, 0), (5, 290),
                                    (2048, 0), (37, 16), (16, 2032)])
def test_grid_covers_exactly_the_m_tiles_of_the_rows(sq, off):
    for bits, esz in ((None, 2), (None, 4), (8, 2)):
        p = plan(1, 15, 5, sq, 64, 1024, off, bits, esz=esz)
        tiles = {row_tile(off + i)[0] for i in range(sq)}
        first = off // BLOCK_Q
        covered = {first + x * p.m_tiles + i for x in range(p.grid[0])
                   for i in range(p.m_tiles)}
        assert tiles <= covered
        # no block without an active row
        assert (p.grid[0] - 1) * p.m_tiles + first <= max(tiles)


@pytest.mark.parametrize("chunk", [16, 32, 48])
def test_a_rows_tile_and_slot_depend_on_its_position_alone(chunk):
    """One-shot (offset 0, 2,048 rows) and every chunk of ``chunk`` rows at
    its staging offset put position p at m-tile p // 16, slot p % 16."""
    one = {p: row_tile(p) for p in range(2048)}
    for off in range(0, 2048 - chunk + 1, chunk):
        for i in range(chunk):
            assert row_tile(off + i) == one[off + i] == divmod(off + i, 16)


def test_sc_plan_shrinks_the_heads_only_as_shared_memory_forces():
    """qwen2-7b (G 7, D 128, bf16): the group's int16 counts take 2 KB a
    row per 1,024 keys, so a block holds 4 heads at group 1024 and 2 at
    2048; the plan takes the most heads that fit."""
    for group, want in ((1024, 4), (2048, 2)):
        p = plan(1, 28, 4, 2048, 128, group, 0, 8, esz=2)
        assert p.heads == want, (group, p)
        assert smem_bytes("sc", want + 1, 1, 128, group, 2) > SMEM_MAX


def test_sc_blocks_split_the_heads_only_to_fill_the_card():
    """A 16-row chunk has one m-tile a KV head: with 132 SMs the SC plan
    gives each head its own block (15 blocks, not 5); a 2,048-row prompt
    fills the card with every head of a KV head in one block."""
    chunk = plan(1, 15, 5, 16, 64, 1024, 2032, 8, esz=2, sms=132)
    assert chunk.heads == 1 and chunk.grid == (1, 15, 1)
    assert plan(1, 15, 5, 16, 64, 1024, 2032, 8, esz=2).heads == 3
    one_shot = plan(1, 15, 5, 2048, 64, 1024, 0, 8, esz=2, sms=132)
    assert one_shot.heads == 3 and one_shot.grid == (128, 5, 1)
    for sq in (16, 64, 2048):
        for esz in (2, 4):
            assert plan(1, 28, 4, sq, 128, 1024, 0, None, esz=esz,
                        sms=132) == plan(1, 28, 4, sq, 128, 1024, 0, None,
                                         esz=esz)


def test_constants_match_the_kernel_source():
    src = CSRC.read_text()
    consts = dict(re.findall(r"constexpr (?:int|short) (k\w+) = (-?\d+);",
                             src))
    assert int(consts["kMTile"]) == BLOCK_Q
    assert int(consts["kMaxD"]) == MAX_D
    assert int(consts["kMmaTileK"]) == TILE_K["mma"]
    assert int(consts["kF32TileK"]) == TILE_K["f32"]
    assert int(consts["kScTileK"]) == TILE_K["sc"]
    assert int(consts["kMmaMaxWarps"]) == fa.MMA_MAX_WARPS
    assert int(consts["kMmaStages"]) == fa.MMA_STAGES
    assert int(consts["kThreads"]) == fa.THREADS
    assert int(consts["kScThreads"]) == fa.SC_THREADS
    assert int(consts["kScItems"]) == fa.SC_ITEMS


def test_the_bf16_path_is_on_tensor_cores_and_the_f32_path_is_not():
    """QK^T and PV of bf16 operands run as mma.sync bf16 -> f32; nothing
    in the file names TF32, a library or SDPA."""
    src = re.sub(r"//[^\n]*", "", CSRC.read_text())
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "ldmatrix.sync.aligned.m8n8.x4.trans" in src
    for word in ("tf32", "cublas", "cudnn", "scaled_dot_product"):
        assert word not in src.lower()
    body = src[src.index("flash_fwd_f32_kernel(Args a)"):
               src.index("min7x4")]
    assert "mma" not in body


@pytest.mark.parametrize("entry", ["flash_attention_f32",
                                   "flash_attention_bf16"])
def test_argument_types_match_the_c_entries(entry):
    """ctypes passes what ARGTYPES says: a pointer typed as an int would be
    cut to 32 bits, a float passed as an int reinterpreted."""
    src = CSRC.read_text()
    m = re.search(r"extern \"C\" int NAME\(([^)]*)\)", src)
    params = [re.sub(r"\s+\w+$", "", p.strip().replace("\\", "").strip())
              .replace("const ", "").replace(" ", "")
              for p in m.group(1).split(",")]
    kinds = {"void*": "ptr", "int": "int", "longlong": "i64",
             "float": "float"}
    names = {fa._PTR: "ptr", fa._I32: "int", fa._I64: "i64",
             fa._F32: "float"}
    assert [names[t] for t in fa.ARGTYPES] == [kinds[p] for p in params]
    assert f"FLASH_ENTRY({entry}," in src


def test_smem_entry_takes_the_plans_arguments():
    src = CSRC.read_text()
    m = re.search(r'extern "C" long long flash_attention_smem_bytes\(([^)]*)\)',
                  src)
    assert [p.split()[0] for p in m.group(1).split(",")] == ["int"] * 6
