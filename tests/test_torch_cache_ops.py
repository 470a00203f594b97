"""Slot and paged cache ops of the PyTorch port held against the JAX
package's ``models/cache_ops.py``: index math only, so exact equality.

The port's writing ops update in place; each comparison feeds both sides
the same numpy contents."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import cache_ops as jops
from repro.models import transformer as jtr
from repro_torch.configs.registry import ARCHS
from repro_torch.errors import CacheLayoutError, ConfigError
from repro_torch.models import cache_ops as tops
from repro_torch.models import transformer as ttr

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

JCFG = JAX_ARCHS["smollm-360m"].reduced(dtype="float32")
TCFG = ARCHS["smollm-360m"].reduced(dtype="float32")


def _random_cache(batch, seq, seed):
    """The same random dense cache on both sides."""
    rng = np.random.default_rng(seed)
    ng = JCFG.n_layers // JCFG.group_size
    shape = (ng, batch, seq, JCFG.n_kv_heads, JCFG.head_dim)
    k = [rng.standard_normal(shape).astype(np.float32)
         for _ in range(JCFG.group_size)]
    v = [rng.standard_normal(shape).astype(np.float32)
         for _ in range(JCFG.group_size)]
    pos = rng.integers(0, seq, (batch,)).astype(np.int32)
    j = jtr.KVCache(k=tuple(jnp.asarray(x) for x in k),
                    v=tuple(jnp.asarray(x) for x in v), pos=jnp.asarray(pos))
    t = ttr.KVCache(k=tuple(torch.as_tensor(x.copy()) for x in k),
                    v=tuple(torch.as_tensor(x.copy()) for x in v),
                    pos=torch.as_tensor(pos.copy()))
    return j, t


def _assert_same(j, t):
    for a, b in zip(list(j.k) + list(j.v), list(t.k) + list(t.v)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(t.pos.numpy(), np.asarray(j.pos))


def test_slot_insert_read_evict_equal_jax():
    jpool, tpool = _random_cache(3, 12, seed=1)
    jone, tone = _random_cache(1, 7, seed=2)
    jpool = jops.slot_insert(jpool, jone, 2)
    tpool = tops.slot_insert(tpool, tone, 2)
    _assert_same(jpool, tpool)
    _assert_same(jops.slot_read(jpool, 2), tops.slot_read(tpool, 2))
    np.testing.assert_array_equal(tops.slot_positions(tpool).numpy(),
                                  np.asarray(jops.slot_positions(jpool)))
    jpool = jops.slot_evict(jpool, 1)
    tpool = tops.slot_evict(tpool, 1)
    _assert_same(jpool, tpool)
    _assert_same(jops.truncate_seq(jpool, 5), tops.truncate_seq(tpool, 5))
    _, tlong = _random_cache(1, 20, seed=5)      # longer than the pool
    with pytest.raises(CacheLayoutError):
        tops.slot_insert(tpool, tlong, 0)


@pytest.mark.parametrize("block", [4, 5])
def test_paged_ops_equal_jax(block):
    capacity, n_blocks, mb = 3, 8, 4
    jdata = jops.paged_init(lambda b, s: jtr.init_kv_cache(JCFG, b, s),
                            capacity, n_blocks, block)
    tdata = tops.paged_init(
        lambda b, s: ttr.init_kv_cache(TCFG, b, s, device="cpu"),
        capacity, n_blocks, block)
    _assert_same(jdata, tdata)
    assert tdata.k[0].shape[1] == n_blocks + 1          # + the trash page

    # admission: prefill caches of 7 and 2*block tokens into scattered pages
    tables = np.full((capacity, mb), -1, np.int32)
    for slot, (s1, pages, seed) in enumerate([(7, [5, 1], 3),
                                              (2 * block, [0, 6], 4)]):
        jone, tone = _random_cache(1, s1, seed=seed)
        tables[slot, :len(pages)] = pages
        jdata = jops.paged_insert(jdata, jone, slot, pages, block=block)
        tdata = tops.paged_insert(tdata, tone, slot, pages, block=block)
        _assert_same(jdata, tdata)
    jt, tt = jnp.asarray(tables), torch.as_tensor(tables)

    # gather (−1 → trash) and the per-slot read
    _assert_same(jops.paged_gather(jdata, jt, block=block),
                 tops.paged_gather(tdata, tt, block=block))
    _assert_same(jops.paged_read(jdata, jt, 1, block=block),
                 tops.paged_read(tdata, tt, 1, block=block))

    # token entries, including positions outside the table's extent
    for pos in ([0, 3, 9], [block * mb, -1, block + 1], [7, 2 * block, 1]):
        je, jo = jops.paged_token_entry(jt, jnp.asarray(pos, jnp.int32),
                                        block=block)
        te, to = tops.paged_token_entry(tt, torch.as_tensor(pos),
                                        block=block)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))

    # one decode step's commit from a dense view back into pages
    jdense, tdense = _random_cache(capacity, mb * block, seed=9)
    jdata = jdata._replace(pos=jnp.asarray([6, 2 * block - 1, 3], jnp.int32))
    tdata = tdata._replace(pos=torch.as_tensor([6, 2 * block - 1, 3],
                                               dtype=torch.int32))
    jdata = jops.paged_commit(jdata, jdense, jt, block=block)
    tdata = tops.paged_commit(tdata, tdense, tt, block=block)
    _assert_same(jdata, tdata)

    # eviction zeroes the pages and resets the position
    jdata = jops.paged_evict(jdata, 0, [5, 1])
    tdata = tops.paged_evict(tdata, 0, [5, 1])
    _assert_same(jdata, tdata)


def test_paged_insert_refuses_what_it_cannot_hold():
    tdata = tops.paged_init(
        lambda b, s: ttr.init_kv_cache(TCFG, b, s, device="cpu"), 2, 4, 4)
    _, tone = _random_cache(1, 9, seed=0)
    with pytest.raises(CacheLayoutError):
        tops.paged_insert(tdata, tone, 0, [0, 1], block=4)
    with pytest.raises(ConfigError, match="prefix-cache"):
        tops.paged_insert(tdata, tone, 0, [0, 1, 2], block=4, start=4)
    with pytest.raises(ConfigError):
        tops.paged_init(lambda b, s: None, 0, 4, 4)
