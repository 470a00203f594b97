"""The port's optimizer, data pipeline, checkpointer and supervisor
(``repro_torch.optim``, ``.data``, ``.checkpoint``, ``.runtime``) held
against the JAX package's on the CPU, the same numpy inputs given to both.

Tolerances:

* ``quantize8``: int8 payload and scales bit-equal, a padded tail
  included; ``warmup_cosine`` within 1 ulp of float32 at every step;
* ``apply_updates`` after 3 steps: parameters and float32 moments within
  1e-6 relative (of the leaf's largest magnitude), float32 and bf16
  parameters. Quantized moments: scales within 1e-6 relative and the
  int8 payload at most one step apart, where a value sits on a rounding
  boundary (the two sides' float32 moments differ in their last bits,
  ``pow`` being the one operation not correctly rounded on both);
* ``compress_with_feedback``: gradients and error state within 1e-6
  relative over two rounds;
* pipeline batches and tokenizer ids bit-equal; the checkpointer's
  round trip bit for bit, bf16 included; supervisor plans equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.data import PipelineConfig as JaxPipelineConfig
from repro.data import TokenPipeline as JaxTokenPipeline
from repro.data import ByteTokenizer as JaxByteTokenizer
from repro.data.pipeline import write_corpus as jax_write_corpus
from repro.optim import adamw as jadamw
from repro.optim import grad_compression as jgc
from repro.optim import schedules as jsched
from repro.runtime import fault_tolerance as jft
from repro_torch import tree as tr
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import ByteTokenizer, PipelineConfig, TokenPipeline
from repro_torch.data import write_corpus
from repro_torch.optim import adamw
from repro_torch.optim import grad_compression as gc
from repro_torch.optim import schedules
from repro_torch.runtime import fault_tolerance as ft

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

SHAPES = {"w": (16, 40), "b": (40,), "e": (3, 7, 11), "s": (1,)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-30))


# ------------------------------------------------------------- quantizer

@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4096 + 17])
def test_quantize8_payload_and_scales_bit_equal_jax(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 3, n)).astype(
        np.float32)
    if n > 256:
        x[256:512] = 0.0                   # an all-zero block: the 1e-20 floor
    jz = jadamw.quantize8(jnp.asarray(x))
    tz = adamw.quantize8(torch.from_numpy(x))
    np.testing.assert_array_equal(tz.q.numpy(), np.asarray(jz.q))
    np.testing.assert_array_equal(tz.scale.numpy(), np.asarray(jz.scale))
    assert tz.q.dtype == torch.int8 and tz.q.shape == (-(-n // 256), 256)
    shape = (n,)
    np.testing.assert_array_equal(
        adamw.dequantize8(tz, shape).numpy(),
        np.asarray(jadamw.dequantize8(jz, shape)))


# -------------------------------------------------------------- schedules

@pytest.mark.parametrize("warmup,total", [(1, 10), (5, 100), (20, 20)])
def test_warmup_cosine_within_one_ulp(warmup, total):
    for step in range(total + 3):
        want = np.float32(jsched.warmup_cosine(
            jnp.asarray(step, jnp.int32), peak_lr=3e-4, warmup_steps=warmup,
            total_steps=total))
        got = schedules.warmup_cosine(torch.tensor(step, dtype=torch.int32),
                                      peak_lr=3e-4, warmup_steps=warmup,
                                      total_steps=total)
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= np.spacing(want), step
    assert float(schedules.constant(torch.tensor(3), peak_lr=0.5)) == 0.5


# ---------------------------------------------------------------- AdamW

def _j(tree, dtype):
    return {k: jnp.asarray(v).astype(dtype) for k, v in tree.items()}


def _t(tree, dtype):
    return {k: torch.from_numpy(v).to(dtype) for k, v in tree.items()}


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x).astype(np.float32))


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_three_steps_match_jax(dtype, quantize):
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    cfg_j = jadamw.AdamWConfig(quantize_moments=quantize)
    cfg_t = adamw.AdamWConfig(quantize_moments=quantize)
    p0 = _tree(0)
    jp, tp = _j(p0, jd), _t(p0, td)
    js, ts = jadamw.init(jp, cfg_j), adamw.init(tp, cfg_t)
    assert ts["step"].dtype == torch.int32
    for i in range(3):
        g = _tree(10 + i, scale=0.1)
        lr = np.float32(1e-2)
        jp, js = jadamw.apply_updates(jp, _j(g, jd), js, cfg_j,
                                      jnp.asarray(lr))
        tp, ts = adamw.apply_updates(tp, _t(g, td), ts, cfg_t,
                                     torch.tensor(lr))
    assert int(ts["step"]) == 3
    for k in SHAPES:
        assert tp[k].dtype == td
        assert _rel(_np(tp[k]), _np(jp[k])) <= 1e-6, k
        for mom in ("m", "v"):
            tm, jm = ts[mom][k], js[mom][k]
            if quantize:
                assert _rel(tm.scale.numpy(), np.asarray(jm.scale)) <= 1e-6
                step = np.abs(tm.q.numpy().astype(np.int32)
                              - np.asarray(jm.q).astype(np.int32))
                assert step.max() <= 1, (k, mom)
            else:
                assert tm.dtype == torch.float32
                assert _rel(tm.numpy(), np.asarray(jm)) <= 1e-6, (k, mom)


def test_weight_decay_only_on_matrices():
    cfg = adamw.AdamWConfig(weight_decay=0.5)
    p = {"mat": torch.ones((2, 2)), "vec": torch.ones((2,))}
    zero = {k: torch.zeros_like(v) for k, v in p.items()}
    new, _ = adamw.apply_updates(p, zero, adamw.init(p, cfg), cfg,
                                 torch.tensor(0.1))
    assert torch.all(new["vec"] == 1.0)
    assert torch.allclose(new["mat"], torch.full((2, 2), 0.95))


def test_decay_mask_counts_the_stacking_axis():
    """The reference stacks its layers, so its ``ndim >= 2`` rule decays
    a layer's norm vector; the port's list of layers keeps that choice."""
    p = {"embed": torch.ones((4, 3)), "final_norm": torch.ones((3,)),
         "layers": [{"ln": torch.ones((3,)), "mlp": {"w": torch.ones((3, 3))}}]}
    assert adamw.decay_mask(p) == {
        "embed": True, "final_norm": False,
        "layers": [{"ln": True, "mlp": {"w": True}}]}


def test_apply_updates_decays_a_layers_norm_vector():
    """``apply_updates`` takes the reference's decay for a model's tree
    with no option: the layer's norm vector decays, the final norm does
    not."""
    cfg = adamw.AdamWConfig(weight_decay=0.5)
    p = {"final_norm": torch.ones((3,)),
         "layers": [{"ln": torch.ones((3,)), "w": torch.ones((3, 3))}]}
    zero = tr.tree_map(torch.zeros_like, p)
    new, _ = adamw.apply_updates(p, zero, adamw.init(p, cfg), cfg,
                                 torch.tensor(0.1))
    assert torch.all(new["final_norm"] == 1.0)
    assert torch.allclose(new["layers"][0]["ln"], torch.full((3,), 0.95))
    assert torch.allclose(new["layers"][0]["w"], torch.full((3, 3), 0.95))


def test_tree_paths_follow_the_leaf_order_of_jax():
    """``tree.paths`` names the leaves in ``tree.flatten``'s order, which
    is ``jax.tree``'s: dict keys sorted, then list and tuple indices."""
    tree = {"z": [np.zeros(1), {"b": np.ones(1), "a": np.zeros(2)}],
            "embed": np.zeros(3), "m": (np.zeros(4), np.ones(4))}
    want = [".".join(str(getattr(k, "key", getattr(k, "idx", None)))
                     for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert tr.paths(tree) == want
    assert [x.shape for x in tr.leaves(tree)] == [
        x.shape for x in jax.tree.leaves(tree)]
    q = adamw.quantize8(torch.ones(3))
    assert tr.paths({"m": q}, is_leaf=lambda n: isinstance(
        n, adamw.Quantized8)) == ["m"]
    assert tr.paths({"m": q}) == ["m.q", "m.scale"]


# --------------------------------------------------------- compression

def test_compress_with_feedback_matches_jax():
    jg0, tg0 = _j(_tree(1), jnp.float32), _t(_tree(1), torch.float32)
    je, te = jgc.init_error_state(jg0), gc.init_error_state(tg0)
    for r in range(2):
        g = _tree(20 + r, scale=0.3)
        jg, je = jgc.compress_with_feedback(_j(g, jnp.float32), je)
        tg, te = gc.compress_with_feedback(_t(g, torch.float32), te)
        for k in SHAPES:
            assert _rel(tg[k].numpy(), np.asarray(jg[k])) <= 1e-6, (r, k)
            assert te[k].dtype == torch.float32
            assert _rel(te[k].numpy(), np.asarray(je[k])) <= 1e-6, (r, k)


# ------------------------------------------------------------- pipeline

@pytest.mark.parametrize("codebooks", [0, 4])
def test_synthetic_batches_bit_equal_jax_two_shards(codebooks):
    for shard in range(2):
        kw = dict(vocab_size=300, seq_len=12, global_batch=4,
                  n_codebooks=codebooks, shard_index=shard, shard_count=2,
                  seed=3)
        ours = TokenPipeline(PipelineConfig(**kw))
        ref = JaxTokenPipeline(JaxPipelineConfig(**kw))
        for step in (0, 1, 7):
            a, b = ours.get_batch(step), ref.get_batch(step)
            for key in ("tokens", "labels"):
                assert a[key].dtype == np.int32
                np.testing.assert_array_equal(a[key], b[key])
            assert a["tokens"].shape[0] == 2


def test_memmap_batches_bit_equal_jax_two_shards(tmp_path):
    corpus = np.random.default_rng(0).integers(-5, 700, 5000).astype(np.int32)
    ours_path, ref_path = tmp_path / "ours.bin", tmp_path / "ref.bin"
    write_corpus(ours_path, corpus)
    jax_write_corpus(ref_path, corpus)
    assert ours_path.read_bytes() == ref_path.read_bytes()
    for shard in range(2):
        kw = dict(vocab_size=512, seq_len=16, global_batch=6,
                  shard_index=shard, shard_count=2)
        ours = TokenPipeline(PipelineConfig(corpus_path=str(ours_path), **kw))
        ref = JaxTokenPipeline(JaxPipelineConfig(corpus_path=str(ref_path),
                                                 **kw))
        for step in (0, 3, 250):
            a, b = ours.get_batch(step), ref.get_batch(step)
            for key in ("tokens", "labels"):
                np.testing.assert_array_equal(a[key], b[key])


def test_byte_tokenizer_round_trips():
    tok, ref = ByteTokenizer(), JaxByteTokenizer()
    text = "SC-GEMM: x·y ≈ O(x, y)"
    ids = tok.encode(text)
    np.testing.assert_array_equal(ids, ref.encode(text))
    assert ids[0] == tok.BOS and tok.decode(ids) == text
    assert tok.decode(np.append(ids, tok.EOS)) == text
    np.testing.assert_array_equal(tok.encode(text, add_bos=False),
                                  ref.encode(text, add_bos=False))


# ---------------------------------------------------------- checkpointer

def _state():
    gen = torch.Generator().manual_seed(0)
    p = {"embed": torch.randn((8, 4), generator=gen).to(torch.bfloat16),
         "layers": [{"w": torch.randn((4, 4), generator=gen),
                     "ln": torch.randn((4,), generator=gen)}
                    for _ in range(2)]}
    cfg = adamw.AdamWConfig(quantize_moments=True)
    opt = adamw.init(p, cfg)
    g = tr.tree_map(lambda x: torch.randn(x.shape, generator=gen).to(x.dtype),
                    p)
    p, opt = adamw.apply_updates(p, g, opt, cfg, torch.tensor(0.1))
    return {"params": p, "opt": opt}


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
        else x.numpy()


def test_checkpoint_round_trip_bit_equal(tmp_path):
    state = _state()
    ck = Checkpointer(tmp_path)
    ck.save(5, state, blocking=True)
    like = tr.tree_map(torch.zeros_like, state)
    back = ck.restore(5, like)
    got, structure = tr.flatten(back)
    want, want_structure = tr.flatten(state)
    assert repr(structure) == repr(want_structure)
    assert isinstance(back["opt"]["m"]["embed"], adamw.Quantized8)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    with pytest.raises(ValueError, match="leaves"):
        ck.restore(5, {"params": like["params"]})
    bad = tr.tree_map(torch.zeros_like, state)
    bad["params"]["embed"] = torch.zeros((9, 4), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shape"):
        ck.restore(5, bad)


def test_checkpoint_ignores_partials_and_keeps_the_newest(tmp_path):
    ck = Checkpointer(tmp_path, keep=3)
    tree = {"w": torch.ones((3,))}
    for s in (1, 2, 3, 4, 5):
        ck.save(s, tree, blocking=True)
    assert ck.all_steps() == [3, 4, 5]
    (tmp_path / "step_00000009").mkdir()          # killed before COMMITTED
    (tmp_path / ".tmp_step_00000010").mkdir()
    assert ck.latest_step() == 5
    assert JaxCheckpointer(tmp_path).all_steps() == [3, 4, 5]


def test_async_save_is_visible_after_wait(tmp_path):
    ck = Checkpointer(tmp_path)
    w = torch.ones((256, 256))
    ck.save(10, {"w": w})
    w.add_(1.0)                  # a write after save() reaches no leaf
    ck.wait()
    assert ck.latest_step() == 10
    back = ck.restore(10, {"w": torch.zeros((256, 256))})
    assert torch.all(back["w"] == 1.0)


# ------------------------------------------------------------ supervisor

def test_heartbeats_and_stragglers_equal_the_reference():
    t = [0.0]
    ours = ft.HeartbeatMonitor(4, timeout_s=10, clock=lambda: t[0])
    ref = jft.HeartbeatMonitor(4, timeout_s=10, clock=lambda: t[0])
    t[0] = 5.0
    for w in (0, 1, 3):
        ours.beat(w)
        ref.beat(w)
    t[0] = 12.0
    assert ours.dead_workers() == ref.dead_workers() == [2]
    assert ours.alive_count() == ref.alive_count() == 3
    det, jdet = ft.StragglerDetector(min_samples=8), jft.StragglerDetector(
        min_samples=8)
    for _ in range(10):
        for w in range(7):
            det.record(w, 1.0 + 0.01 * w)
            jdet.record(w, 1.0 + 0.01 * w)
        det.record(7, 3.0)
        jdet.record(7, 3.0)
    assert det.stragglers() == jdet.stragglers() == [7]


def test_elastic_plans_equal_the_reference():
    for chips, mp in ((512 - 16, 16), (8, 1), (7, 2), (64, 8)):
        assert (ft.plan_elastic_mesh(chips, model_parallelism=mp)
                == jft.plan_elastic_mesh(chips, model_parallelism=mp))
    with pytest.raises(RuntimeError):
        ft.plan_elastic_mesh(8, model_parallelism=16)


def test_supervisor_plans_and_cadence_equal_the_reference():
    ours = ft.TrainingSupervisor(ft.SupervisorConfig(checkpoint_every=100),
                                 n_chips=512, model_parallelism=16)
    ref = jft.TrainingSupervisor(jft.SupervisorConfig(checkpoint_every=100),
                                 n_chips=512, model_parallelism=16)
    for step in range(0, 301, 50):
        ours.on_step(step)
        ref.on_step(step)
        assert ours.should_checkpoint(step) == ref.should_checkpoint(step)
    assert ours.last_checkpoint_step == ref.last_checkpoint_step == 300
    plan = ours.on_failure(dead_workers=[3], chips_per_worker=8)
    assert plan == ref.on_failure(dead_workers=[3], chips_per_worker=8)
    assert plan["new_mesh"] == (31, 16) and plan["surviving_chips"] == 504
    tight = ft.TrainingSupervisor(ft.SupervisorConfig(max_restarts=0),
                                  n_chips=8, model_parallelism=1)
    with pytest.raises(RuntimeError, match="budget"):
        tight.on_failure([0], 1)
    assert ft.device_chips(torch.device("cpu")) == 1
