"""The mesh-bound step builders (``launch/mesh_steps.py``).

On 2 and 4 gloo ranks (meshes (2, 1) and (1, 2) at world 2, (2, 2) at
world 4; ``tests/_torch_spawn.py``), reduced dense, ssm and moe configs:
the train step, the decode step and the paged decode step on ``DTensor``s
placed by the builders' shardings, against the one-rank step (the port's
``launch.train`` / model functions on plain tensors) on the same inputs.

* Under SC-GEMM (8 bits) the decode and paged decode logits and caches
  are bit-equal: every kernel operator keeps its reduction axes whole on
  a rank and an SC weight is packed at its whole tensor's scale, so
  nothing sums in another order. The train step's loss is a mean over
  the batch and its gradients exact matmuls whose K may split over
  ranks, so they sum in another order: the loss within 1e-5 relative,
  each new parameter within 1e-5 of its leaf's largest magnitude (an
  AdamW step moves a weight by about ``lr``, 3e-4).
* Exact projections (float32): logits within 1e-5 of the largest, caches
  and parameters as above (a K split is an all-reduce of partial sums).
* On every mesh the other serving builders (one-shot prefill, a chunk
  into a sequence-split staging cache, the speculative verify window,
  rollback, a 4-bit draft, and dense decode through the paged kernel's
  route, each rank's rows on its own cache rows) bit-equal to their
  eager steps under SC-GEMM.

At one rank the builders equal the JAX package's ``build_*_step`` on a
1x1 mesh (parameters through ``convert.from_jax_params``, exact
projections): logits within 1e-4 of the largest, loss within 1e-5
relative. Under SC-GEMM the reference's jitted step parts from eager code
by up to 0.3 (ROADMAP Queue 3), so SC is held to the port's own
unsharded step above.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_spawn import spawn

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

DEADLINE_S = 400
ARCHS_HELD = ("smollm-360m", "mamba2-130m", "qwen3-moe-235b-a22b")
B, S, MAX_SEQ, BLOCK, N_BLOCKS = 4, 16, 32, 4, 24
LOSS_REL, PARAM_REL, LOGIT_REL = 1e-5, 1e-5, 1e-5


def _cfg(arch: str, sc: bool):
    from repro_torch.configs.registry import ARCHS
    return dataclasses.replace(ARCHS[arch].reduced(dtype="float32"),
                               use_sc_gemm=sc, sc_bits=8).validate()


def _inputs(cfg):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int64)
    batch = {"tokens": torch.from_numpy(toks.astype(np.int32)),
             "labels": torch.from_numpy(toks.astype(np.int32))}
    step = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32))}
    return batch, step


def _whole(tree):
    from repro_torch import tree as tr
    from repro_torch.parallel.context import is_dtensor
    return tr.tree_map(lambda t: t.full_tensor() if is_dtensor(t) else t,
                       tree)


def _rel(got, want) -> float:
    from repro_torch import tree as tr
    worst = 0.0
    for g, w in zip(tr.leaves(got), tr.leaves(want)):
        g, w = g.to(torch.float64), w.to(torch.float64)
        scale = max(float(w.abs().max()), 1e-30) if w.numel() else 1.0
        worst = max(worst, float((g - w).abs().max()) / scale
                    if w.numel() else 0.0)
    return worst


def _equal(got, want) -> bool:
    from repro_torch import tree as tr
    return all(torch.equal(g, w) for g, w in zip(tr.leaves(got),
                                                 tr.leaves(want)))


def _prefilled_cache(m, params, batch):
    """A dense cache of extent MAX_SEQ holding the prompt's K/V (the
    one-rank prefill), and a paged pool holding the same rows."""
    from repro_torch.models import cache_ops
    from repro_torch.launch import steps as eager
    _, single = eager.prefill_step(m, params, {"tokens": batch["tokens"]},
                                   extra_slots=MAX_SEQ - S)
    pool = cache_ops.paged_init(m.init_cache, B, N_BLOCKS, BLOCK)
    per, own = MAX_SEQ // BLOCK, N_BLOCKS // B
    tables = torch.full((B, per), -1, dtype=torch.int32)
    for slot in range(B):
        # the prompt's 16 rows fill 4 of a slot's 6 pages
        pages = list(range(slot * own, (slot + 1) * own))
        tables[slot, :len(pages)] = torch.tensor(pages, dtype=torch.int32)
        one = cache_ops.slot_read(single, slot)
        pool = cache_ops.paged_insert(pool, cache_ops.truncate_seq(
            one, len(pages) * BLOCK), slot, pages, block=BLOCK)
    return single, pool, tables


def _clone(tree):
    from repro_torch import tree as tr
    return tr.tree_map(lambda t: t.clone(), tree)


def _held(cfg, mesh) -> dict:
    """One config on one mesh: the three steps against the one-rank
    step; returns each comparison's numbers (rank 0 keeps them)."""
    from repro_torch import tree as tr
    from repro_torch.launch import mesh_steps as ms
    from repro_torch.launch import steps as eager
    from repro_torch.launch import train as tt
    from repro_torch.models import bind
    from repro_torch.optim import init as opt_init
    from repro_torch.parallel.sharding import distribute
    m = bind(ms.mesh_config(cfg), "cpu")
    params = m.init_params(0)
    batch, step_batch = _inputs(cfg)
    out = {}

    # train: the builder's step against launch.train's on plain tensors
    step, sh, _, optc = ms.build_train_step(cfg, mesh, warmup=1,
                                            total_steps=20)
    opt = opt_init(params, optc)
    want_p, want_o, want_loss, _ = tt.train_step(
        m, _clone(params), _clone(opt), batch, lr_peak=3e-4, steps=20,
        optc=optc)
    got_p, got_o, metrics = step(distribute(params, sh["params"]),
                                 distribute(opt, sh["opt"]),
                                 distribute(batch, sh["batch_fn"](batch)))
    got_p, got_o, metrics = _whole((got_p, got_o, metrics))
    out["train"] = {
        "loss_rel": abs(float(metrics["loss"]) - float(want_loss))
        / abs(float(want_loss)),
        "param_rel": _rel(got_p, want_p),
        "steps_equal": bool(torch.equal(got_o["step"], want_o["step"])),
        "grad_norm_finite": bool(torch.isfinite(metrics["grad_norm"]))}

    # decode over a dense cache, and paged decode over the same rows
    single, pool, tables = _prefilled_cache(m, params, batch)
    want_logits, want_cache = eager.decode_step(m, params, _clone(single),
                                                step_batch)
    step, sh, _ = ms.build_decode_step(cfg, mesh, batch_size=B,
                                       seq_len=MAX_SEQ)
    logits, cache = _whole(step(distribute(params, sh["params"]),
                                distribute(_clone(single), sh["cache"]),
                                distribute(step_batch,
                                           sh["batch_fn"](step_batch))))
    out["decode"] = {"logits_equal": bool(torch.equal(logits, want_logits)),
                     "logits_rel": _rel(logits, want_logits),
                     "cache_equal": _equal(cache, want_cache),
                     "cache_rel": _rel(cache, want_cache)}

    want_logits, want_pool = eager.paged_decode_step(
        m, params, _clone(pool), tables, step_batch)
    step, sh, _ = ms.build_paged_decode_step(
        cfg, mesh, capacity=B, block=BLOCK, n_blocks=N_BLOCKS,
        max_blocks=tables.shape[1])
    logits, data = _whole(step(distribute(params, sh["params"]),
                               distribute(_clone(pool), sh["cache"]),
                               distribute(tables, sh["tables"]),
                               distribute(step_batch,
                                          sh["batch_fn"](step_batch))))
    out["paged"] = {"logits_equal": bool(torch.equal(logits, want_logits)),
                    "logits_rel": _rel(logits, want_logits),
                    "cache_equal": _equal(data, want_pool),
                    "cache_rel": _rel(data, want_pool)}
    del tr
    return out


def _serving(cfg, mesh) -> dict:
    """The other serving builders against their eager steps on the same
    inputs, each bit-equal under SC-GEMM: one-shot prefill, a chunk into
    a B=1 staging cache (sequence-split on a mesh with data axes), the
    speculative verify window (width 3), rollback and a 2-token draft at
    4 bits."""
    import torch
    from repro_torch.launch import mesh_steps as ms
    from repro_torch.launch import steps as eager
    from repro_torch.models import bind
    from repro_torch.parallel.sharding import NamedSharding, P, distribute
    m = bind(ms.mesh_config(cfg), "cpu")
    params = m.init_params(0)
    batch, step_batch = _inputs(cfg)
    single, pool, tables = _prefilled_cache(m, params, batch)
    pool_kw = dict(capacity=B, block=BLOCK, n_blocks=N_BLOCKS,
                   max_blocks=tables.shape[1])

    def run(step, sh, *args):
        return _whole(step(*(distribute(a, s) for a, s in zip(args, sh))))

    out = {}
    prompt = {"tokens": batch["tokens"]}
    want = eager.prefill_step(m, params, prompt)
    step, sh, _ = ms.build_prefill_step(cfg, mesh, batch_size=B, seq_len=S)
    out["prefill"] = _equal(run(step, (sh["params"], sh["batch_fn"](prompt)),
                                params, prompt), want)

    stage = m.init_cache(1, MAX_SEQ)
    chunk = {"tokens": batch["tokens"][:1, :8],
             "n_valid": torch.tensor([8], dtype=torch.int32)}
    want = eager.chunked_prefill_step(m, params, _clone(stage), chunk)
    step, sh, _ = ms.build_chunked_prefill_step(cfg, mesh, seq_len=MAX_SEQ,
                                                chunk=8)
    out["chunk"] = _equal(run(step, (sh["params"], sh["cache"],
                                     sh["batch_fn"](chunk)),
                              params, _clone(stage), chunk), want)

    window = {"tokens": step_batch["tokens"].repeat(1, 3)}
    want = eager.verify_window_step(m, params, _clone(pool), tables, window,
                                    block=BLOCK, width=3)
    step, sh, _ = ms.build_verify_window_step(cfg, mesh, width=3, **pool_kw)
    out["verify"] = _equal(run(step, (sh["params"], sh["cache"],
                                      sh["tables"], sh["batch_fn"](window)),
                               params, _clone(pool), tables, window), want)

    accept = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    committed = want[1]
    want = eager.rollback_step(_clone(committed), tables, accept,
                               block=BLOCK, width=3)
    step, sh, _ = ms.build_rollback_step(cfg, mesh, width=3, **pool_kw)
    out["rollback"] = _equal(run(step, (sh["cache"], sh["tables"],
                                        NamedSharding(mesh, P(None))),
                                 _clone(committed), tables, accept), want)

    # dense decode through the paged kernel's route (each rank's rows
    # against its own cache rows; the kernel's plain version here)
    routed = dataclasses.replace(cfg, paged_attn_kernel="pallas_tuned")
    rm = bind(ms.mesh_config(routed), "cpu")
    want = eager.decode_step(rm, params, _clone(single), step_batch)
    step, sh, _ = ms.build_decode_step(routed, mesh, batch_size=B,
                                       seq_len=MAX_SEQ)
    out["decode_kernel_route"] = _equal(
        run(step, (sh["params"], sh["cache"], sh["batch_fn"](step_batch)),
            params, _clone(single), step_batch), want)

    draft_cfg = eager.draft_config(cfg, 4)
    dm = bind(ms.mesh_config(draft_cfg), "cpu")
    want = eager.draft_loop_step(dm, params, _clone(pool), tables,
                                 step_batch, k=2)
    step, sh, _ = ms.build_draft_loop_step(draft_cfg, mesh, k=2, **pool_kw)
    out["draft"] = _equal(run(step, (sh["params"], sh["cache"], sh["tables"],
                                     sh["batch_fn"](step_batch)),
                              params, _clone(pool), tables, step_batch),
                          want)
    return out


def _meshes(world: int):
    return ((2, 1), (1, 2)) if world == 2 else ((2, 2),)


def case_mesh_steps(rank: int, world: int) -> dict:
    """Every held config on every mesh of this world size."""
    from repro_torch.launch.mesh import make_mesh
    results = {}
    for shape in _meshes(world):
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        for arch in ARCHS_HELD:
            for sc in (True, False) if arch == "smollm-360m" else (True,):
                results[(shape, arch, sc)] = _held(_cfg(arch, sc), mesh)
        results[(shape, "serving", True)] = _serving(
            _cfg("smollm-360m", True), mesh)
    return results


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def mesh_results(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"mesh_steps_{request.param}")
    results = spawn("test_torch_mesh_steps:case_mesh_steps", request.param,
                    root, deadline_s=DEADLINE_S)
    return results[0]


CELLS = [(arch, sc) for arch in ARCHS_HELD
         for sc in ((True, False) if arch == "smollm-360m" else (True,))]


@pytest.mark.parametrize("arch,sc", CELLS,
                         ids=[f"{a}-{'sc' if s else 'f32'}" for a, s in CELLS])
def test_train_step_equals_the_one_rank_step(mesh_results, arch, sc):
    held = [(shape, r) for (shape, a, s), r in mesh_results.items()
            if (a, s) == (arch, sc)]
    assert held
    for shape, r in held:
        t = r["train"]
        assert t["steps_equal"] and t["grad_norm_finite"], (shape, t)
        assert t["loss_rel"] <= LOSS_REL, (shape, t)
        assert t["param_rel"] <= PARAM_REL, (shape, t)


@pytest.mark.parametrize("arch,sc", CELLS,
                         ids=[f"{a}-{'sc' if s else 'f32'}" for a, s in CELLS])
@pytest.mark.parametrize("kind", ["decode", "paged"])
def test_decode_steps_equal_the_one_rank_step(mesh_results, arch, sc, kind):
    held = [(shape, r) for (shape, a, s), r in mesh_results.items()
            if (a, s) == (arch, sc)]
    assert held
    for shape, r in held:
        d = r[kind]
        if sc:
            assert d["logits_equal"] and d["cache_equal"], (shape, d)
        else:
            assert d["logits_rel"] <= LOGIT_REL, (shape, d)
            assert d["cache_rel"] <= PARAM_REL, (shape, d)


@pytest.mark.parametrize("kind", ["prefill", "chunk", "verify", "rollback",
                                  "draft", "decode_kernel_route"])
def test_serving_builders_equal_the_eager_steps(mesh_results, kind):
    """On every mesh, reduced smollm-360m under SC-GEMM: each builder's
    outputs bit-equal to its eager step's."""
    served = {k[0]: r for k, r in mesh_results.items() if k[1] == "serving"}
    assert served
    for shape, r in served.items():
        assert r[kind], (shape, kind)
