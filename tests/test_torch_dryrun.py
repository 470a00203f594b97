"""The dry run (``launch/dryrun.py``), its specs (``configs/shapes.py``
``input_specs`` / ``cache_specs``) and its accounting
(``launch/cost_analysis.py``), against the JAX package where it has a
counterpart.

Every process group (gloo, or the single-process ``fake`` backend at a
mesh's world size) starts in a child process with a deadline
(``tests/_torch_spawn.py``) or in a ``subprocess`` with a timeout: a group
is process-global, and pytest workers share this one.

* ``input_specs`` / ``cache_specs``: the reference's ``ShapeDtypeStruct``
  trees for 10 archs x 4 shapes, leaf for leaf (the caches have the
  reference's stacked layouts in the port too).
* At one gloo rank (a 1x1 mesh) the mesh-bound train, prefill and decode
  steps against the reference's ``build_*_step`` on a 1x1 JAX mesh,
  reduced smollm-360m in float32 with exact projections, the parameters
  carried over by ``convert.from_jax_params``: the loss within 1e-5
  relative, logits within 1e-4 of the largest, updated parameters within
  ``1e-3 · lr`` (the train tests' tolerance, ``test_torch_train.py``).
* The dry run's per-rank argument bytes on a 2x2 mesh (reduced dense,
  train and decode) against the reference's
  ``compiled.memory_analysis().argument_size_in_bytes`` (its side in a
  subprocess with four host devices): equal.
* ``count_step`` against a hand count on a sharded MLP; the roofline's
  arithmetic; the reference's own test cell end to end.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_spawn import spawn

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
ARCH_NAMES = ("gemma2-9b", "llama4-maverick-400b-a17b", "mamba2-130m",
              "musicgen-large", "qwen2-7b", "qwen2-vl-2b", "qwen2.5-14b",
              "qwen3-moe-235b-a22b", "smollm-360m", "zamba2-7b")
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
LOSS_REL, LOGIT_REL, LR = 1e-5, 1e-4, 3e-4


def _signature(leaves) -> list:
    return sorted((tuple(int(d) for d in t.shape),
                   str(t.dtype).removeprefix("torch.")) for t in leaves)


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_and_cache_specs_equal_the_reference(arch, shape):
    import jax
    from repro.configs.registry import ARCHS as JAX_ARCHS
    from repro.configs.shapes import SHAPES as JAX_SHAPES
    from repro.configs.shapes import cache_specs as jax_cache_specs
    from repro.configs.shapes import input_specs as jax_input_specs
    from repro_torch import tree as tr
    from repro_torch.configs.registry import ARCHS
    from repro_torch.configs.shapes import SHAPES, cache_specs, input_specs
    cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
    got = input_specs(cfg, SHAPES[shape])
    want = jax_input_specs(jcfg, JAX_SHAPES[shape])
    assert sorted(got) == sorted(want)
    for key in got:
        assert got[key].device.type == "meta"
        assert _signature([got[key]]) == _signature([want[key]]), key
    if SHAPES[shape].kind == "decode":
        cache = cache_specs(cfg, SHAPES[shape])
        assert all(t.device.type == "meta" for t in tr.leaves(cache))
        assert _signature(tr.leaves(cache)) == _signature(
            jax.tree.leaves(jax_cache_specs(jcfg, JAX_SHAPES[shape])))


# ------------------------------------------------- one rank against JAX

B, S, MAX_SEQ = 2, 32, 48


def _reference_steps(root: Path) -> dict:
    """The reference's jitted train, prefill and decode steps on a 1x1
    mesh; the inputs and parameters saved for the port's child."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs.registry import ARCHS as JAX_ARCHS
    from repro.launch import steps as jsteps
    from repro.models import bind as jbind
    from repro.optim import init as jax_opt_init
    jcfg = JAX_ARCHS["smollm-360m"].reduced(dtype="float32")
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    params = jbind(jcfg).init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    step_toks = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
    np_params = jax.tree.map(np.asarray, params)
    train, _, _, optc = jsteps.build_train_step(jcfg, mesh)
    new_params, _, metrics = train(
        params, jax_opt_init(params, optc),
        {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
    prefill, _, _ = jsteps.build_prefill_step(
        jcfg, mesh, batch_size=B, seq_len=S, extra_slots=MAX_SEQ - S)
    logits, cache = prefill(params, {"tokens": jnp.asarray(toks)})
    decode, _, _ = jsteps.build_decode_step(jcfg, mesh, batch_size=B,
                                            seq_len=MAX_SEQ)
    step_logits, _ = decode(params, cache,
                            {"tokens": jnp.asarray(step_toks)})
    torch.save({"params": np_params, "tokens": toks,
                "step_tokens": step_toks}, root / "inputs.pt")
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "params": jax.tree.map(np.asarray, new_params),
            "prefill_logits": np.asarray(logits),
            "decode_logits": np.asarray(step_logits)}


def case_one_rank(rank: int, world: int) -> dict:
    """The port's mesh-bound steps on a 1x1 gloo mesh, from the
    reference's saved parameters and inputs."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.convert import from_jax_params
    from repro_torch.launch import mesh_steps as ms
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import init as opt_init
    from repro_torch.parallel.sharding import distribute
    cfg = ARCHS["smollm-360m"].reduced(dtype="float32")
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    saved = torch.load(Path(os.environ["DRYRUN_TEST_ROOT"]) / "inputs.pt",
                       weights_only=False)
    params = from_jax_params(saved["params"], cfg, device="cpu")
    toks = torch.from_numpy(saved["tokens"])
    step_toks = torch.from_numpy(saved["step_tokens"])
    whole = _whole
    train, sh, _, optc = ms.build_train_step(cfg, mesh)
    batch = {"tokens": toks, "labels": toks}
    new_params, _, metrics = whole(train(
        distribute(params, sh["params"]),
        distribute(opt_init(params, optc), sh["opt"]),
        distribute(batch, sh["batch_fn"](batch))))
    prefill, sh, _ = ms.build_prefill_step(cfg, mesh, batch_size=B,
                                           seq_len=S, extra_slots=MAX_SEQ - S)
    placed = distribute(params, sh["params"])
    logits, cache = prefill(placed, distribute({"tokens": toks},
                                               sh["batch_fn"]({"tokens":
                                                               toks})))
    decode, sh, _ = ms.build_decode_step(cfg, mesh, batch_size=B,
                                         seq_len=MAX_SEQ)
    step_logits, _ = decode(placed, cache,
                            distribute({"tokens": step_toks},
                                       sh["batch_fn"]({"tokens": step_toks})))
    memo = ms.cached_decode_step(cfg, mesh, batch_size=B, seq_len=MAX_SEQ)
    memos = {"same": memo is ms.cached_decode_step(
        cfg, mesh, batch_size=B, seq_len=MAX_SEQ),
        "other_shape": memo is not ms.cached_decode_step(
            cfg, mesh, batch_size=B, seq_len=2 * MAX_SEQ),
        "train": ms.cached_train_step(cfg, mesh) is ms.cached_train_step(
            cfg, mesh)}
    return {"memos": memos, "loss": float(whole(metrics["loss"])),
            "grad_norm": float(whole(metrics["grad_norm"])),
            "params": new_params,
            "prefill_logits": whole(logits).numpy(),
            "decode_logits": whole(step_logits).numpy()}


def _whole(tree):
    from repro_torch import tree as tr
    from repro_torch.parallel.context import is_dtensor
    return tr.tree_map(lambda t: t.full_tensor() if is_dtensor(t) else t,
                       tree)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    root = tmp_path_factory.mktemp("one_rank")
    want = _reference_steps(root)
    os.environ["DRYRUN_TEST_ROOT"] = str(root)
    try:
        got = spawn("test_torch_dryrun:case_one_rank", 1, root / "spawn",
                    deadline_s=240)[0]
    finally:
        os.environ.pop("DRYRUN_TEST_ROOT")
    return got, want


def test_one_rank_train_step_equals_the_reference(one_rank):
    from repro_torch import tree as tr
    from repro_torch.configs.registry import ARCHS
    from repro_torch.convert import from_jax_params
    got, want = one_rank
    assert abs(got["loss"] - want["loss"]) <= LOSS_REL * abs(want["loss"])
    assert abs(got["grad_norm"] - want["grad_norm"]) <= \
        1e-4 * want["grad_norm"]
    cfg = ARCHS["smollm-360m"].reduced(dtype="float32")
    ref = from_jax_params(want["params"], cfg, device="cpu")
    for a, b in zip(tr.leaves(got["params"]), tr.leaves(ref)):
        assert float((a - b).abs().max()) <= 1e-3 * LR


def test_cached_builders_memoize_on_config_mesh_and_shape(one_rank):
    got, _ = one_rank
    assert got["memos"] == {"same": True, "other_shape": True, "train": True}


@pytest.mark.parametrize("which", ["prefill_logits", "decode_logits"])
def test_one_rank_serving_steps_equal_the_reference(one_rank, which):
    got, want = one_rank
    scale = float(np.abs(want[which]).max())
    assert got[which].shape == want[which].shape
    assert float(np.abs(got[which] - want[which]).max()) <= \
        LOGIT_REL * scale


# ------------------------------------- argument bytes against the reference

_REFERENCE_BYTES = r"""
import json, sys
import numpy as np, jax
from jax.sharding import Mesh
from repro.configs.registry import ARCHS
from repro.configs.shapes import Shape, input_specs
from repro.launch import steps
from repro.launch.dryrun import _with_shardings
from repro.models import bind
cfg = ARCHS["smollm-360m"].reduced(dtype="float32")
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out = {}
shape = Shape("t", 32, 4, "train")
j, sh, (p, o), _ = steps.build_train_step(cfg, mesh)
b = input_specs(cfg, shape)
args = (_with_shardings(p, sh["params"]), _with_shardings(o, sh["opt"]),
        _with_shardings(b, sh["batch_fn"](b)))
out["train"] = j.lower(*args).compile().memory_analysis(
    ).argument_size_in_bytes
shape = Shape("d", 48, 4, "decode")
j, sh, p = steps.build_decode_step(cfg, mesh, batch_size=4, seq_len=48)
c = jax.eval_shape(lambda: bind(cfg).init_cache(4, 48))
b = input_specs(cfg, shape)
args = (_with_shardings(p, sh["params"]), _with_shardings(c, sh["cache"]),
        _with_shardings(b, sh["batch_fn"](b)))
out["decode"] = j.lower(*args).compile().memory_analysis(
    ).argument_size_in_bytes
print(json.dumps(out))
"""


def case_port_bytes(rank: int, world: int) -> dict:
    """The dry run's argument bytes of rank 0 on a fake 2x2 mesh."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    cfg = ARCHS["smollm-360m"].reduced(dtype="float32")
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    out = {}
    for kind, shape in (("train", Shape("t", 32, 4, "train")),
                        ("decode", Shape("d", 48, 4, "decode"))):
        step, abstract, shardings = dryrun._step_args(cfg, shape, mesh)
        counted = dryrun.trace_step(step, abstract, shardings, "cpu")
        out[kind] = counted.argument_bytes
    return out


def test_argument_bytes_equal_the_reference_memory_analysis(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.run([sys.executable, "-c", _REFERENCE_BYTES], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=str(REPO))
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    got = spawn("test_torch_dryrun:case_port_bytes", 4, tmp_path,
                deadline_s=300, backend="fake")[0]
    assert got == want


# ----------------------------------------------------- count_step by hand

def case_sharded_mlp(rank: int, world: int) -> dict:
    """``count_step`` of a two-layer MLP on a fake 2x2 mesh: x (8, 64)
    rows over "data"; w1 (64, 128) columns over "model", w2 (128, 64)
    rows over "model"; the output gathered whole."""
    from torch.distributed.tensor import Replicate
    from repro_torch.launch.cost_analysis import count_step, fake_mode
    from repro_torch.launch.dryrun import place_fake
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import NamedSharding, P
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    meta = {"x": torch.empty((8, 64), device="meta"),
            "w1": torch.empty((64, 128), device="meta"),
            "w2": torch.empty((128, 64), device="meta")}
    specs = {"x": P("data", None), "w1": P(None, "model"),
             "w2": P("model", None)}
    mode = fake_mode()
    with mode:
        args = place_fake(meta, {k: NamedSharding(mesh, s)
                                 for k, s in specs.items()}, "cpu")

    def mlp(a):
        h = a["x"] @ a["w1"]                  # local (4, 64) @ (64, 64)
        y = h @ a["w2"]                       # local (4, 64) @ (64, 64)
        return y.redistribute(mesh, [Replicate(), Replicate()])

    _, counted = count_step(mlp, args, mode=mode)
    return {"flops": counted.stats.flops,
            "by_kind": counted.stats.by_kind,
            "argument_bytes": counted.argument_bytes,
            "output_bytes": counted.output_bytes}


def test_count_step_equals_a_hand_count(tmp_path):
    got = spawn("test_torch_dryrun:case_sharded_mlp", 4, tmp_path,
                deadline_s=120, backend="fake")[0]
    # two local (4, 64) x (64, 64) products
    assert got["flops"] == 2 * (2 * 4 * 64 * 64)
    # y is partial over "model": an all-reduce of the local (4, 64) f32
    # result, then the rows gathered over "data" into (8, 64)
    assert got["by_kind"] == {"all-reduce": 4 * 64 * 4,
                              "all-gather": 8 * 64 * 4}
    # x (4, 64), w1 (64, 64), w2 (64, 64) float32 on rank 0
    assert got["argument_bytes"] == 4 * (4 * 64 + 64 * 64 + 64 * 64)
    assert got["output_bytes"] == 8 * 64 * 4


# ------------------------------------------------------------ the roofline

def test_roofline_terms_math():
    from repro_torch.launch.cost_analysis import (HBM_BW, LINK_BW,
                                                  PEAK_FLOPS, PEAK_INT8_OPS,
                                                  Roofline, link_bw)
    r = Roofline(flops=PEAK_FLOPS, hbm_bytes=HBM_BW, collective_bytes=0.0,
                 n_chips=256, model_flops=PEAK_FLOPS * 256)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(1.0)
    assert r.dominant in ("compute", "memory")
    assert r.useful_flops_fraction == pytest.approx(1.0)
    assert r.roofline_fraction == pytest.approx(1.0)
    sc = Roofline(flops=0.0, hbm_bytes=0.0, collective_bytes=LINK_BW["node"],
                  n_chips=1, sc_ops=PEAK_INT8_OPS)
    assert sc.compute_s == pytest.approx(1.0)
    assert sc.collective_s == pytest.approx(1.0)
    assert link_bw((1, 8)) == LINK_BW["node"]
    assert link_bw((16, 16)) == LINK_BW["cross_node"]
    assert link_bw((2, 16, 16)) == LINK_BW["cross_node"]
    keys = {"flops", "hbm_bytes", "collective_bytes", "n_chips",
            "model_flops", "compute_s", "memory_s", "collective_s",
            "dominant", "useful_flops_fraction", "roofline_fraction"}
    assert keys <= set(r.to_dict())


# --------------------------------------------------- the reference's cell

def test_dryrun_one_cell_subprocess(tmp_path):
    """``mamba2-130m long_500k single`` (the reference's own test cell)
    end to end: the fake 256-rank group, the production mesh, an ``ok``
    record with FLOPs and temp bytes; no JAX imported."""
    code = ("import runpy, sys\n"
            "sys.argv = ['dryrun', '--arch', 'mamba2-130m', '--shape', "
            "'long_500k', '--mesh', 'single', '--device', 'cpu', '--out', "
            f"{str(tmp_path)!r}]\n"
            "try:\n"
            "    runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__')\n"
            "finally:\n"
            "    assert 'jax' not in sys.modules and "
            "'repro' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, cwd=str(REPO),
                         timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads((tmp_path / "mamba2-130m__long_500k__single.json")
                     .read_text())
    assert rec["status"] == "ok"
    assert rec["n_chips"] == 256
    assert rec["roofline"]["flops"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
