"""Training in the port (``models.*.loss_fn``, ``launch.train``) held against
the JAX package on the CPU at the reduced configs (float32), the JAX
parameters carried across by ``repro_torch.convert`` and the JAX gradients
by its ``dtype=torch.float32``.

Tolerances:

* ``loss_fn`` and its gradients, one arch per family (dense, moe, vlm with
  patch embeddings, audio with ``(B, S, K)`` labels, ssm, hybrid), exact
  projections: loss within 1e-5 relative, each gradient leaf within 1e-4
  of its largest magnitude. The labels hold -1 entries, and the
  transformer's sequence pads to a whole loss chunk;
* the same under SC-GEMM at 8 bits for dense and moe in
  ``test_torch_train_sc.py``;
* ``cfg.remat`` on and off give the same gradients bit for bit;
* three ``train_step``s against the reference's three steps (exact
  projections, peak learning rate 1e-2): losses within 1e-5 relative,
  parameters within 1e-3 · lr a step, absolute. The gradients agree within
  1e-6 relative; Adam's ``m / (sqrt(v) + eps)`` magnifies that only for
  the odd gradient near ``eps`` (5.2e-6 at most, in one element);
* ``train`` commits the reference's checkpoint steps (only the final save:
  ``on_step`` marks a step before ``should_checkpoint`` asks), and two
  calls on one directory resume from the first call's save with losses
  within 1e-5 relative of the reference's two-call run.
"""
import dataclasses
import functools
import re
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.launch.train import train as jax_train
from repro.models import bind as jbind
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import apply_updates as jax_apply_updates
from repro.optim import init as jax_opt_init
from repro.optim.schedules import warmup_cosine as jax_warmup_cosine
from repro_torch import tree as tr
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import from_jax_params
from repro_torch.errors import ConfigError
from repro_torch.launch import train as tt
from repro_torch.models import bind, pack_sc_weights
from repro_torch.models.model_zoo import BoundModel
from repro_torch.optim import AdamWConfig
from repro_torch.optim import init as opt_init

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

FAMILIES = ["smollm-360m", "qwen3-moe-235b-a22b", "qwen2-vl-2b",
            "musicgen-large", "mamba2-130m", "zamba2-7b"]
#: Sequence lengths: the transformers' 48 pads to two loss chunks of 32
#: (and 2 x 48 tokens are three router groups); the recurrent families
#: take whole chunks.
SEQ = {"mamba2-130m": 64, "zamba2-7b": 64}
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


def _cfgs(arch, **kw):
    return (JAX_ARCHS[arch].reduced(dtype="float32", **kw),
            ARCHS[arch].reduced(dtype="float32", **kw))


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    jcfg, _ = _cfgs(arch)
    return jbind(jcfg).init_params(jax.random.PRNGKey(0))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seed=0, b=2, s=None):
    s = s or SEQ.get(cfg.name.removesuffix("-smoke"), 48)
    rng = np.random.default_rng(seed)
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
    tokens = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    labels[rng.random(shape) < 0.1] = -1
    out = {"tokens": tokens, "labels": labels}
    if cfg.mrope_sections is not None:
        # 4 patch embeddings on a 2 x 2 grid at t = 0, then the text
        out["visual_embeds"] = rng.standard_normal(
            (b, 4, cfg.d_model)).astype(np.float32)
        text = np.arange(2, s - 2, dtype=np.int32)
        grid = np.array([[0, 0, 0, 0], [0, 0, 1, 1], [0, 1, 0, 1]], np.int32)
        pos = np.concatenate([grid, np.stack([text] * 3)], axis=1)
        out["mrope_positions"] = np.ascontiguousarray(
            np.broadcast_to(pos[:, None], (3, b, s)))
    return out


def _jax_loss_and_grads(jcfg, jp, batch, eager):
    jm = jbind(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if eager:
        with jax.disable_jit():
            loss, grads = jax.value_and_grad(jm.loss_fn)(jp, jb)
    else:
        loss, grads = jax.jit(jax.value_and_grad(jm.loss_fn))(jp, jb)
    return float(loss), grads


def _port_loss_and_grads(tcfg, tp, batch):
    tm = bind(tcfg, "cpu")
    loss, grads = tt.value_and_grad(
        tm, tp, {k: torch.as_tensor(v) for k, v in batch.items()})
    return float(loss), grads


def _assert_grads_close(tgrads, jgrads, tcfg, tol=GRAD_TOL):
    want = from_jax_params(_np_tree(jgrads), tcfg, device="cpu",
                           dtype=torch.float32)
    got_leaves, got_structure = tr.flatten(tgrads)
    want_leaves, want_structure = tr.flatten(want)
    assert repr(got_structure) == repr(want_structure)
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        assert g.shape == w.shape and torch.isfinite(g).all()
        scale = float(w.abs().max())
        err = float((g.to(torch.float32) - w).abs().max())
        assert err <= tol * max(scale, 1e-30), (i, err, scale)


def _check_family(arch, sc, eager, **shape):
    jcfg, tcfg = _cfgs(arch, use_sc_gemm=sc)
    if eager:
        # JAX's eager run compiles every primitive at first use; without
        # its rematerialisation it has half as many (the port's remat is
        # held bitwise to no remat below)
        jcfg = dataclasses.replace(jcfg, remat=False)
    jp = _jax_params(arch)
    tp = from_jax_params(_np_tree(jp), tcfg, device="cpu")
    batch = _batch(tcfg, **shape)
    jloss, jgrads = _jax_loss_and_grads(jcfg, jp, batch, eager)
    tloss, tgrads = _port_loss_and_grads(tcfg, tp, batch)
    assert np.isfinite(tloss)
    assert abs(tloss - jloss) <= LOSS_RTOL * abs(jloss), (tloss, jloss)
    _assert_grads_close(tgrads, jgrads, tcfg)
    return tloss


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_equal_jax_exact(arch):
    _check_family(arch, sc=False, eager=False)


def test_bound_model_loss_fn_is_the_family_loss():
    from repro_torch.models import ssm_lm, transformer, zamba2
    for arch, mod in (("smollm-360m", transformer),
                      ("musicgen-large", transformer),
                      ("mamba2-130m", ssm_lm), ("zamba2-7b", zamba2)):
        _, tcfg = _cfgs(arch)
        tm = bind(tcfg, "cpu")
        tp = tm.init_params(1)
        batch = {k: torch.as_tensor(v) for k, v in _batch(tcfg).items()}
        with torch.no_grad():
            assert torch.equal(tm.loss_fn(tp, batch),
                               mod.loss_fn(tp, tcfg, batch))


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-moe-235b-a22b",
                                  "mamba2-130m", "zamba2-7b"])
def test_remat_gives_the_same_gradients_bitwise(arch):
    _, tcfg = _cfgs(arch, use_sc_gemm=True)
    tp = bind(tcfg, "cpu").init_params(3)
    batch = _batch(tcfg, seed=3)
    assert tcfg.remat
    lon, gon = _port_loss_and_grads(tcfg, tp, batch)
    loff, goff = _port_loss_and_grads(
        dataclasses.replace(tcfg, remat=False), tp, batch)
    assert lon == loff
    for a, b in zip(tr.leaves(gon), tr.leaves(goff)):
        assert torch.equal(a, b)


def test_remat_leaves_serving_untouched(monkeypatch):
    """Without a gradient (serving, graph capture) no group is
    rematerialised."""
    from repro_torch.models import layers
    calls = []
    monkeypatch.setattr(layers, "checkpoint",
                        lambda *a, **k: calls.append(1) or a[0](a[1]))
    _, tcfg = _cfgs("smollm-360m")
    tm = bind(tcfg, "cpu")
    tp = tm.init_params(0)
    batch = {k: torch.as_tensor(v) for k, v in _batch(tcfg).items()}
    with torch.no_grad():
        tm.forward_hidden(tp, batch)
    assert not calls
    tm.loss_fn(tr.tree_map(lambda p: p.requires_grad_(), tp), batch)
    assert len(calls) == tcfg.n_layers // tcfg.group_size


def test_three_train_steps_equal_jax():
    jcfg, tcfg = _cfgs("smollm-360m")
    jm, tm = jbind(jcfg), bind(tcfg, "cpu")
    jp = _jax_params("smollm-360m")
    tp = from_jax_params(_np_tree(jp), tcfg, device="cpu")
    jopt = JaxAdamWConfig()
    js, ts = jax_opt_init(jp, jopt), opt_init(tp, AdamWConfig())
    steps, lr = 3, 1e-2

    @jax.jit
    def jstep(p, s, b):
        loss, grads = jax.value_and_grad(jm.loss_fn)(p, b)
        lrate = jax_warmup_cosine(s["step"], peak_lr=lr,
                                  warmup_steps=max(steps // 20, 1),
                                  total_steps=steps)
        p, s = jax_apply_updates(p, grads, s, jopt, lrate)
        return p, s, loss

    for step in range(steps):
        batch = _batch(tcfg, seed=10 + step)
        jp, js, jloss = jstep(jp, js, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        tp, ts, tloss, _ = tt.train_step(
            tm, tp, ts, {k: torch.as_tensor(v) for k, v in batch.items()},
            lr_peak=lr, steps=steps, optc=AdamWConfig())
        assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * float(jloss)
    assert int(ts["step"]) == steps
    want = from_jax_params(_np_tree(jp), tcfg, device="cpu")
    for i, (a, b) in enumerate(zip(tr.leaves(tp), tr.leaves(want))):
        err = float((a - b).abs().max())
        assert err <= 1e-3 * lr * steps, (i, err)


def test_train_and_cli_lower_the_loss(capsys):
    _, tcfg = _cfgs("smollm-360m", use_sc_gemm=True)
    out = tt.train(tcfg, steps=12, batch=4, seq=32, ckpt_dir=None, lr=1e-2,
                   log_every=100, device="cpu")
    losses = out["losses"]
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] and out["final_loss"] == losses[-1]
    assert out["params"]["embed"].device.type == "cpu"
    tt.main(["--arch", "smollm-360m", "--reduced", "--sc-gemm", "--device",
             "cpu", "--steps", "12", "--batch", "4", "--seq", "32", "--lr",
             "1e-2"])
    printed = capsys.readouterr().out
    first = float(re.search(r"step +0 loss ([\d.]+)", printed).group(1))
    final = float(re.search(r"final loss ([\d.]+)", printed).group(1))
    assert final < first


def test_train_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="CUDA"):
        tt.main(["--arch", "smollm-360m", "--reduced", "--steps", "1"])


def test_train_refuses_a_packed_tree(monkeypatch):
    _, tcfg = _cfgs("smollm-360m", use_sc_gemm=True)
    tm = bind(tcfg, "cpu")
    packed = pack_sc_weights(tm.init_params(0), tcfg)
    batch = {k: torch.as_tensor(v) for k, v in _batch(tcfg).items()}
    with pytest.raises(ConfigError, match="packed"):
        tt.train_step(tm, packed, opt_init(tm.init_params(0), AdamWConfig()),
                      batch, lr_peak=1e-3, steps=1, optc=AdamWConfig())
    monkeypatch.setattr(BoundModel, "init_params",
                        lambda self, seed=0: packed)
    with pytest.raises(ConfigError, match="packed"):
        tt.train(tcfg, steps=1, batch=2, seq=32, ckpt_dir=None, device="cpu")


# --------------------------------------------- checkpoint cadence and resume

TRAIN = dict(batch=2, seq=32, ckpt_every=2, log_every=100)


@functools.lru_cache(maxsize=None)
def _jax_two_calls():
    """The reference's two-call run (``examples/train_lm.py``): 3 steps,
    then up to 6 on the same directory; committed steps after each."""
    jcfg, _ = _cfgs("smollm-360m")
    with tempfile.TemporaryDirectory() as d:
        out1 = jax_train(jcfg, steps=3, ckpt_dir=d, **TRAIN)
        after1 = JaxCheckpointer(d).all_steps()
        out2 = jax_train(jcfg, steps=6, ckpt_dir=d, **TRAIN)
        after2 = JaxCheckpointer(d).all_steps()
    return out1["losses"], after1, out2["losses"], after2


def _port_from_jax_init(monkeypatch):
    """The port's ``train`` started from the reference's initial weights
    (``init_params`` draws differ between the packages)."""
    _, tcfg = _cfgs("smollm-360m")
    jp = _np_tree(_jax_params("smollm-360m"))
    monkeypatch.setattr(
        BoundModel, "init_params",
        lambda self, seed=0: from_jax_params(jp, self.cfg, device=self.device))
    return tcfg


def test_committed_steps_and_two_call_resume_equal_jax(monkeypatch, tmp_path,
                                                       capsys):
    jl1, jafter1, jl2, jafter2 = _jax_two_calls()
    tcfg = _port_from_jax_init(monkeypatch)
    out1 = tt.train(tcfg, steps=3, ckpt_dir=str(tmp_path), device="cpu",
                    **TRAIN)
    assert Checkpointer(tmp_path).all_steps() == jafter1 == [3]
    out2 = tt.train(tcfg, steps=6, ckpt_dir=str(tmp_path), device="cpu",
                    **TRAIN)
    assert "[train] restored step 3" in capsys.readouterr().out
    assert Checkpointer(tmp_path).all_steps() == jafter2 == [3, 6]
    assert len(out1["losses"]) == 3 and len(out2["losses"]) == 3
    for got, want in zip(out1["losses"] + out2["losses"], jl1 + jl2):
        assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)


def test_resumed_state_equals_the_saved_state(tmp_path):
    _, tcfg = _cfgs("smollm-360m", use_sc_gemm=True)
    out = tt.train(tcfg, steps=2, batch=2, seq=32, ckpt_dir=str(tmp_path),
                   device="cpu", log_every=100)
    tm = bind(tcfg, "cpu")
    like = tm.init_params(0)
    state = Checkpointer(tmp_path).restore(
        2, {"params": like, "opt": opt_init(like, AdamWConfig())})
    for a, b in zip(tr.leaves(state["params"]), tr.leaves(out["params"])):
        assert torch.equal(a, b)
    assert int(state["opt"]["step"]) == 2


def test_compressed_gradients_step_is_the_composed_step():
    """``train(compress_grads=True)`` takes the reference's compress path:
    gradients, EF-int8 with the error carried to the next step, then the
    update (each function held against JAX in test_torch_optim_data.py)."""
    from repro_torch.data import PipelineConfig, TokenPipeline
    from repro_torch.optim.grad_compression import (compress_with_feedback,
                                                    init_error_state)
    _, tcfg = _cfgs("smollm-360m", use_sc_gemm=True)
    got = tt.train(tcfg, steps=2, ckpt_dir=None, compress_grads=True,
                   device="cpu", **TRAIN)
    tm = bind(tcfg, "cpu")
    params = tm.init_params(0)
    state, err = opt_init(params, AdamWConfig()), None
    pipe = TokenPipeline(PipelineConfig(vocab_size=tcfg.vocab_size, seq_len=32,
                                        global_batch=2))
    for step in range(2):
        batch = {k: torch.as_tensor(v)
                 for k, v in pipe.get_batch(step).items()}
        loss, grads = tt.value_and_grad(tm, params, batch)
        err = init_error_state(grads) if err is None else err
        grads, err = compress_with_feedback(grads, err)
        params, state = tt._update(params, grads, state, AdamWConfig(),
                                   3e-4, 2)
        assert float(loss) == got["losses"][step]
    for a, b in zip(tr.leaves(params), tr.leaves(got["params"])):
        assert torch.equal(a, b)
