"""The port's examples (``repro_torch.examples``) held against the JAX
package's examples and functions on the CPU.

Tolerances:

* ``quickstart``: Table I's streams, popcounts and closed forms equal the
  reference's exactly; the MAE and every Table II float within one ulp at
  float32; the SC-GEMM cosine within 1e-5 of the JAX value on the same
  operands; every printed line but the cosine's (other operands) equal to
  the reference example's;
* ``sc_gemm_inference`` on the reference's parameters and tokens
  (``convert.from_jax_params``): with exact projections the hidden states
  and the loss within 1e-5 relative of the JAX example's; under SC-GEMM
  the relative error, the cosine and the loss within 1e-5 of JAX's eager
  run (``jax.disable_jit()``: jitted JAX moves a magnitude across a
  rounding boundary now and then, ROADMAP Queue 3);
* ``serve_lm``: each family's greedy stream on the reference's parameters
  equals ``repro.launch.serve.generate`` at temperature 0 token for token;
  a sampled call gives ``(4, 16)`` streams, the same again with the same
  seed (the port samples from a torch generator, so sampled streams are
  held to themselves, not to ``jax.random``);
* ``train_lm`` at ``--steps 4 --batch 1 --seq 8``, the smallest run at
  which the reference example's own ``last < first`` holds: its losses
  equal a direct pair of ``launch.train.train`` calls bit for bit;
* without a card, and without ``--device cpu``, each example raises.
"""
import dataclasses
import importlib
import importlib.util
import re
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.core import (correlation_encode as jcorrelation_encode,
                        proposed_closed_form as jproposed_closed_form,
                        sc_matmul as jsc_matmul, tcu_decode as jtcu_decode)
from repro.core.error_analysis import mae as jmae
from repro.core.hardware_model import table2 as jtable2
from repro.launch.serve import generate as jgenerate
from repro.models import bind as jbind
from repro_torch.convert import from_jax_params
from repro_torch.errors import ConfigError
from repro_torch.examples import EXAMPLES
from repro_torch.examples import quickstart, sc_gemm_inference, serve_lm
from repro_torch.examples import train_lm
from repro_torch.launch.train import train

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
#: the smallest run at which the reference example's loss falls
TRAIN_ARGS = ["--steps", "4", "--batch", "1", "--seq", "8"]
SC_TOL = 1e-5
#: how long the SC inference tests wait for JAX's eager run (~30 s alone)
JAX_EAGER_TIMEOUT_S = 300


def _ulps(a: float, b: float) -> float:
    """|a - b| in float32 ulps of ``b``."""
    return abs(a - b) / float(np.spacing(np.float32(abs(b))))


def _reference_example(name: str):
    """The JAX package's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def quick(capsys_module):
    out = quickstart.main(CPU)
    return out, capsys_module()


@pytest.fixture(scope="module")
def capsys_module():
    """Stdout captured for a module-scoped run (pytest's capsys is
    function-scoped): a callable returning what was printed since."""
    import contextlib
    import io
    buf = io.StringIO()
    stack = contextlib.ExitStack()
    stack.enter_context(contextlib.redirect_stdout(buf))
    yield lambda: (stack.close(), buf.getvalue())[1]
    stack.close()


# ------------------------------------------------------------ quickstart


@pytest.mark.parametrize("pair", quickstart.TABLE1_PAIRS, ids=str)
def test_quickstart_table1_equals_jax(quick, pair):
    out, _ = quick
    x, y = pair
    row = next(r for r in out["table1"] if (r["x"], r["y"]) == pair)
    xu = jtcu_decode(jnp.int32(x), bits=3)
    yu = jcorrelation_encode(jnp.int32(y), bits=3)
    ou = xu & yu
    text = lambda s: "".join(str(int(b)) for b in np.asarray(s)[::-1])
    assert (row["x_u"], row["y_u"], row["o_u"]) == (text(xu), text(yu),
                                                    text(ou))
    assert row["popcount"] == int(ou.sum())
    assert row["closed_form"] == int(jproposed_closed_form(
        jnp.int32(x), jnp.int32(y), bits=3)) == row["popcount"]


def test_quickstart_mae_and_table2_equal_jax(quick):
    out, _ = quick
    assert _ulps(out["mae"], float(jmae("proposed", 8))) <= 1
    want = jtable2()
    assert list(out["table2"]) == list(want)
    for name, rep in want.items():
        got = out["table2"][name]
        for key in ("area_um2", "latency_ns", "exl_pj_s"):
            assert _ulps(got[key], getattr(rep, key)) <= 1, (name, key)
        assert _ulps(got["mae"], float(jmae(name, 8))) <= 1, name


def test_quickstart_cosine_equals_jax_on_the_same_operands(quick):
    out, _ = quick
    a, b = (jnp.asarray(t.numpy()) for t in
            quickstart.sc_gemm_operands(torch.device("cpu")))
    approx = jsc_matmul(a, b, bits=8, impl="mxu_split")
    exact = a @ b
    want = float(jnp.vdot(approx, exact)
                 / (jnp.linalg.norm(approx) * jnp.linalg.norm(exact)))
    assert abs(out["cosine"] - want) <= 1e-5
    assert 0.9 < out["cosine"] < 1


def test_quickstart_prints_the_reference_lines(quick, capsys):
    _, printed = quick
    _reference_example("quickstart").main()
    want = capsys.readouterr().out.splitlines()
    got = printed.splitlines()
    assert len(got) == len(want)
    cos = re.compile(r"  \(64x256\) @ \(256x64\): cosine similarity vs "
                     r"fp32 GEMM = \d\.\d{4}$")
    for g, w in zip(got, want):
        if cos.match(w):
            assert cos.match(g), g
        else:
            assert g == w


# -------------------------------------------------------------- serving


@pytest.mark.parametrize("arch", serve_lm.ARCH_NAMES)
def test_serve_greedy_streams_equal_jax_generate(arch):
    jcfg = JAX_ARCHS[arch].reduced(dtype="float32")
    jp = jbind(jcfg).init_params(jax.random.PRNGKey(0))
    prompts = jax.random.randint(
        jax.random.PRNGKey(1), (serve_lm.BATCH, serve_lm.PROMPT_LEN), 0,
        jcfg.vocab_size, dtype=jnp.int32)
    want = np.asarray(jgenerate(jcfg, jp, prompts,
                                gen_tokens=serve_lm.GEN_TOKENS,
                                temperature=0.0))
    cfg = serve_lm.ARCHS[arch].reduced(dtype="float32")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    got = serve_lm.serve(cfg, tp, torch.as_tensor(np.array(prompts)), 0.0,
                         "cpu")["tokens"]
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_main_samples_the_same_streams_again(capsys):
    out = serve_lm.main(CPU)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(serve_lm.ARCH_NAMES)
    for line, arch in zip(lines, serve_lm.ARCH_NAMES):
        run = out[arch]
        assert tuple(run["tokens"].shape) == (4, 16)
        assert re.fullmatch(
            rf"\[serve\] {re.escape(f'{arch:14s}')} \({run['family']:7s}\) "
            rf"generated 4x16 tokens in +\d+\.\ds -> sample: \[.*\]", line)
        assert line.endswith(f"sample: {run['tokens'][0, :8].tolist()}")
        cfg, params, prompts = serve_lm.setup(arch, "cpu")
        again = serve_lm.serve(cfg, params, prompts, 0.8, "cpu")["tokens"]
        assert torch.equal(again, run["tokens"])


# ------------------------------------------------------------- training


def test_train_main_equals_two_direct_train_calls(tmp_path, capsys):
    out = train_lm.main(CPU + TRAIN_ARGS)
    printed = capsys.readouterr().out
    assert "[train] restored step 2 from" in printed
    assert re.search(r"\[example\] loss \d+\.\d{3} -> \d+\.\d{3} -> "
                     r"\d+\.\d{3} \(restart resumed training; loss kept "
                     r"falling: (True|False)\)", printed)
    assert out["last"] < out["first"]
    kw = dict(cfg=train_lm.mini_config(), batch=1, seq=8, ckpt_every=1,
              ckpt_dir=str(tmp_path), device="cpu")
    first = train(steps=2, **kw)["losses"]
    second = train(steps=4, **kw)["losses"]
    assert out["losses"] == [first, second]
    assert (out["first"], out["mid"], out["last"]) == (
        first[0], first[-1], second[-1])
    assert all(np.isfinite(first + second))


# --------------------------------------------------------- the CLIs


@pytest.mark.parametrize("name", EXAMPLES)
def test_each_example_runs_on_the_card_by_default(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(ConfigError, match="no CUDA device"):
        module.main([])


# --------------------------------------------------------- SC inference


def _jax_inference() -> dict:
    """The JAX example's own computation: its parameters, tokens and exact
    run, then the SC run eagerly (``jax.disable_jit()``)."""
    base = JAX_ARCHS[sc_gemm_inference.ARCH].reduced(dtype="float32")
    jcfg_sc = dataclasses.replace(base, use_sc_gemm=True, sc_bits=8,
                                  name=base.name + "-sc")
    key = jax.random.PRNGKey(0)
    jp = jbind(base).init_params(key)
    tokens = jax.random.randint(
        jax.random.fold_in(key, 1),
        (sc_gemm_inference.BATCH, sc_gemm_inference.SEQ), 0,
        base.vocab_size, dtype=jnp.int32)
    batch = {"tokens": tokens, "labels": tokens}
    h_exact, _ = jbind(base).forward_hidden(jp, batch)
    want = {"params": jax.tree.map(np.asarray, jp),
            "tokens": np.array(tokens), "h_exact": np.asarray(h_exact),
            "loss_exact": float(jbind(base).loss_fn(jp, batch))}
    with jax.disable_jit():
        h_sc, _ = jbind(jcfg_sc).forward_hidden(jp, batch)
        want["loss_sc"] = float(jbind(jcfg_sc).loss_fn(jp, batch))
    want["rel_err"] = float(jnp.linalg.norm(h_sc - h_exact)
                            / jnp.linalg.norm(h_exact))
    want["cosine"] = float(jnp.vdot(h_sc, h_exact) / (
        jnp.linalg.norm(h_sc) * jnp.linalg.norm(h_exact)))
    return want


@pytest.fixture(scope="module", autouse=True)
def _jax_eager_reference():
    """:func:`_jax_inference` on a thread of its own from this module's
    first test on: JAX's eager run spends most of its time compiling
    each operator, which the other tests' work overlaps."""
    box = {}

    def run():
        try:
            box["want"] = _jax_inference()
        except BaseException as e:      # re-raised where it is read
            box["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def result() -> dict:
        thread.join(timeout=JAX_EAGER_TIMEOUT_S)
        assert not thread.is_alive(), "JAX's eager run did not finish"
        if "error" in box:
            raise box["error"]
        return box["want"]

    yield result
    thread.join(timeout=JAX_EAGER_TIMEOUT_S)


@pytest.fixture(scope="module")
def inference(_jax_eager_reference):
    """The JAX example's numbers, and the port's :func:`compare` on its
    parameters and tokens."""
    from repro_torch.models import bind
    want = _jax_eager_reference()
    cfg_exact, cfg_sc = sc_gemm_inference.configs()
    tp = from_jax_params(want["params"], cfg_exact, device="cpu")
    tokens = torch.as_tensor(want["tokens"])
    got = sc_gemm_inference.compare(cfg_exact, cfg_sc, tp, tokens, "cpu")
    batch = {"tokens": tokens, "labels": tokens}
    with torch.no_grad():
        got["h_exact"] = bind(cfg_exact, "cpu").forward_hidden(
            tp, batch)[0].numpy()
    return got, want


def test_sc_inference_exact_projections_equal_jax(inference):
    got, want = inference
    diff = np.linalg.norm(got["h_exact"] - want["h_exact"])
    assert diff <= 1e-5 * np.linalg.norm(want["h_exact"])
    assert abs(got["loss_exact"] - want["loss_exact"]) <= (
        1e-5 * abs(want["loss_exact"]))


@pytest.mark.parametrize("key", ["rel_err", "cosine", "loss_sc"])
def test_sc_inference_sc_numbers_equal_jax_eager(inference, key):
    got, want = inference
    assert abs(got[key] - want[key]) <= SC_TOL * max(abs(want[key]), 1), (
        got[key], want[key])


@pytest.fixture(scope="module")
def sc_inference_cpu():
    """``sc_gemm_inference.main`` on the CPU, once for the module."""
    return sc_gemm_inference.main(CPU)


@pytest.mark.parametrize("key,shift", [
    ("loss_exact", 0.0), ("loss_exact", 1e-3), ("rel_err", 1e-3),
    ("cosine", 1e-3), ("loss_sc", 1e-3), ("loss_sc", -1e-3)])
def test_sc_inference_card_check_names_what_lies_outside(sc_inference_cpu,
                                                         key, shift):
    """``card_mismatches`` (the card-vs-CPU check of the chip script and
    the gpu tests) passes equal numbers and names each one moved past its
    stated tolerance."""
    cpu = sc_inference_cpu
    card = dict(cpu, **{key: cpu[key] + shift})
    found = sc_gemm_inference.card_mismatches(card, cpu)
    if shift == 0.0:
        assert found == []
    else:
        assert len(found) == 1 and (found[0].startswith(key) or
                                    key == "loss_exact"
                                    and found[0].startswith("exact loss"))
    # within the tolerances, nothing is named
    near = {k: v + 0.5 * (sc_gemm_inference.CARD_EXACT_RTOL * abs(v)
                          if k == "loss_exact"
                          else sc_gemm_inference.CARD_SC_TOL)
            for k, v in cpu.items() if isinstance(v, float)}
    assert sc_gemm_inference.card_mismatches(dict(cpu, **near), cpu) == []


def test_sc_inference_main_prints_the_reference_lines(capsys):
    out = sc_gemm_inference.main(CPU)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "arch: smollm-360m-smoke (2L d=64)"
    assert lines[1] == (f"hidden-state rel err  (SC vs exact): "
                        f"{out['rel_err']:.4f}")
    assert lines[2] == (f"hidden-state cosine   (SC vs exact): "
                        f"{out['cosine']:.4f}")
    assert lines[3] == (f"CE loss exact={out['loss_exact']:.4f}  "
                        f"SC-GEMM={out['loss_sc']:.4f}")
    assert len(lines) == 7
    # the SC numeric costs quality, as in the reference's run
    assert out["loss_sc"] > out["loss_exact"] and out["cosine"] < 1
