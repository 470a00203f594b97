"""The port's analysis layer (``repro_torch.analysis``) on the CPU: a
true-positive and a near-miss fixture for each of R1–R5 and S0 (the JAX
package's fixtures of ``tests/test_analysis.py`` written as torch code at
``src/repro_torch/...`` paths, with the same finding counts), the CLI's
exit codes, the port linting clean, each contract audit passing and
catching an injected fault, and the framework-neutral parts held against
the JAX package: the rule engine with R3 and R4 on the same fixtures, and
the copy-on-write schedule stepped through both engines."""
import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.analysis import base as jbase
from repro.analysis import rules as jrules
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models import bind as jbind
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.analysis import DEFAULT_RULES, Suppressions, run_lint
from repro_torch.analysis import base as tbase
from repro_torch.analysis import contracts, rules
from repro_torch.analysis.cli import main as lint_main
from repro_torch.analysis.scopes import find_traced_contexts
from repro_torch.convert import from_jax_params
from repro_torch.kernels import paged_attention as paged
from repro_torch.launch import steps
from repro_torch.models import layers
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import slots
from repro_torch.serving.prefix import PrefixMatch

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def _lint(tmp_path, relpath, code, rule_set=DEFAULT_RULES, run=run_lint):
    """Write one fixture module at a scope-matching path and lint it."""
    p = tmp_path / relpath
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(code))
    report = run([p], list(rule_set))
    return [f.rule for f in report.findings], report


# ----------------------------------------------------------------- R1

def test_r1_true_positive_branch_and_coercions(tmp_path):
    found, report = _lint(tmp_path, "src/repro_torch/kernels/bad_kernel.py", """
        import torch

        class _Scale(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x: torch.Tensor):
                if x > 0:                  # branch on a device tensor
                    x = x + 1
                n = x.sum().item()         # host read of a device tensor
                return float(x)            # host coercion of a device tensor
    """)
    assert found.count("R1") == 3, report.findings


def test_r1_true_positive_step_buffer_taint(tmp_path):
    found, report = _lint(tmp_path, "src/repro_torch/launch/steps.py", """
        import torch

        class BadStep:
            def __init__(self, n):
                self.tokens = torch.zeros((n, 1), dtype=torch.int32)

            def run(self):
                v = self.tokens
                if v.sum() > 0:            # branch on a captured buffer
                    self.tokens.add_(1)
    """)
    assert "R1" in found, report.findings


def test_r1_true_positive_fake_and_data_dependent_shapes(tmp_path):
    found, report = _lint(tmp_path, "src/repro_torch/kernels/bad_fake.py", """
        import torch

        def _impl(x: torch.Tensor, n: int) -> torch.Tensor:
            return x

        _op = torch.library.custom_op("fx::op", _impl, mutates_args=())

        @_op.register_fake
        def _fake(x, n):
            rows = int(x.sum())            # a fake tensor has no data
            keep = x.nonzero()             # data-dependent shape
            return x.new_empty((rows, n)) if n else keep

        def paged_decode_step(tables: torch.Tensor):
            return tables.cpu().tolist()   # two host copies in a step
    """)
    assert found.count("R1") == 4, report.findings


def test_r1_near_miss_host_arguments_and_shapes(tmp_path):
    found, report = _lint(tmp_path, "src/repro_torch/kernels/good_kernel.py", """
        import torch

        class _Op(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x: torch.Tensor, causal: bool, window=None):
                if causal:                 # host argument: fine
                    x = x + 1
                if window is not None:     # structure check: fine
                    x = x - window
                rows = x.shape[0]
                if rows > 8 and x.is_cuda:  # shape and device: host values
                    x = x * 2
                if x.dtype == torch.bfloat16 or x.dim() > 3:
                    x = x.float()
                return x

        def _impl(x: torch.Tensor, bits: int) -> torch.Tensor:
            return x

        _op = torch.library.custom_op("fx::op", _impl, mutates_args=())

        @_op.register_fake
        def _fake(x, bits):
            if bits > 8:                   # the operator's host argument
                return x.new_empty(x.shape)
            return x.new_empty((x.size(0), bits))
    """)
    assert "R1" not in found, report.findings
    found, report = _lint(tmp_path, "src/repro_torch/launch/steps.py", """
        import torch

        class GoodStep:
            def __init__(self, n, chunk):
                self.tokens = torch.zeros((n, chunk), dtype=torch.int32)
                self.chunk = chunk

            def run(self):
                v = self.tokens
                if self.chunk is not None and v.shape[1] == self.chunk:
                    v = v + 1              # host config and shape: fine
                self.tokens.copy_(v)

        def host_side(x: torch.Tensor):    # not reached by a step
            return x.item()
    """)
    assert "R1" not in found, report.findings


def test_r1_finds_the_ports_traced_contexts():
    """The detector sees the idioms it names in the port itself."""
    def contexts(rel):
        tree = ast.parse((PORT / rel).read_text())
        return {(c.func.name, c.reason) for c in find_traced_contexts(tree)}

    step = contexts("launch/steps.py")
    assert ("run", "step-run") in step and \
        ("paged_decode_step", "step-function") in step
    for rel, fake in (("kernels/flash_attention.py", "_flash_attention_fake"),
                      ("kernels/sc_matmul.py", "_sc_linear_fake"),
                      ("kernels/paged_attention.py", "_paged_attention_fake")):
        assert (fake, "fake") in contexts(rel)
    for rel in ("core/sc_layers.py", "models/layers.py", "parallel/context.py"):
        assert {("forward", "autograd"), ("backward", "autograd")} <= \
            contexts(rel)


# ----------------------------------------------------------------- R2

def test_r2_true_positive_per_request_graph(tmp_path):
    found, report = _lint(tmp_path, "src/repro_torch/launch/bad_serve.py", """
        import torch

        def generate(model, tokens):
            graph = torch.cuda.CUDAGraph()       # captured every request
            with torch.cuda.graph(graph):
                out = model(tokens)
            graph.replay()
            return out
    """)
    assert found.count("R2") == 2, report.findings


def test_r2_near_miss_memoized_builders_and_module_level(tmp_path):
    found, report = _lint(tmp_path, "src/repro_torch/launch/good_serve.py", """
        import ctypes
        import functools
        import torch

        compiled = torch.compile(lambda x: x + 1)   # module level: once

        @functools.lru_cache(maxsize=8)
        def cached_step(n):
            return build_step(n)

        def build_step(n):
            return torch.compile(lambda x: x * n)   # reached via the memo

        _LIBS = {}

        def load(name):
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(name)             # a keyed dict memo
                _LIBS[name] = lib
            return lib

        _STEPS = {}

        def capture(step):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                step.run()
            step.graph = graph

        def cached_decode_step(key, step):
            if key not in _STEPS:
                capture(step)                       # called by the memo
                _STEPS[key] = step
            return _STEPS[key]
    """)
    assert "R2" not in found, report.findings


# ----------------------------------------------------------------- R3

def test_r3_true_positive_bare_raise_on_serving_path(tmp_path):
    found, report = _lint(tmp_path, "src/repro_torch/serving/bad_pool.py", """
        def admit(free):
            if not free:
                raise RuntimeError("pool full")
            if free < 0:
                raise ValueError("bad capacity")
    """)
    assert found.count("R3") == 2, report.findings


def test_r3_near_miss_typed_errors_and_out_of_scope(tmp_path):
    found, report = _lint(tmp_path, "src/repro_torch/serving/good_pool.py", """
        from repro_torch.errors import ConfigError, PoolExhausted

        def admit(free, capacity):
            if capacity < 1:
                raise ConfigError("needs capacity >= 1")
            if not free:
                raise PoolExhausted("admission", pages_needed=1,
                                    pages_free=0)
    """)
    assert "R3" not in found, report.findings
    found, report = _lint(tmp_path, "src/repro_torch/core/validation.py", """
        def check(x):
            raise ValueError("not a serving path")
    """)
    assert "R3" not in found, report.findings


# ----------------------------------------------------------------- R4

R4_BAD = """
    class AutotuneCache:
        @staticmethod
        def key(m, n, k, device, backend):
            return f"sc_gemm:{backend}:{m}x{n}x{k}"      # no mode

        @staticmethod
        def flash_key(shape, device):
            return f"flash:{_mode(device)}:{shape}"      # no backend
"""
R4_GOOD = """
    class AutotuneCache:
        @staticmethod
        def key(m, device, backend):
            return f"sc_gemm:{_mode(device)}:{backend}:m{m}"

        @staticmethod
        def flash_key(shape, device, backend):
            return f"flash:{_mode(device)}:{backend}:{shape}"

        def lookup(self, name):          # not a key builder
            return f"hit:{name}"
"""


def test_r4_true_positive_key_missing_segments(tmp_path):
    found, report = _lint(tmp_path, "src/repro_torch/kernels/bad_cache.py",
                          R4_BAD)
    assert found.count("R4") == 2, report.findings


def test_r4_near_miss_complete_keys(tmp_path):
    found, report = _lint(tmp_path, "src/repro_torch/kernels/good_cache.py",
                          R4_GOOD)
    assert "R4" not in found, report.findings


# ----------------------------------------------------------------- R5

def test_r5_true_positive_half_cast_and_default_accumulator(tmp_path):
    found, report = _lint(tmp_path, "src/repro_torch/kernels/bad_dtype.py", """
        import torch

        def counts(x, y):
            p = x.to(torch.bfloat16)                       # narrows counts
            return torch.einsum("ij,jk->ik", p, y)         # backend's acc
    """)
    assert found.count("R5") == 2, report.findings


@pytest.mark.parametrize("line", [
    "x.half() + y", "x.bfloat16() + y", "torch.zeros(4, dtype=torch.float16)",
    "x @ y", "torch.matmul(x.float(), y)", "x.float().mm(y)",
    "torch.bmm(x.to(torch.float32), y)"])
def test_r5_true_positive_forms(tmp_path, line):
    found, report = _lint(tmp_path, "src/repro_torch/core/sc_matmul.py", f"""
        import torch

        def counts(x, y):
            return {line}
    """)
    assert found.count("R5") == 1, report.findings


def test_r5_near_miss_full_width_and_out_of_scope(tmp_path):
    found, report = _lint(tmp_path, "src/repro_torch/kernels/good_dtype.py", """
        import torch
        from repro_torch.models.layers import tree_sum

        def counts(x, y):
            p = x.to(torch.float32)
            q = y.to(dtype=torch.int32)
            a = torch.einsum("ij,jk->ik", p, y.to(torch.float32))
            b = p @ q.float()
            return a + b + tree_sum(p[..., None] * y.float(), -2)
    """)
    assert "R5" not in found, report.findings
    # models outside layers.py may cast deliberately
    found, report = _lint(tmp_path, "src/repro_torch/models/layers_extra.py", """
        import torch

        def probs(p):
            return p.to(torch.bfloat16)
    """)
    assert "R5" not in found, report.findings


# --------------------------------------------------------- suppressions

SUPP_OK = """
    def admit(free):
        # repro-lint: disable=R3 -- fixture demonstrating suppression
        raise RuntimeError("pool full")
"""
SUPP_BAD = """
    def admit(free):
        raise RuntimeError("pool full")  # repro-lint: disable=R3
"""


def test_suppression_requires_justification(tmp_path):
    found, _ = _lint(tmp_path, "src/repro_torch/serving/supp_ok.py", SUPP_OK)
    assert found == []
    found, report = _lint(tmp_path, "src/repro_torch/serving/supp_bad.py",
                          SUPP_BAD)
    assert "S0" in found and "R3" in found, report.findings


def test_suppression_near_miss_other_rule_and_distance(tmp_path):
    """A justified disable covers only the rules it names, on its own line
    or the line after a standalone comment."""
    found, report = _lint(tmp_path, "src/repro_torch/serving/supp_far.py", """
        def admit(free):
            # repro-lint: disable=R1 -- names another rule
            raise RuntimeError("pool full")
            # repro-lint: disable=R3 -- two lines above the raise

            raise ValueError("bad")
    """)
    assert found == ["R3", "R3"], report.findings


# ------------------------------------------------------------ CLI + port

def test_cli_port_runs_clean(capsys):
    """The acceptance gate: the port linted by its own rules is clean, and
    every suppression it honours carries a justification (else S0)."""
    rc = lint_main([str(PORT), "--error-on-findings"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert " 0 findings" in out
    n = sum(len(Suppressions(p.read_text(), str(p))._by_line)
            for p in PORT.rglob("*.py"))
    assert n >= 2       # models/layers.py's bf16_probs casts at least


def test_cli_exit_codes_and_rule_filter(tmp_path, capsys):
    bad = tmp_path / "src/repro_torch/serving/cli_fixture.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("def f():\n    raise ValueError('x')\n")
    assert lint_main([str(bad)]) == 0                   # report-only
    assert lint_main([str(bad), "--error-on-findings"]) == 1
    assert lint_main([str(bad), "--error-on-findings", "--rules", "R1"]) == 0
    assert lint_main([str(bad), "--error-on-findings",
                      "--rules", "R1,R3"]) == 1
    assert lint_main([str(bad), "--rules", "R9"]) == 2  # unknown rule
    broken = tmp_path / "src/repro_torch/serving/broken.py"
    broken.write_text("def f(:\n")
    assert lint_main([str(broken)]) == 2                # parse error
    capsys.readouterr()
    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert [ln.split()[0] for ln in out.splitlines()] == \
        ["R1", "R2", "R3", "R4", "R5"]
    assert "host-sync-safety" in out


def test_module_entry_points_import_neither_jax_nor_the_jax_package():
    """``python -m repro_torch.analysis`` (the seven modules, ``__main__``
    included) loads nothing of JAX or of the JAX package."""
    code = ("import runpy, sys\n"
            "sys.argv = ['repro_torch.analysis', '--list-rules']\n"
            "try:\n"
            "    runpy.run_module('repro_torch.analysis', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "import repro_torch.analysis.contracts\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert {p.name for p in (PORT / "analysis").glob("*.py")} == {
        p.name for p in (SRC / "repro" / "analysis").glob("*.py")}


# ------------------------------------------------------ contract audits

def test_contracts_cli_on_the_cpu_passes_every_audit(capsys):
    assert contracts.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert [ln.split()[0] for ln in out.splitlines()
            if ln.startswith("[")] == ["[PASS]"] * 4
    for name, _ in contracts.AUDITS:
        assert f"contract audit: {name} (cpu)" in out


def test_contracts_cli_without_a_card_fails_and_names_it(monkeypatch,
                                                          capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert contracts.main([]) == 2
    err = capsys.readouterr().err
    assert "no CUDA device" in err
    with pytest.raises(SystemExit):
        contracts.main(["--device", "tpu"])


def test_popcount_audit_catches_injected_half_cast(monkeypatch):
    import importlib
    sc_matmul = importlib.import_module("repro_torch.core.sc_matmul")
    real = sc_matmul.signed_counts

    def poisoned(sx, mx, sy, my, bits):
        # the closed form's magnitudes squeezed through bf16 and back
        return real(sx, mx.to(torch.bfloat16).to(mx.dtype), sy, my, bits)

    monkeypatch.setattr(sc_matmul, "signed_counts", poisoned)
    problems = contracts.audit_popcount_path("cpu")
    assert any(p.startswith("sc_matmul_reference:") and "bfloat16" in p
               for p in problems), problems


def test_popcount_audit_catches_a_float_stream(monkeypatch):
    from repro_torch.kernels import sc_bitops
    real = sc_bitops.sc_stream_mul_torch

    def floaty(x, y, *, bits):
        return real(x, y, bits=bits).to(torch.float32).round().to(torch.int32)

    monkeypatch.setattr(sc_bitops, "sc_stream_mul_torch", floaty)
    problems = contracts.audit_popcount_path("cpu")
    assert any("produces torch.float32" in p for p in problems), problems


def test_reduction_parity_catches_a_sum_in_one_path(monkeypatch):
    real_sum, real_paged = layers.tree_sum, paged.paged_attention_torch

    def summed(*args, **kwargs):
        # one path's tree_sum swapped for .sum(), the other left alone
        with monkeypatch.context() as m:
            m.setattr(layers, "tree_sum", lambda x, dim=-1: x.sum(dim))
            return real_paged(*args, **kwargs)

    monkeypatch.setattr(paged, "paged_attention_torch", summed)
    problems = contracts.audit_reduction_parity("cpu")
    assert sum("paged plain version reduces [('sum', 16" in p
               for p in problems) == 2, problems
    assert layers.tree_sum is real_sum


def test_reduction_parity_catches_bf16_accumulation(monkeypatch):
    real = layers.tree_sum

    def bf16_sum(x, dim=-1):
        return real(x.to(torch.bfloat16), dim).to(x.dtype)

    monkeypatch.setattr(layers, "tree_sum", bf16_sum)
    problems = contracts.audit_reduction_parity("cpu")
    assert any("accumulates in bfloat16, not float32" in p
               for p in problems), problems


def test_reduction_structure_tells_tree_sum_from_sum_and_einsum():
    x = torch.randn(3, 12)
    tree = contracts.reductions(contracts.record_ops(layers.tree_sum, x)[1])
    assert tree == [("add", 16, "float32"), ("add", 8, "float32"),
                    ("add", 4, "float32"), ("add", 2, "float32")]
    assert contracts.reductions(contracts.record_ops(
        lambda t: t.sum(-1), x)[1]) == [("sum", 12, "float32")]
    eins = contracts.reductions(contracts.record_ops(
        lambda t: torch.einsum("ij,j->i", t, torch.ones(12)), x)[1])
    assert eins and all(op != "add" for op, _, _ in eins)


def test_capture_counts_catch_a_second_decode_entry(monkeypatch):
    real = steps._decode_key
    calls = iter(range(100))

    def fresh_key(*args, **kwargs):
        return (*real(*args, **kwargs), next(calls))   # never a hit

    monkeypatch.setattr(steps, "_decode_key", fresh_key)
    problems = contracts.audit_capture_counts("cpu")
    assert any("2 decode entries" in p for p in problems), problems
    assert any("made its own decode entry" in p for p in problems), problems
    assert steps._decode_key is fresh_key and not [
        k for k in steps.decode_steps() if k[0].name.startswith("contract")]


def test_capture_counts_catch_more_prefill_steps_than_buckets(monkeypatch):
    calls = iter(range(1000))

    def per_chunk(decode, *, bucket, chunk):
        # a prefill step per call, as a per-prompt-length cache would make
        return steps._prefill_entry(decode, ("chunked", bucket, chunk,
                                             next(calls)),
                                    extent=bucket, chunk=chunk)

    monkeypatch.setattr(engine_mod, "cached_chunked_prefill_step", per_chunk)
    problems = contracts.audit_capture_counts("cpu")
    assert any("8 prefill steps after a second engine exceeds the bucket "
               "bound" in p for p in problems), problems
    assert any("a second run of the schedule captured" in p
               for p in problems), problems
    assert steps.capture.__name__ == "capture"     # the stand-in is gone


def test_cow_protocol_catches_a_skipped_copy(monkeypatch):
    real = slots.PagedSlotPool.admit_prefix

    def no_copy(self, entry, single_cache, match):
        if match.cow_src is None:
            return real(self, entry, single_cache, match)
        # the resume page attached by reference, never copied
        return real(self, entry, single_cache, PrefixMatch(
            resume=len(match.pages) * match.block, pages=match.pages,
            block=match.block))

    monkeypatch.setattr(slots.PagedSlotPool, "admit_prefix", no_copy)
    problems = contracts.audit_cow_protocol("cpu")
    assert any("refcount ledger" in p for p in problems), problems


# ------------------------------------------- held against the JAX package

NEUTRAL = [("serving/bad_pool.py", """
    def admit(free):
        if not free:
            raise RuntimeError("pool full")
        if free < 0:
            raise ValueError("bad capacity")
"""), ("serving/good_pool.py", """
    from errors import ConfigError, PoolExhausted

    def admit(free, capacity):
        if capacity < 1:
            raise ConfigError("needs capacity >= 1")
        if not free:
            raise PoolExhausted("admission")
"""), ("serving/supp_ok.py", SUPP_OK), ("serving/supp_bad.py", SUPP_BAD),
    ("kernels/bad_cache.py", R4_BAD), ("kernels/good_cache.py", R4_GOOD),
    ("serving/mixed.py", """
    class AutotuneCache:
        def key(self, backend):
            raise Exception("unbuilt")  # repro-lint: disable=R3,R4 -- why
            return f"k:{backend}"  # repro-lint: disable=R4 --
    """)]


@pytest.mark.parametrize("rel,code", NEUTRAL, ids=[r for r, _ in NEUTRAL])
def test_engine_r3_r4_give_the_reference_findings(tmp_path, rel, code):
    def findings(pkg, mod, rule_set):
        _, report = _lint(tmp_path / pkg, f"src/{pkg}/{rel}", code,
                          rule_set, mod.run_lint)
        return [(f.rule, f.line) for f in report.findings]

    want = findings("repro", jbase, (jrules.TypedBackpressure(),
                                     jrules.CacheKeyCompleteness()))
    got = findings("repro_torch", tbase,
                   (rules.TypedBackpressure(), rules.CacheKeyCompleteness()))
    assert got == want
    src = textwrap.dedent(code)
    js, ts = jbase.Suppressions(src, "f.py"), Suppressions(src, "f.py")
    assert ts._by_line == js._by_line
    assert [(f.rule, f.line) for f in ts.unjustified] == \
        [(f.rule, f.line) for f in js.unjustified]


def _ledger(engine) -> list[tuple]:
    """The pool's ledger after every scheduler step of a drained run."""
    pool = engine.pool

    def snap():
        return (pool.refcount.tolist(), pool.n_cow,
                engine._n_prefix_hits, pool.free_pages)

    out = [snap()]
    while engine.step():
        out.append(snap())
    return out


def test_cow_schedule_ledger_equals_the_jax_engine():
    jcfg = JaxModelConfig(
        name="contract-audit-prefix", family="dense", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=128, dtype="float32", q_block=16, kv_block=16,
        loss_chunk=16, remat=False, use_sc_gemm=True).validate()
    cfg = contracts.audit_config("contract-audit-prefix")
    jp = jbind(jcfg).init_params(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    jeng = JaxEngine(jcfg, jp, capacity=2, max_seq=32, block=8, chunk=4)
    for i, p in enumerate(contracts.cow_prompts(cfg.vocab_size)):
        jeng.queue.submit(JaxRequest(uid=f"cow-{i}", prompt=p,
                                     max_new_tokens=5))
    want = _ledger(jeng)
    got = _ledger(contracts.cow_engine(cfg, tp, torch.device("cpu")))
    assert got == want
    assert got[-1][1] >= 1 and got[-1][2] >= 2      # shared and copied
