"""Public-name parity: every module of the JAX package has a twin in the
port at the same path, and every name in a twin's ``__all__`` exists in
the port's module, except the names written below, each renamed or
recast for the port with its reason. The map is exact: an entry whose
name the port's module has is stale and fails. ``sc_einsum_bd_df`` is
held to the reference's on the CPU.

The reference's ``__all__`` lists are read from its sources, never by
importing its modules: one (``launch/dryrun.py``) sets ``XLA_FLAGS`` when
imported, which would reach every later JAX backend of the worker."""
import ast
import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

#: JAX modules with no twin at their path: the port's home, or None.
MODULES = {
    "repro.kernels._compat": (
        None, "shims over the Pallas TPU API across JAX releases; the port "
        "has no Pallas"),
    "repro.launch.hlo_analysis": (
        "repro_torch.launch.cost_analysis",
        "the dry run's costs come from counting the step's operators under "
        "a FakeTensorMode, not from HLO text"),
}

_PALLAS = "the Pallas kernel's entry; the port launches its CUDA kernel"
_ANALYSIS = ("a JAX-only analysis: it walks jaxprs or JAX tracing scopes, "
             "which a PyTorch program does not have")
_MESH_STEPS = ("the reference's mesh-bound builders and their memos live "
               "in launch/mesh_steps.py; launch/steps.py's cached_*_step "
               "are the engine's per-shape CUDA-graph caches")

#: (JAX module, name) -> (the port's home "module:name" or None, reason).
RECAST = {
    ("repro.kernels.sc_matmul", "sc_matmul_counts_pallas"): (
        "repro_torch.kernels.sc_matmul:sc_matmul_counts", _PALLAS),
    ("repro.kernels.paged_attention", "paged_attention_pallas"): (
        "repro_torch.kernels.paged_attention:paged_attention", _PALLAS),
    ("repro.kernels.flash_attention", "flash_attention_pallas"): (
        "repro_torch.kernels.flash_attention:flash_attention", _PALLAS),
    ("repro.kernels.sc_bitops", "sc_stream_mul_pallas"): (
        "repro_torch.kernels.sc_bitops:sc_stream_mul_cuda", _PALLAS),
    ("repro.kernels.ops", "sc_matmul_pallas"): (
        "repro_torch.kernels.ops:sc_matmul", _PALLAS),
    ("repro.kernels.ops", "default_interpret"): (
        None, "Pallas interpret mode; a port wrapper takes its plain "
              "version when its tensors lie on the CPU"),
    ("repro.kernels.autotune", "PagedFlashConfig"): (
        "repro_torch.kernels.autotune:PagedConfig",
        "the paged kernel's launch plan, renamed for what it plans"),
    ("repro.analysis.contracts", "iter_eqns"): (None, _ANALYSIS),
    ("repro.analysis.contracts", "half_precision_casts"): (
        "repro_torch.analysis.contracts:half_precision_ops", _ANALYSIS),
    ("repro.analysis.contracts", "contraction_dims"): (None, _ANALYSIS),
    ("repro.analysis.contracts", "audit_einsum_parity"): (
        "repro_torch.analysis.contracts:audit_reduction_parity", _ANALYSIS),
    ("repro.analysis.contracts", "audit_compile_counts"): (
        "repro_torch.analysis.contracts:audit_capture_counts",
        "XLA compile counts; the port counts CUDA graph captures"),
    ("repro.analysis.rules", "TraceSafety"): (
        "repro_torch.analysis.rules:HostSyncSafety",
        "jit trace safety; the port's hazard is a host sync in a captured "
        "step"),
    ("repro.analysis.scopes", "is_jit_callee"): (None, _ANALYSIS),
    ("repro.analysis.scopes", "is_pallas_callee"): (None, _ANALYSIS),
    **{("repro.launch.steps", name): (
        f"repro_torch.launch.mesh_steps:{name}", _MESH_STEPS)
       for name in ("build_train_step", "build_prefill_step",
                    "build_decode_step", "build_paged_decode_step",
                    "build_chunked_prefill_step", "build_draft_loop_step",
                    "build_verify_window_step", "build_rollback_step",
                    "cached_train_step", "cached_paged_decode_step")},
}


ROOT = Path(list(repro.__path__)[0])


def _jax_modules() -> dict[str, tuple]:
    """Every module of the JAX package (``__main__`` aside) with the names
    of its ``__all__`` (empty without one), read from its source."""
    out = {}
    for path in sorted(ROOT.rglob("*.py")):
        parts = ("repro",) + path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__main__":
            continue
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names = ()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.Assign) and any(
                    getattr(t, "id", None) == "__all__"
                    for t in node.targets):
                names = tuple(ast.literal_eval(node.value))
        out[".".join(parts)] = names
    return out


def _twin(name: str) -> str:
    return "repro_torch" + name[len("repro"):]


def _home(target: str):
    module, name = target.split(":")
    return getattr(importlib.import_module(module), name)


JAX_MODULES = _jax_modules()


def test_every_jax_module_has_a_twin_or_a_written_home():
    for name in JAX_MODULES:
        if name in MODULES:
            home, reason = MODULES[name]
            assert reason
            if home is not None:
                importlib.import_module(home)
            with pytest.raises(ModuleNotFoundError):
                importlib.import_module(_twin(name))
        else:
            importlib.import_module(_twin(name))


@pytest.mark.parametrize("name", [n for n in JAX_MODULES if n not in MODULES])
def test_public_names_equal_the_references(name):
    port = importlib.import_module(_twin(name))
    for public in JAX_MODULES[name]:
        entry = RECAST.get((name, public))
        if entry is None:
            assert hasattr(port, public), f"{_twin(name)} lacks {public!r}"
            continue
        home, reason = entry
        assert reason
        assert not hasattr(port, public), \
            f"{_twin(name)} has {public!r}: its RECAST entry is stale"
        if home is not None:
            _home(home)                 # the port's home exists


def test_every_recast_name_is_a_public_name_of_the_reference():
    for name, public in RECAST:
        assert public in JAX_MODULES[name], (name, public)


@pytest.mark.parametrize("bits", [4, 8])
def test_sc_einsum_bd_df_equals_jax(bits):
    from repro.core import sc_layers as jsc_layers
    from repro.core.sc_numerics import recover_counts as jrecover
    from repro_torch.core import sc_layers
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2, 3, 40)).astype(np.float32)
    w = (rng.standard_normal((40, 12)) * 0.2).astype(np.float32)
    j = jsc_layers.sc_einsum_bd_df(jnp.asarray(x), jnp.asarray(w), bits,
                                   "mxu_split")
    t = sc_layers.sc_einsum_bd_df(torch.from_numpy(x), torch.from_numpy(w),
                                  bits, "pallas")
    assert t.shape == (2, 3, 12) and t.dtype == torch.float32
    np.testing.assert_array_equal(
        jrecover(t.reshape(6, 12).numpy(), x.reshape(6, 40), w, bits=bits,
                 row_quant=True),
        jrecover(np.asarray(j).reshape(6, 12), x.reshape(6, 40), w,
                 bits=bits, row_quant=True))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-6)


def test_the_core_package_re_exports_the_references_names():
    import repro_torch.core as core
    assert sorted(core.__all__) == sorted(JAX_MODULES["repro.core"])
    for name in core.__all__:
        assert getattr(core, name) is not None
    from repro_torch.core import mae, sc_dense
    from repro_torch.core.error_analysis import mae as home_mae
    from repro_torch.core.sc_layers import sc_dense as home_sc_dense
    assert (mae, sc_dense) == (home_mae, home_sc_dense)


def test_the_core_package_keeps_the_function_sc_matmul():
    """As in the reference, ``repro_torch.core.sc_matmul`` is the dispatch
    function, also once its submodule of the same name is imported (which
    every model import does)."""
    import importlib
    import repro_torch.core as core
    module = importlib.import_module("repro_torch.core.sc_matmul")
    from repro_torch.core import sc_matmul
    assert sc_matmul is module.sc_matmul is core.sc_matmul
    assert callable(sc_matmul) and module is not sc_matmul
