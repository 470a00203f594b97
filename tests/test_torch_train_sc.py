"""Training under SC-GEMM in the port held against the JAX package's eager
run (``jax.disable_jit()``) on the CPU, at the reduced smollm-360m and
qwen3-moe-235b-a22b (float32, 8 bits): the loss within 1e-5 relative and
each gradient leaf within 1e-4 of its largest magnitude, as for exact
projections in ``test_torch_train.py``. The port follows JAX's eager
arithmetic: jitted SC runs may move a quantization step (``ROADMAP.md``
Queue 3). JAX's eager run compiles each primitive at first use (some 600
compilations, about half a minute a model), hence a file of its own.
"""
import pytest
import torch

from repro_torch.convert import from_jax_params
from test_torch_train import (_batch, _cfgs, _check_family, _jax_params,
                              _np_tree, _port_loss_and_grads)

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-moe-235b-a22b"])
def test_loss_and_grads_equal_jax_eager_under_sc_gemm(arch):
    """Two sequences of 16 tokens (one loss chunk, one router group)."""
    sc = _check_family(arch, sc=True, eager=True, b=2, s=16)
    _, tcfg = _cfgs(arch)
    tp = from_jax_params(_np_tree(_jax_params(arch)), tcfg, device="cpu")
    exact, _ = _port_loss_and_grads(tcfg, tp, _batch(tcfg, b=2, s=16))
    assert sc != exact          # the SC numeric did run
