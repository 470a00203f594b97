"""The port's model metadata (``launch/modelmeta.py``) against the JAX
package's: ``param_counts`` (``total``, ``active``, ``embedding``) and
``model_flops`` exactly equal for all ten registered architectures and
every ``SHAPES`` entry, the public size ranges of
``tests/test_launch.py:80-100``, and the counts taken from shapes alone:
the parameter trees are built on the ``meta`` device, so the 235 B and
400 B configs are never allocated."""
import functools

import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.launch import modelmeta as jmeta
from repro_torch.configs.registry import ARCHS
from repro_torch.configs.shapes import SHAPES, Shape
from repro_torch.launch import modelmeta
from repro_torch.launch.modelmeta import model_flops, param_counts
from repro_torch.launch.steps import abstract_opt_state, abstract_params
from repro_torch.optim import AdamWConfig
from repro_torch import tree as tr

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_param_counts_equal_jax(arch):
    got, want = param_counts(ARCHS[arch]), jmeta.param_counts(JAX_ARCHS[arch])
    assert got == want
    assert type(got["active"]) is type(want["active"])


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_model_flops_equal_jax_at_every_shape(arch, monkeypatch):
    # each package counts a config once (the counts are tested above)
    for mod in (modelmeta, jmeta):
        monkeypatch.setattr(mod, "param_counts",
                            functools.lru_cache(mod.param_counts))
    assert sorted(SHAPES) == sorted(JAX_SHAPES)
    for name, shape in SHAPES.items():
        got = model_flops(ARCHS[arch], shape)
        want = jmeta.model_flops(JAX_ARCHS[arch], JAX_SHAPES[name])
        assert got == want, (name, got, want)


def test_param_counts_match_public_sizes():
    """Derived totals are near the models' advertised sizes (the
    reference's own ranges)."""
    expectations = {
        "smollm-360m": (0.30e9, 0.45e9),
        "qwen2-7b": (6.5e9, 8.5e9),
        "gemma2-9b": (8.0e9, 10.5e9),
        "qwen2.5-14b": (13e9, 16e9),
        "qwen3-moe-235b-a22b": (220e9, 250e9),
        "llama4-maverick-400b-a17b": (330e9, 440e9),
        "mamba2-130m": (0.10e9, 0.18e9),
    }
    for arch, (lo, hi) in expectations.items():
        assert lo < param_counts(ARCHS[arch])["total"] < hi, arch
    active = param_counts(ARCHS["qwen3-moe-235b-a22b"])["active"]
    assert 15e9 < active < 30e9        # a22b: ~22 B active


def test_model_flops_conventions():
    cfg = ARCHS["smollm-360m"]
    n = param_counts(cfg)["active"]
    assert model_flops(cfg, Shape("t", 128, 8, "train")) == 6.0 * n * 1024
    assert model_flops(cfg, Shape("p", 128, 8, "prefill")) == 2.0 * n * 1024
    assert model_flops(cfg, Shape("d", 4096, 4, "decode")) == 2.0 * n * 4


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b",
                                  "llama4-maverick-400b-a17b"])
def test_the_largest_configs_are_counted_from_shapes(arch):
    """Every leaf of the trees the counts walk lives on the ``meta``
    device: shapes and dtypes, no storage; the optimizer state too, its
    int8 moments in blocks of 256."""
    cfg = ARCHS[arch]
    params = abstract_params(cfg)
    leaves = tr.leaves(params)
    assert all(t.is_meta for t in leaves)
    assert sum(t.numel() for t in leaves) == param_counts(cfg)["total"]
    opt = abstract_opt_state(cfg, params, AdamWConfig(quantize_moments=True))
    moments = tr.leaves(opt["m"])
    assert all(t.is_meta for t in moments)
    blocks = sum(t.numel() for t in moments if t.dtype == torch.int8)
    assert blocks == sum(-(-t.numel() // 256) * 256 for t in leaves)
