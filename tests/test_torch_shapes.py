"""The port's assigned input shapes (``repro_torch.configs.shapes``) against
the JAX package's (``repro.configs.shapes``): the shape set, and for every
registered architecture at every shape the SC-GEMM problems a forward
routes through the multiplier (the autotuner's keys) and whether the shape
applies. Pure integers."""
import dataclasses

import pytest

from repro.configs import shapes as jshapes
from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models.moe import moe_capacity as jmoe_capacity
from repro_torch.configs import shapes
from repro_torch.configs.registry import ARCHS


def test_the_shape_set_equals_the_jax_packages():
    assert {n: dataclasses.astuple(s) for n, s in shapes.SHAPES.items()} == \
        {n: dataclasses.astuple(s) for n, s in jshapes.SHAPES.items()}


@pytest.mark.parametrize("shape", sorted(jshapes.SHAPES))
@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_problems_and_applicability_equal_the_jax_packages(arch, shape):
    cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
    s, js = shapes.SHAPES[shape], jshapes.SHAPES[shape]
    assert shapes.sc_gemm_problems(cfg, s) == jshapes.sc_gemm_problems(jcfg,
                                                                       js)
    assert shapes.is_applicable(cfg, s) == jshapes.is_applicable(jcfg, js)


@pytest.mark.parametrize("arch", sorted(a for a, c in JAX_ARCHS.items()
                                        if c.n_experts))
def test_moe_capacity_equals_the_jax_packages(arch):
    for cfg, jcfg in ((ARCHS[arch], JAX_ARCHS[arch]),
                      (ARCHS[arch].reduced(), JAX_ARCHS[arch].reduced())):
        assert shapes.moe_capacity(cfg) == jmoe_capacity(jcfg)
