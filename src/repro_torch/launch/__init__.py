"""Entry points of the port: the eager serving steps, the serve CLI
(``serve``), the train entry point (``train``) and the paper's Table II /
Fig. 1(b) (``paper``); and the numeric flags they share."""
from __future__ import annotations

__all__ = ["apply_numeric_overrides", "numeric_overrides"]


def numeric_overrides(*, sc_gemm: bool = False,
                      sc_impl: str | None = None) -> dict:
    """``--sc-gemm``/``--sc-impl`` flags → ModelConfig override fields."""
    overrides = {}
    if sc_gemm:
        overrides["use_sc_gemm"] = True
    if sc_impl is not None:
        overrides["sc_impl"] = sc_impl
    return overrides


def apply_numeric_overrides(cfg, *, sc_gemm: bool = False,
                            sc_impl: str | None = None):
    """``cfg`` with the SC-numeric fields of the shared ``--sc-gemm``/
    ``--sc-impl`` flags replaced and re-validated, so an invalid
    combination fails alike in train and serve."""
    import dataclasses
    overrides = numeric_overrides(sc_gemm=sc_gemm, sc_impl=sc_impl)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides).validate()
    return cfg
