"""The reference's four examples (``examples/*.py`` of the JAX package) as
entry points of the port:

* ``quickstart``: Table I bit for bit, the exhaustive MAE at B = 8, an
  SC-GEMM product's cosine against float32 and the reproduced Table II;
* ``sc_gemm_inference``: reduced smollm-360m with exact and with SC-GEMM
  projections on the same parameters;
* ``serve_lm``: ``launch.serve.generate`` over a dense, an ssm and a
  hybrid model;
* ``train_lm``: ``launch.train.train`` killed half way and resumed from
  its checkpoint.

Each runs as ``PYTHONPATH=src python -m repro_torch.examples.<name>
[--device cpu]``: on the card unless ``--device cpu`` is given (without a
card it raises :class:`~repro_torch.errors.ConfigError`). Each prints the
reference example's lines and its ``main(argv=None)`` returns the numbers
it printed. Random inputs come from explicit ``torch.Generator``\\ s on the
CPU, seeded 0 and 1 where the reference takes ``PRNGKey(0)`` and
``fold_in(key, 1)`` (or ``PRNGKey(1)``), and are then moved, so a run on
the card and a run on the CPU see the same inputs.
"""
__all__ = ["EXAMPLES"]

#: the example modules, in the reference's order
EXAMPLES = ("quickstart", "sc_gemm_inference", "serve_lm", "train_lm")
