"""Core SC numerics of the port: stream lengths and the bit-level TCU /
correlation encoders with stream packing (``tcu``), the paper's multiplier
and its three baselines (``multipliers``), the exhaustive error analysis
and the gate-inventory hardware model behind Table II and Fig. 1(b)
(``error_analysis``, ``hardware_model``), sign-magnitude quantization
(``sc_numerics``), the SC-GEMM reference formulations and dispatch
(``sc_matmul``), and the ``sc_dense`` layer numeric with its
straight-through gradient (``sc_layers``)."""
