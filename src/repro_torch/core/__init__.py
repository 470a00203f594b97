"""Core SC numerics of the port: stream lengths, sign-magnitude
quantization, the SC-GEMM reference formulations and dispatch, and the
``sc_dense`` layer numeric with its straight-through gradient."""
