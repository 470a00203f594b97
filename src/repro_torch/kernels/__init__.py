"""Hand-written CUDA kernels of the port, their ctypes wrappers and plain
PyTorch versions: SC-GEMM counts (``sc_matmul``) and paged decode attention
(``paged_attention``). Sources live in ``csrc/``; ``build`` compiles them
with nvcc at first use."""
