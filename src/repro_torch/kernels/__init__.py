"""Hand-written CUDA kernels of the port, their ctypes wrappers and plain
PyTorch versions: SC-GEMM counts (``sc_matmul``), paged decode attention
(``paged_attention``), causal flash attention (``flash_attention``), the
last two with SC variants whose helpers are shared (``sc_attention``), and
the paper's bit-parallel stream multiplier (``sc_bitops``). ``ops`` holds
the public entries, ``ref`` the plain oracles. Sources live in ``csrc/``;
``build`` compiles them with nvcc at first use."""
