"""Core SC numerics of the port: stream lengths and the bit-level TCU /
correlation encoders with stream packing (``tcu``), the paper's multiplier
and its three baselines (``multipliers``), the exhaustive error analysis
and the gate-inventory hardware model behind Table II and Fig. 1(b)
(``error_analysis``, ``hardware_model``), sign-magnitude quantization
(``sc_numerics``), the SC-GEMM reference formulations and dispatch
(``sc_matmul``), and the ``sc_dense`` layer numeric with its
straight-through gradient (``sc_layers``).

The package re-exports the names the reference's ``repro.core`` does,
each imported on first use: ``kernels.sc_matmul`` imports this package's
modules, and ``sc_layers`` the kernels, so an eager re-export would close
an import cycle."""
import importlib

_EXPORTS = {
    "tcu": ("correlation_encode", "pack_stream", "popcount_u32",
            "stream_length", "tcu_decode", "unpack_stream"),
    "multipliers": ("MULTIPLIERS", "gaines", "jenson", "proposed_bitlevel",
                    "proposed_closed_form", "umul"),
    "sc_numerics": ("SignMagnitude", "dequantize_sign_magnitude",
                    "quantize_sign_magnitude", "recover_counts"),
    "sc_matmul": ("resolve_impl", "sc_matmul", "sc_matmul_mxu_split",
                  "sc_matmul_reference"),
    "sc_layers": ("sc_dense",),
    "error_analysis": ("error_vs_operand_difference", "mae", "table2_mae"),
}
_HOME = {name: module for module, names in _EXPORTS.items()
         for name in names}

__all__ = [*_HOME, "hardware_model"]


def __getattr__(name: str):
    if name == "hardware_model":
        return importlib.import_module(f"{__name__}.hardware_model")
    if name in _HOME:
        module = importlib.import_module(f"{__name__}.{_HOME[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))

