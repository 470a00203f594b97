"""Quickstart: the paper's multiplier end to end (port of the reference's
``examples/quickstart.py``).

1. Reproduces Table I bit for bit through the B-to-TCU decoder, the
   correlation encoder and the AND array.
2. Shows the exact integer closed form against the exhaustive grid.
3. Multiplies two matrices with SC-GEMM and compares against float32.
4. Prints the reproduced Table II.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Runs on the card unless ``--device cpu`` is given. ``main`` returns what
it prints: Table I's rows, the MAE, the cosine and Table II's rows.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import (correlation_encode, proposed_closed_form,
                              sc_matmul, tcu_decode)
from repro_torch.core.error_analysis import mae
from repro_torch.core.hardware_model import table2
from repro_torch.device import resolve_device

__all__ = ["TABLE1_PAIRS", "bits_to_str", "table1_row", "sc_gemm_operands",
           "cosine", "main"]

#: Table I's operand pairs at B = 3
TABLE1_PAIRS = ((4, 6), (5, 3), (3, 4))


def bits_to_str(stream: torch.Tensor) -> str:
    """A stream as the paper writes it: the last position first."""
    return "".join(str(int(b)) for b in stream.cpu().flip(-1))


def table1_row(x: int, y: int, device: torch.device) -> dict:
    """One row of Table I (B = 3): both streams, their AND, its popcount
    and the closed form's count."""
    xu = tcu_decode(torch.tensor(x, dtype=torch.int32, device=device),
                    bits=3)
    yu = correlation_encode(torch.tensor(y, dtype=torch.int32,
                                         device=device), bits=3)
    ou = xu & yu
    closed = proposed_closed_form(torch.tensor(x, device=device),
                                  torch.tensor(y, device=device), bits=3)
    return {"x": x, "y": y, "x_u": bits_to_str(xu), "y_u": bits_to_str(yu),
            "o_u": bits_to_str(ou), "popcount": int(ou.sum()),
            "closed_form": int(closed)}


def sc_gemm_operands(device: torch.device) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The (64 x 256) and (256 x 64) float32 normals of section 3."""
    a = torch.randn((64, 256), generator=torch.Generator().manual_seed(0))
    b = torch.randn((256, 64), generator=torch.Generator().manual_seed(1))
    return a.to(device), b.to(device)


def cosine(approx: torch.Tensor, exact: torch.Tensor) -> float:
    """The cosine similarity of two tensors, flattened."""
    return float(torch.vdot(approx.reshape(-1), exact.reshape(-1))
                 / (torch.linalg.norm(approx) * torch.linalg.norm(exact)))


def _rule(title: str) -> None:
    print("=" * 70)
    print(title)
    print("=" * 70)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, 'cuda')")
    dev = resolve_device(ap.parse_args(argv).device)

    _rule("1. Paper Table I, bit-for-bit (B = 3, N = 8)")
    rows = [table1_row(x, y, dev) for x, y in TABLE1_PAIRS]
    for r in rows:
        x, y, o = r["x"], r["y"], r["closed_form"]
        print(f"  X={x} -> X_u={r['x_u']}   Y={y} -> Y_u={r['y_u']}"
              f"   O_u={r['o_u']} (popcount {r['popcount']},"
              f" closed form {o}, target {x * y / 64:.3f}, got {o / 8:.3f})")

    print()
    _rule("2. Exact closed form == bit-level construction (exhaustive, B = 8)")
    err = mae("proposed", 8, device=dev)
    print(f"  MAE over all 65536 operand pairs: {err:.4f}  (paper: 0.04)")

    print()
    _rule("3. SC-GEMM: the multiplier as a GEMM numeric")
    a, b = sc_gemm_operands(dev)
    cos = cosine(sc_matmul(a, b, bits=8, impl="mxu_split"), a @ b)
    print(f"  (64x256) @ (256x64): cosine similarity vs fp32 GEMM = "
          f"{cos:.4f}")

    print()
    _rule("4. Reproduced Table II")
    print(f"  {'unit':10s} {'A(um2)':>9s} {'L(ns)':>10s} {'ExL(pJ.s)':>11s} "
          f"{'MAE':>6s}")
    t2 = {}
    for name, rep in table2().items():
        t2[name] = {"area_um2": rep.area_um2, "latency_ns": rep.latency_ns,
                    "exl_pj_s": rep.exl_pj_s,
                    "mae": mae(name, 8, device=dev)}
        print(f"  {name:10s} {rep.area_um2:9.1f} {rep.latency_ns:10.2f} "
              f"{rep.exl_pj_s:11.2e} {t2[name]['mae']:6.4f}")
    print("  (paper values: see core/hardware_model.PAPER_TABLE2)")
    return {"device": str(dev), "table1": rows, "mae": err, "cosine": cos,
            "table2": t2}


if __name__ == "__main__":
    main()
