"""The paper's own evaluation through the port: Table II (area, latency,
energy-latency, A×E×L and MAE of the four multipliers, model vs paper, and
the headline improvement factors) and Fig. 1(b) (mean absolute error per
normalized operand difference), as ``name,us_per_call,derived`` CSV
(port of ``benchmarks/table2.py``, ``benchmarks/fig1b.py`` and their
printing in ``benchmarks/run.py``).

    PYTHONPATH=src python -m repro_torch.launch.paper [--only table2,fig1b] \\
        [--device cpu]

Runs on the card unless ``--device cpu`` is given: the exhaustive operand
grids live on the chosen device and every multiplier's sweep runs there.
Row names and ``derived`` strings are the JAX benchmarks' own;
``us_per_call`` of a ``table2/<multiplier>`` row times one exhaustive
65,536-pair MAE sweep on the chosen device, synchronized before the clock
stops (the other rows carry 0.0, as there).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.error_analysis import (error_vs_operand_difference, mae,
                                             table2_mae)
from repro_torch.core.hardware_model import (PAPER_TABLE2, improvement_factors,
                                             table2)
from repro_torch.device import resolve_device

__all__ = ["table2_rows", "fig1b_rows", "SUITES", "main"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def table2_rows(device: str | torch.device | None = None) -> list[dict]:
    """Table II: one row per multiplier, then the A×E×L and MAE claims."""
    dev = resolve_device(device)
    rows = []
    hw = table2(bits=8)
    maes = table2_mae(bits=8, device=dev)
    for name in ("umul", "gaines", "jenson", "proposed"):
        r = hw[name]
        p = PAPER_TABLE2[name]
        _sync(dev)
        t0 = time.perf_counter()
        _ = mae(name, bits=8, device=dev)   # exhaustive 65536-pair sweep
        _sync(dev)
        us = (time.perf_counter() - t0) * 1e6
        rows.append({
            "name": f"table2/{name}",
            "us_per_call": round(us, 1),
            "derived": (
                f"A={r.area_um2:.1f}um2(paper {p['area_um2']})"
                f" L={r.latency_ns:g}ns(paper {p['latency_ns']:g})"
                f" ExL={r.exl_pj_s:.2e}(paper {p['exl_pj_s']:.1e})"
                f" AEL={r.axexl_paper_units:.2e}(paper {p['axexl']:.1e})"
                f" MAE={maes[name]:.4f}(paper {p['mae']})"),
        })
    f = improvement_factors()
    rows.append({
        "name": "table2/improvement_vs_umul",
        "us_per_call": 0.0,
        "derived": f"AxExL {f['umul']:.3g}x better (paper claims 10.6e4)",
    })
    rows.append({
        "name": "table2/mae_improvement",
        "us_per_call": 0.0,
        "derived": (
            f"proposed MAE {maes['proposed']:.4f} vs paper-reported baselines "
            f"umul 0.06 / jenson 0.07 / gaines 0.08 -> "
            f"{(1 - maes['proposed'] / 0.06) * 100:.1f}% / "
            f"{(1 - maes['proposed'] / 0.07) * 100:.1f}% / "
            f"{(1 - maes['proposed'] / 0.08) * 100:.1f}% lower "
            f"(paper: 32.2/42.8/51.8)"),
    })
    return rows


def fig1b_rows(device: str | torch.device | None = None) -> list[dict]:
    """Fig. 1(b): per-multiplier error by operand-difference bin, then the
    paper's claim (the proposed design's error spread is below Gaines')."""
    dev = resolve_device(device)
    rows = []
    spreads = {}
    for name in ("proposed", "umul", "gaines", "jenson"):
        out = error_vs_operand_difference(name, bits=8, n_bins=8, device=dev)
        mean_err = out["mean_abs_error"]
        spreads[name] = float(np.ptp(mean_err))
        bins = " ".join(f"{v:.3f}" for v in mean_err)
        rows.append({
            "name": f"fig1b/{name}",
            "us_per_call": 0.0,
            "derived": f"mean|err| per |x-y|/N bin: [{bins}] "
                       f"spread={spreads[name]:.4f}",
        })
    rows.append({
        "name": "fig1b/claim",
        "us_per_call": 0.0,
        "derived": (
            f"proposed spread {spreads['proposed']:.4f} < gaines "
            f"{spreads['gaines']:.4f} (paper: error less dependent on "
            f"operand difference) -> "
            f"{'CONFIRMED' if spreads['proposed'] < spreads['gaines'] else 'NOT CONFIRMED'}"),
    })
    return rows


#: suite name -> rows(device)
SUITES = {"table2": table2_rows, "fig1b": fig1b_rows}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of " + ",".join(SUITES))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, 'cuda')")
    args = ap.parse_args(argv)
    selected = args.only.split(",") if args.only else list(SUITES)
    unknown = sorted(set(selected) - set(SUITES))
    if unknown:
        ap.error(f"unknown suites {unknown}; choose from {list(SUITES)}")
    dev = resolve_device(args.device)
    print("name,us_per_call,derived")
    for key in selected:
        for row in SUITES[key](dev):
            derived = str(row["derived"]).replace(",", ";")
            print(f"{row['name']},{row['us_per_call']},{derived}", flush=True)


if __name__ == "__main__":
    main()
