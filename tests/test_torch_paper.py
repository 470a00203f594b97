"""The paper's evaluation through the port (``core/error_analysis.py``,
``core/hardware_model.py``, ``launch/paper.py``) against the JAX package's
and its benchmarks, on the CPU: Table II and Fig. 1(b) row for row, letter
for letter."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import fig1b as jax_fig1b
from benchmarks import table2 as jax_table2
from repro.core import error_analysis as jea
from repro.core import hardware_model as jhw
from repro_torch.core import error_analysis as tea
from repro_torch.core import hardware_model as thw
from repro_torch.errors import ConfigError
from repro_torch.launch import paper

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

SRC = Path(__file__).resolve().parents[1] / "src"
ROOT = SRC.parent


@pytest.fixture(scope="module")
def jax_rows():
    return {"table2": jax_table2.run(), "fig1b": jax_fig1b.run()}


@pytest.mark.parametrize("bits", [3, 8])
def test_exhaustive_grid_equals_jax(bits):
    xt, yt = tea.exhaustive_grid(bits, "cpu")
    xj, yj = jea.exhaustive_grid(bits)
    assert xt.dtype == yt.dtype == torch.int32
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


@pytest.mark.parametrize("bits", [6, 8])
def test_table2_mae_equals_jax(bits):
    got = tea.table2_mae(bits, device="cpu")
    want = jea.table2_mae(bits)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                   atol=0, err_msg=name)


def test_table2_mae_values_at_the_paper_width():
    got = tea.table2_mae(8, device="cpu")
    assert abs(got["proposed"] - 0.04030989855527878) < 1e-8
    assert got["jenson"] == 0.0 and got["umul"] == 0.00390625


@pytest.mark.parametrize("name", ["proposed", "gaines", "jenson", "umul"])
@pytest.mark.parametrize("n_bins", [8, 16])
def test_error_vs_operand_difference_equals_jax(name, n_bins):
    got = tea.error_vs_operand_difference(name, bits=8, n_bins=n_bins,
                                          device="cpu")
    want = jea.error_vs_operand_difference(name, bits=8, n_bins=n_bins)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["count"], want["count"])
    np.testing.assert_array_equal(got["bin_centers"], want["bin_centers"])
    for key in ("mean_abs_error", "max_abs_error"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6,
                                   err_msg=key)


def test_mae_takes_a_callable():
    def exact(x, y, bits):
        return (x.to(torch.float32) * y) / float(4 ** bits)
    assert tea.mae(exact, bits=6, device="cpu") == 0.0
    assert jea.mae(lambda x, y, b: (x.astype(jnp.float32) * y) / 4 ** b,
                   bits=6) == 0.0


def test_hardware_model_equals_jax():
    assert thw.PAPER_TABLE2 == jhw.PAPER_TABLE2
    for bits in (6, 8):
        got, want = thw.table2(bits), jhw.table2(bits)
        assert list(got) == list(want)
        for name in want:
            assert dataclasses.asdict(got[name]) == \
                dataclasses.asdict(want[name])
            assert got[name].axexl_paper_units == want[name].axexl_paper_units
            assert got[name].axexl_mm2 == want[name].axexl_mm2
        assert thw.improvement_factors(bits) == jhw.improvement_factors(bits)
    for const in ("GE_AREA", "FF_GE", "T_GATE", "T_CLK", "E_SW",
                  "LAYOUT_OVERHEAD"):
        assert getattr(thw, const) == getattr(jhw, const), const
    for name in jhw.DESIGNS:
        assert (dataclasses.asdict(thw.DESIGNS[name](8))
                == dataclasses.asdict(jhw.DESIGNS[name](8)))


@pytest.mark.parametrize("suite", ["table2", "fig1b"])
def test_paper_rows_equal_the_jax_benchmarks(jax_rows, suite):
    got = paper.SUITES[suite]("cpu")
    want = jax_rows[suite]
    assert [r["name"] for r in got] == [r["name"] for r in want]
    assert [r["derived"] for r in got] == [r["derived"] for r in want]
    for row in got:
        assert row["us_per_call"] > 0 if row["name"] in {
            "table2/umul", "table2/gaines", "table2/jenson",
            "table2/proposed"} else row["us_per_call"] == 0.0


def test_paper_headline_numbers():
    rows = {r["name"]: r["derived"] for r in paper.table2_rows("cpu")
            + paper.fig1b_rows("cpu")}
    assert "MAE=0.0403(paper 0.04)" in rows["table2/proposed"]
    assert "AEL=4.97e-14(paper 4.9e-14)" in rows["table2/proposed"]
    assert rows["table2/improvement_vs_umul"].startswith(
        "AxExL 1.04e+05x better")
    assert "32.8% / 42.4% / 49.6% lower" in rows["table2/mae_improvement"]
    assert rows["fig1b/claim"].startswith(
        "proposed spread 0.0497 < gaines 0.1478")
    assert rows["fig1b/claim"].endswith("CONFIRMED")


def test_paper_cli_prints_the_jax_rows(jax_rows):
    """``python -m repro_torch.launch.paper --device cpu`` as a user runs
    it: the JAX benchmark CLI's CSV, row names and ``derived`` letter for
    letter."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.paper", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    want = [r for suite in ("table2", "fig1b") for r in jax_rows[suite]]
    assert len(lines) == 1 + len(want)
    for line, row in zip(lines[1:], want):
        name, _, derived = line.split(",", 2)
        assert (name, derived) == (row["name"],
                                   row["derived"].replace(",", ";"))


def test_paper_cli_runs_one_suite(capsys):
    paper.main(["--only", "fig1b", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 6 and all(line.startswith(("name,", "fig1b/"))
                                   for line in lines)
    with pytest.raises(SystemExit):
        paper.main(["--only", "roofline", "--device", "cpu"])


def test_paper_defaults_to_the_card(monkeypatch):
    """Without CUDA the entry point and the sweeps refuse at once rather
    than run on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="CUDA"):
        paper.main([])
    with pytest.raises(ConfigError, match="CUDA"):
        tea.table2_mae(8)
    with pytest.raises(ConfigError, match="CUDA"):
        tea.exhaustive_grid(8)
