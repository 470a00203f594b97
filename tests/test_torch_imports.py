"""The PyTorch port's package boundary: it imports neither JAX nor the JAX
package, its entry points default to the card and refuse to fall back to
the CPU silently, and its configs describe the same architectures as the
JAX package's."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro_torch.configs.registry import ARCHS
from repro_torch.errors import ConfigError

# several pytest workers share the machine: a few threads each
torch.set_num_threads(2)

SRC = Path(__file__).resolve().parents[1] / "src"

PORT_MODULES = [
    "repro_torch", "repro_torch.errors", "repro_torch.device",
    "repro_torch.convert",
    "repro_torch.configs.base", "repro_torch.configs.registry",
    "repro_torch.configs.shapes",
    "repro_torch.core.tcu", "repro_torch.core.sc_numerics",
    "repro_torch.core.sc_matmul", "repro_torch.core.sc_layers",
    "repro_torch.core.multipliers", "repro_torch.core.error_analysis",
    "repro_torch.core.hardware_model",
    "repro_torch.kernels.build", "repro_torch.kernels.sc_matmul",
    "repro_torch.kernels.autotune",
    "repro_torch.kernels.sc_bitops",
    "repro_torch.kernels.ops", "repro_torch.kernels.ref",
    "repro_torch.kernels.paged_attention", "repro_torch.kernels.sc_attention",
    "repro_torch.kernels.flash_attention", "repro_torch.models",
    "repro_torch.models.layers", "repro_torch.models.transformer",
    "repro_torch.models.mamba2", "repro_torch.models.ssm_lm",
    "repro_torch.models.zamba2",
    "repro_torch.models.cache_ops", "repro_torch.models.model_zoo",
    "repro_torch.serving", "repro_torch.serving.queue",
    "repro_torch.serving.prefix",
    "repro_torch.serving.slots", "repro_torch.serving.engine",
    "repro_torch.launch.steps", "repro_torch.launch.serve",
    "repro_torch.launch.paper", "repro_torch.launch.train",
    "repro_torch.launch.mesh", "repro_torch.launch.modelmeta",
    "repro_torch.launch.mesh_steps", "repro_torch.launch.cost_analysis",
    "repro_torch.launch.dryrun", "repro_torch.parallel.kernel_sharding",
    "repro_torch.parallel", "repro_torch.parallel.sharding",
    "repro_torch.parallel.context", "repro_torch.parallel.pipeline_parallel",
    "repro_torch.tree", "repro_torch.optim", "repro_torch.optim.adamw",
    "repro_torch.optim.schedules", "repro_torch.optim.grad_compression",
    "repro_torch.data", "repro_torch.data.pipeline",
    "repro_torch.data.tokenizer", "repro_torch.checkpoint",
    "repro_torch.checkpoint.checkpointer", "repro_torch.runtime",
    "repro_torch.runtime.fault_tolerance", "repro_torch.analysis",
    "repro_torch.analysis.base", "repro_torch.analysis.scopes",
    "repro_torch.analysis.rules", "repro_torch.analysis.contracts",
    "repro_torch.analysis.cli", "repro_torch.examples",
    "repro_torch.examples.quickstart",
    "repro_torch.examples.sc_gemm_inference",
    "repro_torch.examples.serve_lm", "repro_torch.examples.train_lm",
]


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    src = (SRC.parent / "chip_smoke.py").read_text()
    assert "import jax" not in src and "from jax" not in src
    assert "from repro." not in src and "import repro\n" not in src


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_the_card(monkeypatch):
    """Without CUDA, every entry point that defaults to the card raises a
    typed ConfigError at once; asking for the CPU runs."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import bind
    from repro_torch.models.transformer import init_kv_cache, init_params
    from repro_torch.serving import Engine, Request
    _no_cuda(monkeypatch)
    cfg = ARCHS["smollm-360m"].reduced(dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(ConfigError, match="CUDA"):
        Engine(cfg, params)
    with pytest.raises(ConfigError, match="CUDA"):
        bind(cfg)
    with pytest.raises(ConfigError, match="CUDA"):
        init_params(cfg, 0)
    with pytest.raises(ConfigError, match="CUDA"):
        init_kv_cache(cfg, 1, 8)
    with pytest.raises(ConfigError, match="CUDA"):
        generate(cfg, params, torch.zeros((1, 4), dtype=torch.int32),
                 gen_tokens=1)
    engine = Engine(cfg, params, device="cpu", capacity=1, max_seq=16)
    out = engine.run([Request(uid="a", prompt=[1, 2, 3], max_new_tokens=2)])
    assert out[0].n_generated == 2 and engine.stats["device"] == "cpu"


def test_serve_cli_defaults_to_the_card(monkeypatch):
    from repro_torch.launch.serve import main
    _no_cuda(monkeypatch)
    with pytest.raises(ConfigError, match="CUDA"):
        main(["--arch", "smollm-360m", "--reduced"])


def test_serve_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "smollm-360m", "--reduced", "--device", "cpu",
          "--sc-gemm", "--requests", "3", "--prompt-len", "8", "--gen", "4",
          "--capacity", "2", "--block", "4"])
    out = capsys.readouterr().out
    assert "[serve] cpu continuous/paged/chunked: 3 requests" in out


@pytest.mark.parametrize("mode", ["chunked", "oneshot"])
def test_serve_cli_module_serves_sc_attention_on_the_cpu(mode):
    """``python -m repro_torch.launch.serve`` with SC-GEMM and SC attention,
    as a user runs it."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "smollm-360m", "--reduced", "--sc-gemm", "--attn-sc", "--device",
         "cpu", "--requests", "3", "--prompt-len", "8", "--gen", "4",
         "--capacity", "2", "--block", "4", "--prefill-mode", mode],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"[serve] cpu continuous/paged/{mode}: 3 requests" in proc.stdout
    assert "attention SC 8-bit" in proc.stdout


def test_serve_cli_refuses_out_of_range_attention_bits():
    from repro_torch.launch.serve import main
    with pytest.raises(ConfigError, match="2..8"):
        main(["--arch", "smollm-360m", "--reduced", "--device", "cpu",
              "--attn-sc-bits", "9"])


def test_later_slices_are_refused():
    """No slice is refused any more: SC attention, speculation and the
    prefix cache (on by default) are served (on the CPU here), and so are
    the ssm and hybrid families, without speculation, the vlm and audio
    families (audio without speculation, on ``(S, K)`` prompts) and the
    moe family, which binds, serves and speculates with its prefix cache
    off, as in the reference."""
    import numpy as np
    from repro_torch.models import bind
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import Engine, Request
    cfg = ARCHS["smollm-360m"].reduced(dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    shared = Engine(cfg, params, device="cpu", capacity=2, max_seq=24,
                    block=4, chunk=4)
    assert shared.prefix is not None
    prompt = np.arange(1, 11, dtype=np.int32)
    out = shared.run([Request(uid=f"p{i}", prompt=prompt, max_new_tokens=2)
                      for i in range(2)])
    assert [r.n_generated for r in out] == [2, 2]
    assert shared.stats["prefix_hits"] == 1
    spec = Engine(cfg, params, device="cpu", speculate_k=2, capacity=1,
                  max_seq=16)
    out = spec.run([Request(uid="s", prompt=[1, 2, 3], max_new_tokens=3)])
    assert out[0].n_generated == 3 and spec.stats["spec_rounds"] >= 1
    with pytest.raises(ConfigError, match="speculative"):
        Engine(cfg, params, device="cpu", speculate_k=2, paged=False)
    sc = Engine(dataclasses.replace(cfg, attn_sc=True), params, device="cpu",
                capacity=1, max_seq=16)
    out = sc.run([Request(uid="a", prompt=[1, 2, 3], max_new_tokens=2)])
    assert out[0].n_generated == 2 and sc.stats["attn_sc_bits"] == 8
    for arch in ("mamba2-130m", "zamba2-7b"):
        fam = ARCHS[arch].reduced(dtype="float32")
        fam_params = bind(fam, "cpu").init_params(0)
        with pytest.raises(ConfigError, match="speculative"):
            Engine(fam, fam_params, device="cpu", speculate_k=2)
        out = Engine(fam, fam_params, device="cpu", capacity=1, max_seq=24,
                     block=4).run([Request(uid="f", prompt=[1, 2, 3],
                                           max_new_tokens=2)])
        assert out[0].n_generated == 2
    for arch in ("qwen2-vl-2b", "musicgen-large"):
        fam = ARCHS[arch].reduced(dtype="float32")
        fam_params = bind(fam, "cpu").init_params(0)
        k = fam.n_codebooks
        prompt = np.arange(1, 7, dtype=np.int32)
        if k:
            prompt = np.stack([prompt] * k, axis=-1)
            with pytest.raises(ConfigError, match="speculative"):
                Engine(fam, fam_params, device="cpu", speculate_k=2)
        out = Engine(fam, fam_params, device="cpu", capacity=1, max_seq=24,
                     block=4).run([Request(uid="v", prompt=prompt,
                                           max_new_tokens=2)])
        assert out[0].n_generated == 2
        assert out[0].tokens.shape == ((2, k) if k else (2,))
    for arch in ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"):
        fam = ARCHS[arch].reduced(dtype="float32")
        fam_params = bind(fam, "cpu").init_params(0)
        eng = Engine(fam, fam_params, device="cpu", capacity=1, max_seq=24,
                     block=4)
        assert eng.prefix is None
        out = eng.run([Request(uid="m", prompt=[1, 2, 3], max_new_tokens=2)])
        assert out[0].n_generated == 2 and not eng.stats["prefix_cache"]
    spec = Engine(fam, fam_params, device="cpu", speculate_k=1, capacity=1,
                  max_seq=16, block=4)
    out = spec.run([Request(uid="s", prompt=[1, 2, 3], max_new_tokens=3)])
    assert out[0].n_generated == 3 and spec.stats["spec_rounds"] >= 1


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_configs_match_the_jax_package(arch):
    """Same fields, same values, same reduced() rule, same derived
    properties for every registered architecture."""
    ours, theirs = ARCHS[arch], JAX_ARCHS[arch]
    fields = [f.name for f in dataclasses.fields(ours)]
    assert fields == [f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert (dataclasses.asdict(ours.reduced(dtype="float32"))
            == dataclasses.asdict(theirs.reduced(dtype="float32")))
    assert ours.group_size == theirs.group_size


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_refuses_without_a_card_or_the_port(tmp_path, alone):
    """Without CUDA (here), and in a directory that holds nothing of the
    repository, chip_smoke.py exits non-zero and prints no result line."""
    script = SRC.parent / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, cwd=tmp_path, timeout=120,
                          env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
