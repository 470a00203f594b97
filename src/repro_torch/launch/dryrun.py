"""Multi-pod dry run (port of ``repro/launch/dryrun.py``): every
(architecture x input shape) traced on the production meshes as rank 0
of a 256-rank (16 x 16) or 512-rank (2 x 16 x 16) mesh, proving the
distribution config is coherent without the hardware, and recording per
rank: memory (argument, output, alias and temp bytes), FLOPs, SC
operations, HBM bytes, collective bytes by kind and the roofline
(``launch/cost_analysis.py``).

The reference lowers and compiles each step. The port has no compiler:
it starts PyTorch's single-process ``fake`` process group at the mesh's
world size (rank 0), builds the mesh through ``launch/mesh.py``, places
the step's inputs as ``DTensor``s over fake local shards (nothing is
allocated) and runs the mesh-bound step (``launch/mesh_steps.py``)
under ``cost_analysis.count_step``. The kernels run as their custom
operators' fake implementations; attention always takes the kernels'
routes (``attn_kernel`` and ``paged_attn_kernel`` "pallas_tuned"), so a
trace on the CPU is the card's program. Fake tensors sit on the card's
device type when a card is present, else on the CPU (``--device``
chooses); either way nothing runs on a device.

A failing cell is recorded (``status: "error"``) and the run goes on;
the exit code is then non-zero. Records go to
``experiments/dryrun_torch/<arch>__<shape>__<single|multi>.json``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch import tree as tr
from repro_torch.configs.registry import ARCHS
from repro_torch.configs.shapes import (SHAPES, cache_specs, input_specs,
                                        is_applicable)
from repro_torch.core.sc_matmul import SC_IMPLS
from repro_torch.errors import ConfigError
from repro_torch.launch import numeric_overrides
from repro_torch.launch import mesh_steps as ms
from repro_torch.launch.cost_analysis import (count_step, fake_mode,
                                              roofline_terms)
from repro_torch.launch.mesh import make_production_mesh, production_mesh
from repro_torch.launch.modelmeta import model_flops, param_counts

__all__ = ["run_cell", "main", "OUT_DIR", "place_fake", "trace_step"]

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
#: the dry run's kernel routes: the card's program on any device
KERNEL_ROUTES = {"attn_kernel": "pallas_tuned",
                 "paged_attn_kernel": "pallas_tuned"}


def _device_type(device: str | None) -> str:
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    if device not in ("cuda", "cpu"):
        raise ConfigError(f"the dry run's fake tensors sit on 'cuda' or "
                          f"'cpu', got {device!r}")
    return device


def _fake_group(world: int) -> None:
    """The ``fake`` process group at ``world`` ranks, this process rank 0
    (one already up at another world size is replaced; a real group is
    refused)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise ConfigError("the dry run starts its own fake process "
                              "group; a real one is up in this process")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())


def place_fake(tree, shardings, device_type: str):
    """``tree`` (tensors on ``meta``) as ``DTensor``s over fake local
    shards of this rank's shapes, placed by ``shardings`` (a tree of
    ``NamedSharding``s, or one for every leaf). Call inside the fake
    mode."""
    from torch.distributed.tensor import DTensor, Shard

    def one(t, s):
        local = list(t.shape)
        sizes = dict(zip(s.mesh.mesh_dim_names, s.mesh.shape))
        for axis, p in zip(sizes, s.placements):
            if isinstance(p, Shard):
                local[p.dim] = -(-local[p.dim] // sizes[axis])
        data = torch.empty(local, dtype=t.dtype, device=device_type)
        return DTensor.from_local(data, s.mesh, s.placements,
                                  shape=t.shape, stride=t.stride())

    if not isinstance(shardings, (dict, list, tuple)):
        return tr.tree_map(lambda t: one(t, shardings), tree)
    return tr.tree_map(one, tree, shardings)


def _step_args(cfg, shape, mesh):
    """(step, the abstract inputs, their shardings) of ``shape``'s kind."""
    from repro_torch.optim import init as opt_init
    batch = input_specs(cfg, shape)
    if shape.kind == "train":
        step, sh, (params, _), optc = ms.build_train_step(cfg, mesh)
        opt = opt_init(params, optc)
        return step, (params, opt, batch), (sh["params"], sh["opt"],
                                            sh["batch_fn"](batch))
    if shape.kind == "prefill":
        step, sh, params = ms.build_prefill_step(
            cfg, mesh, batch_size=shape.global_batch, seq_len=shape.seq_len)
        return step, (params, batch), (sh["params"], sh["batch_fn"](batch))
    step, sh, params = ms.build_decode_step(
        cfg, mesh, batch_size=shape.global_batch, seq_len=shape.seq_len)
    return step, (params, cache_specs(cfg, shape), batch), (
        sh["params"], sh["cache"], sh["batch_fn"](batch))


def trace_step(step, abstract, shardings, device_type: str):
    """Place ``abstract`` (meta trees) by ``shardings`` over fake shards
    and count rank 0's run of ``step`` on them; the
    ``cost_analysis.StepCount``."""
    mode = fake_mode()
    with mode:
        args = [place_fake(a, s, device_type)
                for a, s in zip(abstract, shardings)]
    _, counted = count_step(step, *args, mode=mode)
    return counted


def _record_base(arch, shape_name, multi_pod, shape, overrides):
    return {"arch": arch, "shape": shape_name,
            "mesh": "pod2x16x16" if multi_pod else "pod16x16",
            "kind": shape.kind, "status": "skipped",
            "overrides": overrides or {}}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides: dict | None = None, *,
             device: str | None = None) -> dict:
    """One cell's record. ``overrides``: ``dataclasses.replace`` fields of
    the config, validated as train and serve validate them."""
    cfg = ARCHS[arch]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides).validate()
    shape = SHAPES[shape_name]
    record = _record_base(arch, shape_name, multi_pod, shape, overrides)
    ok, reason = is_applicable(cfg, shape)
    if not ok:
        record["reason"] = reason
        return record
    cfg = dataclasses.replace(cfg, **KERNEL_ROUTES).validate()
    dev = _device_type(device)
    want = production_mesh(multi_pod=multi_pod)
    _fake_group(want.size)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev)
    t0 = time.time()
    step, abstract, shardings = _step_args(cfg, shape, mesh)
    counted = trace_step(step, abstract, shardings, dev)
    trace_s = time.time() - t0
    mf = model_flops(cfg, shape)
    rl = roofline_terms(counted.stats, n_chips=want.size, model_flops=mf,
                        mesh_shape=want.shape)
    record.update({
        "status": "ok",
        "reason": "",
        "n_chips": want.size,
        "device": dev,
        "trace_s": round(trace_s, 1),
        "ops": counted.ops,
        "memory": counted.memory(),
        "param_counts": param_counts(cfg),
        "model_flops": mf,
        "roofline": rl.to_dict(),
        "collectives_by_kind": {k: float(v) for k, v in
                                counted.stats.by_kind.items()},
    })
    return record


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--sc-gemm", action="store_true",
                    help="trace with SC-GEMM dense projections")
    ap.add_argument("--sc-impl", choices=SC_IMPLS, default=None,
                    help="SC-GEMM kernel (overrides the config's sc_impl)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where the fake tensors sit (default: the card "
                         "when present, else the CPU)")
    args = ap.parse_args(argv)
    overrides = numeric_overrides(sc_gemm=args.sc_gemm, sc_impl=args.sc_impl)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = sorted(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = (sorted(SHAPES) if (args.all or args.shape is None)
              else [args.shape])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                tag = f"{arch}__{shape}__{'multi' if multi else 'single'}"
                try:
                    rec = run_cell(arch, shape, multi,
                                   overrides=overrides or None,
                                   device=args.device)
                except Exception as e:  # noqa: BLE001 - record, go on
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "pod2x16x16" if multi else "pod16x16",
                           "status": "error", "reason": f"{type(e).__name__}",
                           "error": f"{type(e).__name__}: {e}"[:2000],
                           "traceback": traceback.format_exc()[-2000:]}
                    failures += 1
                (out_dir / f"{tag}.json").write_text(json.dumps(rec,
                                                                indent=1))
                extra = ""
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    extra = (f" dominant={r['dominant']}"
                             f" compute={r['compute_s']:.3e}s"
                             f" mem={r['memory_s']:.3e}s"
                             f" coll={r['collective_s']:.3e}s"
                             f" trace={rec['trace_s']}s")
                elif rec["status"] == "error":
                    extra = " " + rec["error"][:120]
                print(f"[dryrun] {tag}: {rec['status']}{extra}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
