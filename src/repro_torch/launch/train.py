"""Training entry point of the port: data pipeline → train step →
checkpoint and restart (port of ``repro/launch/train.py``).

Runs on the card unless ``device="cpu"`` (``--device cpu``) is given.
Fault tolerance is the reference's: a deterministic pipeline, async
commit-ordered checkpoints and the supervisor's restore-on-start, so a
second run on the same ``ckpt_dir`` resumes from the first run's save.
As in the reference, ``supervisor.on_step`` marks a step before
``should_checkpoint`` asks about it, so ``ckpt_every`` never fires and the
only save is the blocking one at the end.

The step (:func:`train_step`) is functional: the loss and the gradient of
every leaf of the parameter tree by ``torch.autograd.grad``, then
``warmup_cosine`` and AdamW. Under ``--sc-gemm`` every projection's
forward is the SC-GEMM kernel on the card, its weight packed for the call
(the weights change every step), and its backward the exact matmul
(straight-through); the attention sites run the flash kernel forward and
recompute through its plain version backward. The step is deterministic
on the card as it is (the embedding's backward, an accumulating
``index_put_``, sorts its indices there), so a step from a restored state
equals the step from the state in memory bit for bit.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --sc-gemm --steps 50 --batch 8 --seq 128 --ckpt-dir build/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --reduced --device cpu --steps 20 --batch 2 --seq 32
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import tree as tr
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.registry import ARCHS
from repro_torch.core.sc_matmul import SC_IMPLS
from repro_torch.data import PipelineConfig, TokenPipeline
from repro_torch.errors import ConfigError
from repro_torch.launch import apply_numeric_overrides
from repro_torch.models import bind
from repro_torch.optim import AdamWConfig, apply_updates
from repro_torch.optim import init as opt_init
from repro_torch.optim.grad_compression import (compress_with_feedback,
                                                init_error_state)
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.runtime import (SupervisorConfig, TrainingSupervisor,
                                 device_chips)

__all__ = ["train", "train_step", "value_and_grad", "main"]


def _refuse_packed(params) -> None:
    """Packed SC-GEMM weights are copies of the float weights that an
    update leaves stale: a tree that carries them is not trained."""
    if isinstance(params, dict):
        if "packed" in params:
            raise ConfigError("the parameter tree carries packed SC-GEMM "
                              "weights, which an update would leave stale: "
                              "train the float tree")
        for v in params.values():
            _refuse_packed(v)
    elif isinstance(params, (list, tuple)):
        for v in params:
            _refuse_packed(v)


def value_and_grad(model, params, batch: dict):
    """``(loss, grads)`` of ``model.loss_fn`` at ``params``: the gradient
    of every leaf by ``torch.autograd.grad``, in the leaf's dtype (zeros
    for a leaf the loss does not reach)."""
    flat, structure = tr.flatten(params)
    leaves = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        loss = model.loss_fn(tr.unflatten(structure, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tr.unflatten(structure, grads)


def train_step(model, params, opt_state: dict, batch: dict, *,
               lr_peak: float, steps: int, optc: AdamWConfig):
    """One step: loss and gradients, the learning rate of
    ``warmup_cosine`` at ``opt_state["step"]`` (warm-up over a twentieth
    of ``steps``), AdamW (``optim.apply_updates``, with the reference's
    weight decay). Returns ``(params, opt_state, loss, grads)``."""
    _refuse_packed(params)
    loss, grads = value_and_grad(model, params, batch)
    params, opt_state = _update(params, grads, opt_state, optc, lr_peak,
                                steps)
    return params, opt_state, loss, grads


def _update(params, grads, opt_state, optc, lr_peak, steps):
    lrate = warmup_cosine(opt_state["step"], peak_lr=lr_peak,
                          warmup_steps=max(steps // 20, 1), total_steps=steps)
    return apply_updates(params, grads, opt_state, optc, lrate)


def train(cfg, *, steps: int, batch: int, seq: int, ckpt_dir: str | None,
          lr: float = 3e-4, ckpt_every: int = 20, compress_grads: bool = False,
          log_every: int = 10, seed: int = 0,
          device: str | torch.device | None = None) -> dict:
    """Train ``cfg`` from random weights of ``seed`` (or from the latest
    committed checkpoint in ``ckpt_dir``) up to ``steps``; returns
    ``{"losses", "final_loss", "params"}``."""
    m = bind(cfg, device)
    optc = AdamWConfig(quantize_moments=cfg.n_experts >= 64)
    pipe = TokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        n_codebooks=cfg.n_codebooks, seed=seed))

    params = m.init_params(seed)
    _refuse_packed(params)
    opt_state = opt_init(params, optc)
    err_state = None
    start_step = 0

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    supervisor = TrainingSupervisor(
        SupervisorConfig(checkpoint_every=ckpt_every),
        n_chips=device_chips(m.device), model_parallelism=1)
    if ckpt and ckpt.latest_step() is not None:
        start_step = ckpt.latest_step()
        state = ckpt.restore(start_step,
                             like={"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        print(f"[train] restored step {start_step} from {ckpt_dir}")

    losses = []
    t0 = time.time()
    for step in range(start_step, steps):
        arrays = {k: torch.as_tensor(v, device=m.device)
                  for k, v in pipe.get_batch(step).items()}
        if compress_grads:
            # the compression numerics on the gradient path (EF-int8)
            loss, grads = value_and_grad(m, params, arrays)
            if err_state is None:
                err_state = init_error_state(grads)
            grads, err_state = compress_with_feedback(grads, err_state)
            params, opt_state = _update(params, grads, opt_state, optc, lr,
                                        steps)
        else:
            params, opt_state, loss, _ = train_step(
                m, params, opt_state, arrays, lr_peak=lr, steps=steps,
                optc=optc)
        losses.append(float(loss))
        supervisor.on_step(step)
        if ckpt and supervisor.should_checkpoint(step) and step > start_step:
            ckpt.save(step, {"params": params, "opt": opt_state})
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step:5d} loss {float(loss):.4f} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
    if ckpt:
        ckpt.save(steps, {"params": params, "opt": opt_state}, blocking=True)
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "params": params}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--sc-gemm", action="store_true",
                    help="run dense projections through the SC-GEMM numeric "
                         "(STE training)")
    ap.add_argument("--sc-impl", choices=SC_IMPLS, default=None,
                    help="SC-GEMM kernel (overrides the config's sc_impl; "
                         "'auto' = $REPRO_SC_IMPL, then the device's choice)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced(dtype="float32")
    cfg = apply_numeric_overrides(cfg, sc_gemm=args.sc_gemm,
                                  sc_impl=args.sc_impl)
    out = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                ckpt_dir=args.ckpt_dir, lr=args.lr,
                compress_grads=args.compress_grads, device=args.device)
    print(f"[train] done; final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
