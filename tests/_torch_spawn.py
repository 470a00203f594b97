"""Run a test case on ``world`` ranks of a ``torch.distributed`` group, each
in a process of its own (``multiprocessing`` spawn), as
``tests/test_torch_parallel.py`` does: gloo with a ``file://`` rendezvous
in the test's temporary directory (or the single-process ``fake``
backend at any world size), a group timeout, and a deadline of the
parent's own after which it kills the children and fails. A process
group is process-global, so a test never starts one in the pytest
worker itself.

A case is ``"module:function"``; ``function(rank, world)`` runs in each
child after the group is up, and its result is saved (``torch.save``)
for the parent to read. A child that raises writes its traceback and
exits non-zero.
"""
import importlib
import multiprocessing as mp
import time
import traceback
from datetime import timedelta
from pathlib import Path

import torch

GROUP_TIMEOUT = timedelta(seconds=120)


def _rank_main(case: str, rank: int, world: int, root: str,
               backend: str) -> None:
    import sys
    import torch.distributed as dist
    torch.set_num_threads(1 if backend == "gloo" else 2)
    out = Path(root)
    try:
        if backend == "fake":
            from torch.testing._internal.distributed.fake_pg import FakeStore
            dist.init_process_group("fake", rank=rank, world_size=world,
                                    store=FakeStore())
        else:
            dist.init_process_group(
                backend, init_method=f"file://{out / 'rendezvous'}",
                rank=rank, world_size=world, timeout=GROUP_TIMEOUT)
        try:
            module, name = case.split(":")
            result = getattr(importlib.import_module(module), name)(rank,
                                                                   world)
        finally:
            dist.destroy_process_group()
        torch.save(result, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        sys.exit(1)


def spawn(case: str, world: int, root: Path, *, deadline_s: float,
          backend: str = "gloo") -> list:
    """Run ``case`` on ``world`` ranks (one process with the ``fake``
    backend, which stands in for every rank); each saved result."""
    root.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    ranks = range(1 if backend == "fake" else world)
    procs = [ctx.Process(target=_rank_main,
                         args=(case, r, world, str(root), backend))
             for r in ranks]
    for p in procs:
        p.start()
    deadline = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        hung = [r for r, p in zip(ranks, procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errs = {r: (root / f"rank{r}.err").read_text() for r in ranks
            if (root / f"rank{r}.err").exists()}
    assert not hung, f"ranks {hung} still ran at the {deadline_s}s deadline"
    assert not errs, "\n".join(f"rank {r}:\n{e}" for r, e in errs.items())
    assert [p.exitcode for p in procs] == [0] * len(procs)
    return [torch.load(root / f"rank{r}.pt", weights_only=False)
            for r in ranks]
