"""Async checkpointing with manifest-driven restore (port of
``repro/checkpoint/checkpointer.py``).

Layout on disk::

    <dir>/step_<N>/manifest.json       structure, shapes, dtypes, step
    <dir>/step_<N>/leaf_<i>.pt         one tensor a leaf (``torch.save``)
    <dir>/step_<N>/COMMITTED           written last: restore ignores partials

A save copies every leaf to the host first, so training may go on
changing its tensors, then writes on a background thread into
``.tmp_step_<N>``, writes the manifest and ``COMMITTED``, and renames the
directory; ``wait()`` joins the thread. Only committed steps are listed,
and the oldest beyond ``keep`` are removed. The format is the port's
tree (``repro_torch.tree``: dicts and the list of layers), each leaf a
tensor in its own dtype, so bf16 comes back bit for bit.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any

import torch

from repro_torch import tree as tr

__all__ = ["Checkpointer"]


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """A host copy of ``x`` that no later write to ``x`` reaches."""
    return x.detach().to("cpu", copy=True)


class Checkpointer:
    def __init__(self, directory: str | Path, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ save

    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        self.wait()
        leaves, structure = tr.flatten(tree)
        host_leaves = [_to_host(x) for x in leaves]
        structure_repr = repr(structure)

        def _write():
            path = self.dir / f"step_{step:08d}"
            tmp = self.dir / f".tmp_step_{step:08d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "n_leaves": len(host_leaves),
                        "treedef": structure_repr,
                        "dtypes": [str(a.dtype).removeprefix("torch.")
                                   for a in host_leaves],
                        "shapes": [list(a.shape) for a in host_leaves]}
            for i, arr in enumerate(host_leaves):
                torch.save(arr, tmp / f"leaf_{i}.pt")
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            (tmp / "COMMITTED").touch()
            if path.exists():
                shutil.rmtree(path)
            tmp.rename(path)
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # --------------------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "COMMITTED").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any) -> Any:
        """The tree of ``like``'s structure saved at ``step``: the leaf
        count and every leaf's shape checked against ``like``, each leaf
        in its saved dtype on the device of ``like``'s leaf."""
        path = self.dir / f"step_{step:08d}"
        manifest = json.loads((path / "manifest.json").read_text())
        leaves_like, structure = tr.flatten(like)
        if manifest["n_leaves"] != len(leaves_like):
            raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                             f"expected {len(leaves_like)}")
        out = []
        for i, ref in enumerate(leaves_like):
            leaf = torch.load(path / f"leaf_{i}.pt", map_location="cpu",
                              weights_only=True)
            if leaf.shape != ref.shape:
                raise ValueError(f"leaf {i}: checkpoint shape "
                                 f"{tuple(leaf.shape)}, expected "
                                 f"{tuple(ref.shape)}")
            out.append(leaf.to(ref.device))
        return tr.unflatten(structure, out)
