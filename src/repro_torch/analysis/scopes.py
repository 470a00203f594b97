"""Traced-context detection for the port's host-sync rule (R1).

In the port a *traced context* is code whose tensors are not concrete host
values when it runs, so reading one on the host (``.item()``, ``int()``,
an ``if``) either breaks it or silently makes it slow. The port has three
idioms, all recognised syntactically:

* **graphed steps**: the ``run`` method of a step class (a class named
  ``*Step`` or deriving from one) in ``launch/steps.py``, which
  ``steps.capture`` records into a CUDA graph, and the step functions it
  reaches: the model step functions of the bound interface
  (:data:`STEP_FUNCTIONS`) and every function of the same module they
  call by name. A captured step's host reads would run once, at capture,
  and replay stale;
* **fake implementations**: a function registered with ``register_fake``
  for a custom operator. Its tensor arguments are ``FakeTensor``\\ s with
  no data;
* **autograd functions**: ``forward`` and ``backward`` of a
  ``torch.autograd.Function`` subclass, which run inside a captured or
  checkpointed region as often as outside one.

Taint starts at the tensor arguments: parameters annotated
``torch.Tensor`` (or ``torch.Tensor | None``), a step's own buffers (the
``self.<name>`` attributes its class assigns from a tensor factory such
as ``torch.zeros`` or ``init_cache``), a fake's parameters where its
operator's implementation takes a tensor, the tensors an autograd
``forward`` saves for backward and every gradient ``backward`` receives.
It does not flow through configs, shapes, dtypes, devices or ``is None``
tests (the rules prune those). Purely syntactic — no imports are
resolved — so the detector errs on the side of silence: a function it
cannot prove traced is skipped.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass

__all__ = ["TracedContext", "find_traced_contexts", "dotted_name",
           "tensor_params", "STEP_FUNCTIONS", "TENSOR_FACTORIES"]

FuncDef = ast.FunctionDef | ast.AsyncFunctionDef

#: The model step functions of the bound interface (``models.bind``) and
#: the serving steps of ``launch/steps.py`` that the graphed steps run.
STEP_FUNCTIONS = frozenset({
    "prefill_step", "decode_step", "chunked_prefill_step",
    "prefill_chunk_step", "paged_decode_step", "decode_window_step",
    "draft_loop_step", "verify_window_step", "rollback_step"})

#: Calls (by their last name) whose result is a tensor or a tree of them:
#: what makes a step attribute a buffer.
TENSOR_FACTORIES = frozenset({
    "zeros", "ones", "full", "empty", "arange", "tensor", "as_tensor",
    "zeros_like", "ones_like", "full_like", "empty_like", "new_zeros",
    "new_ones", "new_full", "new_empty", "new_tensor", "init_cache",
    "paged_init"})


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _last(node: ast.AST) -> str | None:
    name = dotted_name(node)
    return None if name is None else name.split(".")[-1]


def _is_tensor_type(node: ast.AST | None) -> bool:
    """``torch.Tensor`` or ``Tensor``, alone or ``| None``; a container of
    tensors is not one."""
    if isinstance(node, (ast.Name, ast.Attribute)):
        return _last(node) == "Tensor"
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        sides = (node.left, node.right)
        return (any(_is_tensor_type(s) for s in sides)
                and all(_is_tensor_type(s) or (isinstance(s, ast.Constant)
                                               and s.value is None)
                        for s in sides))
    return False


def _params(func: FuncDef) -> list[ast.arg]:
    a = func.args
    return a.posonlyargs + a.args + a.kwonlyargs


def tensor_params(func: FuncDef) -> set[str]:
    """The parameters of ``func`` annotated as tensors."""
    return {p.arg for p in _params(func) if _is_tensor_type(p.annotation)}


@dataclass
class TracedContext:
    """One function whose ``tainted`` names hold tensors that are not host
    values when it runs (``self.<attr>`` names a step's buffer)."""
    func: FuncDef
    tainted: frozenset[str]
    reason: str      # "step-run" | "step-function" | "fake" | "autograd"


def _assigned_attrs(cls: ast.ClassDef) -> set[str]:
    """``self.<name>`` attributes the class assigns from a tensor factory."""
    out: set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        pairs = []
        for t in targets:
            if isinstance(t, ast.Tuple) and isinstance(node.value, ast.Tuple) \
                    and len(t.elts) == len(node.value.elts):
                pairs += zip(t.elts, node.value.elts)
            else:
                pairs.append((t, node.value))
        for target, value in pairs:
            name = dotted_name(target)
            if (name and name.startswith("self.") and name.count(".") == 1
                    and value is not None and any(
                        isinstance(c, ast.Call)
                        and _last(c.func) in TENSOR_FACTORIES
                        for c in ast.walk(value))):
                out.add(name)
    return out


def _is_step_class(cls: ast.ClassDef) -> bool:
    return cls.name.endswith("Step") or any(
        (_last(b) or "").endswith("Step") for b in cls.bases)


def _is_autograd_function(cls: ast.ClassDef) -> bool:
    return any(dotted_name(b) in ("torch.autograd.Function",
                                  "autograd.Function", "Function")
               for b in cls.bases)


def _saved_names(func: FuncDef) -> set[str]:
    """Names passed to ``ctx.save_for_backward(...)`` in ``func``."""
    return {a.id for c in ast.walk(func) if isinstance(c, ast.Call)
            and _last(c.func) == "save_for_backward"
            for a in c.args if isinstance(a, ast.Name)}


def _custom_op_impls(tree: ast.Module) -> dict[str, FuncDef]:
    """Operator name -> its implementation's def, for
    ``op = torch.library.custom_op("ns::op", impl, ...)``."""
    defs = {f.name: f for f in ast.walk(tree)
            if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))}
    return {node.targets[0].id: defs[node.value.args[1].id]
            for node in ast.walk(tree)
            if isinstance(node, ast.Assign) and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Call)
            and _last(node.value.func) == "custom_op"
            and len(node.value.args) > 1
            and isinstance(node.value.args[1], ast.Name)
            and node.value.args[1].id in defs}


def _fake_taint(func: FuncDef, impls: dict[str, FuncDef]) -> set[str] | None:
    """The tensor parameters of a ``register_fake`` implementation, or
    None when ``func`` is not one."""
    for deco in func.decorator_list:
        target = deco.func if isinstance(deco, ast.Call) else deco
        if _last(target) != "register_fake":
            continue
        op = dotted_name(target.value) if isinstance(
            target, ast.Attribute) else None
        impl = impls.get(op or "")
        if impl is None:
            return tensor_params(func)
        impl_tensor = [_is_tensor_type(p.annotation) for p in _params(impl)]
        return {p.arg for p, t in zip(_params(func), impl_tensor) if t}
    return None


def _called_names(func: FuncDef) -> set[str]:
    return {c.func.id for c in ast.walk(func)
            if isinstance(c, ast.Call) and isinstance(c.func, ast.Name)}


def find_traced_contexts(tree: ast.Module) -> list[TracedContext]:
    contexts: dict[int, TracedContext] = {}

    def add(func: FuncDef, tainted: set[str], reason: str) -> None:
        contexts.setdefault(id(func),
                            TracedContext(func, frozenset(tainted), reason))

    impls = _custom_op_impls(tree)
    module_defs = {f.name: f for f in tree.body
                   if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            methods = [f for f in node.body if isinstance(
                f, (ast.FunctionDef, ast.AsyncFunctionDef))]
            if _is_step_class(node):
                buffers = _assigned_attrs(node)
                for f in methods:
                    if f.name == "run":
                        add(f, buffers | tensor_params(f), "step-run")
            if _is_autograd_function(node):
                for f in methods:
                    if f.name == "forward":
                        add(f, tensor_params(f) | _saved_names(f),
                            "autograd")
                    elif f.name == "backward":
                        add(f, {p.arg for p in _params(f)[1:]}, "autograd")
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fake = _fake_taint(node, impls)
            if fake is not None:
                add(node, fake, "fake")
    # the step functions, and what a graphed step or step function of
    # this module calls by name, transitively
    todo = [f for name, f in module_defs.items() if name in STEP_FUNCTIONS]
    todo += [c.func for c in list(contexts.values())
             if c.reason == "step-run"]
    seen: set[int] = set()
    while todo:
        func = todo.pop()
        if id(func) in seen:
            continue
        seen.add(id(func))
        if func.name in module_defs and module_defs[func.name] is func:
            add(func, tensor_params(func), "step-function")
        todo += [module_defs[n] for n in _called_names(func)
                 if n in module_defs]
    return list(contexts.values())
