"""The port's lint rules R1–R5: the reference's ids and intent, recast for
what PyTorch and CUDA graphs make hazardous.

Each rule encodes an invariant that a past bug (or near-miss) showed is
too easy to regress silently; the docstring of each rule class names it.
All rules are purely syntactic over one module's AST — no imports are
executed — so they favour precision over recall: code a rule cannot prove
wrong is left alone, and the contract audits
(``repro_torch.analysis.contracts``) catch the semantic remainder.
"""
from __future__ import annotations

import ast
from typing import Iterable

from .base import Finding, Rule
from .scopes import FuncDef, dotted_name, find_traced_contexts, tensor_params

__all__ = ["HostSyncSafety", "RecompilationHazard", "TypedBackpressure",
           "CacheKeyCompleteness", "DtypeDrift", "DEFAULT_RULES"]

# Attribute reads that are host metadata, never a device read.
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                 "requires_grad", "is_leaf"}
# Methods whose result is host metadata even on a device tensor.
_STATIC_METHODS = {"size", "dim", "numel", "nelement", "stride",
                   "is_contiguous", "element_size", "data_ptr",
                   "storage_offset", "is_floating_point", "get_device"}
# Builtins (and helpers) whose result is host-static on a tensor argument.
_PRUNE_CALLS = {"isinstance", "len", "getattr", "hasattr", "type", "id",
                "repr", "str", "callable", "is_dtensor"}
# Attributes whose value is a tensor even with no tainted name in sight.
_TAINT_SOURCES = {"saved_tensors"}
# Methods that copy a tensor to the host.
_HOST_READS = {"item", "tolist", "cpu", "numpy"}
# Calls whose output shape depends on the data (a device sync to size it).
_DATA_SHAPED = {"nonzero", "masked_select", "unique"}


class _TaintScan(ast.NodeVisitor):
    """Does an expression reference a tainted name (modulo static reads)?"""

    def __init__(self, env: set[str]):
        self.env = env
        self.hit = False

    def visit_Attribute(self, node: ast.Attribute):
        if node.attr in _STATIC_ATTRS:
            return
        if node.attr in _TAINT_SOURCES or dotted_name(node) in self.env:
            self.hit = True
            return
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        callee = dotted_name(node.func)
        if callee in _PRUNE_CALLS:
            return
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _STATIC_METHODS:
            return
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare):
        # `x is None` / `x is not None` inspects structure, not data
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name):
        if node.id in self.env:
            self.hit = True


def _tainted(node: ast.AST | None, env: set[str]) -> bool:
    if node is None:
        return False
    scan = _TaintScan(env)
    scan.visit(node)
    return scan.hit


class HostSyncSafety(Rule):
    """R1: no host reads or host branches on device tensors where the
    tensors are not host values.

    Inside a graphed step's ``run`` and the step functions it reaches, a
    ``register_fake`` implementation, or an autograd ``forward``/
    ``backward``, ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``,
    ``int()``/``float()``/``bool()`` coercions, ``if``/``while``/
    conditional expressions and data-dependent-shape calls
    (``nonzero``, ``masked_select``, ``unique``) on a tensor either fail
    (a capture refuses a synchronize; a fake tensor has no data) or,
    worse, bake the captured value into every replay. Shape, dtype and
    device reads and ``is None`` checks are host values and stay allowed.
    """

    id = "R1"
    name = "host-sync-safety"
    scope = ("repro_torch/kernels/", "repro_torch/launch/steps.py",
             "repro_torch/models/")

    def check(self, tree, src, path):
        for ctx in find_traced_contexts(tree):
            yield from self._walk(ctx.func.body, set(ctx.tainted), path)

    # -- statement walker with a forward-flowing taint env ----------------
    def _walk(self, stmts, env: set[str], path) -> Iterable[Finding]:
        for node in stmts:
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                tainted = _tainted(node.value, env)
                if isinstance(node, ast.AugAssign):
                    tainted = tainted or _tainted(node.target, env)
                yield from self._scan_expr(node.value, env, path)
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for name in self._target_names(targets):
                    (env.add if tainted else env.discard)(name)
            elif isinstance(node, (ast.If, ast.While)):
                if _tainted(node.test, env):
                    kind = "if" if isinstance(node, ast.If) else "while"
                    yield self.finding(
                        path, node.lineno,
                        f"`{kind}` on a device tensor inside a graphed "
                        f"step, fake or autograd function — use "
                        f"torch.where, or hoist the flag to a host value")
                yield from self._scan_expr(node.test, env, path)
                yield from self._walk(node.body, env, path)
                yield from self._walk(node.orelse, env, path)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                yield from self._scan_expr(node.iter, env, path)
                if _tainted(node.iter, env):
                    env.update(self._target_names([node.target]))
                yield from self._walk(node.body, env, path)
                yield from self._walk(node.orelse, env, path)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    yield from self._scan_expr(item.context_expr, env, path)
                yield from self._walk(node.body, env, path)
            elif isinstance(node, ast.Try):
                for block in (node.body, node.orelse, node.finalbody):
                    yield from self._walk(block, env, path)
                for h in node.handlers:
                    yield from self._walk(h.body, env, path)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a nested def closes over the env; its own tensor
                # parameters are tainted, the others shadow
                inner = set(env) - {a.arg for a in node.args.posonlyargs
                                    + node.args.args + node.args.kwonlyargs}
                inner |= tensor_params(node)
                yield from self._walk(node.body, inner, path)
            elif isinstance(node, (ast.Return, ast.Expr)):
                yield from self._scan_expr(node.value, env, path)

    @staticmethod
    def _target_names(targets) -> Iterable[str]:
        for t in targets:
            name = dotted_name(t)
            if name is not None and (isinstance(t, ast.Name)
                                     or name.count(".") == 1):
                yield name
            elif isinstance(t, (ast.Tuple, ast.List)):
                yield from HostSyncSafety._target_names(t.elts)

    def _scan_expr(self, node, env: set[str], path) -> Iterable[Finding]:
        if node is None:
            return
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                callee = sub.func
                name = dotted_name(callee)
                last = callee.attr if isinstance(callee, ast.Attribute) \
                    else name
                if isinstance(callee, ast.Attribute) \
                        and last in _HOST_READS \
                        and _tainted(callee.value, env):
                    yield self.finding(
                        path, sub.lineno,
                        f"`.{last}()` of a device tensor — a host sync "
                        f"that a capture refuses (or replays stale) and a "
                        f"fake tensor cannot answer; keep it a tensor")
                elif name in ("int", "float", "bool") and sub.args \
                        and _tainted(sub.args[0], env):
                    yield self.finding(
                        path, sub.lineno,
                        f"`{name}()` coercion of a device tensor — a host "
                        f"sync; use a tensor op or .to(dtype)")
                elif last in _DATA_SHAPED and (
                        (isinstance(callee, ast.Attribute)
                         and _tainted(callee.value, env)
                         and (name or "").split(".")[0] != "torch")
                        or (sub.args and _tainted(sub.args[0], env))):
                    yield self.finding(
                        path, sub.lineno,
                        f"`{last}` on a device tensor — its output shape "
                        f"depends on the data, a host sync a capture "
                        f"refuses; use a fixed-shape mask")
            elif isinstance(sub, ast.IfExp) and _tainted(sub.test, env):
                yield self.finding(
                    path, sub.lineno,
                    "conditional expression on a device tensor — use "
                    "torch.where instead")


class RecompilationHazard(Rule):
    """R2: graphs, compiled functions and kernel libraries built per call
    must pass through a memo.

    The JAX package once rebuilt ``jax.jit(...)`` in ``serve.py`` every
    request, recompiling the model per prompt. Its torch form is a CUDA graph
    captured, a ``torch.compile`` made, an extension built or a library
    loaded in a serve function's body: per request. Any
    ``torch.cuda.CUDAGraph()``, ``torch.cuda.graph(...)``,
    ``torch.compile(...)``, ``torch.utils.cpp_extension.load*`` or
    ``ctypes.CDLL(...)`` inside a function body must be reachable only
    through a memo: an ``lru_cache``/``cache`` function, a function a
    memo calls, or a keyed dict memo (a function that looks a key up in a
    dict, ``d.get(key)`` or ``key in d``, and stores ``d[key] = ...``:
    ``launch/steps.py``'s ``_STEPS``, ``kernels/build.py``'s ``_LIBS``).
    """

    id = "R2"
    name = "recompilation-hazard"
    scope = ("repro_torch/",)

    _MEMO = {"functools.lru_cache", "lru_cache", "functools.cache", "cache"}
    _BUILDERS = {"torch.cuda.CUDAGraph", "torch.cuda.graph",
                 "torch.compile", "ctypes.CDLL", "CDLL"}

    def _builder(self, call: ast.Call) -> str | None:
        name = dotted_name(call.func)
        if name is not None and (name in self._BUILDERS or (
                "cpp_extension" in name.split(".")[:-1]
                and name.split(".")[-1].startswith("load"))):
            return name
        return None

    def _is_memoized(self, func: FuncDef) -> bool:
        for deco in func.decorator_list:
            target = deco.func if isinstance(deco, ast.Call) else deco
            if dotted_name(target) in self._MEMO:
                return True
        return self._is_dict_memo(func)

    @staticmethod
    def _is_dict_memo(func: FuncDef) -> bool:
        """A keyed lookup of a dict and a keyed store into the same one."""
        looked, stored = set(), set()
        for node in ast.walk(func):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and node.func.attr == "get":
                looked.add(dotted_name(node.func.value))
            elif isinstance(node, ast.Compare) and any(
                    isinstance(op, (ast.In, ast.NotIn)) for op in node.ops):
                looked.update(dotted_name(c) for c in node.comparators)
            elif isinstance(node, ast.Assign):
                stored.update(dotted_name(t.value) for t in node.targets
                              if isinstance(t, ast.Subscript))
        return bool((looked & stored) - {None})

    def check(self, tree, src, path):
        memoized = [n for n in ast.walk(tree)
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and self._is_memoized(n)]
        called_by_memo = {
            (dotted_name(c.func) or "").split(".")[-1]
            for m in memoized for c in ast.walk(m)
            if isinstance(c, ast.Call)}

        def exempt(chain: list[FuncDef]) -> bool:
            return any(self._is_memoized(f) or f.name in called_by_memo
                       for f in chain)

        yield from self._scan(tree.body, [], exempt, path)

    def _scan(self, stmts, chain, exempt, path) -> Iterable[Finding]:
        for node in stmts:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._scan(node.body, chain + [node], exempt, path)
            elif isinstance(node, ast.ClassDef):
                yield from self._scan(node.body, chain, exempt, path)
            else:
                for sub in ast.walk(node):
                    if not isinstance(sub, ast.Call):
                        continue
                    kind = self._builder(sub)
                    if kind and chain and not exempt(chain):
                        yield self.finding(
                            path, sub.lineno,
                            f"{kind} built inside `{chain[-1].name}` with "
                            f"no memo on the call path (lru_cache or a "
                            f"keyed dict) — rebuilt per call (a graph "
                            f"captured or a library loaded per request)")


class TypedBackpressure(Rule):
    """R3: capacity/allocation paths raise typed errors, not bare builtins.

    The engine turns ``PoolExhausted`` into wait/preempt scheduling; a bare
    ``ValueError``/``RuntimeError`` from ``serving/`` (the prefix-cache
    sharing layer ``serving/prefix.py`` included) or the cache ops is
    indistinguishable from a crash. Use the typed errors of
    ``repro_torch.errors``: ``PoolExhausted`` (capacity), ``ConfigError``,
    ``CacheLayoutError`` (layout-contract breaks), ``EngineInvariantError``
    (engine bugs), ``PrefixCacheInvariantError`` (sharing-protocol
    breaks), ``KernelLaunchError``.
    """

    id = "R3"
    name = "typed-backpressure"
    scope = ("repro_torch/serving/", "repro_torch/serving/prefix.py",
             "repro_torch/models/cache_ops.py")

    _BARE = {"ValueError", "RuntimeError", "Exception"}

    def check(self, tree, src, path):
        for node in ast.walk(tree):
            if isinstance(node, ast.Raise) and isinstance(node.exc, ast.Call):
                name = dotted_name(node.exc.func)
                if name in self._BARE:
                    yield self.finding(
                        path, node.lineno,
                        f"bare `{name}` raised on a serving path — use "
                        f"PoolExhausted (capacity) or a typed error from "
                        f"repro_torch.errors (ConfigError / CacheLayoutError "
                        f"/ EngineInvariantError / PrefixCacheInvariantError "
                        f"/ KernelLaunchError)")


class CacheKeyCompleteness(Rule):
    """R4: every AutotuneCache key embeds the backend and the mode.

    The JAX package's schema-v1 cache keyed entries only by shape, so
    CPU timings poisoned device lookups. Every ``key``/``*_key`` method of
    an ``AutotuneCache`` class must fold both ``backend`` (the device and
    kernel) and the mode (``_mode(...)``: the card or the plain versions)
    into each returned key string.
    """

    id = "R4"
    name = "cache-key-completeness"
    scope = ()                      # fires only inside AutotuneCache classes

    def check(self, tree, src, path):
        for cls in ast.walk(tree):
            if not (isinstance(cls, ast.ClassDef)
                    and "AutotuneCache" in cls.name):
                continue
            for func in cls.body:
                if not (isinstance(func, ast.FunctionDef)
                        and (func.name == "key"
                             or func.name.endswith("_key"))):
                    continue
                for ret in ast.walk(func):
                    if not isinstance(ret, ast.Return) or ret.value is None:
                        continue
                    names = {n.id for n in ast.walk(ret.value)
                             if isinstance(n, ast.Name)}
                    calls = {dotted_name(c.func) or ""
                             for c in ast.walk(ret.value)
                             if isinstance(c, ast.Call)}
                    has_mode = any(c.split(".")[-1] == "_mode" for c in calls)
                    missing = [seg for seg, ok in
                               [("backend", "backend" in names),
                                ("mode", has_mode)] if not ok]
                    if missing:
                        yield self.finding(
                            path, ret.lineno,
                            f"AutotuneCache.{func.name} returns a key "
                            f"missing the {'/'.join(missing)} segment(s) — "
                            f"the schema-v1 cache-poisoning bug")


class DtypeDrift(Rule):
    """R5: the count path keeps its casts full-width and its accumulators
    explicit.

    The count-identity contract needs the popcount and attention
    contractions exact: a literal half-precision cast
    (``.to(torch.bfloat16|torch.float16)``, ``.half()``, ``.bfloat16()``,
    ``dtype=`` a half type) narrows counts or probabilities, and a
    ``matmul``/``einsum``/``mm``/``bmm``/``@`` whose accumulator the
    backend chooses (PyTorch has no ``preferred_element_type``) may sum
    in bf16 or TF32. A contraction here takes operands cast explicitly to
    ``torch.float32`` or an integer type, or reduces through ``tree_sum``.
    """

    id = "R5"
    name = "dtype-drift"
    scope = ("repro_torch/kernels/", "repro_torch/core/sc_matmul.py",
             "repro_torch/models/layers.py")

    _HALF = {"bfloat16", "float16", "half"}
    _HALF_METHODS = {"half", "bfloat16"}
    _EXACT = {"float32", "float", "int8", "int16", "int32", "int64", "int",
              "long", "short", "uint8"}
    _EXACT_METHODS = {"float", "int", "long", "short"}
    _CONTRACTIONS = {"matmul", "einsum", "mm", "bmm"}

    def _is_half(self, node: ast.AST) -> bool:
        return isinstance(node, ast.Attribute) and node.attr in self._HALF

    def _is_exact_cast(self, node: ast.AST, exact: set[str]) -> bool:
        """An explicit full-width cast, or a name only ever assigned one."""
        if isinstance(node, ast.Name):
            return node.id in exact
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute):
            return False
        if node.func.attr in self._EXACT_METHODS and not node.args:
            return True
        if node.func.attr == "to":
            dtypes = [a for a in node.args if isinstance(a, ast.Attribute)]
            dtypes += [k.value for k in node.keywords if k.arg == "dtype"]
            return bool(dtypes) and all(
                isinstance(d, ast.Attribute) and d.attr in self._EXACT
                for d in dtypes)
        return False

    def _exact_names(self, func: ast.AST) -> set[str]:
        assigned: dict[str, bool] = {}
        for node in ast.walk(func):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        ok = self._is_exact_cast(node.value, set())
                        assigned[t.id] = assigned.get(t.id, True) and ok
        return {n for n, ok in assigned.items() if ok}

    def check(self, tree, src, path):
        scopes = [n for n in ast.walk(tree) if isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        exact_in = {}
        for f in scopes:
            names = self._exact_names(f)
            for node in ast.walk(f):
                exact_in.setdefault(id(node), names)
        for node in ast.walk(tree):
            exact = exact_in.get(id(node), set())
            if isinstance(node, ast.BinOp) and isinstance(node.op,
                                                          ast.MatMult):
                operands = [node.left, node.right]
                if not all(self._is_exact_cast(o, exact) for o in operands):
                    yield self._contraction(path, node.lineno, "@")
                continue
            if not isinstance(node, ast.Call):
                continue
            callee = node.func
            last = callee.attr if isinstance(callee, ast.Attribute) \
                else dotted_name(callee)
            if (last == "to" and any(
                    self._is_half(a) for a in node.args)) or any(
                    k.arg == "dtype" and self._is_half(k.value)
                    for k in node.keywords):
                yield self.finding(
                    path, node.lineno,
                    "half-precision cast on the SC/attention count path "
                    "breaks the count-identity contract")
            elif last in self._HALF_METHODS and isinstance(
                    callee, ast.Attribute) and not node.args:
                yield self.finding(
                    path, node.lineno,
                    f"`.{last}()` on the SC/attention count path breaks "
                    f"the count-identity contract")
            elif last in self._CONTRACTIONS and isinstance(
                    callee, ast.Attribute):
                operands = list(node.args)
                if last == "einsum" and operands and isinstance(
                        operands[0], ast.Constant):
                    operands = operands[1:]
                elif dotted_name(callee) not in (f"torch.{last}",):
                    operands = [callee.value, *operands]
                if not operands or not all(self._is_exact_cast(o, exact)
                                           for o in operands):
                    yield self._contraction(path, node.lineno, last)

    def _contraction(self, path, line, what) -> Finding:
        return self.finding(
            path, line,
            f"`{what}` with a backend-chosen accumulator — cast its "
            f"operands to torch.float32 or an integer type, or reduce "
            f"through tree_sum")


DEFAULT_RULES: tuple[Rule, ...] = (
    HostSyncSafety(), RecompilationHazard(), TypedBackpressure(),
    CacheKeyCompleteness(), DtypeDrift())
