"""Device-sync and compile hygiene for the port's card-resident plane.

The counterpart of ``repro/analysis/jit.py``. Applied to the modules where
tensors live on the card (the runner's ``SYNC_SCOPE``). The JAX package's
four ``jit-*`` rules map so:

* ``jit-concretize`` → ``device-sync``. Under ``jax.jit`` a host read of a
  traced value fails; in eager torch it succeeds but makes the host wait
  until the card has finished everything queued before it, so the next
  launch cannot be queued while the card works. Flagged:

  - ``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()`` and ``.nonzero()``
    on any receiver except the ``numpy``/``math`` modules and values the
    rule can see are numpy arrays (the result of an ``np.*`` call, directly
    or through a local name);
  - ``torch.cuda.synchronize()``, ``torch.nonzero``, ``torch.unique`` and
    ``torch.masked_select`` (their output's size is data-dependent);
  - ``float()``, ``int()`` or ``bool()`` of a value the rule can see is a
    tensor, and the implicit ``bool()`` of one that an ``if``, ``while``,
    ``assert``, ``and``/``or``/``not`` or conditional expression tests.

  A value is a *visible tensor* when it is the result of a ``torch.*`` call
  (other than the scalar helpers in ``_TORCH_NON_TENSOR``), of a tensor
  method in ``_TENSOR_METHODS``, an index, arithmetic or comparison of a
  visible tensor, or a local name assigned from one (or annotated
  ``torch.Tensor``) earlier in the same function. The reference's
  exemptions stay: constants and shape arithmetic (``int(x.shape[0])``,
  ``len``). The test is syntactic and local on purpose: what it cannot see
  (a boolean-mask index, a tensor handed in through a parameter) is what
  the card's sync audit in ``chip_smoke.py`` reports.
* ``jit-per-call`` → ``compile-per-call``: an immediately invoked
  ``torch.compile(f)(x)`` or ``torch.jit.script(f)(x)`` / ``trace`` builds
  a fresh compiled wrapper on every call, so its cache never hits.
* ``jit-mutable-global`` has no counterpart: eager torch traces nothing, so
  a module-level array is read as it is at each call, never baked in.
* ``jit-static-argnames`` has no counterpart: eager torch has no static
  arguments and never retraces on a scalar's value.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.source import SourceFile

__all__ = ["check_sync"]

_SYNC_METHODS = {"item", "cpu", "numpy", "tolist", "nonzero"}
_SYNC_TORCH_FNS = {"nonzero", "unique", "masked_select"}
_HOST_MODULES = {"np", "numpy", "math"}
# ``torch.*`` calls that wrap data as a tensor: on the host unless given a
# device.
_WRAPPERS = {"as_tensor", "tensor"}
_SHAPE_ATTRS = {"shape", "ndim", "size"}
# Tensor methods whose result is a tensor (a reduction or a selection).
_TENSOR_METHODS = {
    "sum", "max", "min", "mean", "norm", "any", "all", "argmax", "argmin",
    "amax", "amin", "prod", "std", "var", "abs", "sqrt", "exp", "log",
    "logsumexp", "softmax", "topk", "cumsum", "count_nonzero", "isfinite",
    "isnan", "isinf", "eq", "ne", "lt", "le", "gt", "ge", "float",
    "double", "int", "long", "bool", "to", "cuda", "clone", "detach",
    "contiguous", "view", "reshape", "flatten", "squeeze", "unsqueeze"}
# ``torch.*`` calls that return a Python scalar, a dtype or a device.
_TORCH_NON_TENSOR = {
    "finfo", "iinfo", "device", "dtype", "Size", "Generator",
    "get_default_dtype", "is_tensor", "is_floating_point", "is_complex",
    "numel", "get_num_threads", "promote_types", "result_type", "can_cast",
    "is_grad_enabled", "no_grad", "enable_grad", "inference_mode",
    "set_default_dtype", "manual_seed", "initial_seed", "seed"}
_TORCH_TENSOR_NAMESPACES = {"linalg", "fft", "special"}
_COMPILERS = (("torch", "compile"), ("torch", "jit", "script"),
              ("torch", "jit", "trace"))


def _attr_chain(node: ast.AST) -> Optional[List[str]]:
    """``torch.cuda.synchronize`` → ["torch", "cuda", "synchronize"]."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def _contains_shape_access(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in _SHAPE_ATTRS:
            return True
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) \
                and sub.func.id == "len":
            return True
    return False


def _is_tensor_annotation(node: Optional[ast.AST]) -> bool:
    chain = _attr_chain(node) if node is not None else None
    return chain in (["torch", "Tensor"], ["Tensor"])


class _Scope:
    """Assignments of one function: name → [(line, kind)] in line order,
    where kind is ``"tensor"``, ``"host"`` or ``None`` (see ``_kind``)."""

    def __init__(self, fn: Optional[ast.AST], body: List[ast.stmt]):
        self.assigns: Dict[str, List[Tuple[int, Optional[str]]]] = {}
        if fn is not None:
            args = fn.args
            for a in (args.posonlyargs + args.args + args.kwonlyargs):
                if _is_tensor_annotation(a.annotation):
                    self.assigns[a.arg] = [(fn.lineno, "tensor")]
        self.body = body

    def collect(self) -> None:
        """Bind every local assignment, in line order, so that each value
        is judged by the bindings before it."""
        nodes = [n for stmt in self.body for n in _walk_local(stmt)
                 if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign,
                                   ast.For, ast.AsyncFor, ast.With,
                                   ast.AsyncWith, ast.comprehension))]
        nodes.sort(key=lambda n: (getattr(n, "lineno", 0),
                                  getattr(n, "col_offset", 0)))
        for node in nodes:
            if isinstance(node, ast.Assign):
                kind = _kind(node.value, self, node.lineno)
                for t in node.targets:
                    self._bind(t, kind, node.lineno)
            elif isinstance(node, ast.AnnAssign):
                kind = ("tensor" if _is_tensor_annotation(node.annotation)
                        else None if node.value is None
                        else _kind(node.value, self, node.lineno))
                self._bind(node.target, kind, node.lineno)
            elif isinstance(node, ast.AugAssign):
                both = ast.BinOp(left=node.target, op=node.op,
                                 right=node.value)
                self._bind(node.target, _kind(both, self, node.lineno),
                           node.lineno)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if item.optional_vars is not None:
                        self._bind(item.optional_vars, None, node.lineno)
            else:
                self._bind(node.target, None, node.target.lineno)

    def _bind(self, target: ast.AST, kind: Optional[str], line: int) -> None:
        if isinstance(target, ast.Name):
            self.assigns.setdefault(target.id, []).append((line, kind))
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, kind, line)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, kind, line)

    def kind(self, name: str, line: int) -> Optional[str]:
        """The kind of the last assignment to ``name`` before ``line``."""
        kind = None
        for at, k in self.assigns.get(name, ()):
            if at >= line:
                break
            kind = k
        return kind


def _walk_local(node: ast.AST):
    """``ast.walk`` that does not enter nested functions or classes."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef, ast.Lambda)):
                stack.append(child)


def _device_keyword(call: ast.Call) -> bool:
    """Whether ``call`` has a ``device=`` keyword other than ``None``."""
    return any(kw.arg == "device" and not (isinstance(kw.value, ast.Constant)
                                           and kw.value.value is None)
               for kw in call.keywords)


def _names_a_device(call: ast.Call) -> bool:
    """Whether a ``.to(...)`` call moves to a device: a ``device=``
    keyword, or a first argument that is a string, a ``torch.device(...)``
    or a name that says device (``dev``, ``self.device``, ``x.device``)."""
    if _device_keyword(call):
        return True
    if not call.args:
        return False
    arg = call.args[0]
    if isinstance(arg, ast.Constant):
        return isinstance(arg.value, str)
    chain = _attr_chain(arg.func if isinstance(arg, ast.Call) else arg)
    return bool(chain) and (chain == ["torch", "device"]
                            or "dev" in chain[-1].lower())


def _non_blocking(call: ast.Call) -> bool:
    return any(kw.arg == "non_blocking" and not (
        isinstance(kw.value, ast.Constant) and not kw.value.value)
        for kw in call.keywords)


def _kind(node: Optional[ast.AST], scope: _Scope, line: int) -> Optional[str]:
    """``"tensor"`` for a visible tensor (which may lie on the card),
    ``"host"`` for a value visibly on the host (a numpy array, a tensor
    from ``torch.from_numpy`` or ``.cpu()``, a literal), else None."""
    if node is None:
        return None
    if isinstance(node, ast.Name):
        return scope.kind(node.id, line)
    if isinstance(node, (ast.List, ast.Tuple, ast.ListComp)):
        return "host"
    if isinstance(node, ast.Call):
        chain = _attr_chain(node.func)
        if chain and chain[0] in ("np", "numpy"):
            return "host"
        if chain and chain[0] == "torch":
            if chain == ["torch", "from_numpy"]:
                return "host"
            if len(chain) == 2 and chain[1] in _WRAPPERS:
                if _device_keyword(node):
                    return "tensor"
                return ("tensor" if node.args
                        and _kind(node.args[0], scope, line) == "tensor"
                        else "host")
            if len(chain) == 2 and chain[1] not in _TORCH_NON_TENSOR:
                return "tensor"
            if len(chain) == 3 and chain[1] in _TORCH_TENSOR_NAMESPACES:
                return "tensor"
            return None
        if isinstance(node.func, ast.Attribute):
            recv, attr = node.func.value, node.func.attr
            if isinstance(recv, ast.Name) and recv.id in _HOST_MODULES:
                return None
            if attr in _SYNC_METHODS - {"nonzero"}:
                return "host"
            if _kind(recv, scope, line) == "host":
                if attr == "cuda" or (attr == "to"
                                      and _names_a_device(node)):
                    return "tensor"
                return "host"
            if attr in _TENSOR_METHODS:
                return "tensor"
        return None
    if isinstance(node, ast.Subscript):
        return _kind(node.value, scope, line)
    if isinstance(node, ast.UnaryOp) and not isinstance(node.op, ast.Not):
        return _kind(node.operand, scope, line)
    if isinstance(node, (ast.BinOp, ast.Compare)):
        sides = ([node.left, node.right] if isinstance(node, ast.BinOp)
                 else [node.left] + list(node.comparators))
        kinds = {_kind(s, scope, line) for s in sides}
        if "tensor" in kinds:
            return "tensor"
        return "host" if "host" in kinds else None
    return None


class _SyncVisitor(ast.NodeVisitor):
    """``device-sync`` and ``compile-per-call`` over one scope's body."""

    def __init__(self, src: SourceFile, scope: _Scope,
                 findings: List[Finding]):
        self.src = src
        self.scope = scope
        self.findings = findings

    def _flag(self, node: ast.AST, rule: str, msg: str) -> None:
        self.findings.append(Finding(self.src.rel, node.lineno, rule, msg))

    def _tensor(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Constant) or _contains_shape_access(node):
            return False
        return _kind(node, self.scope, node.lineno) == "tensor"

    def _test(self, node: ast.AST) -> None:
        """The implicit ``bool()`` of a condition (an ``and``/``or``/``not``
        is tested operand by operand when it is visited)."""
        if self._tensor(node):
            self._flag(node, "device-sync",
                       "a condition on a card tensor is its `bool()`: the "
                       "host waits for the card")

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Call):
            inner = _attr_chain(func.func)
            if inner and tuple(inner) in _COMPILERS:
                self._flag(node, "compile-per-call",
                           f"immediately-invoked `{'.'.join(inner)}(...)"
                           "(...)` builds a fresh compiled wrapper per call; "
                           "hoist or cache it")
        why = self._sync(node)
        if why is not None:
            self._flag(node, "device-sync", why)
        self.generic_visit(node)

    def _sync(self, node: ast.Call) -> Optional[str]:
        """Why ``node`` makes the host wait for the card, or None."""
        func, line = node.func, node.lineno
        chain = _attr_chain(func) or []
        if chain == ["torch", "cuda", "synchronize"]:
            return "`torch.cuda.synchronize()` waits for the card"
        if len(chain) == 2 and chain[0] == "torch":
            if chain[1] in _SYNC_TORCH_FNS:
                return (f"`torch.{chain[1]}` has a data-dependent size: the "
                        "host waits for the card to learn it")
            if chain[1] in _WRAPPERS and node.args \
                    and _device_keyword(node) and not _non_blocking(node):
                arg = node.args[0]
                kind = _kind(arg, self.scope, line)
                if kind == "host" or isinstance(arg, ast.Constant) \
                        or (chain[1] == "tensor" and kind != "tensor"):
                    return (f"`torch.{chain[1]}(host data, device=...)` is "
                            "a blocking copy to the card: the host waits "
                            "for it")
            return None
        if isinstance(func, ast.Name):
            if func.id in ("float", "int", "bool") and node.args \
                    and self._tensor(node.args[0]):
                return (f"`{func.id}()` of a tensor copies it to the host: "
                        "the host waits for the card")
            return None
        if not isinstance(func, ast.Attribute):
            return None
        recv, attr = func.value, func.attr
        on_host = (isinstance(recv, ast.Name) and recv.id in _HOST_MODULES) \
            or _kind(recv, self.scope, line) == "host"
        if attr in _SYNC_METHODS:
            return (None if on_host else
                    f"`.{attr}()` of a card tensor waits for the card")
        if _non_blocking(node):
            return None
        if on_host and (attr == "cuda"
                        or (attr == "to" and _names_a_device(node))):
            return (f"`.{attr}()` of host data is a blocking copy to the "
                    "card: the host waits for it")
        if attr == "copy_" and not on_host and node.args \
                and _kind(node.args[0], self.scope, line) == "host":
            return ("`.copy_()` of host data into a tensor that may lie on "
                    "the card is a blocking copy: the host waits")
        return None

    def visit_If(self, node: ast.If) -> None:
        self._test(node.test)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._test(node.test)
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._test(node.test)
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._test(node.test)
        self.generic_visit(node)

    def visit_BoolOp(self, node: ast.BoolOp) -> None:
        for v in node.values:
            self._test(v)
        self.generic_visit(node)

    def visit_UnaryOp(self, node: ast.UnaryOp) -> None:
        if isinstance(node.op, ast.Not):
            self._test(node.operand)
        self.generic_visit(node)

    # Nested scopes are visited on their own.
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef


def check_sync(src: SourceFile) -> List[Finding]:
    if src.tree is None:
        return []
    findings: List[Finding] = []
    scopes = [(None, src.tree.body)]
    for node in ast.walk(src.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scopes.append((node, node.body))
        elif isinstance(node, ast.ClassDef):
            scopes.append((None, node.body))
    for fn, body in scopes:
        scope = _Scope(fn, body)
        scope.collect()
        visitor = _SyncVisitor(src, scope, findings)
        for stmt in body:
            visitor.visit(stmt)
    return findings
