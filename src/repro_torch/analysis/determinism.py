"""Determinism checker for bitwise-parity modules.

The repo's headline guarantee is that ids and ``SearchStats`` are bitwise
identical across the numpy/torch/local/process/socket planes. That only holds
if the modules those planes share never consult ambient nondeterminism.
Three rules, applied to the configured parity scope (``core/``,
``kernels/``, the serverless choreography — see the runner):

* ``wallclock`` — calls to ``time.time`` / ``time.monotonic`` /
  ``time.perf_counter`` (and their ``_ns`` variants). Wall-clock belongs in
  trace/measurement code; a site that only feeds measured timelines carries
  an ``# squash: ignore[wallclock] -- ...`` pragma saying so.
* ``unseeded-rng`` — module-level numpy RNG (``np.random.rand`` etc. — the
  legacy global stream), ``np.random.seed`` (mutates that global stream),
  and bare ``random.*`` module functions. Torch's default generator is the
  port's counterpart of the legacy numpy stream: ``torch.manual_seed`` /
  ``torch.seed`` / ``torch.cuda.manual_seed(_all)`` (which mutate it), the
  sampling calls ``torch.rand/randn/randint/randperm/normal/bernoulli/
  multinomial`` and their ``*_like`` forms, and the in-place
  ``Tensor.uniform_/normal_/random_/bernoulli_/exponential_``, each of the
  last two kinds unless given ``generator=``. Seeded constructions
  (``np.random.default_rng(seed)``, ``random.Random(seed)``,
  ``np.random.Generator``/``SeedSequence``, a ``torch.Generator`` passed as
  ``generator=``) are the sanctioned forms.
* ``set-iteration`` — ``for`` loops over set displays/comprehensions or
  ``set(...)`` calls, and ``list()``/``tuple()``/``enumerate()`` over the
  same: set iteration order is salted per process, so any result ordering
  derived from it diverges across workers. ``sorted(set(...))`` is fine.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.source import SourceFile

__all__ = ["check_determinism"]

_WALLCLOCK_FNS = {
    "time", "monotonic", "perf_counter", "time_ns", "monotonic_ns",
    "perf_counter_ns", "clock_gettime",
}
_NP_NAMES = {"np", "numpy"}
_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64",
                 "Philox", "BitGenerator"}
_RANDOM_MODULE_OK = {"Random", "SystemRandom"}
_TORCH_SEEDERS = {("torch", "manual_seed"), ("torch", "seed"),
                  ("torch", "cuda", "manual_seed"),
                  ("torch", "cuda", "manual_seed_all")}
_TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "normal",
                   "bernoulli", "multinomial", "rand_like", "randn_like",
                   "randint_like"}
_TENSOR_SAMPLERS = {"uniform_", "normal_", "random_", "bernoulli_",
                     "exponential_"}


def _attr_chain(node: ast.AST) -> Optional[List[str]]:
    """``np.random.rand`` → ["np", "random", "rand"]; None if not a chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id == "set":
        return True
    # set ops on set exprs: (a_set | b_set) — only literal-rooted ones.
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.BitOr,
                                                            ast.BitAnd,
                                                            ast.Sub)):
        return _is_set_expr(node.left) or _is_set_expr(node.right)
    return False


class _DetVisitor(ast.NodeVisitor):
    def __init__(self, src: SourceFile):
        self.src = src
        self.findings: List[Finding] = []

    def _flag(self, node: ast.AST, rule: str, msg: str) -> None:
        self.findings.append(Finding(self.src.rel, node.lineno, rule, msg))

    def visit_Call(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func)
        if chain:
            # time.time() / time.perf_counter() ...
            if len(chain) == 2 and chain[0] == "time" \
                    and chain[1] in _WALLCLOCK_FNS:
                self._flag(node, "wallclock",
                           f"`time.{chain[1]}()` in a bitwise-parity module "
                           "(confine wall-clock to trace/measurement code)")
            # np.random.<legacy fn>() — the unseeded global stream.
            elif len(chain) == 3 and chain[0] in _NP_NAMES \
                    and chain[1] == "random" and chain[2] not in _NP_RANDOM_OK:
                self._flag(node, "unseeded-rng",
                           f"`{chain[0]}.random.{chain[2]}()` uses numpy's "
                           "global RNG stream; use "
                           "`np.random.default_rng(seed)`")
            # random.<fn>() — the stdlib global stream.
            elif len(chain) == 2 and chain[0] == "random" \
                    and chain[1] not in _RANDOM_MODULE_OK:
                self._flag(node, "unseeded-rng",
                           f"`random.{chain[1]}()` uses the stdlib global "
                           "RNG; use a seeded `random.Random(seed)` instance")
            # torch.manual_seed() ... — mutates torch's default generator.
            elif tuple(chain) in _TORCH_SEEDERS:
                self._flag(node, "unseeded-rng",
                           f"`{'.'.join(chain)}()` mutates torch's default "
                           "generator; pass a seeded `torch.Generator` as "
                           "`generator=`")
            # torch.randn(...) without generator= — the default generator.
            elif len(chain) == 2 and chain[0] == "torch" \
                    and chain[1] in _TORCH_SAMPLERS \
                    and not _has_generator(node):
                self._flag(node, "unseeded-rng",
                           f"`torch.{chain[1]}()` without `generator=` draws "
                           "from torch's default generator")
        # x.normal_() without generator= — the default generator, in place.
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _TENSOR_SAMPLERS \
                and not _has_generator(node):
            self._flag(node, "unseeded-rng",
                       f"`.{node.func.attr}()` without `generator=` draws "
                       "from torch's default generator")
        # list(set(...)) / tuple(set(...)) / enumerate(set(...))
        if isinstance(node.func, ast.Name) \
                and node.func.id in ("list", "tuple", "enumerate") \
                and node.args and _is_set_expr(node.args[0]):
            self._flag(node, "set-iteration",
                       f"`{node.func.id}()` over a set has salted, "
                       "process-dependent order; wrap in `sorted(...)`")
        self.generic_visit(node)

    def _check_iter(self, node) -> None:
        if _is_set_expr(node.iter):
            self._flag(node, "set-iteration",
                       "iterating a set has salted, process-dependent "
                       "order; wrap in `sorted(...)`")

    def visit_For(self, node: ast.For) -> None:
        self._check_iter(node)
        self.generic_visit(node)

    def visit_AsyncFor(self, node: ast.AsyncFor) -> None:
        self._check_iter(node)
        self.generic_visit(node)

    def visit_comprehension(self, node: ast.comprehension) -> None:
        if _is_set_expr(node.iter):
            self.findings.append(Finding(
                self.src.rel, node.iter.lineno, "set-iteration",
                "comprehension over a set has salted, process-dependent "
                "order; wrap in `sorted(...)`"))
        self.generic_visit(node)


def check_determinism(src: SourceFile) -> List[Finding]:
    if src.tree is None:
        return []
    visitor = _DetVisitor(src)
    visitor.visit(src.tree)
    return visitor.findings
