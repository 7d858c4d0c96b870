"""GL004 — tracer leak out of a traced scope.

Inside a jit-traced function, values are abstract tracers; storing one on
`self`, a global, or any host container outlives the trace and either
poisons later eager code with a `TracerLeakError` far from the cause, or
(worse) silently caches trace-time garbage. Traced scopes are:

- defs decorated `@jax.jit` / `@functools.partial(jax.jit, ...)`;
- defs wrapped at module level (`X = jax.jit(f)` marks `f`);
- nested defs handed to `lax.while_loop` / `lax.scan` / `lax.cond` /
  `vmap` / `grad` etc. INSIDE a traced scope (the `cond`/`body` pair of
  waves_loop) — their bodies trace with the parent.

Flagged inside those scopes (including nested defs):
- any attribute store (`obj.x = ...`, `self.x += ...`);
- any subscript store or mutating-method call (`.append`/`.update`/...)
  whose base name is NOT bound locally in the traced scope — writes into
  module globals or closure state;
- assignments to names declared `global`/`nonlocal`.
"""

from __future__ import annotations

import ast
from typing import List, Set

from kubernetes_tpu_torch.analysis.rules.base import (
    TRACE_CONSUMERS,
    FileContext,
    Finding,
    ProjectIndex,
    _is_jit_expr,
    dotted,
    functions_of,
    last_component,
)

RULE = "GL004"

_CONTAINER_MUTATORS = frozenset({"append", "extend", "add", "update",
                                 "insert", "setdefault", "pop", "remove",
                                 "clear"})


def _local_bindings(fn: ast.AST) -> Set[str]:
    """Names bound inside `fn`: params, assignment targets, for-targets,
    withitems, comprehension targets, nested def/class names."""
    names: Set[str] = set()
    a = fn.args
    for arg in (a.posonlyargs + a.args + a.kwonlyargs
                + ([a.vararg] if a.vararg else [])
                + ([a.kwarg] if a.kwarg else [])):
        names.add(arg.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            names.add(node.name)
    return names


def _traced_functions(ctx: FileContext, index: ProjectIndex):
    """Traced scopes in this file — nested defs handed to
    lax.while_loop/scan/... inside a traced scope need no separate entry
    (ast.walk over the parent already covers their bodies); TRACE_CONSUMERS
    membership exists so helpers traced OUTSIDE any jit (a bare vmap at
    module level) still get a scope of their own. One tree walk total."""
    consumed = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            fname = dotted(node.func)
            if fname and last_component(fname) in TRACE_CONSUMERS:
                consumed.update(a.id for a in node.args
                                if isinstance(a, ast.Name))
    out = []
    for fn in functions_of(ctx.tree):
        if any(_is_jit_expr(d) for d in fn.decorator_list):
            out.append(fn)
        elif fn.name in (index.traced_defs | consumed) \
                and ctx.enclosing_function(fn) is None:
            out.append(fn)
    return out


def check(ctx: FileContext, index: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    for fn in _traced_functions(ctx, index):
        local = _local_bindings(fn)
        declared: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, (ast.Global, ast.Nonlocal)):
                declared.update(node.names)
        for node in ast.walk(fn):
            tgt = None
            kind = None
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Attribute):
                        tgt = dotted(t) or f"<expr>.{t.attr}"
                        kind = "attribute store"
                    elif isinstance(t, ast.Subscript):
                        base = t.value
                        p = dotted(base)
                        root = p.partition(".")[0] if p else None
                        if root is not None and root not in local:
                            tgt = f"{p}[...]"
                            kind = "subscript store into non-local"
                    elif isinstance(t, ast.Name) and t.id in declared:
                        tgt = t.id
                        kind = "global/nonlocal store"
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _CONTAINER_MUTATORS:
                p = dotted(node.func.value)
                root = p.partition(".")[0] if p else None
                if root is not None and root not in local:
                    tgt = f"{p}.{node.func.attr}(...)"
                    kind = "container mutation of non-local"
            if tgt is not None:
                findings.append(Finding(
                    RULE, ctx.path, node.lineno, node.col_offset,
                    f"{kind} ({tgt}) inside traced scope "
                    f"'{fn.name}' — a tracer stored here outlives the "
                    "trace (leak) and the side effect replays only at "
                    "trace time; return the value through the carry "
                    "instead",
                    context=ctx.qualname(fn)))
    return findings
