"""GL006 — lock-order cycles (deadlock potential) over the project graph.

The engine is a concurrent system end to end: the coalescer's CV, the
cache's mutex, the telemetry registry's registration lock, the ledger's
own lock — and a deadlock needs nothing more than two call paths
acquiring two of them in opposite orders. This rule builds the
project-wide acquisition graph: an edge A -> B for every `with` that
acquires lock B lexically inside a `with` holding lock A (class-scoped
identity, like GL001's lifetimes: `self._lock` in class C is the lock
"C._lock" on EVERY instance and call path). Two finding shapes:

1. cycle: an observed edge whose reverse is reachable through the graph
   (observed elsewhere, or declared) — the classic ABBA deadlock, fired
   at every observed edge on the cycle so each inversion site carries
   its own justification or fix;
2. self-deadlock: re-acquiring the SAME non-reentrant Lock expression
   inside its own `with` — blocks forever, no second thread needed.

`# graftlint: lock-order(A,B,...)` anywhere in the linted set DECLARES
the blessed order (consecutive pairs become graph edges with no site),
so a later inversion anywhere fires even before the reverse `with`
nesting is ever written — the machine-checked form of the r12 "leader
holds the CV, never the backend lock while parked" prose. Lock IDs are
"<ClassName>.<attr>" for instance locks and "<module>.<name>" for
module-level locks — the SAME names handed to the lockcheck factories,
so the static graph and the GRAFT_LOCKCHECK runtime checker speak one
namespace.

Lexical nesting within one function is the provable shape; orders built
across call boundaries (helper acquires B, caller holds A) are the
runtime checker's half. A Condition's wait() releases its lock while
parked — the lexical region still counts as held, which is conservative
in exactly the direction a deadlock analysis wants.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.analysis.rules.base import (
    FileContext,
    Finding,
    ProjectIndex,
    dotted,
    functions_of,
    local_aliases,
    lock_ctor_kind,
    module_id,
    resolve,
)

RULE = "GL006"

_DECL_RE = re.compile(r"#.*graftlint:\s*lock-order\(([^)]*)\)")


def _lock_id(ctx: FileContext, index: ProjectIndex, fn: ast.AST,
             expr: ast.AST, aliases: Dict[str, str]
             ) -> Optional[Tuple[str, str, str]]:
    """(lock id, kind, resolved expr) for a with-item context expression
    that provably names a lock; None otherwise. Resolvable shapes:
    `self.<attr>` where the enclosing class binds <attr> to a lock ctor,
    a bare/aliased name bound to a lock ctor in this function, and a
    module-level lock of this file."""
    path = resolve(dotted(expr), aliases)
    if path is None:
        return None
    if path.startswith("self.") and path.count(".") == 1:
        attr = path.split(".", 1)[1]
        klass = ctx.enclosing_class(fn)
        if klass is not None:
            kind = index.lock_classes.get(klass.name, {}).get(attr)
            if kind is not None:
                return f"{klass.name}.{attr}", kind, path
        return None
    if "." not in path:
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) \
                    and any(isinstance(t, ast.Name) and t.id == path
                            for t in node.targets):
                kind = lock_ctor_kind(node.value)
                if kind is not None:
                    qual = ctx.qualname(fn)
                    return f"{qual}.{path}", kind, path
        mid = f"{module_id(ctx.path)}.{path}"
        kind = index.module_locks.get(mid)
        if kind is not None:
            return mid, kind, path
    return None


def _collect(ctx: FileContext, index: ProjectIndex):
    """(edges, reacquires) for one file: edges maps (held id, acquired
    id) -> [(qualname, line)], reacquires lists provable same-expression
    re-acquisitions of a non-reentrant Lock."""
    edges: Dict[Tuple[str, str], List[Tuple[str, int]]] = {}
    reacquires: List[Tuple[str, int, str]] = []

    for fn in functions_of(ctx.tree):
        aliases = local_aliases(fn)
        qual = ctx.qualname(fn)

        def visit(node: ast.AST, held: List[Tuple[str, str, str]]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return  # nested defs run on their own call stack
            if isinstance(node, (ast.With, ast.AsyncWith)):
                acquired = []
                for item in node.items:
                    lid = _lock_id(ctx, index, fn, item.context_expr,
                                   aliases)
                    if lid is None:
                        continue
                    ident, kind, expr_s = lid
                    for hid, hkind, hexpr in held:
                        if hid == ident:
                            # same LOCK NAME: orderable only when it is
                            # provably the same object (same resolved
                            # expression) — then a plain Lock deadlocks
                            # against itself right here
                            if kind == "lock" and hexpr == expr_s:
                                reacquires.append((qual, node.lineno,
                                                   ident))
                            continue
                        edges.setdefault((hid, ident), []).append(
                            (qual, node.lineno))
                    acquired.append((ident, kind, expr_s))
                inner = held + acquired
                for child in node.body:
                    visit(child, inner)
                return
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for child in ast.iter_child_nodes(fn):
            visit(child, [])
    return edges, reacquires


def prepare(contexts: List[FileContext], index: ProjectIndex) -> None:
    """Pass-1.5 hook (lint.run_paths): fold every file's declarations and
    observed edges into the project-wide graph BEFORE any check() runs,
    so cycles spanning files fire at each participating site."""
    for ctx in contexts:
        for m in _DECL_RE.finditer(ctx.source):
            ids = [s.strip() for s in m.group(1).split(",") if s.strip()]
            for a, b in zip(ids, ids[1:]):
                index.lock_decls[(a, b)] = ctx.path
        edges, _re = _collect(ctx, index)
        for key, sites in edges.items():
            index.lock_edges.setdefault(key, []).extend(
                (ctx.path, q, ln) for q, ln in sites)


def _adjacency(index: ProjectIndex) -> Dict[str, List[str]]:
    adj: Dict[str, List[str]] = {}
    for a, b in list(index.lock_edges) + list(index.lock_decls):
        adj.setdefault(a, []).append(b)
    return adj


def _find_path(adj: Dict[str, List[str]], src: str, dst: str
               ) -> Optional[List[str]]:
    """A path src -> ... -> dst through the graph, or None."""
    seen = {src}
    stack = [(src, [src])]
    while stack:
        cur, path = stack.pop()
        for nxt in adj.get(cur, ()):
            if nxt == dst:
                return path + [nxt]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _provenance(index: ProjectIndex, a: str, b: str) -> str:
    sites = index.lock_edges.get((a, b))
    if sites:
        path, qual, _ln = sites[0]
        return f"observed in {qual or '<module>'} ({path})"
    decl = index.lock_decls.get((a, b))
    return f"declared lock-order ({decl})" if decl else "declared"


def check(ctx: FileContext, index: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    edges, reacquires = _collect(ctx, index)

    for qual, line, ident in reacquires:
        findings.append(Finding(
            RULE, ctx.path, line, 0,
            f"re-acquiring non-reentrant lock '{ident}' inside its own "
            "`with` — this thread deadlocks against itself; use an "
            "RLock, or split the _locked helper the outer holder calls",
            context=qual))

    adj = _adjacency(index)
    for (a, b), sites in sorted(edges.items()):
        back = _find_path(adj, b, a)
        if back is None:
            continue
        hops = " -> ".join(f"'{x}'" for x in back)
        why = "; ".join(_provenance(index, x, y)
                        for x, y in zip(back, back[1:]))
        for qual, line in sites:
            findings.append(Finding(
                RULE, ctx.path, line, 0,
                f"lock-order cycle: '{a}' is held while acquiring "
                f"'{b}', but the reverse path {hops} exists ({why}) — "
                "two threads on these paths deadlock; acquire in one "
                "blessed order (declare it with `# graftlint: "
                "lock-order(...)`) or drop one lock before the other",
                context=qual))
    return findings
