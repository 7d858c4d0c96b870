"""GL007 — torn read/write: guarded-field access outside the guard.

The r12 "metrics torn-read audit" class, machine-checked: a class keeps
a field's writers under `with self._lock:` so multi-word updates commit
atomically (count and sum advance together; a deque mutates while a
scrape iterates) — and then one accessor reads the field bare, seeing a
half-committed update. The audit that caught Histogram's (count, sum)
tear was a hand pass; this rule is that pass, run on every file forever.

Per class that owns at least one lock attribute: a field QUALIFIES as
lock-guarded when at least one write runs under the class's own lock and
guarded writes are not outnumbered by unguarded ones ("predominantly
guarded" — one stray write must not demote the field, it IS the bug).
Every access (read or write) to a qualifying field outside any lock
region then fires. Guarded contexts:

- lexically inside `with self.<lock>:` for any lock attr of the class;
- a method named `*_locked` — the repo's caller-holds-the-lock
  convention (the runtime half verifies it: those helpers carry
  `lockcheck.assert_held`, checked under GRAFT_LOCKCHECK=1);
- `__init__`/`__new__`, where no second thread can hold a reference yet
  (accesses there are also never REPORTED, same reasoning).

Single-threaded-by-design accessors (a loop-owned field that shares a
name, a stats read that tolerates staleness) carry
`# graftlint: torn-ok` naming why the tear cannot happen or cannot hurt.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Tuple

from kubernetes_tpu_torch.analysis.rules.base import (
    MUTATING_METHODS,
    FileContext,
    Finding,
    ProjectIndex,
    class_lock_attrs,
    dotted,
)

RULE = "GL007"

_BIRTH_METHODS = ("__init__", "__new__")


def _method_of(ctx: FileContext, node: ast.AST, klass: ast.ClassDef):
    """The OUTERMOST function between `node` and `klass` — the method
    whose name carries the _locked / __init__ conventions even when the
    access sits in a nested helper."""
    method = None
    for anc in ctx.ancestors(node):
        if anc is klass:
            break
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            method = anc
    return method


def _under_lock(ctx: FileContext, node: ast.AST, klass: ast.ClassDef,
                locks: Dict[str, str]) -> bool:
    for anc in ctx.ancestors(node):
        if anc is klass:
            break
        if isinstance(anc, ast.With):
            for item in anc.items:
                p = dotted(item.context_expr)
                if p is not None and p.startswith("self.") \
                        and p.split(".", 1)[1] in locks:
                    return True
    return False


def _is_write(ctx: FileContext, attr: ast.Attribute) -> bool:
    if isinstance(attr.ctx, (ast.Store, ast.Del)):
        return True
    parent = ctx.parent(attr)
    if isinstance(parent, ast.Subscript) \
            and isinstance(parent.ctx, (ast.Store, ast.Del)):
        return True  # self.f[i] = v / del self.f[k] / self.f[i] += v
    if isinstance(parent, ast.Attribute) \
            and parent.attr in MUTATING_METHODS:
        gp = ctx.parent(parent)
        if isinstance(gp, ast.Call) and gp.func is parent:
            return True  # self.f.append(v) and friends
    return False


def check(ctx: FileContext, index: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    for klass in ast.walk(ctx.tree):
        if not isinstance(klass, ast.ClassDef):
            continue
        locks = class_lock_attrs(klass)
        if not locks:
            continue
        # accesses[field] = [(attr node, is_write, guarded, in_birth)]
        accesses: Dict[str, List[Tuple[ast.Attribute, bool, bool, bool]]] \
            = {}
        for node in ast.walk(klass):
            if not isinstance(node, ast.Attribute):
                continue
            if not (isinstance(node.value, ast.Name)
                    and node.value.id == "self"):
                continue
            field = node.attr
            if field in locks:
                continue
            method = _method_of(ctx, node, klass)
            if method is None:
                continue  # class-level statement, construction-time
            in_birth = method.name in _BIRTH_METHODS
            guarded = (in_birth or method.name.endswith("_locked")
                       or _under_lock(ctx, node, klass, locks))
            accesses.setdefault(field, []).append(
                (node, _is_write(ctx, node), guarded, in_birth))

        for field, acc in sorted(accesses.items()):
            wg = sum(1 for _n, w, g, b in acc if w and g and not b)
            wu = sum(1 for _n, w, g, _b in acc if w and not g)
            if wg < 1 or wu > wg:
                continue  # not a (predominantly) lock-guarded field
            for node, is_write, guarded, in_birth in acc:
                if guarded or in_birth:
                    continue
                kind = "write to" if is_write else "read of"
                findings.append(Finding(
                    RULE, ctx.path, node.lineno, node.col_offset,
                    f"torn {kind} lock-guarded field self.{field}: "
                    f"writes in {klass.name} run under the class lock, "
                    "but this access holds none — it can observe (or "
                    "commit) a half-applied update; take the lock, move "
                    "it into a *_locked helper, or bless a benign race "
                    "with `# graftlint: torn-ok`",
                    context=ctx.qualname(node) or klass.name))
    return findings
