"""GL005 — snapshot dynamic-row writes without a paired generation bump.

The tensor snapshot is a MIRROR: every consumer (device upload dirt,
encoding caches keyed on version/vocab_gen/labels_gen, the hinted refresh)
trusts that any in-place write to a dynamic array was announced — a
`self.dirty` note, a `version`/`vocab_gen`/`labels_gen` bump, or the
`apply_assume_delta` generation sync. A row write without the announcement
is the worst kind of bug: everything keeps working on the stale device
copy until a placement lands on capacity that is not there.

Fires on: subscript stores / `np.<ufunc>.at` / `.fill()` targeting an
attribute path whose final component is one of the snapshot's dynamic
arrays (DYNAMIC_ATTRS — `requested`, `nonzero`, `pod_count`,
`port_bitmap`, `_raw_dyn`, volume presence, `labels`, `image_sizes`),
alias-resolved through locals (`requested = self.requested`), in a
function that touches NEITHER `<root>.dirty` NOR a generation counter of
the same root object.

Private helpers whose CALLER owns the announcement annotate the def with
`# graftlint: gen-ok — <who bumps>`.
"""

from __future__ import annotations

import ast
from typing import List, Set

from kubernetes_tpu_torch.analysis.rules.base import (
    DYNAMIC_ATTRS,
    FileContext,
    Finding,
    ProjectIndex,
    dotted,
    functions_of,
    last_component,
    local_aliases,
    mutations_in,
)

RULE = "GL005"

_GEN_ATTRS = ("version", "vocab_gen", "labels_gen", "dirty")


def _announced_roots(fn: ast.AST) -> Set[str]:
    """Root names whose .dirty / generation counters are touched in fn."""
    roots: Set[str] = set()
    for node in ast.walk(fn):
        p = dotted(node) if isinstance(node, ast.Attribute) else None
        if p is None:
            continue
        parts = p.split(".")
        for i, comp in enumerate(parts[1:], start=1):
            if comp in _GEN_ATTRS:
                roots.add(".".join(parts[:i]))
                break
    return roots


def _classes_with_machinery(ctx: FileContext) -> set:
    """ClassDef nodes that demonstrably carry the mirror's generation
    machinery (an assignment to `self.dirty` anywhere in their body) —
    only THEIR dynamic-attr writes are in-scope. A Pod's `labels` dict or
    a PodBatch's pod-side `nonzero` share attribute names with the
    snapshot but have no dirty/version contract to violate."""
    out = set()
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, (ast.Assign, ast.AugAssign)):
                targets = sub.targets if isinstance(sub, ast.Assign) \
                    else [sub.target]
                if any(dotted(t) == "self.dirty" for t in targets):
                    out.add(node)
                    break
    return out


def _in_scope(path: str, fn, ctx: FileContext, machinery: set) -> bool:
    root = path.partition(".")[0]
    if root == "self":
        return ctx.enclosing_class(fn) in machinery
    return root in ("snap", "snapshot") or ".snapshot." in path \
        or path.startswith("self.snapshot.")


def check(ctx: FileContext, index: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    machinery = _classes_with_machinery(ctx)
    for fn in functions_of(ctx.tree):
        aliases = local_aliases(fn)
        muts = [(p, ln) for p, ln in mutations_in(fn, aliases)
                if "." in p and last_component(p) in DYNAMIC_ATTRS
                and _in_scope(p, fn, ctx, machinery)]
        if not muts:
            continue
        announced = _announced_roots(fn)
        for path, line in muts:
            root = path.rsplit(".", 1)[0]
            if root in announced:
                continue
            findings.append(Finding(
                RULE, ctx.path, line, 0,
                f"in-place write to dynamic snapshot row {path} with no "
                f"paired announcement ({root}.dirty note or version/"
                "vocab_gen/labels_gen bump) in this function — every "
                "generation-keyed consumer keeps reading the stale "
                "mirror (apply_assume_delta contract); announce it or "
                "mark the def `# graftlint: gen-ok` naming the caller "
                "that does",
                context=ctx.qualname(fn)))
    return findings
