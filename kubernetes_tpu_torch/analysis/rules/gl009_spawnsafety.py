"""GL009 — spawn-context hygiene for multiprocess worker entrypoints.

The r18 fleet runs M full scheduler PROCESSES: each worker is spawned
(never forked — a forked child inherits the parent's jax runtime state
and locks mid-flight) and must build its OWN world from the picklable
config it is handed. The failure modes are all silent-until-production:

- a worker reading a module-level MUTABLE binding (dict/list/set) sees
  the child's import-time copy, not the parent's live state — the two
  diverge without an error anywhere;
- `global X` writes in a worker mutate the CHILD's module only; the
  parent keeps its value and the "shared" state quietly forks;
- a worker closing over a module-level LOCK synchronizes nothing: the
  child gets its own unlocked copy (and under spawn, pickling a live
  lock in the config is a crash at start);
- a worker touching a module-level DEVICE value (a jitted callable's
  module-level result, a jnp array) drags the parent's accelerator
  context across the process boundary;
- a bound-method target (`Process(target=self.run)`) pickles the WHOLE
  owner — including every lock attribute it carries — under spawn, and
  shares them for-real under fork: both wrong;
- a nested def / lambda target is not picklable under spawn at all.

Fires on `Process(target=...)` call sites and on the named entrypoint's
offending reads (module constants — ints, strings, tuples, compiled
regexes — are fine; the rule flags only provably mutable/lock/device
bindings). A worker that genuinely wants a module global (a fork-only
tool, a read-only table mutated nowhere) carries
`# graftlint: spawn-ok` naming why the divergence cannot happen.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from kubernetes_tpu_torch.analysis.rules.base import (
    FileContext,
    Finding,
    ProjectIndex,
    dotted,
    last_component,
    lock_ctor_kind,
)

RULE = "GL009"

_MUTABLE_LITERALS = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                     ast.DictComp, ast.SetComp)


def _module_hazards(tree: ast.Module, index: ProjectIndex
                    ) -> Dict[str, str]:
    """name -> hazard description for module-level bindings a spawn
    worker must not rely on."""
    out: Dict[str, str] = {}
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign):
            continue
        val = stmt.value
        why: Optional[str] = None
        if isinstance(val, _MUTABLE_LITERALS):
            why = "module-level mutable state (child gets a copy)"
        elif lock_ctor_kind(val) is not None:
            why = "module-level lock (synchronizes nothing across " \
                  "processes)"
        elif isinstance(val, ast.Call):
            fn = dotted(val.func)
            if fn is not None and (
                    fn.startswith(("jnp.", "jax.", "jax.numpy."))
                    or last_component(fn) in index.jitted_names):
                why = "module-level device value (drags the parent's " \
                      "accelerator context across the spawn boundary)"
        if why is None:
            continue
        for t in stmt.targets:
            if isinstance(t, ast.Name):
                out[t.id] = why
    return out


def _bound_names(fn: ast.AST) -> Set[str]:
    """Names bound locally in `fn` (params, assignments, imports, defs,
    comprehension targets, with/except aliases) — everything else a
    worker loads is a free name resolved in the (child's) module."""
    bound: Set[str] = set()
    args = fn.args
    for a in (args.posonlyargs + args.args + args.kwonlyargs
              + ([args.vararg] if args.vararg else [])
              + ([args.kwarg] if args.kwarg else [])):
        bound.add(a.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) \
                and isinstance(node.ctx, (ast.Store, ast.Del)):
            bound.add(node.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                bound.add((alias.asname or alias.name).split(".")[0])
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            bound.add(node.name)
        elif isinstance(node, ast.ExceptHandler) and node.name:
            bound.add(node.name)
    # a `global X` makes every X a MODULE reference — X is then free no
    # matter how many local stores exist (and those stores are the
    # child-only divergence GL009 flags)
    for node in ast.walk(fn):
        if isinstance(node, ast.Global):
            bound -= set(node.names)
    return bound


def _global_writes(fn: ast.AST):
    """(name, store node) for writes through `global` declarations — a
    spawn worker mutating ITS module copy while the parent keeps the
    old value."""
    declared: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Global):
            declared.update(node.names)
    if not declared:
        return
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store) \
                and node.id in declared:
            yield node.id, node


def _process_targets(ctx: FileContext):
    """(call node, target expr) for every `...Process(target=...)` (or
    first-positional-callable Process(...)) call in the file."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = dotted(node.func)
        if fn is None or last_component(fn) != "Process":
            continue
        target = None
        for kw in node.keywords:
            if kw.arg == "target":
                target = kw.value
        if target is not None:
            yield node, target


def check(ctx: FileContext, index: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    module_defs = {stmt.name: stmt for stmt in ctx.tree.body
                   if isinstance(stmt, ast.FunctionDef)}
    hazards = _module_hazards(ctx.tree, index)

    for call, target in _process_targets(ctx):
        qual_site = ctx.qualname(call)
        tpath = dotted(target)
        if isinstance(target, ast.Lambda):
            findings.append(Finding(
                RULE, ctx.path, target.lineno, target.col_offset,
                "Process target is a lambda — not picklable under the "
                "spawn context; make the worker entrypoint a "
                "module-level def handed a picklable config",
                context=qual_site))
            continue
        if tpath is not None and tpath.startswith("self."):
            klass = ctx.enclosing_class(call)
            locks = index.lock_classes.get(klass.name, {}) \
                if klass is not None else {}
            if locks:
                held = ", ".join(sorted(locks))
                findings.append(Finding(
                    RULE, ctx.path, target.lineno, target.col_offset,
                    f"Process target {tpath} is a bound method — spawn "
                    f"pickles the whole {klass.name} including its live "
                    f"lock(s) ({held}); hand a module-level def a "
                    "picklable config instead",
                    context=qual_site))
            continue
        if not isinstance(target, ast.Name):
            continue
        worker = module_defs.get(target.id)
        if worker is None:
            # a def nested in the calling function is a closure: spawn
            # cannot pickle it, and its captured locals silently fork
            for anc_fn in [a for a in ctx.ancestors(call)
                           if isinstance(a, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))]:
                for sub in ast.walk(anc_fn):
                    if isinstance(sub, ast.FunctionDef) \
                            and sub.name == target.id and sub is not anc_fn:
                        findings.append(Finding(
                            RULE, ctx.path, target.lineno,
                            target.col_offset,
                            f"Process target {target.id} is a nested "
                            "def (a closure) — not picklable under the "
                            "spawn context and its captured state forks "
                            "silently under fork; move the entrypoint "
                            "to module level",
                            context=qual_site))
                        break
                else:
                    continue
                break
            continue
        reported: Set[str] = set()
        for name, node in _global_writes(worker):
            if name in reported:
                continue
            reported.add(name)
            findings.append(Finding(
                RULE, ctx.path, node.lineno, node.col_offset,
                f"spawn worker {worker.name} writes module global "
                f"{name}: the write lands in the CHILD's module only — "
                "parent and worker state silently fork; report results "
                "through the worker's queue/pipe instead",
                context=f"{worker.name}"))
        if not hazards:
            continue
        bound = _bound_names(worker)
        for node in ast.walk(worker):
            if not isinstance(node, ast.Name) \
                    or not isinstance(node.ctx, ast.Load):
                continue
            name = node.id
            if name in bound or name not in hazards \
                    or name in reported:
                continue
            reported.add(name)
            findings.append(Finding(
                RULE, ctx.path, node.lineno, node.col_offset,
                f"spawn worker {worker.name} reads {name}: "
                f"{hazards[name]} — pass it through the worker's "
                "picklable config (or justify with `# graftlint: "
                "spawn-ok`)",
                context=f"{worker.name}",
            ))
    return findings
