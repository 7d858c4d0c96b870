"""GL001 — zero-copy aliasing of a mutated host buffer.

The r07/r08 race class: the CPU backend zero-copies aligned numpy uploads,
so `jnp.asarray(buf)` hands the device a VIEW of `buf`; an in-place write
to `buf` while an async wave still reads the alias corrupts placements
silently. Three provable shapes fire:

1. same-function: `jnp.asarray(P)` followed (later in the same function)
   by an in-place mutation of the same dotted path P;
2. class-scoped: `jnp.asarray(P)` in one method of a class while another
   method of the SAME class mutates P in place — the attribute's lifetime
   spans calls, so upload/mutate ordering is not decidable and the alias
   must be assumed live (`enc.committed_nodes` vs the harvest fold was
   exactly this);
3. `# graftlint: copy-required` contract seams: the pragma'd statement
   must upload through a copying constructor (`jnp.array`, `.copy()`,
   `np.ascontiguousarray`, `sanitize.upload_copied`) — a later
   "optimization" to `jnp.asarray` fires the rule instead of shipping the
   r07 race again.

The fix idiom — `jnp.array(...)` / `.copy()` / `sanitize.upload_copied` —
never fires: only `jnp.asarray` of a PLAIN dotted path is ever suspect
(call/subscript args are skipped; advanced indexing already copies).
"""

from __future__ import annotations

import ast
from typing import List

from kubernetes_tpu_torch.analysis.rules.base import (
    FileContext,
    Finding,
    ProjectIndex,
    chain_without_root,
    dotted,
    functions_of,
    local_aliases,
    mutations_in,
    resolve,
)

RULE = "GL001"

_ASARRAY = ("jnp.asarray", "jax.numpy.asarray", "upload_frozen",
            "sanitize.upload_frozen")
_COPYING = ("jnp.array", "jax.numpy.array", "np.array", "numpy.array",
            "np.ascontiguousarray", "numpy.ascontiguousarray",
            "upload_copied", "copy", "deepcopy")


def _asarray_sites(fn, aliases):
    """(resolved dotted path, Call node, spelling) for every zero-copy
    upload of a plain dotted path: jnp.asarray AND sanitize.upload_frozen
    (which is jnp.asarray underneath — with GRAFT_SANITIZE unset nothing
    seals the source, so mutating a frozen-seam buffer is the same silent
    race in production)."""
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and node.args:
            fname = dotted(node.func)
            if fname in _ASARRAY:
                p = resolve(dotted(node.args[0]), aliases)
                if p:
                    out.append((p, node, fname))
    return out


def check(ctx: FileContext, index: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []

    # -- shapes 1 + 2: upload-vs-mutation matching -------------------------
    per_fn = {}
    for fn in functions_of(ctx.tree):
        aliases = local_aliases(fn)
        per_fn[fn] = (_asarray_sites(fn, aliases),
                      mutations_in(fn, aliases))

    for fn, (uploads, muts) in per_fn.items():
        for path, call, spelling in uploads:
            hit = None
            for mpath, mline in muts:
                if mpath == path and mline > call.lineno:
                    hit = (mpath, "later in this function")
                    break
            if hit is None and "." in path:
                klass = ctx.enclosing_class(fn)
                if klass is not None:
                    chain = chain_without_root(path)
                    for ofn, (_u, omuts) in per_fn.items():
                        if ofn is fn or ctx.enclosing_class(ofn) is not klass:
                            continue
                        for mpath, _mline in omuts:
                            if "." in mpath \
                                    and chain_without_root(mpath) == chain:
                                hit = (mpath, f"in {ctx.qualname(ofn)}")
                                break
                        if hit:
                            break
            if hit is not None:
                # no line numbers in the message: it feeds the baseline
                # fingerprint, which must survive unrelated line drift
                mpath, where = hit
                findings.append(Finding(
                    RULE, ctx.path, call.lineno, call.col_offset,
                    f"{spelling}({path}) zero-copy aliases a buffer "
                    f"mutated in place ({mpath} {where}); "
                    "an async wave reading the alias races the write — "
                    "use jnp.array / .copy() / sanitize.upload_copied",
                    context=ctx.qualname(fn)))

    # -- shape 3: copy-required contract seams -----------------------------
    # SIMPLE statements only: a compound statement (def/class/with) spans
    # its whole body, which would smear one seam's pragma over unrelated
    # uploads
    for stmt in ast.walk(ctx.tree):
        if not isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign,
                                 ast.Expr, ast.Return)):
            continue
        lo = stmt.lineno
        hi = stmt.end_lineno or lo
        if "copy-required" not in ctx.tags_for_span(lo, hi):
            continue
        calls = [n for n in ast.walk(stmt) if isinstance(n, ast.Call)]
        bad = [n for n in calls if dotted(n.func) in _ASARRAY]
        names = {dotted(n.func) for n in calls} - {None}
        copying = any(nm in _COPYING or nm.rsplit(".", 1)[-1] in _COPYING
                      for nm in names)
        anchor = ctx.enclosing_function(stmt)
        qual = ctx.qualname(anchor) if anchor is not None else "<module>"
        if bad:
            findings.append(Finding(
                RULE, ctx.path, bad[0].lineno, bad[0].col_offset,
                "copy-required seam uploads via jnp.asarray (zero-copy "
                "alias) — this statement is contractually a COPY "
                "(jnp.array / sanitize.upload_copied)",
                context=qual))
        elif not copying:
            findings.append(Finding(
                RULE, ctx.path, lo, stmt.col_offset,
                "copy-required pragma but no copying upload "
                "(jnp.array / .copy() / np.ascontiguousarray / "
                "sanitize.upload_copied) on this statement — stale pragma "
                "or unprotected seam",
                context=qual))
    return findings
