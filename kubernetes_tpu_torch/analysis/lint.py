"""graftlint engine: file discovery, two-pass analysis, pragmas, baseline.

Pure stdlib + AST — importing this module never imports jax/numpy, so the
tier-1 clean-tree gate and `bench.py --lint-gate` cost milliseconds and
run identically on a box with no accelerator.

Pass 1 builds the cross-file ProjectIndex (which bare names are jitted
callables anywhere in the set — GL002's taint sources and GL003's
call-site registry). Pass 2 runs every rule per file. Suppression layers,
in order:

1. pragmas — `# graftlint: <tag>` on the finding's statement, the line
   above it, or the enclosing `def` line (see rules/base.py tag table;
   `disable=GL00x` works for every rule). Pragmas are the PREFERRED
   suppression: the justification lives next to the code it blesses.
2. baseline — a JSON file of fingerprints (`--write-baseline`) for
   findings inherited from before the rule existed. Fingerprints hash
   (rule, path, enclosing qualname, message), not line numbers, so edits
   above a baselined finding don't un-suppress it. The shipped tree
   carries an EMPTY baseline: every finding is either fixed or pragma'd.

PyTorch port of kubernetes_tpu/analysis/lint.py, with its rules copied
unchanged. Departures: `lint_gate()` and the CLI lint the
kubernetes_tpu_torch package directory by default, the baseline names the
port's CLI, and `rules/base.module_id` folds the `kubernetes_tpu_torch`
prefix. The package's `__init__` imports torch, so importing this module
does too; the analysis itself stays pure AST.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.analysis.rules import (
    ALL_RULES,
    RULE_IDS,
    FileContext,
    Finding,
    ProjectIndex,
)

__all__ = ["Finding", "run_paths", "lint_gate", "load_baseline",
           "write_baseline", "collect_files", "RULE_IDS"]

_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "node_modules",
              "build", "dist"}


def collect_files(paths: Sequence[str]) -> List[str]:
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS)
                files.extend(os.path.join(root, n) for n in sorted(names)
                             if n.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    return files


# the checkout that contains this very module — the stable anchor for
# fingerprint paths (parent of the kubernetes_tpu_torch package dir)
_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


def _relpath(path: str) -> str:
    """Repo-stable path form for fingerprints and reports. Files inside
    this checkout anchor to the REPO ROOT, so the same file fingerprints
    the same whether linted as `kubernetes_tpu_torch/`,
    `./kubernetes_tpu_torch/`, or
    the absolute package dir (lint_gate's default), and regardless of the
    CWD the linter runs from — else a baseline written one way suppresses
    nothing the other way. Out-of-tree files (fixture dirs) fall back to
    CWD-relative, else normalized as given."""
    ap = os.path.abspath(path)
    for root in (_REPO_ROOT, os.getcwd()):
        if ap == root or ap.startswith(root + os.sep):
            return os.path.relpath(ap, root)
    return os.path.normpath(path)


def run_paths(paths: Sequence[str],
              baseline: Optional[Dict[str, str]] = None,
              rules: Optional[Iterable[str]] = None,
              ) -> Tuple[List[Finding], int, List[str]]:
    """Lint every .py under `paths`. Returns (unsuppressed findings sorted
    by location, count suppressed by the baseline, parse-error notes).
    Pragma-suppressed findings are never materialized at all."""
    want = set(rules) if rules is not None else set(RULE_IDS)
    contexts: List[FileContext] = []
    errors: List[str] = []
    # validate per path: a typo'd/renamed path must FAIL the gate even when
    # OTHER paths yield files — else a CI arg list quietly stops covering a
    # since-renamed subtree while the gate keeps passing
    files: List[str] = []
    seen = set()
    for p in paths or ("<none>",):
        sub = collect_files([p])
        if not sub:
            errors.append(f"no Python files found under: {p}")
        files.extend(f for f in sub if f not in seen)
        seen.update(sub)
    index = ProjectIndex()
    for f in files:
        try:
            with open(f, "r", encoding="utf-8") as fh:
                src = fh.read()
            ctx = FileContext(_relpath(f), src)
        except (OSError, SyntaxError, ValueError) as e:
            errors.append(f"{f}: {e}")
            continue
        contexts.append(ctx)
        index.scan(ctx.tree, ctx.path)
    # pass 1.5: project-wide rule state (GL006's lock graph) — built over
    # the FULL set before any per-file check runs, so cross-file cycles
    # fire at every participating site
    for mod in ALL_RULES:
        prep = getattr(mod, "prepare", None)
        if prep is not None and mod.RULE in want:
            prep(contexts, index)

    findings: List[Finding] = []
    suppressed = 0
    base = baseline or {}
    for ctx in contexts:
        by_line = _nodes_by_line(ctx)
        for mod in ALL_RULES:
            if mod.RULE not in want:
                continue
            for fd in mod.check(ctx, index):
                # rules anchor findings on nodes; re-check pragma scope via
                # the reported line's nodes (one walk per file, not per
                # finding)
                if any(ctx.suppressed(fd.rule, n)
                       for n in by_line.get(fd.line, ())):
                    continue
                if fd.fingerprint() in base:
                    suppressed += 1
                    continue
                findings.append(fd)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, suppressed, errors


def _nodes_by_line(ctx: FileContext) -> Dict[int, list]:
    import ast
    out: Dict[int, list] = {}
    for node in ast.walk(ctx.tree):
        ln = getattr(node, "lineno", None)
        if ln is not None and isinstance(node, (ast.expr, ast.stmt)):
            out.setdefault(ln, []).append(node)
    return out


# ------------------------------------------------------------------ baseline


def load_baseline(path: str) -> Dict[str, str]:
    """fingerprint -> human note. Missing file = empty baseline (a fresh
    tree has nothing to inherit)."""
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    entries = data.get("suppressions", data) if isinstance(data, dict) \
        else {}
    return {str(k): str(v) for k, v in entries.items()}


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    entries = {f.fingerprint(): f.render() for f in findings}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"comment": "graftlint baseline — regenerate with "
                              "`python -m kubernetes_tpu_torch.analysis "
                              "--write-baseline <file> <paths>`; prefer "
                              "pragmas for anything new",
                   "suppressions": entries}, fh, indent=2, sort_keys=True)
        fh.write("\n")


# ------------------------------------------------------------------ the gate


def lint_gate(root: Optional[str] = None,
              baseline: Optional[str] = None) -> Tuple[bool, str]:
    """(clean, report) over the package tree — the tier-1 / bench gate.
    Defaults to the installed kubernetes_tpu_torch package directory so
    the gate checks the code actually being exercised, wherever it runs
    from."""
    if root is None:
        import kubernetes_tpu_torch
        root = os.path.dirname(
            os.path.abspath(kubernetes_tpu_torch.__file__))
    base = load_baseline(baseline) if baseline else None
    findings, n_sup, errors = run_paths([root], baseline=base)
    lines = [f.render() for f in findings] + \
        [f"parse error: {e}" for e in errors]
    ok = not findings and not errors
    tail = (f"graftlint: {len(findings)} finding(s), "
            f"{n_sup} baseline-suppressed")
    return ok, "\n".join(lines + [tail])
