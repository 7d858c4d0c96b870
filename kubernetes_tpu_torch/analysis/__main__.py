"""CLI: `python -m kubernetes_tpu_torch.analysis [paths ...]`.

Exit codes: 0 clean, 1 unsuppressed findings (or parse errors), 2 usage.

    python -m kubernetes_tpu_torch.analysis kubernetes_tpu_torch/
    python -m kubernetes_tpu_torch.analysis --baseline graftlint_baseline.json src/
    python -m kubernetes_tpu_torch.analysis --write-baseline graftlint_baseline.json src/
    python -m kubernetes_tpu_torch.analysis --rules GL001,GL005 --json kubernetes_tpu_torch/
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from kubernetes_tpu_torch.analysis.lint import (
    RULE_IDS,
    load_baseline,
    run_paths,
    write_baseline,
)
from kubernetes_tpu_torch.analysis.rules import CATALOG


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kubernetes_tpu_torch.analysis",
        description="graftlint: AST hazard analysis for the JAX hot path "
                    "and the concurrency discipline (GL001 aliasing, "
                    "GL002 host-sync, GL003 recompile, GL004 tracer leak, "
                    "GL005 generation discipline, GL006 lock order, "
                    "GL007 torn read/write, GL008 event-loop blocking, "
                    "GL009 spawn safety)")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: the "
                         "kubernetes_tpu_torch package directory)")
    ap.add_argument("--baseline", metavar="FILE",
                    help="JSON suppression file; listed fingerprints are "
                         "not reported")
    ap.add_argument("--write-baseline", metavar="FILE",
                    help="write all current findings to FILE as the new "
                         "baseline and exit 0")
    ap.add_argument("--rules", metavar="IDS",
                    help="comma-separated subset, e.g. GL001,GL005")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid in RULE_IDS:
            print(f"{rid}  {CATALOG[rid]}")
        return 0

    rules = None
    if args.rules:
        rules = [r.strip().upper() for r in args.rules.split(",") if r]
        unknown = [r for r in rules if r not in RULE_IDS]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)} "
                  f"(have: {', '.join(RULE_IDS)})", file=sys.stderr)
            return 2

    paths = args.paths
    if not paths:
        import kubernetes_tpu_torch
        paths = [os.path.dirname(
            os.path.abspath(kubernetes_tpu_torch.__file__))]

    baseline = load_baseline(args.baseline) if args.baseline else None
    if args.write_baseline:
        # regenerate from the UNFILTERED findings: combining --baseline
        # with --write-baseline must not silently drop every inherited
        # suppression from the new file
        baseline = None
    findings, n_sup, errors = run_paths(paths, baseline=baseline,
                                        rules=rules)

    if args.write_baseline:
        write_baseline(args.write_baseline, findings)
        print(f"graftlint: baseline written ({len(findings)} "
              f"suppression(s)) -> {args.write_baseline}")
        for e in errors:
            # an unparseable/missing file silently SHRINKS the baseline's
            # coverage — that is a failed regeneration, same as the gate
            print(f"parse error: {e}", file=sys.stderr)
        return 1 if errors else 0

    if args.json:
        by_rule = {rid: 0 for rid in (rules or RULE_IDS)}
        for f in findings:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        print(json.dumps({
            "findings": [{"rule": f.rule, "path": f.path, "line": f.line,
                          "col": f.col, "context": f.context,
                          "message": f.message,
                          "fingerprint": f.fingerprint()}
                         for f in findings],
            "by_rule": by_rule,
            "baseline_suppressed": n_sup,
            "parse_errors": errors}, indent=2))
    else:
        for f in findings:
            print(f.render())
        for e in errors:
            print(f"parse error: {e}", file=sys.stderr)
        print(f"graftlint: {len(findings)} finding(s), {n_sup} "
              f"baseline-suppressed, {len(errors)} parse error(s)")
    return 1 if findings or errors else 0


if __name__ == "__main__":
    sys.exit(main())
