"""Bench-trajectory trend reader: the BENCH_r*.json
artifacts become a queryable trajectory instead of sixteen files a human
diffs by hand.

    python bench.py --trend
    python -m kubernetes_tpu_torch.observability --trend [--root DIR]
                                                   [--band 0.30]

Reads every BENCH_r*.json under the repo root (the driver-written
{cmd, rc, parsed} shape and the bench's own artifacts alike) plus
PROGRESS.jsonl, renders a headline-metric trend table, and flags
regressions: the LATEST round's value against the nearest earlier round
carrying the same metric, beyond the documented ±30% box-noise band
(PROFILE_r10.md — the 2-core CI box moves knees ±30% run to run, so a
smaller delta is noise, a larger one is a finding). Exit status is the
CI contract: 0 clean, 1 when any headline metric regressed past the
band, 2 on usage/IO errors.

Pure stdlib — no jax import, safe to run anywhere (including the
lint-gate CI leg).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

# (artifact key, short label, direction) — direction "up" = bigger is
# better, "down" = smaller is better, None = informational only (never
# flags; overhead percentages swing sign with box noise)
HEADLINE_METRICS: Tuple[Tuple[str, str, Optional[str]], ...] = (
    ("value", "drain pods/s", "up"),
    ("arrival_sustained_pods_s", "arrival sust/s", "up"),
    ("arrival_p99_create_to_bound_ms", "arrival p99 ms", "down"),
    ("multi_frontend_pods_s", "fleet inproc/s", "up"),
    ("multi_frontend_binwire_pods_s", "fleet binwire/s", "up"),
    ("churn_vs_quiet", "churn/quiet", "up"),
    # aggregate scheduleOnes/s of the M-process fleet (the
    # multiproc_N scenarios) — absent before r18, the gate tolerates
    # missing history and starts enforcing from the first round it
    # appears in
    ("multiproc_pods_s", "multiproc agg/s", "up"),
    # the Sparrow fast tier's p99 create->bound and the bulk
    # stream's sustained fraction under mixed criticality — absent
    # before r19; the gate tolerates missing history like multiproc
    ("fastlane_p99_ms", "fastlane p99 ms", "down"),
    ("mixed_bulk_sustained", "mixed bulk frac", "up"),
    # the rolling-update scenario — update completion time and
    # the replacement pods' p99 create->bound on the loaded stream —
    # absent before r20; the gate tolerates missing history like
    # multiproc/fastlane
    ("rolling_update_completion_s", "rollout done s", "down"),
    ("rolling_replacement_p99_ms", "rollout p99 ms", "down"),
    ("telemetry_overhead_pct", "recorder ovh %", None),
    ("podtrace_overhead_pct", "podtrace ovh %", None),
    # the federation tier — aggregate nodes behind the front
    # door, router admission p99 on top of per-cell create->bound, and
    # pods spilled-then-bound under a cell brownout — absent before r21;
    # the gate tolerates missing history like multiproc/fastlane
    ("federation_agg_nodes", "fed agg nodes", "up"),
    ("federation_router_p99_ms", "fed router p99 ms", "down"),
    ("federation_spillover_bound", "fed spill bound", "up"),
)

NOISE_BAND = 0.30

# cpus-aware band: metrics whose level is set by
# how much housekeeping can OVERLAP the stream core, mapped to the
# artifact key carrying their same-box attribution A/B. On a 1-core box
# fault handling serializes behind the stream, so the churn ratio sits
# structurally lower than any multi-core bar — the r19/r20 0.37-0.39
# readings against the 2-core r11 0.66 were box shape, not code (the
# same-box placebo A/B in bench.measure_churn carries the attribution).
# A 1-core regression on these metrics is annotated and NOT gated,
# exactly like box_change — but ONLY when the round's artifact actually
# carries the attribution evidence; a bare 1-cpu drop still gates.
SINGLE_CORE_LENIENT = {"churn_vs_quiet": "churn_attribution"}


def load_rounds(root: str) -> List[Tuple[int, Dict]]:
    """Every BENCH_r<NN>.json under root as (round, parsed) — tolerant
    of both the driver shape ({"parsed": {...}}) and a bare dict."""
    out: List[Tuple[int, Dict]] = []
    for name in os.listdir(root):
        m = re.fullmatch(r"BENCH_r(\d+)\.json", name)
        if not m:
            continue
        try:
            with open(os.path.join(root, name), "r",
                      encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        parsed = doc.get("parsed", doc) if isinstance(doc, dict) else None
        if isinstance(parsed, dict):
            out.append((int(m.group(1)), parsed))
    out.sort()
    return out


def _metric(parsed: Dict, key: str) -> Optional[float]:
    v = parsed.get(key)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v)


def round_cpus(parsed: Dict) -> Optional[int]:
    """The CPU count the round ran on: top-level ``cpus`` (every r19+
    scenario records it) with the r18 fallback (only the multiproc
    scenario disclosed the box shape back then)."""
    v = parsed.get("cpus")
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        mp = parsed.get("multiproc")
        v = mp.get("cpus") if isinstance(mp, dict) else None
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return int(v)


def find_regressions(rounds: List[Tuple[int, Dict]],
                     band: float = NOISE_BAND) -> List[Dict]:
    """Latest round vs the nearest EARLIER round carrying each headline
    metric; a delta past the band in the bad direction is a
    regression. A regression whose two rounds ran on DIFFERENT CPU
    counts carries a ``box_change`` annotation (\"2 -> 1 cpus\") — the
    r18 churn_vs_quiet 0.45 \"dip\" was exactly this, a 2-core round
    compared against a 1-core one, not a code regression."""
    if len(rounds) < 2:
        return []
    latest_r, latest = rounds[-1]
    regs: List[Dict] = []
    for key, label, direction in HEADLINE_METRICS:
        if direction is None:
            continue
        cur = _metric(latest, key)
        if cur is None:
            continue
        prev = prev_r = prev_parsed = None
        for r, parsed in reversed(rounds[:-1]):
            prev = _metric(parsed, key)
            if prev is not None:
                prev_r, prev_parsed = r, parsed
                break
        if prev is None or prev == 0:
            continue
        bad = (cur < prev * (1.0 - band)) if direction == "up" \
            else (cur > prev * (1.0 + band))
        if bad:
            reg = {"metric": key, "label": label,
                   "round": latest_r, "vs_round": prev_r,
                   "current": cur, "previous": prev,
                   "ratio": round(cur / prev, 3),
                   "direction": direction}
            cur_cpus = round_cpus(latest)
            prev_cpus = round_cpus(prev_parsed)
            if cur_cpus is not None and prev_cpus is not None \
                    and cur_cpus != prev_cpus:
                reg["box_change"] = f"{prev_cpus} -> {cur_cpus} cpus"
            elif key in SINGLE_CORE_LENIENT and cur_cpus == 1 \
                    and isinstance(
                        latest.get(SINGLE_CORE_LENIENT[key]), dict):
                reg["single_core_band"] = (
                    "1-cpu box: housekeeping serializes behind the "
                    f"stream core — see {SINGLE_CORE_LENIENT[key]} "
                    "in the artifact")
            regs.append(reg)
    return regs


def render_table(rounds: List[Tuple[int, Dict]]) -> str:
    cols = [k for k, _l, _d in HEADLINE_METRICS
            if any(_metric(p, k) is not None for _r, p in rounds)]
    labels = {k: l for k, l, _d in HEADLINE_METRICS}
    head = ["round"] + [labels[k] for k in cols]
    body: List[List[str]] = []
    for r, parsed in rounds:
        row = [f"r{r:02d}"]
        for k in cols:
            v = _metric(parsed, k)
            row.append("-" if v is None else
                       (f"{v:.2f}" if abs(v) < 100 else f"{v:.0f}"))
        body.append(row)
    widths = [max(len(head[i]), *(len(row[i]) for row in body))
              for i in range(len(head))]
    lines = ["  ".join(h.rjust(w) for h, w in zip(head, widths))]
    for row in body:
        lines.append("  ".join(c.rjust(w) for c, w in zip(row, widths)))
    return "\n".join(lines)


def progress_summary(root: str) -> str:
    """One line per driver round from PROGRESS.jsonl (last entry wins):
    the repo-growth trajectory beside the perf one."""
    path = os.path.join(root, "PROGRESS.jsonl")
    if not os.path.exists(path):
        return ""
    last: Dict[int, Dict] = {}
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except ValueError:
                    continue
                if isinstance(e, dict) and "round" in e:
                    last[int(e["round"])] = e
    except OSError:
        return ""
    if not last:
        return ""
    lines = ["progress (PROGRESS.jsonl, last sample per round):"]
    for r in sorted(last):
        e = last[r]
        lines.append(f"  round {r:2d}: loc={e.get('loc', '?')} "
                     f"commits={e.get('commits', '?')} "
                     f"turns={e.get('turns', '?')}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="bench.py --trend",
        description="render the BENCH_r*.json headline trend and flag "
                    "regressions beyond the box-noise band (nonzero "
                    "exit: CI contract)")
    ap.add_argument("--root", default=None,
                    help="directory holding BENCH_r*.json + "
                         "PROGRESS.jsonl (default: the repo root)")
    ap.add_argument("--band", type=float, default=NOISE_BAND,
                    help="relative noise band (default 0.30 — the "
                         "documented 2-core box swing)")
    args = ap.parse_args(argv)
    root = args.root or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if not os.path.isdir(root):
        print(f"trend: no such directory {root}", file=sys.stderr)
        return 2
    rounds = load_rounds(root)
    if not rounds:
        print(f"trend: no BENCH_r*.json under {root}", file=sys.stderr)
        return 2
    print(render_table(rounds))
    prog = progress_summary(root)
    if prog:
        print(prog)
    regs = find_regressions(rounds, band=args.band)
    fatal = [g for g in regs
             if "box_change" not in g and "single_core_band" not in g]
    if regs:
        print(f"\nREGRESSIONS past the ±{args.band:.0%} band:")
        for g in regs:
            arrow = "v" if g["direction"] == "up" else "^"
            note = ""
            if "box_change" in g:
                # a box-shape change (the runner moved between CPU
                # shapes) explains the delta — report it, don't gate on
                # it (the r18 churn_vs_quiet lesson)
                note = f"  [box change: {g['box_change']} — not gated]"
            elif "single_core_band" in g:
                note = f"  [{g['single_core_band']} — not gated]"
            print(f"  {arrow} {g['label']} ({g['metric']}): "
                  f"r{g['round']:02d}={g['current']:.2f} vs "
                  f"r{g['vs_round']:02d}={g['previous']:.2f} "
                  f"(x{g['ratio']}){note}")
        if fatal:
            return 1
    print(f"\nno regressions past the ±{args.band:.0%} band "
          f"(latest r{rounds[-1][0]:02d} vs trajectory)")
    return 0


__all__ = ["HEADLINE_METRICS", "NOISE_BAND", "SINGLE_CORE_LENIENT",
           "find_regressions", "load_rounds", "main", "progress_summary",
           "render_table", "round_cpus"]
