"""GL002 — hidden device→host sync in the hot path.

Every host touch of a device value (`np.asarray(dev)`, `.item()`,
`float(dev)`, `int(dev)`, `bool(dev)`, `.block_until_ready()`) blocks the
caller until the device drains — on the pipelined drain that forfeits the
whole overlap (the device wait PROFILE_r07 worked to hide), and on the
extender warm path it's a per-request stall. The design budget is ONE
blessed sync per wave (`engine/waves.py` place_waves) plus the harvest's
fetch; everything else must either stay on device or carry a
`# graftlint: sync-ok` pragma naming why the stall is paid.

Detection is dataflow-taint within a function, so it cannot false-positive
on numpy-on-numpy `np.asarray`:

- taint sources: results of calls to KNOWN-JITTED callables (the project
  index collects every `@jax.jit` def and module-level `X = jax.jit(...)`
  bind across the linted set), and the WaveHandle device fields
  (`.packed`, `.state_out`, `.counter_out`, `.committed_out`) whose
  device-ness crosses the dispatch→harvest function boundary;
- taint propagates through subscripts of tainted names;
- a sync-forcer applied to a tainted expression fires.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from kubernetes_tpu_torch.analysis.rules.base import (
    DEVICE_ATTRS,
    SYNC_BUILTINS,
    SYNC_METHODS,
    SYNC_WRAPPERS,
    FileContext,
    Finding,
    ProjectIndex,
    dotted,
    functions_of,
    last_component,
)

RULE = "GL002"


def _taint_events(fn: ast.AST, jitted: Set[str]) -> Dict[str, list]:
    """name -> [(line, producer-or-None)] assignment events in line order.
    producer set = the name now holds a device value (assigned from a
    jitted call); None = any other rebind CLEARS the taint (last-write
    wins — `selected = np.asarray(selected)[:pf]` is the sync itself and
    the name is host numpy afterwards)."""
    events: Dict[str, list] = {}
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        call = node.value
        producer = None
        if isinstance(call, ast.Call):
            fname = dotted(call.func)
            if fname is not None and last_component(fname) in jitted:
                producer = last_component(fname)
        for t in node.targets:
            elts = t.elts if isinstance(t, ast.Tuple) else [t]
            for e in elts:
                if isinstance(e, ast.Name):
                    events.setdefault(e.id, []).append(
                        (node.lineno, producer))
    for evs in events.values():
        # key on the line alone: two same-line rebinds with mixed producers
        # would make tuple comparison reach the None-vs-str element
        evs.sort(key=lambda ev: ev[0])
    return events


def _taint_of(expr: ast.AST, events: Dict[str, list], at_line: int):
    """Why `expr` is a device value at `at_line`, or None. Subscript
    peels; an attribute chain ending in a WaveHandle device field is
    tainted by contract (device-ness crosses the function boundary)."""
    cur = expr
    while isinstance(cur, ast.Subscript):
        cur = cur.value
    if isinstance(cur, ast.Name) and cur.id in events:
        producer = None
        for line, prod in events[cur.id]:
            if line >= at_line:
                break  # >= : a same-line rebind (`x = np.asarray(x)`) is
                # the sync of the PRIOR value — don't let it untaint itself
            producer = prod
        if producer is not None:
            return f"result of jitted '{producer}'"
    p = dotted(cur)
    if p is not None and "." in p and last_component(p) in DEVICE_ATTRS:
        return f"device field '{p}'"
    return None


def check(ctx: FileContext, index: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    for fn in functions_of(ctx.tree):
        events = _taint_events(fn, index.jitted_names)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            fname = dotted(node.func)
            why = None
            forced_by = None
            if fname in SYNC_WRAPPERS and node.args:
                why = _taint_of(node.args[0], events, node.lineno)
                forced_by = fname
            elif fname in SYNC_BUILTINS and len(node.args) == 1:
                why = _taint_of(node.args[0], events, node.lineno)
                forced_by = f"{fname}()"
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in SYNC_METHODS:
                why = _taint_of(node.func.value, events, node.lineno)
                forced_by = f".{node.func.attr}()"
            if why is not None:
                findings.append(Finding(
                    RULE, ctx.path, node.lineno, node.col_offset,
                    f"{forced_by} forces a device->host sync on {why} — "
                    "a pipeline stall in the hot path; keep it on device "
                    "or bless the stall with `# graftlint: sync-ok`",
                    context=ctx.qualname(fn)))
    return findings
