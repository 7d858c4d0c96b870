"""graftlint in the port (analysis/lint.py, analysis/rules/,
analysis/__main__.py) against the reference's. Every case of
tests/test_graftlint.py runs with each package's linter (the `k`
fixture), and every lint of a fixture runs through BOTH linters, which
must report equal findings (rule, path, line, column, context, message),
suppression counts and parse errors. The fixtures that read the
reference's real JAX sources (the GL002/GL003 registry cases) read them in
both runs: they are inputs, and the port's tree has no `jax.jit` to find.
The port's own CLI (`python -m kubernetes_tpu_torch.analysis`), baselines
and `_relpath` run against the port's tree; the gate runs once, through a
shared fixture, over the port's tree with no baseline, and must be clean
inside the reference's 20 s bound. Last, the port's departures: module_id
folds `kubernetes_tpu_torch`, and lint_gate() and the CLI default to the
port's package directory."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

import kubernetes_tpu
import kubernetes_tpu_torch
from tests.torch_packages import PORT, REF, Pkg

MODULES = {
    "analysis_main": "analysis.__main__",
    "analysis_lint": "analysis.lint",
    "analysis_rules_base": "analysis.rules.base",
}
PKGS = {REF: Pkg(REF, MODULES), PORT: Pkg(PORT, MODULES)}
PKG_DIRS = {root: os.path.dirname(os.path.abspath(pkg.__file__))
            for root, pkg in ((REF, kubernetes_tpu),
                              (PORT, kubernetes_tpu_torch))}
# the reference's real sources: inputs of the registry fixtures
REF_DIR = PKG_DIRS[REF]
REPO = os.path.dirname(REF_DIR)


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return PKGS[request.param]


@pytest.fixture(scope="module")
def port_gate():
    """lint_gate() over the port's tree, once: (ok, report, seconds)."""
    t0 = time.perf_counter()
    ok, report = PKGS[PORT].lint_gate()
    return ok, report, time.perf_counter() - t0


def _seen(result):
    findings, n_sup, errors = result
    return ([(f.rule, f.path, f.line, f.col, f.context, f.message,
              f.fingerprint()) for f in findings], n_sup, errors)


def run_both(k, paths, **kw):
    """run_paths through both linters: equal findings, suppressions and
    parse errors; returns `k`'s result."""
    got = {root: PKGS[root].run_paths(paths, **kw) for root in (REF, PORT)}
    assert _seen(got[PORT]) == _seen(got[REF])
    return got[k.root]


def lint_src(k, tmp_path, src, name="snippet.py", rules=None):
    f = tmp_path / name
    f.write_text(textwrap.dedent(src))
    findings, _sup, errors = run_both(k, [str(f)], rules=rules)
    assert not errors, errors
    return findings


def rules_of(findings):
    return [f.rule for f in findings]


# ------------------------------------------------------------------- GL001


def test_gl001_fires_on_asarray_then_mutate(k, tmp_path):
    fs = lint_src(k, tmp_path, """
        import jax.numpy as jnp
        import numpy as np

        def upload():
            buf = np.zeros(8)
            dev = jnp.asarray(buf)
            buf[0] = 1.0
            return dev
    """)
    assert rules_of(fs) == ["GL001"]


def test_gl001_fires_on_class_scoped_alias(k, tmp_path):
    """The r08 committed_nodes shape: upload in one method, in-place fold
    in another — lifetime spans calls, so the alias must be assumed live."""
    fs = lint_src(k, tmp_path, """
        import jax.numpy as jnp
        import numpy as np

        class Engine:
            def dispatch(self, enc):
                return jnp.asarray(enc.committed_nodes)

            def harvest(self, enc, cls, node):
                np.add.at(enc.committed_nodes, (cls, node), 1)
    """)
    assert rules_of(fs) == ["GL001"]


def test_gl001_silent_on_copying_idioms(k, tmp_path):
    fs = lint_src(k, tmp_path, """
        import jax.numpy as jnp
        import numpy as np

        def upload():
            buf = np.zeros(8)
            a = jnp.array(buf)          # copy constructor
            b = jnp.asarray(buf.copy()) # explicit host copy
            c = jnp.asarray(buf)        # alias, but buf is never mutated
            return a, b, c
    """)
    assert fs == []


def test_gl001_copy_required_contract(k, tmp_path):
    """The machine-checked form of the old prose comments: downgrading a
    copy-required seam to jnp.asarray fires; the copying form passes."""
    bad = lint_src(k, tmp_path, """
        import jax.numpy as jnp

        def seam(host):
            dev = jnp.asarray(host)  # graftlint: copy-required
            return dev
    """)
    assert rules_of(bad) == ["GL001"]
    good = lint_src(k, tmp_path, """
        import jax.numpy as jnp

        def seam(host):
            dev = jnp.array(host)  # graftlint: copy-required
            return dev
    """, name="good.py")
    assert good == []


# ------------------------------------------------------------------- GL002


GL002_BAD = """
    import functools
    import jax
    import numpy as np

    @functools.partial(jax.jit, static_argnames=("k",))
    def kernel(x, k=1):
        return x * k

    def hot_path(x):
        out = kernel(x)
        host = np.asarray(out)
        return host
"""


def test_gl002_fires_on_sync_of_jitted_result(k, tmp_path):
    fs = lint_src(k, tmp_path, GL002_BAD)
    assert rules_of(fs) == ["GL002"]


def test_gl002_pragma_blesses_the_sync(k, tmp_path):
    fs = lint_src(k, tmp_path, GL002_BAD.replace(
        "host = np.asarray(out)",
        "host = np.asarray(out)  # graftlint: sync-ok"))
    assert fs == []


def test_gl002_silent_on_numpy_on_numpy(k, tmp_path):
    """np.asarray of host data is free — taint only flows from jitted
    calls and WaveHandle device fields, and a rebind clears it."""
    fs = lint_src(k, tmp_path, """
        import functools
        import jax
        import numpy as np

        @jax.jit
        def kernel(x):
            return x + 1

        def fine(x):
            res = kernel(x)
            res = np.asarray(res)  # graftlint: sync-ok (the one fetch)
            twice = np.asarray(res)      # already host: no second sync
            n = int(res[0])              # host scalar
            return twice, n
    """)
    assert fs == []


def test_gl002_registry_covers_tail_rounds_entry(k, tmp_path):
    """ISSUE 5: the conflict-round tail (engine/waves.tail_rounds_loop)
    is a new jitted entry point; the project-wide jit registry must pick
    it up from the REAL source file so GL002 taint coverage extends to
    its callers — an unblessed fetch of its packed result is a pipeline
    stall and must fire."""
    import ast

    waves_py = os.path.join(REF_DIR, "engine", "waves.py")
    with open(waves_py, "r", encoding="utf-8") as fh:
        waves_src = fh.read()
    index = k.ProjectIndex()
    index.scan(ast.parse(waves_src))
    assert "tail_rounds_loop" in index.jitted_names, \
        "new tail entry point missing from the jit registry"
    # cross-file taint: the fixture only CALLS the entry point; the
    # jitted-ness comes from the registry built over the real waves.py
    fixture = tmp_path / "harvest_tail.py"
    fixture.write_text(textwrap.dedent("""
        import numpy as np
        from kubernetes_tpu.engine.waves import tail_rounds_loop

        def harvest_tail(cls, nodes, state, pc, counter, prios):
            packed, _st = tail_rounds_loop(cls, nodes, state, pc,
                                           counter, prios)
            return np.asarray(packed)
    """))
    findings, _sup, errors = run_both(k, [waves_py, str(fixture)],
                                       rules=["GL002"])
    assert not errors, errors
    assert any(f.rule == "GL002" and "harvest_tail" in f.context
               for f in findings), findings
    # the blessed form (the harvest's documented fetch) stays silent
    fixture.write_text(fixture.read_text().replace(
        "return np.asarray(packed)",
        "return np.asarray(packed)  # graftlint: sync-ok"))
    findings, _sup, errors = run_both(k, [waves_py, str(fixture)],
                                       rules=["GL002"])
    assert not errors, errors
    assert not [f for f in findings if "harvest_tail" in f.context], findings


def test_gl002_registry_covers_streaming_pop_seam(k, tmp_path):
    """ISSUE 7: the always-on loop's micro-wave pop dispatches through
    the registered jitted entry points (waves_loop and friends) — the
    registry built over the REAL waves.py must extend GL002 taint to a
    streaming-shaped consumer, because the pop seam is exactly where a
    hidden device->host sync would silently serialize the loop (one
    unblessed fetch per micro-wave = the whole overlap forfeited at
    20k pops/s)."""
    import ast

    waves_py = os.path.join(REF_DIR, "engine", "waves.py")
    with open(waves_py, "r", encoding="utf-8") as fh:
        index = k.ProjectIndex()
        index.scan(ast.parse(fh.read()))
    # the streaming dispatch path's device entry points, all registered
    # via decoration
    for entry in ("waves_loop", "tail_rounds_loop", "precompute_jit",
                  "frozen_affinity_scores"):
        assert entry in index.jitted_names, entry
    fixture = tmp_path / "stream_pump.py"
    fixture.write_text(textwrap.dedent("""
        import numpy as np
        from kubernetes_tpu.engine.waves import waves_loop

        def pump_micro_wave(queue, cls_arr, nodes, state, pc, ctr, prios):
            packed, _st = waves_loop(cls_arr, nodes, state, pc, ctr,
                                     prios)
            return np.asarray(packed)
    """))
    findings, _sup, errors = run_both(k, [waves_py, str(fixture)],
                                       rules=["GL002"])
    assert not errors, errors
    assert any(f.rule == "GL002" and "pump_micro_wave" in f.context
               for f in findings), findings
    # the blessed harvest fetch stays silent
    fixture.write_text(fixture.read_text().replace(
        "return np.asarray(packed)",
        "return np.asarray(packed)  # graftlint: sync-ok"))
    findings, _sup, errors = run_both(k, [waves_py, str(fixture)],
                                       rules=["GL002"])
    assert not errors, errors
    assert not [f for f in findings if "pump_micro_wave" in f.context], \
        findings


def test_gl002_registry_covers_hostcheck_static_column_seam(k, tmp_path):
    """ISSUE 18: host-check classes ride the wave via a precomputed
    `host_fit` [C, N] column ANDed inside the fused static eval
    (ops/predicates.static_fits, entered through waves.precompute_jit).
    The column is built host-side from label truth and uploaded frozen —
    the registry built over the REAL waves.py must extend GL002 taint to
    a consumer feeding the host_fit-bearing class dict, because an
    unblessed fetch at this seam would serialize every host-check wave
    (exactly the flush this PR removed, reintroduced as a hidden
    sync)."""
    import ast

    waves_py = os.path.join(REF_DIR, "engine", "waves.py")
    with open(waves_py, "r", encoding="utf-8") as fh:
        index = k.ProjectIndex()
        index.scan(ast.parse(fh.read()))
    assert "precompute_jit" in index.jitted_names, \
        "host-check static-column entry missing from the jit registry"
    fixture = tmp_path / "host_column.py"
    fixture.write_text(textwrap.dedent("""
        import numpy as np
        from kubernetes_tpu.engine.waves import precompute_jit

        def eval_host_static_chunk(cls, nodes, host_rows, priorities):
            cls = dict(cls, host_fit=host_rows)  # frozen label column
            pre = precompute_jit(cls, nodes, priorities=priorities)
            return np.asarray(pre["static_fit"])
    """))
    findings, _sup, errors = run_both(k, [waves_py, str(fixture)],
                                       rules=["GL002"])
    assert not errors, errors
    assert any(f.rule == "GL002" and "eval_host_static_chunk" in f.context
               for f in findings), findings
    # the blessed form (the dispatch's documented fetch point) is silent
    fixture.write_text(fixture.read_text().replace(
        'return np.asarray(pre["static_fit"])',
        'return np.asarray(pre["static_fit"])  # graftlint: sync-ok'))
    findings, _sup, errors = run_both(k, [waves_py, str(fixture)],
                                       rules=["GL002"])
    assert not errors, errors
    assert not [f for f in findings
                if "eval_host_static_chunk" in f.context], findings


def test_gl002_registry_covers_batched_extender_eval(k, tmp_path):
    """ISSUE 9: the coalesced multi-frontend eval adds a jitted entry
    point (scheduler_engine._fused_eval_batch_jit, the [C, N] sibling of
    the extender's fused single-pod dispatch) — the project-wide registry
    must pick it up from the REAL source so GL002 taint extends to
    consumers: an unblessed fetch of the batch result would stall the
    coalescing window once per micro-batch, exactly the hidden-sync
    hazard the fleet throughput story rests on."""
    import ast

    eng_py = os.path.join(REF_DIR, "engine", "scheduler_engine.py")
    with open(eng_py, "r", encoding="utf-8") as fh:
        index = k.ProjectIndex()
        index.scan(ast.parse(fh.read()))
    for entry in ("_fused_eval_jit", "_fused_eval_batch_jit"):
        assert entry in index.jitted_names, entry
    fixture = tmp_path / "coalesced_eval.py"
    fixture.write_text(textwrap.dedent("""
        import numpy as np
        from kubernetes_tpu.engine.scheduler_engine import (
            _fused_eval_batch_jit,
        )

        def serve_window(parr, narr, plain, weights, mode):
            m, s = _fused_eval_batch_jit(parr, narr, None, plain,
                                         weights, mode)
            return np.asarray(m), np.asarray(s)
    """))
    findings, _sup, errors = run_both(k, [eng_py, str(fixture)],
                                       rules=["GL002"])
    assert not errors, errors
    assert any(f.rule == "GL002" and "serve_window" in f.context
               for f in findings), findings
    # the blessed form (the batch's one documented result fetch) is silent
    fixture.write_text(textwrap.dedent("""
        import numpy as np
        from kubernetes_tpu.engine.scheduler_engine import (
            _fused_eval_batch_jit,
        )

        def serve_window(parr, narr, plain, weights, mode):
            m, s = _fused_eval_batch_jit(parr, narr, None, plain,
                                         weights, mode)
            m = np.asarray(m)  # graftlint: sync-ok
            s = np.asarray(s)  # graftlint: sync-ok
            return m, s
    """))
    findings, _sup, errors = run_both(k, [eng_py, str(fixture)],
                                       rules=["GL002"])
    assert not errors, errors
    assert not [f for f in findings if "serve_window" in f.context], findings


def test_gl002_registry_does_not_taint_async_wire(k, tmp_path):
    """ISSUE 11: the async binary wire (server/asyncwire.py + framing +
    the binary client) is pure HOST-side plumbing — it never calls a
    jitted entry point and never fetches a device value; all device work
    stays behind the service core's blessed seams. The registry built
    over the REAL engine sources must therefore produce ZERO GL002
    findings over the new wire modules: if taint ever reaches the event
    loop's reads, either the wire started dispatching device work inline
    (a loop-wedging hazard — one unblessed fetch per frame serializes
    every connection) or the rule broke. Mirrors the r12 batched-eval
    fixture from the opposite direction: that one proves the registry
    EXTENDS to consumers; this one proves the wire is not one."""
    import ast

    eng_py = os.path.join(REF_DIR, "engine", "scheduler_engine.py")
    waves_py = os.path.join(REF_DIR, "engine", "waves.py")
    wire_files = [
        os.path.join(REF_DIR, "server", "asyncwire.py"),
        os.path.join(REF_DIR, "server", "framing.py"),
        os.path.join(REF_DIR, "server", "embedded.py"),
        os.path.join(REF_DIR, "client", "binarywire.py"),
    ]
    # the registry really carries the jitted entry points (scan sanity:
    # an empty registry would make this test pass vacuously)
    index = k.ProjectIndex()
    for src in (eng_py, waves_py):
        with open(src, "r", encoding="utf-8") as fh:
            index.scan(ast.parse(fh.read()))
    assert "_fused_eval_batch_jit" in index.jitted_names
    assert "waves_loop" in index.jitted_names
    findings, _sup, errors = run_both(k, [eng_py, waves_py] + wire_files,
                                       rules=["GL002"])
    assert not errors, errors
    tainted = [f for f in findings
               if any(os.path.basename(w) in f.path for w in wire_files)]
    assert not tainted, tainted
    # negative control, the r12 pattern inverted: a wire-shaped consumer
    # that DOES fetch a jitted result from its serve path fires — the
    # silence above is the wire's purity, not the rule going blind
    fixture = tmp_path / "bad_wire.py"
    fixture.write_text(textwrap.dedent("""
        import numpy as np
        from kubernetes_tpu.engine.scheduler_engine import (
            _fused_eval_batch_jit,
        )

        def serve_frame(parr, narr, plain, weights, mode):
            m, s = _fused_eval_batch_jit(parr, narr, None, plain,
                                         weights, mode)
            return np.asarray(m)
    """))
    findings, _sup, errors = run_both(k, [eng_py, str(fixture)],
                                       rules=["GL002"])
    assert not errors, errors
    assert any(f.rule == "GL002" and "serve_frame" in f.context
               for f in findings), findings


def test_lint_gate_covers_new_wire_modules(k):
    """ISSUE 11 satellite: `bench --lint-gate` discovers the new wire
    modules (they are ordinary package files — but a collection
    regression here would silently exempt the fleet transport from every
    rule, so the coverage is pinned)."""

    files = k.collect_files([PKG_DIRS[k.root]])
    for rel in (("server", "asyncwire.py"), ("server", "framing.py"),
                ("server", "embedded.py"), ("client", "binarywire.py")):
        assert os.path.join(PKG_DIRS[k.root], *rel) in files, rel


def test_gl003_fires_on_ragged_coalesced_batch(k, tmp_path):
    """ISSUE 9: the coalescing window's batch axis is where a ragged-
    shape recompile storm would creep back in — slicing the class arrays
    to the data-dependent batch size in the serve loop must fire GL003;
    the shipped pad-to-bucket idiom (pod_arrays_bucketed rows=bucket(C))
    stays silent."""
    eng_py = os.path.join(REF_DIR, "engine", "scheduler_engine.py")
    bad = tmp_path / "ragged_window.py"
    bad.write_text(textwrap.dedent("""
        from kubernetes_tpu.engine.scheduler_engine import (
            _fused_eval_batch_jit,
        )

        def serve(windows, parr, narr, plain, weights, mode):
            out = []
            while windows:
                n = windows.pop()
                out.append(_fused_eval_batch_jit(parr[:n], narr, None,
                                                 plain, weights, mode))
            return out
    """))
    findings, _sup, errors = run_both(k, [eng_py, str(bad)], rules=["GL003"])
    assert not errors, errors
    assert any(f.rule == "GL003" and "serve" in f.context
               for f in findings), findings
    good = tmp_path / "bucketed_window.py"
    good.write_text(textwrap.dedent("""
        import numpy as np
        from kubernetes_tpu.engine.scheduler_engine import (
            _fused_eval_batch_jit,
        )

        def serve(windows, parr, narr, plain, weights, mode, pad):
            out = []
            while windows:
                n = windows.pop()
                rows = np.zeros(pad, dtype=np.int32)
                rows[:n] = parr[:n]
                out.append(_fused_eval_batch_jit(rows, narr, None,
                                                 plain, weights, mode))
            return out
    """))
    findings, _sup, errors = run_both(k, [eng_py, str(good)], rules=["GL003"])
    assert not errors, errors
    assert not [f for f in findings if f.rule == "GL003"
                and "bucketed_window" in f.path], findings


def test_gl003_fires_on_ragged_micro_wave_pop(k, tmp_path):
    """ISSUE 7: the micro-wave pop is where the ragged-shape recompile
    storm would creep back in — an arrival loop slicing its pod arrays
    to the data-dependent pop size before a registered jitted entry
    point must fire GL003; the pad-to-bucket idiom (predicates.bucket,
    what the reference's ScheduleLoop rides) stays silent."""
    waves_py = os.path.join(REF_DIR, "engine", "waves.py")
    bad = tmp_path / "ragged_pump.py"
    bad.write_text(textwrap.dedent("""
        from kubernetes_tpu.engine.waves import waves_loop

        def pump(queue, cls_arr, nodes, state, pc, ctr, prios):
            out = []
            while queue:
                n = queue.pop()
                out.append(waves_loop(cls_arr, nodes, state, pc[:n],
                                      ctr, prios))
            return out
    """))
    findings, _sup, errors = run_both(k, [waves_py, str(bad)],
                                       rules=["GL003"])
    assert not errors, errors
    assert any(f.rule == "GL003" and "pump" in f.context
               for f in findings), findings
    # blessed: pad to a fixed bucket OUTSIDE the call's operand — no
    # ragged slice reaches the jitted entry point
    good = tmp_path / "bucketed_pump.py"
    good.write_text(textwrap.dedent("""
        import numpy as np
        from kubernetes_tpu.engine.waves import waves_loop

        def pump(queue, cls_arr, nodes, state, pc, ctr, prios, pad):
            out = []
            while queue:
                n = queue.pop()
                pc_pad = np.full(pad, 0, dtype=np.int32)
                pc_pad[:n] = pc[:n]
                out.append(waves_loop(cls_arr, nodes, state, pc_pad,
                                      ctr, prios))
            return out
    """))
    findings, _sup, errors = run_both(k, [waves_py, str(good)],
                                       rules=["GL003"])
    assert not errors, errors
    assert not [f for f in findings if f.rule == "GL003"
                and "bucketed_pump" in f.path], findings


def test_gl002_registry_covers_victim_scan_seam(k, tmp_path):
    """ISSUE 14: wave-path preemption adds a jitted entry point
    (ops/preempt.victim_scan_jit — the [C, N] victim pre-filter) — the
    project-wide registry must pick it up from the REAL source so GL002
    taint extends to consumers: an unblessed fetch of the candidate
    rows would stall the harvest tail once per preemption round."""
    import ast

    pre_py = os.path.join(REF_DIR, "ops", "preempt.py")
    with open(pre_py, "r", encoding="utf-8") as fh:
        index = k.ProjectIndex()
        index.scan(ast.parse(fh.read()))
    assert "victim_scan_jit" in index.jitted_names
    fixture = tmp_path / "victim_select.py"
    fixture.write_text(textwrap.dedent("""
        import numpy as np
        from kubernetes_tpu.ops.preempt import victim_scan_jit

        def select_victims(need_cpu, need_mem, prio, dev):
            cand, bound = victim_scan_jit(need_cpu, need_mem, prio,
                                          dev, dev, dev, dev, dev, dev,
                                          dev, dev)
            return np.asarray(cand)
    """))
    findings, _sup, errors = run_both(k, [pre_py, str(fixture)],
                                       rules=["GL002"])
    assert not errors, errors
    assert any(f.rule == "GL002" and "select_victims" in f.context
               for f in findings), findings
    # the blessed fetch (the scan's documented synchronous consume)
    fixture.write_text(fixture.read_text().replace(
        "return np.asarray(cand)",
        "return np.asarray(cand)  # graftlint: sync-ok"))
    findings, _sup, errors = run_both(k, [pre_py, str(fixture)],
                                       rules=["GL002"])
    assert not errors, errors
    assert not [f for f in findings if "select_victims" in f.context], \
        findings


def test_gl003_fires_on_ragged_victim_set(k, tmp_path):
    """ISSUE 14: a preemption round's preemptor count is data-dependent —
    slicing the need arrays to it before the victim-scan jit would mint
    one XLA compile per distinct round size (the GL003 storm); the
    pad-to-bucket idiom engine.preempt_scan actually uses stays silent."""
    pre_py = os.path.join(REF_DIR, "ops", "preempt.py")
    bad = tmp_path / "ragged_scan.py"
    bad.write_text(textwrap.dedent("""
        from kubernetes_tpu.ops.preempt import victim_scan_jit

        def scan_rounds(rounds, need_cpu, need_mem, prio, dev):
            out = []
            while rounds:
                n = rounds.pop()
                out.append(victim_scan_jit(need_cpu[:n], need_mem[:n],
                                           prio[:n], dev, dev, dev, dev,
                                           dev, dev, dev, dev))
            return out
    """))
    findings, _sup, errors = run_both(k, [pre_py, str(bad)],
                                       rules=["GL003"])
    assert not errors, errors
    assert any(f.rule == "GL003" and "scan_rounds" in f.context
               for f in findings), findings
    good = tmp_path / "bucketed_scan.py"
    good.write_text(textwrap.dedent("""
        import numpy as np
        from kubernetes_tpu.ops.preempt import victim_scan_jit

        def scan_rounds(rounds, need_cpu, need_mem, prio, dev, pad):
            out = []
            while rounds:
                n = rounds.pop()
                nc = np.zeros(pad, dtype=np.int32)
                nc[:n] = need_cpu[:n]
                out.append(victim_scan_jit(nc, nc, nc, dev, dev, dev,
                                           dev, dev, dev, dev, dev))
            return out
    """))
    findings, _sup, errors = run_both(k, [pre_py, str(good)],
                                       rules=["GL003"])
    assert not errors, errors
    assert not [f for f in findings if f.rule == "GL003"
                and "bucketed_scan" in f.path], findings


def test_gl002_fires_on_device_handle_field(k, tmp_path):
    fs = lint_src(k, tmp_path, """
        import numpy as np

        def harvest(handle):
            return np.asarray(handle.packed)
    """)
    assert rules_of(fs) == ["GL002"]


# ------------------------------------------------------------------- GL003


def test_gl003_fires_on_jit_in_function(k, tmp_path):
    fs = lint_src(k, tmp_path, """
        import jax

        def hot(xs):
            f = jax.jit(lambda a: a + 1)
            return [f(x) for x in xs]
    """)
    assert rules_of(fs) == ["GL003"]


def test_gl003_fires_on_ragged_slice_in_loop(k, tmp_path):
    fs = lint_src(k, tmp_path, """
        import jax

        @jax.jit
        def kernel(x):
            return x.sum()

        def drain(queue, arr):
            out = []
            while queue:
                n = queue.pop()
                out.append(kernel(arr[:n]))
            return out
    """)
    assert rules_of(fs) == ["GL003"]


def test_gl003_silent_on_blessed_idioms(k, tmp_path):
    """Module-level wrap/decorator and bucketed shapes pass."""
    fs = lint_src(k, tmp_path, """
        import functools
        import jax

        def _impl(x):
            return x + 1

        impl_jit = jax.jit(_impl)

        @functools.partial(jax.jit, static_argnames=("k",))
        def kernel(x, k=1):
            return x * k

        def drain(queue, arr, pad):
            out = []
            while queue:
                queue.pop()
                out.append(kernel(arr))   # constant shape per drain
            return out
    """)
    assert fs == []


# ------------------------------------------------------------------- GL004


def test_gl004_fires_on_attr_store_in_traced_scope(k, tmp_path):
    fs = lint_src(k, tmp_path, """
        import jax

        def _impl(holder, x):
            holder.last = x
            return x + 1

        impl_jit = jax.jit(_impl)
    """)
    assert rules_of(fs) == ["GL004"]


def test_gl004_fires_on_global_append(k, tmp_path):
    fs = lint_src(k, tmp_path, """
        import jax

        TRACE_LOG = []

        @jax.jit
        def kernel(x):
            TRACE_LOG.append(x)
            return x + 1
    """)
    assert rules_of(fs) == ["GL004"]


def test_gl004_silent_on_pure_kernel_with_local_state(k, tmp_path):
    fs = lint_src(k, tmp_path, """
        import jax
        from jax import lax

        @jax.jit
        def loop(x):
            acc = []
            acc.append(x)          # local container: fine

            def body(c):
                s, i = c
                return (s + 1, i + 1)

            def cond(c):
                return c[1] < 4

            return lax.while_loop(cond, body, (x, 0)), acc
    """)
    assert fs == []


# ------------------------------------------------------------------- GL005


GL005_BAD = """
    import numpy as np

    class Snapshot:
        def __init__(self, n):
            self.requested = np.zeros((n, 4), dtype=np.int32)
            self.version = 0
            self.dirty = set()

        def write_row(self, i, row):
            self.requested[i] = row
"""


def test_gl005_fires_on_unannounced_row_write(k, tmp_path):
    fs = lint_src(k, tmp_path, GL005_BAD)
    assert rules_of(fs) == ["GL005"]


def test_gl005_silent_when_announced_or_blessed(k, tmp_path):
    fs = lint_src(k, tmp_path, GL005_BAD.replace(
        "self.requested[i] = row",
        "self.requested[i] = row\n"
        "            self.dirty.add(\"requested\")\n"
        "            self.version += 1"))
    assert fs == []
    fs = lint_src(k, tmp_path, GL005_BAD.replace(
        "        def write_row(self, i, row):",
        "        # graftlint: gen-ok — caller owns the dirty note\n"
        "        def write_row(self, i, row):"), name="blessed.py")
    assert fs == []


def test_gl005_silent_on_nonsnapshot_labels(k, tmp_path):
    """A Pod's labels dict shares the attribute name but carries no
    generation machinery — out of scope by construction."""
    fs = lint_src(k, tmp_path, """
        def admit(req):
            req.obj.labels["key"] = "value"
    """)
    assert fs == []


def test_gl005_fires_via_local_alias(k, tmp_path):
    fs = lint_src(k, tmp_path, """
        import numpy as np

        class Snapshot:
            def __init__(self, n):
                self.requested = np.zeros((n, 4), dtype=np.int32)
                self.dirty = set()

            def write(self, idx, rows):
                requested = self.requested
                requested[idx] = rows
    """)
    assert rules_of(fs) == ["GL005"]


def test_gl005_fires_on_label_delta_patch_without_gen(k, tmp_path):
    """ISSUE 8: the Protean label-row delta patch is a snapshot
    dynamic-row write like any other — skipping the labels_gen
    announcement would let every consumer keyed on it (the wave
    encoding's topology views) silently go stale. The patch shape
    without the announcement must fire; the shipped shape (gen bump +
    patch-log append) is silent."""
    src = """
        import numpy as np

        class Snapshot:
            def __init__(self, n, l):
                self.labels = np.zeros((n, l), dtype=np.int8)
                self.labels_gen = 0
                self.dirty = set()
                self._labels_log = []

            def patch_row(self, i, row):
                self.labels[i] = row
    """
    fs = lint_src(k, tmp_path, src)
    assert rules_of(fs) == ["GL005"]
    fs = lint_src(k, tmp_path, src.replace(
        "self.labels[i] = row",
        "self.labels_gen += 1\n"
        "                self._labels_log.append((self.labels_gen, i))\n"
        "                self.labels[i] = row"))
    assert fs == []


def test_gl001_fires_on_frozen_patch_overlay_mutated_in_place(k, tmp_path):
    """ISSUE 8: the patched topology views back FROZEN device uploads —
    re-patching them IN PLACE (instead of the shipped copy-on-write:
    fresh array, patch, re-freeze) is exactly the r07 aliasing race with
    a churn trigger. The class-scoped lifetime makes GL001 fire; no new
    jitted entry point was added for the fence/patch paths (they are
    host-side numpy), so the registry needs no new coverage — this
    fixture pins the upload seam discipline instead."""
    fs = lint_src(k, tmp_path, """
        import numpy as np
        from kubernetes_tpu.analysis.sanitize import upload_frozen

        class Engine:
            def flush(self, enc):
                return upload_frozen(enc.key_node)

            def patch(self, enc, rows, fresh):
                enc.key_node[:, :, rows] = fresh
    """)
    assert rules_of(fs) == ["GL001"]


# ----------------------------------------------- review-hardening guards


def test_pragma_does_not_smear_over_the_function(k, tmp_path):
    """A sync-ok on one statement must NOT bless a different unblessed
    sync elsewhere in the same function (suppression anchors on the
    smallest enclosing statement; function-wide blessing requires the
    pragma on the def line itself)."""
    fs = lint_src(k, tmp_path, """
        import jax
        import numpy as np

        @jax.jit
        def kernel(x):
            return x + 1

        def hot(x):
            a = kernel(x)
            b = np.asarray(a)  # graftlint: sync-ok (this one is blessed)
            c = kernel(x)
            d = np.asarray(c)
            return b, d
    """)
    assert rules_of(fs) == ["GL002"]
    assert "np.asarray" in fs[0].message


def test_gl001_sees_through_upload_frozen(k, tmp_path):
    """upload_frozen is jnp.asarray underneath — with GRAFT_SANITIZE unset
    nothing seals the source, so mutating a frozen-seam buffer is the same
    production race and must fire GL001 like the bare spelling."""
    fs = lint_src(k, tmp_path, """
        import numpy as np
        from kubernetes_tpu.analysis import sanitize

        class Enc:
            def up(self):
                return sanitize.upload_frozen(self.wave_gate)

            def poke(self):
                self.wave_gate[0] = 1
    """)
    assert rules_of(fs) == ["GL001"]
    assert "upload_frozen" in fs[0].message


def test_gl002_survives_same_line_mixed_rebinds(k, tmp_path):
    """Two same-line rebinds of one name with mixed producers (jitted and
    not) must not crash the taint-event sort (None vs str comparison) —
    a lint-engine TypeError takes down the whole gate, not one rule."""
    fs = lint_src(k, tmp_path, """
        import jax
        import numpy as np

        @jax.jit
        def kernel(x):
            return x + 1

        def hot(x):
            out = kernel(x); out = np.zeros(3)
            return out
    """)
    assert fs == []


def test_empty_collection_fails_the_gate(k, tmp_path):
    """A typo'd path must fail loudly, not lint zero files and pass."""
    findings, _sup, errors = run_both(k, [str(tmp_path / "no_such_dir")])
    assert findings == [] and errors, errors
    ok, _report = k.lint_gate(str(tmp_path / "no_such_dir"))
    assert not ok


def test_bad_path_fails_even_beside_good_paths(k, tmp_path):
    """A typo'd path must fail the run even when OTHER paths yield files —
    else a CI arg list silently stops covering a renamed subtree."""
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    findings, _sup, errors = run_both(k, [str(good),
                                          str(tmp_path / "renamed_away")])
    assert findings == []
    assert any("renamed_away" in e for e in errors), errors


# ------------------------------------------------- baseline + CLI plumbing


def test_baseline_suppresses_and_survives_line_drift(k, tmp_path):
    src = """
        import jax.numpy as jnp
        import numpy as np

        def upload():
            buf = np.zeros(8)
            dev = jnp.asarray(buf)
            buf[0] = 1.0
            return dev
    """
    f = tmp_path / "mod.py"
    f.write_text(textwrap.dedent(src))
    findings, _s, _e = run_both(k, [str(f)])
    assert len(findings) == 1
    bpath = tmp_path / "baseline.json"
    k.write_baseline(str(bpath), findings)
    base = k.load_baseline(str(bpath))
    # shift every line down: the fingerprint (rule, path, qualname,
    # message) must keep matching
    f.write_text("# a new header comment\n# another\n"
                 + textwrap.dedent(src))
    findings2, sup, _e = run_both(k, [str(f)], baseline=base)
    assert findings2 == [] and sup == 1


def test_cli_clean_and_failing_exit_codes(k, tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax\n\ndef f(xs):\n"
                   "    g = jax.jit(lambda a: a)\n    return g(xs)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", f"{k.root}.analysis", str(bad)],
        capture_output=True, text=True, env=env,
        cwd=REPO)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "GL003" in r.stdout
    r2 = subprocess.run(
        [sys.executable, "-m", f"{k.root}.analysis", "--list-rules"],
        capture_output=True, text=True, env=env,
        cwd=REPO)
    assert r2.returncode == 0 and "GL005" in r2.stdout


def test_baseline_path_form_stable_relative_vs_absolute(k, tmp_path,
                                                        monkeypatch):
    """A baseline written while linting a RELATIVE path must still
    suppress when the same files are linted via the absolute dir
    (lint_gate's default) — fingerprints must not embed the invocation
    spelling of the path."""
    pkg = tmp_path / "proj" / "pkg"
    pkg.mkdir(parents=True)
    (pkg / "mod.py").write_text(
        "import numpy as np\nimport jax.numpy as jnp\n\n"
        "def f():\n    b = np.zeros(4)\n"
        "    d = jnp.asarray(b)\n    b[0] = 1\n    return d\n")
    monkeypatch.chdir(tmp_path / "proj")
    findings, _s, _e = run_both(k, ["pkg"])
    assert len(findings) == 1
    bpath = tmp_path / "b.json"
    k.write_baseline(str(bpath), findings)
    findings2, sup, _e = run_both(k, [str(pkg)],
                                   baseline=k.load_baseline(str(bpath)))
    assert findings2 == [] and sup == 1


def test_write_baseline_roundtrip_json(k, tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import numpy as np\nimport jax.numpy as jnp\n\n"
                   "def f():\n    b = np.zeros(4)\n"
                   "    d = jnp.asarray(b)\n    b[0] = 1\n    return d\n")
    bpath = tmp_path / "b.json"
    findings, _s, _e = run_both(k, [str(bad)])
    k.write_baseline(str(bpath), findings)
    data = json.loads(bpath.read_text())
    assert len(data["suppressions"]) == 1
    findings2, sup, _e = run_both(k, [str(bad)],
                                   baseline=k.load_baseline(str(bpath)))
    assert findings2 == [] and sup == 1


def test_fingerprints_stable_across_cwd(k, tmp_path, monkeypatch):
    """The same IN-REPO file must fingerprint identically whatever CWD the
    linter runs from — a baseline regenerated by CI at the repo root must
    keep suppressing for a wrapper script running elsewhere."""

    target = os.path.join(PKG_DIRS[k.root], "engine", "waves.py")
    monkeypatch.chdir(REPO)
    a = k.analysis_lint._relpath(target)
    monkeypatch.chdir(tmp_path)
    b = k.analysis_lint._relpath(target)
    assert a == b == os.path.join(k.root, "engine", "waves.py")


def test_write_baseline_reports_parse_errors(k, tmp_path, capsys):
    """--write-baseline over a tree with an unparseable file must fail
    (exit 1) and say so — a 'successful' regeneration that silently
    shrank coverage resurfaces the broken file's findings unsuppressed
    the moment it is fixed."""

    (tmp_path / "ok.py").write_text("x = 1\n")
    (tmp_path / "broken.py").write_text("def broken(:\n")
    bpath = tmp_path / "b.json"
    rc = k.main(["--write-baseline", str(bpath), str(tmp_path)])
    err = capsys.readouterr().err
    assert rc == 1
    assert "broken.py" in err


def test_write_baseline_regen_keeps_inherited_suppressions(k, tmp_path,
                                                           capsys):
    """--baseline old --write-baseline new must regenerate from the
    UNFILTERED findings: the old file's suppressions land in the new one
    instead of being silently dropped (which would resurrect them as
    fresh findings on the very next --baseline run)."""

    bad = tmp_path / "bad.py"
    bad.write_text("import numpy as np\nimport jax.numpy as jnp\n\n"
                   "def f():\n    b = np.zeros(4)\n"
                   "    d = jnp.asarray(b)\n    b[0] = 1\n    return d\n")
    old = tmp_path / "old.json"
    new = tmp_path / "new.json"
    assert k.main(["--write-baseline", str(old), str(bad)]) == 0
    assert k.main(["--baseline", str(old), "--write-baseline", str(new),
                   str(bad)]) == 0
    capsys.readouterr()
    assert k.load_baseline(str(new)) == k.load_baseline(str(old)) != {}
    assert k.main(["--baseline", str(new), str(bad)]) == 0


# ------------------------------------------------------- the tier-1 gate


def test_tree_lints_clean(port_gate):
    """THE gate, over the port's tree (lint_gate()'s default) with no
    baseline: zero findings. tests/test_graftlint.py holds the
    reference's tree to the same gate."""
    ok, report, _seconds = port_gate
    assert ok, f"graftlint gate failed:\n{report}"


def test_gate_is_pure_ast_fast(port_gate):
    """The reference's speed guard under its own 20 s bound, on the one
    gate run over the port's tree: a regression guard against a rule
    going super-linear, not an SLO."""
    _ok, _report, seconds = port_gate
    assert seconds < 20.0


# ------------------------------------------------- ISSUE 12: mesh seams


def test_gl001_fires_on_shard_resident_fold_alias(k, tmp_path):
    """The shard-resident buffer lifecycle (ISSUE 12): a host array that
    backs a RESIDENT sharded upload while a later fold mutates it in
    place is the committed_nodes race at mesh scale — degrading the
    copying upload (sanitize.upload_copied(..., sharding=...) /
    ResidentMesh.update_rows' per-slice np.array) to a zero-copy
    jnp.asarray must fire; the shipped copying shape stays silent."""
    bad = lint_src(k, tmp_path, """
        import jax.numpy as jnp
        import numpy as np

        class ResidentEngine:
            def sync_shards(self, enc):
                # sharded residency built over an alias of the live fold
                # target — the regression GL001 exists to reject
                return jnp.asarray(enc.committed_nodes)

            def fold(self, enc, cls, node):
                np.add.at(enc.committed_nodes, (cls, node), 1)
    """)
    assert rules_of(bad) == ["GL001"]
    good = lint_src(k, tmp_path, """
        import jax
        import numpy as np

        class ResidentEngine:
            def sync_shards(self, enc, sharding):
                # the shipped seam: copy host-side BEFORE placement, so
                # even a zero-copy per-shard device_put aliases only the
                # throwaway copy (sanitize.upload_copied(sharding=...) /
                # mesh.ResidentMesh.update_rows)
                return jax.device_put(np.array(enc.committed_nodes),
                                      sharding)

            def fold(self, enc, cls, node):
                np.add.at(enc.committed_nodes, (cls, node), 1)
    """)
    assert not [f for f in good if f.rule == "GL001"], good


def test_gl003_fires_on_ragged_per_shard_slice_into_reduce(k, tmp_path):
    """ISSUE 12: the two-stage winner reduce consumes PER-SHARD candidate
    rows — a host loop slicing the candidate table to data-dependent
    per-shard offsets before a registered jitted entry point is the
    recompile storm at mesh scale (one compile per ragged shard width).
    The shipped shape — the whole [D, C] table into ONE program, shard
    ownership resolved inside — stays silent."""
    waves_py = os.path.join(REF_DIR, "engine", "waves.py")
    bad = tmp_path / "ragged_reduce.py"
    bad.write_text(textwrap.dedent("""
        from kubernetes_tpu.engine.waves import waves_loop

        def combine(shard_offs, cls_arr, nodes, state, pc, ctr, prios):
            out = []
            for d in range(len(shard_offs) - 1):
                lo, hi = shard_offs[d], shard_offs[d + 1]
                out.append(waves_loop(cls_arr, nodes, state, pc[lo:hi],
                                      ctr, prios))
            return out
    """))
    findings, _sup, errors = run_both(k, [waves_py, str(bad)],
                                       rules=["GL003"])
    assert not errors, errors
    assert any(f.rule == "GL003" and "combine" in f.context
               for f in findings), findings
    good = tmp_path / "whole_table_reduce.py"
    good.write_text(textwrap.dedent("""
        from kubernetes_tpu.engine.waves import waves_loop

        def combine(cls_arr, nodes, state, pc_all, ctr, prios):
            # one program over the WHOLE padded table; shard ownership is
            # the device program's job (waves_loop spmd_mesh), never a
            # host-side ragged slice
            return waves_loop(cls_arr, nodes, state, pc_all, ctr, prios)
    """))
    findings, _sup, errors = run_both(k, [waves_py, str(good)],
                                       rules=["GL003"])
    assert not errors, errors
    assert not [f for f in findings if f.rule == "GL003"
                and "whole_table_reduce" in f.path], findings


def test_gl002_flight_recorder_stays_host_pure(k, tmp_path):
    """ISSUE 13: the flight recorder's emit sites record TIMESTAMPS and
    host ints already in hand — they never fetch a device value (one
    unblessed fetch per wave "to log it" would serialize the pipeline at
    the dispatch seam, the exact hazard the overlap story rests on). The
    registry built over the REAL engine sources must produce ZERO GL002
    findings over the observability modules and the port's span ring
    (which times what the reference's per-wave recorder kinds timed); a
    wave span that DOES fetch a jitted result to tag itself fires — the
    silence is the recorder's purity, not the rule going blind."""
    import ast

    eng_py = os.path.join(REF_DIR, "engine", "scheduler_engine.py")
    waves_py = os.path.join(REF_DIR, "engine", "waves.py")
    obs_files = [
        os.path.join(REF_DIR, "observability", "recorder.py"),
        os.path.join(REF_DIR, "observability", "registry.py"),
        os.path.join(REF_DIR, "observability", "perfetto.py"),
        # the port's span ring and its exporter: the per-wave records
        # the reference's recorder kinds became
        os.path.join(PKG_DIRS[PORT], "utils", "trace.py"),
        os.path.join(PKG_DIRS[PORT], "observability", "perfetto.py"),
    ]
    # scan sanity: an empty jit registry would pass vacuously
    index = k.ProjectIndex()
    for src in (eng_py, waves_py):
        with open(src, "r", encoding="utf-8") as fh:
            index.scan(ast.parse(fh.read()))
    assert "waves_loop" in index.jitted_names
    findings, _sup, errors = run_both(k, [eng_py, waves_py] + obs_files,
                                       rules=["GL002"])
    assert not errors, errors
    tainted = [f for f in findings
               if any(os.path.basename(o) in f.path for o in obs_files)]
    assert not tainted, tainted
    # negative control: a wave span that fetches the jitted packed
    # result to fill its fields fires GL002
    bad = tmp_path / "bad_recorder_emit.py"
    bad.write_text(textwrap.dedent("""
        import numpy as np
        from kubernetes_tpu.engine.waves import waves_loop
        from kubernetes_tpu_torch.utils.trace import timed_span

        def record_wave(cls_arr, nodes, state, pc, ctr, prios):
            packed, _st = waves_loop(cls_arr, nodes, state, pc, ctr,
                                     prios)
            fetched = np.asarray(packed)
            with timed_span("pipeline.harvest", wave=int(fetched[0])):
                return fetched
    """))
    findings, _sup, errors = run_both(k, [waves_py, str(bad)],
                                       rules=["GL002"])
    assert not errors, errors
    assert any(f.rule == "GL002" and "record_wave" in f.context
               for f in findings), findings
    # the shipped shape — a span around the launch tagged with a host
    # int, no device touch — is silent even when it calls the jitted
    # entry point in the same scope
    good = tmp_path / "good_recorder_emit.py"
    good.write_text(textwrap.dedent("""
        from kubernetes_tpu.engine.waves import waves_loop
        from kubernetes_tpu_torch.utils.trace import timed_span

        def record_wave(cls_arr, nodes, state, pc, ctr, prios, wave):
            with timed_span("pipeline.dispatch", wave=wave):
                packed, _st = waves_loop(cls_arr, nodes, state, pc, ctr,
                                         prios)
            return packed
    """))
    findings, _sup, errors = run_both(k, [waves_py, str(good)],
                                       rules=["GL002"])
    assert not errors, errors
    assert not [f for f in findings if "good_recorder_emit" in f.path], \
        findings

def test_gl002_podtrace_slo_seams_stay_host_pure(k, tmp_path):
    """ISSUE 15: the pod tracer and SLO engine stamp TIMESTAMPS and host
    ints already in hand — a per-pod trace that fetched a device value
    to fill an event would serialize the pipeline at every sampled pod,
    the exact GL002 hazard at per-pod (not per-wave) cadence. The
    registry built over the REAL engine sources produces ZERO GL002
    findings over podtrace/slo/trend; a trace consumer that fetches the
    jitted packed result to stamp a timeline FIRES (the silence is the
    tracer's purity, not the rule going blind)."""
    import ast

    eng_py = os.path.join(REF_DIR, "engine", "scheduler_engine.py")
    waves_py = os.path.join(REF_DIR, "engine", "waves.py")
    obs_files = [
        os.path.join(REF_DIR, "observability", "podtrace.py"),
        os.path.join(REF_DIR, "observability", "slo.py"),
        os.path.join(REF_DIR, "observability", "trend.py"),
    ]
    # scan sanity: an empty jit registry would pass vacuously
    index = k.ProjectIndex()
    for src in (eng_py, waves_py):
        with open(src, "r", encoding="utf-8") as fh:
            index.scan(ast.parse(fh.read()))
    assert "waves_loop" in index.jitted_names
    findings, _sup, errors = run_both(k, [eng_py, waves_py] + obs_files,
                                       rules=["GL002"])
    assert not errors, errors
    tainted = [f for f in findings
               if any(os.path.basename(o) in f.path for o in obs_files)]
    assert not tainted, tainted
    # negative control: a per-pod stamp that fetches the jitted packed
    # result to populate its event fields fires GL002
    bad = tmp_path / "bad_podtrace_emit.py"
    bad.write_text(textwrap.dedent("""
        import numpy as np
        from kubernetes_tpu.engine.waves import waves_loop
        from kubernetes_tpu.observability.podtrace import (
            HARVESTED,
            TRACER,
        )

        def trace_wave(cls_arr, nodes, state, pc, ctr, prios, keys):
            packed, _st = waves_loop(cls_arr, nodes, state, pc, ctr,
                                     prios)
            fetched = np.asarray(packed)
            TRACER.batch_event(HARVESTED, keys, a=int(fetched[0]))
            return fetched
    """))
    findings, _sup, errors = run_both(k, [waves_py, str(bad)],
                                       rules=["GL002"])
    assert not errors, errors
    assert any(f.rule == "GL002" and "trace_wave" in f.context
               for f in findings), findings
    # the shipped shape — keys + wave id + a host timestamp beside the
    # same jitted call — is silent
    good = tmp_path / "good_podtrace_emit.py"
    good.write_text(textwrap.dedent("""
        import time
        from kubernetes_tpu.engine.waves import waves_loop
        from kubernetes_tpu.observability.podtrace import (
            WAVE_DISPATCHED,
            TRACER,
        )

        def trace_wave(cls_arr, nodes, state, pc, ctr, prios, keys, wid):
            packed, _st = waves_loop(cls_arr, nodes, state, pc, ctr,
                                     prios)
            if TRACER.enabled:
                TRACER.batch_event(WAVE_DISPATCHED, keys, a=wid,
                                   t0=time.monotonic())
            return packed
    """))
    findings, _sup, errors = run_both(k, [waves_py, str(good)],
                                       rules=["GL002"])
    assert not errors, errors
    assert not [f for f in findings if "good_podtrace_emit" in f.path], \
        findings


# --------------------------------------- ISSUE 17: fast-lane eval seam


def test_gl002_registry_covers_fastlane_sample_eval(k, tmp_path):
    """ISSUE 17: the fast lane's [1, k] sampled eval is a jitted entry
    point (ops/fastlane.sample_eval) — the project-wide registry must
    pick it up from the REAL source so GL002 taint extends to consumers.
    An unblessed fetch here sits INSIDE the sub-10 ms bind path: one
    accidental sync against a busy device queue is the whole budget."""
    import ast

    fl_py = os.path.join(REF_DIR, "ops", "fastlane.py")
    with open(fl_py, "r", encoding="utf-8") as fh:
        index = k.ProjectIndex()
        index.scan(ast.parse(fh.read()))
    assert "sample_eval" in index.jitted_names
    fixture = tmp_path / "fast_bind.py"
    fixture.write_text(textwrap.dedent("""
        import numpy as np
        from kubernetes_tpu.ops.fastlane import sample_eval

        def fast_bind(idx, req, nodes):
            out = sample_eval(idx, req, False, False, nodes)
            return np.asarray(out)
    """))
    findings, _sup, errors = run_both(k, [fl_py, str(fixture)],
                                       rules=["GL002"])
    assert not errors, errors
    assert any(f.rule == "GL002" and "fast_bind" in f.context
               for f in findings), findings
    # the blessed fetch — the lane's documented synchronous consume
    # (device dispatched only when idle, so the wait IS the eval)
    fixture.write_text(fixture.read_text().replace(
        "return np.asarray(out)",
        "return np.asarray(out)  # graftlint: sync-ok"))
    findings, _sup, errors = run_both(k, [fl_py, str(fixture)],
                                       rules=["GL002"])
    assert not errors, errors
    assert not [f for f in findings if "fast_bind" in f.context], \
        findings


def test_gl003_fires_on_ragged_fastlane_sample(k, tmp_path):
    """ISSUE 17: a data-dependent k-slice feeding the sampled eval would
    mint one XLA compile per distinct candidate count (the GL003 storm,
    paid on the LATENCY path); the fixed-[1, k] shape the lane actually
    dispatches — resampling re-fills the same width — stays silent."""
    fl_py = os.path.join(REF_DIR, "ops", "fastlane.py")
    bad = tmp_path / "ragged_sample.py"
    bad.write_text(textwrap.dedent("""
        from kubernetes_tpu.ops.fastlane import sample_eval

        def probe(pods, idx, req, nodes):
            out = []
            while pods:
                k = pods.pop()
                out.append(sample_eval(idx[:k], req, False, False,
                                       nodes))
            return out
    """))
    findings, _sup, errors = run_both(k, [fl_py, str(bad)],
                                       rules=["GL003"])
    assert not errors, errors
    assert any(f.rule == "GL003" and "probe" in f.context
               for f in findings), findings
    good = tmp_path / "fixed_sample.py"
    good.write_text(textwrap.dedent("""
        import numpy as np
        from kubernetes_tpu.ops.fastlane import sample_eval

        def probe(pods, draw, req, nodes, k):
            out = []
            while pods:
                pods.pop()
                idx = np.zeros(k, dtype=np.int32)
                idx[:] = draw(k)
                out.append(sample_eval(idx, req, False, False, nodes))
            return out
    """))
    findings, _sup, errors = run_both(k, [fl_py, str(good)],
                                       rules=["GL003"])
    assert not errors, errors
    assert not [f for f in findings if f.rule == "GL003"
                and "fixed_sample" in f.path], findings


# ---------------------- ISSUE 19: the concurrency family (GL006-GL009)


GL006_INVERSION = """
    import threading

    class Cell:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()

        def forward(self):
            with self._a:
                with self._b:
                    pass

        def backward(self):
            with self._b:
                with self._a:
                    pass
"""


def test_gl006_fires_on_two_lock_inversion(k, tmp_path):
    """The deliberate ABBA reintroduction: both nesting directions exist,
    so BOTH observed edges sit on the cycle and each site fires."""
    fs = lint_src(k, tmp_path, GL006_INVERSION, rules=["GL006"])
    assert rules_of(fs) == ["GL006", "GL006"]
    assert all("lock-order cycle" in f.message for f in fs)
    assert "'Cell._a'" in fs[0].message and "'Cell._b'" in fs[0].message


def test_gl006_silent_on_consistent_order(k, tmp_path):
    fs = lint_src(k, tmp_path, """
        import threading

        class Cell:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def forward(self):
                with self._a:
                    with self._b:
                        pass

            def also_forward(self):
                with self._a:
                    with self._b:
                        pass
    """, rules=["GL006"])
    assert fs == []


def test_gl006_cycle_across_files(k, tmp_path):
    """One direction per FILE: the cycle only exists project-wide, which
    is exactly what the prepare() pass-1.5 graph is for."""
    (tmp_path / "fwd.py").write_text(textwrap.dedent("""
        import threading

        class Cell:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def forward(self):
                with self._a:
                    with self._b:
                        pass
    """))
    (tmp_path / "bwd.py").write_text(textwrap.dedent("""
        import threading

        class Cell:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def backward(self):
                with self._b:
                    with self._a:
                        pass
    """))
    findings, _s, errors = run_both(k, [str(tmp_path)], rules=["GL006"])
    assert not errors
    assert len(findings) == 2  # one per participating site, per file
    assert {os.path.basename(f.path) for f in findings} == \
        {"fwd.py", "bwd.py"}


def test_gl006_declared_order_catches_lone_inversion(k, tmp_path):
    """A `lock-order(...)` declaration blesses A->B project-wide, so a
    single B->A nesting fires even though the forward `with` nesting is
    never written anywhere."""
    fs = lint_src(k, tmp_path, """
        import threading

        # graftlint: lock-order(Cell._a,Cell._b)

        class Cell:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def backward(self):
                with self._b:
                    with self._a:
                        pass
    """, rules=["GL006"])
    assert rules_of(fs) == ["GL006"]
    assert "declared lock-order" in fs[0].message


def test_gl006_fires_on_self_deadlock_and_spares_rlock(k, tmp_path):
    bad = lint_src(k, tmp_path, """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()

            def work(self):
                with self._lock:
                    with self._lock:
                        pass
    """, rules=["GL006"])
    assert rules_of(bad) == ["GL006"]
    assert "re-acquiring non-reentrant" in bad[0].message
    good = lint_src(k, tmp_path, """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.RLock()

            def work(self):
                with self._lock:
                    with self._lock:
                        pass
    """, name="good.py", rules=["GL006"])
    assert good == []


def test_gl006_lock_ok_pragma_blesses_site(k, tmp_path):
    fs = lint_src(k, tmp_path, """
        import threading

        class Cell:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def forward(self):
                with self._a:
                    with self._b:  # graftlint: lock-ok
                        pass

            def backward(self):
                with self._b:
                    with self._a:  # graftlint: lock-ok
                        pass
    """, rules=["GL006"])
    assert fs == []


# ------------------------------------------------------------------- GL007


GL007_TORN_COUNTER = """
    import threading

    class Counter:
        def __init__(self):
            self._lock = threading.Lock()
            self._v = 0

        def inc(self):
            with self._lock:
                self._v += 1

        def reset(self):
            self._v = 0

        def peek(self):
            return self._v
"""


def test_gl007_fires_on_torn_counter_regression(k, tmp_path):
    """The r18 metrics-audit regression, reintroduced deliberately: one
    guarded writer, one STRAY unguarded write and one bare read — the
    stray write must not demote the field (it IS the bug), and both
    unguarded accesses fire."""
    fs = lint_src(k, tmp_path, GL007_TORN_COUNTER, rules=["GL007"])
    assert rules_of(fs) == ["GL007", "GL007"]
    assert "torn write" in fs[0].message  # reset
    assert "torn read" in fs[1].message   # peek


def test_gl007_silent_when_guarded_or_locked_helper(k, tmp_path):
    fs = lint_src(k, tmp_path, """
        import threading

        class Counter:
            def __init__(self):
                self._lock = threading.Lock()
                self._v = 0

            def inc(self):
                with self._lock:
                    self._inc_locked()

            def _inc_locked(self):
                self._v += 1

            def peek(self):
                with self._lock:
                    return self._v
    """, rules=["GL007"])
    assert fs == []


def test_gl007_torn_ok_pragma_blesses_stale_read(k, tmp_path):
    fs = lint_src(k, tmp_path, """
        import threading

        class Counter:
            def __init__(self):
                self._lock = threading.Lock()
                self._v = 0

            def inc(self):
                with self._lock:
                    self._v += 1

            def peek(self):
                # single int, CPython store is atomic; staleness is fine
                # for a monitoring read. graftlint: torn-ok
                return self._v
    """, rules=["GL007"])
    assert fs == []


def test_gl007_ignores_unguarded_fields(k, tmp_path):
    """A field NEVER written under the lock belongs to some other
    discipline (a loop-owned field, a config constant) — not GL007's."""
    fs = lint_src(k, tmp_path, """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.mode = "idle"

            def flip(self):
                self.mode = "busy"

            def show(self):
                return self.mode
    """, rules=["GL007"])
    assert fs == []


# ------------------------------------------------------------------- GL008


def test_gl008_fires_on_blocking_shapes_in_async_def(k, tmp_path):
    fs = lint_src(k, tmp_path, """
        import socket
        import threading
        import time

        class Srv:
            def __init__(self):
                self._lock = threading.Lock()

            async def handle(self, sock):
                time.sleep(0.01)
                with self._lock:
                    pass
                data = sock.recv(4)
                self._lock.acquire()
                return data
    """, rules=["GL008"])
    assert rules_of(fs) == ["GL008"] * 4
    msgs = "\n".join(f.message for f in fs)
    assert "time.sleep" in msgs
    assert "threading lock self._lock" in msgs
    assert ".recv()" in msgs


def test_gl008_fires_on_device_sync_in_async_def(k, tmp_path):
    fs = lint_src(k, tmp_path, """
        import jax
        import numpy as np

        @jax.jit
        def kernel(x):
            return x

        class Srv:
            async def pump(self, xs):
                out = kernel(xs)
                return np.asarray(out)
    """, rules=["GL008"])
    assert rules_of(fs) == ["GL008"]
    assert "device->host sync" in fs[0].message


def test_gl008_silent_on_async_twins_and_executor_hop(k, tmp_path):
    """The blessed shapes: await asyncio.sleep, and blocking work INSIDE
    the lambda handed to run_in_executor — that body runs on a worker
    thread, not the loop (asyncwire's actual idiom)."""
    fs = lint_src(k, tmp_path, """
        import asyncio
        import threading
        import time

        class Srv:
            def __init__(self):
                self._lock = threading.Lock()

            def _sync_work(self):
                with self._lock:
                    time.sleep(0.001)

            async def handle(self, loop):
                await asyncio.sleep(0.01)
                await loop.run_in_executor(None, lambda: self._sync_work())
    """, rules=["GL008"])
    assert fs == []


def test_gl008_block_ok_pragma_blesses_tiny_section(k, tmp_path):
    fs = lint_src(k, tmp_path, """
        import threading

        class Srv:
            def __init__(self):
                self._lock = threading.Lock()

            async def handle(self):
                with self._lock:  # graftlint: block-ok
                    pass
    """, rules=["GL008"])
    assert fs == []


# ------------------------------------------------------------------- GL009


def test_gl009_fires_on_lambda_and_bound_method_targets(k, tmp_path):
    fs = lint_src(k, tmp_path, """
        import multiprocessing as mp
        import threading

        class Owner:
            def __init__(self):
                self._lock = threading.Lock()

            def run(self):
                pass

            def boot(self):
                a = mp.Process(target=lambda: None)
                b = mp.Process(target=self.run)
                return a, b
    """, rules=["GL009"])
    assert rules_of(fs) == ["GL009", "GL009"]
    assert "lambda" in fs[0].message
    assert "bound method" in fs[1].message and "_lock" in fs[1].message


def test_gl009_fires_on_module_state_capture_and_global_write(k, tmp_path):
    fs = lint_src(k, tmp_path, """
        import multiprocessing as mp
        import threading

        _TABLE = {}
        _LOCK = threading.Lock()
        _TOTAL = 0

        def worker(cfg):
            global _TOTAL
            with _LOCK:
                _TABLE[cfg] = 1
                _TOTAL += 1

        def boot():
            p = mp.Process(target=worker, args=(1,))
            p.start()
    """, rules=["GL009"])
    msgs = "\n".join(f.message for f in fs)
    assert "_TABLE" in msgs and "mutable state" in msgs
    assert "_LOCK" in msgs and "synchronizes nothing" in msgs
    assert "_TOTAL" in msgs and "CHILD's module" in msgs


def test_gl009_silent_on_picklable_config_worker(k, tmp_path):
    """The multiproc.py discipline: a module-level def handed everything
    through picklable args; module CONSTANTS (ints, strings, compiled
    regexes) are not hazards."""
    fs = lint_src(k, tmp_path, """
        import multiprocessing as mp
        import re

        _OWNER_RE = re.compile(r"owner=(\\w+)")
        MAX_EVENTS = 4096

        def worker(cfg, queue):
            n = min(cfg["n"], MAX_EVENTS)
            m = _OWNER_RE.match(cfg["line"])
            queue.put((n, m and m.group(1)))

        def boot(q):
            ctx = mp.get_context("spawn")
            p = ctx.Process(target=worker, args=({"n": 1, "line": ""}, q))
            p.start()
            return p
    """, rules=["GL009"])
    assert fs == []


def test_gl009_spawn_ok_pragma_blesses_readonly_table(k, tmp_path):
    fs = lint_src(k, tmp_path, """
        import multiprocessing as mp

        _CANNED = {"a": 1}

        def worker(q):
            # import-time-frozen table, mutated nowhere: the child's copy
            # is identical by construction. graftlint: spawn-ok
            q.put(_CANNED["a"])

        def boot(q):
            return mp.Process(target=worker, args=(q,))
    """, rules=["GL009"])
    assert fs == []


# --------------------------------------- concurrency family CLI plumbing


def test_cli_selective_concurrency_rules_exit_codes(k, tmp_path):
    """`--rules GL006,GL007,GL008,GL009` is the concurrency-only
    invocation: exit 1 on a torn counter, exit 0 once it is clean, and
    the same file keeps exit 0 when only OTHER rules are selected."""
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(GL007_TORN_COUNTER))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    conc = ["--rules", "GL006,GL007,GL008,GL009"]
    r = subprocess.run(
        [sys.executable, "-m", f"{k.root}.analysis", *conc, str(bad)],
        capture_output=True, text=True, env=env,
        cwd=REPO)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "GL007" in r.stdout
    r2 = subprocess.run(
        [sys.executable, "-m", f"{k.root}.analysis",
         "--rules", "GL001,GL002", str(bad)],
        capture_output=True, text=True, env=env,
        cwd=REPO)
    assert r2.returncode == 0, r2.stdout + r2.stderr
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    r3 = subprocess.run(
        [sys.executable, "-m", f"{k.root}.analysis", *conc,
         str(good)],
        capture_output=True, text=True, env=env,
        cwd=REPO)
    assert r3.returncode == 0, r3.stdout + r3.stderr


def test_cli_json_carries_by_rule_counters(k, tmp_path):
    import io
    from contextlib import redirect_stdout

    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(GL007_TORN_COUNTER))
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = k.main(["--rules", "GL006,GL007", "--json", str(bad)])
    data = json.loads(buf.getvalue())
    assert rc == 1
    assert data["by_rule"] == {"GL006": 0, "GL007": 2}
    full = io.StringIO()
    with redirect_stdout(full):
        k.main(["--json", str(bad)])
    data = json.loads(full.getvalue())
    assert set(data["by_rule"]) == {f"GL00{i}" for i in range(1, 10)}
    assert data["by_rule"]["GL007"] == 2


def test_list_rules_documents_concurrency_family(k, tmp_path):
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        assert k.main(["--list-rules"]) == 0
    out = buf.getvalue()
    for rid in ("GL006", "GL007", "GL008", "GL009"):
        assert rid in out, out


def test_gl007_baseline_fingerprint_survives_line_drift(k, tmp_path):
    """A baselined GL007 finding keeps suppressing after edits ABOVE it
    shift every line number — fingerprints anchor on qualname+message."""
    f = tmp_path / "mod.py"
    f.write_text(textwrap.dedent(GL007_TORN_COUNTER))
    findings, _s, _e = run_both(k, [str(f)], rules=["GL007"])
    assert len(findings) == 2
    bpath = tmp_path / "b.json"
    k.write_baseline(str(bpath), findings)
    f.write_text("# a new header comment\n# another\n\n"
                 + textwrap.dedent(GL007_TORN_COUNTER))
    findings2, sup, _e = run_both(k, [str(f)], rules=["GL007"],
                                   baseline=k.load_baseline(str(bpath)))
    assert findings2 == [] and sup == 2


def test_lint_gate_refuses_concurrency_dirty_tree(k, tmp_path):
    """`bench --lint-gate` refuses a tree carrying a torn counter or a
    lock-order hazard the same way it refuses an aliasing upload."""
    (tmp_path / "bad.py").write_text(textwrap.dedent(GL007_TORN_COUNTER))
    ok, report = k.lint_gate(str(tmp_path))
    assert not ok and "GL007" in report


# ----------------------------------------------------- federation (ISSUE 20)


def test_gl002_registry_covers_federation_route_scores(k, tmp_path):
    """ISSUE 20: the router's fused [C, M] scoring seam
    (ops/federation.route_scores) is a module-level jit bind — the
    project-wide registry must pick it up from the REAL source so GL002
    taint extends to consumers. An unblessed fetch of the routing
    verdict sits on the admission path: one accidental sync per batch
    is the router's whole sub-10 ms budget."""
    import ast

    fed_py = os.path.join(REF_DIR, "ops", "federation.py")
    with open(fed_py, "r", encoding="utf-8") as fh:
        index = k.ProjectIndex()
        index.scan(ast.parse(fh.read()))
    assert "route_scores" in index.jitted_names, \
        "route_scores missing from the jit registry"
    fixture = tmp_path / "route_batch.py"
    fixture.write_text(textwrap.dedent("""
        import numpy as np
        from kubernetes_tpu.ops.federation import route_scores

        def route_batch(dc, dm, cf, mf, cc, mc, pr, rd, dok):
            out = route_scores(dc, dm, cf, mf, cc, mc, pr, rd, dok)
            return np.asarray(out)
    """))
    findings, _sup, errors = run_both(k, [fed_py, str(fixture)],
                                       rules=["GL002"])
    assert not errors, errors
    assert any(f.rule == "GL002" and "route_batch" in f.context
               for f in findings), findings
    # the blessed fetch — the ONE routing-verdict transfer per batch
    # (the stacked [2, C] output exists exactly so there is one)
    fixture.write_text(fixture.read_text().replace(
        "return np.asarray(out)",
        "return np.asarray(out)  # graftlint: sync-ok"))
    findings, _sup, errors = run_both(k, [fed_py, str(fixture)],
                                       rules=["GL002"])
    assert not errors, errors
    assert not [f for f in findings if "route_batch" in f.context], \
        findings


def test_federation_pad_to_bucket_idiom_stays_silent(k, tmp_path):
    """The router's pad-to-bucket shape bounding (host-side np.pad of
    the C axis BEFORE the dispatch, trim after the blessed fetch) is
    the documented GL003 escape hatch one level up — the full rule set
    must stay silent on it."""
    fed_py = os.path.join(REF_DIR, "ops", "federation.py")
    fixture = tmp_path / "padded_route.py"
    fixture.write_text(textwrap.dedent("""
        import numpy as np
        from kubernetes_tpu.ops.federation import route_scores
        from kubernetes_tpu.ops.predicates import bucket

        def padded_route(dc, dm, cf, mf, cc, mc, pr, rd, dok):
            c = len(dc)
            cb = bucket(c)
            if cb != c:
                pad = cb - c
                dc = np.pad(dc, (0, pad))
                dm = np.pad(dm, (0, pad))
                dok = np.pad(dok, ((0, pad), (0, 0)),
                             constant_values=True)
            out = route_scores(dc, dm, cf, mf, cc, mc, pr, rd, dok)
            verdict = np.asarray(out)  # graftlint: sync-ok
            return verdict[:, :c]
    """))
    findings, _sup, errors = run_both(k, [fed_py, str(fixture)])
    assert not errors, errors
    assert not [f for f in findings if "padded_route" in f.context], \
        findings



# ============================================================
# the port's departures

MODULE_LOCKS = """
    import threading

    _A = threading.Lock()
    _B = threading.Lock()

    def forward():
        with _A:
            with _B:
                pass

    def backward():
        with _B:
            with _A:
                pass
"""


def test_module_id_folds_each_packages_own_prefix():
    ref_id = PKGS[REF].analysis_rules_base.module_id
    port_id = PKGS[PORT].analysis_rules_base.module_id
    for rel in ("engine/scheduler_engine.py", "api/pb/__init__.py",
                "parallel/mesh.py"):
        assert port_id(f"kubernetes_tpu_torch/{rel}") == \
            ref_id(f"kubernetes_tpu/{rel}")
    assert port_id("kubernetes_tpu_torch/api/pb/__init__.py") == "api.pb"
    assert port_id("./kubernetes_tpu_torch/engine/waves.py") == \
        "engine.waves"
    assert port_id("snippet.py") == ref_id("snippet.py") == "snippet"


def test_lock_ids_equal_once_the_package_prefix_is_rewritten(
        tmp_path, monkeypatch):
    """A module-level lock-order cycle in `<pkg>/engine/locks.py`, linted
    from the directory that holds `<pkg>`: each linter over its own
    package's path names the locks `engine.locks._A` and
    `engine.locks._B`, so the findings are equal once the package
    directory in the path is rewritten."""
    monkeypatch.chdir(tmp_path)
    seen = {}
    for root in (REF, PORT):
        f = os.path.join(root, "engine", "locks.py")
        os.makedirs(os.path.dirname(f))
        with open(f, "w") as fh:
            fh.write(textwrap.dedent(MODULE_LOCKS))
        findings, _sup, errors = PKGS[root].run_paths([f], rules=["GL006"])
        assert not errors, errors
        seen[root] = [tuple(str(v).replace(root + os.sep, "<pkg>" + os.sep)
                            for v in (x.rule, x.path, x.line, x.col,
                                      x.context, x.message))
                      for x in findings]
    assert seen[PORT] == seen[REF]
    assert len(seen[PORT]) == 2
    assert all("'engine.locks._A'" in m and "'engine.locks._B'" in m
               for *_, m in seen[PORT])


def test_gate_and_cli_default_to_the_ports_tree(capsys):
    """lint_gate() and `python -m kubernetes_tpu_torch.analysis` with no
    paths lint the port's package directory (the reference's default to
    its own is kept in its copy)."""
    lint = PKGS[PORT].analysis_lint
    seen = []
    real = lint.run_paths

    def spy(paths, **kw):
        seen.append(list(paths))
        return [], 0, []

    lint.run_paths = spy
    try:
        assert lint.lint_gate() == (
            True, "graftlint: 0 finding(s), 0 baseline-suppressed")
        main_mod = PKGS[PORT].analysis_main
        main_mod.run_paths, saved = spy, main_mod.run_paths
        try:
            assert main_mod.main([]) == 0
        finally:
            main_mod.run_paths = saved
    finally:
        lint.run_paths = real
    assert seen == [[PKG_DIRS[PORT]], [PKG_DIRS[PORT]]]
    assert "0 finding(s)" in capsys.readouterr().out


def test_cli_names_the_port(tmp_path, capsys):
    main = PKGS[PORT].analysis_main.main
    with pytest.raises(SystemExit):
        main(["--help"])
    assert capsys.readouterr().out.startswith(
        "usage: python -m kubernetes_tpu_torch.analysis")
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(MODULE_LOCKS))
    out = tmp_path / "baseline.json"
    assert main(["--write-baseline", str(out), str(bad)]) == 0
    assert "python -m kubernetes_tpu_torch.analysis --write-baseline" in \
        json.loads(out.read_text())["comment"]
