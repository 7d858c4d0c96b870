"""Whole runs of each cell through run.py on the CPU at a tiny size, and
the same runs with the program broken underneath the timed path: each
planted fault must turn `correct` false."""

import json
from pathlib import Path

import pytest

from benchmark import run
from benchmark.lib import faults

with open(Path(__file__).resolve().parents[2] / "BENCHMARK.json") as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


def _last_line(capsys, result):
    run.emit(result)
    out, err = capsys.readouterr()
    assert err.strip().splitlines()[-1].startswith("check score_regret ")
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run(cell, trace, tiny_spec, tiny, capsys):
    line = _last_line(capsys, run.run_cell(
        tiny_spec, cell, 2**31 + 12345, 0.6, bool(trace), device="cpu",
        params=tiny))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"] and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 300
    c = run.load_cell(tiny_spec, cell)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    # device metrics are read only from a card's trace
    got = set(line["metrics"])
    assert got <= want
    assert want - got <= {m for m in want if "roofline" in m or "idle" in m}
    assert all(v["value"] >= 0 for v in line["metrics"].values())
    if not trace:
        assert line["metrics"]["backlog_pods_s"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("kind", faults.FAULTS)
def test_planted_fault_turns_correct_false(cell, kind, tiny_spec, tiny,
                                           capsys):
    try:
        line = _last_line(capsys, run.run_cell(
            tiny_spec, cell, 77, 0.4, False, device="cpu", params=tiny,
            tweak=faults.tweak(kind)))
    finally:
        faults.undo()
    assert line["correct"] is False
    failed = [k for k, v in line["checks"].items()
              if v["value"] > v["limit"]]
    assert failed, line["checks"]
    if kind == "first_fit":
        assert failed == ["score_regret"], line["checks"]


def test_undo_restores_the_program(tiny_spec, tiny, capsys):
    from kubernetes_tpu_torch.engine import waves
    real = waves._pick
    faults._first_fit(type("W", (), {})())
    assert waves._pick is not real
    faults.undo()
    assert waves._pick is real



@pytest.mark.parametrize("cell", CELLS)
def test_reset_leaves_the_store_no_read_event(cell, tiny_spec, tiny,
                                              capsys):
    """Each episode's reset drops the watch events the scheduler has read,
    so that no episode's heap holds the pods of the ones before it; the
    episodes after a trim are still judged correct."""
    seen = {}
    line = _last_line(capsys, run.run_cell(
        tiny_spec, cell, 2**31 + 7, 0.6, False, device="cpu", params=tiny,
        tweak=lambda w: seen.setdefault("w", w)))
    w = seen["w"]
    assert line["correct"] is True and len(w.judged) >= 2
    assert all(e.rv > w.sched._rv for e in w.api._log)
    assert w.api.watch_since(("Pod", "Node"), w.sched._rv) == []

@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_on_the_card(cell, card, tiny_spec, tiny):
    line = run.run_cell(tiny_spec, cell, 5, 1.0, True, device=card,
                        params=tiny)
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
