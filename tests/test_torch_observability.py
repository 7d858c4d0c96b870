"""The port's trace exporter, trend reader and flight-recorder CLI
(observability/{perfetto,trend,__main__}.py) against the reference's.

- The perfetto bodies of tests/test_observability.py run on both
  packages (the `k` fixture): the lanes of a recorded pipelined drain
  with the host-tail-under-device-eval overlap visible, the fence lane's
  instants, and `overlap_seconds` against its pairwise reference.
- One recorder ring and one set of pod exemplars, recorded from a
  reference drain, render to equal Chrome trace JSON in both packages.
- `trend.main` over the repository's BENCH_r*.json files prints the same
  table and returns the same exit code in both packages, directly and
  through the CLI's `--trend`.
- The port's CLI with `--device cpu` writes a trace with one dispatch,
  one device-eval and one bind-flush span per wave its recorded drain
  dispatched (`engine.wave_dispatch`), and records the same waves as the
  reference's CLI.
Everything is compared exactly."""

from __future__ import annotations

import json

import numpy as np
import pytest

from tests.torch_packages import PORT, REF, Pkg

MODULES = {
    "scheduler": "engine.scheduler",
    "hollow": "models.hollow", "perfetto": "observability.perfetto",
    "rec": "observability.recorder", "podtrace": "observability.podtrace",
    "trend": "observability.trend", "cli": "observability.__main__",
    "lite": "server.apiserver_lite", "trace": "utils.trace",
}

PKGS = {REF: Pkg(REF, MODULES), PORT: Pkg(PORT, MODULES)}
DEVICE = {REF: {}, PORT: {"device": "cpu"}}


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return PKGS[request.param]


@pytest.fixture
def flight(k):
    """The package's process-wide ring, armed for one test and ALWAYS
    disarmed after: global state must never leak across tests."""
    recorder = k.rec.RECORDER
    recorder.clear()
    recorder.enable()
    try:
        yield recorder
    finally:
        recorder.disable()
        recorder.clear()


def mk_sched(k, n_nodes=64, n_pods=0):
    api = k.ApiServerLite()
    k.load_cluster(api, k.hollow_nodes(n_nodes),
                   k.PROFILES["density"](n_pods) if n_pods else [])
    s = k.Scheduler(api, record_events=False, **DEVICE[k.root])
    s.start()
    return api, s


def _close(sched):
    close = getattr(sched.engine, "close", None)
    if close is not None:
        close()


# ------------------------------------- tests/test_observability.py bodies


def test_perfetto_export_lanes_and_overlap(k, flight, tmp_path):
    """The exported timeline carries distinct host/device/fence lanes and
    the pipelined overlap is VISIBLE: at least one wave's device-eval
    window contains the previous wave's bind-flush."""
    api, s = mk_sched(k, n_pods=800)
    s.run_until_drained(max_batch=128)
    _close(s)
    ev = flight.snapshot()
    out = tmp_path / "trace.json"
    trace = k.perfetto.export_chrome_trace(ev, str(out))
    # the file is loadable chrome://tracing JSON (object form)
    loaded = json.loads(out.read_text())
    assert loaded["traceEvents"]
    lanes = {m["args"]["name"] for m in loaded["traceEvents"]
             if m.get("ph") == "M" and m["name"] == "thread_name"}
    assert lanes == {"host", "device", "fence", "preempt", "fastlane"}
    tids = {"host": None, "device": None}
    for m in trace["traceEvents"]:
        if m.get("ph") == "M" and m["name"] == "thread_name" \
                and m["args"]["name"] in tids:
            tids[m["args"]["name"]] = m["tid"]
    spans = [m for m in trace["traceEvents"] if m.get("ph") == "X"]
    host = [m for m in spans if m["tid"] == tids["host"]]
    device = [m for m in spans if m["tid"] == tids["device"]]
    assert host and device
    # overlap: some host bind-flush lies inside a LATER wave's device span
    flushes = [m for m in host if m["name"].startswith("bind-flush")]
    overlapped = any(
        d["ts"] <= f["ts"] and f["ts"] + f["dur"] <= d["ts"] + d["dur"]
        and d["name"] != f"device-eval {f['name'].split()[-1]}"
        for f in flushes for d in device)
    assert overlapped, (flushes, device)
    # and the quantitative form agrees
    assert k.perfetto.overlap_seconds(ev) > 0


def test_perfetto_fence_lane_markers(k, flight):
    """Fence-requeue / degraded / churn events render as instants on the
    fence lane."""
    rec = k.rec
    flight.record(rec.FENCE_REQUEUE, wave=3, a=2, b=1)
    flight.record(rec.DEGRADED, a=1, b=3)
    flight.record(rec.CHURN_OP, a=rec.CHURN_OP_CODES["kill"], b=1)
    trace = k.perfetto.build_chrome_trace(flight.snapshot())
    instants = [m for m in trace["traceEvents"] if m.get("ph") == "i"]
    names = {m["name"] for m in instants}
    assert {"fence-requeue w3", "degraded-enter", "churn:kill"} <= names
    assert all(m["tid"] == k.perfetto.TID_FENCE for m in instants)


def test_overlap_seconds_matches_pairwise_reference(k):
    """The O(n log n) union/prefix form must agree with the brute-force
    all-pairs intersection on a randomized event soup (and stay fast on
    a big ring — the full-ring export case)."""
    rng = np.random.default_rng(5)
    events = []
    t = 0.0
    for w in range(400):
        t += float(rng.uniform(0.001, 0.01))
        d_dur = float(rng.uniform(0.001, 0.02))
        events.append({"kind": "dispatch", "wave": w, "t": t,
                       "dur": d_dur, "a": 1, "b": 0})
        h0 = t + d_dur + float(rng.uniform(0.0, 0.01))
        b_dur = float(rng.uniform(0.001, 0.03))
        events.append({"kind": "harvest", "wave": w, "t": h0,
                       "dur": b_dur, "a": 1, "b": 0})
        events.append({"kind": "bind_flush", "wave": w,
                       "t": h0 + float(rng.uniform(-0.01, 0.01)),
                       "dur": float(rng.uniform(0.001, 0.02)),
                       "a": 1, "b": 0})

    def brute(evs):
        device, hostspans, dend = [], [], {}
        for e in evs:
            if e["kind"] == "dispatch":
                dend[e["wave"]] = e["t"] + e["dur"]
                hostspans.append((e["t"], e["t"] + e["dur"], e["wave"]))
            elif e["kind"] == "harvest":
                device.append((dend.get(e["wave"], e["t"]),
                               e["t"] + e["dur"], e["wave"]))
            elif e["kind"] == "bind_flush":
                hostspans.append((e["t"], e["t"] + e["dur"], e["wave"]))
        total = 0.0
        for h0, h1, hw in hostspans:
            cov = 0.0
            for d0, d1, dw in device:
                if dw == hw:
                    continue
                lo, hi = max(h0, d0), min(h1, d1)
                if hi > lo:
                    cov += hi - lo
            total += min(cov, h1 - h0)
        return total

    got = k.perfetto.overlap_seconds(events)
    ref = brute(events)
    # union-minus-own undercounts only where device windows of different
    # waves overlap each other (one batch owns the device at a time in
    # the real engine); on this soup windows DO overlap, so allow the
    # conservative side only
    assert got <= ref + 1e-9
    assert got >= 0.5 * ref  # and it is the same quantity, not garbage
    # non-overlapping device windows (the real engine's shape): exact
    seq = []
    t = 0.0
    for w in range(50):
        seq.append({"kind": "dispatch", "wave": w, "t": t, "dur": 0.002,
                    "a": 1, "b": 0})
        seq.append({"kind": "harvest", "wave": w, "t": t + 0.010,
                    "dur": 0.001, "a": 1, "b": 0})
        if w:
            seq.append({"kind": "bind_flush", "wave": w - 1,
                        "t": t + 0.004, "dur": 0.003, "a": 1, "b": 0})
        t += 0.012
    assert k.perfetto.overlap_seconds(seq) == pytest.approx(brute(seq))


# ------------------------------------------------ one ring, two exporters


@pytest.fixture(scope="module")
def recorded():
    """A reference drain recorded with the ring and the pod tracer (every
    pod sampled), plus fence, degraded, churn and preemption events and a
    wire conflict, as JSON-able dicts both exporters can take."""
    ref = PKGS[REF]
    recorder, tracer = ref.rec.RECORDER, ref.podtrace.TRACER
    saved = tracer.sample
    recorder.clear()
    tracer.clear()
    tracer.sample = 1
    recorder.enable()
    tracer.enable()
    try:
        _, s = mk_sched(ref, n_pods=600)
        s.run_until_drained(max_batch=128)
        recorder.record(ref.rec.FENCE_REQUEUE, wave=2, a=3, b=1)
        recorder.record(ref.rec.FENCE_REQUEUE, wave=-1, a=1,
                        b=ref.podtrace.REASON_DOUBLE_CLAIM)
        recorder.record(ref.rec.DEGRADED, a=1, b=2)
        recorder.record(ref.rec.CHURN_OP, a=ref.rec.CHURN_OP_CODES["kill"])
        recorder.record(ref.rec.PREEMPT_PROPOSE, wave=4, a=2, b=1)
        recorder.record(ref.rec.PREEMPT_COMMIT, wave=4, a=1, b=1)
        events = recorder.snapshot()
        exemplars = tracer.snapshot()["exemplars"]
    finally:
        recorder.disable()
        tracer.disable()
        recorder.clear()
        tracer.clear()
        tracer.sample = saved
    assert exemplars and any(e["kind"] == "harvest" for e in events)
    return json.loads(json.dumps(events)), json.loads(json.dumps(exemplars))


def test_one_ring_renders_equal_trace_json(recorded):
    events, exemplars = recorded
    got = {}
    for root in (REF, PORT):
        k = PKGS[root]
        trace = k.perfetto.build_chrome_trace(events)
        t_base = min(e["t"] for e in events)
        k.perfetto.add_pod_lanes(trace, exemplars, t_base=t_base)
        got[root] = (json.dumps(trace, sort_keys=True),
                     k.perfetto.overlap_seconds(events))
    assert got[PORT] == got[REF]
    names = {e["name"] for e in json.loads(got[PORT][0])["traceEvents"]}
    assert {"fence-conflict:double_claim", "degraded-enter",
            "churn:kill"} <= names


# ----------------------------------------------------------- the trend


@pytest.mark.parametrize("argv", [[], ["--band", "0.1"], ["--band", "0.6"]],
                         ids=["default", "band-0.1", "band-0.6"])
def test_trend_main_equal_over_the_repo_artifacts(argv, capsys):
    out = {}
    for root in (REF, PORT):
        rc = PKGS[root].trend.main(list(argv))
        out[root] = (rc, capsys.readouterr().out)
    assert out[PORT] == out[REF]
    assert out[PORT][0] in (0, 1) and "r21" in out[PORT][1]


def test_cli_trend_needs_no_drain_and_equals_reference(capsys):
    out = {}
    for root in (REF, PORT):
        rc = PKGS[root].cli.main(["--trend"])
        out[root] = (rc, capsys.readouterr().out)
    assert out[PORT] == out[REF]


# --------------------------------------------------------------- the CLI


def _cli_run(k, tmp_path, monkeypatch, device_args):
    """The CLI's --trace and --events at 64 nodes x 300 pods; returns the
    trace, the raw ring and engine.wave_dispatch over the recorded drain
    (the warm drain before it is not counted)."""
    counters = k.trace.COUNTERS
    at_enable = []

    class Recorder:
        """The ring the CLI arms, noting the wave count when it does."""

        def __init__(self, real):
            self.real = real

        def __getattr__(self, name):
            return getattr(self.real, name)

        def enable(self):
            at_enable.append(
                counters.snapshot().get("engine.wave_dispatch", (0, 0))[0])
            self.real.enable()

    monkeypatch.setattr(k.rec, "RECORDER", Recorder(k.rec.RECORDER))
    out = tmp_path / f"{k.root}-trace.json"
    raw = tmp_path / f"{k.root}-events.json"
    rc = k.cli.main(["--trace", str(out), "--events", str(raw),
                     "--nodes", "64", "--pods", "300",
                     "--profile", "mixed_affinity", *device_args])
    monkeypatch.undo()
    assert rc == 0 and len(at_enable) == 1
    waves = counters.snapshot().get("engine.wave_dispatch",
                                    (0, 0))[0] - at_enable[0]
    return (json.loads(out.read_text()), json.loads(raw.read_text()),
            waves)


def _spans(trace, prefix):
    return [e for e in trace["traceEvents"]
            if e.get("ph") == "X" and e["name"].startswith(prefix)]


def test_cli_trace_has_one_device_span_per_dispatched_wave(
        tmp_path, monkeypatch):
    got = {}
    for root, dev in ((PORT, ["--device", "cpu"]), (REF, [])):
        trace, events, waves = _cli_run(PKGS[root], tmp_path, monkeypatch,
                                        dev)
        disp, dev_eval, flush = (_spans(trace, p) for p in (
            "dispatch w", "device-eval w", "bind-flush w"))
        assert waves > 0
        assert len(disp) == len(dev_eval) == len(flush) == waves
        assert all(e["dur"] > 0 for e in disp + dev_eval + flush)
        assert sum(e["args"]["pods"] for e in disp) == 300
        got[root] = (waves, [(e["kind"], e["wave"], e["a"], e["b"])
                             for e in events])
    assert got[PORT] == got[REF]
