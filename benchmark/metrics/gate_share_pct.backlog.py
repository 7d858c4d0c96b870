"""Share of the dispatched rows whose class the one-pod-per-node-per-wave
gate covers (engine.wave_gate_rows over engine.wave_dispatch_pods), in
percent: rows the gate may hold back, not rows it refused (a refused row
stays active for another wave, which inner_waves.backlog counts); None
where the program has no such counter or dispatched nothing."""


def read(run):
    c = run.counters
    gated = c.get("engine.wave_gate_rows")
    pods = c.get("engine.wave_dispatch_pods", (0, 0.0))[0]
    if gated is None or pods == 0:
        return None
    return 100.0 * gated[0] / pods
