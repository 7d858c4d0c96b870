"""Inner wave iterations of the device's wave loop (engine.inner_waves,
the loop's own count that each harvest reads off the fetched payload)
per episode; None where the program has no such counter."""


def read(run):
    c = run.counters.get("engine.inner_waves")
    if c is None:
        return None
    return c[0] / len(run.res["episodes"])
