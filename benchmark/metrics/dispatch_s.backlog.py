"""Seconds in the engine's wave dispatch (the pipeline.dispatch span)
per episode."""


def read(run):
    return run.counters.get("pipeline.dispatch", (0, 0.0))[1] / len(
        run.res["episodes"])
