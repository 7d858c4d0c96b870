"""Seconds in the wave encoding's affinity build (the pipeline.aff_build
span: AffinityData, the per-node views, the tail's projected arrays and
their uploads) per episode; None where the program has no such span."""


def read(run):
    c = run.counters.get("pipeline.aff_build")
    if c is None:
        return None
    return c[1] / len(run.res["episodes"])
