"""Seconds in the strict tail and the exact host tail (the pipeline.tail
and pipeline.host_tail spans) per episode."""


def read(run):
    c = run.counters
    return (c.get("pipeline.tail", (0, 0.0))[1]
            + c.get("pipeline.host_tail", (0, 0.0))[1]) / len(
                run.res["episodes"])
