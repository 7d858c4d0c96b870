"""End to end: all pods bound in the window over the summed wall of every
episode's creates and drain (host clock)."""

from benchmark.lib import stats


def read(run):
    return stats.rate(run.res["bound"],
                      [e["wall_s"] for e in run.res["episodes"]])
