"""AffinityData builds of the wave encoding (engine.wave_aff_build) per
episode; 0 where the mix carries no inter-pod term."""


def read(run):
    return run.counters.get("engine.wave_aff_build", (0, 0.0))[0] / len(
        run.res["episodes"])
