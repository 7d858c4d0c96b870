"""(class, node) cells that the first wave of each dispatch's anti mask
forbids to the classes riding it (engine.wave_forbid_cells: the bound
pods' terms and the occupancy carry, both ways), per episode; 0 where
nothing forbids a node; None where the program has no such counter."""


def read(run):
    c = run.counters.get("engine.wave_forbid_cells")
    if c is None:
        return None
    return c[0] / len(run.res["episodes"])
