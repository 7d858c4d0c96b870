"""Faults planted under the timed path, for the control of the comparison
(control.py, on the card at a cell's own size) and for the benchmark's
tests (on the CPU). Each is a `tweak(world)` that run.run_cell calls once
the scheduler has started; `undo()` puts the program back.

  unchanged  the harvest binds nothing it placed (a step that returns its
             state unchanged);
  half       the harvest binds every other pod it placed (half of the
             batch left out);
  altered    every placed pod is sent to the cluster's first node (an
             answer altered where it is produced);
  first_fit  every wave and tail round targets each pod's first fitting
             node instead of its best-scoring one (the priorities
             skipped: what `score_regret` is there to catch).
"""

FAULTS = ("unchanged", "half", "altered", "first_fit")

_undo = []


def undo() -> None:
    while _undo:
        _undo.pop()()


def _harvest(kind):
    def tweak(w):
        engine = w.sched.engine
        real = engine.harvest_waves
        names = w.cluster.names

        def harvest(handle):
            res = real(handle)
            if kind == "unchanged":
                res.bound = []
            elif kind == "half":
                res.bound = res.bound[::2]
            else:
                for p in res.bound:
                    p.node_name = names[0]
            return res
        engine.harvest_waves = harvest
        _undo.append(lambda: vars(engine).pop("harvest_waves", None))
    return tweak


def _first_fit(w):
    import torch
    from kubernetes_tpu_torch.engine import waves
    real = waves._pick

    def pick(fits, scores, pod_class, active, counter, col):
        masked, ties, fc, sel, counter_out = real(fits, scores, pod_class,
                                                  active, counter, col)
        first = col.first_fit(fits)[pod_class.long()]
        return masked, ties, fc, torch.where(sel >= 0, first, sel), \
            counter_out
    waves._pick = pick
    _undo.append(lambda: setattr(waves, "_pick", real))


def tweak(kind: str):
    if kind not in FAULTS:
        raise ValueError(f"unknown fault {kind!r}")
    return _first_fit if kind == "first_fit" else _harvest(kind)
