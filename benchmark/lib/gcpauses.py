"""Python's collections, as they happen: the generation and the
perf_counter interval of each, through gc.callbacks. The collector is
left as it is; this only watches it."""

import gc
import time


class GcPauses:
    def __init__(self):
        self.done = []          # (generation, start, end)
        self._t0 = None

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.done.append((info["generation"], self._t0,
                              time.perf_counter()))
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def within(self, t0: float, t1: float):
        """(count, seconds) of the full (generation 2) collections and of
        all collections that started in [t0, t1)."""
        full = [(a, b) for g, a, b in self.done if g == 2 and t0 <= a < t1]
        every = [(a, b) for g, a, b in self.done if t0 <= a < t1]
        return (len(full), sum(b - a for a, b in full),
                len(every), sum(b - a for a, b in every))
