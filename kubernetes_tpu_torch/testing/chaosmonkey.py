"""Chaosmonkey: disruption registry + convergence assertion harness.

Mirror of the reference's fault-injection mechanism
(test/e2e/chaosmonkey/chaosmonkey.go): tests register interest in a
disruption; the harness runs every test's Setup, fires the disruption
mid-flight, then runs every Test and Teardown. Here the "cluster" is the
in-process rig (apiserver-lite + hollow fleet + controllers + scheduler),
so disruptions are first-class functions over live components — kill the
scheduler, crash a kubelet, partition the watch stream, restart the
apiserver from its WAL — and the invariant checked after every storm is
the reference's level-triggered promise: the system re-converges to
all-pods-bound with no double binds (SURVEY §5.3/§5.4).
"""

from __future__ import annotations

from typing import Callable, List, Optional


class Test:
    """chaosmonkey.Test: Setup runs before the disruption, Test during/
    after it, Teardown last (chaosmonkey.go:33-60)."""

    __test__ = False  # not a pytest collection target

    def __init__(self, setup: Optional[Callable[[], None]] = None,
                 test: Optional[Callable[[], None]] = None,
                 teardown: Optional[Callable[[], None]] = None,
                 name: str = ""):
        self.name = name
        self.setup = setup or (lambda: None)
        self.test = test or (lambda: None)
        self.teardown = teardown or (lambda: None)


class Chaosmonkey:
    def __init__(self, disruption: Callable[[], None]):
        self.disruption = disruption
        self.tests: List[Test] = []

    def register(self, test: Test) -> None:
        self.tests.append(test)

    def register_interface(self, setup=None, test=None, teardown=None,
                           name: str = "") -> None:
        self.register(Test(setup, test, teardown, name))

    def do(self) -> None:
        """Setup all -> disrupt -> Test all -> Teardown all
        (chaosmonkey.go:78-106; sequential rather than goroutine-per-test —
        the rig is single-process)."""
        done: List[Test] = []
        try:
            for t in self.tests:
                t.setup()
                done.append(t)
            self.disruption()
            for t in done:
                t.test()
        finally:
            for t in reversed(done):
                t.teardown()
