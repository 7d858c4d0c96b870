"""tsan-lite runtime lock checker, armed by ``GRAFT_LOCKCHECK=1``.

The static half of the concurrency discipline (GL006-GL009) proves what
it can from the AST; this module catches the rest at runtime, the way
lockdep does in the kernel: every instrumented lock records which locks
the acquiring thread already holds, the observed (held -> acquired)
edges accumulate in one global table, and the FIRST time two locks are
taken in both orders the checker has a witness for a real deadlock
candidate — no need to actually lose the race.

Usage is the factory triple, handed the same ``"ClassName._attr"`` /
``"module.id._name"`` lock ids the static rules compute, so the static
graph and the runtime checker speak one namespace:

    self._lock = lockcheck.make_lock("SchedulerCache._lock")
    _lock = lockcheck.make_rlock("api.pb._lock")

With the knob OFF (the default, and the shipped configuration) each
factory returns the RAW ``threading`` primitive — exact pass-through,
zero wrappers, zero overhead, bit-identical scheduling. With
``GRAFT_LOCKCHECK=1`` in the environment at construction time the
factories return instrumented twins that:

- maintain a per-thread stack of held locks;
- record every (held, acquired) name edge, and report a VIOLATION when
  the reverse edge was ever observed (lock-order inversion — the GL006
  hazard, caught even when the two orders never actually race);
- RAISE on re-acquiring a non-reentrant Lock the thread already holds
  (without the checker that is not a report, it is a hang);
- support ``assert_held(lock, what)`` so ``*_locked()`` methods verify
  their caller actually holds the guard (the GL007 hazard at runtime).

Violations are RECORDED, not raised (except the guaranteed self-
deadlock): a storm test drives the real workload to completion, then
asserts ``lockcheck.violations() == []`` — one run checks both
behaviour and discipline. ``reset()`` clears state between tests.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Dict, List, Optional, Tuple

__all__ = ["enabled", "make_lock", "make_rlock", "make_condition",
           "assert_held", "violations", "assert_clean", "reset"]


def enabled() -> bool:
    """Read the knob per call: construction sites decide instrumentation
    at lock-birth time, tests flip the env before building the world."""
    return os.environ.get("GRAFT_LOCKCHECK", "") == "1"


# ---------------------------------------------------------------- state

# the checker's own guard is a RAW lock — instrumenting it would recurse
_STATE_LOCK = threading.Lock()
# (held name, acquired name) -> site string of the first observation
_EDGES: Dict[Tuple[str, str], str] = {}
_VIOLATIONS: List[str] = []

_TLS = threading.local()


def _held_stack() -> List["_Checked"]:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def _call_site() -> str:
    """nearest frame outside this module — where the acquire happened."""
    here = os.path.basename(__file__)
    for fr in reversed(traceback.extract_stack(limit=12)):
        if os.path.basename(fr.filename) != here:
            return f"{fr.filename}:{fr.lineno} in {fr.name}"
    return "<unknown>"


def _record(msg: str) -> None:
    with _STATE_LOCK:
        _VIOLATIONS.append(msg)


def violations() -> List[str]:
    with _STATE_LOCK:
        return list(_VIOLATIONS)


def assert_clean() -> None:
    vs = violations()
    if vs:
        raise AssertionError(
            "lockcheck recorded %d violation(s):\n  %s"
            % (len(vs), "\n  ".join(vs)))


def reset() -> None:
    """Clear the edge table and violation log (per-thread held stacks
    drain naturally as the locks release)."""
    with _STATE_LOCK:
        _EDGES.clear()
        del _VIOLATIONS[:]


# ------------------------------------------------------------- wrappers


class _Checked:
    """Shared acquire/release bookkeeping over a raw primitive."""

    reentrant = False

    def __init__(self, name: str, raw) -> None:
        self.name = name
        self._raw = raw

    # -- bookkeeping around the raw primitive's acquire/release ---------

    def _before_acquire(self) -> bool:
        """Order + self-deadlock checks. Returns True when this is a
        reentrant re-acquire (no new held entry should be pushed)."""
        stack = _held_stack()
        for held in stack:
            if held is self:
                if self.reentrant:
                    return True
                # not a report: without the checker this thread is GONE
                raise RuntimeError(
                    f"lockcheck: thread {threading.current_thread().name} "
                    f"re-acquired non-reentrant lock {self.name} it "
                    f"already holds at {_call_site()} — guaranteed "
                    "deadlock")
        site = None
        for held in stack:
            if held.name == self.name:
                # same NAME on a different object (two instances of one
                # class): no order exists between peers, skip the edge
                continue
            edge = (held.name, self.name)
            rev = (self.name, held.name)
            with _STATE_LOCK:
                if rev in _EDGES:
                    first = _EDGES[rev]
                    if site is None:
                        site = _call_site()
                    _VIOLATIONS.append(
                        f"lock-order inversion: {self.name} acquired "
                        f"while holding {held.name} at {site}, but the "
                        f"reverse order was observed at {first}")
                elif edge not in _EDGES:
                    if site is None:
                        site = _call_site()
                    _EDGES[edge] = site
        return False

    def _push(self) -> None:
        _held_stack().append(self)

    def _pop(self) -> None:
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                return

    def _is_held(self) -> bool:
        return any(h is self for h in _held_stack())

    # -- the lock protocol ---------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        nested = self._before_acquire()
        got = self._raw.acquire(blocking, timeout)
        if got and not nested:
            self._push()
        return got

    def release(self) -> None:
        self._raw.release()
        self._pop()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<lockcheck {type(self).__name__} {self.name!r}>"


class _CheckedLock(_Checked):
    reentrant = False

    def __init__(self, name: str) -> None:
        super().__init__(name, threading.Lock())

    def locked(self) -> bool:
        return self._raw.locked()


class _CheckedRLock(_Checked):
    reentrant = True

    def __init__(self, name: str) -> None:
        super().__init__(name, threading.RLock())
        self._depth = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        nested = self._before_acquire()
        got = self._raw.acquire(blocking, timeout)
        if got:
            self._depth += 1
            if not nested:
                self._push()
        return got

    def release(self) -> None:
        self._depth -= 1
        last = self._depth == 0
        self._raw.release()
        if last:
            self._pop()


class _CheckedCondition(_Checked):
    """Condition over its own (checked) lock. ``wait`` releases the lock
    for the duration, so the held entry pops for the sleep and comes
    back on wake — a waiter does NOT hold the lock against order checks
    run by the threads it is waiting on."""

    reentrant = False

    def __init__(self, name: str) -> None:
        super().__init__(name, threading.Condition())

    def wait(self, timeout: Optional[float] = None) -> bool:
        self._pop()
        try:
            return self._raw.wait(timeout)
        finally:
            self._push()

    def wait_for(self, predicate, timeout: Optional[float] = None):
        self._pop()
        try:
            return self._raw.wait_for(predicate, timeout)
        finally:
            self._push()

    def notify(self, n: int = 1) -> None:
        self._raw.notify(n)

    def notify_all(self) -> None:
        self._raw.notify_all()


# ------------------------------------------------------------ factories


def make_lock(name: str):
    """``threading.Lock()`` when the knob is off; the checked twin when
    ``GRAFT_LOCKCHECK=1``. ``name`` is the static lock id
    (``"ClassName._attr"`` / ``"module.id._name"``)."""
    return _CheckedLock(name) if enabled() else threading.Lock()


def make_rlock(name: str):
    return _CheckedRLock(name) if enabled() else threading.RLock()


def make_condition(name: str):
    return _CheckedCondition(name) if enabled() else threading.Condition()


def assert_held(lock, what: str = "") -> None:
    """Record a violation when the calling thread does NOT hold `lock`.
    A no-op on raw primitives (the knob-off path costs one isinstance),
    so ``*_locked()`` methods call it unconditionally."""
    if isinstance(lock, _Checked) and not lock._is_held():
        suffix = f" ({what})" if what else ""
        _record(
            f"guard not held: {lock.name} required{suffix} but thread "
            f"{threading.current_thread().name} does not hold it at "
            f"{_call_site()}")
