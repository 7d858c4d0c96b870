"""Leader election over an apiserver-lite lock object.

Mirrors client-go tools/leaderelection (leaderelection.go:138 Run =
acquire -> renew loop; resourcelock/ holds the LeaderElectionRecord in an
object annotation — here a first-class Lease record, the direction upstream
later took with coordination/v1). Semantics preserved:

- acquire: create the lock if absent, else take over only when the holder's
  renew_time is older than lease_duration (leaderelection.go tryAcquireOrRenew).
- renew: CAS on resourceVersion every retry_period; losing the CAS or the
  lock means stepping down (OnStoppedLeading).
- observers watching the same object see holder identity changes.

The scheduler/controller-manager binaries run under this exactly like the
reference's --leader-elect (plugin/cmd/kube-scheduler/app/server.go:127-146).
The TPU sidecar is stateless (SURVEY.md §5.4), so failover = the new leader
re-snapshots; no device state must be handed over.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite, Conflict, NotFound


@dataclass
class Lease:
    """resourcelock.LeaderElectionRecord as a stored object."""

    name: str
    namespace: str = "kube-system"
    holder: str = ""
    lease_duration: float = 15.0
    acquire_time: float = 0.0
    renew_time: float = 0.0
    leader_transitions: int = 0
    resource_version: int = 0


class LeaseLock:
    """resourcelock.Interface: Get/Create/Update of the Lease object."""

    KIND = "Lease"

    def __init__(self, api: ApiServerLite, name: str, namespace: str = "kube-system"):
        self.api = api
        self.name = name
        self.namespace = namespace

    def get(self) -> Lease:
        return self.api.get(self.KIND, self.namespace, self.name)

    def create(self, lease: Lease) -> int:
        return self.api.create(self.KIND, lease)

    def update(self, lease: Lease, expect_rv: int) -> int:
        return self.api.update(self.KIND, lease, expect_rv=expect_rv)


class LeaderElector:
    """leaderelection.LeaderElector — acquire then renew until stopped or
    deposed. Defaults match LeaderElectionDefaulting: 15s lease, 10s renew
    deadline, 2s retry (pkg/client/leaderelectionconfig + apiserver defaults).
    """

    def __init__(self, lock: LeaseLock, identity: str,
                 lease_duration: float = 15.0,
                 renew_deadline: float = 10.0,
                 retry_period: float = 2.0,
                 on_started_leading: Optional[Callable[[], None]] = None,
                 on_stopped_leading: Optional[Callable[[], None]] = None,
                 now: Callable[[], float] = time.monotonic):
        self.lock = lock
        self.identity = identity
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        self.on_started_leading = on_started_leading or (lambda: None)
        self.on_stopped_leading = on_stopped_leading or (lambda: None)
        self._now = now
        self._leading = False
        self._last_renew = 0.0  # last successful acquire/renew
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------- primitives

    def is_leader(self) -> bool:
        return self._leading

    def try_acquire_or_renew(self) -> bool:
        """One tryAcquireOrRenew pass. Returns True when we hold the lock."""
        now = self._now()
        try:
            cur = self.lock.get()
        except NotFound:
            lease = Lease(name=self.lock.name, namespace=self.lock.namespace,
                          holder=self.identity, lease_duration=self.lease_duration,
                          acquire_time=now, renew_time=now)
            try:
                self.lock.create(lease)
            except Conflict:
                return False
            return True

        if cur.holder != self.identity:
            # an empty holder is a gracefully released lease (release());
            # only a live NAMED holder blocks acquisition
            if cur.holder and now < cur.renew_time + cur.lease_duration:
                return False  # current leader is live
            # lease expired: steal, bumping transitions
            lease = Lease(name=cur.name, namespace=cur.namespace,
                          holder=self.identity, lease_duration=self.lease_duration,
                          acquire_time=now, renew_time=now,
                          leader_transitions=cur.leader_transitions + 1)
        else:
            lease = Lease(name=cur.name, namespace=cur.namespace,
                          holder=self.identity, lease_duration=self.lease_duration,
                          acquire_time=cur.acquire_time, renew_time=now,
                          leader_transitions=cur.leader_transitions)
        try:
            self.lock.update(lease, expect_rv=cur.resource_version)
        except (Conflict, NotFound):
            return False
        return True

    def step(self) -> bool:
        """One election tick; fires callbacks on transitions. Usable directly
        in deterministic tests.

        A leader tolerates transient renew failures (CAS races) until
        renew_deadline elapses since the last successful renew — client-go's
        RenewDeadline window — EXCEPT when the lock shows another holder,
        which means we were actively deposed and must step down now."""
        held = self.try_acquire_or_renew()
        now = self._now()
        if held:
            self._last_renew = now
            if not self._leading:
                self._leading = True
                self.on_started_leading()
        elif self._leading:
            deposed = False
            try:
                deposed = self.lock.get().holder != self.identity
            except NotFound:
                pass  # lock vanished: treat as transient
            if deposed or now >= self._last_renew + self.renew_deadline:
                self._leading = False
                self.on_stopped_leading()
        return held

    # ------------------------------------------------------------- daemon

    def run(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"leaderelect-{self.identity}")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.step()
            self._stop.wait(self.retry_period)
        if self._leading:
            self._leading = False
            self.on_stopped_leading()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def release(self) -> bool:
        """Graceful step-down: zero out the lease's renew_time via CAS so a
        standby can acquire immediately instead of waiting out
        lease_duration (client-go's later ReleaseOnCancel behavior; 1.7
        holders just crashed and made standbys wait). Returns True if the
        lease was released. Fires on_stopped_leading."""
        was_leading = self._leading
        self._leading = False
        released = False
        try:
            cur = self.lock.get()
            if cur.holder == self.identity:
                self.lock.update(
                    Lease(name=cur.name, namespace=cur.namespace,
                          holder="", lease_duration=cur.lease_duration,
                          acquire_time=0.0, renew_time=0.0,
                          leader_transitions=cur.leader_transitions),
                    expect_rv=cur.resource_version)
                released = True
        except (Conflict, NotFound):
            pass
        if was_leading:
            self.on_stopped_leading()
        return released
