"""The standalone scheduler daemon: leader election + healthz + metrics +
policy flags around the scheduling loop.

Mirror of the reference's binary composition
(plugin/cmd/kube-scheduler/app/server.go:67 Run: client -> informers ->
CreateScheduler -> healthz/pprof HTTP -> leaderelection.RunOrDie :127-146)
with the option surface of app/options/options.go:70-92:

  --scheduler-name             SchedulerOptions.scheduler_name
  --algorithm-provider         .algorithm_provider (api/policy.PROVIDERS)
  --policy-config-file         .policy_config_file (JSON Policy)
  --leader-elect               .leader_elect
  --lock-object-{namespace,name}  .lock_object_namespace/.lock_object_name
  --address/--port (healthz)   .healthz_host/.healthz_port

Two drive modes, like every other component here: `step()` for
deterministic fake-clock tests (one elector tick + one scheduling round
when leading), and `run()`/`stop()` for threaded operation. Failover is
exercised end-to-end by tests/test_torch_daemon.py: kill the leading
daemon mid-storm, the standby acquires the lease and finishes the drain.

PyTorch port of kubernetes_tpu/server/daemon.py: every Scheduler a daemon
makes runs on the daemon's device — the card unless the caller names
another (``device="cpu"``, ``--device cpu``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import time

from kubernetes_tpu_torch import resolve_device
from kubernetes_tpu_torch.client.leaderelection import LeaderElector, LeaseLock
from kubernetes_tpu_torch.engine.scheduler import Scheduler
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite


@dataclass
class SchedulerOptions:
    """app/options/options.go:70-92, reduced to the implemented knobs."""

    scheduler_name: str = "default-scheduler"
    algorithm_provider: str = "DefaultProvider"
    policy_config_file: Optional[str] = None
    leader_elect: bool = True
    lock_object_namespace: str = "kube-system"
    lock_object_name: str = "kube-scheduler"
    healthz_host: str = "127.0.0.1"
    healthz_port: int = 0  # 0 = ephemeral; None disables the server
    batch_mode: str = "wave"

    @classmethod
    def from_component_config(cls, cfg) -> "SchedulerOptions":
        """Options from a decoded componentconfig
        KubeSchedulerConfiguration (api/scheme.py) — the
        --config/--policy-configmap path of the reference server
        (KubeSchedulerConfiguration, componentconfig types.go:158)."""
        host, _, port = cfg.healthz_bind_address.rpartition(":")
        return cls(
            scheduler_name=cfg.scheduler_name,
            algorithm_provider=cfg.algorithm_provider,
            policy_config_file=cfg.policy_config_file or None,
            leader_elect=cfg.leader_election.leader_elect,
            lock_object_namespace=cfg.leader_election.lock_object_namespace,
            lock_object_name=cfg.leader_election.lock_object_name,
            healthz_host=host or "127.0.0.1",
            healthz_port=int(port) if port else 0)


class SchedulerDaemon:
    def __init__(self, api: ApiServerLite, identity: str,
                 options: Optional[SchedulerOptions] = None,
                 now: Callable[[], float] = time.monotonic, device=None):
        # None = the card (RuntimeError without one), before any state
        self.device = resolve_device(device)
        self.api = api
        self.identity = identity
        self.options = options or SchedulerOptions()
        self._now = now
        self.scheduler: Optional[Scheduler] = None
        self._policy = None
        if self.options.policy_config_file:
            from kubernetes_tpu_torch.api.policy import parse_policy
            with open(self.options.policy_config_file) as f:
                self._policy = parse_policy(f.read())
        self._priorities = None
        if self._policy is None \
                and self.options.algorithm_provider != "DefaultProvider":
            from kubernetes_tpu_torch.api.policy import provider_priorities
            self._priorities = provider_priorities(
                self.options.algorithm_provider)
        self.elector: Optional[LeaderElector] = None
        if self.options.leader_elect:
            lock = LeaseLock(api, self.options.lock_object_name,
                             self.options.lock_object_namespace)
            self.elector = LeaderElector(
                lock, identity, now=now,
                on_started_leading=self._on_started_leading,
                on_stopped_leading=self._on_stopped_leading)
        self._healthz: Optional[ThreadingHTTPServer] = None
        self._healthz_thread: Optional[threading.Thread] = None
        self._run_thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        if self.options.healthz_port is not None:
            self._start_healthz()

    # --------------------------------------------------------------- leading

    def _make_scheduler(self) -> Scheduler:
        kwargs = dict(scheduler_name=self.options.scheduler_name,
                      batch_mode=self.options.batch_mode,
                      record_events=False, policy=self._policy,
                      now=self._now,  # one clock for LE, TTLs, and backoff
                      device=self.device)
        if self._priorities is not None:
            kwargs["priorities"] = self._priorities
        sched = Scheduler(self.api, **kwargs)
        sched.start()
        return sched

    def _on_started_leading(self) -> None:
        # fresh scheduler = fresh relist; the previous leader's assumed
        # state is irrelevant (level-triggered recovery, SURVEY §5.4)
        self.scheduler = self._make_scheduler()

    def _on_stopped_leading(self) -> None:
        if self.scheduler is not None:
            self.scheduler.engine.close()  # its wave worker, if started
        self.scheduler = None

    def is_leader(self) -> bool:
        if self.elector is None:
            return True
        return self.elector.is_leader()

    # ----------------------------------------------------------------- drive

    def step(self) -> dict:
        """One daemon iteration (fake-clock testable): elector tick, then a
        scheduling round when leading."""
        if self.elector is not None:
            self.elector.step()
        if self.is_leader():
            if self.scheduler is None:  # leader_elect=False path
                self.scheduler = self._make_scheduler()
            return self.scheduler.schedule_round()
        return {"popped": 0, "bound": 0, "unschedulable": 0,
                "bind_errors": 0}

    def run(self, poll: float = 0.01) -> None:
        def loop():
            while not self._stopping.is_set():
                self.step()
                self._stopping.wait(poll)
        self._run_thread = threading.Thread(target=loop, daemon=True)
        self._run_thread.start()

    def stop(self, release: bool = True) -> None:
        """Graceful stop: releases the lease so a standby acquires
        immediately. release=False simulates a crash — the lease stays
        held, so a standby must wait out lease_duration (the failover path
        tests/test_torch_daemon.py drives). Either way the scheduler's
        engine worker stops."""
        self._stopping.set()
        if self._run_thread is not None:
            self._run_thread.join(timeout=5)
            self._run_thread = None
        if self.elector is not None:
            self.elector.stop()
            if release:
                self.elector.release()
        if self.scheduler is not None:
            self.scheduler.engine.close()
        if self._healthz is not None:
            self._healthz.shutdown()
            self._healthz.server_close()  # free the listening socket
            if self._healthz_thread is not None:
                self._healthz_thread.join(timeout=5)
            self._healthz = None

    # --------------------------------------------------------------- healthz

    @property
    def healthz_port(self) -> Optional[int]:
        return self._healthz.server_address[1] if self._healthz else None

    def _start_healthz(self) -> None:
        daemon = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _write(self, body: bytes, ctype: str = "text/plain"):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._write(b"ok")
                elif self.path == "/metrics":
                    sched = daemon.scheduler
                    body = sched.metrics.render() if sched else ""
                    self._write(body.encode())
                elif self.path == "/leader":
                    self._write(str(daemon.is_leader()).lower().encode())
                else:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()

        self._healthz = ThreadingHTTPServer(
            (self.options.healthz_host, self.options.healthz_port), Handler)
        self._healthz_thread = threading.Thread(
            target=self._healthz.serve_forever, daemon=True)
        self._healthz_thread.start()


def main(argv=None) -> None:
    """Self-contained demo entrypoint: in-process apiserver, a small hollow
    cluster, two competing daemons — shows election, scheduling, failover."""
    import argparse

    from kubernetes_tpu_torch.api.types import make_node, make_pod

    ap = argparse.ArgumentParser(prog="kube-scheduler-lite")
    ap.add_argument("--nodes", type=int, default=50)
    ap.add_argument("--pods", type=int, default=500)
    ap.add_argument("--policy-config-file", default=None)
    ap.add_argument("--config", default=None,
                    help="componentconfig KubeSchedulerConfiguration file "
                         "(versioned; decoded through api/scheme.py)")
    ap.add_argument("--device", default=None,
                    help="torch device to schedule on (default: the card)")
    args = ap.parse_args(argv)

    api = ApiServerLite()
    for i in range(args.nodes):
        api.create("Node", make_node(f"node-{i:03d}"))
    for i in range(args.pods):
        api.create("Pod", make_pod(f"pod-{i:04d}", cpu=100))
    if args.config:
        import json as _json

        from kubernetes_tpu_torch.api.scheme import DEFAULT_SCHEME
        from kubernetes_tpu_torch.utils import features
        with open(args.config) as f:
            cfg = DEFAULT_SCHEME.decode(_json.load(f))
        for gate, val in cfg.feature_gates.items():
            features.DEFAULT_FEATURE_GATE.set(gate, val)
        opts = SchedulerOptions.from_component_config(cfg)
        if args.policy_config_file:
            opts.policy_config_file = args.policy_config_file
        # the demo runs TWO daemons in one process: a fixed healthz port
        # from the config (default 10251) would EADDRINUSE on the second
        # — ephemeral ports for both, like the no-config path
        opts.healthz_port = 0
    else:
        opts = SchedulerOptions(policy_config_file=args.policy_config_file)
    a = SchedulerDaemon(api, "daemon-a", opts, device=args.device)
    b = SchedulerDaemon(api, "daemon-b", opts, device=args.device)
    for _ in range(50):
        a.step()
        b.step()
        pods, _ = api.list("Pod")
        if all(p.node_name for p in pods):
            break
    bound = sum(1 for p in api.list("Pod")[0] if p.node_name)
    leader = "daemon-a" if a.is_leader() else "daemon-b"
    print(f"leader={leader} bound={bound}/{args.pods} "
          f"healthz(a)=:{a.healthz_port} healthz(b)=:{b.healthz_port}")
    a.stop()
    b.stop()


if __name__ == "__main__":
    main()
