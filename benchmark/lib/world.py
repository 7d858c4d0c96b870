"""The world a traffic loop (loops/<loop>.py) drives: the configuration's
cluster in the program's store, the started scheduler, and what the
reference will judge. Python's collector runs as it would in a
deployment: nothing here freezes or disables it.
"""

import bisect
import sys
from dataclasses import dataclass, field
from typing import List

from benchmark.gen.cluster import make_cluster
from benchmark.lib.adapter import port_nodes
from benchmark.lib.outcome import read_outcome


# the store's bound on its event log: far above the 90,000 events (create,
# bind, delete) of a 30,000-pod episode, as World.trim_log empties the log
# between episodes
MAX_LOG = 5_000_000


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class World:
    """The cluster in the store, the started scheduler and what the
    reference will judge."""
    conf: dict
    params: dict
    seed: int
    device: str
    judged: List[tuple] = field(default_factory=list)  # (podset, outcome)
    # the timed intervals of the window on time.perf_counter, where the
    # loop leaves parts of its window untimed (a backlog's resets)
    timed: List[tuple] = field(default_factory=list)

    def __post_init__(self):
        import torch  # noqa: F401  (the program imports it; loaded here)
        from kubernetes_tpu_torch.engine.scheduler import Scheduler
        from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite
        self.cluster = make_cluster(self.conf, self.seed)
        # room in the event log for a whole episode: at its limit the store
        # copies its log on every write (PERF.md, Open questions), which
        # would time the trim instead of the scheduler; trim_log bounds
        # it between episodes
        self.api = ApiServerLite(max_log=MAX_LOG)
        for node in port_nodes(self.cluster):
            self.api.create("Node", node)
        self.sched = Scheduler(self.api, record_events=False,
                               device=self.device)
        self.sched.start()
        self.acked: List[str] = []
        self.sched.wave_observer = self._observe

    def _observe(self, ts, keys):
        self.acked.extend(keys)

    def sync_device(self):
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize(self.device)

    def judge(self, podset, rv0):
        """Read back what the program did with `podset` since rv0."""
        out = read_outcome(self.api, podset, self.cluster, rv0, self.acked)
        self.acked = []
        self.judged.append((podset, out))
        return out

    def trim_log(self):
        """Drop the store's watch events that the scheduler has read: a
        compaction between episodes (etcd's), made in the reset, outside
        the clock. Without it the log keeps every pod of the run alive,
        and each full pass of Python's collector walks a heap that grows
        episode by episode, so a run's rate would depend on how many
        episodes came before; with it each episode starts from the same
        heap (the nodes and the scheduler's own state)."""
        api, seen = self.api, self.sched._rv
        with api._lock:
            lo = bisect.bisect_right(api._log, seen, key=lambda e: e.rv)
            api._log = api._log[lo:]
            api._log_start_rv = (api._log[0].rv if api._log
                                 else api._rv + 1)

    def close(self):
        self.sched.wave_observer = None
        self.sched.engine.close()
