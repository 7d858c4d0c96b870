"""Client layer: the client-go analog (SURVEY.md §1 L3).

The port carries leader election, which the scheduler daemon runs on.
"""

from kubernetes_tpu_torch.client.leaderelection import LeaderElector, LeaseLock

__all__ = [
    "LeaderElector",
    "LeaseLock",
]
