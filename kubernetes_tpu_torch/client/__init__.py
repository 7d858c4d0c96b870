"""Client layer: the client-go analog (SURVEY.md §1 L3).

Informers (Reflector -> Store -> SharedInformer), listers, rate-limited
workqueues, leader election, and the event recorder — the substrate every
controller (L4) and agent (L6/L7) in this framework watches state through
and writes back with.
"""

from kubernetes_tpu_torch.client.informer import SharedInformer, SharedInformerFactory, Store
from kubernetes_tpu_torch.client.leaderelection import LeaderElector, LeaseLock
from kubernetes_tpu_torch.client.record import EventRecorder
from kubernetes_tpu_torch.client.workqueue import (
    ItemExponentialFailureRateLimiter,
    RateLimitingQueue,
    WorkQueue,
    parallelize,
)

__all__ = [
    "SharedInformer",
    "SharedInformerFactory",
    "Store",
    "LeaderElector",
    "LeaseLock",
    "EventRecorder",
    "WorkQueue",
    "RateLimitingQueue",
    "ItemExponentialFailureRateLimiter",
    "parallelize",
]
