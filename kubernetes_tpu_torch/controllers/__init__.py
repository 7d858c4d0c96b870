"""Controllers: the reconcile layer (SURVEY.md §1 L4).

Every controller follows the reference's informer->workqueue->sync pattern
(pkg/controller/*): event handlers enqueue keys, workers pop from a
rate-limited queue, sync(key) diffs desired (spec) against observed (status)
and issues API writes. Heavy per-cluster math stays out of this layer — the
TPU owns the pod x node hot loop; controllers are O(objects-touched) host
work.
"""

from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.controllers.manager import ControllerManager

__all__ = ["Controller", "ControllerManager"]
