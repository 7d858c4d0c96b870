"""Image manager + image GC behind the CRI ImageService.

Two reference components live here:

- ImageManager (pkg/kubelet/images/image_manager.go EnsureImageExists):
  the pull-policy gate in front of every container start — Always pulls,
  IfNotPresent pulls only when absent, Never errors when absent.
- ImageGCManager (pkg/kubelet/images/image_gc_manager.go:41, policy
  thresholds validated at :133-140, GarbageCollect at :245): when the
  image filesystem crosses HighThresholdPercent, delete
  least-recently-used images that no container references until usage is
  back under LowThresholdPercent. The kubelet's eviction manager calls
  this FIRST when it sees disk pressure — reclaiming node-level resources
  before killing pods (eviction_manager.go reclaimNodeLevelResources).

Pull policy rides the pod annotation `bench/image-pull-policy` (the hollow
analog of v1.Container.ImagePullPolicy; one knob per pod keeps the scripted
surface small), defaulting to IfNotPresent like the reference does for
tagged images.
"""

from __future__ import annotations

from typing import List

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.nodes.cri import ImageService

PULL_POLICY_ANNOTATION = "bench/image-pull-policy"

PULL_ALWAYS = "Always"
PULL_IF_NOT_PRESENT = "IfNotPresent"
PULL_NEVER = "Never"


class ImagePullError(Exception):
    pass


class ImageManager:
    """EnsureImageExists (image_manager.go): one decision per container
    start."""

    def __init__(self, service: ImageService):
        self.service = service
        self.pulls = 0  # diagnostics

    def ensure_image_exists(self, pod: Pod, image: str,
                            size_bytes: int = 0) -> None:
        policy = pod.annotations.get(PULL_POLICY_ANNOTATION,
                                     PULL_IF_NOT_PRESENT)
        present = any(i.ref == image for i in self.service.list_images())
        if policy == PULL_NEVER:
            if not present:
                raise ImagePullError(
                    f"container image {image!r} is not present with pull "
                    f"policy of Never")
            return
        if policy == PULL_ALWAYS or not present:
            self.service.pull_image(image, size_bytes=size_bytes)
            self.pulls += 1


class ImageGCPolicy:
    """image_gc_manager.go:55 ImageGCPolicy with the same validation
    (:133-140): percents in [0,100], low <= high."""

    def __init__(self, high_threshold_percent: int = 85,
                 low_threshold_percent: int = 80):
        if not 0 <= high_threshold_percent <= 100:
            raise ValueError(
                f"invalid HighThresholdPercent {high_threshold_percent}, "
                f"must be in range [0-100]")
        if not 0 <= low_threshold_percent <= 100:
            raise ValueError(
                f"invalid LowThresholdPercent {low_threshold_percent}, "
                f"must be in range [0-100]")
        if low_threshold_percent > high_threshold_percent:
            raise ValueError(
                f"LowThresholdPercent {low_threshold_percent} can not be "
                f"higher than HighThresholdPercent {high_threshold_percent}")
        self.high = high_threshold_percent
        self.low = low_threshold_percent


class ImageGCManager:
    """image_gc_manager.go:41: threshold-triggered LRU image deletion.
    `capacity_bytes` is the image filesystem size (cadvisor ImagesFsInfo
    in the reference; a configured number in the hollow node)."""

    def __init__(self, service: ImageService, capacity_bytes: int,
                 policy: ImageGCPolicy = None):
        self.service = service
        self.capacity = capacity_bytes
        self.policy = policy or ImageGCPolicy()
        self.freed_total = 0  # diagnostics

    def _in_use(self) -> set:
        in_use = getattr(self.service, "images_in_use", None)
        return in_use() if in_use is not None else set()

    def garbage_collect(self) -> int:
        """One GC pass; returns bytes freed. Mirrors GarbageCollect
        (:245): compute usage percent; above high → free down to low by
        deleting unused images oldest-last-used first."""
        if self.capacity <= 0:
            return 0
        usage = self.service.image_fs_info()
        if usage * 100 < self.policy.high * self.capacity:
            return 0
        target = self.capacity * self.policy.low // 100
        return self.free_space(usage - target)

    def free_space(self, bytes_to_free: int) -> int:
        """freeSpace (image_gc_manager.go:277): delete unused images in
        last-used order until `bytes_to_free` is reclaimed or candidates
        run out. Also the eviction manager's disk-reclaim hook."""
        if bytes_to_free <= 0:
            return 0
        in_use = self._in_use()
        candidates: List = [i for i in self.service.list_images()
                            if i.ref not in in_use]
        candidates.sort(key=lambda i: i.last_used_at)
        freed = 0
        for img in candidates:
            if freed >= bytes_to_free:
                break
            self.service.remove_image(img.ref)
            freed += img.size_bytes
        self.freed_total += freed
        return freed
