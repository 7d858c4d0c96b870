"""Per-node aggregate state.

TPU-native analog of schedulercache.NodeInfo (reference:
plugin/pkg/scheduler/schedulercache/node_info.go:34-75): the authoritative
host-side aggregate of everything the placement kernels need about one node —
pods assigned (incl. assumed), requested and nonzero-requested resource sums,
used host ports, and a monotonically increasing generation counter that drives
incremental snapshot refresh (node_info.go generation is bumped on every
mutation; the cache's UpdateNodeNameToInfoMap at cache.go:79 clones only nodes
whose generation moved — our tensor snapshot does the same per-column delta
upload, see kubernetes_tpu_torch/state/snapshot.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from kubernetes_tpu_torch.api.types import Node, Pod, Resource


class NodeInfo:
    __slots__ = (
        "node",
        "pods",
        "pods_with_affinity",
        "requested",
        "nonzero_cpu",
        "nonzero_mem",
        "used_ports",
        "vol_count",
        "prio_usage",
        "generation",
        "spec_generation",
        "ports_generation",
    )

    def __init__(self, node: Optional[Node] = None):
        self.node: Optional[Node] = node
        self.pods: List[Pod] = []
        # pods carrying any pod (anti-)affinity — the reference tracks these
        # separately (node_info.go PodsWithAffinity) so the symmetry checks
        # don't scan every pod
        self.pods_with_affinity: List[Pod] = []
        self.requested = Resource()
        self.nonzero_cpu = 0
        self.nonzero_mem = 0
        self.used_ports: Set[int] = set()
        # volume-bearing pods on this node — a counter so the snapshot's
        # columnar dynamic-row writer can skip the per-pod volume walk on
        # the (overwhelmingly common) volume-free node
        self.vol_count = 0
        # per-PRIORITY resource aggregate: priority -> [milli_cpu, memory,
        # count] over this node's pods (assumed included). The snapshot's
        # priority-band columns read this per dirty row, so the wave-path
        # victim scan never walks pod lists; one dict op per
        # add/remove keeps it exact.
        self.prio_usage: Dict[int, list] = {}
        # generation: any mutation; spec_generation: node object (labels,
        # taints, allocatable, conditions) changed; ports_generation: the
        # used-ports set changed. The snapshot diffs each independently so a
        # plain pod add/remove only rewrites the small dynamic arrays.
        self.generation = 0
        self.spec_generation = 0
        self.ports_generation = 0

    # -- mutation (mirrors node_info.go addPod:302 / removePod:330) ---------

    def add_pod(self, pod: Pod) -> None:
        req = pod.resource_request()
        ncpu, nmem = pod.nonzero_request()
        self.add_pod_precomputed(pod, req, ncpu, nmem, pod.used_ports())

    def add_pod_precomputed(self, pod: Pod, req: Resource, ncpu: int,
                            nmem: int, ports: List[int]) -> None:
        """add_pod with the derived quantities supplied by the caller — the
        bulk-assume path computes them once per equivalence class instead of
        once per pod (30k identical pods -> one resource_request walk)."""
        self.requested.add(req)
        self.nonzero_cpu += ncpu
        self.nonzero_mem += nmem
        if ports:
            self.used_ports.update(ports)
            self.ports_generation += 1
        if pod.volumes:
            self.vol_count += 1
        u = self.prio_usage.get(pod.priority)
        if u is None:
            self.prio_usage[pod.priority] = [req.milli_cpu, req.memory, 1]
        else:
            u[0] += req.milli_cpu
            u[1] += req.memory
            u[2] += 1
        self.pods.append(pod)
        if pod.affinity is not None and (pod.affinity.pod_affinity is not None
                                         or pod.affinity.pod_anti_affinity is not None):
            self.pods_with_affinity.append(pod)
        self.generation += 1

    def add_pods_same_class(self, pods: List[Pod], req: Resource, ncpu: int,
                            nmem: int, ports: List[int]) -> None:
        """add_pod_precomputed for a RUN of spec-equal pods landing on this
        node: one scaled resource update + one list extend instead of
        len(pods) Python-object walks — the columnar half of the drain's
        assume phase. Semantically identical to calling
        add_pod_precomputed per pod, in order."""
        n = len(pods)
        if n == 0:
            return
        if n == 1:
            self.add_pod_precomputed(pods[0], req, ncpu, nmem, ports)
            return
        r = self.requested
        r.milli_cpu += req.milli_cpu * n
        r.memory += req.memory * n
        r.nvidia_gpu += req.nvidia_gpu * n
        r.storage_scratch += req.storage_scratch * n
        r.storage_overlay += req.storage_overlay * n
        for k, v in req.extended.items():
            r.extended[k] = r.extended.get(k, 0) + v * n
        self.nonzero_cpu += ncpu * n
        self.nonzero_mem += nmem * n
        if ports:
            self.used_ports.update(ports)
            self.ports_generation += 1
        if pods[0].volumes:
            self.vol_count += n
        u = self.prio_usage.get(p_prio := pods[0].priority)
        if u is None:
            self.prio_usage[p_prio] = [req.milli_cpu * n, req.memory * n, n]
        else:
            u[0] += req.milli_cpu * n
            u[1] += req.memory * n
            u[2] += n
        self.pods.extend(pods)
        p0 = pods[0]
        if p0.affinity is not None and (p0.affinity.pod_affinity is not None
                                        or p0.affinity.pod_anti_affinity is not None):
            self.pods_with_affinity.extend(pods)
        self.generation += 1

    def remove_pod(self, pod: Pod) -> bool:
        key = pod.key()
        for i, p in enumerate(self.pods):
            if p.key() == key:
                del self.pods[i]
                self.pods_with_affinity = [
                    q for q in self.pods_with_affinity if q.key() != key]
                req = p.resource_request()
                self.requested.sub(req)
                if p.volumes:
                    self.vol_count -= 1
                u = self.prio_usage.get(p.priority)
                if u is not None:
                    u[0] -= req.milli_cpu
                    u[1] -= req.memory
                    u[2] -= 1
                    if u[2] <= 0:
                        del self.prio_usage[p.priority]
                ncpu, nmem = p.nonzero_request()
                self.nonzero_cpu -= ncpu
                self.nonzero_mem -= nmem
                if p.used_ports():
                    # rebuild ports (another pod may still hold the same port —
                    # the reference keeps a map and re-adds; rebuilding is exact)
                    self.used_ports = set()
                    for q in self.pods:
                        self.used_ports.update(q.used_ports())
                    self.ports_generation += 1
                self.generation += 1
                return True
        return False

    def set_node(self, node: Node) -> None:
        self.node = node
        self.generation += 1
        self.spec_generation += 1

    def allocatable(self) -> Resource:
        return self.node.allocatable if self.node else Resource()

    def allowed_pod_number(self) -> int:
        return self.node.allowed_pod_number if self.node else 0

    def clone_shallow(self) -> "NodeInfo":
        out = NodeInfo(self.node)
        out.pods = list(self.pods)
        out.pods_with_affinity = list(self.pods_with_affinity)
        out.requested = self.requested.clone()
        out.nonzero_cpu = self.nonzero_cpu
        out.nonzero_mem = self.nonzero_mem
        out.used_ports = set(self.used_ports)
        out.vol_count = self.vol_count
        out.prio_usage = {k: list(v) for k, v in self.prio_usage.items()}
        out.generation = self.generation
        out.spec_generation = self.spec_generation
        out.ports_generation = self.ports_generation
        return out


def node_info_map(nodes: List[Node], pods: List[Pod]) -> Dict[str, NodeInfo]:
    """Build a fresh name->NodeInfo map from raw objects (bound pods only)."""
    out: Dict[str, NodeInfo] = {n.name: NodeInfo(n) for n in nodes}
    for p in pods:
        if p.node_name and p.node_name in out:
            out[p.node_name].add_pod(p)
    return out
