"""The hollow cluster of a configuration, as plain arrays."""

from dataclasses import dataclass
from typing import List

import numpy as np

from benchmark.gen.seeds import rng

HOSTNAME_KEY = "kubernetes.io/hostname"
ZONE_KEY = "failure-domain.beta.kubernetes.io/zone"


@dataclass
class Cluster:
    names: List[str]
    cpu: np.ndarray        # int64 [N] allocatable millicores
    mem: np.ndarray        # int64 [N] allocatable bytes
    pods: np.ndarray       # int64 [N] allowed pods
    zone: np.ndarray       # int64 [N] index into zones
    zones: List[str]

    def __len__(self):
        return len(self.names)

    def domain(self, key: str) -> np.ndarray:
        """The topology domain index of each node under `key`."""
        if key == HOSTNAME_KEY:
            return np.arange(len(self.names), dtype=np.int64)
        if key == ZONE_KEY:
            return self.zone
        raise ValueError(f"topology key {key!r} is not in the cluster")


def make_cluster(conf: dict, seed: int) -> Cluster:
    """`conf["cluster"]`'s nodes: one template, zones balanced and assigned
    by a permutation drawn from the seed."""
    c = conf["cluster"]
    n = int(c["nodes"])
    t = c["node_template"]
    zones = list(c["zones"])
    zone = np.arange(n, dtype=np.int64) % len(zones)
    zone = zone[rng(seed, "nodes").permutation(n)]
    full = lambda v: np.full(n, int(v), dtype=np.int64)  # noqa: E731
    return Cluster([f"{c['name_prefix']}{i}" for i in range(n)],
                   full(t["cpu_milli"]), full(t["memory_bytes"]),
                   full(t["pods"]), zone, zones)
