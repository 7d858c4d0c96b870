"""What the program did, read back from the store: the Outcome the
reference judges."""

from typing import Dict, Iterable

import numpy as np

from benchmark.reference.check import Outcome


def read_outcome(api, podset, cluster, rv0: int,
                 acked: Iterable[str]) -> Outcome:
    """Binds of `podset`'s pods since store revision rv0: the node each
    is on now (read back from the store), the revision of its first bind
    and the number of writes that bound it (from the store's event log),
    and whether the scheduler acknowledged it."""
    ns = podset.namespace
    keys = [f"{ns}/{name}" for name in podset.names]
    index = {k: i for i, k in enumerate(keys)}
    node_index = {name: i for i, name in enumerate(cluster.names)}
    p = len(keys)
    bind_rv = np.full(p, -1, dtype=np.int64)
    count = np.zeros(p, dtype=np.int64)
    last: Dict[str, str] = {}
    for e in api.watch_since(("Pod",), rv0):
        if e.type == "DELETED":
            continue
        key = f"{e.obj.namespace}/{e.obj.name}"
        i = index.get(key)
        node = e.obj.node_name
        if i is None or not node or node == last.get(key):
            continue
        last[key] = node
        count[i] += 1
        if bind_rv[i] < 0:
            bind_rv[i] = e.rv
    node_of = np.full(p, -1, dtype=np.int64)
    for i, name in enumerate(podset.names):
        node = api.get("Pod", ns, name).node_name
        if node:
            node_of[i] = node_index[node]
    ack = np.zeros(p, dtype=bool)
    for k in acked:
        i = index.get(k)
        if i is not None:
            ack[i] = True
    return Outcome(node_of=node_of, bind_rv=bind_rv, bind_count=count,
                   acked=ack)
