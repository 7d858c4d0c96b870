"""Subprocess body for the kill -9 persistence test on the port
(tests/test_torch_store_wire.py): tests/_persistence_storm.py with its
imports on kubernetes_tpu_torch.

Creates a durable ApiServerLite, loads a cluster, then binds pods one batch
at a time forever, reporting progress on stdout — until the parent SIGKILLs
it mid-storm. Deliberately imports no jax: it exercises the store, not the
kernels, and must start fast.
"""

import sys

from kubernetes_tpu_torch.api.types import Binding, make_node, make_pod
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite


def main() -> None:
    data_dir = sys.argv[1]
    n_nodes, n_pods = int(sys.argv[2]), int(sys.argv[3])
    api = ApiServerLite(data_dir=data_dir)
    for i in range(n_nodes):
        api.create("Node", make_node(f"node-{i:04d}"))
    for i in range(n_pods):
        api.create("Pod", make_pod(f"pod-{i:05d}", cpu=100, memory=64 << 20))
    print("READY", flush=True)
    i = 0
    while True:
        api.bind_many([
            Binding(f"pod-{(i + j) % n_pods:05d}", "default", "",
                    f"node-{(i + j) % n_nodes:04d}")
            for j in range(10)
        ])
        i += 10
        print(f"BOUND {i}", flush=True)


if __name__ == "__main__":
    main()
