"""Node agents (SURVEY.md §1 L6/L7): hollow kubelet fleet + proxy.

The kubemark design inverted: the reference runs REAL kubelet code against
fake externalities (cmd/kubemark/hollow-node.go); here the node agent is
hollow by construction — the pod lifecycle state machine, heartbeat loop,
node-side admission, and service routing are real, while the container
runtime is a latency-simulating fake (the NewFakeDockerClient EnableSleep
analog). One shared informer fans out to N kubelets (the scale answer to N
kubelets each holding a watch).
"""

from kubernetes_tpu_torch.nodes.kubelet import HollowFleet, HollowKubelet
from kubernetes_tpu_torch.nodes.proxy import HollowProxy

__all__ = ["HollowFleet", "HollowKubelet", "HollowProxy"]
