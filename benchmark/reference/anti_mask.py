"""Required inter-pod anti-affinity as Kubernetes v1.7 states it, in plain
PyTorch, and the one-pod-per-node gate of a placement wave.

Written from the predicate (plugin/pkg/scheduler/algorithm/predicates/
predicates.go, InterPodAffinityMatches), not from any encoding of it: a
node is forbidden for a pod when

  own       one of the pod's required anti-affinity terms selects a bound
            pod whose node shares a topology domain with the node under
            the term's key (anyPodMatchesPodAffinityTerm), or
  symmetry  a bound pod's required anti-affinity term selects the pod,
            and the bound pod's node shares a domain with the node under
            that term's key (satisfiesExistingPodsAntiAffinity).

Two nodes share a domain under a key when both carry the key with one
value (NodesHaveSameTopologyKey); a node without the key shares none. All
pods are taken to be in one namespace, so a term's namespaces are the
pod's own. Selectors are match_labels: every pair must be on the pod.

Inputs are plain: a topology key's domains are an int64 tensor [N] of one
domain id per node (-1 where the node lacks the key), a bound pod is
(labels, anti, node) and a pending template (labels, anti), where `anti`
is a list of (match_labels, topology_key).
"""

from typing import Dict, List, Sequence, Tuple

import torch

Term = Tuple[Dict[str, str], str]
Bound = Tuple[Dict[str, str], List[Term], int]
Template = Tuple[Dict[str, str], List[Term]]


def selects(match_labels: Dict[str, str], labels: Dict[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in match_labels.items())


def forbidden(domains: Dict[str, torch.Tensor], bound: Sequence[Bound],
              templates: Sequence[Template], own: bool = True,
              sym: bool = True, block: int = 0) -> torch.Tensor:
    """bool [T, N]: node n is forbidden for template t by the bound pods,
    through t's own terms (`own`) and the bound pods' terms that select t
    (`sym`). Computed on the device of `domains`, `block` nodes at a time
    (0: all at once)."""
    dom = {k: torch.as_tensor(v, dtype=torch.int64)
           for k, v in domains.items()}
    first = next(iter(dom.values()))
    n, device = int(first.shape[0]), first.device
    step = block or n
    out = torch.zeros((len(templates), n), dtype=torch.bool, device=device)
    for t, (labels, anti) in enumerate(templates):
        # per topology key, the nodes whose domains t may not join
        sources: Dict[str, List[int]] = {}
        if own:
            for sel, key in anti:
                sources.setdefault(key, []).extend(
                    node for b_labels, _, node in bound
                    if selects(sel, b_labels))
        if sym:
            for _, b_anti, node in bound:
                for sel, key in b_anti:
                    if selects(sel, labels):
                        sources.setdefault(key, []).append(node)
        for key, nodes in sources.items():
            if not nodes:
                continue
            d = dom[key]
            hit = d[torch.tensor(nodes, dtype=torch.int64, device=device)]
            hit = torch.unique(hit[hit >= 0])
            for lo in range(0, n, step):
                part = d[lo:lo + step]
                out[t, lo:lo + step] |= (part >= 0) & torch.isin(part, hit)
    return out


def gate_accept(selected: torch.Tensor, pod_class: torch.Tensor,
                gated: torch.Tensor) -> torch.Tensor:
    """bool [P]: what the one-pod-per-node gate of one wave admits. Pods
    are in FIFO order (their index) and `selected` is each pod's target
    node (-1: none). A pod of a gated class is admitted only as the
    earliest pod on its node, and a node whose earliest pod is gated
    admits no other; the gate says nothing against any other pod."""
    sel = torch.as_tensor(selected).cpu().tolist()
    g = torch.as_tensor(gated, dtype=torch.bool).cpu()[
        torch.as_tensor(pod_class).long().cpu()].tolist()
    out = torch.zeros(len(sel), dtype=torch.bool)
    first: Dict[int, int] = {}
    for i, node in enumerate(sel):
        if node < 0:
            continue
        if node not in first:
            first[node] = i
            out[i] = True
        else:
            out[i] = not g[i] and not g[first[node]]
    return out


def violations(domains: Dict[str, torch.Tensor], placed: Sequence[Bound],
               prior: Sequence[Bound] = ()) -> Tuple[int, int]:
    """(own, symmetry): the pods of `placed`, taken in its order (the
    store's bind order), that landed on a node forbidden to them by the
    pods bound before them (`prior`, then the earlier ones of `placed`),
    through their own terms and through the earlier pods' terms."""
    n_own = n_sym = 0
    for i, (labels, anti, node) in enumerate(placed):
        before = list(prior) + list(placed[:i])
        n_own += int(forbidden(domains, before, [(labels, anti)],
                               sym=False)[0, node])
        n_sym += int(forbidden(domains, before, [(labels, anti)],
                               own=False)[0, node])
    return n_own, n_sym
