"""Gang (coscheduling) placement: whole-group all-or-nothing assignment.

BASELINE.json config 4 — a NEW capability relative to the reference (the
only in-tree batching notion is the strictly-sequential one-pod loop,
SURVEY §2.3): pods carrying the group annotations

    scheduling.k8s.io/group-name          gang identity
    scheduling.k8s.io/group-min-available member quorum (default: observed)

schedule atomically. The device batch engine is the relaxation solver —
the wave kernel assigns the whole gang against evolving capacity in one
program — and the host wraps it in speculative-assume transactionality:

  1. a gang becomes ELIGIBLE only when >= min-available members are in
     the ready queue (the PodGroup quorum gate);
  2. the eligible members run through the normal engine with assume=True
     (wave or strict — the gang is just a batch);
  3. if EVERY member placed, the placements commit (bind as usual);
     otherwise the whole gang rolls back — every assumed member is
     forgotten and re-queued with backoff, leaving zero partial residue
     (no deadlock-by-fragment, the failure mode gang scheduling exists
     to prevent).

A fast total-capacity pre-check rejects obviously infeasible gangs
without touching the device: if the gang's aggregate cpu/memory demand
exceeds the cluster's aggregate free capacity, nothing can place it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.api.types import Pod

GANG_NAME_ANNOTATION = "scheduling.k8s.io/group-name"
GANG_MIN_AVAILABLE_ANNOTATION = "scheduling.k8s.io/group-min-available"


def gang_name(pod: Pod) -> Optional[str]:
    return pod.annotations.get(GANG_NAME_ANNOTATION)


def min_available(pods: Sequence[Pod]) -> int:
    """The gang's quorum: max annotated value, else full observed size."""
    best = 0
    for p in pods:
        raw = p.annotations.get(GANG_MIN_AVAILABLE_ANNOTATION)
        if raw:
            try:
                best = max(best, int(raw))
            except ValueError:
                pass
    return best or len(pods)


def partition(pods: Sequence[Pod]) -> Tuple[List[Pod], Dict[str, List[Pod]]]:
    """(plain pods, gang-name -> members) preserving FIFO order."""
    plain: List[Pod] = []
    gangs: Dict[str, List[Pod]] = {}
    for p in pods:
        g = gang_name(p)
        if g is None:
            plain.append(p)
        else:
            gangs.setdefault(g, []).append(p)
    return plain, gangs


def capacity_precheck(members: Sequence[Pod], infos) -> bool:
    """Cheap aggregate feasibility: total gang cpu/mem demand must fit the
    cluster's total free capacity (necessary, not sufficient). False =
    provably unplaceable, skip the device entirely."""
    need_cpu = need_mem = 0
    for p in members:
        r = p.resource_request()
        need_cpu += r.milli_cpu
        need_mem += r.memory
    free_cpu = free_mem = 0
    for info in infos.values():
        node = info.node
        if node is None or not node.is_ready() or node.unschedulable:
            continue
        free_cpu += max(node.allocatable.milli_cpu
                        - info.requested.milli_cpu, 0)
        free_mem += max(node.allocatable.memory - info.requested.memory, 0)
    return need_cpu <= free_cpu and need_mem <= free_mem


class GangResult:
    __slots__ = ("name", "placed", "placed_members", "unplaced_members",
                 "reason")

    def __init__(self, name: str, placed: bool,
                 placed_members: List[Pod], unplaced_members: List[Pod],
                 reason: str = ""):
        self.name = name
        self.placed = placed  # quorum reached, placed_members commit
        self.placed_members = placed_members
        self.unplaced_members = unplaced_members
        self.reason = reason


def schedule_gangs(engine, ready: List[Tuple[str, List[Pod], int]],
                   mode: str = "wave") -> List[GangResult]:
    """Atomic placement of MANY gangs in ONE device pass: members run
    through the engine as a single FIFO batch (a per-gang dispatch would
    pay a device round trip per job), then each gang commits or rolls
    back independently. A rolled-back gang only FREES capacity later
    gangs already accounted for, so surviving placements stay valid —
    they saw a conservative (smaller) cluster.

    Quorum semantics (the coscheduling PodGroup contract): a gang COMMITS
    when at least `quorum` members placed — those bind, the rest re-queue
    and retry individually (the gang is past its atomicity point). Below
    quorum the whole gang rolls back to zero residue.

    Atomicity covers PLACEMENT (assumed capacity). Binds are per-pod API
    writes, as in the reference; a bind failure after commit is a
    per-member retry, not a gang rollback — the caller marks the gang
    degraded so retries bypass quorum gating instead of parking forever."""
    results: List[GangResult] = []
    infos = engine.cache.node_infos()
    batched: List[Tuple[str, List[Pod], int]] = []
    members_all: List[Pod] = []
    for name, members, quorum in ready:
        if not capacity_precheck(members, infos):
            results.append(GangResult(name, False, [], members,
                                      "InsufficientClusterCapacity"))
            continue
        batched.append((name, members, quorum))
        members_all.extend(members)
    if not members_all:
        return results
    placed = engine.schedule(members_all, assume=True, mode=mode)
    by_pod = {r.pod.key(): r for r in placed}
    for name, members, quorum in batched:
        rs = [by_pod[m.key()] for m in members]
        ok = [r for r in rs if r.node_name is not None]
        unplaced = [r.pod for r in rs if r.node_name is None]
        if len(ok) >= quorum:
            results.append(GangResult(
                name, True, [r.pod for r in ok], unplaced,
                "" if not unplaced else
                f"{len(unplaced)} stragglers past quorum retry solo"))
            continue
        # below quorum: rollback to zero residue (scheduler.go:234's
        # ForgetPod, applied transactionally across the group — ONE lock
        # for the whole gang via the cache's bulk rollback)
        engine.cache.forget_pods_bulk([r.pod for r in ok])
        for r in ok:
            engine.note_node_dirty(r.pod.node_name)
            r.pod.node_name = ""
        results.append(GangResult(
            name, False, [], members,
            f"only {len(ok)}/{len(members)} members placeable "
            f"(quorum {quorum})"))
    return results
