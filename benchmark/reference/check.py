"""The comparison that decides `correct`: the program's binds, as read back
from the store, held against the configuration's guarantees.

Inputs are the benchmark's own (the cluster and the pods of gen/) and the
program's outputs (`Outcome`): where each pod is bound, the store revision
of its bind, how many writes bound it, and whether the scheduler
acknowledged the bind. Every number but one is a count of violations,
with the limit 0.

The one that is not is `score_regret`, the priorities' check. The binds
are replayed in the store's order from the empty cluster; just before
each, the best score that any node still fitting the pod's requests
offers is set against the score of the node the pod got, and the
difference, in points of v1.7's resource priorities (scores.py), is that
pod's regret. The number compared is the mean regret per bound pod. A
wave places many pods against one frozen state, so a sound program's
regret is small but need not be 0; a program that packs pods first-fit
or inverts the priorities reads points per pod (PERF.md gives the
readings the limit was set from). The best node is sought among the
nodes whose capacity fits the pod; the inter-pod terms have their own
checks.
"""

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from benchmark.reference.scores import nonzero, score

CHECKS = ("double_binds", "unread_binds", "over_capacity", "anti_own",
          "anti_sym", "affinity", "pending_fit", "score_regret")
# the mean regret's limit: above the highest that sound runs of both cells
# read, and well below what a first-fit placement in the timed path reads
# (PERF.md, the readings); every other number is an exact count
LIMITS = {name: 0 for name in CHECKS}
LIMITS["score_regret"] = SCORE_REGRET_LIMIT = 0.5


@dataclass
class Outcome:
    node_of: np.ndarray     # int64 [P] node index, -1 unbound
    bind_rv: np.ndarray     # int64 [P] store revision of the first bind, -1
    bind_count: np.ndarray  # int64 [P] store writes that bound the pod
    acked: np.ndarray       # bool [P] bind acknowledged by the scheduler


def _selects(sel: Dict[str, str], labels: Dict[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in sel.items())


def _match_templates(templates, sel) -> np.ndarray:
    return np.array([_selects(sel, t.labels) for t in templates])


def _count_in(keys_sorted, lo, hi):
    return (np.searchsorted(keys_sorted, hi, "left")
            - np.searchsorted(keys_sorted, lo, "left"))


class State:
    """A set of bound pods: per-node sums and per-domain label counts."""

    def __init__(self, cluster, podset, bound_mask, node_of):
        self.cluster, self.podset = cluster, podset
        t = podset.tmpl[bound_mask]
        nodes = node_of[bound_mask]
        n = len(cluster)
        cpu = np.array([x.cpu for x in podset.templates], dtype=np.int64)
        mem = np.array([x.mem for x in podset.templates], dtype=np.int64)
        self.nz_cpu, self.nz_mem = nonzero(cpu, mem)
        self.cpu = np.bincount(nodes, cpu[t], n).astype(np.int64)
        self.mem = np.bincount(nodes, mem[t], n).astype(np.int64)
        self.nzc = np.bincount(nodes, self.nz_cpu[t], n).astype(np.int64)
        self.nzm = np.bincount(nodes, self.nz_mem[t], n).astype(np.int64)
        self.count = np.bincount(nodes, minlength=n)
        self._t, self._nodes = t, nodes

    def in_domain(self, tmask, key) -> np.ndarray:
        """Bound pods whose template is in `tmask`, counted per node's
        domain under `key`, read back per node."""
        dom = self.cluster.domain(key)
        sel = tmask[self._t]
        per_dom = np.bincount(dom[self._nodes[sel]],
                              minlength=int(dom.max()) + 1)
        return per_dom[dom]

    def feasible(self, ti: int) -> np.ndarray:
        """Nodes that fit one more pod of template `ti` in this state."""
        c, tpl = self.cluster, self.podset.templates
        t = tpl[ti]
        ok = ((self.cpu + t.cpu <= c.cpu) & (self.mem + t.mem <= c.mem)
              & (self.count + 1 <= c.pods))
        for sel, key in t.anti:                       # its own terms
            ok &= self.in_domain(_match_templates(tpl, sel), key) == 0
        for ui, u in enumerate(tpl):                  # existing pods' terms
            for sel, key in u.anti:
                if _selects(sel, t.labels):
                    owners = np.zeros(len(tpl), dtype=bool)
                    owners[ui] = True
                    ok &= self.in_domain(owners, key) == 0
        for sel, key in t.aff:
            m = _match_templates(tpl, sel)
            here = self.in_domain(m, key)
            if m[self._t].any():
                ok &= here > 0
            elif not _selects(sel, t.labels):
                ok &= False
        return ok


def _topology(cluster, podset, out, bound) -> Dict[str, int]:
    """Required inter-pod terms over the binds in store order."""
    tpl = podset.templates
    idx = np.nonzero(bound)[0]
    tm = podset.tmpl[idx]
    rv = out.bind_rv[idx]
    big = int(out.bind_rv.max()) + 2
    res = {"anti_own": 0, "anti_sym": 0, "affinity": 0}
    for ti, t in enumerate(tpl):
        owners = idx[tm == ti]
        if owners.size == 0 or not (t.anti or t.aff):
            continue
        for terms, kind in ((t.anti, "anti"), (t.aff, "aff")):
            for sel, key in terms:
                dom = cluster.domain(key)
                mt = _match_templates(tpl, sel)[tm]
                m_dom = dom[out.node_of[idx[mt]]]
                m_rv = rv[mt]
                keys = np.sort(m_dom * big + m_rv)
                o_dom = dom[out.node_of[owners]]
                o_rv = out.bind_rv[owners]
                before = _count_in(keys, o_dom * big, o_dom * big + o_rv)
                after = _count_in(keys, o_dom * big + o_rv + 1,
                                  (o_dom + 1) * big)
                if kind == "anti":
                    res["anti_own"] += int((before > 0).sum())
                    res["anti_sym"] += int((after > 0).sum())
                else:
                    prior_any = np.searchsorted(np.sort(m_rv), o_rv, "left")
                    lonely = ((prior_any > 0) & (before == 0)) | (
                        (prior_any == 0) & (not _selects(sel, t.labels)))
                    res["affinity"] += int(lonely.sum())
    return res


def _excl_per_node(values, seg_first):
    """Within each run of one node (rows sorted by node, then bind order):
    the sum of the earlier rows' values."""
    cs = np.cumsum(values)
    first = np.maximum.accumulate(np.where(seg_first,
                                           np.arange(values.size), 0))
    return cs - values - (cs[first] - values[first])


def score_regret(cluster, podset, out) -> Tuple[int, int]:
    """(total regret in points, pods scored) over the bound pods in store
    bind order (module doc). Exact for any mix: for each score level, the
    bind instants at which some node held at least that score are counted
    from each node's piecewise-constant score between its own binds."""
    idx = np.nonzero(out.node_of >= 0)[0]
    e = idx.size
    if e == 0:
        return 0, 0
    order = idx[np.argsort(out.bind_rv[idx], kind="stable")]
    nodes = out.node_of[order]
    t = podset.tmpl[order]
    tpl = podset.templates
    req_c = np.array([x.cpu for x in tpl], dtype=np.int64)
    req_m = np.array([x.mem for x in tpl], dtype=np.int64)
    nz_c, nz_m = nonzero(req_c, req_m)
    rank = np.arange(e)
    by = np.lexsort((rank, nodes))          # by node, then bind order
    sn, sr, st = nodes[by], rank[by], t[by]
    first = np.r_[True, sn[1:] != sn[:-1]]
    last = np.r_[sn[1:] != sn[:-1], True]
    before = [_excl_per_node(v[st], first) for v in (req_c, req_m, nz_c, nz_m)]
    before.append(_excl_per_node(np.ones(e, dtype=np.int64), first))
    after = [b + v[st] for b, v in zip(before, (req_c, req_m, nz_c, nz_m))]
    after.append(before[4] + 1)
    n = len(cluster)
    cap_c, cap_m, cap_p = cluster.cpu, cluster.mem, cluster.pods
    first_rank = np.full(n, e)
    first_rank[sn[first]] = sr[first]
    # every node's pieces: [start, end] bind instants over which its state
    # stands (the state just before bind k is the one covering k)
    p_start = np.concatenate([np.zeros(n, dtype=np.int64), sr + 1])
    nxt = np.r_[sr[1:], e]
    p_end = np.concatenate([first_rank, np.where(last, e, nxt)])

    def node_score(u, c, m, zc, zm, cnt, nd):
        """Template u's score on nodes nd holding (c, m, zc, zm, cnt);
        -1 where u does not fit."""
        fit = ((c + req_c[u] <= cap_c[nd]) & (m + req_m[u] <= cap_m[nd])
               & (cnt + 1 <= cap_p[nd]))
        return np.where(fit, score(zc + nz_c[u], zm + nz_m[u],
                                   cap_c[nd], cap_m[nd]), -1)

    empty = [np.zeros(n, dtype=np.int64)] * 5
    total = 0
    for u in np.unique(t):
        p_score = np.concatenate([node_score(u, *empty, np.arange(n)),
                                  node_score(u, *after, sn)])
        best = np.full(e + 1, -1, dtype=np.int64)
        for s in range(int(p_score.max()) + 1):
            sel = p_score >= s
            cover = (np.bincount(p_start[sel], minlength=e + 2)
                     - np.bincount(p_end[sel] + 1, minlength=e + 2))
            best = np.where(np.cumsum(cover)[:e + 1] > 0, s, best)
        mine = st == u
        own = node_score(u, *(b[mine] for b in before), sn[mine])
        total += int((best[sr[mine]] - own).sum())
    return total, e


def check(cluster, podset, out: Outcome) -> Dict[str, int]:
    """Every check of CHECKS, each a count of violations."""
    n = len(cluster)
    bound = out.node_of >= 0
    if (out.node_of >= n).any():
        raise ValueError("a bind names a node outside the cluster")
    end = State(cluster, podset, bound, out.node_of)
    res = {"double_binds": int(np.maximum(out.bind_count - 1, 0).sum()),
           "unread_binds": int((out.acked & ~bound).sum()),
           "over_capacity": int(((end.cpu > cluster.cpu)
                                 | (end.mem > cluster.mem)
                                 | (end.count > cluster.pods)).sum())}
    res.update(_topology(cluster, podset, out, bound))
    pending = 0
    for ti in np.unique(podset.tmpl[~bound]):
        if end.feasible(int(ti)).any():
            pending += int(((podset.tmpl == ti) & ~bound).sum())
    res["pending_fit"] = pending
    res["score_regret"] = score_regret(cluster, podset, out)
    return {k: res[k] for k in CHECKS}


def aggregate(results: List[dict]) -> Dict[str, float]:
    """The compared numbers over several judged pod sets (episodes): each
    count summed, and the mean regret over every bound pod of all."""
    out = {k: sum(r[k] for r in results) for k in CHECKS
           if k != "score_regret"}
    pts = sum(r["score_regret"][0] for r in results)
    pods = sum(r["score_regret"][1] for r in results)
    out["score_regret"] = pts / pods if pods else 0.0
    return {k: out[k] for k in CHECKS}


def failing(values: Dict[str, float]) -> List[str]:
    return [k for k in CHECKS if values[k] > LIMITS[k]]
