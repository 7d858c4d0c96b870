"""A plain serial scheduler: the reference put in the program's place, for
the control of the comparison. It places the pods one at a time, in the
order given, on the best-scoring feasible node (the lowest index among
ties), and returns an Outcome with the binds in that order. The
reference's own tests use it as a sound placement to plant faults in,
and with one guarantee broken, as the step a later change might be
tempted to take:
  first_fit      takes the first feasible node and skips the priorities;
  skip_symmetry  ignores the anti-affinity terms of pods already placed.
"""

import numpy as np

from benchmark.reference.check import Outcome, _match_templates, _selects
from benchmark.reference.scores import nonzero, score

CONTROLS = ("first_fit", "skip_symmetry")


def place(cluster, podset, control: str = "") -> Outcome:
    if control and control not in CONTROLS:
        raise ValueError(f"unknown control {control!r}")
    tpl = podset.templates
    n, p = len(cluster), len(podset)
    cpu = np.zeros(n, dtype=np.int64)
    mem = np.zeros(n, dtype=np.int64)
    nzc = np.zeros(n, dtype=np.int64)
    nzm = np.zeros(n, dtype=np.int64)
    count = np.zeros(n, dtype=np.int64)
    req_c = np.array([t.cpu for t in tpl], dtype=np.int64)
    req_m = np.array([t.mem for t in tpl], dtype=np.int64)
    nz_c, nz_m = nonzero(req_c, req_m)
    # one per-domain count for each distinct (selector, key) of a required
    # term: pods matching it, and pods carrying it as an anti term
    terms = []
    for t in tpl:
        for sel, key in t.anti + t.aff:
            if (sel, key) not in terms:
                terms.append((sel, key))
    doms = [cluster.domain(key) for _, key in terms]
    matches = [_match_templates(tpl, sel) for sel, _ in terms]
    matching = [np.zeros(int(d.max()) + 1, dtype=np.int64) for d in doms]
    carrying = [np.zeros(int(d.max()) + 1, dtype=np.int64) for d in doms]
    own_anti = [[terms.index(x) for x in t.anti] for t in tpl]
    own_aff = [[terms.index(x) for x in t.aff] for t in tpl]
    targeted = [[j for j, (sel, _) in enumerate(terms)
                 if any(j == terms.index(x) for u in tpl for x in u.anti)
                 and _selects(sel, t.labels)] for t in tpl]
    node_of = np.full(p, -1, dtype=np.int64)
    for i in range(p):
        ti = int(podset.tmpl[i])
        ok = ((cpu + req_c[ti] <= cluster.cpu)
              & (mem + req_m[ti] <= cluster.mem)
              & (count + 1 <= cluster.pods))
        for j in own_anti[ti]:
            ok &= matching[j][doms[j]] == 0
        if control != "skip_symmetry":
            for j in targeted[ti]:
                ok &= carrying[j][doms[j]] == 0
        for j in own_aff[ti]:
            if matching[j].any():
                ok &= matching[j][doms[j]] > 0
            elif not matches[j][ti]:
                ok &= False
        cand = np.nonzero(ok)[0]
        if cand.size == 0:
            continue
        if control == "first_fit":
            best = int(cand[0])
        else:
            s = score(nzc[cand] + nz_c[ti], nzm[cand] + nz_m[ti],
                      cluster.cpu[cand], cluster.mem[cand])
            best = int(cand[np.argmax(s)])
        node_of[i] = best
        cpu[best] += req_c[ti]
        mem[best] += req_m[ti]
        nzc[best] += nz_c[ti]
        nzm[best] += nz_m[ti]
        count[best] += 1
        for j in range(len(terms)):
            if matches[j][ti]:
                matching[j][doms[j][best]] += 1
        for j in own_anti[ti]:
            carrying[j][doms[j][best]] += 1
    order = np.arange(p, dtype=np.int64)
    bound = node_of >= 0
    return Outcome(node_of=node_of, bind_rv=np.where(bound, order, -1),
                   bind_count=bound.astype(np.int64), acked=bound)
