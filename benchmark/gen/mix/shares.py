"""The general generator: the configuration lists its pod templates under
`pods.templates`, each with its share of the pods. Every seed gives the
same number of pods of each template (counts within one of share x n),
in another order, so the work of a run does not move with its seed.

A template:
    {"share": 0.15, "cpu_milli": 100, "memory_bytes": 268435456,
     "labels": {"app": "a"},
     "anti": [{"match_labels": {"app": "a"},
               "topology_key": "kubernetes.io/hostname"}],
     "affinity": [...]}
"""

from typing import List

import numpy as np

from benchmark.gen.pods import Template
from benchmark.gen.seeds import rng


def _exact_counts(n: int, shares: List[float]) -> List[int]:
    """Counts that sum to n, each within one of share * n."""
    total = sum(shares)
    raw = [s * n / total for s in shares]
    out = [int(r) for r in raw]
    order = sorted(range(len(raw)), key=lambda i: out[i] - raw[i])
    for i in order[:n - sum(out)]:
        out[i] += 1
    return out


def _terms(entries):
    return [(dict(e["match_labels"]), e["topology_key"]) for e in entries]


def make(conf: dict, n: int, seed: int, episode: int):
    spec = conf["pods"]["templates"]
    templates = [Template(int(t["cpu_milli"]), int(t["memory_bytes"]),
                          dict(t.get("labels", {})),
                          anti=_terms(t.get("anti", [])),
                          aff=_terms(t.get("affinity", [])))
                 for t in spec]
    counts = _exact_counts(n, [float(t["share"]) for t in spec])
    tmpl = np.repeat(np.arange(len(spec), dtype=np.int64), counts)
    if len(spec) > 1:
        tmpl = tmpl[rng(seed, "pods", episode).permutation(n)]
    return templates, tmpl
