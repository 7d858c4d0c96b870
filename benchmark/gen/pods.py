"""The pod mixes: a mix is a list of templates (requests, labels, required
inter-pod terms) and one template index per pod. The configuration names
its generator (`pods.generator`), a module gen/mix/<generator>.py whose
`make(conf, n, seed, episode)` returns both; a new generator is a new file
there."""

import importlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

# (match_labels selector, topology key)
Term = Tuple[Dict[str, str], str]


@dataclass
class Template:
    cpu: int                              # millicores requested
    mem: int                              # bytes requested
    labels: Dict[str, str] = field(default_factory=dict)
    anti: List[Term] = field(default_factory=list)   # required anti-affinity
    aff: List[Term] = field(default_factory=list)    # required affinity


@dataclass
class PodSet:
    templates: List[Template]
    tmpl: np.ndarray                      # int64 [P] template of each pod
    names: List[str]
    namespace: str

    def __len__(self):
        return len(self.names)


def make_pods(conf: dict, n: int, seed: int, episode: int,
              prefix: str) -> PodSet:
    """`n` pods of the configuration's mix for one episode, named
    `<prefix><i>`."""
    gen = importlib.import_module(
        f"benchmark.gen.mix.{conf['pods']['generator']}")
    templates, tmpl = gen.make(conf, n, seed, episode)
    return PodSet(templates, np.asarray(tmpl, dtype=np.int64),
                  [f"{prefix}{i}" for i in range(n)],
                  conf["pods"]["namespace"])
