"""Both packages side by side for the port's parity tests: `Pkg(root,
modules)` loads one package's modules by short name and exposes their
public names flat, so one test body runs against the reference
(kubernetes_tpu) and the port (kubernetes_tpu_torch) alike."""

from __future__ import annotations

import importlib

REF, PORT = "kubernetes_tpu", "kubernetes_tpu_torch"


class Pkg:
    """One package's modules by short name, and their public names
    flat (a name two modules bind to different objects must be asked
    for through its module)."""

    def __init__(self, root, modules):
        self.root = root
        self._flat, clash = {}, set()
        for short, mod in modules.items():
            m = importlib.import_module(f"{root}.{mod}")
            setattr(self, short, m)
            for name, val in vars(m).items():
                if name.startswith("_"):
                    continue
                if name in self._flat and self._flat[name] is not val:
                    clash.add(name)
                self._flat.setdefault(name, val)
        for name in clash:
            del self._flat[name]

    def __getattr__(self, name):
        try:
            return self.__dict__["_flat"][name]
        except KeyError:
            raise AttributeError(name) from None


def helpers(root):
    """tests/helpers.py (the seeded random cluster generator) built on
    package `root`'s own types: the same seeds give the same nodes and
    pods in either package."""
    import pathlib
    import types
    src = (pathlib.Path(__file__).with_name("helpers.py")).read_text()
    mod = types.ModuleType(f"tests.helpers[{root}]")
    exec(compile(src.replace("from kubernetes_tpu.api.types import",
                             f"from {root}.api.types import"),
                 mod.__name__, "exec"), mod.__dict__)
    return mod
