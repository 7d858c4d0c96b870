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
    for through its module). `extra` adds names of its own (the seeded
    generator's, say); `dev` is what an entry point of this package is
    given to run on the CPU (nothing for the reference, device="cpu"
    for the port)."""

    def __init__(self, root, modules, extra=None):
        self.root = root
        self.dev = {"device": "cpu"} if root == PORT else {}
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
        self._flat.update(extra or {})

    def __getattr__(self, name):
        try:
            return self.__dict__["_flat"][name]
        except KeyError:
            raise AttributeError(name) from None


def helpers(root):
    """tests/helpers.py (the seeded random cluster generator) built on
    package `root`'s own types: the same seeds give the same nodes and
    pods in either package."""
    return reference_test_module("helpers", root)



def reference_test_module(name, root):
    """The reference's tests/<name>.py with its imports of the reference
    (and of tests/helpers.py) pointed at package `root`: its generators
    build `root`'s own objects from the same seeds."""
    import pathlib
    import re
    import sys
    import types
    src = (pathlib.Path(__file__).with_name(f"{name}.py")).read_text()
    src = re.sub(r"^(\s*)from kubernetes_tpu([ .])", rf"\1from {root}\2",
                 src, flags=re.M)
    if name != "helpers":
        alias = f"tests._helpers_{root}"
        sys.modules.setdefault(alias, helpers(root))
        src = src.replace("from tests.helpers import",
                          f"from {alias} import")
    mod = types.ModuleType(f"tests.{name}[{root}]")
    exec(compile(src, mod.__name__, "exec"), mod.__dict__)
    return mod
