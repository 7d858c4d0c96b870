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
    pointed at package `root`, and every tests.<module> it imports
    (tests/helpers.py, tests/test_full_fuzz.py, tests/test_nodes.py, ...)
    built the same way on `root`: its generators build `root`'s own
    objects from the same seeds. The module's `__file__` is the reference
    file's path. Built once per (name, root)."""
    import pathlib
    import re
    import sys
    import types
    alias = f"tests._{name}_{root}"
    if alias in sys.modules:
        return sys.modules[alias]
    path = pathlib.Path(__file__).with_name(f"{name}.py")
    src = path.read_text()
    src = re.sub(r"^(\s*)(from|import) kubernetes_tpu([ .])",
                 rf"\1\2 {root}\3", src, flags=re.M)
    for dep in sorted(set(re.findall(r"^\s*from tests\.(\w+) import",
                                     src, flags=re.M))):
        dep_alias = reference_test_module(dep, root).__name__
        src = re.sub(rf"^(\s*)from tests\.{dep} import",
                     rf"\1from {dep_alias} import", src, flags=re.M)
    mod = types.ModuleType(alias)
    mod.__file__ = str(path)
    sys.modules[alias] = mod
    try:
        exec(compile(src, str(path), "exec"), mod.__dict__)
    except BaseException:
        del sys.modules[alias]
        raise
    return mod


def twin(obj, root, _memo=None):
    """`obj`, built of one package's classes, rebuilt field by field of
    package `root`'s classes of the same module path and name (enums by
    member name); containers are rebuilt around their twins, anything
    else is shared. The same inputs for the other package's helpers."""
    import enum
    memo = {} if _memo is None else _memo
    if id(obj) in memo:
        return memo[id(obj)]
    cls = type(obj)
    mod = cls.__module__
    pkg = next((p for p in (REF, PORT)
                if mod == p or mod.startswith(p + ".")), None)
    if pkg is not None:
        target = getattr(importlib.import_module(root + mod[len(pkg):]),
                         cls.__qualname__)
        if isinstance(obj, enum.Enum):
            return target[obj.name]
        new = target.__new__(target)
        memo[id(obj)] = new
        new.__dict__.update({name: twin(v, root, memo)
                             for name, v in vars(obj).items()})
        return new
    if isinstance(obj, (list, tuple, set, frozenset)):
        return cls(twin(v, root, memo) for v in obj)
    if isinstance(obj, dict):
        return cls((twin(a, root, memo), twin(b, root, memo))
                   for a, b in obj.items())
    return obj
