"""tests/test_hygiene.py's contracts over the port (the cmd/importverifier
and cmd/clicheck analog): every module of kubernetes_tpu_torch imports;
no module of it reads the reference's source tree at runtime (the
reference's own check, run over the port's files, and no string in the
port's code, docstrings aside, names a path or module of the
kubernetes_tpu package); every ktctl verb is dispatchable and the wire
registry covers the apiserver's kinds, in both packages (the `k`
fixture). Last, the hyperkube dispatcher (__main__.py) of both packages:
help, version, an unknown component, and `scheduler --nodes 50 --pods
500` binding every pod, the port on the CPU (`--device cpu`), with the
reference's printed bound= count."""

from __future__ import annotations

import ast
import importlib
import io
import pathlib
import pkgutil
import re

import pytest

import kubernetes_tpu_torch
from tests import test_hygiene
from tests.torch_packages import PORT, REF, Pkg

MODULES = {
    "api_wire": "api.wire",
    "cli_ktctl": "cli.ktctl",
    "hyperkube": "__main__",
    "server_apiserver": "server.apiserver",
}
PKGS = {REF: Pkg(REF, MODULES), PORT: Pkg(PORT, MODULES)}
ROOT = pathlib.Path(kubernetes_tpu_torch.__file__).parent


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return PKGS[request.param]


def test_every_port_module_imports():
    failures = []
    for mod in pkgutil.walk_packages(kubernetes_tpu_torch.__path__,
                                     prefix="kubernetes_tpu_torch."):
        if mod.name.endswith("__main__"):
            continue
        try:
            importlib.import_module(mod.name)
        except Exception as e:  # noqa: BLE001 - collecting all failures
            failures.append(f"{mod.name}: {type(e).__name__}: {e}")
    assert not failures, failures


def test_no_runtime_reads_of_the_reference_tree(monkeypatch):
    """The reference's check, over the port's files."""
    monkeypatch.setattr(test_hygiene, "ROOT", ROOT)
    test_hygiene.test_no_runtime_reads_of_the_reference_tree()


def _docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and \
                    isinstance(first.value, ast.Constant):
                yield id(first.value)


def test_no_string_names_the_reference_package():
    """No string the port's code builds at runtime names a file or module
    of kubernetes_tpu: the port opens, imports and spawns only its own."""
    names_ref = re.compile(r"kubernetes_tpu(?!_torch)[./]")
    offenders = []
    for path in sorted(ROOT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        docs = set(_docstrings(tree))
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and id(node) not in docs \
                    and names_ref.search(node.value):
                offenders.append(f"{path}:{node.lineno}: {node.value[:80]}")
    assert not offenders, offenders


def test_ktctl_verbs_dispatchable(k):
    kt = k.Ktctl(k.ApiServer(), out=io.StringIO())
    verbs = [m[len("cmd_"):].replace("_", "-") for m in dir(kt)
             if m.startswith("cmd_")]
    assert len(verbs) >= 20
    for verb in verbs:
        assert getattr(kt, "cmd_" + verb.replace("-", "_"), None) \
            is not None


def test_ktctl_verbs_equal_in_both_packages():
    verbs = {root: sorted(m for m in dir(PKGS[root].Ktctl)
                          if m.startswith("cmd_"))
             for root in (REF, PORT)}
    assert verbs[PORT] == verbs[REF]


def test_wire_registry_covers_served_kinds(k):
    # kinds the apiserver serves but the wire codec cannot carry would
    # break the REST facade on first touch
    missing = [kind for kind in k.KIND_INFO if kind not in k.KIND_REGISTRY]
    assert not missing, missing
    assert sorted(PKGS[PORT].KIND_INFO) == sorted(PKGS[REF].KIND_INFO)


# ------------------------------------------------- the hyperkube dispatcher


def test_dispatcher_help_version_and_unknown(k, capsys):
    main = k.hyperkube.main
    assert main(["help"]) == 0
    usage = capsys.readouterr().out
    assert usage == (f"usage: python -m {k.root} "
                     "{apiserver|ktadm|ktctl|scheduler|version} ...\n")
    assert main([]) == 0
    assert capsys.readouterr().out == usage
    assert main(["version"]) == 0
    assert capsys.readouterr().out == (
        "kubernetes-tpu v1.7.0-tpu.0 (hyperkube-style dispatcher)\n")
    assert main(["no-such-thing"]) == 1
    err = capsys.readouterr().err
    assert "unknown component 'no-such-thing'" in err
    assert sorted(k.hyperkube.COMPONENTS) == [
        "apiserver", "ktadm", "ktctl", "scheduler"]


def _bound(line):
    return re.search(r"bound=(\d+)/(\d+)", line).groups()


def test_dispatcher_scheduler_binds_every_pod(capsys):
    """`scheduler --nodes 50 --pods 500`: two daemons, one leads and binds
    every pod; the port on the CPU prints the reference's bound= count."""
    got = {}
    for root, extra in ((REF, []), (PORT, ["--device", "cpu"])):
        assert PKGS[root].hyperkube.main(
            ["scheduler", "--nodes", "50", "--pods", "500", *extra]) == 0
        got[root] = capsys.readouterr().out.strip().splitlines()[-1]
    assert _bound(got[PORT]) == _bound(got[REF]) == ("500", "500")
    assert got[PORT].startswith("leader=daemon-")
