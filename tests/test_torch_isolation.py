"""The port stands alone: no module of kubernetes_tpu_torch, and neither
chip_smoke.py nor kernel_ab.py, imports jax or the reference package; the
package imports with both blocked; and its entry points refuse to run on a
box without a card unless the caller names the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest

import kubernetes_tpu_torch
from kubernetes_tpu_torch.engine.scheduler import Scheduler
from kubernetes_tpu_torch.engine.scheduler_engine import (
    SchedulingEngine,
    evaluate_pod,
)
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite
from kubernetes_tpu_torch.state.cache import SchedulerCache
from kubernetes_tpu_torch.state.snapshot import ClusterSnapshot

PKG = pathlib.Path(kubernetes_tpu_torch.__file__).parent
REPO = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "kubernetes_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [REPO / "chip_smoke.py",
                            REPO / "kernel_ab.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: {bad}"


def test_package_imports_with_jax_and_reference_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kubernetes_tpu'] = None\n"
        "import kubernetes_tpu_torch as k\n"
        "for m in pkgutil.walk_packages(k.__path__, 'kubernetes_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        SchedulingEngine(SchedulerCache())
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_pod(None, {}, ClusterSnapshot(), ())
    with pytest.raises(RuntimeError, match="CUDA"):
        Scheduler(ApiServerLite())
