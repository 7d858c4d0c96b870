"""The port stands alone: no module of kubernetes_tpu_torch, and neither
chip_smoke.py nor kernel_ab.py, imports jax or the reference package; the
package imports with both blocked, and its mesh and sanitizer run so; a spawned cell process or fleet worker
of the port never imports either; and its entry points refuse to run on a
box without a card unless the caller names the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest

import kubernetes_tpu_torch
from kubernetes_tpu_torch.engine.scheduler import Scheduler
from kubernetes_tpu_torch.federation.cell import CellAgent
from kubernetes_tpu_torch.federation.router import FederationRouter, LocalCell
from kubernetes_tpu_torch.parallel.mesh import make_mesh
from kubernetes_tpu_torch.engine.scheduler_engine import (
    SchedulingEngine,
    evaluate_pod,
    evaluate_pods_batch,
)
from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite
from kubernetes_tpu_torch.server.daemon import SchedulerDaemon
from kubernetes_tpu_torch.server.extender import TPUExtenderBackend
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


SCANNED = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py",
                                       REPO / "kernel_ab.py"]


@pytest.mark.parametrize("path", SCANNED,
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


def test_mesh_and_sanitizer_are_scanned_and_run_with_jax_blocked():
    """The two modules that replace the reference's last jax-importing
    device modules (parallel/mesh.py, analysis/sanitize.py) are in the
    scan above, and import and run in a process where jax and the
    reference package cannot be imported."""
    for rel in ("parallel/mesh.py", "analysis/sanitize.py"):
        assert PKG / rel in SCANNED
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kubernetes_tpu'] = None\n"
        "import numpy as np\n"
        "from kubernetes_tpu_torch.parallel import mesh\n"
        "from kubernetes_tpu_torch.analysis import sanitize\n"
        "m = mesh.make_mesh(2, device='cpu')\n"
        "t = sanitize.upload_copied(np.arange(8), 'cpu',\n"
        "                           mesh.Placement(m, 0))\n"
        "assert [s.shape[0] for s in t.shards] == [4, 4]\n"
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
    with pytest.raises(RuntimeError, match="CUDA"):
        TPUExtenderBackend()
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_pods_batch([], {}, ClusterSnapshot(), ())
    with pytest.raises(RuntimeError, match="CUDA"):
        SchedulerDaemon(ApiServerLite(), "me")
    with pytest.raises(RuntimeError, match="CUDA"):
        FederationRouter([LocalCell("c0", None)])
    with pytest.raises(RuntimeError, match="CUDA"):
        CellAgent("c0", [])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(4)


class _StopAtOnce:
    """A control queue whose first message is "stop"."""

    def get(self, timeout=None):
        return "stop"


def _spawned_child(kind, cfg, out_q):
    """Spawn target: run one of the port's process entry points, then
    report which forbidden modules the child ever imported."""
    if kind == "cell":
        from kubernetes_tpu_torch.federation.cell import run_cell_process
        run_cell_process(cfg, out_q, _StopAtOnce())
    else:
        from kubernetes_tpu_torch.parallel.multiproc import _worker_main
        _worker_main(cfg, out_q)
    out_q.put({"modules": sorted(m for m in sys.modules
                                 if m.split(".")[0] in FORBIDDEN)})


@pytest.mark.parametrize("kind", ["cell", "worker"])
def test_spawned_children_import_no_jax_or_reference(kind):
    import multiprocessing

    from kubernetes_tpu_torch.api.types import make_pod
    from kubernetes_tpu_torch.models.hollow import hollow_nodes
    from kubernetes_tpu_torch.server import framing
    from kubernetes_tpu_torch.server.asyncwire import AsyncBinaryServer
    from kubernetes_tpu_torch.server.embedded import VerdictService

    srv = None
    if kind == "cell":
        cfg = {"cell": "iso", "n_nodes": 8, "device": "cpu"}
    else:
        backend = TPUExtenderBackend(device="cpu")
        backend.sync_nodes(hollow_nodes(8))
        srv = AsyncBinaryServer(VerdictService(backend))
        srv.start()
        pods = [make_pod(f"iso-{i}", cpu=100, memory=64 << 20)
                for i in range(2)]
        cfg = {"worker_id": 0, "host": "127.0.0.1", "port": srv.port,
               "pods_blob": framing.encode_items_blob(pods, "pods"),
               "device": "cpu"}
    ctx = multiprocessing.get_context("spawn")
    out_q = ctx.Queue()
    proc = ctx.Process(target=_spawned_child, args=(kind, cfg, out_q),
                       daemon=True)
    proc.start()
    try:
        msgs = []
        while not msgs or "modules" not in msgs[-1]:
            msgs.append(out_q.get(timeout=120))
        proc.join(timeout=30)
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=5)
        if srv is not None:
            srv.stop()
    assert all(m.get("ok", True) for m in msgs), msgs
    assert msgs[-1]["modules"] == []
    if kind == "cell":
        assert msgs[0]["port"] > 0 and msgs[1]["final"]
    else:
        assert msgs[0]["counts"]["binds"] == 2
