"""The port stands alone: no module of kubernetes_tpu_torch, and neither
chip_smoke.py nor kernel_ab.py, imports jax or the reference package; the
package imports with both blocked, its mesh, sanitizer and front door
(admission, auth, quota, the full apiserver, REST, WAL shipping), its
trace exporter, trend reader and flight-recorder CLI, its cloud
provider, volumes and controllers, its node agents (the kubelet, the
CRI, kube-proxy, the probers and the host-ops loader), and its command
line (the hyperkube dispatcher, ktctl, ktadm, strategic merge patch) and
linter (graftlint's engine, rules and CLI) import and run so; a spawned
cell process or fleet worker of the port never imports either; and its
entry points refuse to run on a box without a card unless the caller
names the CPU (the CLI's --trend needs no card)."""

import ast
import json
import os
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
from kubernetes_tpu_torch.server.apiserver import ApiServer
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


FRONT_DOOR = ("quota/__init__.py", "quota/evaluator.py",
              "auth/__init__.py", "auth/authn.py", "auth/authz.py",
              "admission/__init__.py", "admission/chain.py",
              "admission/plugins.py", "admission/webhook.py",
              "api/fields.py", "server/extensions.py", "server/apiserver.py",
              "server/openapi.py", "server/rest_http.py",
              "server/replication.py", "cli/__init__.py",
              "cli/rest_client.py", "testing/chaosmonkey.py")


def test_front_door_is_scanned_and_runs_with_jax_blocked():
    """The full apiserver's modules are in the scan above, and they
    import and serve one admitted create in a process where jax and the
    reference package cannot be imported."""
    for rel in FRONT_DOOR:
        assert PKG / rel in SCANNED, rel
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kubernetes_tpu'] = None\n"
        "import kubernetes_tpu_torch.admission\n"
        "import kubernetes_tpu_torch.auth.authn\n"
        "import kubernetes_tpu_torch.auth.authz\n"
        "import kubernetes_tpu_torch.quota\n"
        "import kubernetes_tpu_torch.cli.rest_client\n"
        "import kubernetes_tpu_torch.server.rest_http\n"
        "import kubernetes_tpu_torch.server.replication\n"
        "from kubernetes_tpu_torch.server.apiserver import ApiServer\n"
        "from kubernetes_tpu_torch.server.openapi import build_spec\n"
        "from kubernetes_tpu_torch.api.types import make_pod\n"
        "from kubernetes_tpu_torch.api.workloads import Namespace\n"
        "api = ApiServer()\n"
        "api.create('Namespace', Namespace(name='iso'))\n"
        "api.create('Pod', make_pod('p', namespace='iso'))\n"
        "assert api.get('Pod', 'iso', 'p') is not None\n"
        "assert build_spec()['paths']\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'kubernetes_tpu')\n"
        "             and sys.modules[m] is not None))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


CONTROL_PLANE = ("observability/perfetto.py", "observability/trend.py",
                 "observability/__main__.py", "cloud/__init__.py",
                 "cloud/provider.py", "volumes/__init__.py",
                 "volumes/plugins.py", "volumes/drivers.py",
                 "volumes/manager.py", "controllers/__init__.py",
                 "controllers/base.py", "controllers/replicaset.py",
                 "controllers/deployment.py", "controllers/job.py",
                 "controllers/daemonset.py", "controllers/statefulset.py",
                 "controllers/endpoint.py", "controllers/namespace.py",
                 "controllers/gc.py", "controllers/nodelifecycle.py",
                 "controllers/quota_sa.py", "controllers/autoscale.py",
                 "controllers/certificates.py", "controllers/cloudctrl.py",
                 "controllers/manager.py")


def test_control_plane_is_scanned_and_runs_with_jax_blocked():
    """The trace exporter, the trend reader, the CLI, the cloud, volumes
    and controllers are in the scan above, and they import and run in a
    process where jax and the reference package cannot be imported: a
    ReplicaSet and a claim pumped to stability, a disk attached through
    the attach/detach controller, a ring rendered, the trend read."""
    for rel in CONTROL_PLANE:
        assert PKG / rel in SCANNED, rel
    code = (
        "import sys, io, contextlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kubernetes_tpu'] = None\n"
        "import kubernetes_tpu_torch.volumes\n"
        "from kubernetes_tpu_torch.api.types import (LabelSelector,\n"
        "    PersistentVolume, PersistentVolumeClaim, Volume, VolumeKind,\n"
        "    make_node, make_pod)\n"
        "from kubernetes_tpu_torch.api.workloads import ReplicaSet\n"
        "from kubernetes_tpu_torch.cloud import FakeCloud\n"
        "from kubernetes_tpu_torch.controllers import ControllerManager\n"
        "from kubernetes_tpu_torch.observability import perfetto, trend\n"
        "from kubernetes_tpu_torch.observability import __main__ as cli\n"
        "from kubernetes_tpu_torch.server.apiserver_lite import "
        "ApiServerLite\n"
        "api = ApiServerLite()\n"
        "api.create('Node', make_node('n0'))\n"
        "cloud = FakeCloud()\n"
        "cloud.create_disk('pd-0')\n"
        "cm = ControllerManager(api, record_events=False, cloud=cloud)\n"
        "tpl = make_pod('', labels={'app': 'a'}, cpu=10)\n"
        "api.create('ReplicaSet', ReplicaSet(name='a', replicas=2,\n"
        "    selector=LabelSelector(match_labels={'app': 'a'}),\n"
        "    template=tpl))\n"
        "api.create('PersistentVolume', PersistentVolume('pv-0',\n"
        "    capacity=1 << 30, source=Volume(name='pv-0',\n"
        "    kind=VolumeKind.GCE_PD, volume_id='pd-0')))\n"
        "api.create('PersistentVolumeClaim', PersistentVolumeClaim(\n"
        "    'c', capacity=1 << 20))\n"
        "p = make_pod('db', cpu=10, node_name='n0')\n"
        "p.volumes = [Volume(name='d', kind=VolumeKind.PVC,\n"
        "                    volume_id='c')]\n"
        "api.create('Pod', p)\n"
        "cm.pump_until_stable()\n"
        "assert len(api.list('Pod')[0]) == 3\n"
        "assert cloud.disks_attached('n0') == ['pd-0']\n"
        "t = perfetto.build_chrome_trace([{'kind': 'dispatch', 'wave': 0,\n"
        "    't': 1.0, 'dur': 0.1, 'a': 1, 'b': 0}])\n"
        "assert t['traceEvents']\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    assert trend.main([]) in (0, 1)\n"
        "    assert cli.main(['--trend']) in (0, 1)\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'kubernetes_tpu')\n"
        "             and sys.modules[m] is not None))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


NODE_AGENTS = ("nodes/__init__.py", "nodes/cri.py", "nodes/checkpoint.py",
               "nodes/images.py", "nodes/kuberuntime.py",
               "nodes/kubelet_server.py", "nodes/kubelet.py",
               "nodes/proxy.py", "utils/probe.py", "native/__init__.py")


def test_node_agents_are_scanned_and_run_with_jax_blocked():
    """The kubelet, the CRI, kube-proxy, the probers and the host-ops
    loader are in the scan above, and they import and run in a process
    where jax and the reference package cannot be imported: a HollowFleet
    of 4 kubelets with a HollowProxy steps a bound pod to Running, the
    Endpoints controller hands it to the proxy, and the snapshot's host
    op fills a multi-hot row."""
    for rel in NODE_AGENTS:
        assert PKG / rel in SCANNED, rel
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kubernetes_tpu'] = None\n"
        "import numpy as np\n"
        "import kubernetes_tpu_torch.nodes.checkpoint\n"
        "from kubernetes_tpu_torch import native\n"
        "from kubernetes_tpu_torch.api.types import make_node, make_pod\n"
        "from kubernetes_tpu_torch.api.workloads import Service, "
        "ServicePort\n"
        "from kubernetes_tpu_torch.client.informer import "
        "SharedInformerFactory\n"
        "from kubernetes_tpu_torch.controllers.endpoint import "
        "EndpointController\n"
        "from kubernetes_tpu_torch.nodes import HollowFleet, HollowProxy\n"
        "from kubernetes_tpu_torch.server.apiserver_lite import "
        "ApiServerLite\n"
        "from kubernetes_tpu_torch.utils.probe import SUCCESS, "
        "probe_exec\n"
        "api = ApiServerLite()\n"
        "factory = SharedInformerFactory(api)\n"
        "fleet = HollowFleet(api, factory, now=lambda: 1000.0)\n"
        "for i in range(4):\n"
        "    fleet.add_node(make_node(f'n{i}', cpu=1000, memory=1 << 30))\n"
        "proxy = HollowProxy(factory)\n"
        "epc = EndpointController(api, factory, record_events=False)\n"
        "api.create('Service', Service('web', 'default',\n"
        "    selector={'app': 'web'}, ports=[ServicePort(port=80)]))\n"
        "api.create('Pod', make_pod('p', cpu=100, node_name='n2',\n"
        "                           labels={'app': 'web'}))\n"
        "factory.step_all()\n"
        "fleet.step()\n"
        "factory.step_all()\n"
        "epc.pump()\n"
        "factory.step_all()\n"
        "assert api.get('Pod', 'default', 'p').phase == 'Running'\n"
        "assert proxy.route('default/web', 80)[2] == 'n2'\n"
        "out = np.zeros((2, 8), dtype=np.int8)\n"
        "native.fill_multi_hot(np.array([[0, 1], [1, 7]]), out)\n"
        "assert out.sum() == 2 and out[1, 7] == 1\n"
        "assert probe_exec(lambda: (0, 'ok'))[0] == SUCCESS\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'kubernetes_tpu')\n"
        "             and sys.modules[m] is not None))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


COMMAND_LINE = (
    "__main__.py", "cli/strategicpatch.py", "cli/ktctl.py", "cli/ktadm.py",
    "analysis/lint.py", "analysis/__main__.py", "analysis/rules/__init__.py",
    "analysis/rules/base.py", "analysis/rules/gl001_aliasing.py",
    "analysis/rules/gl002_hostsync.py", "analysis/rules/gl003_recompile.py",
    "analysis/rules/gl004_tracer.py", "analysis/rules/gl005_generation.py",
    "analysis/rules/gl006_lockorder.py", "analysis/rules/gl007_tornread.py",
    "analysis/rules/gl008_blockloop.py",
    "analysis/rules/gl009_spawnsafety.py")


def test_command_line_and_linter_are_scanned_and_run_with_jax_blocked(
        tmp_path):
    """The 17 modules of the command line and the linter are in the scan
    above, and they import and run in a process where jax and the
    reference package cannot be imported: the dispatcher prints its
    version, ktadm inits a cluster and a node joins it, ktctl runs a
    Deployment through a strategic-merge patch, and the linter lints the
    dispatcher clean."""
    for rel in COMMAND_LINE:
        assert PKG / rel in SCANNED, rel
    code = (
        "import io, json, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kubernetes_tpu'] = None\n"
        "from kubernetes_tpu_torch.__main__ import main\n"
        "from kubernetes_tpu_torch.analysis import run_paths\n"
        "from kubernetes_tpu_torch.cli.ktadm import KtAdm, ca_hash\n"
        "from kubernetes_tpu_torch.cli.ktctl import Ktctl\n"
        "assert main(['version']) == 0\n"
        "adm = KtAdm(out=io.StringIO())\n"
        f"c = adm.init({str(tmp_path / 'c')!r})\n"
        "adm.join(c, 'w0', c.token, ca_cert_hash=ca_hash(c.ca_key))\n"
        "kt = Ktctl(c.api, out=io.StringIO(), cred=c.admin_cred)\n"
        "assert kt.run(['run', 'web', '--image=x', '--replicas=2']) == 0\n"
        "assert kt.run(['patch', 'deployment', 'web', '-p',\n"
        "               json.dumps({'replicas': 3})]) == 0\n"
        "assert c.api.store.get('Deployment', 'default', 'web')"
        ".replicas == 3\n"
        "found, _, errors = run_paths([sys.modules["
        "'kubernetes_tpu_torch.__main__'].__file__])\n"
        "assert found == [] and errors == []\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'kubernetes_tpu')\n"
        "             and sys.modules[m] is not None))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "kubernetes_tpu_torch.observability", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300)


def test_cli_trace_refuses_without_a_card_unless_asked_for_the_cpu(
        tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --trace runs on it")
    out = tmp_path / "trace.json"
    small = ("--nodes", "8", "--pods", "24", "--trace", str(out))
    refused = _cli(*small)
    assert refused.returncode != 0
    assert "CUDA" in refused.stderr and not out.exists()
    done = _cli(*small, "--device", "cpu")
    assert done.returncode == 0, done.stderr
    assert any(e["name"].startswith("device-eval")
               for e in json.loads(out.read_text())["traceEvents"])


def test_cli_trend_needs_no_card():
    got = subprocess.run(
        [sys.executable, "-m", "kubernetes_tpu_torch.observability",
         "--trend"], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert got.returncode in (0, 1), got.stderr
    assert "band" in got.stdout


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
        Scheduler(ApiServer())
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
    from kubernetes_tpu_torch.__main__ import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["scheduler", "--nodes", "4", "--pods", "4"])


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
