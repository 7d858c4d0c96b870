"""The slice whole: the controller manager, the cloud provider and volumes
in front of the scheduler, the reference's stack (ControllerManager and
Scheduler on JAX, on the CPU) against the port's (Scheduler(device="cpu")).

One world in each package, built alike: hollow nodes with zone and
region labels, GCE PDs created in the package's FakeCloud across the
zones, their PersistentVolumes created through the package's ApiServer
(whose PersistentVolumeLabel plugin stamps each PV with its disk's zone
from the FakeCloud), claims bound by PersistentVolumeBinder, then
Deployments with mixed_affinity templates, one DaemonSet, one Job and
bare pods that each mount one claim. The controllers are pumped to
stability, the scheduler drains, the attach/detach controller attaches
the disks; half the Deployments are scaled up by half, pumped and
drained again.

The bar is exact (ROADMAP, "How a slice is held"): the pod -> node
placements, the ReplicaSets' names and sizes, the claim -> PV bindings
and the FakeCloud attachments must be equal; and the run holds what it
is scripted to hold (every pod bound, one DaemonSet pod per node, each
claim's pod in its PV's zone, no node past the attachable-disk limit,
each disk attached to exactly its pod's node)."""

from __future__ import annotations

import dataclasses

import pytest

from tests.torch_packages import PORT, REF, Pkg

MODULES = {
    "chain": "admission.chain", "plugins": "admission.plugins",
    "types": "api.types", "workloads": "api.workloads", "cloud": "cloud",
    "manager": "controllers.manager", "scheduler": "engine.scheduler",
    "hollow": "models.hollow", "apiserver": "server.apiserver",
    "lite": "server.apiserver_lite",
}

PKGS = {REF: Pkg(REF, MODULES), PORT: Pkg(PORT, MODULES)}
DEVICE = {REF: {}, PORT: {"device": "cpu"}}

Mi, Gi = 1 << 20, 1 << 30
REGION_LABEL = "failure-domain.beta.kubernetes.io/region"
ZONE_LABEL = "failure-domain.beta.kubernetes.io/zone"
REGION = "region-1"
N_NODES, REPLICAS, N_PD, JOB = 256, 100, 64, 40
# the Deployments' templates: these of mixed_affinity's first hundred pods
# (two hostname anti-affinity apps, one zone-packing group, one
# anti-affinity target, twelve plain) so that every replica fits 256 nodes
TEMPLATES = (0, 1, 15, 17, *range(22, 34))


def world(k, n_nodes=N_NODES, templates=TEMPLATES, replicas=REPLICAS,
          n_pd=N_PD, job=JOB):
    """Build, pump, drain, attach, scale, pump, drain, attach. Returns the
    store, the cloud and the pump rounds of each pass."""
    api = k.ApiServerLite()
    for node in k.hollow_nodes(n_nodes):
        node.labels[REGION_LABEL] = REGION
        api.create("Node", node)
    cloud = k.FakeCloud()
    cm = k.ControllerManager(api, record_events=False, cloud=cloud)
    plugins = k.default_plugins()
    plugins.insert(-1, k.PersistentVolumeLabel(cloud))
    front = k.ApiServer(store=api,
                        admission=k.AdmissionChain(plugins, store=api))
    for i in range(n_pd):
        cloud.create_disk(f"pd-{i:04d}", size_gb=10,
                          zone=k.ZONES[i % len(k.ZONES)], region=REGION)
        front.create("PersistentVolume", k.PersistentVolume(
            f"pv-{i:04d}", capacity=10 * Gi, access_modes=["ReadWriteOnce"],
            source=k.Volume(name=f"pd-{i:04d}", kind=k.VolumeKind.GCE_PD,
                            volume_id=f"pd-{i:04d}")))
        api.create("PersistentVolumeClaim", k.PersistentVolumeClaim(
            f"claim-{i:04d}", "default", capacity=10 * Gi,
            access_modes=["ReadWriteOnce"]))
    rounds = [cm.pump_until_stable()]
    sched = k.Scheduler(api, record_events=False, **DEVICE[k.root])
    sched.start()
    profile = k.mixed_affinity_pods(100, namespace="default")
    for i, tpl in enumerate(profile[t] for t in templates):
        name = f"d{i:03d}"
        template = dataclasses.replace(
            tpl, name="", uid="", labels=dict(tpl.labels, deploy=name))
        api.create("Deployment", k.Deployment(
            name=name, replicas=replicas, template=template,
            selector=k.LabelSelector(match_labels={"deploy": name})))
    api.create("DaemonSet", k.DaemonSet(
        name="node-agent",
        selector=k.LabelSelector(match_labels={"ds": "node-agent"}),
        template=k.make_pod("", labels={"ds": "node-agent"}, cpu=100,
                            memory=64 * Mi)))
    api.create("Job", k.Job(
        name="batch", completions=job, parallelism=job,
        template=dataclasses.replace(
            k.make_pod("", labels={"job": "batch"}, cpu=100,
                       memory=128 * Mi), restart_policy="Never")))
    for i in range(n_pd):
        pod = k.make_pod(f"db-{i:04d}", cpu=100, memory=256 * Mi,
                         labels={"app": "db"})
        pod.volumes = [k.Volume(name="data", kind=k.VolumeKind.PVC,
                                volume_id=f"claim-{i:04d}")]
        api.create("Pod", pod)
    totals = []
    for scale in (False, True):
        if scale:
            for i in range(0, len(templates), 2):
                dep = api.get("Deployment", "default", f"d{i:03d}")
                api.update("Deployment", dataclasses.replace(
                    dep, replicas=dep.replicas + dep.replicas // 2))
        rounds.append(cm.pump_until_stable())
        totals.append(sched.run_until_drained())
        rounds.append(cm.pump_until_stable())
    close = getattr(sched.engine, "close", None)
    if close is not None:
        close()
    return api, cloud, rounds, totals


def outcome(api, cloud):
    pods = api.list("Pod")[0]
    return {
        "placements": sorted((p.key(), p.node_name) for p in pods),
        "replicasets": sorted((rs.name, rs.owner_name, rs.replicas)
                              for rs in api.list("ReplicaSet")[0]),
        "claims": sorted((c.name, c.volume_name)
                         for c in api.list("PersistentVolumeClaim")[0]),
        "attachments": sorted(cloud.attachments.items()),
    }


@pytest.fixture(scope="module")
def runs():
    return {root: world(PKGS[root]) for root in (REF, PORT)}


@pytest.mark.parametrize("what", ["placements", "replicasets", "claims",
                                  "attachments", "rounds", "totals"])
def test_port_equals_reference(runs, what):
    got = {}
    for root, (api, cloud, rounds, totals) in runs.items():
        got[root] = {"rounds": rounds, "totals": totals,
                     **outcome(api, cloud)}[what]
    assert got[PORT] == got[REF]


def test_the_world_holds_what_it_was_scripted_to(runs):
    api, cloud, rounds, totals = runs[PORT]
    assert max(rounds) < 60  # every pump converged before its cap
    pods = api.list("Pod")[0]
    nodes = {n.name: n for n in api.list("Node")[0]}
    assert all(p.node_name for p in pods)
    want = {f"d{i:03d}": REPLICAS + (REPLICAS // 2 if i % 2 == 0 else 0)
            for i in range(len(TEMPLATES))}
    rses = api.list("ReplicaSet")[0]
    assert sorted(rs.owner_name for rs in rses) == sorted(want)
    for rs in rses:
        assert rs.replicas == want[rs.owner_name]
        assert sum(1 for p in pods if p.owner_kind == "ReplicaSet"
                   and p.owner_name == rs.name) == rs.replicas
    ds = [p for p in pods if p.owner_kind == "DaemonSet"]
    assert sorted(p.node_name for p in ds) == sorted(nodes)
    assert sum(1 for p in pods if p.owner_kind == "Job") == JOB
    pvs = {pv.name: pv for pv in api.list("PersistentVolume")[0]}
    claims = {c.name: c for c in api.list("PersistentVolumeClaim")[0]}
    assert all(c.volume_name for c in claims.values())
    per_node = {}
    for p in pods:
        if not p.volumes:
            continue
        pv = pvs[claims[p.volumes[0].volume_id].volume_name]
        assert pv.labels[ZONE_LABEL] == nodes[p.node_name].labels[ZONE_LABEL]
        assert cloud.attachments[pv.source.volume_id] == p.node_name
        per_node[p.node_name] = per_node.get(p.node_name, 0) + 1
    assert len(cloud.attachments) == N_PD
    assert max(per_node.values()) <= cloud.max_disks_per_node
    assert sum(t["bound"] for t in totals) == len(pods) - len(ds)
