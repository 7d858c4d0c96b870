"""The port's volume plugins, drivers and volume manager (volumes/)
against the reference's. The bodies of tests/test_volume_plugins.py run
on both packages (the `k` fixture): plugin lookup by spec, emptyDir,
hostPath, configMap, secret, downward API, projected and NFS payloads,
claim resolution and local-volume node pinning, attachable mounts that
wait for the controller's attach, in-use protection, and the
reconciler, and the kubelet's syncPod gating its start on the mount
(nodes/kubelet with a VolumeManager)."""

from __future__ import annotations

import base64

import pytest

from tests.torch_packages import PORT, REF, Pkg

MODULES = {
    "api_cluster": "api.cluster",
    "api_types": "api.types",
    "client_informer": "client.informer",
    "controllers_cloudctrl": "controllers.cloudctrl",
    "nodes_kubelet": "nodes.kubelet",
    "server_apiserver_lite": "server.apiserver_lite",
    "volumes": "volumes",
    "volumes_plugins": "volumes.plugins",
}

PKGS = {REF: Pkg(REF, MODULES), PORT: Pkg(PORT, MODULES)}


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return PKGS[request.param]


Mi = 1 << 20


def vol(k, name, kind=None, vid="", driver=""):
    kind = k.VolumeKind.OTHER if kind is None else kind
    return k.Volume(name=name, kind=kind, volume_id=vid, driver=driver)


def rig(k, node_name="n1"):
    api = k.ApiServerLite()
    api.create("Node", k.make_node(node_name, cpu=4000, memory=1 << 33))
    host = k.VolumeHost(api=api, node_name=node_name)
    mgr = k.VolumeManager(k.VolumePluginManager(k.default_plugins()), host)
    return api, host, mgr


def test_find_plugin_by_spec_exactly_one(k):
    pm = k.VolumePluginManager(k.default_plugins())
    assert pm.find_plugin_by_spec(
        k.VolumeSpec(volume=vol(k, "v", driver="EmptyDir"))
    ).name == "kubernetes.io/empty-dir"
    assert pm.find_plugin_by_spec(
        k.VolumeSpec(volume=vol(k, "v", k.VolumeKind.GCE_PD, "disk-1"))
    ).name == "kubernetes.io/gce-pd"
    assert pm.find_plugin_by_spec(
        k.VolumeSpec(volume=vol(k, "v", k.VolumeKind.CONFIG_MAP, "cm"))
    ).name == "kubernetes.io/configmap"
    # a driver hint nothing claims
    with pytest.raises(k.VolumeError):
        pm.find_plugin_by_spec(
            k.VolumeSpec(volume=vol(k, "v", driver="FlockerISH")))


def test_duplicate_registration_rejected(k):
    plugins = k.default_plugins()
    with pytest.raises(k.VolumeError):
        k.VolumePluginManager(plugins + [plugins[0].__class__()])


def test_emptydir_isolated_per_pod(k):
    api, host, mgr = rig(k)
    p1 = k.make_pod("p1", cpu=10, memory=Mi)
    p1.volumes = [vol(k, "scratch", driver="EmptyDir")]
    p2 = k.make_pod("p2", cpu=10, memory=Mi)
    p2.volumes = [vol(k, "scratch", driver="EmptyDir")]
    for p in (p1, p2):
        mgr.add_pod(p)
    mgr.reconcile()
    host.pod_dir(p1.key())["scratch"]["f"] = b"one"
    assert "f" not in host.pod_dir(p2.key())["scratch"]


def test_hostpath_shared_on_node(k):
    api, host, mgr = rig(k)
    p1 = k.make_pod("p1", cpu=10, memory=Mi)
    p1.volumes = [vol(k, "logs", driver="HostPath", vid="/var/log")]
    p2 = k.make_pod("p2", cpu=10, memory=Mi)
    p2.volumes = [vol(k, "logs", driver="HostPath", vid="/var/log")]
    mgr.add_pod(p1)
    mgr.add_pod(p2)
    mgr.reconcile()
    host.pod_dir(p1.key())["logs"]["a.log"] = b"x"
    assert host.pod_dir(p2.key())["logs"]["a.log"] == b"x"


def test_configmap_and_secret_materialize_payload(k):
    api, host, mgr = rig(k)
    api.create("ConfigMap", k.ConfigMap("settings", "default",
                                      data={"mode": "fast"}))
    api.create("Secret", k.Secret("creds", "default", data={
        "token": base64.b64encode(b"s3cret").decode()}))
    p = k.make_pod("p", cpu=10, memory=Mi)
    p.volumes = [vol(k, "cfg", k.VolumeKind.CONFIG_MAP, "settings"),
                 vol(k, "sec", k.VolumeKind.SECRET, "creds")]
    mgr.add_pod(p)
    mgr.reconcile()
    assert host.pod_dir(p.key())["cfg"]["mode"] == b"fast"
    # secret files land base64-DECODED (pkg/volume/secret/secret.go)
    assert host.pod_dir(p.key())["sec"]["token"] == b"s3cret"


def test_missing_configmap_is_mount_error_not_crash(k):
    api, host, mgr = rig(k)
    p = k.make_pod("p", cpu=10, memory=Mi)
    p.volumes = [vol(k, "cfg", k.VolumeKind.CONFIG_MAP, "nope")]
    mgr.add_pod(p)
    mounted, _ = mgr.reconcile()
    assert mounted == 0
    with pytest.raises(k.VolumeError, match="not found"):
        mgr.wait_for_attach_and_mount(p, timeout=0.05)


def test_downward_api_renders_pod_fields(k):
    api, host, mgr = rig(k)
    p = k.make_pod("p", cpu=10, memory=Mi, labels={"app": "web"})
    p.node_name = "n1"
    p.volumes = [vol(k, "info", driver="DownwardAPI")]
    mgr.add_pod(p)
    mgr.reconcile()
    d = host.pod_dir(p.key())["info"]
    assert d["metadata.name"] == b"p"
    assert b'app="web"' in d["metadata.labels"]
    assert d["spec.nodeName"] == b"n1"


def test_projected_merges_sources(k):
    api, host, mgr = rig(k)
    api.create("ConfigMap", k.ConfigMap("cm", "default", data={"k1": "v1"}))
    api.create("Secret", k.Secret("s", "default", data={
        "k2": base64.b64encode(b"v2").decode()}))
    p = k.make_pod("p", cpu=10, memory=Mi)
    p.volumes = [vol(k, "all", driver="Projected",
                     vid="configmap:cm,secret:s,downwardAPI")]
    mgr.add_pod(p)
    mgr.reconcile()
    d = host.pod_dir(p.key())["all"]
    assert d["k1"] == b"v1" and d["k2"] == b"v2"
    assert d["metadata.name"] == b"p"


def test_nfs_shared_across_nodes(k):
    api1, host1, mgr1 = rig(k, "n1")
    host2 = k.VolumeHost(api=api1, node_name="n2")
    # same shared backend universe (the "network")
    host2.shared_fs = host1.shared_fs
    mgr2 = k.VolumeManager(k.VolumePluginManager(k.default_plugins()), host2)
    p1 = k.make_pod("p1", cpu=10, memory=Mi)
    p1.volumes = [vol(k, "data", driver="NFS", vid="fs1:/export")]
    p2 = k.make_pod("p2", cpu=10, memory=Mi)
    p2.volumes = [vol(k, "data", driver="NFS", vid="fs1:/export")]
    mgr1.add_pod(p1)
    mgr2.add_pod(p2)
    mgr1.reconcile()
    mgr2.reconcile()
    host1.pod_dir(p1.key())["data"]["shared.txt"] = b"hello"
    assert host2.pod_dir(p2.key())["data"]["shared.txt"] == b"hello"


def test_pvc_resolution_and_local_node_pinning(k):
    api, host, mgr = rig(k, "n1")
    term = k.NodeSelectorTerm(match_expressions=[
        k.SelectorRequirement("kubernetes.io/hostname", "In", ["n2"])])
    api.create("PersistentVolume", k.PersistentVolume(
        "pv-local", capacity=Mi,
        source=k.Volume(name="pv-local", driver="Local", volume_id="/mnt/d1"),
        node_affinity_terms=[term]))
    api.create("PersistentVolumeClaim", k.PersistentVolumeClaim(
        "claim", "default", volume_name="pv-local", capacity=Mi))
    p = k.make_pod("p", cpu=10, memory=Mi)
    p.volumes = [vol(k, "data", k.VolumeKind.PVC, "claim")]
    mgr.add_pod(p)
    mounted, _ = mgr.reconcile()
    # n1 does not satisfy the PV's node affinity -> mount must fail
    assert mounted == 0
    with pytest.raises(k.VolumeError, match="affinity conflict"):
        mgr.wait_for_attach_and_mount(p, timeout=0.05)
    # the right node mounts fine
    node2 = k.make_node("n2", cpu=4000, memory=1 << 33)
    node2.labels["kubernetes.io/hostname"] = "n2"
    api.create("Node", node2)
    host2 = k.VolumeHost(api=api, node_name="n2")
    mgr2 = k.VolumeManager(k.VolumePluginManager(k.default_plugins()), host2)
    mgr2.wait_for_attach_and_mount(p, timeout=0.5)
    assert "data" in host2.pod_dir(p.key())


def test_unbound_pvc_is_visible_error(k):
    api, host, mgr = rig(k)
    api.create("PersistentVolumeClaim", k.PersistentVolumeClaim(
        "loose", "default", capacity=Mi))
    p = k.make_pod("p", cpu=10, memory=Mi)
    p.volumes = [vol(k, "data", k.VolumeKind.PVC, "loose")]
    with pytest.raises(k.VolumeError, match="not bound"):
        mgr.add_pod(p)


def test_attachable_mount_waits_for_controller_attach(k):
    api, host, mgr = rig(k)
    p = k.make_pod("p", cpu=10, memory=Mi)
    p.volumes = [vol(k, "disk", k.VolumeKind.GCE_PD, "pd-1")]
    mgr.add_pod(p)
    mounted, _ = mgr.reconcile()
    assert mounted == 0  # not attached yet
    # the attach-detach controller attaches (records on the node)
    node = api.get("Node", "", "n1")
    node.annotations[k.ATTACHED_ANNOTATION] = "GCEPersistentDisk:pd-1"
    api.update("Node", node)
    mounted, _ = mgr.reconcile()
    assert mounted == 1
    # device content is shared through the backend: remount elsewhere
    host.pod_dir(p.key())["disk"]["state"] = b"v1"
    assert host.shared_fs["GCEPersistentDisk:pd-1"]["state"] == b"v1"
    assert mgr.volumes_in_use() == ["GCEPersistentDisk:pd-1"]


def test_in_use_protection_blocks_detach(k):

    api, host, mgr = rig(k)
    factory = k.SharedInformerFactory(api)
    ctrl = k.AttachDetachController(api, factory, record_events=False)
    factory.start()
    p = k.make_pod("p", cpu=10, memory=Mi)
    p.volumes = [vol(k, "disk", k.VolumeKind.GCE_PD, "pd-1")]
    p.node_name = "n1"
    api.create("Pod", p)
    factory.step_all()
    ctrl.sync("n1")
    assert "GCEPersistentDisk:pd-1" in api.get(
        "Node", "", "n1").annotations[k.ATTACHED_ANNOTATION]
    mgr.add_pod(p)
    mgr.reconcile()
    # pod object deleted but kubelet hasn't unmounted yet: in-use guard
    api.delete("Pod", "default", "p")
    node = api.get("Node", "", "n1")
    node.annotations[k.IN_USE_ANNOTATION] = ",".join(mgr.volumes_in_use())
    api.update("Node", node)
    factory.step_all()
    ctrl.sync("n1")
    assert "GCEPersistentDisk:pd-1" in api.get(
        "Node", "", "n1").annotations[k.ATTACHED_ANNOTATION]
    # kubelet unmounts -> in-use clears -> controller detaches
    mgr.teardown_pod(p.key())
    node = api.get("Node", "", "n1")
    node.annotations.pop(k.IN_USE_ANNOTATION)
    api.update("Node", node)
    ctrl.sync("n1")
    assert api.get("Node", "", "n1").annotations.get(
        k.ATTACHED_ANNOTATION, "") == ""


def test_reconciler_unmounts_orphans_and_cleans_pod_dir(k):
    api, host, mgr = rig(k)
    p = k.make_pod("p", cpu=10, memory=Mi)
    p.volumes = [vol(k, "a", driver="EmptyDir"), vol(k, "b", driver="EmptyDir")]
    mgr.add_pod(p)
    mgr.reconcile()
    assert mgr.mounted_volumes(p.key()) == {"a", "b"}
    n = mgr.teardown_pod(p.key())
    assert n == 2
    assert p.key() not in host.fs


def test_kubelet_syncpod_gates_on_mount(k):
    api, host, mgr = rig(k)
    node = api.get("Node", "", "n1")
    kubelet = k.HollowKubelet(api, node, volume_manager=mgr)
    p = k.make_pod("web", cpu=10, memory=Mi)
    p.node_name = "n1"
    p.volumes = [vol(k, "cfg", k.VolumeKind.CONFIG_MAP, "missing-cm")]
    api.create("Pod", p)
    kubelet.handle_pod(p)
    kubelet.workers.drain()
    # mount failed -> pod NOT admitted, FailedMount recorded
    assert p.key() not in kubelet._admitted
    assert api.get("Pod", "default", "web").annotations[
        "kubernetes.io/failure-reason"] == "FailedMount"
    # operator creates the configmap; next sync succeeds
    api.create("ConfigMap", k.ConfigMap("missing-cm", "default",
                                        data={"k": "v"}))
    kubelet.handle_pod(p)
    kubelet.workers.drain()
    assert p.key() in kubelet._admitted
    assert host.pod_dir(p.key())["cfg"]["k"] == b"v"
