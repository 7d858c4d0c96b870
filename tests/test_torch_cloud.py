"""The port's cloud provider layer (cloud/) and the volume attachers and
controllers that drive it, against the reference's. The bodies of
tests/test_cloud_providers.py run on both packages (the `k` fixture):
the disk surface (single-writer attach, per-node limits, refused
deletes), the provider flavours, the GCE PD attacher, the
attach/detach controller on a cloud that refuses a multi-attach (and
its retry through the queue), and the PV binder's provisioning,
class matching and reclaim."""

from __future__ import annotations

import pytest

from tests.torch_packages import PORT, REF, Pkg

MODULES = {
    "api_cluster": "api.cluster",
    "api_types": "api.types",
    "api_workloads": "api.workloads",
    "client_informer": "client.informer",
    "cloud_provider": "cloud.provider",
    "controllers_cloudctrl": "controllers.cloudctrl",
    "server_apiserver": "server.apiserver",
    "server_apiserver_lite": "server.apiserver_lite",
    "volumes_drivers": "volumes.drivers",
    "volumes_plugins": "volumes.plugins",
}

PKGS = {REF: Pkg(REF, MODULES), PORT: Pkg(PORT, MODULES)}


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return PKGS[request.param]


def test_disk_lifecycle_and_multi_attach_guard(k):
    cloud = k.FakeCloud()
    cloud.create_disk("pd-1", size_gb=100)
    cloud.attach_disk("pd-1", "n1")
    cloud.attach_disk("pd-1", "n1")  # idempotent
    assert cloud.disks_attached("n1") == ["pd-1"]
    with pytest.raises(k.DiskError, match="already attached"):
        cloud.attach_disk("pd-1", "n2")
    with pytest.raises(k.DiskError, match="attached"):
        cloud.delete_disk("pd-1")
    # detach from the wrong node is a no-op; right node frees it
    cloud.detach_disk("pd-1", "n2")
    assert cloud.disks_attached("n1") == ["pd-1"]
    cloud.detach_disk("pd-1", "n1")
    assert cloud.disks_attached("n1") == []
    cloud.attach_disk("pd-1", "n2")  # now attachable elsewhere
    cloud.detach_disk("pd-1", "n2")
    cloud.delete_disk("pd-1")
    assert "pd-1" not in cloud.disks


def test_per_node_disk_limit(k):
    cloud = k.get_provider("azure-like")
    for i in range(cloud.max_disks_per_node):
        cloud.attach_disk(f"d{i}", "n1")
    with pytest.raises(k.DiskError, match="limit"):
        cloud.attach_disk("overflow", "n1")
    cloud.attach_disk("overflow", "n2")  # other nodes unaffected


def test_provider_flavors(k):
    os_cloud = k.get_provider("openstack-like")
    with pytest.raises(k.DiskError, match="does not exist"):
        os_cloud.attach_disk("vol-x", "n1")  # Cinder: create first
    os_cloud.create_disk("vol-x")
    os_cloud.attach_disk("vol-x", "n1")
    vs = k.get_provider("vsphere-like")
    assert not vs.has_load_balancer() and not vs.has_routes()
    assert vs.has_disks()
    az = k.get_provider("azure-like")
    st = az.ensure_load_balancer("default/svc", ["n1"])
    assert st.ingress_ip.startswith("20.0.0.")
    with pytest.raises(KeyError):
        k.get_provider("digitalocean-like")


def test_volume_attacher_drives_the_cloud(k):
    cloud = k.FakeCloud()
    host = k.VolumeHost(cloud=cloud, node_name="n1")
    plugin = k.GCEPDPlugin()
    spec = k.VolumeSpec(volume=k.Volume(name="data", kind=k.VolumeKind.GCE_PD,
                                    volume_id="pd-db"))
    dev = plugin.new_attacher(host).attach(spec, "n1")
    assert dev == "GCEPersistentDisk:pd-db"
    assert cloud.disks_attached("n1") == ["pd-db"]
    plugin.new_detacher(host).detach(dev, "n1")
    assert cloud.disks_attached("n1") == []


def test_attach_detach_controller_drives_cloud(k):
    """End to end: the controller's desired-state pass calls the cloud's
    AttachDisk/DetachDisk and refuses to record an attachment the cloud
    rejected (multi-attach guard surfaces as FailedAttachVolume)."""

    api = k.ApiServerLite()
    cloud = k.FakeCloud()
    for n in ("n1", "n2"):
        api.create("Node", k.make_node(n, cpu=1000, memory=1 << 31))
    factory = k.SharedInformerFactory(api)
    ctrl = k.AttachDetachController(api, factory, record_events=False,
                                  cloud=cloud)
    factory.start()
    p1 = k.make_pod("p1", cpu=10, memory=1 << 20)
    p1.node_name = "n1"
    p1.volumes = [k.Volume(name="v", kind=k.VolumeKind.GCE_PD,
                         volume_id="pd-shared")]
    api.create("Pod", p1)
    factory.step_all()
    ctrl.sync("n1")
    assert cloud.disks_attached("n1") == ["pd-shared"]
    assert "GCEPersistentDisk:pd-shared" in api.get(
        "Node", "", "n1").annotations[k.ATTACHED_ANNOTATION]
    # a second pod on ANOTHER node wants the same disk: the cloud refuses
    # the multi-attach and the controller must NOT record it
    p2 = k.make_pod("p2", cpu=10, memory=1 << 20)
    p2.node_name = "n2"
    p2.volumes = [k.Volume(name="v", kind=k.VolumeKind.GCE_PD,
                         volume_id="pd-shared")]
    api.create("Pod", p2)
    factory.step_all()
    # a direct sync raises to signal the rate-limited queue to RETRY the
    # refused attach (the queue absorbs this in the worker loop)
    with pytest.raises(RuntimeError, match="already attached"):
        ctrl.sync("n2")
    assert cloud.disks_attached("n2") == []
    assert k.ATTACHED_ANNOTATION not in api.get("Node", "", "n2").annotations
    # first pod leaves: detach happens on the cloud too
    api.delete("Pod", "default", "p1")
    factory.step_all()
    ctrl.sync("n1")
    assert cloud.disks_attached("n1") == []
    # and the second node can now attach on its next sync
    ctrl.sync("n2")
    assert cloud.disks_attached("n2") == ["pd-shared"]


def test_refused_attach_retries_through_the_queue(k):
    """Finding regression: a cloud-refused attach must be re-queued (the
    losing node gets the disk once the winner releases it, with no pod
    event ever landing on the loser)."""

    api = k.ApiServerLite()
    cloud = k.FakeCloud()
    for n in ("n1", "n2"):
        api.create("Node", k.make_node(n, cpu=1000, memory=1 << 31))
    factory = k.SharedInformerFactory(api)
    ctrl = k.AttachDetachController(api, factory, record_events=False,
                                  cloud=cloud)
    factory.start()
    for pname, node in (("p1", "n1"), ("p2", "n2")):
        p = k.make_pod(pname, cpu=10, memory=1 << 20)
        p.node_name = node
        p.volumes = [k.Volume(name="v", kind=k.VolumeKind.GCE_PD,
                            volume_id="pd-shared")]
        api.create("Pod", p)
    import time as _time

    factory.step_all()
    ctrl.pump()  # through the queue: n1 wins, n2 refused + requeued
    assert cloud.disks_attached("n1") == ["pd-shared"]
    # winner's pod goes away; its sync detaches
    api.delete("Pod", "default", "p1")
    factory.step_all()
    ctrl.pump()
    # the requeued n2 key eventually attaches WITHOUT any new n2 event
    # (rate-limited delay is 5ms-base exponential)
    deadline = _time.monotonic() + 5.0
    while _time.monotonic() < deadline:
        ctrl.pump()
        if cloud.disks_attached("n2") == ["pd-shared"]:
            break
        _time.sleep(0.02)
    assert cloud.disks_attached("n2") == ["pd-shared"]


def _pv_rig(k):

    api = k.ApiServerLite()
    api.create("StorageClass", k.StorageClass(
        "fast", provisioner="kubernetes.io/gce-pd", is_default=True))
    api.create("StorageClass", k.StorageClass(
        "manual", provisioner="kubernetes.io/no-provisioner",
        reclaim_policy="Retain"))
    factory = k.SharedInformerFactory(api)
    binder = k.PersistentVolumeBinder(api, factory, record_events=False)
    factory.start()
    return api, factory, binder


def test_dynamic_provisioning_and_reclaim(k):
    """pv_controller provisionClaim + reclaimVolume: a classed claim with
    no matching PV gets one minted by the class's provisioner, binds on
    the requeue, and the PV is deleted when the claim goes away."""

    api, factory, binder = _pv_rig(k)
    api.create("PersistentVolumeClaim", k.PersistentVolumeClaim(
        "data", "default", capacity=1 << 30,
        annotations={k.CLASS_ANNOTATION: "fast"}))
    factory.step_all()
    binder.pump()
    factory.step_all()
    binder.pump()  # the provisioned PV's ADDED event requeues the claim
    pvc = api.get("PersistentVolumeClaim", "default", "data")
    assert pvc.volume_name == "pvc-1eb304af-data"
    pv = api.get("PersistentVolume", "", "pvc-1eb304af-data")
    assert pv.capacity == 1 << 30
    assert pv.annotations[k.CLASS_ANNOTATION] == "fast"
    assert pv.source.kind.value == "GCEPersistentDisk"
    # claim deleted -> reclaim Delete removes the provisioned PV
    api.delete("PersistentVolumeClaim", "default", "data")
    factory.step_all()
    binder.pump()
    import pytest as _pytest

    with _pytest.raises(k.NotFound):
        api.get("PersistentVolume", "", "pvc-1eb304af-data")


def test_class_matching_and_no_provisioner(k):
    """A classed claim must not bind a classless PV; no-provisioner
    classes wait for a manually created same-class PV (and Retain keeps
    the PV on claim deletion)."""

    api, factory, binder = _pv_rig(k)
    # a classless PV big enough for the claim — must NOT be taken
    api.create("PersistentVolume", k.PersistentVolume(
        "classless", capacity=10 << 30, source=k.Volume(name="classless")))
    api.create("PersistentVolumeClaim", k.PersistentVolumeClaim(
        "data", "default", capacity=1 << 30,
        annotations={k.CLASS_ANNOTATION: "manual"}))
    factory.step_all()
    binder.pump()
    pvc = api.get("PersistentVolumeClaim", "default", "data")
    assert pvc.volume_name == ""  # no same-class PV, no provisioner
    # operator creates a manual-class PV: the claim binds it
    api.create("PersistentVolume", k.PersistentVolume(
        "manual-1", capacity=2 << 30, source=k.Volume(name="manual-1"),
        annotations={k.CLASS_ANNOTATION: "manual"}))
    factory.step_all()
    binder.pump()
    assert api.get("PersistentVolumeClaim", "default",
                   "data").volume_name == "manual-1"
    # Retain: claim deletion keeps the PV
    api.delete("PersistentVolumeClaim", "default", "data")
    factory.step_all()
    binder.pump()
    assert api.get("PersistentVolume", "", "manual-1").name == "manual-1"


def test_default_class_admission_annotates_pvc(k):
    """The StorageClassDefault plugin (now that PVCs carry annotations):
    a class-less claim created through the chain gets the default class
    and dynamic provisioning kicks in."""

    api = k.ApiServer()
    api.store.create("Namespace", k.Namespace("default"))
    api.store.create("StorageClass", k.StorageClass(
        "fast", provisioner="kubernetes.io/gce-pd", is_default=True))
    api.create("PersistentVolumeClaim", k.PersistentVolumeClaim(
        "data", "default", capacity=1 << 20))
    got = api.get("PersistentVolumeClaim", "default", "data")
    assert got.annotations[k.CLASS_ANNOTATION] == "fast"


def test_reclaim_spares_rebound_pv(k):
    """Finding regression: a PV rebound by another claim between the
    delete and the reclaim pass must NOT be deleted."""

    api, factory, binder = _pv_rig(k)
    api.create("PersistentVolumeClaim", k.PersistentVolumeClaim(
        "a", "default", capacity=1 << 20,
        annotations={k.CLASS_ANNOTATION: "fast"}))
    factory.step_all(); binder.pump()
    factory.step_all(); binder.pump()
    pv_name = api.get("PersistentVolumeClaim", "default", "a").volume_name
    assert pv_name
    # claim a deleted; claim b binds the same PV BEFORE the reclaim runs
    api.delete("PersistentVolumeClaim", "default", "a")
    api.create("PersistentVolumeClaim", k.PersistentVolumeClaim(
        "b", "default", capacity=1 << 20,
        annotations={k.CLASS_ANNOTATION: "fast"}))
    factory.step_all()
    binder.sync("default/b")          # b binds the freed PV
    assert api.get("PersistentVolumeClaim", "default",
                   "b").volume_name == pv_name
    binder.pump()                     # the queued reclaim:default/a runs
    assert api.get("PersistentVolume", "", pv_name).name == pv_name
