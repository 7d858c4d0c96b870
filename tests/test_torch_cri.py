"""The port's container runtime boundary and node checkpoints (nodes/cri.py,
kuberuntime.py, images.py, checkpoint.py) against the reference's. The
bodies of tests/test_cri.py and tests/test_checkpoint.py run on both
packages (the `k` fixture): the scripted FakeRuntimeService and the
ProcessRuntimeService (real pause processes, wall clock) behind the same
hollow kubelet, computePodActions, image pull policies and image GC, disk
pressure reclaiming images before pods, node-allocatable reservation,
and the checkpoint store (atomic FileStore, MemStore, checksummed
sandbox records, restart counters surviving a kubelet restart, orphan
GC). tests/test_checkpoint.py's bench_matrix case runs bench_matrix.py,
a file of the reference, and stays there."""

from __future__ import annotations

import os
import time

import pytest

from tests.torch_packages import PORT, REF, Pkg

MODULES = {
    "api_types": "api.types",
    "client_informer": "client.informer",
    "nodes_checkpoint": "nodes.checkpoint",
    "nodes_cri": "nodes.cri",
    "nodes_images": "nodes.images",
    "nodes_kubelet": "nodes.kubelet",
    "nodes_kuberuntime": "nodes.kuberuntime",
    "server_apiserver_lite": "server.apiserver_lite",
}

PKGS = {REF: Pkg(REF, MODULES), PORT: Pkg(PORT, MODULES)}


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return PKGS[request.param]


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


Mi = 1 << 20
Gi = 1 << 30


# ------------------------------------------------------- FakeRuntimeService


def test_fake_runtime_sandbox_and_container_lifecycle(k):
    clock = FakeClock()
    rt = k.FakeRuntimeService(boot_latency=2.0, now=clock)
    sid = rt.run_pod_sandbox(k.PodSandboxConfig(name="p", namespace="ns"))
    cid = rt.create_container(sid, k.ContainerConfig(name="c", image="img"))
    assert rt.container_status(cid).state == k.CREATED
    rt.start_container(cid)
    # boot latency: still CREATED until the clock advances
    assert rt.container_status(cid).state == k.CREATED
    clock.t += 2.0
    assert rt.container_status(cid).state == k.RUNNING
    rt.stop_container(cid)
    st = rt.container_status(cid)
    assert st.state == k.EXITED and st.exit_code == 137
    rt.stop_container(cid)  # idempotent
    assert rt.container_status(cid).exit_code == 137
    rt.stop_pod_sandbox(sid)
    assert rt.pod_sandbox_status(sid).state == k.SANDBOX_NOTREADY
    rt.remove_pod_sandbox(sid)
    assert rt.pod_sandbox_status(sid) is None
    assert rt.list_containers(sandbox_id=sid) == []


def test_fake_runtime_scripted_exit_and_attempts(k):
    clock = FakeClock()
    rt = k.FakeRuntimeService(now=clock)
    sid = rt.run_pod_sandbox(k.PodSandboxConfig(name="p"))
    cid = rt.create_container(
        sid, k.ContainerConfig(name="c", run_seconds=5.0, fail_exit=True))
    rt.start_container(cid)
    assert rt.container_status(cid).state == k.RUNNING
    clock.t += 5.0
    st = rt.container_status(cid)
    assert st.state == k.EXITED and st.exit_code == 1
    # same-named container again = attempt 1 (restart counting rides this)
    cid2 = rt.create_container(sid, k.ContainerConfig(name="c"))
    assert rt.container_status(cid2).attempt == 1


# ---------------------------------------------------------- RuntimeManager


def mk_manager(k, clock=None, boot_latency=0.0):
    clock = clock or FakeClock()
    rt = k.FakeRuntimeService(boot_latency=boot_latency, now=clock)
    mgr = k.RuntimeManager(rt, image_manager=k.ImageManager(rt), now=clock)
    return rt, mgr, clock


def test_compute_pod_actions_fresh_pod_creates_sandbox(k):
    _, mgr, _ = mk_manager(k)
    pod = k.make_pod("p", cpu=100)
    actions = mgr.compute_pod_actions(pod, mgr.pod_status(pod))
    assert actions.create_sandbox
    assert len(actions.containers_to_start) == 1
    # executing them converges: second sync is a no-op
    mgr.sync_pod(pod)
    again = mgr.compute_pod_actions(pod, mgr.pod_status(pod))
    assert not again.create_sandbox and not again.containers_to_start


def test_kubelet_killed_pod_with_restart_policy_never_reports_failed(k):
    """kuberuntime.py's pod_status: every latest attempt EXITED 137
    (kubelet-killed) and restartPolicy Never forbids a fresh attempt —
    pod_status must report a terminal Failed phase, or the pod sits in the
    kubelet's _starting set unready forever. Mirrors the reference's
    GetPhase: stopped containers that cannot restart fail the pod."""
    rt, mgr, clock = mk_manager(k)
    pod = k.make_pod("p", cpu=100)
    pod.restart_policy = "Never"
    mgr.sync_pod(pod)
    mgr.restart_pod_containers(pod)  # liveness path: CRI kill -> exit 137
    st = mgr.pod_status(pod)
    assert st.completed_phase == "Failed"
    # and compute_pod_actions still refuses a fresh attempt
    actions = mgr.compute_pod_actions(pod, st)
    assert not actions.containers_to_start and not actions.create_sandbox


def test_kubelet_killed_pod_with_restartable_policy_stays_pending(k):
    """Same 137 state under restartPolicy Always: NOT terminal — the next
    sync starts a fresh attempt instead."""
    rt, mgr, clock = mk_manager(k)
    pod = k.make_pod("p", cpu=100)
    mgr.sync_pod(pod)
    mgr.restart_pod_containers(pod)
    st = mgr.pod_status(pod)
    assert st.completed_phase == ""
    actions = mgr.compute_pod_actions(pod, st)
    assert actions.containers_to_start  # fresh attempt queued


def test_compute_pod_actions_restarts_killed_not_completed(k):
    rt, mgr, clock = mk_manager(k)
    pod = k.make_pod("p", cpu=100)
    pod.annotations["bench/run-seconds"] = "3"
    mgr.sync_pod(pod)
    clock.t += 3.0
    st = mgr.pod_status(pod)
    assert st.completed_phase == "Succeeded"
    # natural completion: no restart even with restartPolicy Always
    actions = mgr.compute_pod_actions(pod, st)
    assert not actions.containers_to_start
    # a KILLED container (exit 137) does restart under Always
    pod2 = k.make_pod("p2", cpu=100)
    mgr.sync_pod(pod2)
    mgr.restart_pod_containers(pod2)
    actions = mgr.compute_pod_actions(pod2, mgr.pod_status(pod2))
    assert len(actions.containers_to_start) == 1
    mgr.sync_pod(pod2)
    assert mgr.pod_status(pod2).restarts == 1


def test_kill_pod_removes_sandbox(k):
    rt, mgr, _ = mk_manager(k)
    pod = k.make_pod("p", cpu=100)
    mgr.sync_pod(pod)
    assert mgr.sandbox_ready(pod.key())
    mgr.kill_pod(pod.key())
    assert not mgr.sandbox_ready(pod.key())
    assert rt.list_pod_sandboxes() == []


# ----------------------------------------------- kubelet drives the CRI


def mk_fleet(k, n_nodes=1, clock=None, **kw):
    clock = clock or FakeClock()
    api = k.ApiServerLite()
    factory = k.SharedInformerFactory(api)
    fleet = k.HollowFleet(api, factory, now=clock, **kw)
    for i in range(n_nodes):
        fleet.add_node(k.make_node(f"n{i}", cpu=1000, memory=1 << 30, pods=8))
    factory.step_all()
    return api, factory, fleet, clock


def test_kubelet_lifecycle_flows_through_cri_ops(k):
    api, factory, fleet, clock = mk_fleet(k)
    kubelet = fleet.kubelets["n0"]
    rt = kubelet.runtime
    pod = k.make_pod("p", cpu=100, node_name="n0")
    pod.annotations["bench/run-seconds"] = "4"
    api.create("Pod", pod)
    factory.step_all()
    fleet.step()
    assert rt.ops.get("RunPodSandbox") == 1
    assert rt.ops.get("StartContainer") == 1
    assert rt.ops.get("PullImage") == 1
    assert api.get("Pod", "default", "p").phase == "Running"
    clock.t += 4.0
    fleet.step()
    assert api.get("Pod", "default", "p").phase == "Succeeded"
    # teardown reached the runtime once the final status round-tripped
    factory.step_all()
    fleet.step()
    assert rt.ops.get("RemovePodSandbox") == 1
    assert rt.list_pod_sandboxes() == []


def test_process_runtime_plugs_in_without_kubelet_changes(k):
    """The boundary's proof: a kubelet constructed with the REAL
    process-spawning runtime (sandbox = pause process) runs a pod to
    completion — no kubelet code knows which runtime is behind it."""
    api = k.ApiServerLite()
    factory = k.SharedInformerFactory(api)
    node = k.make_node("n0", cpu=1000, memory=1 << 30, pods=8)
    rt = k.ProcessRuntimeService()
    kubelet = k.HollowKubelet(api, node, runtime=rt)  # wall clock
    try:
        kubelet.register()
        pod = k.make_pod("p", cpu=100, node_name="n0")
        pod.annotations["bench/run-seconds"] = "0"
        api.create("Pod", pod)
        kubelet.handle_pod(pod)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            kubelet.step()
            if api.get("Pod", "default", "p").phase == "Succeeded":
                break
            time.sleep(0.05)
        assert api.get("Pod", "default", "p").phase == "Succeeded"
        # the sandbox really was a process (pause binary or sleep)
        assert rt.list_pod_sandboxes() != []
    finally:
        rt.close()


def test_process_runtime_failing_workload(k):
    rt = k.ProcessRuntimeService()
    try:
        mgr = k.RuntimeManager(rt)
        pod = k.make_pod("f", cpu=100)
        pod.annotations["bench/run-seconds"] = "0"
        pod.annotations["bench/fail"] = "1"
        mgr.sync_pod(pod)
        deadline = time.monotonic() + 10.0
        phase = ""
        while time.monotonic() < deadline:
            phase = mgr.pod_status(pod).completed_phase
            if phase:
                break
            time.sleep(0.05)
        assert phase == "Failed"
    finally:
        rt.close()


# ------------------------------------------------------------------ images


def test_image_pull_policies(k):
    rt = k.FakeRuntimeService()
    im = k.ImageManager(rt)
    pod = k.make_pod("p", cpu=100)
    im.ensure_image_exists(pod, "app:v1")  # IfNotPresent default: pulls
    im.ensure_image_exists(pod, "app:v1")  # present: no pull
    assert im.pulls == 1
    pod.annotations["bench/image-pull-policy"] = "Always"
    im.ensure_image_exists(pod, "app:v1")
    assert im.pulls == 2
    pod.annotations["bench/image-pull-policy"] = "Never"
    with pytest.raises(k.ImagePullError):
        im.ensure_image_exists(pod, "ghost:v1")


def test_image_gc_policy_validation(k):
    with pytest.raises(ValueError):
        k.ImageGCPolicy(high_threshold_percent=101)
    with pytest.raises(ValueError):
        k.ImageGCPolicy(low_threshold_percent=-1)
    with pytest.raises(ValueError):
        k.ImageGCPolicy(high_threshold_percent=50, low_threshold_percent=60)


def test_image_gc_lru_with_in_use_protection(k):
    clock = FakeClock()
    rt = k.FakeRuntimeService(now=clock)
    gc = k.ImageGCManager(rt, capacity_bytes=1000,
                          policy=k.ImageGCPolicy(85, 50))
    rt.pull_image("old:v1", size_bytes=400)
    clock.t += 10
    rt.pull_image("used:v1", size_bytes=300)
    clock.t += 10
    rt.pull_image("new:v1", size_bytes=200)
    # "used" is referenced by a container -> protected
    sid = rt.run_pod_sandbox(k.PodSandboxConfig(name="p"))
    rt.create_container(sid, k.ContainerConfig(name="c", image="used:v1"))
    # usage 900/1000 = 90% >= high 85 -> free down to 50% (500)
    freed = gc.garbage_collect()
    assert freed >= 400
    refs = {i.ref for i in rt.list_images()}
    assert "used:v1" in refs  # in-use protected
    assert "old:v1" not in refs  # LRU victim first
    assert rt.image_fs_info() <= 500
    # below threshold: next pass is a no-op
    assert gc.garbage_collect() == 0


def test_disk_pressure_reclaims_images_before_evicting_pods(k):
    """eviction_manager.go reclaimNodeLevelResources: image GC satisfies
    the disk signal, so no pod dies."""
    clock = FakeClock()
    api = k.ApiServerLite()
    factory = k.SharedInformerFactory(api)
    fleet = k.HollowFleet(api, factory, now=clock)
    node = k.make_node("n0", cpu=1000, memory=1 << 30, pods=8)
    node.allocatable.storage_scratch = 1 << 30  # a real image/scratch fs
    fleet.add_node(node)
    factory.step_all()
    kubelet = fleet.kubelets["n0"]
    rt = kubelet.runtime
    pod = k.make_pod("p", cpu=100, node_name="n0")
    api.create("Pod", pod)
    factory.step_all()
    fleet.step()
    assert api.get("Pod", "default", "p").phase == "Running"
    # stuff the image fs past the node's disk eviction limit with an
    # unused image; the pod itself uses almost nothing
    disk_cap = kubelet.eviction.disk_limit
    assert disk_cap > 0
    rt.pull_image("fat:v1", size_bytes=disk_cap + 1000)
    fleet.step()
    # image GC reclaimed; the pod survived and pressure cleared
    assert api.get("Pod", "default", "p").phase == "Running"
    assert not kubelet.eviction.disk_pressure
    assert "fat:v1" not in {i.ref for i in rt.list_images()}


def test_liveness_restart_rides_cri_attempts(k):
    """The kubelet's liveness restart is CRI kill + fresh attempt; the
    runtime's attempt counter matches the kubelet's restart count."""
    api, factory, fleet, clock = mk_fleet(k)
    kubelet = fleet.kubelets["n0"]
    pod = k.make_pod("p", cpu=100, node_name="n0")
    pod.containers[0].liveness_probe = k.Probe(period_s=1.0,
                                               failure_threshold=1)
    pod.annotations["bench/liveness-fail-at"] = "5"
    api.create("Pod", pod)
    factory.step_all()
    fleet.step()
    assert api.get("Pod", "default", "p").phase == "Running"
    clock.t += 6.0
    fleet.step()  # liveness fails -> kill
    fleet.step()  # fresh attempt running again
    assert api.get("Pod", "default", "p").restart_count == 1
    assert kubelet.runtime_mgr.pod_status(pod).restarts == 1


def test_node_allocatable_reservation(k):
    """--kube-reserved semantics (pkg/kubelet/cm/node_container_manager.go):
    the node registers allocatable = capacity - reserved; the scheduler
    and node-side admission see only the allocatable slice."""
    api = k.ApiServerLite()
    node = k.make_node("n0", cpu=4000, memory=8 << 30)
    kl = k.HollowKubelet(api, node,
                         reserved=k.Resource(milli_cpu=500, memory=1 << 30))
    kl.register()
    reg = api.get("Node", "", "n0")
    assert reg.allocatable.milli_cpu == 3500
    assert reg.allocatable.memory == 7 << 30
    assert reg.capacity.milli_cpu == 4000  # capacity still published
    # node-side admission enforces the RESERVED boundary, not capacity
    big = k.make_pod("big", cpu=3600, node_name="n0")
    api.create("Pod", big)
    kl.handle_pod(big)
    kl.step()
    p = api.get("Pod", "default", "big")
    assert p.phase == "Failed"
    assert p.annotations["kubernetes.io/failure-reason"] == "OutOfcpu"
    ok = k.make_pod("fits", cpu=3400, node_name="n0")
    api.create("Pod", ok)
    kl.handle_pod(ok)
    kl.step()
    assert api.get("Pod", "default", "fits").phase == "Running"


# ---------------------------------------------------------------- FileStore


def test_filestore_roundtrip_and_idempotent_delete(k, tmp_path):
    st = k.FileStore(str(tmp_path / "ckpt"))
    st.write("sandbox-a", b"one")
    st.write("sandbox-b", b"two")
    assert st.read("sandbox-a") == b"one"
    assert st.list() == ["sandbox-a", "sandbox-b"]
    st.write("sandbox-a", b"three")  # overwrite is atomic replace
    assert st.read("sandbox-a") == b"three"
    st.delete("sandbox-a")
    st.delete("sandbox-a")  # missing key is NOT an error
    with pytest.raises(KeyError):
        st.read("sandbox-a")
    assert st.list() == ["sandbox-b"]


def test_key_validation_blocks_traversal(k, tmp_path):
    st = k.FileStore(str(tmp_path / "ckpt"))
    for bad in ("", "..", "a/b", "../evil", "/abs", ".hidden" * 50):
        with pytest.raises(ValueError):
            k.validate_key(bad)
        with pytest.raises(ValueError):
            st.write(bad, b"x")


def test_checkpointer_checksum_rejects_corruption(k, tmp_path):
    st = k.FileStore(str(tmp_path / "ckpt"))
    ck = k.PodSandboxCheckpointer(st)
    ck.checkpoint("default/web", {"restarts": 3, "node": "n1"})
    assert ck.restore("default/web") == {"restarts": 3, "node": "n1"}
    assert ck.pod_keys() == ["default/web"]
    # flip bytes on disk: restore must refuse, not return garbage
    path = os.path.join(st.directory, "default_web")
    with open(path, "r+b") as f:
        data = f.read().replace(b'"restarts": 3', b'"restarts": 9')
        f.seek(0)
        f.write(data)
        f.truncate()
    with pytest.raises(k.CorruptCheckpointError):
        ck.restore("default/web")


def test_memstore_matches_filestore_contract(k):
    st = k.MemStore()
    st.write("k", b"v")
    assert st.read("k") == b"v"
    st.delete("k")
    st.delete("k")
    with pytest.raises(KeyError):
        st.read("k")


# ------------------------------------------------- kubelet restart recovery


def _live_pod(k, name):
    p = k.make_pod(name, cpu=50, memory=Mi)
    p.containers[0].liveness_probe = k.Probe(
        initial_delay_s=0, period_s=1, failure_threshold=1)
    p.annotations["bench/liveness-fail-at"] = "5"
    return p


def test_kubelet_restart_resumes_restart_counters(k, tmp_path):
    t = [1000.0]
    api = k.ApiServerLite()
    node = k.make_node("n1", cpu=4000, memory=8 * Gi)
    api.create("Node", node)
    ck = k.PodSandboxCheckpointer(k.FileStore(str(tmp_path / "ckpt")))
    kubelet = k.HollowKubelet(api, node, now=lambda: t[0], checkpointer=ck)
    pod = _live_pod(k, "web")
    pod.node_name = "n1"
    api.create("Pod", pod)
    kubelet.handle_pod(pod)
    kubelet.workers.drain()
    # run past the liveness-failure point a few times -> restarts accrue
    for _ in range(3):
        t[0] += 6.0
        kubelet.step()
    restarts = kubelet._restarts.get(pod.key(), 0)
    assert restarts >= 2
    # kubelet process dies; a NEW kubelet on the same node + checkpoint
    # dir resumes the counter instead of resetting to zero
    kubelet2 = k.HollowKubelet(api, node, now=lambda: t[0], checkpointer=ck)
    kubelet2.handle_pod(api.get("Pod", "default", "web"))
    kubelet2.workers.drain()
    assert kubelet2._restarts.get(pod.key()) == restarts
    # pod deletion cleans the checkpoint up
    kubelet2.forget_pod(pod)
    kubelet2.workers.drain()
    assert ck.pod_keys() == []


def test_corrupt_checkpoint_dropped_on_restart(k, tmp_path):
    api = k.ApiServerLite()
    node = k.make_node("n1", cpu=4000, memory=8 * Gi)
    api.create("Node", node)
    store = k.FileStore(str(tmp_path / "ckpt"))
    store.write("default_web", b"{not json")
    ck = k.PodSandboxCheckpointer(store)
    kubelet = k.HollowKubelet(api, node, checkpointer=ck)
    # the invalid checkpoint was removed, kubelet starts clean
    assert store.list() == []
    assert kubelet._restored == {}


def test_restore_all_survives_any_blob_shape(k, tmp_path):
    store = k.FileStore(str(tmp_path / "ckpt"))
    store.write("arr", b"[1, 2]")          # valid JSON, wrong shape
    store.write("num", b"42")              # valid JSON, wrong shape
    store.write("badpod", b'{"pod": 7, "version": "v1", "record": {}}')
    ck = k.PodSandboxCheckpointer(store)
    ck.checkpoint("default/ok", {"restarts": 1})
    assert ck.restore_all() == {"default/ok": {"restarts": 1}}
    # all malformed blobs pruned, the valid one kept
    assert store.list() == ["default_ok"]


def test_long_pod_keys_checkpoint_safely(k, tmp_path):
    ck = k.PodSandboxCheckpointer(k.FileStore(str(tmp_path / "ckpt")))
    long_key = ("n" * 250) + "/" + ("p" * 250)
    ck.checkpoint(long_key, {"restarts": 5})
    assert ck.restore(long_key) == {"restarts": 5}
    assert ck.restore_all() == {long_key: {"restarts": 5}}
    ck.remove(long_key)
    assert ck.pod_keys() == []


def test_orphaned_checkpoint_gc(k, tmp_path):
    """A checkpoint for a pod deleted while the kubelet was down is
    removed by the sync-loop sweep, not inherited by a future pod."""
    api = k.ApiServerLite()
    node = k.make_node("n1", cpu=4000, memory=8 * Gi)
    api.create("Node", node)
    ck = k.PodSandboxCheckpointer(k.FileStore(str(tmp_path / "ckpt")))
    ck.checkpoint("default/ghost", {"restarts": 7, "node": "n1"})
    kubelet = k.HollowKubelet(api, node, checkpointer=ck)
    assert "default/ghost" in kubelet._restored
    kubelet.step()
    assert kubelet._restored == {}
    assert ck.pod_keys() == []
