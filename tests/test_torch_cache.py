"""The reference's scheduler-cache state machine (tests/test_cache.py,
modeled on cache_test.go: assume, confirm, forget, expire, the
generation counters) on both packages. Each body runs through the `k`
fixture."""

from __future__ import annotations

import pytest

from tests.torch_packages import PORT, REF, Pkg, helpers

MODULES = {
    "api_types": "api.types",
    "state_cache": "state.cache",
}
HELPER_NAMES = ('Gi',)


def _pkg(root):
    h = helpers(root)
    return Pkg(root, MODULES,
               extra={n: getattr(h, n) for n in HELPER_NAMES})


PKGS = {root: _pkg(root) for root in (REF, PORT)}


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def k(request):
    return PKGS[request.param]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def make_cache(k, ttl=30.0):
    clock = FakeClock()
    cache = k.SchedulerCache(ttl_seconds=ttl, now=clock)
    cache.add_node(k.make_node("n1"))
    cache.add_node(k.make_node("n2"))
    return cache, clock


def test_assume_adds_resources(k):
    cache, _ = make_cache(k)
    pod = k.make_pod("p1", cpu=1000, memory=1 * k.Gi)
    pod.node_name = "n1"
    cache.assume_pod(pod)
    infos = cache.node_infos()
    assert infos["n1"].requested.milli_cpu == 1000
    assert len(infos["n1"].pods) == 1
    assert cache.is_assumed("default/p1")


def test_expire_releases_assumed(k):
    cache, clock = make_cache(k, ttl=30.0)
    pod = k.make_pod("p1", cpu=1000)
    pod.node_name = "n1"
    cache.assume_pod(pod)
    cache.finish_binding(pod)
    clock.t = 31.0
    expired = cache.cleanup_assumed()
    assert expired == ["default/p1"]
    assert cache.node_infos()["n1"].requested.milli_cpu == 0


def test_unfinished_binding_never_expires(k):
    cache, clock = make_cache(k, ttl=30.0)
    pod = k.make_pod("p1", cpu=1000)
    pod.node_name = "n1"
    cache.assume_pod(pod)  # no finish_binding
    clock.t = 1e9
    assert cache.cleanup_assumed() == []
    assert cache.node_infos()["n1"].requested.milli_cpu == 1000


def test_add_confirms_assumed(k):
    cache, clock = make_cache(k, ttl=30.0)
    pod = k.make_pod("p1", cpu=1000)
    pod.node_name = "n1"
    cache.assume_pod(pod)
    cache.finish_binding(pod)
    cache.add_pod(pod)  # informer confirmation
    assert not cache.is_assumed("default/p1")
    clock.t = 1e9
    assert cache.cleanup_assumed() == []  # confirmed pods never expire
    assert cache.node_infos()["n1"].requested.milli_cpu == 1000


def test_add_moves_pod_when_bound_elsewhere(k):
    cache, _ = make_cache(k)
    pod = k.make_pod("p1", cpu=1000)
    pod.node_name = "n1"
    cache.assume_pod(pod)
    confirmed = k.make_pod("p1", cpu=1000)
    confirmed.node_name = "n2"  # another scheduler won
    cache.add_pod(confirmed)
    assert cache.node_infos()["n1"].requested.milli_cpu == 0
    assert cache.node_infos()["n2"].requested.milli_cpu == 1000


def test_forget_undoes_assume(k):
    cache, _ = make_cache(k)
    pod = k.make_pod("p1", cpu=1000)
    pod.node_name = "n1"
    cache.assume_pod(pod)
    cache.forget_pod(pod)
    assert cache.node_infos()["n1"].requested.milli_cpu == 0
    assert cache.pod_count() == 0


def test_remove_pod(k):
    cache, _ = make_cache(k)
    pod = k.make_pod("p1", cpu=500)
    pod.node_name = "n1"
    cache.add_pod(pod)
    cache.remove_pod(pod)
    assert cache.node_infos()["n1"].requested.milli_cpu == 0


def test_update_pod_moves_resources(k):
    cache, _ = make_cache(k)
    p_old = k.make_pod("p1", cpu=500)
    p_old.node_name = "n1"
    cache.add_pod(p_old)
    p_new = k.make_pod("p1", cpu=800)
    p_new.node_name = "n1"
    cache.update_pod(p_old, p_new)
    assert cache.node_infos()["n1"].requested.milli_cpu == 800


def test_generation_counters_drive_deltas(k):
    cache, _ = make_cache(k)
    g0 = cache.node_infos()["n1"].generation
    pod = k.make_pod("p1", cpu=100)
    pod.node_name = "n1"
    cache.add_pod(pod)
    infos = cache.node_infos()
    assert infos["n1"].generation > g0
    # untouched node unchanged
    assert infos["n2"].generation == cache.node_infos()["n2"].generation
