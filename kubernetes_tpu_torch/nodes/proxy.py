"""Hollow proxy: the kube-proxy analog — Services/Endpoints -> routing table.

Mirrors pkg/proxy/iptables/proxier.go's shape without the kernel: every sync
is a FULL table rebuild from watched state (syncProxyRules at proxier.go:966
rewrites the whole KUBE-SERVICES chain each pass — same idiom here, a dict
swap), and routing picks a backend per connection. The reference's iptables
probability-based load balancing becomes deterministic round-robin.

The table is identical on every node (kube-proxy programs the same rules
fleet-wide), so one HollowProxy instance serves the whole hollow cluster.
"""

from __future__ import annotations

import threading
from kubernetes_tpu_torch.analysis import lockcheck
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.client.informer import SharedInformerFactory

# route key: "<ns>/<service>:<port>" -> list of (ip, target_port, node_name)
Backend = Tuple[str, int, str]


class HollowProxy:
    def __init__(self, factory: SharedInformerFactory):
        self.svc_informer = factory.informer("Service")
        self.eps_informer = factory.informer("Endpoints")
        self._lock = lockcheck.make_lock("HollowProxy._lock")
        self._table: Dict[str, List[Backend]] = {}
        self._local_counts: Dict[str, Dict[str, int]] = {}
        self._rr: Dict[str, int] = {}
        self.sync_count = 0
        # any change triggers a full resync, proxier.go-style
        for inf in (self.svc_informer, self.eps_informer):
            inf.add_event_handler(
                on_add=lambda o: self.sync_rules(),
                on_update=lambda old, new: self.sync_rules(),
                on_delete=lambda o: self.sync_rules())

    def sync_rules(self) -> None:
        """Full-table rewrite from current Services x Endpoints."""
        eps_by_key = {e.key(): e for e in self.eps_informer.store.list()}
        table: Dict[str, List[Backend]] = {}
        local_counts: Dict[str, Dict[str, int]] = {}
        for svc in self.svc_informer.store.list():
            eps = eps_by_key.get(svc.key())
            backends_src = eps.addresses if eps else []
            # per-service per-node endpoint counts for the healthcheck
            # server (same for every port: one index, not a table scan)
            counts: Dict[str, int] = {}
            for a in backends_src:
                counts[a.node_name] = counts.get(a.node_name, 0) + 1
            local_counts[svc.key()] = counts
            for port in svc.ports or []:
                route_key = f"{svc.key()}:{port.port}"
                table[route_key] = [
                    (a.ip, port.target_port or port.port, a.node_name)
                    for a in backends_src]
        with self._lock:
            self._table = table
            self._local_counts = local_counts
            self.sync_count += 1

    def route(self, service_key: str, port: int) -> Optional[Backend]:
        """One connection: round-robin over ready backends (the userspace
        proxy's LoadBalancerRR, pkg/proxy/userspace/roundrobin.go)."""
        key = f"{service_key}:{port}"
        with self._lock:
            backends = self._table.get(key)
            if not backends:
                return None
            i = self._rr.get(key, 0) % len(backends)
            self._rr[key] = i + 1
            return backends[i]

    def backends(self, service_key: str, port: int) -> List[Backend]:
        with self._lock:
            return list(self._table.get(f"{service_key}:{port}", ()))

    def local_endpoint_count(self, service_key: str, node_name: str) -> int:
        """Backends of a service living on `node_name` — the quantity the
        healthcheck server reports (healthcheck.go hcPayload). O(1) from
        the per-service index sync_rules maintains."""
        with self._lock:
            return self._local_counts.get(service_key, {}).get(node_name, 0)


class ProxyHealthServer:
    """The proxy healthcheck server (pkg/proxy/healthcheck/healthcheck.go):
    external load balancers probe it to learn whether THIS node has local
    endpoints for a service (externalTrafficPolicy=Local). 200 + the local
    endpoint count when some exist, 503 when none — the LB then skips the
    node. One server per node; paths are /healthz/<ns>/<name> (the
    reference allocates one healthCheckNodePort per service; a path per
    service keeps the sim to one listener)."""

    def __init__(self, proxy: HollowProxy, node_name: str,
                 host: str = "127.0.0.1", port: int = 0):
        import json
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        outer = self
        self.proxy = proxy
        self.node_name = node_name

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                parts = self.path.strip("/").split("/")
                if len(parts) != 3 or parts[0] != "healthz":
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                service_key = parts[1] + "/" + parts[2]
                n = outer.proxy.local_endpoint_count(service_key,
                                                     outer.node_name)
                body = json.dumps({"service": service_key,
                                   "localEndpoints": n}).encode()
                self.send_response(200 if n > 0 else 503)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
