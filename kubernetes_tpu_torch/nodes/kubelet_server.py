"""The kubelet API server — pkg/kubelet/server/server.go.

The reference kubelet serves its own HTTP API next to the apiserver:
/healthz, /pods (the admitted pod set, used by the node problem
detector and debugging), /stats (cadvisor summaries),
/containerLogs/<ns>/<pod>/<container> (what `kubectl logs` proxies to),
and the streaming exec/attach/portForward endpoints
(server.go InstallDefaultHandlers + InstallDebuggingHandlers).

The hollow runtime has no real containers, so logs and exec are served
from the same annotation-scripted substrate the probes use:

  bench/log-lines=<text>   newline-separated synthetic log content
  bench/exec-<cmd>=<out>   canned output for `exec <cmd>`

which preserves the wire shape (URL layout, 404-vs-200 semantics,
follow=false reads) without inventing a container runtime — the same
trade kubemark makes with its fake docker client.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

LOG_LINES_ANNOTATION = "bench/log-lines"
EXEC_PREFIX_ANNOTATION = "bench/exec-"


class KubeletApiError(Exception):
    """HTTP-shaped kubelet API failure (code + message), raised by the
    HollowKubelet serve_* methods and mapped to a status by whichever
    transport carries it (HTTP here, SystemExit in ktctl)."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class KubeletServer:
    """HTTP facade over one HollowKubelet (server.go Server)."""

    def __init__(self, kubelet, host: str = "127.0.0.1", port: int = 0):
        self.kubelet = kubelet
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send(self, code: int, payload, ctype="application/json"):
                body = payload if isinstance(payload, bytes) else \
                    json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                parts = [p for p in url.path.split("/") if p]
                k = outer.kubelet
                if url.path == "/healthz":
                    return self._send(200, b"ok", "text/plain")
                if url.path == "/pods":
                    return self._send(200, {"items": k.serve_pods()})
                if url.path == "/stats/summary":
                    return self._send(200, k.serve_stats())
                if parts[:1] == ["portForward"] and len(parts) >= 3:
                    # /portForward/<ns>/<pod>?port=N — one stream round
                    q = parse_qs(url.query)
                    try:
                        port = int(q.get("port", ["0"])[0])
                        data = k.serve_port(parts[1], parts[2], port)
                    except KubeletApiError as e:
                        return self._send(e.code, {"message": str(e)})
                    except ValueError:
                        return self._send(400, {"message": "bad port"})
                    return self._send(200, data,
                                      "application/octet-stream")
                if parts[:1] == ["containerLogs"] and len(parts) >= 3:
                    # /containerLogs/<ns>/<pod>[/<container>]
                    q = parse_qs(url.query)
                    try:
                        text = k.serve_logs(
                            parts[1], parts[2],
                            tail=q.get("tailLines", [None])[0])
                    except KubeletApiError as e:
                        return self._send(e.code, {"message": str(e)})
                    return self._send(200, text.encode(), "text/plain")
                return self._send(404, {"message": self.path})

            def do_POST(self):
                url = urlparse(self.path)
                parts = [p for p in url.path.split("/") if p]
                k = outer.kubelet
                if parts[:1] == ["attach"] and len(parts) >= 3:
                    # /attach/<ns>/<pod> — the running container's stream
                    try:
                        out = k.serve_attach(parts[1], parts[2])
                    except KubeletApiError as e:
                        return self._send(e.code, {"message": str(e)})
                    return self._send(200, out.encode(), "text/plain")
                if parts[:1] == ["exec"] and len(parts) >= 3:
                    # /exec/<ns>/<pod>?command=<cmd> (the non-streaming
                    # half of the exec contract; SPDY upgrade elided)
                    cmd = parse_qs(url.query).get("command", [""])[0]
                    try:
                        out = k.serve_exec(parts[1], parts[2], cmd)
                    except KubeletApiError as e:
                        return self._send(e.code, {"message": str(e)})
                    return self._send(200, out.encode(), "text/plain")
                return self._send(404, {"message": self.path})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
