"""Probe executors — pkg/probe/{http,tcp,exec}.

The reference's probers return one of three results (pkg/probe/probe.go
Result: Success/Failure/Unknown) with a message:

- HTTP (pkg/probe/http/http.go): GET the URL; 2xx/3xx is Success, any
  other status Failure, transport errors Failure (the kubelet treats a
  refused connection as a failed probe, not an error), timeouts bounded.
- TCP (pkg/probe/tcp/tcp.go): a successful connect is Success.
- Exec (pkg/probe/exec/exec.go): exit 0 Success, non-zero Failure —
  here a callable returning (rc, output), since the hollow runtime has
  no containers to exec into.

These are the real network probers the framework's own HTTP surfaces
are checked with (kubelet API /healthz, proxy healthcheck, daemon
healthz) — the hollow kubelet's annotation-driven pod probes stay the
kubemark-style fake for scripted outcomes.
"""

from __future__ import annotations

import socket
import urllib.error
import urllib.request
from typing import Callable, Tuple

SUCCESS = "Success"
FAILURE = "Failure"
UNKNOWN = "Unknown"


def probe_http(url: str, timeout: float = 1.0) -> Tuple[str, str]:
    """http.go DoHTTPProbe: 2xx/3xx Success, other statuses Failure,
    transport errors Failure (a dead endpoint is a FAILED probe)."""
    try:
        req = urllib.request.Request(url, headers={
            "User-Agent": "kube-probe/1.7-tpu"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            code = resp.status
    except urllib.error.HTTPError as e:
        code = e.code
    except Exception as e:
        return FAILURE, f"Get {url}: {e}"
    if 200 <= code < 400:
        return SUCCESS, f"HTTP probe succeeded with code {code}"
    return FAILURE, f"HTTP probe failed with statuscode: {code}"


def probe_tcp(host: str, port: int, timeout: float = 1.0) -> Tuple[str, str]:
    """tcp.go DoTCPProbe: connect() decides."""
    try:
        with socket.create_connection((host, port), timeout=timeout):
            return SUCCESS, "TCP probe succeeded"
    except OSError as e:
        return FAILURE, f"dial tcp {host}:{port}: {e}"


def probe_exec(fn: Callable[[], Tuple[int, str]]) -> Tuple[str, str]:
    """exec.go Probe over a callable standing in for the container exec:
    rc 0 Success, non-zero Failure, an exception Unknown (the reference
    maps exec-infrastructure errors to Unknown, not Failure)."""
    try:
        rc, output = fn()
    except Exception as e:
        return UNKNOWN, str(e)
    return (SUCCESS if rc == 0 else FAILURE), output
