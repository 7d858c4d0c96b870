"""Generated-protobuf loader: imports ktpb_pb2, generating it with protoc
on demand (mirroring the native-lib build-on-demand pattern). Returns None
when neither a generated module nor protoc is available — callers fall
back to the JSON path."""

from __future__ import annotations

import os
import subprocess
import threading
from kubernetes_tpu_torch.analysis import lockcheck

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_HERE))
_PROTO_DIR = os.path.join(os.path.dirname(_ROOT), "proto")
_GEN = os.path.join(_HERE, "ktpb_pb2.py")

_lock = lockcheck.make_lock("api.pb._lock")
_mod = None
_tried = False


def load():
    """The ktpb_pb2 module, or None."""
    global _mod, _tried
    if _mod is not None or _tried:
        return _mod
    with _lock:
        if _mod is not None or _tried:
            return _mod
        _tried = True
        if not os.path.exists(_GEN):
            src = os.path.join(_PROTO_DIR, "ktpb.proto")
            if os.path.exists(src):
                try:
                    subprocess.run(
                        ["protoc", f"--proto_path={_PROTO_DIR}",
                         f"--python_out={_HERE}", "ktpb.proto"],
                        check=True, capture_output=True, timeout=120)
                except Exception:
                    return None
        if os.path.exists(_GEN):
            try:
                from kubernetes_tpu_torch.api.pb import ktpb_pb2  # noqa: F401
                _mod = ktpb_pb2
            except Exception:
                _mod = None
    return _mod
