"""Node-local checkpoint store — the dockershim checkpoint analog.

Reference: pkg/kubelet/dockershim/checkpoint_store.go — the only
node-local durable state in the v1.7 tree. `CheckpointStore` is a
key→blob interface (`Write/Read/Delete/List`), `FileStore` the
filesystem implementation with atomic writes and key validation;
dockershim checkpoints pod-sandbox metadata through it so a restarted
kubelet can reconstruct sandbox state (port mappings, host-network
flag) before the runtime is queried
(pkg/kubelet/dockershim/docker_checkpoint.go PodSandboxCheckpoint).

Here the kubelet checkpoints its admitted-pod sandbox records
(restarts, static-pod specs ride their own file source) so a
restarted HollowKubelet resumes restart counters and running state
without replaying every status write — exercised by the chaos
harness's kubelet-kill path.
"""

from __future__ import annotations

import errno
import json
import os
import re
import tempfile
from typing import Any, Dict, List

_KEY_RE = re.compile(r"^[a-zA-Z0-9][a-zA-Z0-9._-]*$")


class CorruptCheckpointError(Exception):
    """Stored blob failed validation on read (checkpoint_store.go's
    data-validation on Read)."""


class CheckpointStore:
    """checkpoint_store.go CheckpointStore interface."""

    def write(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def read(self, key: str) -> bytes:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def list(self) -> List[str]:
        raise NotImplementedError


def validate_key(key: str) -> None:
    """checkpoint_store.go validateKey: keys must be regular filenames —
    no separators/traversal, non-empty."""
    if not key or len(key) > 250 or not _KEY_RE.match(key) \
            or key in (".", ".."):
        raise ValueError(f"checkpoint key is not valid: {key!r}")


class FileStore(CheckpointStore):
    """checkpoint_store.go FileStore: one file per key under a base dir,
    atomic tmp-file + rename writes (util/ioutils atomic write), missing
    key on delete is NOT an error (idempotent cleanup)."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, key: str) -> str:
        validate_key(key)
        return os.path.join(self.directory, key)

    def write(self, key: str, data: bytes) -> None:
        path = self._path(key)
        # truncated prefix: the tmp name must stay under the filesystem's
        # 255-byte filename limit even for maximum-length keys
        fd, tmp = tempfile.mkstemp(dir=self.directory,
                                   prefix=".tmp-" + key[:40] + "-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def read(self, key: str) -> bytes:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(key) from None

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except OSError as e:
            if e.errno != errno.ENOENT:
                raise

    def list(self) -> List[str]:
        return sorted(
            fn for fn in os.listdir(self.directory)
            if not fn.startswith(".tmp-"))


class MemStore(CheckpointStore):
    """The in-memory store used in dockershim tests
    (checkpoint_store.go MemStore)."""

    def __init__(self):
        self._data: Dict[str, bytes] = {}

    def write(self, key: str, data: bytes) -> None:
        validate_key(key)
        self._data[key] = bytes(data)

    def read(self, key: str) -> bytes:
        if key not in self._data:
            raise KeyError(key)
        return self._data[key]

    def delete(self, key: str) -> None:
        validate_key(key)
        self._data.pop(key, None)

    def list(self) -> List[str]:
        return sorted(self._data)


CHECKPOINT_VERSION = "v1"


class PodSandboxCheckpointer:
    """docker_checkpoint.go PodSandboxCheckpoint over a CheckpointStore:
    the kubelet-side record of a pod's sandbox (restart count + phase)
    with a version + checksum envelope, validated on read."""

    def __init__(self, store: CheckpointStore):
        self.store = store

    @staticmethod
    def _key(pod_key: str) -> str:
        # "default/web-1" -> "default_web-1" (keys must be plain
        # filenames). k8s ns+name can reach ~500 chars, past both
        # validate_key's 250 limit and the filesystem's 255 after the
        # atomic-write tmp prefix — long keys get a fixed-width digest
        # suffix so they stay unique AND mountable
        key = pod_key.replace("/", "_")
        if len(key) > 200:
            import hashlib
            key = key[:160] + "-" + hashlib.sha256(
                pod_key.encode()).hexdigest()[:32]
        return key

    def checkpoint(self, pod_key: str, record: Dict[str, Any]) -> None:
        body = {"version": CHECKPOINT_VERSION, "pod": pod_key,
                "record": record}
        payload = json.dumps(body, sort_keys=True)
        body["checksum"] = _checksum(payload)
        self.store.write(self._key(pod_key),
                         json.dumps(body, sort_keys=True).encode())

    def restore(self, pod_key: str) -> Dict[str, Any]:
        raw = self.store.read(self._key(pod_key))
        try:
            body = json.loads(raw)
            checksum = body.pop("checksum")
        except (ValueError, KeyError):
            raise CorruptCheckpointError(
                f"checkpoint for {pod_key!r} is not valid JSON") from None
        if _checksum(json.dumps(body, sort_keys=True)) != checksum \
                or body.get("version") != CHECKPOINT_VERSION:
            raise CorruptCheckpointError(
                f"checkpoint for {pod_key!r} failed checksum/version "
                f"validation")
        return body["record"]

    def remove(self, pod_key: str) -> None:
        self.store.delete(self._key(pod_key))

    def restore_all(self) -> Dict[str, Dict[str, Any]]:
        """One pass over the store: {pod_key: record} for every VALID
        checkpoint; invalid blobs — bad JSON, wrong shape, failed
        checksum — are deleted as found (dockershim removes checkpoints
        that fail validation rather than serving garbage forever)."""
        out: Dict[str, Dict[str, Any]] = {}
        for key in self.store.list():
            try:
                raw = self.store.read(key)
                body = json.loads(raw)
                checksum = body.pop("checksum")
                pod_key = body["pod"]
                if not isinstance(pod_key, str) \
                        or _checksum(json.dumps(body, sort_keys=True)) \
                        != checksum \
                        or body.get("version") != CHECKPOINT_VERSION:
                    raise CorruptCheckpointError(key)
                out[pod_key] = body["record"]
            except Exception:
                # any malformation (non-dict JSON, missing fields, type
                # surprises) means an unusable checkpoint: drop it and
                # start that pod fresh — never crash kubelet startup
                self.store.delete(key)
        return out

    def pod_keys(self) -> List[str]:
        return sorted(self.restore_all())


def _checksum(payload: str) -> int:
    import zlib
    return zlib.adler32(payload.encode())
