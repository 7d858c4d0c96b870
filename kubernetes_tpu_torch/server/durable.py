"""Durable persistence for apiserver-lite: write-ahead log + snapshots.

The reference's single durable truth is etcd: every write goes through a
raft-replicated WAL and periodic snapshots, and recovery is "replay the WAL
on top of the last snapshot" (reference: etcd behind
staging/src/k8s.io/apiserver/pkg/storage/etcd3/store.go:85 New / :257
GuaranteedUpdate; disaster path cluster/restore-from-backup.sh; the WAL
record framing itself is the forked etcd proto under third_party/).

This module gives ApiServerLite the same durability story, single-node:

- WriteAheadLog: append-only file of length+CRC32-framed records. A torn
  tail (crash mid-write) is detected by the CRC/length check and replay
  stops at the last complete record — the etcd WAL's torn-entry semantics.
- DurableStore: data-dir layout `snapshot.db` (full object map + rv,
  written atomically via tmp+rename) and `wal.log` (records since that
  snapshot). restore() = load snapshot, replay WAL.
- Records are ("put", key, obj, rv) / ("del", key, rv) — create, update,
  and the /binding subresource all reduce to `put`, exactly like etcd txns.
- fsync policy: "batch" (default) flushes OS buffers once per API call —
  surviving process crashes (kill -9) but not power loss; "always" fsyncs
  every flush; "off" leaves buffering to Python (fastest, test-only).

Resume semantics for watchers mirror etcd compaction: the in-memory event
log does not survive a restart, so a watcher resuming with a pre-crash
resourceVersion gets TooOldResourceVersion and must relist — which is the
reference's documented recovery path (level-triggered re-list; SURVEY §5.4).
"""

from __future__ import annotations

import os
import pickle
import struct
import zlib
from typing import Any, Dict, Iterator, Optional, Tuple

_HDR = struct.Struct("<II")  # payload length, crc32(payload)


class WriteAheadLog:
    """Append-only framed log; tolerant of a torn final record on replay."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "ab")

    def append(self, payload: bytes) -> None:
        self._f.write(_HDR.pack(len(payload), zlib.crc32(payload)) + payload)

    def flush(self, sync: bool = False) -> None:
        self._f.flush()
        if sync:
            os.fsync(self._f.fileno())

    def close(self) -> None:
        try:
            self._f.flush()
        finally:
            self._f.close()

    @staticmethod
    def replay(path: str) -> Iterator[bytes]:
        """Yield complete, checksum-valid records; stop at the first torn or
        corrupt frame (crash mid-append leaves at most one)."""
        for payload, _end in WriteAheadLog.scan(path):
            yield payload

    @staticmethod
    def scan(path: str) -> Iterator[Tuple[bytes, int]]:
        """(payload, end-offset-after-this-record) for each valid record —
        the end offset lets restore truncate a torn tail before appending
        (etcd WAL repair semantics: reopening in append mode after a torn
        record would bury every later write behind the tear)."""
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            pos = 0
            while True:
                hdr = f.read(_HDR.size)
                if len(hdr) < _HDR.size:
                    return
                length, crc = _HDR.unpack(hdr)
                payload = f.read(length)
                if len(payload) < length or zlib.crc32(payload) != crc:
                    return
                pos += _HDR.size + length
                yield payload, pos


class DurableStore:
    """snapshot.db + wal.log management for one ApiServerLite instance."""

    SNAPSHOT = "snapshot.db"
    WAL = "wal.log"

    def __init__(self, data_dir: str, fsync: str = "batch",
                 compact_every: int = 200_000):
        assert fsync in ("always", "batch", "off")
        self.data_dir = data_dir
        self.fsync = fsync
        self.compact_every = compact_every
        os.makedirs(data_dir, exist_ok=True)
        self._snap_path = os.path.join(data_dir, self.SNAPSHOT)
        self._wal_path = os.path.join(data_dir, self.WAL)
        self._wal: Optional[WriteAheadLog] = None
        self._records_since_snapshot = 0

    # ------------------------------------------------------------ recovery

    def restore(self) -> Tuple[Dict[Any, Any], int]:
        """(objects, rv) = last snapshot + WAL replay. Also counts replayed
        records toward the next compaction threshold."""
        objects: Dict[Any, Any] = {}
        rv = 0
        if os.path.exists(self._snap_path):
            with open(self._snap_path, "rb") as f:
                objects, rv = pickle.load(f)
        n = 0
        valid_end = 0
        for payload, end in WriteAheadLog.scan(self._wal_path):
            rec = pickle.loads(payload)
            op = rec[0]
            if op == "put":
                _, key, obj, rec_rv = rec
                objects[key] = obj
                rv = max(rv, rec_rv)
            elif op == "del":
                _, key, rec_rv = rec
                objects.pop(key, None)
                rv = max(rv, rec_rv)
            n += 1
            valid_end = end
        # repair a torn tail NOW: appending after it would bury every
        # subsequent flushed record behind an unreadable frame
        if os.path.exists(self._wal_path) \
                and os.path.getsize(self._wal_path) > valid_end:
            with open(self._wal_path, "r+b") as f:
                f.truncate(valid_end)
        self._records_since_snapshot = n
        return objects, rv

    # ------------------------------------------------------------- logging

    def _ensure_wal(self) -> WriteAheadLog:
        if self._wal is None:
            self._wal = WriteAheadLog(self._wal_path)
        return self._wal

    def put(self, key, obj, rv: int) -> None:
        self._ensure_wal().append(
            pickle.dumps(("put", key, obj, rv), pickle.HIGHEST_PROTOCOL))
        self._records_since_snapshot += 1

    def delete(self, key, rv: int) -> None:
        self._ensure_wal().append(
            pickle.dumps(("del", key, rv), pickle.HIGHEST_PROTOCOL))
        self._records_since_snapshot += 1

    def flush(self) -> None:
        """Once per API write call (batch boundary)."""
        if self._wal is None:
            return
        if self.fsync == "always":
            self._wal.flush(sync=True)
        elif self.fsync == "batch":
            self._wal.flush(sync=False)

    def should_compact(self) -> bool:
        return self._records_since_snapshot >= self.compact_every

    # ---------------------------------------------------------- compaction

    def compact(self, objects: Dict[Any, Any], rv: int) -> None:
        """Write a full snapshot atomically (tmp + fsync + rename — the
        restore-from-backup.sh discipline), then truncate the WAL."""
        tmp = self._snap_path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump((objects, rv), f, pickle.HIGHEST_PROTOCOL)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snap_path)
        # make the rename itself durable BEFORE truncating the WAL: a power
        # loss that kept the truncate but lost the directory entry would
        # otherwise recover old-snapshot + empty-WAL = silent data loss
        dir_fd = os.open(self.data_dir, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
        if self._wal is not None:
            self._wal.close()
            self._wal = None
        open(self._wal_path, "wb").close()  # truncate
        self._records_since_snapshot = 0

    def close(self) -> None:
        if self._wal is not None:
            self._wal.flush(sync=self.fsync != "off")
            self._wal.close()
            self._wal = None
