"""Store replication: WAL shipping + standby promotion.

The reference's store survives node loss because etcd replicates its WAL
through raft before acknowledging writes (etcd behind
staging/src/k8s.io/apiserver/pkg/storage/etcd3/store.go:85; disaster
recovery discipline in cluster/restore-from-backup.sh). This module gives
the durable store (server/durable.py) the availability half of that story
without writing raft: an ASYNCHRONOUS log-shipping follower —

- the primary keeps writing its own snapshot.db + wal.log untouched;
- a WalShippingStandby periodically pulls: the snapshot when it changed,
  then any new WAL bytes since its last offset (detecting primary
  compaction by the WAL shrinking below the shipped offset);
- on primary death, promote() restores an ApiServerLite from the standby
  directory and serves.

Honest semantics, stated plainly: shipping is async, so writes committed
on the primary AFTER the last ship() are lost at failover (raft would not
lose them; this is warm-standby / etcd-backup semantics, the
restore-from-backup.sh path automated). What IS guaranteed: the standby
restores to a consistent prefix of the primary's history — torn shipped
tails are dropped by the WAL's CRC framing, a half-shipped compaction
falls back to snapshot+reset, and every object present after promotion has
exactly the state some prefix of primary history gave it, so binds remain
exactly-once against the promoted truth.
"""

from __future__ import annotations

import os
import zlib
from typing import Optional, Tuple

from kubernetes_tpu_torch.server.durable import _HDR, DurableStore


def _complete_frame_prefix(data: bytes) -> int:
    """Length of the longest prefix of `data` consisting of whole,
    CRC-VALID WAL frames. Shipping must be frame-aligned (a half-record
    shipped and then dropped by the standby's torn-tail repair would
    desynchronize every later frame), and CRC-checked (bytes read at a
    stale offset after a primary compaction can be length-plausible
    garbage — the checksum is what proves they are frames)."""
    off = 0
    while off + _HDR.size <= len(data):
        ln, crc = _HDR.unpack_from(data, off)
        end = off + _HDR.size + ln
        if end > len(data):
            break
        if zlib.crc32(data[off + _HDR.size:end]) != crc:
            break
        off = end
    return off


class WalShippingStandby:
    """Pull-based follower over a primary's durable data dir."""

    def __init__(self, primary_dir: str, standby_dir: str):
        self.primary_dir = primary_dir
        self.standby_dir = standby_dir
        os.makedirs(standby_dir, exist_ok=True)
        self._p_snap = os.path.join(primary_dir, DurableStore.SNAPSHOT)
        self._p_wal = os.path.join(primary_dir, DurableStore.WAL)
        self._s_snap = os.path.join(standby_dir, DurableStore.SNAPSHOT)
        self._s_wal = os.path.join(standby_dir, DurableStore.WAL)
        self._wal_offset = 0  # bytes of primary WAL shipped so far
        self._snap_sig: Optional[Tuple[float, int]] = None  # (mtime, size)
        self.ships = 0  # diagnostics
        self.bytes_shipped = 0

    # ------------------------------------------------------------ shipping

    def _snapshot_signature(self) -> Optional[Tuple[float, int]]:
        try:
            st = os.stat(self._p_snap)
        except FileNotFoundError:
            return None
        return (st.st_mtime_ns, st.st_size)

    def _copy_snapshot(self) -> None:
        """Atomic copy (tmp + rename, like the primary's own compaction
        discipline) so a crash mid-ship never leaves a torn snapshot."""
        with open(self._p_snap, "rb") as src:
            data = src.read()
        tmp = self._s_snap + ".tmp"
        with open(tmp, "wb") as dst:
            dst.write(data)
            dst.flush()
            os.fsync(dst.fileno())
        os.replace(tmp, self._s_snap)

    def ship(self) -> int:
        """One shipping pass; returns bytes shipped. Handles the two
        primary-side events that invalidate simple byte-append:

        - new snapshot (compaction): re-copy it, restart the WAL from 0
          (the primary truncated its WAL at that instant)
        - WAL shrunk below our offset without a visible new snapshot
          (raced mid-compaction): same reset, next pass catches up

        A compaction can also land BETWEEN reading the snapshot signature
        and reading the WAL (the primary is another process): the
        signature is re-checked after the WAL read, and a changed one
        discards this pass's bytes and retries — appending them would
        stack post-compaction frames on the pre-compaction standby
        snapshot, silently skipping the records in between."""
        shipped = 0
        for _attempt in range(4):
            shipped = 0  # a retried attempt's copies don't count twice
            sig = self._snapshot_signature()
            try:
                wal_size = os.path.getsize(self._p_wal)
            except FileNotFoundError:
                wal_size = 0
            if sig != self._snap_sig or wal_size < self._wal_offset:
                if sig is not None:
                    self._copy_snapshot()
                    shipped += sig[1]
                self._snap_sig = sig
                self._wal_offset = 0
                # the primary's WAL restarted at its snapshot point; ours
                # must restart with it or we'd replay pre-snapshot records
                open(self._s_wal, "wb").close()
            data = b""
            if wal_size > self._wal_offset:
                with open(self._p_wal, "rb") as src:
                    src.seek(self._wal_offset)
                    data = src.read(wal_size - self._wal_offset)
            if self._snapshot_signature() != sig:
                continue  # compaction raced this pass; retry clean
            n = _complete_frame_prefix(data)
            if n:
                with open(self._s_wal, "ab") as dst:
                    dst.write(data[:n])
                    dst.flush()
                    os.fsync(dst.fileno())
                self._wal_offset += n
                shipped += n
            break
        self.ships += 1
        self.bytes_shipped += shipped
        return shipped

    # ----------------------------------------------------------- promotion

    def promote(self, **apiserver_kwargs):
        """Primary is dead: become the store. Restores snapshot+WAL from
        the standby dir (torn shipped tail repaired by the CRC scan) and
        returns a serving ApiServerLite. The returned server OWNS the
        standby dir from here on (its writes append there)."""
        from kubernetes_tpu_torch.server.apiserver_lite import ApiServerLite
        return ApiServerLite(data_dir=self.standby_dir, **apiserver_kwargs)

    def standby_rv(self) -> int:
        """Highest resourceVersion the standby would restore to (test +
        monitoring probe; the replication-lag gauge)."""
        store = DurableStore(self.standby_dir)
        _objects, rv = store.restore()
        store.close()
        return rv
