"""Remote bootstrap: stream a tablet snapshot to bring up a new replica.

Counterpart of yugabyte_tpu/tserver/remote_bootstrap.py, with the
imports renamed.

Capability parity with the reference (ref: src/yb/tserver/
remote_bootstrap_session.h:95 — the source serves a RocksDB checkpoint
(hard-linked SSTs) + WAL segments over chunked fetch RPCs;
remote_bootstrap_client.cc — the destination downloads everything, writes a
superblock + consensus metadata and opens the tablet, after which normal
Raft catch-up replays whatever the snapshot missed).

The source does NOT pause writes: WAL segments are hard-linked while the
appender keeps writing, so the fetched tail may be torn — the destination's
WAL replay stops at the first bad record (same crash-tolerance contract as
local bootstrap) and Raft streams the rest.
"""

from __future__ import annotations

import os
import shutil
import threading
import uuid
from typing import Dict, List, Tuple

from yugabyte_tpu_torch.utils.status import Status, StatusError
from yugabyte_tpu_torch.utils.trace import TRACE

FETCH_CHUNK = 1 << 20


def _link_or_copy(src: str, dst: str) -> None:
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)


def _snapshot_tree(src_root: str, dst_root: str) -> None:
    for dirpath, _dirnames, filenames in os.walk(src_root):
        rel = os.path.relpath(dirpath, src_root)
        out_dir = os.path.join(dst_root, rel) if rel != "." else dst_root
        os.makedirs(out_dir, exist_ok=True)
        for fn in filenames:
            if fn.endswith(".tmp"):
                continue
            _link_or_copy(os.path.join(dirpath, fn),
                          os.path.join(out_dir, fn))


class RemoteBootstrapSessions:
    """Source-side session registry (one per in-flight bootstrap)."""

    def __init__(self, fs_root: str):
        self._root = os.path.join(fs_root, "rb_sessions")
        self._lock = threading.Lock()
        self._sessions: Dict[str, str] = {}  # session_id -> dir
        shutil.rmtree(self._root, ignore_errors=True)

    def begin(self, tablet_peer, tablet_meta: dict) -> dict:
        """Flush + snapshot the tablet into a session dir; return the file
        manifest and the consensus state the destination must adopt."""
        session_id = uuid.uuid4().hex[:12]
        sdir = os.path.join(self._root, session_id)
        os.makedirs(sdir, exist_ok=True)
        tablet_peer.tablet.flush()
        # Hard-link LSM data (ref rocksdb CreateCheckpoint) + WAL segments.
        _snapshot_tree(os.path.join(tablet_peer.data_dir, "regular"),
                       os.path.join(sdir, "regular"))
        _snapshot_tree(os.path.join(tablet_peer.data_dir, "intents"),
                       os.path.join(sdir, "intents"))
        _snapshot_tree(tablet_peer.log.wal_dir, os.path.join(sdir, "wal"))
        files: List[Tuple[str, int]] = []
        for dirpath, _d, filenames in os.walk(sdir):
            for fn in filenames:
                p = os.path.join(dirpath, fn)
                files.append((os.path.relpath(p, sdir), os.path.getsize(p)))
        with self._lock:
            self._sessions[session_id] = sdir
        raft = tablet_peer.raft
        TRACE("rb session %s: %d files for tablet %s", session_id,
              len(files), tablet_peer.tablet_id)
        return {
            "session_id": session_id,
            "files": [[p, s] for p, s in files],
            "term": raft.current_term,
            "peer_ids": list(raft.config.peer_ids),
            "config_index": raft._meta.config_index,
            "tablet_meta": tablet_meta,
        }

    def _session_dir(self, session_id: str) -> str:
        with self._lock:
            sdir = self._sessions.get(session_id)
        if sdir is None:
            raise StatusError(Status.NotFound(
                f"remote bootstrap session {session_id}"))
        return sdir

    def fetch(self, session_id: str, relpath: str, offset: int,
              length: int) -> bytes:
        sdir = self._session_dir(session_id)
        p = os.path.normpath(os.path.join(sdir, relpath))
        if not p.startswith(os.path.normpath(sdir) + os.sep):
            raise StatusError(Status.InvalidArgument(
                f"path escape: {relpath!r}"))
        with open(p, "rb") as f:
            f.seek(offset)
            return f.read(min(length, FETCH_CHUNK))

    def end(self, session_id: str) -> None:
        with self._lock:
            sdir = self._sessions.pop(session_id, None)
        if sdir:
            shutil.rmtree(sdir, ignore_errors=True)


def download_tablet(messenger, source_addr: str, tablet_id: str,
                    dest_dir: str) -> dict:
    """Destination half (ref remote_bootstrap_client.cc): pull every file
    of a fresh source session into dest_dir; returns the begin-response
    (manifest + consensus state). Caller writes superblock/cmeta and opens
    the tablet."""
    resp = messenger.call(source_addr, "tserver", "begin_remote_bootstrap",
                          tablet_id=tablet_id)
    session_id = resp["session_id"]
    try:
        for relpath, size in resp["files"]:
            out = os.path.join(dest_dir, relpath)
            os.makedirs(os.path.dirname(out), exist_ok=True)
            with open(out, "wb") as f:
                off = 0
                while off < size:
                    chunk = messenger.call(
                        source_addr, "tserver", "fetch_remote_bootstrap",
                        session_id=session_id, relpath=relpath,
                        offset=off, length=FETCH_CHUNK)
                    if not chunk:
                        break
                    f.write(chunk)
                    off += len(chunk)
                f.flush()
                os.fsync(f.fileno())
    finally:
        try:
            messenger.call(source_addr, "tserver", "end_remote_bootstrap",
                           session_id=session_id)
        except StatusError:
            pass
    return resp
