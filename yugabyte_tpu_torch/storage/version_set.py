"""Version set + MANIFEST: durable LSM file metadata.

Copy of yugabyte_tpu/storage/version_set.py with the imports renamed.

Capability parity with the reference's VersionSet/MANIFEST (ref:
src/yb/rocksdb/db/version_set.cc LogAndApply; InstallCompactionResults
db/compaction_job.cc:894). The manifest is a JSON-lines log of version edits;
recovery replays it. Flushed frontiers persist here too (the WAL-replay
bootstrap reads them back — ref: Tablet::MaxPersistentOpId tablet.cc:2931).
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from yugabyte_tpu_torch.storage.sst import Frontier, SSTProps


@dataclass
class FileMeta:
    file_id: int
    path: str
    props: SSTProps
    being_compacted: bool = False

    @property
    def total_size(self) -> int:
        return self.props.data_size + self.props.base_size


class VersionSet:
    def __init__(self, db_dir: str):
        self.db_dir = db_dir
        self.manifest_path = os.path.join(db_dir, "MANIFEST")
        self.files: Dict[int, FileMeta] = {}
        self.next_file_id = 1
        self.flushed_frontier: Optional[Frontier] = None
        self.compactions_installed = 0  # in-memory stat (not persisted)
        self._lock = threading.Lock()

    # -- durability ---------------------------------------------------------
    # Manifest bytes go through the process Env like every other storage
    # file: encryption at rest covers the file catalog too, and the
    # fault-injection env can drop manifest fsyncs — a crash then rolls the
    # version set back in step with the SSTs it references (no frontier
    # edit can outlive the flush data it describes).
    def recover(self) -> None:
        from yugabyte_tpu_torch.utils.env import get_env
        if not os.path.exists(self.manifest_path):
            return
        for line in get_env().read_file(self.manifest_path).splitlines():
            if not line.strip():
                continue
            try:
                edit = json.loads(line)
            except ValueError:
                # torn tail: a crash mid-append left a partial edit — the
                # prefix before it is a complete, consistent version (the
                # WAL torn-tail rule applied to the metadata log)
                break
            self._apply(edit, log=False)

    def _append_manifest(self, edits: List[dict]) -> None:
        """One durable append batch of version edits (ref LogAndApply's
        single manifest write per install)."""
        from yugabyte_tpu_torch.utils.env import get_env
        f = get_env().open_append(self.manifest_path)
        try:
            f.append("".join(json.dumps(e) + "\n" for e in edits).encode())
            f.flush(fsync=True)
        finally:
            f.close()

    def _log_edit(self, edit: dict) -> None:
        self._append_manifest([edit])

    def _apply(self, edit: dict, log: bool = True) -> None:
        kind = edit["kind"]
        if kind == "add":
            props = SSTProps.from_json(edit["props"])
            # Manifest stores paths RELATIVE to db_dir: checkpoints/copies of
            # the directory must resolve to their own files.
            fm = FileMeta(edit["file_id"],
                          os.path.join(self.db_dir, edit["path"]), props)
            self.files[fm.file_id] = fm
            self.next_file_id = max(self.next_file_id, fm.file_id + 1)
        elif kind == "delete":
            self.files.pop(edit["file_id"], None)
        elif kind == "frontier":
            self.flushed_frontier = Frontier.from_json(edit["frontier"])
        if log:
            self._log_edit(edit)

    # -- mutations ----------------------------------------------------------
    def new_file_id(self) -> int:
        with self._lock:
            fid = self.next_file_id
            self.next_file_id += 1
            return fid

    def add_file(self, file_id: int, path: str, props: SSTProps) -> None:
        with self._lock:
            self._apply({"kind": "add", "file_id": file_id,
                         "path": os.path.relpath(path, self.db_dir),
                         "props": props.to_json()})

    def install_compaction(self, removed: List[int], added: List[tuple]) -> None:
        """Atomically (single manifest append batch) swap inputs for outputs."""
        with self._lock:
            edits = [{"kind": "delete", "file_id": fid} for fid in removed]
            edits += [{"kind": "add", "file_id": fid,
                       "path": os.path.relpath(path, self.db_dir),
                       "props": props.to_json()} for fid, path, props in added]
            self._append_manifest(edits)
            for e in edits:
                self._apply(e, log=False)
            self.compactions_installed += 1

    def set_flushed_frontier(self, frontier: Frontier) -> None:
        with self._lock:
            self._apply({"kind": "frontier", "frontier": frontier.to_json()})

    def live_files(self) -> List[FileMeta]:
        with self._lock:
            # newest first (higher file id = newer run) — universal compaction order
            return sorted(self.files.values(), key=lambda f: -f.file_id)
