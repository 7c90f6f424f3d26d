"""Segmented write-ahead log with group commit.

Counterpart of yugabyte_tpu/consensus/log.py, with the imports renamed.

Capability parity with the reference WAL (ref: src/yb/consensus/log.cc —
`Log::AsyncAppendReplicates` :739, background `Appender` group-commit thread
:328-432, segment allocation/rollover, `LogReader` for bootstrap replay,
GC of fully-consumed segments). Design notes carried over:

- The WAL *is* the Raft log (ref log.h:104-113): entries are
  (term, index, payload) where payload is opaque to this layer (the Raft
  module serializes write batches into it).
- Group commit: producers enqueue batches; one appender thread drains the
  queue, writes everything pending, issues ONE fsync, then fires all the
  callbacks (ref log.cc:392-432).
- Segments are named by the index of their first entry; a segment rolls
  when it exceeds `log_segment_size_bytes`. GC drops whole segments whose
  max index < the anchor (ref log_reader.cc / log_anchor_registry).

Record framing: [u32 crc][u32 payload_len][u64 term][u64 index][payload],
crc32 over everything after the crc field. A torn tail (crash mid-write)
fails the crc / length check and replay stops there, matching the
reference's tolerance of a truncated final record.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

from yugabyte_tpu_torch.utils import flags
from yugabyte_tpu_torch.utils.latency import STAGE_WAL_FSYNC
from yugabyte_tpu_torch.utils.metrics import ROOT_REGISTRY
from yugabyte_tpu_torch.utils.trace import TRACE, LongOperationTracker

flags.define_flag("log_segment_size_bytes", 64 * 1024 * 1024,
                  "roll the WAL segment after it exceeds this size "
                  "(ref log_segment_size_mb)")
flags.define_flag("durable_wal_write", True,
                  "fsync WAL batches (ref durable_wal_write)")
flags.define_flag("wal_slow_fsync_threshold_ms", 500.0,
                  "a WAL group-commit fsync slower than this dumps its "
                  "trace to /tracez (ref long_fsync_threshold_ms)")


def _wal_metrics():
    """Process-wide WAL tier metrics (one appender thread per Log; the
    entity aggregates across tablets like the reference's server-level
    log_append_latency)."""
    e = ROOT_REGISTRY.entity("server", "wal")
    return (e.histogram("wal_append_duration_ms",
                        "WAL group-commit batch encode+write wall time"),
            e.histogram("wal_fsync_duration_ms",
                        "WAL group-commit fsync wall time"),
            e.counter("wal_group_commits_total",
                      "WAL group-commit batches written"))

_HEADER = struct.Struct("<IIQQ")  # crc, payload_len, term, index


@dataclass(frozen=True)
class LogEntry:
    term: int
    index: int
    payload: bytes

    @property
    def op_id(self) -> Tuple[int, int]:
        return (self.term, self.index)


def _segment_name(first_index: int) -> str:
    return f"wal-{first_index:012d}"


def _encode_entry(e: LogEntry) -> bytes:
    body = struct.pack("<QQ", e.term, e.index) + e.payload
    crc = zlib.crc32(body)
    return struct.pack("<II", crc, len(e.payload)) + body


def _read_segment(path: str) -> Iterator[LogEntry]:
    """Yield entries; stop silently at a torn/corrupt tail. Reads go
    through the process Env (transparent decryption at rest)."""
    from yugabyte_tpu_torch.utils.env import get_env
    data = get_env().read_file(path)
    off = 0
    while off + _HEADER.size <= len(data):
        crc, plen, term, index = _HEADER.unpack_from(data, off)
        end = off + _HEADER.size + plen
        if end > len(data):
            break  # torn tail
        body = data[off + 8:end]
        if zlib.crc32(body) != crc:
            break  # corrupt tail
        yield LogEntry(term, index, data[off + _HEADER.size:end])
        off = end


class LogReader:
    """Reads a WAL directory in index order (ref: consensus/log_reader.cc)."""

    def __init__(self, wal_dir: str):
        self.wal_dir = wal_dir

    def segments(self) -> List[str]:
        if not os.path.isdir(self.wal_dir):
            return []
        names = sorted(n for n in os.listdir(self.wal_dir)
                       if n.startswith("wal-"))
        return [os.path.join(self.wal_dir, n) for n in names]

    def read_all(self, min_index: int = 0) -> Iterator[LogEntry]:
        """All entries with index >= min_index, in order. Overwritten
        (truncated-then-rewritten) indexes yield only the latest record
        because truncation rewrites the tail segment in place. Segments are
        named by their first index, so ones entirely below min_index are
        skipped without reading them."""
        segs = self.segments()
        first_indexes = [int(os.path.basename(s)[4:]) for s in segs]
        for i, seg in enumerate(segs):
            nxt_first = (first_indexes[i + 1] if i + 1 < len(segs) else None)
            if nxt_first is not None and nxt_first <= min_index:
                continue  # every entry in this segment is < min_index
            for e in _read_segment(seg):
                if e.index >= min_index:
                    yield e


class Log:
    """Appendable segmented WAL with a group-commit appender thread."""

    def __init__(self, wal_dir: str):
        from yugabyte_tpu_torch.utils import lock_rank
        self.wal_dir = wal_dir
        os.makedirs(wal_dir, exist_ok=True)
        self._lock = lock_rank.tracked(threading.Lock(), "log._lock")
        self._cv = threading.Condition(self._lock)
        self._queue: List[Tuple[List[LogEntry],
                                Optional[Callable]]] = []  # guarded-by: _cv
        self._inflight = False  # guarded-by: _cv — appender mid-write
        self._stopped = False   # guarded-by: _cv
        # First append/fsync failure latches here: the segment may hold a
        # torn record, so further appends are refused (they would land
        # after the tear and be unreachable at replay) and every callback
        # reports the error — the replicate FAILS rather than claiming
        # durability it does not have. Recovery is a re-bootstrap (the
        # torn-tail replay rule applies). on_io_error tells the owner
        # (TabletPeer) to transition the tablet to FAILED.
        self._io_error: Optional[Exception] = None  # guarded-by: _cv
        self.on_io_error: Optional[Callable[[Exception], None]] = None
        # _file/_file_size/_file_first_index are appender-protocol state,
        # not lock state: only the appender thread touches them while
        # _inflight is True, and truncate_after/close first wait (under
        # _cv) for the queue to drain and _inflight to clear. Annotating
        # them guarded-by _cv would demand the lock across segment file
        # I/O, serializing producers behind fsync for no correctness win.
        self._file = None
        self._file_size = 0
        self._file_first_index = None
        self._last_op_id = (0, 0)  # guarded-by: _cv
        self._recover()
        self._appender = threading.Thread(
            target=self._appender_loop, name=f"wal-appender", daemon=True)
        self._appender.start()

    # ------------------------------------------------------------- recovery
    def _recover(self) -> None:  # guarded-by: _cv (pre-publication ctor)
        reader = LogReader(self.wal_dir)
        segs = reader.segments()
        last = None
        for seg in segs:
            for e in _read_segment(seg):
                last = e
        if last is not None:
            self._last_op_id = last.op_id
        if segs:
            # Re-open the final segment for append; rewrite it first so a
            # torn tail never precedes new records.
            from yugabyte_tpu_torch.utils.env import get_env, looks_encrypted
            tail = segs[-1]
            if looks_encrypted(tail) and not get_env().encrypted:
                # FAIL CLOSED: without keys this segment reads as empty
                # and the torn-tail rewrite would destroy committed data
                raise RuntimeError(
                    f"WAL segment {tail} is encrypted but no universe "
                    f"keys are loaded; refusing to open")
            entries = list(_read_segment(tail))
            get_env().write_file(
                tail + ".tmp",
                b"".join(_encode_entry(e) for e in entries))
            os.replace(tail + ".tmp", tail)
            self._file = get_env().open_append(tail)
            self._file_size = self._file.offset
            self._file_first_index = int(os.path.basename(tail)[4:])

    # --------------------------------------------------------------- append
    @property
    def last_op_id(self) -> Tuple[int, int]:
        with self._lock:
            return self._last_op_id

    @property
    def io_error(self) -> Optional[Exception]:
        """The latched append failure, or None while healthy."""
        with self._lock:
            return self._io_error

    def backlog(self) -> int:
        """Entries queued for the appender but not yet fsynced — the
        WAL-pressure signal of the write-admission state machine
        (tablet/admission.py): a deep backlog means appends are arriving
        faster than the disk syncs them, so new writes should be delayed
        or shed before the queue's memory and latency grow unbounded."""
        with self._lock:
            n = sum(len(entries) for entries, _cb, _b in self._queue)
            return n + (1 if self._inflight else 0)

    def append_async(self, entries: Sequence[LogEntry],
                     callback: Optional[Callable] = None,
                     budget=None) -> None:
        """Queue entries for the appender thread (ref log.cc:739
        AsyncAppendReplicates). The callback fires after fsync as
        callback(err): err is None on durable success, the I/O error
        otherwise — claiming success on a failed append would count a
        non-durable replica toward the commit majority.

        budget, when given, is the originating op's LatencyBudget
        (utils/latency.py): the appender thread records the group
        fsync wall into it — the caller thread is already parked on
        the commit cv by then, so the contextvar can't carry it."""
        if not entries:
            if callback:
                callback(None)
            return
        with self._cv:
            if self._stopped:
                raise RuntimeError("log is closed")
            if self._io_error is not None:
                err = self._io_error
            else:
                self._queue.append((list(entries), callback, budget))
                self._cv.notify()
                return
        if callback:
            callback(err)

    def append_sync(self, entries: Sequence[LogEntry]) -> None:
        done = threading.Event()
        box = {"err": None}

        def _cb(err):
            box["err"] = err
            done.set()

        self.append_async(entries, _cb)
        done.wait()
        if box["err"] is not None:
            raise box["err"]

    def _appender_loop(self) -> None:
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._queue or self._stopped)
                if self._stopped and not self._queue:
                    return
                batch, self._queue = self._queue, []
                self._inflight = True
            try:
                self._write_batch(batch)
            finally:
                with self._cv:
                    self._inflight = False
                    self._cv.notify_all()

    def _write_batch(self, batch) -> None:
        import time as _time
        h_append, h_fsync, c_commits = _wal_metrics()
        with self._cv:
            err = self._io_error
        if err is None:
            try:
                t0 = _time.monotonic()
                files_to_sync = set()
                last_op_id = None
                for entries, _cb, _budget in batch:
                    for e in entries:
                        self._ensure_segment(e.index)
                        rec = _encode_entry(e)
                        self._file.append(rec)
                        self._file_size += len(rec)
                        last_op_id = e.op_id
                    files_to_sync.add(self._file)
                if last_op_id is not None:
                    # published under the lock: last_op_id is read
                    # concurrently (last_op_id property, raft recovery)
                    with self._cv:
                        self._last_op_id = last_op_id
                t1 = _time.monotonic()
                h_append.increment((t1 - t0) * 1e3)
                # a slow fsync dumps its trace (LongOperationTracker armed
                # on the WAL durability path, ref read_query.cc:500 usage)
                with LongOperationTracker(
                        "wal.fsync",
                        flags.get_flag("wal_slow_fsync_threshold_ms")):
                    for f in files_to_sync:
                        f.flush(fsync=bool(
                            flags.get_flag("durable_wal_write")))
                fsync_ms = (_time.monotonic() - t1) * 1e3
                h_fsync.increment(fsync_ms)
                c_commits.increment()
                # Attribute the group fsync to every op in the batch:
                # each waited for this one sync (group commit), so each
                # op's durability cost IS the group's wall time.
                for _entries, _cb, b in batch:
                    if b is not None:
                        b.record(STAGE_WAL_FSYNC, fsync_ms)
            except OSError as exc:
                err = exc
                self._fail(exc)
        for _entries, cb, _budget in batch:
            if cb:
                # err != None also for batches whose bytes landed before
                # the failure: their fsync never ran, so durability is
                # unconfirmed — conservatively failed
                cb(err)

    def _fail(self, exc: Exception) -> None:
        with self._cv:
            first = self._io_error is None
            if first:
                self._io_error = exc
        if first:
            TRACE("wal %s: append failed, log is sealed: %s",
                  self.wal_dir, exc)
            hook = self.on_io_error
            if hook is not None:
                try:
                    hook(exc)
                except Exception as e:  # noqa: BLE001 — appender must live
                    TRACE("wal %s: on_io_error hook raised: %s",
                          self.wal_dir, e)

    def _ensure_segment(self, first_index: int) -> None:
        if (self._file is None or
                self._file_size >= flags.get_flag("log_segment_size_bytes")):
            from yugabyte_tpu_torch.utils.env import get_env
            if self._file:
                self._file.flush(fsync=True)
                self._file.close()
            path = os.path.join(self.wal_dir, _segment_name(first_index))
            self._file = get_env().open_append(path)
            self._file_size = self._file.offset
            self._file_first_index = first_index
            TRACE("wal: rolled to segment %s", path)

    # ----------------------------------------------------- truncate (raft)
    def truncate_after(self, index: int) -> None:  # takes _cv for its body
        """Drop all entries with index > `index` (follower conflict
        resolution, ref raft_consensus.cc follower Update path). Rewrites
        the tail segment(s) synchronously, after waiting for any in-flight
        appender batch to drain (callbacks never block on this lock)."""
        with self._cv:
            self._cv.wait_for(lambda: not self._queue and not self._inflight)
            from yugabyte_tpu_torch.utils.env import get_env, looks_encrypted
            segs = LogReader(self.wal_dir).segments()
            if self._file:
                self._file.flush(fsync=True)
                self._file.close()
                self._file = None
            for seg in reversed(segs):
                if looks_encrypted(seg) and not get_env().encrypted:
                    raise RuntimeError(
                        f"WAL segment {seg} is encrypted but no universe "
                        f"keys are loaded; refusing to truncate")
                entries = list(_read_segment(seg))
                if entries and entries[0].index > index:
                    os.remove(seg)
                    continue
                kept = [e for e in entries if e.index <= index]
                get_env().write_file(
                    seg + ".tmp",
                    b"".join(_encode_entry(e) for e in kept))
                os.replace(seg + ".tmp", seg)
                break
            segs = LogReader(self.wal_dir).segments()
            last = None
            for seg in segs:
                for e in _read_segment(seg):
                    last = e
            if segs:
                self._file = get_env().open_append(segs[-1])
                self._file_size = self._file.offset
                self._file_first_index = int(os.path.basename(segs[-1])[4:])
            self._last_op_id = last.op_id if last else (0, 0)

    # ------------------------------------------------------------------- gc
    def _gcable_segments(self, anchor_index: float) -> List[str]:
        """Closed segments whose entries are ALL < anchor_index, in order
        (the single authority for the GC rule: deletion, scoring and the
        closed-bytes report all walk this list). Caller holds _cv. The
        active segment is never eligible."""
        segs = LogReader(self.wal_dir).segments()
        out = []
        for i, seg in enumerate(segs[:-1]):
            nxt_first = int(os.path.basename(segs[i + 1])[4:])
            if nxt_first <= anchor_index:
                out.append(seg)
            else:
                break
        return out

    @staticmethod
    def _sizes(paths: List[str]) -> int:
        total = 0
        for p in paths:
            try:
                total += os.path.getsize(p)
            except OSError:  # yblint: contained(size probe; a segment GC'd mid-scan just drops out of the total)
                pass
        return total

    def gc_candidate_bytes(self, anchor_index: int) -> int:
        """Bytes gc_up_to(anchor_index) would free right now (maintenance
        scoring, ref MaintenanceOpStats::logs_retained_bytes)."""
        with self._cv:
            return self._sizes(self._gcable_segments(anchor_index))

    def gc_up_to(self, anchor_index: int) -> int:
        """Delete whole segments whose entries are ALL < anchor_index (the
        minimum of flushed frontiers / peer watermarks, ref
        log_anchor_registry). Never deletes the active segment. Returns
        number of segments removed."""
        with self._cv:
            victims = self._gcable_segments(anchor_index)
            for seg in victims:
                os.remove(seg)
            return len(victims)

    def close(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify()
        self._appender.join(timeout=10)
        if self._file:
            try:
                self._file.flush(fsync=True)
                self._file.close()
            except OSError as e:
                TRACE("wal %s: close-time flush failed: %s",
                      self.wal_dir, e)
            self._file = None
