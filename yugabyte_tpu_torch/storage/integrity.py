"""End-to-end data integrity: shadow verification + at-rest scrub.

Counterpart of yugabyte_tpu/storage/integrity.py, whole. Three defenses
against SILENT corruption — the failure class loud-fault containment
cannot see (HBM bit flips, miscompiles and kernel bugs on the device
side; disk bit rot at rest):

  - **Online shadow verification** of the device compaction paths: a
    sampled fraction of device-native jobs (``--shadow_verify_sample``)
    re-derives the survivor decisions through the native heap-merge
    oracle (storage/cpu_baseline.py) on a host thread that overlaps the
    device work, and compares them chunk by chunk as the device
    decisions stream into the writer. Any divergence raises
    ``ShadowMismatch`` before the outputs are installed; the compaction
    layer unwinds the partial outputs, sticky-quarantines the shape
    bucket on the health board and re-runs the job natively —
    byte-identical to a healthy device run.

  - **Resident-slab digest verification**: a sampled fraction of the
    device write-through cache installs (compaction's survivor span
    gathered on the card under the output file id) is re-derived from
    the installed file's bytes and compared; a divergent entry is
    dropped, never installed, and counted.

  - **At-rest scrub**: ``verify_sst`` deep-checks one SST (base-file
    footer + CRC, every data-block CRC, index/handle/bloom consistency)
    at a throttled byte rate; ``DB.scrub`` walks a DB's live files with
    it. A corrupt SST is quarantined (renamed ``*.corrupt``) and the DB
    parks with a STICKY Corruption background error (in-place retry
    cannot restore lost bytes). The tablet server's maintenance manager
    runs it on ``--scrub_interval_s`` (tserver/maintenance_manager.
    ScrubTabletsOp), and on a leader the cross-replica digest exchange
    follows (tserver/tablet_server._scrub_digest_check, counted by
    ``replica_mismatch_counter``; ``--scrub_replica_fail_after``).

Every counter lives in the metrics registry under the JAX package's
names (entity server:integrity).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from yugabyte_tpu_torch.utils import flags
from yugabyte_tpu_torch.utils import ybsan

flags.define_flag("shadow_verify_sample", 0.02,
                  "fraction of device-native compaction jobs whose "
                  "survivor decisions are re-derived through the native "
                  "merge oracle and compared before install (0 disables; "
                  "1.0 verifies every job)")
flags.define_flag("scrub_interval_s", 600.0,
                  "target seconds between at-rest integrity scrubs of "
                  "each tablet's SSTs (0 disables the scrubber)")
flags.define_flag("scrub_bytes_per_sec", 32 << 20,
                  "token-bucket cap on scrub read bandwidth so the "
                  "scrubber cannot starve foreground I/O")
flags.define_flag("scrub_replica_fail_after", 2,
                  "consecutive cross-replica digest mismatches before "
                  "the diverged follower is marked FAILED for rebuild "
                  "(>1 absorbs transient replication-lag noise)")


def integrity_metrics():
    from yugabyte_tpu_torch.utils.metrics import ROOT_REGISTRY
    return ROOT_REGISTRY.entity("server", "integrity")


def _counter(name: str, help: str):
    return integrity_metrics().counter(name, help)


def shadow_mismatch_counter():
    """The alarm: device survivor decisions diverged from the native
    oracle — silent-corruption class, never expected in a healthy run."""
    return _counter("device_shadow_mismatch_total",
                    "device-native compaction jobs whose survivor "
                    "decisions diverged from the native merge oracle "
                    "(caught pre-install by shadow verification)")


# ---------------------------------------------------------------------------
# Online shadow verification of device compaction decisions


class ShadowMismatch(Exception):
    """Device survivor decisions diverged from the native oracle."""


def maybe_shadow_verifier(inputs, history_cutoff_ht: int, is_major: bool,
                          retain_deletes: bool) -> Optional["ShadowVerifier"]:
    """Sampling gate for the device-native compaction path: returns a
    verifier (its oracle thread already running) for a sampled job, else
    None. Inputs are the FILTERED SSTReaders in shell-ingest order — the
    domain the device survivor indexes address."""
    sample = float(flags.get_flag("shadow_verify_sample"))
    if sample <= 0:
        return None
    if sample < 1.0:
        import random
        if random.random() >= sample:
            return None
    return ShadowVerifier(inputs, history_cutoff_ht, is_major,
                          retain_deletes)


_waited = threading.local()


def shadow_wait_s() -> float:
    """Seconds the calling thread has spent in ShadowVerifier's
    check_chunk and finish (waiting for the oracle, comparing): the
    verifier's share of a job's wall time. The device-native jobs keep
    it out of the rate they record on the health board, so an audited
    job does not read as a slow device."""
    return getattr(_waited, "s", 0.0)


@ybsan.shadow(_surv=ybsan.PUBLISHER_CONSUMER,
              _mk=ybsan.PUBLISHER_CONSUMER,
              _oracle_err=ybsan.PUBLISHER_CONSUMER,
              _ms=ybsan.PUBLISHER_CONSUMER)
class ShadowVerifier:
    """Re-derives one compaction job's survivor decisions through the
    native heap-merge oracle and compares the device decisions against
    them chunk by chunk.

    The oracle runs on its own thread from construction so its disk
    reads + native merge overlap the device staging/compute; the first
    ``check_chunk`` blocks until it lands. Oracle FAILURES (native lib
    unavailable, concurrent file teardown) disable verification for the
    job — they are not evidence of corruption; only a successful oracle
    run that DISAGREES raises ShadowMismatch."""

    def __init__(self, inputs, history_cutoff_ht: int, is_major: bool,
                 retain_deletes: bool):
        self._inputs = list(inputs)
        self._cutoff = history_cutoff_ht
        self._is_major = is_major
        self._retain = retain_deletes
        self._surv: Optional[np.ndarray] = None
        self._mk: Optional[np.ndarray] = None
        self._oracle_err: Optional[BaseException] = None
        self._off = 0
        self._ms = 0.0
        self._thread = threading.Thread(target=self._run_oracle,
                                        name="compaction-shadow",
                                        daemon=True)
        self._thread.start()

    def _run_oracle(self) -> None:
        import time as _time
        t0 = _time.monotonic()
        try:
            from yugabyte_tpu_torch.ops.slabs import concat_slabs
            from yugabyte_tpu_torch.storage.cpu_baseline import \
                compact_cpu_baseline
            slabs = [r.read_all() for r in self._inputs]
            offsets = np.concatenate(
                ([0], np.cumsum([s.n for s in slabs]))).tolist()
            merged = concat_slabs(slabs)
            order, keep, mk = compact_cpu_baseline(
                merged, offsets, self._cutoff, self._is_major, self._retain)
            self._surv = order[keep]
            self._mk = mk[keep]
        except BaseException as e:  # noqa: BLE001  # yblint: contained(oracle failure disables shadow verify for this job — it is not corruption evidence; counted + TRACEd on the join path)
            self._oracle_err = e
        finally:
            self._ms = (_time.monotonic() - t0) * 1e3

    def _join(self) -> bool:
        """True when the oracle produced expected decisions; False when
        it failed (verification skipped, counted)."""
        self._thread.join()
        if self._oracle_err is not None:
            from yugabyte_tpu_torch.utils.trace import TRACE
            TRACE("shadow verify: oracle failed (%r) — verification "
                  "skipped for this job", self._oracle_err)
            _counter("shadow_verify_skipped_total",
                     "sampled compaction jobs whose shadow oracle "
                     "failed (verification skipped, not corruption)"
                     ).increment()
            self._oracle_err = None
            self._surv = None
        return self._surv is not None

    def check_chunk(self, surv: np.ndarray, make_tomb: np.ndarray) -> None:
        """Compare one streamed decision chunk (global survivor indexes +
        tombstone flags, in merged order) against the oracle's span at
        the running offset. Raises ShadowMismatch on ANY divergence."""
        t0 = time.monotonic()
        try:
            self._check_chunk(surv, make_tomb)
        finally:
            _waited.s = shadow_wait_s() + time.monotonic() - t0

    def _check_chunk(self, surv: np.ndarray, make_tomb: np.ndarray) -> None:
        if not self._join():
            return
        lo, hi = self._off, self._off + len(surv)
        self._off = hi
        exp_s = self._surv[lo:hi]
        exp_m = self._mk[lo:hi]
        if len(exp_s) != len(surv) \
                or not np.array_equal(np.asarray(surv, dtype=np.int64),
                                      np.asarray(exp_s, dtype=np.int64)) \
                or not np.array_equal(np.asarray(make_tomb, dtype=bool),
                                      np.asarray(exp_m, dtype=bool)):
            bad = "chunk length"
            if len(exp_s) == len(surv):
                ds = np.nonzero(np.asarray(surv, dtype=np.int64)
                                != np.asarray(exp_s, dtype=np.int64))[0]
                dm = np.nonzero(np.asarray(make_tomb, dtype=bool)
                                != np.asarray(exp_m, dtype=bool))[0]
                bad = (f"survivor index at merged pos {lo + int(ds[0])}"
                       if len(ds) else
                       f"tombstone flag at merged pos {lo + int(dm[0])}")
            raise ShadowMismatch(
                f"device survivor decisions diverged from the native "
                f"oracle ({bad}; span [{lo}, {hi}) of "
                f"{len(self._surv)} expected survivors)")

    def finish(self, rows_out: int) -> None:
        """Final totals check + accounting; called after the last chunk,
        BEFORE the tail output files are written/installed."""
        t0 = time.monotonic()
        try:
            self._finish(rows_out)
        finally:
            _waited.s = shadow_wait_s() + time.monotonic() - t0

    def _finish(self, rows_out: int) -> None:
        from yugabyte_tpu_torch.utils.metrics import record_pipeline_stage
        if self._join():
            if rows_out != len(self._surv) or self._off != rows_out:
                raise ShadowMismatch(
                    f"device survivor count {rows_out} (checked "
                    f"{self._off}) != native oracle {len(self._surv)}")
            _counter("shadow_verify_jobs_total",
                     "device-native compaction jobs fully shadow-"
                     "verified against the native merge oracle"
                     ).increment()
            _counter("shadow_verify_rows_total",
                     "survivor decisions compared by shadow "
                     "verification").increment(rows_out)
        record_pipeline_stage("shadow", self._ms)


def shadow_snapshot() -> dict:
    """Shadow-verification state for /integrityz."""
    e = integrity_metrics()
    return {
        "sample": float(flags.get_flag("shadow_verify_sample")),
        "jobs_verified": e.counter("shadow_verify_jobs_total", "").value(),
        "rows_verified": e.counter("shadow_verify_rows_total", "").value(),
        "mismatches": shadow_mismatch_counter().value(),
        "skipped": e.counter("shadow_verify_skipped_total", "").value(),
    }


# ---------------------------------------------------------------------------
# Resident-slab digest verification: the device-gathered cache entry vs
# the SST bytes the shell actually wrote. The chained L0->L1->L2 path
# FEEDS the next compaction from these entries without ever re-decoding
# the file, so a wrong entry would silently poison every downstream
# merge — this sampled check keeps the write-through honest against the
# host truth (the installed, CRC-covered SST), exactly the posture the
# shadow verifier holds over the survivor decisions.


flags.define_flag("resident_digest_sample", 0.02,
                  "fraction of device write-through cache installs whose "
                  "staged columns are re-derived from the written SST "
                  "bytes and compared (0 disables; a mismatched entry is "
                  "dropped, never installed)")


def resident_digest_mismatch_counter():
    return _counter("resident_digest_mismatch_total",
                    "device write-through cache entries that diverged "
                    "from a host re-stage of the installed SST bytes "
                    "(entry dropped before any chained merge could read "
                    "it)")


def verify_resident_entry(staged, base_path: str) -> List[str]:
    """Full check of one write-through cache entry against the decoded
    bytes of its installed SST. Costs a download of the staged columns
    plus a host decode+pack — hence the sampling gate around it.
    Returns the (possibly empty) list of divergences."""
    from yugabyte_tpu_torch.ops.merge_gc import pack_cols
    from yugabyte_tpu_torch.storage.sst import SSTReader
    errors: List[str] = []
    reader = SSTReader(base_path)
    try:
        slab = reader.read_all()
    finally:
        reader.close()
    host_cols, n, _n_pad, _w = pack_cols(slab)
    if staged.n != n:
        return [f"row count: staged {staged.n} != decoded {n}"]
    dev_cols = staged.cols_dev.cpu().numpy().view(np.uint32)
    r_common = min(dev_cols.shape[0], host_cols.shape[0])
    if not np.array_equal(dev_cols[:r_common, :n], host_cols[:r_common, :n]):
        bad = np.nonzero(dev_cols[:r_common, :n]
                         != host_cols[:r_common, :n])
        errors.append(f"column words diverge at (row {int(bad[0][0])}, "
                      f"entry {int(bad[1][0])})")
    if dev_cols.shape[0] > r_common \
            and not (dev_cols[r_common:, :n] == 0).all():
        errors.append("staged width padding rows are not zero")
    return errors


def maybe_verify_resident_entry(staged, base_path: str) -> bool:
    """Sampling gate for the write-through install path: True when the
    entry may install (clean, or unsampled), False when the digest check
    found a divergence (counted; the caller drops the entry and lets the
    next reader re-stage from the file bytes)."""
    sample = float(flags.get_flag("resident_digest_sample"))
    if sample <= 0:
        return True
    if sample < 1.0:
        import random
        if random.random() >= sample:
            return True
    errors = verify_resident_entry(staged, base_path)
    _counter("resident_digest_checked_total",
             "device write-through cache installs digest-checked "
             "against the installed SST bytes").increment()
    if not errors:
        return True
    from yugabyte_tpu_torch.utils.trace import TRACE
    resident_digest_mismatch_counter().increment()
    TRACE("resident digest: device-staged entry for %s diverges from the "
          "installed bytes (%s) — entry dropped, not installed",
          base_path, errors[0])
    return False


def resident_digest_snapshot() -> dict:
    """Write-through digest-check state for /integrityz."""
    e = integrity_metrics()
    return {
        "sample": float(flags.get_flag("resident_digest_sample")),
        "checked": e.counter("resident_digest_checked_total", "").value(),
        "mismatches": resident_digest_mismatch_counter().value(),
    }


# ---------------------------------------------------------------------------
# At-rest SST verification (the scrub + sst_dump/ldb --verify core)


@dataclass
class SSTVerifyReport:
    path: str
    n_blocks: int = 0
    n_entries: int = 0
    bytes_verified: int = 0
    errors: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.errors


def verify_sst(base_path: str, limiter=None,
               cancel=None) -> SSTVerifyReport:
    """Deep-check one SST: base-file footer magic + CRC (SSTReader open),
    index/handle geometry, every data-block CRC (full decode), per-block
    index-key agreement and bloom membership of each block's first doc
    key. Reads pace through ``limiter`` (a utils.rate_limiter.RateLimiter)
    when given. Returns a report; never raises for corruption — the
    caller routes it (DB.scrub parks the DB, the tools exit non-zero)."""
    from yugabyte_tpu_torch.storage import block_format
    from yugabyte_tpu_torch.storage.sst import SSTReader
    from yugabyte_tpu_torch.utils.status import StatusError
    rep = SSTVerifyReport(path=base_path)
    try:
        r = SSTReader(base_path)
    except StatusError as e:  # yblint: contained(corruption captured into the verify report — the caller routes it to quarantine/background-error)
        rep.errors.append(f"base: {e}")
        return rep
    except OSError as e:  # yblint: contained(I/O failure captured into the verify report — the caller routes it)
        rep.errors.append(f"base io: {e}")
        return rep
    try:
        rep.n_blocks = r.n_blocks
        # index geometry: handles contiguous, sizes/counts consistent
        # with the props the footer vouched for
        off = 0
        n_sum = 0
        prev_key = None
        for i, (boff, bsize, bn) in enumerate(r.block_handles):
            if boff != off:
                rep.errors.append(
                    f"index: block {i} offset {boff} != expected {off}")
            off = boff + bsize
            n_sum += bn
            if prev_key is not None and r.index_keys[i] < prev_key:
                rep.errors.append(f"index: key order regresses at "
                                  f"block {i}")
            prev_key = r.index_keys[i]
        if n_sum != r.props.n_entries:
            rep.errors.append(f"index: entry counts sum {n_sum} != "
                              f"props n_entries {r.props.n_entries}")
        if off != r.props.data_size:
            rep.errors.append(f"index: handles cover {off} bytes != "
                              f"props data_size {r.props.data_size}")
        from yugabyte_tpu_torch.ops.slabs import _doc_key_len
        for i, (boff, bsize, bn) in enumerate(r.block_handles):
            if cancel is not None:
                cancel.check()
            if limiter is not None:
                limiter.acquire(bsize)
            try:
                raw = r._data.pread(bsize, boff)
                if len(raw) < bsize:
                    rep.errors.append(
                        f"block {i}: short read {len(raw)} < {bsize}")
                    continue
                slab = block_format.decode_block(raw)
            except StatusError as e:  # yblint: contained(block corruption captured into the verify report — the caller routes it to quarantine/background-error)
                rep.errors.append(f"block {i}: {e}")
                continue
            except OSError as e:  # yblint: contained(I/O failure captured into the verify report — the caller routes it)
                rep.errors.append(f"block {i} io: {e}")
                continue
            rep.bytes_verified += bsize
            rep.n_entries += slab.n
            if slab.n != bn:
                rep.errors.append(f"block {i}: decoded {slab.n} entries, "
                                  f"index says {bn}")
                continue
            if slab.n:
                raw_keys = slab.key_words.astype(">u4").tobytes()
                stride = slab.width_words * 4
                last = raw_keys[(slab.n - 1) * stride:
                                (slab.n - 1) * stride
                                + int(slab.key_len[slab.n - 1])]
                if last != r.index_keys[i]:
                    rep.errors.append(
                        f"block {i}: last key disagrees with index")
                first = raw_keys[: int(slab.key_len[0])]
                try:
                    doc_key = first[: _doc_key_len(first)]
                    if not r.may_contain_doc(doc_key):
                        rep.errors.append(
                            f"block {i}: bloom filter denies a present "
                            f"doc key")
                except (ValueError, IndexError):  # yblint: contained(system keys have no doc-key prefix — the bloom probe simply does not apply)
                    pass  # undecodable system key: bloom probe n/a
    finally:
        r.close()
    return rep


# ---------------------------------------------------------------------------
# Quarantine registry: corrupt files set aside for forensics


_quar_lock = threading.Lock()
_quarantined: List[dict] = []   # guarded-by: _quar_lock


def quarantine_sst(base_path: str, reason: str = "") -> List[str]:
    """Set a corrupt SST aside: rename base + data files to ``*.corrupt``
    so nothing re-opens the bad bytes as live data (open fds keep
    working; the replica is parked and will be rebuilt). Records the
    quarantine for /integrityz. Returns the new paths."""
    from yugabyte_tpu_torch.storage.sst import data_file_name
    from yugabyte_tpu_torch.utils.trace import TRACE
    moved = []
    for p in (base_path, data_file_name(base_path)):
        q = p + ".corrupt"
        try:
            os.replace(p, q)
            moved.append(q)
        except OSError as e:
            # half-quarantined is still quarantined for the reader (the
            # base file rename alone breaks re-open); keep going + say so
            TRACE("integrity: cannot quarantine %s: %s", p, e)
    with _quar_lock:
        _quarantined.append({"path": base_path, "reason": reason,
                             "ts": time.time()})
    _counter("sst_quarantine_total",
             "corrupt SSTs set aside as *.corrupt files").increment()
    TRACE("integrity: quarantined corrupt SST %s (%s)", base_path, reason)
    return moved


def quarantined_files() -> List[dict]:
    with _quar_lock:
        return [dict(d) for d in _quarantined]


# ---------------------------------------------------------------------------
# Scrub pacing + accounting


_scrub_limiter = None        # guarded-by: _scrub_limiter_lock
_scrub_limiter_rate = 0      # guarded-by: _scrub_limiter_lock
_scrub_limiter_lock = threading.Lock()


def scrub_rate_limiter():
    """Process-wide scrub read throttle (one bucket across all tablets;
    rebuilt when the flag changes). None when unthrottled."""
    global _scrub_limiter, _scrub_limiter_rate
    rate = int(flags.get_flag("scrub_bytes_per_sec"))
    if rate <= 0:
        return None
    with _scrub_limiter_lock:
        if _scrub_limiter is None or _scrub_limiter_rate != rate:
            from yugabyte_tpu_torch.utils.rate_limiter import RateLimiter
            _scrub_limiter = RateLimiter(rate)
            _scrub_limiter_rate = rate
        return _scrub_limiter


def record_scrub(files: int, blocks: int, nbytes: int,
                 corrupt: int) -> None:
    e = integrity_metrics()
    e.counter("sst_scrub_files_total",
              "SSTs deep-verified by the background scrubber"
              ).increment(files)
    e.counter("sst_scrub_bytes_total",
              "bytes read and CRC-verified by the background scrubber"
              ).increment(nbytes)
    if corrupt:
        e.counter("sst_scrub_corruption_total",
                  "corrupt SSTs detected by the background scrubber"
                  ).increment(corrupt)


def scrub_snapshot() -> dict:
    """Scrubber totals."""
    e = integrity_metrics()
    return {
        "bytes_per_sec": int(flags.get_flag("scrub_bytes_per_sec")),
        "files_verified": e.counter("sst_scrub_files_total", "").value(),
        "bytes_verified": e.counter("sst_scrub_bytes_total", "").value(),
        "corruption_detected": e.counter(
            "sst_scrub_corruption_total", "").value(),
        "quarantined": len(quarantined_files()),
    }


def replica_mismatch_counter():
    return _counter("scrub_replica_mismatch_total",
                    "cross-replica digest mismatches observed by the "
                    "leader-driven scrub digest exchange")
