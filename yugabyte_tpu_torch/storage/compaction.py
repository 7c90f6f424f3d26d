"""The compaction job: device merge+GC decisions and the byte paths around it.

Counterpart of yugabyte_tpu/storage/compaction.py. `run_compaction_job`
(compaction.py:174 there) is the router, argument for argument as the
JAX package's, except that the port's device=None is the card:

  combined path: an explicit device ("cuda" or "cpu"), the native engine
          available, no YBTPU_FORCE_RADIX and no deep input go to
          `run_compaction_job_device_native`, or, with a mesh of more than
          one shard and at least distributed_compaction_min_rows input rows
          (`_wants_distributed`), to `run_compaction_job_dist_native`;
  native job: device="native" runs the stock native CompactionJob
          (`_run_native_job`);
  Python path: everything else, and the device-native job's re-entry for
          skewed picks (`_no_combined=True`): `read_all` + `concat_slabs`;
          deep inputs take the native C++ merge (`compact_cpu_baseline`),
          a mesh-sized job `parallel.dist_compact.distributed_compact`,
          the rest `run_merge.merge_and_gc_runs` on the device (the radix
          re-sort past 2x run-layout inflation or under YBTPU_FORCE_RADIX:
          kernels G, I.1, B over the concatenated slab; else kernels A and B, chunked when
          YBTPU_MERGE_CHUNK_ROWS is set); then `_gather_slab` and
          `SSTWriter(fit_lindex=False)`, one file per
          compaction_max_output_entries_per_sst rows.

`run_compaction_job_device_native` (compaction.py:560 there), the
production L0->L1 path, routes as the JAX package's
(compaction.py:660-695 there); past 2x run-layout inflation, or on a
deep input, it re-enters the router's Python path:

Device codec on (the default; slice 2 of the port), `_device_codec_attempt`:
  stage A: each input's raw data file is read and CRC-checked on the host
          (block_codec.parse_raw_file, values as zero-copy slices), its
          column regions uploaded and decoded on the card (kernel C);
  stage B: re-laid run-major on the card (run_merge.stage_runs_from_staged)
          and merged + GC'd (kernels A and B, run_merge.launch_merge_gc);
  stage C: per output file, the survivor span is gathered on the card
          (kernels D and E) and encoded (kernel F); the host splices the
          values, compresses, stamps headers and CRCs and writes the file
          (_DeviceCodecWriter).

Device codec off (YBTPU_DEVICE_CODEC=0; slice 1), or BlockCodecUnsupported
raised, `_device_native_attempt`:
  stage A (host thread): the native shell (native/compaction_engine.cc)
          reads and decodes the input SSTs;
  stage B: the inputs' key columns are decoded on host threads, uploaded
          (merge_gc.stage_slab), re-laid run-major and merged + GC'd on the
          card (kernels A and B);
  stage C: the packed decisions stream into the shell, which writes the
          output SSTs (_StreamingNativeWriter).

Both paths write output files byte-identical to the stock native
CompactionJob (`_run_native_job`) and to the JAX package's job over the
same inputs.

The resident chain (JAX compaction.py:770-1160): with a device slab cache
and `input_ids`, inputs the cache holds skip staging (no read, no
upload), misses stage into the cache (`stage`, or `stage_from_raw` on the
codec route), and every input is pinned for the whole attempt. Each
output file's survivor span is gathered on the card (kernel D once a
job, kernel E per span) and installed under the output id at one level
above the deepest input as the file hits disk (`_ResidentSpanInstaller`;
a sampled digest check, storage/integrity.py, drops a divergent entry);
the learned index of each output is fit on the card over the same span
(P4). With a run cache (storage/run_cache.py) holding every input, the
native shell ingests the retained decoded runs (no file read, no block
decode) and the job takes the shell route; the shell route exports its
outputs into the run cache, so the next job over them starts warm.

`run_compaction_job_dist_native` (compaction.py:1433 there) is the mesh
path: the native shell ingests the input bytes on its own thread while
`read_all` + `concat_slabs` + the distributed step
(parallel/dist_compact.distributed_compact_with_outputs: kernels M1-M3,
G, I.1, B) run, then _StreamingNativeWriter writes the outputs; with a
device cache `_DistResidentInstaller` installs each output's span from
the sharded outputs (DistOutputs.gather_span: H once, D once, E a span).
`run_compaction_job_with_decisions` (:1626 there) is stage C of a pooled
wave slot (parallel/dist_compact.pooled_merge_gc): outputs from decisions
computed elsewhere.

Containment and routing, as in the JAX package:

  - `run_compaction_job(..., offload_policy=board)` routes a job by the
    bucket-health board (storage/bucket_health.py; `health_board()`):
    `use_device("run_merge_fused", (k_pad, m), probe=False)` decides,
    forced by `device_offload_mode`, native while the bucket is COLD,
    else by the measured rates; a native routing is timed into the
    board's native EWMA (compaction.py:210-295 there).
  - `run_compaction_job_device_native` gates on
    `allow_device("run_merge_fused", (k_pad, m))` (a parked bucket
    completes natively, timed), times every device completion into the
    board, and CONTAINS a device fault (ops/device_faults.is_device_fault,
    run_merge.DeviceFaultError) or a shadow mismatch: the attempt unwinds
    (partial outputs deleted, installed cache entries dropped, zero
    pins), the bucket is quarantined (a mismatch sticky), the counters
    and the TRACE record it, and the whole job re-runs natively over the
    same filtered inputs, byte-identical (compaction.py:618-748 there).
  - A sampled fraction of device jobs (`shadow_verify_sample`) is
    shadow-verified (storage/integrity.ShadowVerifier) chunk by chunk
    before any byte installs, on the shell, codec and mesh routes; the
    silent-fault site `maybe_flip_survivors` sits before each check.
  - `run_compaction_job_dist_native` gates and contains the mesh job on
    its ("dist_compact", (n_shards, capacity)) bucket.

Universal compaction picking (`pick_universal`, compaction_picker.cc
there) is what the DB's scheduler calls (storage/db.py).

Cancellation and pacing, as in the JAX package: every route takes
`cancel=` (a utils.cancellation.CancellationToken) and checks it at the
JAX package's stage boundaries — the router's entry, each input of an
ingest (the native job, the shell's ingest thread, the codec's raw
reads), each input upload, each decision chunk, each output file. A
cancelled job raises OperationCancelled after its unwind: the output
files it wrote are deleted, the resident installer's entries dropped and
its cache pins released; the board records nothing for it (it is not a
device fault). The process-wide `compaction_rate_limiter()`
(compaction_rate_bytes_per_sec) paces every writer between output files,
never after the last one. Every writer hits the sync point
`compaction:output_written` after each file (utils/sync_point.py): a test
arms it to act in the middle of a job.

Under an encrypted Env (utils/env.py), as in the JAX package: the C++
shell reads and writes raw files, so it is skipped wherever it would run
(the router's combined gate, the "native" job, the decisions writer), and
`run_compaction_job_device_native` re-enters the router's Python path
with `_no_combined=True`: `read_all` through the Env, kernels A + B (or
G, I.1, B for a skewed pick, the native merge for deep documents) on the
device, and `SSTWriter` through the Env. The outputs carry a random nonce
per file; their plaintext equals the JAX package's.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from yugabyte_tpu_torch.docdb.value import Value
from yugabyte_tpu_torch.ops.merge_gc import GCParams
from yugabyte_tpu_torch.ops.slabs import KVSlab
from yugabyte_tpu_torch.storage.sst import (Frontier, SSTProps, SSTReader,
                                            SSTWriter)
from yugabyte_tpu_torch.storage.version_set import FileMeta
from yugabyte_tpu_torch.utils import flags, sync_point

flags.define_flag("universal_compaction_max_merge_width", 16,
                  "cap on runs merged in one universal pick "
                  "(ref max_merge_width, docdb_rocksdb_util.cc)")
flags.define_flag("universal_compaction_always_include_size_bytes",
                  64 << 10,
                  "runs at or below this size join a pick regardless of "
                  "the size-ratio rule (ref "
                  "universal_compaction_always_include_size_threshold)")
flags.define_flag("universal_compaction_min_merge_width", 4,
                  "min sorted runs to trigger a compaction")
flags.define_flag("universal_compaction_size_ratio_pct", 20,
                  "merge run into candidate set while its size <= "
                  "(1+ratio) * accumulated")

flags.define_flag("compaction_max_output_entries_per_sst", 2_000_000,
                  "split compaction output files at this row count")
flags.define_flag("compaction_rate_bytes_per_sec", 0,
                  "token-bucket cap on compaction output bytes/sec; "
                  "0 = unlimited (ref rocksdb/util/rate_limiter.cc)")
flags.define_flag("distributed_compaction_min_rows", 1 << 20,
                  "jobs at or above this many input rows fan their "
                  "subcompactions across the device mesh when one is "
                  "available (ref: subcompaction sizing, "
                  "compaction_job.cc:330 GenSubcompactionBoundaries)")


_rate_limiter = None       # guarded-by: _rate_limiter_lock
_rate_limiter_rate = 0     # guarded-by: _rate_limiter_lock
_rate_limiter_lock = threading.Lock()


def compaction_rate_limiter():
    """Process-wide limiter paced by compaction_rate_bytes_per_sec
    (rebuilt when the flag changes); one shared bucket across every
    compaction thread. None when the flag is 0."""
    global _rate_limiter, _rate_limiter_rate
    rate = flags.get_flag("compaction_rate_bytes_per_sec")
    if rate <= 0:
        return None
    with _rate_limiter_lock:
        if _rate_limiter is None or _rate_limiter_rate != rate:
            from yugabyte_tpu_torch.utils.rate_limiter import RateLimiter
            _rate_limiter = RateLimiter(rate)
            _rate_limiter_rate = rate
        return _rate_limiter


def _check(cancel) -> None:
    """A stage boundary: raise OperationCancelled if the job's token
    tripped."""
    if cancel is not None:
        cancel.check()


def _after_output_file(props: SSTProps, more_coming: bool) -> None:
    """The close of one output file, on every writer: the sync point,
    then the limiter's pacing between files (never after the last)."""
    sync_point.hit("compaction:output_written")
    limiter = compaction_rate_limiter()
    if limiter is not None and more_coming:
        limiter.acquire(props.data_size + props.base_size)


def _shell_can_run() -> bool:
    """The native byte shell can run this job's bytes: it builds, and the
    process Env is plaintext (the shell reads and writes raw files)."""
    from yugabyte_tpu_torch.storage import native_engine
    from yugabyte_tpu_torch.utils.env import get_env
    return native_engine.available() and not get_env().encrypted


def _ingest_decode_counter():
    """The warm resident chain's honesty meter: a chained job whose every
    input the run cache holds ingests without reading or decoding SST
    bytes, and adds nothing here."""
    from yugabyte_tpu_torch.utils.metrics import ROOT_REGISTRY
    return ROOT_REGISTRY.entity("server", "storage").counter(
        "compaction_ingest_decode_total",
        "compaction inputs the native shell read and decoded from SST "
        "files (run-cache hits ingest without touching the bytes)")


def ingest_decodes() -> int:
    """Native-shell file ingests so far in this process."""
    return _ingest_decode_counter().value()


def _count_ingest_decode() -> None:
    _ingest_decode_counter().increment()


def _storage_fallback_counter():
    from yugabyte_tpu_torch.utils.metrics import ROOT_REGISTRY
    return ROOT_REGISTRY.entity("server", "offload_policy").counter(
        "compaction_device_fallback_total",
        "compactions completed via the native merge after a mid-job "
        "device fault")


def _realign_ids(all_inputs, input_ids, inputs):
    """Cache ids re-aligned to a filtered input list: a whole-file drop
    earlier in the list must not shift every later reader onto its
    neighbor's staged columns."""
    if input_ids is None:
        return None
    id_of = {id(r): fid for r, fid in zip(all_inputs, input_ids)}
    return [id_of[id(r)] for r in inputs]


def _out_level(device_cache, input_ids) -> int:
    """Residency level of a job's outputs: one above the deepest input
    (the chained L0->L1->L2 eviction policy keeps deep outputs resident
    over shallow short-lived ones)."""
    in_levels = [device_cache.level_of(fid)
                 for fid in (input_ids or []) if fid is not None]
    return 1 + max([lv for lv in in_levels if lv is not None], default=0)


def _wants_distributed(mesh, n_rows: int) -> bool:
    """The single gate of the distributed compaction: a mesh of more than
    one shard and a job at or above distributed_compaction_min_rows."""
    return (mesh is not None
            and getattr(mesh, "devices", np.empty(0)).size > 1
            and n_rows >= flags.get_flag("distributed_compaction_min_rows"))


def filter_expired_inputs(inputs: Sequence[SSTReader],
                          history_cutoff_ht: int, is_major: bool,
                          retain_deletes: bool):
    """Whole-file TTL drop (ref: docdb/compaction_file_filter.h:60
    ExpirationFilter): an input SST whose every entry carries a TTL that
    expired before the history cutoff contributes nothing to the output.
    Only at major compactions without retain-deletes, and only when the
    file's key range is disjoint from every other input's (an expired
    entry still shadows older versions of its key in other files).

    Returns (kept_inputs, dropped_inputs)."""
    if not is_major or retain_deletes:
        return list(inputs), []
    cutoff_phys_us = history_cutoff_ht >> 12
    inputs = list(inputs)
    kept, dropped = [], []
    for r in inputs:
        exp = getattr(r.props, "max_expire_us", 0)
        if not exp or exp > cutoff_phys_us:
            kept.append(r)
            continue
        overlaps = any(
            o is not r and o.props.n_entries
            and not (r.props.last_key < o.props.first_key
                     or o.props.last_key < r.props.first_key)
            for o in inputs)
        if overlaps:
            kept.append(r)   # shadowing possible: take the per-entry path
        else:
            dropped.append(r)
    return kept, dropped


@dataclass
class CompactionPick:
    inputs: List[FileMeta]
    is_major: bool


def pick_universal(files: List[FileMeta]) -> Optional[CompactionPick]:
    """The universal picker (ref: compaction_picker.cc
    UniversalCompactionPicker; YB's DocDB default, docdb_rocksdb_util.cc:
    637-658). files must be newest-first. Accumulates runs newest-first
    while each stays within the size ratio of the accumulated ones (runs
    under the always-include size join regardless) and stops at the first
    run that dwarfs them; a pick of every live run is major. Returns None
    below the minimum merge width."""
    min_width = flags.get_flag("universal_compaction_min_merge_width")
    max_width = flags.get_flag("universal_compaction_max_merge_width")
    ratio = flags.get_flag("universal_compaction_size_ratio_pct")
    always_sz = flags.get_flag(
        "universal_compaction_always_include_size_bytes")
    candidates = [f for f in files if not f.being_compacted]
    if len(candidates) < min_width:
        return None
    acc = candidates[0].total_size
    picked = [candidates[0]]
    for f in candidates[1:]:
        if len(picked) >= max_width:
            break
        if (f.total_size <= always_sz
                or f.total_size * 100 <= (100 + ratio) * acc):
            picked.append(f)
            acc += f.total_size
        else:
            break
    if len(picked) < min_width:
        return None
    is_major = len(picked) == len(files)  # all live runs -> bottommost
    return CompactionPick(picked, is_major)


@dataclass
class CompactionResult:
    outputs: List[Tuple[int, str, SSTProps]]  # (file_id, base_path, props)
    rows_in: int
    rows_out: int
    # survivors rewritten as tombstones (TTL expiry at a non-major
    # compaction); 0 where the path cannot cheaply count them (pure
    # native shell)
    tombstones_written: int = 0


class _StreamingNativeWriter:
    """Stage C: write output SSTs from survivor spans AS THE SPANS FILL.

    feed(n_available) writes every output file whose full
    [start, start+max_rows) span is already covered while strictly more
    survivors are known to exist; finish() writes the tail. File splits and
    base assembly are those of the JAX package's writer, so outputs are
    byte-identical over identical ranges. Each file is a cancellation
    boundary, and the rate limiter paces between files (never after the
    last one: that would only delay the install)."""

    def __init__(self, job, out_dir: str, new_file_id, fr,
                 block_entries: Optional[int], has_deep: bool = False,
                 cancel=None, on_span=None, lindex_for_span=None):
        self._job = job
        self._cancel = cancel
        # (fid, base_path, start, end) after each span's SST exists on
        # disk: the write-through installer hooks here
        self._on_span = on_span
        # (start, end) -> Optional[lindex dict], before the span's base
        # file is assembled: the learned index fit over the span's cols
        # while they are on the card
        self._lindex_for_span = lindex_for_span
        self._out_dir = out_dir
        self._new_file_id = new_file_id
        self._fr = fr
        self._has_deep = has_deep
        self._block_entries = (block_entries if block_entries is not None
                               else flags.get_flag("sst_block_entries"))
        self._max_rows = flags.get_flag(
            "compaction_max_output_entries_per_sst")
        self._tombstone_value = Value.tombstone().encode()
        self._next_start = 0
        self.outputs: List[Tuple[int, str, SSTProps]] = []
        self.ranges: List[Tuple[int, int]] = []

    def _write_span(self, start: int, end: int, more_coming: bool) -> None:
        from yugabyte_tpu_torch.storage.sst import (
            data_file_name, sst_compression_enabled, write_base_file)
        _check(self._cancel)   # file-split boundary
        fid = self._new_file_id()
        base_path = os.path.join(self._out_dir, f"{fid:06d}.sst")
        size, index, hashes, fk, lk = self._job.write_output(
            start, end, data_file_name(base_path), self._block_entries,
            compress=sst_compression_enabled(),
            tombstone_value=self._tombstone_value)
        lindex = (self._lindex_for_span(start, end)
                  if self._lindex_for_span is not None else None)
        props = write_base_file(base_path, index, end - start, hashes,
                                fk, lk, self._fr, size,
                                has_deep=self._has_deep, lindex=lindex)
        self.outputs.append((fid, base_path, props))
        self.ranges.append((start, end))
        if self._on_span is not None:
            self._on_span(fid, base_path, start, end)
        _after_output_file(props, more_coming)

    def feed(self, n_available: int) -> None:
        # strictly >: an exactly-full final span must come from finish()
        while n_available - self._next_start > self._max_rows:
            self._write_span(self._next_start,
                             self._next_start + self._max_rows,
                             more_coming=True)
            self._next_start += self._max_rows

    def finish(self, rows_out: int
               ) -> Tuple[List[Tuple[int, str, SSTProps]],
                          List[Tuple[int, int]]]:
        start = self._next_start
        while start < rows_out:
            end = min(start + self._max_rows, rows_out)
            self._write_span(start, end, more_coming=end < rows_out)
            start = end
        self._next_start = start
        return self.outputs, self.ranges


def _write_native_outputs(job, out_dir: str, new_file_id, fr,
                          block_entries: Optional[int],
                          has_deep: bool = False, cancel=None
                          ) -> Tuple[List[Tuple[int, str, SSTProps]],
                                     List[Tuple[int, int]]]:
    """Write the native job's survivors as (possibly split) output SSTs:
    the everything-already-available form of _StreamingNativeWriter.
    Returns (outputs, ranges); on failure or cancellation the files
    written so far are deleted."""
    writer = _StreamingNativeWriter(job, out_dir, new_file_id, fr,
                                    block_entries, has_deep=has_deep,
                                    cancel=cancel)
    try:
        return writer.finish(job.n_survivors)
    except BaseException:
        _remove_outputs(writer)
        raise


def _run_native_job(inputs: Sequence[SSTReader], out_dir: str, new_file_id,
                    history_cutoff_ht: int, is_major: bool,
                    retain_deletes: bool, block_entries: Optional[int],
                    frontier_inputs: Optional[Sequence[SSTReader]] = None,
                    cancel=None) -> CompactionResult:
    """Full-native compaction, the stock CompactionJob: the byte path
    (decode/merge/encode) runs in C++ (native/compaction_engine.cc);
    Python assembles base files and frontiers."""
    from yugabyte_tpu_torch.storage import native_engine

    with native_engine.NativeCompactionJob() as job:
        for r in inputs:
            _check(cancel)   # input boundary
            with open(r.data_path, "rb") as f:
                job.add_input(f.read(), r.block_handles)
        rows_in = job.prepare()
        rows_out = job.merge(history_cutoff_ht, is_major, retain_deletes)
        fr = _merge_frontiers(
            [r.props.frontier for r in (frontier_inputs or inputs)],
            history_cutoff_ht)
        outputs, _ranges = _write_native_outputs(
            job, out_dir, new_file_id, fr, block_entries,
            has_deep=any(r.props.has_deep for r in inputs), cancel=cancel)
    return CompactionResult(outputs, rows_in, rows_out)


def run_compaction_job(inputs: Sequence[SSTReader], out_dir: str,
                       new_file_id, history_cutoff_ht: int, is_major: bool,
                       retain_deletes: bool = False, device=None,
                       block_entries: Optional[int] = None, device_cache=None,
                       input_ids: Optional[Sequence[int]] = None,
                       mesh=None, offload_policy=None, run_cache=None,
                       _no_combined: bool = False,
                       cancel=None) -> CompactionResult:
    """The compaction job (ref: CompactionJob::Run, compaction_job.cc:442),
    routed as the JAX package's (see the module docstring).

    new_file_id: callable returning the next file id. device: "cuda",
    "cpu" (the kernels' plain PyTorch versions; the tests) or "native"
    (the native CompactionJob); None takes the Python path on the card.
    Without a GPU, "cuda" and None raise. device_cache + input_ids: input
    key columns come from (or are staged into) the device slab cache and
    the outputs are written through to it; run_cache: the native run
    cache of the device-native job. mesh: a parallel.mesh.Mesh — jobs at
    or above distributed_compaction_min_rows fan their subcompactions
    across its shards (parallel/dist_compact.py). offload_policy: the
    bucket-health board (storage/bucket_health.health_board()) — with an
    explicit device, a single-device job routes by `use_device("run_merge_fused", (k_pad,
    m), probe=False)`, and a native routing is timed into the board's
    native EWMA (mesh-sized jobs gate on their own bucket in
    run_compaction_job_dist_native). cancel: a CancellationToken checked
    at every stage boundary of the route taken (OperationCancelled; the
    files written are deleted, nothing is installed)."""
    import time
    _check(cancel)
    all_inputs = list(inputs)
    orig_input_ids = list(input_ids) if input_ids is not None else None
    board_key = None  # (board, family, qkey) when the board routed native
    if (offload_policy is not None and device is not None
            and device != "native" and not _no_combined):
        # measured device-vs-native routing: offload only where the live
        # bucket-health board says the device path wins
        est_rows = sum(r.props.n_entries for r in all_inputs)
        cached = bool(device_cache is not None and input_ids is not None
                      and all(device_cache.contains(fid)
                              for fid in input_ids))
        if not _wants_distributed(mesh, est_rows):
            from yugabyte_tpu_torch.ops import run_merge
            from yugabyte_tpu_torch.storage import offload_policy as _pol
            qkey = _pol.bucket_key(run_merge.packed_run_ns(
                [r.props.n_entries for r in all_inputs
                 if r.props.n_entries]))
            # probe=False: a routing DECISION — a DEGRADED bucket's probe
            # slot is claimed at the device-native path's own
            # allow_device(), immediately before the launch
            if not offload_policy.use_device("run_merge_fused", qkey,
                                             est_rows=est_rows,
                                             cached=cached, probe=False):
                device = "native"
                board_key = (offload_policy, "run_merge_fused", qkey)
    if device is not None and device != "native" and not _no_combined:
        # the production path: device decisions + the codec or the C++
        # byte shell, for depth-2 inputs without the radix override, where
        # the shell can run the bytes (unencrypted); the device-native
        # job re-enters below for skewed picks
        from yugabyte_tpu_torch.ops import run_merge
        if (_shell_can_run() and not run_merge.force_radix()
                and not any(r.props.has_deep for r in all_inputs)):
            if _wants_distributed(
                    mesh, sum(r.props.n_entries for r in all_inputs)):
                # mesh-sized job: distributed decisions + the same native
                # byte shell / streaming writer as the single-device job
                return run_compaction_job_dist_native(
                    all_inputs, out_dir, new_file_id, history_cutoff_ht,
                    is_major, retain_deletes, device=device,
                    block_entries=block_entries, device_cache=device_cache,
                    input_ids=orig_input_ids, mesh=mesh, cancel=cancel)
            return run_compaction_job_device_native(
                all_inputs, out_dir, new_file_id, history_cutoff_ht,
                is_major, retain_deletes, device=device,
                block_entries=block_entries, device_cache=device_cache,
                input_ids=orig_input_ids, run_cache=run_cache,
                cancel=cancel)
    inputs, dropped = filter_expired_inputs(
        all_inputs, history_cutoff_ht, is_major, retain_deletes)
    dropped_rows = sum(r.props.n_entries for r in dropped)
    input_ids = _realign_ids(all_inputs, input_ids, inputs)
    if not inputs:
        return CompactionResult([], dropped_rows, 0)
    if device == "native" and _shell_can_run():
        # under encryption at rest the Python path (through the Env) runs
        t0 = time.monotonic()
        result = _run_native_job(inputs, out_dir, new_file_id,
                                 history_cutoff_ht, is_major,
                                 retain_deletes, block_entries,
                                 frontier_inputs=all_inputs,
                                 cancel=cancel)
        result.rows_in += dropped_rows
        if board_key is not None:
            # live native measurement, what the device rate must beat
            board, family, qkey = board_key
            board.record_native(family, qkey, result.rows_in,
                                time.monotonic() - t0)
        return result
    from yugabyte_tpu_torch.ops.slabs import FLAG_DEEP, concat_slabs
    slabs = [r.read_all() for r in inputs]
    keep_idx = [i for i, s in enumerate(slabs) if s.n]
    slabs = [slabs[i] for i in keep_idx]
    if not slabs:
        return CompactionResult([], 0, 0)
    merged = concat_slabs(slabs)
    params = GCParams(history_cutoff_ht, is_major, retain_deletes)
    if device == "native" or bool((merged.flags & FLAG_DEEP).any()):
        # documents deeper than row + column: the device GC implements
        # depth-2 overwrite truncation only; the native merge carries the
        # full per-component overwrite stack (ref:
        # docdb_compaction_filter.cc:104-123)
        from yugabyte_tpu_torch.storage.cpu_baseline import (
            compact_cpu_baseline)
        offsets = np.concatenate(
            ([0], np.cumsum([s.n for s in slabs]))).tolist()
        perm, keep, make_tomb = compact_cpu_baseline(
            merged, offsets, history_cutoff_ht, is_major, retain_deletes)
    elif _wants_distributed(mesh, merged.n):
        # a large job and a mesh: the subcompactions fan across its
        # shards; the outputs come back globally range-partitioned, so the
        # survivors are in merged order
        from yugabyte_tpu_torch.parallel.dist_compact import (
            distributed_compact)
        _cols, keep_d, mk_d, src_idx = distributed_compact(merged, params,
                                                           mesh)
        perm, keep, make_tomb = src_idx, keep_d, mk_d
    elif device_cache is not None and input_ids is not None:
        # resident inputs: cache hits skip the pack and the upload, misses
        # stage into the cache
        from yugabyte_tpu_torch.ops import run_merge
        staged_list = []
        for fid, slab in zip([input_ids[i] for i in keep_idx], slabs):
            st = device_cache.get(fid)
            if st is None:
                st = device_cache.stage(fid, slab)
            staged_list.append(st)
        if (run_merge.run_layout_inflation([s.n for s in slabs]) > 2.0
                or run_merge.force_radix()):
            # one huge run + small ones: the radix re-sort over the
            # concatenated resident cols (kernels H, G, I.1, B)
            from yugabyte_tpu_torch.ops.merge_gc import merge_and_gc_device
            from yugabyte_tpu_torch.storage.device_cache import concat_staged
            perm, keep, make_tomb = merge_and_gc_device(
                merged, params, staged=concat_staged(staged_list))
        else:
            perm, keep, make_tomb = run_merge.launch_merge_gc(
                run_merge.stage_runs_from_staged(staged_list),
                params).result()
    else:
        # the run-aware device merge; merge_and_gc_runs takes the radix
        # re-sort itself when the run layout would inflate
        from yugabyte_tpu_torch.ops import run_merge
        perm, keep, make_tomb = run_merge.merge_and_gc_runs(
            slabs, params, device=device)
    surv = perm[keep]                       # input indices, merged order
    tomb_flags = make_tomb[keep]
    rows_out = int(surv.shape[0])
    # the frontier covers whole-file-dropped inputs too (ref:
    # compaction_job.cc:683-692)
    fr = _merge_frontiers([r.props.frontier for r in all_inputs],
                          history_cutoff_ht)
    max_rows = flags.get_flag("compaction_max_output_entries_per_sst")
    tombstone_value = Value.tombstone().encode()
    out_level = (_out_level(device_cache, input_ids)
                 if device_cache is not None else 0)
    outputs: List[Tuple[int, str, SSTProps]] = []
    try:
        for start in range(0, rows_out, max_rows):
            _check(cancel)   # file-split boundary
            end = min(start + max_rows, rows_out)
            out_slab = _gather_slab(merged, surv[start:end],
                                    tomb_flags[start:end], tombstone_value)
            fid = new_file_id()
            base_path = os.path.join(out_dir, f"{fid:06d}.sst")
            # fit_lindex=False: byte-identical to the native writer's
            props = SSTWriter(base_path, block_entries=block_entries,
                              fit_lindex=False).write(out_slab, fr)
            outputs.append((fid, base_path, props))
            if device_cache is not None:
                # write-through for the next pick, one level above the
                # deepest input
                device_cache.stage(fid, out_slab, level=out_level)
            _after_output_file(props, end < rows_out)
    except BaseException:
        # the unwind: no partial output or its cache entry outlives a
        # failed or cancelled job
        _remove_files(outputs)
        if device_cache is not None:
            for fid, _p, _props in outputs:
                device_cache.drop(fid)
        raise
    return CompactionResult(outputs, merged.n + dropped_rows, rows_out,
                            tombstones_written=int(
                                np.count_nonzero(tomb_flags)))


def _gather_slab(slab: KVSlab, sel: np.ndarray, make_tomb: np.ndarray,
                 tombstone_value: bytes) -> KVSlab:
    """The surviving rows, vectorized: values move as one offset-arithmetic
    gather (ref hot loop 3, compaction_job.cc:958-1024), rows rewritten as
    tombstones get the tombstone value and flag."""
    from yugabyte_tpu_torch.ops.slabs import FLAG_TOMBSTONE, ValueArray
    va = ValueArray.from_list(slab.values)
    values = va.gather(slab.value_idx[sel], replace_mask=make_tomb,
                       replacement=tombstone_value)
    flags_out = slab.flags[sel].copy()
    flags_out[make_tomb] |= FLAG_TOMBSTONE
    return KVSlab(
        key_words=slab.key_words[sel], key_len=slab.key_len[sel],
        doc_key_len=slab.doc_key_len[sel], ht_hi=slab.ht_hi[sel],
        ht_lo=slab.ht_lo[sel], write_id=slab.write_id[sel],
        flags=flags_out, ttl_ms=slab.ttl_ms[sel],
        value_idx=np.arange(len(sel), dtype=np.int32), values=values)


def run_compaction_job_device_native(
        inputs: Sequence[SSTReader], out_dir: str, new_file_id,
        history_cutoff_ht: int, is_major: bool,
        retain_deletes: bool = False, device=None,
        block_entries: Optional[int] = None, device_cache=None,
        input_ids: Optional[Sequence[int]] = None,
        run_cache=None, cancel=None) -> CompactionResult:
    """The production hot path: CUDA decisions, with the device block
    codec (the default) or the native byte shell (YBTPU_DEVICE_CODEC=0,
    a job the codec cannot take, or a job whose every input the run cache
    holds) around them.

    device: 'cuda' (the default) or 'cpu' (the kernels' plain PyTorch
    versions; the tests). Without a GPU and without device='cpu' it
    raises. A skewed pick (run-layout inflation past 2x) or a deep input
    re-enters run_compaction_job's Python path (the radix re-sort, or the
    native merge). device_cache + input_ids: the resident chain (see the
    module docstring); run_cache: the native run cache.

    The bucket (k_pad, m) is gated on the health board, every device
    completion is timed into it (without the sampled shadow verifier's
    wait: integrity.shadow_wait_s), and a device fault or shadow mismatch
    is contained: the job completes natively, byte-identical (see the
    module docstring). cancel: checked at every stage boundary; a
    cancelled attempt unwinds and raises, and the board records nothing
    for it."""
    from yugabyte_tpu_torch.ops import block_codec, run_merge
    from yugabyte_tpu_torch.utils.env import get_env
    from yugabyte_tpu_torch.utils.torch_setup import resolve_device

    dev = resolve_device(device)
    if get_env().encrypted:
        # the C++ shell bypasses the Env: under encryption the Env-aware
        # Python path runs instead (the JAX package's route)
        return run_compaction_job(inputs, out_dir, new_file_id,
                                  history_cutoff_ht, is_major,
                                  retain_deletes, device=device,
                                  block_entries=block_entries,
                                  device_cache=device_cache,
                                  input_ids=input_ids,
                                  _no_combined=True, cancel=cancel)
    all_inputs = list(inputs)
    orig_input_ids = list(input_ids) if input_ids is not None else None
    inputs, dropped = filter_expired_inputs(
        all_inputs, history_cutoff_ht, is_major, retain_deletes)
    dropped_rows = sum(r.props.n_entries for r in dropped)
    inputs = [r for r in inputs if r.props.n_entries]
    if not inputs:
        return CompactionResult([], dropped_rows, 0)
    input_ids = _realign_ids(all_inputs, input_ids, inputs)
    if (any(r.props.has_deep for r in all_inputs)
            or run_merge.run_layout_inflation(
                [r.props.n_entries for r in inputs]) > 2.0):
        # deep documents take the native merge's overwrite stack; skewed
        # run sizes would pad every run to the largest bucket on the
        # device: the radix re-sort instead (same outputs; the original
        # input list with its original id pairing)
        return run_compaction_job(all_inputs, out_dir, new_file_id,
                                  history_cutoff_ht, is_major,
                                  retain_deletes, device=device,
                                  block_entries=block_entries,
                                  device_cache=device_cache,
                                  input_ids=orig_input_ids,
                                  _no_combined=True, cancel=cancel)
    import time
    from yugabyte_tpu_torch.storage import integrity, offload_policy
    from yugabyte_tpu_torch.storage.bucket_health import health_board
    from yugabyte_tpu_torch.utils.trace import TRACE
    qkey = offload_policy.bucket_key(
        run_merge.packed_run_ns([r.props.n_entries for r in inputs]))
    surface = offload_policy.declared_surface_keys()
    if surface and qkey not in surface:
        # a reachable shape the committed manifest never declared: the
        # live signal that the bucket lattice and reality diverged
        from yugabyte_tpu_torch.utils.metrics import ROOT_REGISTRY
        ROOT_REGISTRY.entity("server", "offload_policy").counter(
            "compaction_offsurface_bucket_total",
            "device-native compactions whose shape bucket is outside "
            "the declared kernel compile surface").increment()
        TRACE("compaction: bucket k_pad=%d m=%d is outside the declared "
              "compile surface", *qkey)
    board = health_board()
    if not board.allow_device("run_merge_fused", qkey):
        # QUARANTINED (recent fault / sticky mismatch) or DEGRADED with
        # no probe slot: native until the board re-opens the bucket
        TRACE("compaction: shape bucket k_pad=%d m=%d is parked by the "
              "health board — routing native", *qkey)
        t0 = time.monotonic()
        result = run_compaction_job(all_inputs, out_dir, new_file_id,
                                    history_cutoff_ht, is_major,
                                    retain_deletes, device="native",
                                    block_entries=block_entries,
                                    input_ids=orig_input_ids,
                                    _no_combined=True, cancel=cancel)
        # the parked completion is live native measurement too: what a
        # probe's device rate has to beat to re-promote
        board.record_native("run_merge_fused", qkey, result.rows_in,
                            time.monotonic() - t0)
        return result
    # The device codec takes the cold byte path: when the run cache holds
    # every input the shell ingests with zero decode (and its export keeps
    # the chain warm), so the shell keeps those jobs
    all_run_cached = bool(
        run_cache is not None and input_ids is not None
        and all(run_cache.contains(fid) for fid in input_ids))
    t0 = time.monotonic()
    w0 = integrity.shadow_wait_s()

    def device_s() -> float:
        # the job's seconds without the sampled verifier's wait: an
        # audited job must not read as a slow device on the board
        return time.monotonic() - t0 - (integrity.shadow_wait_s() - w0)
    try:
        if block_codec.codec_enabled() and not all_run_cached:
            try:
                result = _device_codec_attempt(
                    inputs, all_inputs, input_ids, dropped_rows, out_dir,
                    new_file_id, history_cutoff_ht, is_major,
                    retain_deletes, dev, block_entries, device_cache,
                    cancel)
                board.record_device("run_merge_fused", qkey,
                                    result.rows_in, device_s())
                return result
            except block_codec.BlockCodecUnsupported as e:
                # the native byte shell takes the job
                block_codec.codec_metrics()["encode_fallbacks"].increment()
                TRACE("compaction: device codec unsupported for this "
                      "job (%s) — taking the native byte shell", e)
        else:
            block_codec.codec_metrics()["encode_fallbacks"].increment()
        result = _device_native_attempt(
            inputs, all_inputs, input_ids, dropped_rows, out_dir,
            new_file_id, history_cutoff_ht, is_major, retain_deletes, dev,
            block_entries, device_cache, run_cache, cancel)
        board.record_device("run_merge_fused", qkey, result.rows_in,
                            device_s())
        return result
    except Exception as e:  # noqa: BLE001 — device-fault containment
        if not _contain(e, board, "run_merge_fused", qkey):
            raise
        # the native re-run below writes through the shell encode
        block_codec.codec_metrics()["encode_fallbacks"].increment()
        # byte-identical completion: the attempt unwound cleanly (its
        # partial outputs deleted, entries dropped, pins released), so
        # the whole job re-runs natively over the SAME filtered inputs
        t1 = time.monotonic()
        result = _run_native_job(inputs, out_dir, new_file_id,
                                 history_cutoff_ht, is_major,
                                 retain_deletes, block_entries,
                                 frontier_inputs=all_inputs, cancel=cancel)
        result.rows_in += dropped_rows
        board.record_native("run_merge_fused", qkey, result.rows_in,
                            time.monotonic() - t1)
        return result


def _contain(e: BaseException, board, family: str, bucket) -> bool:
    """The containment decision of a failed device attempt (JAX
    compaction.py:696-737): False for a host-side failure (a disk fault,
    a bug, a build error — the caller re-raises it); for a device fault
    (ops/device_faults.is_device_fault, run_merge.DeviceFaultError) or a
    shadow mismatch, records it on the board (a mismatch STICKY: wrong
    bytes out-rank any fault), counts the native completion, TRACEs, and
    returns True."""
    from yugabyte_tpu_torch.ops import device_faults
    from yugabyte_tpu_torch.ops.run_merge import DeviceFaultError
    from yugabyte_tpu_torch.storage.integrity import (
        ShadowMismatch, shadow_mismatch_counter)
    from yugabyte_tpu_torch.utils.trace import TRACE
    shadow_mm = isinstance(e, ShadowMismatch)
    if not (shadow_mm or isinstance(e, DeviceFaultError)
            or device_faults.is_device_fault(e)):
        return False
    cause = e.cause if isinstance(e, DeviceFaultError) else e
    reason = f"{type(cause).__name__}: {cause}"
    if shadow_mm:
        board.record_mismatch(family, bucket, reason=reason)
    else:
        board.record_fault(family, bucket, reason=reason)
    _storage_fallback_counter().increment()
    if shadow_mm:
        # the alarm: device decisions diverged from the native oracle —
        # a SILENT-corruption event, never an expected fault
        shadow_mismatch_counter().increment()
        TRACE("compaction: SHADOW VERIFY MISMATCH (%s) — partial outputs "
              "deleted, %s bucket %s quarantined; re-running the job "
              "natively", cause, family, tuple(bucket))
    else:
        TRACE("compaction: device fault mid-job (%r) — %s bucket %s "
              "quarantined; completing via the native merge", cause,
              family, tuple(bucket))
    return True


class _ResidentSpanInstaller:
    """Write-through installer of the resident chain: as each output
    file's SST hits disk, its survivor span is gathered on the card from
    the merge's products (kernel D once a job, kernel E a span: key
    columns never leave the device) and installed into the slab cache
    under the OUTPUT file id, so the entry corresponds to the file just
    written. A sampled digest check (storage/integrity.py) re-derives the
    entry from the written bytes; a divergent entry is dropped, never
    installed.

    A chunked handle has no parent-domain products until its decision
    stream is fully drained, so spans written mid-stream buffer and
    install in finish()."""

    def __init__(self, device_cache, level: int):
        self.device_cache = device_cache
        self.level = level
        self.handle = None          # set once the merge is launched
        self.installed: List[int] = []
        self._pending: List[Tuple[int, str, int, int]] = []
        self._pos_all = None
        self._span_cache: dict = {}   # (start, end) -> StagedCols

    def _ready(self) -> bool:
        """True once the handle holds parent-domain device products
        (building them from a fully drained chunked stream if needed)."""
        from yugabyte_tpu_torch.ops.run_merge import _ChunkedMergeGCHandle
        h = self.handle
        if h is None:
            return False
        if h._p_mat is not None:
            return True
        if isinstance(h, _ChunkedMergeGCHandle) and h._result is not None:
            h.to_parent_products()   # the chunked stream fully drained
            return h._p_mat is not None
        return False

    def _gather_span(self, start: int, end: int):
        from yugabyte_tpu_torch.ops import run_merge
        st = self._span_cache.pop((start, end), None)
        if st is not None:
            return st
        if self._pos_all is None:   # one survivor scan per job
            self._pos_all = run_merge.survivor_positions(self.handle)
        return run_merge.gather_staged_output_span(
            self.handle, self._pos_all, start, end)

    def lindex_for_span(self, start: int, end: int):
        """Learned-index fit (kernel P4) over the span's gathered cols,
        cached so the install that follows gathers nothing again. None
        when the flag is off or the handle is mid-stream (chunked spans
        written before their decisions drained carry no model: it is
        advisory)."""
        from yugabyte_tpu_torch.ops import point_read
        if not flags.get_flag("sst_learned_index") or not self._ready():
            return None
        st = self._gather_span(start, end)
        self._span_cache[(start, end)] = st
        return point_read.fit_learned_index_device(st)

    def on_span(self, fid: int, base_path: str, start: int, end: int
                ) -> None:
        if self.handle is None:
            return
        if not self._ready():
            self._pending.append((fid, base_path, start, end))
            return
        self._install(fid, base_path, start, end)

    def _install(self, fid: int, base_path: str, start: int, end: int
                 ) -> None:
        from yugabyte_tpu_torch.storage import integrity
        st = self._gather_span(start, end)
        if not integrity.maybe_verify_resident_entry(st, base_path):
            return  # digest mismatch: the next reader re-stages from bytes
        self.device_cache.put(fid, st, level=self.level)
        self.installed.append(fid)

    def finish(self) -> None:
        """Install the spans a chunked stream had to defer."""
        if self.handle is None or not self._pending:
            return
        if not self._ready():
            return
        pending, self._pending = self._pending, []
        for fid, base_path, start, end in pending:
            self._install(fid, base_path, start, end)

    def unwind(self) -> None:
        """Failure unwind: every entry this attempt installed describes a
        file the unwind just deleted; drop them so the cache never
        outlives its SSTs."""
        for fid in self.installed:
            self.device_cache.drop(fid)
        self.installed = []


def _unwind_attempt(state: dict) -> None:
    """The clean unwind of a failed attempt: delete every output file its
    writer wrote and drop every cache entry its installer installed."""
    _remove_outputs(state["writer"])
    if state["installer"] is not None:
        state["installer"].unwind()


def _release_pins(state: dict, device_cache) -> None:
    """Zero leaked pins on every exit path: the inputs an attempt pinned
    against eviction are released, a failed attempt's included."""
    if device_cache is not None:
        for fid in state["pins"]:
            device_cache.unpin(fid)


def _device_native_attempt(
        inputs, all_inputs, input_ids, dropped_rows: int, out_dir: str,
        new_file_id, history_cutoff_ht: int, is_major: bool,
        retain_deletes: bool, device, block_entries, device_cache=None,
        run_cache=None, cancel=None) -> CompactionResult:
    """One attempt of the pipelined device+native job. UNWINDS CLEANLY on
    any failure or cancellation: every output file it wrote is deleted
    and every cache entry it installed dropped before the exception
    propagates, and the inputs it pinned are unpinned on every exit."""
    # cached-run ids, in INPUT ORDER (the device survivor indexes are
    # run-major over exactly this order), all or nothing: a partial hit
    # pays the file path for every input. contains() first, so a partial
    # hit neither counts hits nor promotes entries it never consumes;
    # probed before the ingest thread starts
    cached_ids = None
    if run_cache is not None and input_ids is not None \
            and all(run_cache.contains(fid) for fid in input_ids):
        ids = [run_cache.get(fid) for fid in input_ids]
        if all(i is not None for i in ids):
            cached_ids = ids
    state = {"writer": None, "installer": None, "pins": []}
    try:
        return _device_native_body(
            inputs, all_inputs, input_ids, dropped_rows, out_dir,
            new_file_id, history_cutoff_ht, is_major, retain_deletes,
            device, block_entries, device_cache, run_cache, cached_ids,
            state, cancel)
    except BaseException:
        _unwind_attempt(state)
        raise
    finally:
        _release_pins(state, device_cache)


def _remove_outputs(writer) -> None:
    """Unwind of a failed attempt: delete every output file (base and
    data) its writer wrote."""
    if writer is not None:
        _remove_files(writer.outputs)


def _remove_files(outputs) -> None:
    from yugabyte_tpu_torch.storage.sst import data_file_name
    for _fid, base_path, _props in outputs:
        for p in (base_path, data_file_name(base_path)):
            try:
                os.remove(p)
            except OSError:  # the file may not exist yet
                pass


def _stage_input(fid, device_cache, state: dict, stage_miss):
    """One input of stage B: a resident input comes straight from the
    cache; a miss is staged by stage_miss(fid) (fid None without a cache
    id). A resident input is pinned for the whole attempt (released in
    its finally): capacity eviction can never race the merge off it."""
    cached = device_cache is not None and fid is not None
    st = device_cache.get(fid) if cached else None
    if st is None:
        st = stage_miss(fid if cached else None)
    if cached and device_cache.pin(fid):
        state["pins"].append(fid)
    return st


def _device_native_body(
        inputs, all_inputs, input_ids, dropped_rows: int, out_dir: str,
        new_file_id, history_cutoff_ht: int, is_major: bool,
        retain_deletes: bool, device, block_entries, device_cache,
        run_cache, cached_ids, state: dict, cancel=None) -> CompactionResult:
    from yugabyte_tpu_torch.ops import device_faults, run_merge
    from yugabyte_tpu_torch.ops.merge_gc import stage_slab
    from yugabyte_tpu_torch.storage import integrity, native_engine

    # online shadow verification (sampled): the native heap-merge oracle
    # re-derives this job's survivor decisions on its own thread,
    # overlapping the device work; each decision chunk is compared
    # before its bytes can install
    shadow = integrity.maybe_shadow_verifier(
        inputs, history_cutoff_ht, is_major, retain_deletes)
    tombstone_value = Value.tombstone().encode()
    with native_engine.NativeCompactionJob() as job:
        # -- stage A (host): the native shell ingests the inputs on its
        # own thread (file reads, block decode and CRC release the GIL),
        # overlapping the staging + kernel launches below; with every
        # input in the run cache it ingests the retained decoded runs
        ingest = {"rows_in": None, "err": None}

        def _ingest_inputs():
            try:
                pinned = False
                if cached_ids is not None:
                    try:
                        # add_cached pins each run; an entry evicted since
                        # the probe raises, and the job takes the file
                        # path (stray pinned runs are ignored by prepare()
                        # and freed with the job)
                        for rid in cached_ids:
                            job.add_cached(rid)
                        pinned = True
                    except KeyError:
                        pinned = False
                if pinned:
                    ingest["rows_in"] = job.prepare_cached()
                else:
                    for r in inputs:
                        # input boundary: a cancelled job reads no more
                        _check(cancel)
                        with open(r.data_path, "rb") as f:
                            job.add_input(f.read(), r.block_handles)
                        _count_ingest_decode()
                    ingest["rows_in"] = job.prepare()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                ingest["err"] = e

        ingest_thread = threading.Thread(target=_ingest_inputs,
                                         name="compaction-ingest",
                                         daemon=True)
        ingest_thread.start()
        try:
            # -- stage B: resident inputs come from the slab cache; the
            # misses' key columns decode on host threads and upload, then
            # the inputs are re-laid run-major on the card and the merge +
            # GC kernels enqueued
            misses = [i for i, fid in enumerate(
                input_ids or [None] * len(inputs))
                if not (device_cache is not None and fid is not None
                        and device_cache.contains(fid))]
            slabs: dict = {}

            def _read(i):
                slabs[i] = inputs[i].read_all()

            readers = [threading.Thread(target=_read, args=(i,), daemon=True)
                       for i in misses]
            for t in readers:
                t.start()
            for t in readers:
                t.join()

            def _stage_miss(i, fid):
                slab = slabs.pop(i, None)
                if slab is None:   # a reader thread failed: surface it here
                    slab = inputs[i].read_all()
                return (device_cache.stage(fid, slab) if fid is not None
                        else stage_slab(slab, device))

            staged_list = []
            for i, fid in enumerate(input_ids or [None] * len(inputs)):
                _check(cancel)   # before each input's upload
                staged_list.append(_stage_input(
                    fid, device_cache, state,
                    lambda f, i=i: _stage_miss(i, f)))
            staged_runs = run_merge.stage_runs_from_staged(staged_list)
            params = GCParams(history_cutoff_ht, is_major, retain_deletes)
            handle = run_merge.launch_merge_gc(staged_runs, params)
        finally:
            # the thread calls into the C++ job; it MUST finish before any
            # unwind can free the job
            ingest_thread.join()
        if ingest["err"] is not None:
            raise ingest["err"]
        rows_in = ingest["rows_in"]

        # -- stage C: stream the decisions into the shell and write every
        # output file whose survivor span is complete; with a cache each
        # file's span installs as the file hits disk
        fr = _merge_frontiers([r.props.frontier for r in all_inputs],
                              history_cutoff_ht)
        installer = None
        if device_cache is not None:
            installer = _ResidentSpanInstaller(
                device_cache, _out_level(device_cache, input_ids))
            installer.handle = handle
            state["installer"] = installer
        writer = _StreamingNativeWriter(
            job, out_dir, new_file_id, fr, block_entries,
            has_deep=any(r.props.has_deep for r in inputs), cancel=cancel,
            on_span=installer.on_span if installer is not None else None,
            lindex_for_span=(installer.lindex_for_span
                             if installer is not None else None))
        state["writer"] = writer
        tombstones_written = 0
        for perm_c, keep_c, mk_c in handle.result_iter():
            _check(cancel)   # chunk boundary
            surv = perm_c[keep_c]
            mk_surv = mk_c[keep_c]
            # silent-corruption injection point (tests): a flipped
            # decision lands in the SST unless shadow verify is on
            device_faults.maybe_flip_survivors(surv, mk_surv)
            if shadow is not None:
                shadow.check_chunk(surv, mk_surv)
            tombstones_written += int(np.count_nonzero(mk_surv))
            job.append_survivors(surv, mk_surv)
            writer.feed(job.n_survivors)
        rows_out = job.n_survivors
        if shadow is not None:
            shadow.finish(rows_out)   # before the tail files write
        outputs, ranges = writer.finish(rows_out)
        if run_cache is not None:
            # run-cache write-through: the exported survivors are
            # byte-equivalent to re-decoding the files just written, so
            # the next compaction over these outputs starts all-cached
            for (fid, _base, _props), (start, end) in zip(outputs, ranges):
                rid = job.export_run(start, end, tombstone_value)
                run_cache.put(fid, rid,
                              native_engine.runcache_entry_bytes(rid))
    if installer is not None:
        # the spans a chunked stream deferred install here; an unchunked
        # job installed each span as its file hit disk
        installer.finish()
    return CompactionResult(outputs, rows_in + dropped_rows, rows_out,
                            tombstones_written=tombstones_written)


class _DeviceCodecWriter:
    """Stage C of the device-codec job: write output SSTs whose block
    bytes were assembled from the device encode (block_codec.encode_span),
    the shell-free twin of _StreamingNativeWriter.

    File splits, tombstone rewrite and base assembly are those of
    _StreamingNativeWriter, so codec and shell jobs write byte-identical
    files over identical survivor ranges. Each span's cols are gathered
    on the card once (kernels D and E) and shared three ways: the encode
    (kernel F), the learned-index fit (P4) and the write-through
    install."""

    def __init__(self, handle, values, w_out: int, out_dir: str,
                 new_file_id, fr, block_entries: Optional[int],
                 has_deep: bool = False, cancel=None, installer=None):
        self._handle = handle
        self._cancel = cancel
        self._values = values          # every input's value rows, in order
        self._w_out = w_out
        self._out_dir = out_dir
        self._new_file_id = new_file_id
        self._fr = fr
        self._has_deep = has_deep
        self._installer = installer
        self._block_entries = (block_entries if block_entries is not None
                               else flags.get_flag("sst_block_entries"))
        self._max_rows = flags.get_flag(
            "compaction_max_output_entries_per_sst")
        self._tombstone_value = Value.tombstone().encode()
        self._pos_all = None
        self.outputs: List[Tuple[int, str, SSTProps]] = []
        self.ranges: List[Tuple[int, int]] = []

    def _gather_span(self, start: int, end: int):
        from yugabyte_tpu_torch.ops import run_merge
        inst = self._installer
        if inst is not None:
            st = inst._gather_span(start, end)
            # prefill the installer's span cache: the fit and the install
            # after the write reuse this gather
            inst._span_cache[(start, end)] = st
            return st, inst.lindex_for_span(start, end)
        if self._pos_all is None:   # one survivor scan serves every span
            self._pos_all = run_merge.survivor_positions(self._handle)
        return run_merge.gather_staged_output_span(
            self._handle, self._pos_all, start, end), None

    def _write_span(self, surv: np.ndarray, mk: np.ndarray,
                    start: int, end: int, more_coming: bool) -> None:
        from yugabyte_tpu_torch.ops import block_codec
        from yugabyte_tpu_torch.storage.sst import (
            data_file_name, sst_compression_enabled, write_base_file)
        from yugabyte_tpu_torch.utils.env import get_env
        _check(self._cancel)   # file-split boundary
        st, lindex = self._gather_span(start, end)
        vals = self._values.gather(surv[start:end],
                                   replace_mask=mk[start:end],
                                   replacement=self._tombstone_value)
        blocks, index, hashes, fk, lk = block_codec.encode_span(
            st, end - start, self._w_out, vals, self._block_entries,
            compress=sst_compression_enabled())
        fid = self._new_file_id()
        base_path = os.path.join(self._out_dir, f"{fid:06d}.sst")
        data_path = data_file_name(base_path)
        if os.path.exists(data_path):
            os.remove(data_path)   # never append to a stale data file
        df = get_env().open_append(data_path)
        try:
            size = 0
            for blk in blocks:
                df.append(blk)
                size += len(blk)
            df.flush(fsync=True)
        finally:
            df.close()
        props = write_base_file(base_path, index, end - start, hashes,
                                fk, lk, self._fr, size,
                                has_deep=self._has_deep, lindex=lindex)
        self.outputs.append((fid, base_path, props))
        self.ranges.append((start, end))
        if self._installer is not None:
            self._installer.on_span(fid, base_path, start, end)
        _after_output_file(props, more_coming)

    def write_all(self, surv: np.ndarray, mk: np.ndarray, rows_out: int
                  ) -> List[Tuple[int, str, SSTProps]]:
        start = 0
        while start < rows_out:
            end = min(start + self._max_rows, rows_out)
            self._write_span(surv, mk, start, end,
                             more_coming=end < rows_out)
            start = end
        return self.outputs


def _device_codec_attempt(
        inputs, all_inputs, input_ids, dropped_rows: int, out_dir: str,
        new_file_id, history_cutoff_ht: int, is_major: bool,
        retain_deletes: bool, device, block_entries,
        device_cache=None, cancel=None) -> CompactionResult:
    """One attempt of the shell-free device-codec job (decode, merge and
    encode on the card; the host CRC-checks raw bytes, splices values and
    writes files). Unwinds like _device_native_attempt: partial outputs
    deleted, installed entries dropped, zero leaked pins, so a
    BlockCodecUnsupported leaves nothing behind for the shell path."""
    state = {"writer": None, "installer": None, "pins": []}
    try:
        return _device_codec_body(
            inputs, all_inputs, input_ids, dropped_rows, out_dir,
            new_file_id, history_cutoff_ht, is_major, retain_deletes,
            device, block_entries, device_cache, state, cancel)
    except BaseException:
        _unwind_attempt(state)
        raise
    finally:
        _release_pins(state, device_cache)


def _device_codec_body(
        inputs, all_inputs, input_ids, dropped_rows: int, out_dir: str,
        new_file_id, history_cutoff_ht: int, is_major: bool,
        retain_deletes: bool, device, block_entries, device_cache,
        state: dict, cancel=None) -> CompactionResult:
    from yugabyte_tpu_torch.ops import block_codec, device_faults, run_merge
    from yugabyte_tpu_torch.ops.slabs import ValueArray
    from yugabyte_tpu_torch.storage import integrity

    shadow = integrity.maybe_shadow_verifier(
        inputs, history_cutoff_ht, is_major, retain_deletes)

    # -- stage A: raw-byte ingest. One file read, per-block CRC check and
    # zero-copy value slicing per input; key columns decode on the card
    # (kernel C) unless the slab cache already holds them, so no host
    # block decode runs
    staged_list = []
    values_parts = []
    rows_in = 0
    w_out = 1
    for r, fid in zip(inputs, input_ids or [None] * len(inputs)):
        _check(cancel)   # input boundary, like the shell's ingest
        rfb = block_codec.parse_raw_file(r.read_raw(), r.block_handles)
        values_parts.extend(rfb.value_parts)
        rows_in += rfb.n
        w_out = max(w_out, rfb.w)
        staged_list.append(_stage_input(
            fid, device_cache, state,
            lambda f, rfb=rfb: (device_cache.stage_from_raw(f, rfb)
                                if f is not None else
                                block_codec.decode_file_to_staged(
                                    rfb, device))))
    values = ValueArray.concat(values_parts)

    # -- stage B: the same merge + GC launch as the shell path. The
    # per-file and run-major matrices are dropped as soon as the next
    # stage has consumed them: the handle keeps the merged payload
    staged_runs = run_merge.stage_runs_from_staged(staged_list)
    del staged_list
    params = GCParams(history_cutoff_ht, is_major, retain_deletes)
    handle = run_merge.launch_merge_gc(staged_runs, params)
    del staged_runs

    # the decisions drain fully before stage C: the survivor indices
    # drive the host value gather
    surv_parts, mk_parts = [], []
    for perm_c, keep_c, mk_c in handle.result_iter():
        _check(cancel)   # chunk boundary
        surv_c = perm_c[keep_c]
        mk_surv = mk_c[keep_c]
        device_faults.maybe_flip_survivors(surv_c, mk_surv)
        if shadow is not None:
            shadow.check_chunk(surv_c, mk_surv)
        surv_parts.append(surv_c)
        mk_parts.append(mk_surv)
    # one part for an unchunked launch: no concatenating copy
    surv = (surv_parts[0] if len(surv_parts) == 1
            else np.concatenate(surv_parts) if surv_parts
            else np.zeros(0, dtype=np.int64))
    mk = (mk_parts[0] if len(mk_parts) == 1
          else np.concatenate(mk_parts) if mk_parts
          else np.zeros(0, dtype=bool))
    rows_out = int(surv.shape[0])
    if shadow is not None:
        shadow.finish(rows_out)

    # -- stage C: device gather + encode, host value splice, per span
    fr = _merge_frontiers([r.props.frontier for r in all_inputs],
                          history_cutoff_ht)
    installer = None
    if device_cache is not None:
        installer = _ResidentSpanInstaller(
            device_cache, _out_level(device_cache, input_ids))
        installer.handle = handle
        state["installer"] = installer
    writer = _DeviceCodecWriter(
        handle, values, w_out, out_dir, new_file_id, fr, block_entries,
        has_deep=any(r.props.has_deep for r in inputs), cancel=cancel,
        installer=installer)
    state["writer"] = writer
    outputs = writer.write_all(surv, mk, rows_out)
    if installer is not None:
        installer.finish()
    return CompactionResult(outputs, rows_in + dropped_rows, rows_out,
                            tombstones_written=int(np.count_nonzero(mk)))


class _DistResidentInstaller:
    """Write-through installer of the mesh job: as each output file's SST
    hits disk, its survivor span is gathered from the SHARDED device
    outputs (parallel/dist_compact.DistOutputs.gather_span: the merged
    cols never come back to the host) and installed under the output id,
    digest-sampled like the single-device installer."""

    def __init__(self, device_cache, level: int, outputs_dev):
        self.device_cache = device_cache
        self.level = level
        self._outputs = outputs_dev
        self.installed: List[int] = []

    def on_span(self, fid: int, base_path: str, start: int, end: int
                ) -> None:
        from yugabyte_tpu_torch.storage import integrity
        st = self._outputs.gather_span(start, end)
        if not integrity.maybe_verify_resident_entry(st, base_path):
            return  # digest mismatch: the next reader re-stages from bytes
        self.device_cache.put(fid, st, level=self.level)
        self.installed.append(fid)

    def unwind(self) -> None:
        for fid in self.installed:
            self.device_cache.drop(fid)
        self.installed = []


def run_compaction_job_dist_native(
        inputs: Sequence[SSTReader], out_dir: str, new_file_id,
        history_cutoff_ht: int, is_major: bool,
        retain_deletes: bool = False, device=None,
        block_entries: Optional[int] = None, device_cache=None,
        input_ids: Optional[Sequence[int]] = None, mesh=None,
        cancel=None) -> CompactionResult:
    """The mesh path: key-range-sharded merge + GC decisions
    (parallel/dist_compact.distributed_compact_with_outputs) with the
    native byte shell around them.

    Stage A ingests the input bytes into the C++ shell on its own thread,
    overlapping `read_all` + `concat_slabs` + the distributed step; only
    the decision-sized arrays come down (the merged cols stay on the
    mesh's devices); _StreamingNativeWriter writes the outputs, with the
    split and tombstone rules of the single-device job, so the files are
    byte-identical to it. With a device cache, each output's span is
    gathered from the sharded outputs and installed under its id
    (_DistResidentInstaller) at one level above the deepest input. The
    shards run on the mesh's devices; a `device` given must be of their
    type ("cuda" for a mesh of cards, "cpu" for a CPU mesh), or the job
    raises. cancel: checked at each input of the ingest, before the
    survivors go to the shell and at each output file; a cancelled job
    unwinds (files deleted, entries dropped) and raises.

    The (n_shards, capacity) bucket is gated on the health board
    ("dist_compact"), and a device fault or shadow mismatch is contained
    as in run_compaction_job_device_native: every output file written is
    deleted and every entry installed dropped, the bucket quarantined,
    and the job completed by the native CompactionJob, byte-identical."""
    import time
    from yugabyte_tpu_torch.ops import device_faults
    from yugabyte_tpu_torch.ops.merge_gc import bucket_size
    from yugabyte_tpu_torch.ops.slabs import concat_slabs
    from yugabyte_tpu_torch.parallel.dist_compact import (
        _quantized_capacity, distributed_compact_with_outputs)
    from yugabyte_tpu_torch.storage import integrity, native_engine
    from yugabyte_tpu_torch.storage.bucket_health import health_board
    from yugabyte_tpu_torch.utils.torch_setup import resolve_device
    from yugabyte_tpu_torch.utils.trace import TRACE

    _check(cancel)
    if device is not None:
        kind = resolve_device(device).type
        if any(d.type != kind for d in mesh.devices.flat):
            raise ValueError(f"run_compaction_job_dist_native: device "
                             f"{device} is not the mesh's "
                             f"({list(mesh.devices.flat)})")
    all_inputs = list(inputs)
    inputs, dropped = filter_expired_inputs(
        all_inputs, history_cutoff_ht, is_major, retain_deletes)
    dropped_rows = sum(r.props.n_entries for r in dropped)
    inputs = [r for r in inputs if r.props.n_entries]
    if not inputs:
        return CompactionResult([], dropped_rows, 0)
    input_ids = _realign_ids(all_inputs, input_ids, inputs)
    n_shards = mesh.devices.size
    est_rows = sum(r.props.n_entries for r in inputs)
    bucket = (n_shards, _quantized_capacity(
        bucket_size(est_rows) // n_shards, n_shards, 2.0))
    board = health_board()
    if not board.allow_device("dist_compact", bucket):
        # the bucket is parked (fault quarantine / sticky mismatch /
        # degraded without a probe slot): the native job, byte-identical
        TRACE("compaction: dist bucket n_shards=%d capacity=%d is "
              "parked by the health board — routing native", *bucket)
        t0 = time.monotonic()
        result = _run_native_job(inputs, out_dir, new_file_id,
                                 history_cutoff_ht, is_major,
                                 retain_deletes, block_entries,
                                 frontier_inputs=all_inputs, cancel=cancel)
        result.rows_in += dropped_rows
        board.record_native("dist_compact", bucket, result.rows_in,
                            time.monotonic() - t0)
        return result
    t_job = time.monotonic()
    w0 = integrity.shadow_wait_s()
    shadow = integrity.maybe_shadow_verifier(
        inputs, history_cutoff_ht, is_major, retain_deletes)
    params = GCParams(history_cutoff_ht, is_major, retain_deletes)
    state = {"writer": None, "installer": None}
    try:
        with native_engine.NativeCompactionJob() as job:
            ingest = {"rows_in": None, "err": None}

            def _ingest_inputs():
                try:
                    for r in inputs:
                        _check(cancel)   # input boundary
                        with open(r.data_path, "rb") as f:
                            job.add_input(f.read(), r.block_handles)
                        _count_ingest_decode()
                    ingest["rows_in"] = job.prepare()
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    ingest["err"] = e

            ingest_thread = threading.Thread(
                target=_ingest_inputs, name="dist-compaction-ingest",
                daemon=True)
            ingest_thread.start()
            try:
                merged = concat_slabs([s for s in (r.read_all()
                                                   for r in inputs) if s.n])
                bucket = (n_shards, _quantized_capacity(
                    bucket_size(merged.n) // n_shards, n_shards, 2.0))
                keep, mk, src_idx, outputs_dev = \
                    distributed_compact_with_outputs(merged, params, mesh)
                bucket = outputs_dev.bucket_key()
                del merged
            finally:
                # the thread calls into the C++ job; it MUST finish
                # before any unwind can free the job
                ingest_thread.join()
            if ingest["err"] is not None:
                raise ingest["err"]
            rows_in = ingest["rows_in"]
            surv = src_idx[keep]
            mk_surv = mk[keep]
            device_faults.maybe_flip_survivors(surv, mk_surv)
            if shadow is not None:
                shadow.check_chunk(surv, mk_surv)
            rows_out = int(surv.shape[0])
            if shadow is not None:
                shadow.finish(rows_out)
            fr = _merge_frontiers([r.props.frontier for r in all_inputs],
                                  history_cutoff_ht)
            installer = None
            if device_cache is not None:
                installer = _DistResidentInstaller(
                    device_cache, _out_level(device_cache, input_ids),
                    outputs_dev)
                state["installer"] = installer
            else:
                del outputs_dev
            writer = _StreamingNativeWriter(
                job, out_dir, new_file_id, fr, block_entries, has_deep=False,
                cancel=cancel,
                on_span=installer.on_span if installer is not None
                else None)
            state["writer"] = writer
            _check(cancel)
            job.set_survivors(surv, mk_surv)
            outputs, _ranges = writer.finish(job.n_survivors)
    except BaseException as e:
        _unwind_attempt(state)
        if not (isinstance(e, Exception)
                and _contain(e, board, "dist_compact", bucket)):
            raise
        t1 = time.monotonic()
        result = _run_native_job(inputs, out_dir, new_file_id,
                                 history_cutoff_ht, is_major,
                                 retain_deletes, block_entries,
                                 frontier_inputs=all_inputs, cancel=cancel)
        result.rows_in += dropped_rows
        board.record_native("dist_compact", bucket, result.rows_in,
                            time.monotonic() - t1)
        return result
    board.record_device("dist_compact", bucket, rows_in + dropped_rows,
                        time.monotonic() - t_job
                        - (integrity.shadow_wait_s() - w0))
    return CompactionResult(outputs, rows_in + dropped_rows, rows_out,
                            tombstones_written=int(np.count_nonzero(mk_surv)))


def run_compaction_job_with_decisions(
        inputs: Sequence[SSTReader], slabs: Sequence[KVSlab], out_dir: str,
        new_file_id, history_cutoff_ht: int, is_major: bool,
        retain_deletes: bool, block_entries: Optional[int],
        surv: np.ndarray, mk_surv: np.ndarray, rows_in: int,
        frontier_inputs: Optional[Sequence[SSTReader]] = None,
        cancel=None, on_span=None) -> CompactionResult:
    """Write a compaction job's outputs from decisions computed elsewhere:
    stage C of a pooled wave slot (parallel/dist_compact.pooled_merge_gc).

    The byte path is the sequential writer's: the native shell +
    _StreamingNativeWriter where the shell can run the bytes, else the
    `_gather_slab` + SSTWriter loop, so the outputs are byte-identical to a
    sequential job over the same inputs. inputs: the filtered reader list;
    slabs: their read_all() slabs (the Python writer's input); surv indexes
    the concatenation of the live slabs in input order, in merged order.
    on_span(fid, base_path, start, end) runs after each output file.
    cancel: checked at each input and each output file; the files written
    are deleted when it trips. The rate limiter paces between files."""
    from yugabyte_tpu_torch.ops.slabs import concat_slabs

    fr = _merge_frontiers(
        [r.props.frontier for r in (frontier_inputs or inputs)],
        history_cutoff_ht)
    has_deep = any(r.props.has_deep for r in inputs)
    rows_out = int(surv.shape[0])
    tombstones = int(np.count_nonzero(mk_surv))
    if _shell_can_run() and not has_deep:
        from yugabyte_tpu_torch.storage import native_engine
        with native_engine.NativeCompactionJob() as job:
            for r in inputs:
                _check(cancel)
                with open(r.data_path, "rb") as f:
                    job.add_input(f.read(), r.block_handles)
                _count_ingest_decode()
            job.prepare()
            job.set_survivors(surv, mk_surv)
            writer = _StreamingNativeWriter(
                job, out_dir, new_file_id, fr, block_entries,
                has_deep=has_deep, cancel=cancel, on_span=on_span)
            try:
                outputs, _ranges = writer.finish(job.n_survivors)
            except BaseException:
                _remove_outputs(writer)
                raise
        return CompactionResult(outputs, rows_in, rows_out,
                                tombstones_written=tombstones)
    # the Python writer: run_compaction_job's Python path over the same
    # decisions
    merged = concat_slabs([s for s in slabs if s.n])
    max_rows = flags.get_flag("compaction_max_output_entries_per_sst")
    tombstone_value = Value.tombstone().encode()
    outputs: List[Tuple[int, str, SSTProps]] = []
    try:
        for start in range(0, rows_out, max_rows):
            _check(cancel)
            end = min(start + max_rows, rows_out)
            out_slab = _gather_slab(merged, surv[start:end],
                                    mk_surv[start:end], tombstone_value)
            fid = new_file_id()
            base_path = os.path.join(out_dir, f"{fid:06d}.sst")
            props = SSTWriter(base_path, block_entries=block_entries,
                              fit_lindex=False).write(out_slab, fr)
            outputs.append((fid, base_path, props))
            if on_span is not None:
                on_span(fid, base_path, start, end)
            _after_output_file(props, end < rows_out)
    except BaseException:
        _remove_files(outputs)
        raise
    return CompactionResult(outputs, rows_in, rows_out,
                            tombstones_written=tombstones)


def _merge_frontiers(frontiers: Sequence[Frontier],
                     history_cutoff: int) -> Frontier:
    live = [f for f in frontiers if f is not None]
    if not live:
        return Frontier(history_cutoff=history_cutoff)
    return Frontier(
        op_id_min=min(f.op_id_min for f in live),
        op_id_max=max(f.op_id_max for f in live),
        ht_min=min(f.ht_min for f in live),
        ht_max=max(f.ht_max for f in live),
        history_cutoff=max(history_cutoff,
                           max(f.history_cutoff for f in live)),
    )
