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

Not ported yet, each raising NotImplementedError naming its ROADMAP
queue A item: the offload policy (health-board routing and device-fault
containment), cancellation and the compaction rate limiter (the DB's
remaining entry points), an encrypted Env (the encrypted Env and
FaultInjectionEnv). The bucket-health routing, the device-fault
containment that re-runs natively and the sampled shadow verifier are
queue A items too: here a device error propagates.
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
from yugabyte_tpu_torch.utils import flags

flags.define_flag("compaction_max_output_entries_per_sst", 2_000_000,
                  "split compaction output files at this row count")
flags.define_flag("compaction_rate_bytes_per_sec", 0,
                  "token-bucket cap on compaction output bytes/sec; "
                  "0 = unlimited (the limiter is ROADMAP queue A: the "
                  "DB's remaining entry points)")
flags.define_flag("distributed_compaction_min_rows", 1 << 20,
                  "jobs at or above this many input rows fan their "
                  "subcompactions across the device mesh when one is "
                  "available (ref: subcompaction sizing, "
                  "compaction_job.cc:330 GenSubcompactionBoundaries)")


_TITLE_HEALTH = "ROADMAP queue A: health-board routing and device-fault " \
    "containment"
_TITLE_DB = "ROADMAP queue A: the DB's remaining entry points"
_TITLE_ENV = "ROADMAP queue A: the encrypted Env and FaultInjectionEnv"


def _check_ported(offload_policy=None, cancel=None) -> None:
    """Raise NotImplementedError, naming the ROADMAP queue A item, for
    every argument and setting of the JAX package's job that the port
    does not have yet."""
    from yugabyte_tpu_torch.utils.env import get_env
    if offload_policy is not None:
        raise NotImplementedError(f"offload_policy: {_TITLE_HEALTH}")
    if cancel is not None:
        raise NotImplementedError(
            f"cancel: compaction cancellation is {_TITLE_DB}")
    if flags.get_flag("compaction_rate_bytes_per_sec") > 0:
        raise NotImplementedError(
            f"compaction_rate_bytes_per_sec: the compaction rate limiter is "
            f"{_TITLE_DB}")
    if get_env().encrypted:
        raise NotImplementedError(
            f"compaction under an encrypted Env: {_TITLE_ENV} (the JAX "
            f"package's encrypted Env needs the cryptography package)")


# native-shell file ingests (each input read and decoded from its SST by
# the C++ shell), process-wide: a warm chained job ingests every input
# from the run cache and must add none
_ingest_lock = threading.Lock()
_ingest_decodes = 0   # guarded-by: _ingest_lock


def ingest_decodes() -> int:
    """Native-shell file ingests so far in this process."""
    with _ingest_lock:
        return _ingest_decodes


def _count_ingest_decode() -> None:
    global _ingest_decodes
    with _ingest_lock:
        _ingest_decodes += 1


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
    byte-identical over identical ranges."""

    def __init__(self, job, out_dir: str, new_file_id, fr,
                 block_entries: Optional[int], has_deep: bool = False,
                 on_span=None, lindex_for_span=None):
        self._job = job
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

    def _write_span(self, start: int, end: int) -> None:
        from yugabyte_tpu_torch.storage.sst import (
            data_file_name, sst_compression_enabled, write_base_file)
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

    def feed(self, n_available: int) -> None:
        # strictly >: an exactly-full final span must come from finish()
        while n_available - self._next_start > self._max_rows:
            self._write_span(self._next_start,
                             self._next_start + self._max_rows)
            self._next_start += self._max_rows

    def finish(self, rows_out: int
               ) -> Tuple[List[Tuple[int, str, SSTProps]],
                          List[Tuple[int, int]]]:
        start = self._next_start
        while start < rows_out:
            end = min(start + self._max_rows, rows_out)
            self._write_span(start, end)
            start = end
        self._next_start = start
        return self.outputs, self.ranges


def _write_native_outputs(job, out_dir: str, new_file_id, fr,
                          block_entries: Optional[int],
                          has_deep: bool = False
                          ) -> Tuple[List[Tuple[int, str, SSTProps]],
                                     List[Tuple[int, int]]]:
    """Write the native job's survivors as (possibly split) output SSTs:
    the everything-already-available form of _StreamingNativeWriter.
    Returns (outputs, ranges)."""
    writer = _StreamingNativeWriter(job, out_dir, new_file_id, fr,
                                    block_entries, has_deep=has_deep)
    return writer.finish(job.n_survivors)


def _run_native_job(inputs: Sequence[SSTReader], out_dir: str, new_file_id,
                    history_cutoff_ht: int, is_major: bool,
                    retain_deletes: bool, block_entries: Optional[int],
                    frontier_inputs: Optional[Sequence[SSTReader]] = None
                    ) -> CompactionResult:
    """Full-native compaction, the stock CompactionJob: the byte path
    (decode/merge/encode) runs in C++ (native/compaction_engine.cc);
    Python assembles base files and frontiers."""
    from yugabyte_tpu_torch.storage import native_engine

    with native_engine.NativeCompactionJob() as job:
        for r in inputs:
            with open(r.data_path, "rb") as f:
                job.add_input(f.read(), r.block_handles)
        rows_in = job.prepare()
        rows_out = job.merge(history_cutoff_ht, is_major, retain_deletes)
        fr = _merge_frontiers(
            [r.props.frontier for r in (frontier_inputs or inputs)],
            history_cutoff_ht)
        outputs, _ranges = _write_native_outputs(
            job, out_dir, new_file_id, fr, block_entries,
            has_deep=any(r.props.has_deep for r in inputs))
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
    across its shards (parallel/dist_compact.py). offload_policy and
    cancel raise NotImplementedError (see _check_ported)."""
    _check_ported(offload_policy, cancel)
    all_inputs = list(inputs)
    orig_input_ids = list(input_ids) if input_ids is not None else None
    if device is not None and device != "native" and not _no_combined:
        # the production path: device decisions + the codec or the C++
        # byte shell, for depth-2 inputs without the radix override; the
        # device-native job re-enters below for skewed picks
        from yugabyte_tpu_torch.ops import run_merge
        from yugabyte_tpu_torch.storage import native_engine
        if (native_engine.available() and not run_merge.force_radix()
                and not any(r.props.has_deep for r in all_inputs)):
            if _wants_distributed(
                    mesh, sum(r.props.n_entries for r in all_inputs)):
                # mesh-sized job: distributed decisions + the same native
                # byte shell / streaming writer as the single-device job
                return run_compaction_job_dist_native(
                    all_inputs, out_dir, new_file_id, history_cutoff_ht,
                    is_major, retain_deletes, device=device,
                    block_entries=block_entries, device_cache=device_cache,
                    input_ids=orig_input_ids, mesh=mesh)
            return run_compaction_job_device_native(
                all_inputs, out_dir, new_file_id, history_cutoff_ht,
                is_major, retain_deletes, device=device,
                block_entries=block_entries, device_cache=device_cache,
                input_ids=orig_input_ids, run_cache=run_cache)
    inputs, dropped = filter_expired_inputs(
        all_inputs, history_cutoff_ht, is_major, retain_deletes)
    dropped_rows = sum(r.props.n_entries for r in dropped)
    input_ids = _realign_ids(all_inputs, input_ids, inputs)
    if not inputs:
        return CompactionResult([], dropped_rows, 0)
    if device == "native":
        from yugabyte_tpu_torch.storage import native_engine
        if native_engine.available():
            result = _run_native_job(inputs, out_dir, new_file_id,
                                     history_cutoff_ht, is_major,
                                     retain_deletes, block_entries,
                                     frontier_inputs=all_inputs)
            result.rows_in += dropped_rows
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
    for start in range(0, rows_out, max_rows):
        end = min(start + max_rows, rows_out)
        out_slab = _gather_slab(merged, surv[start:end],
                                tomb_flags[start:end], tombstone_value)
        fid = new_file_id()
        base_path = os.path.join(out_dir, f"{fid:06d}.sst")
        # fit_lindex=False: byte-identical to the native writer's outputs
        props = SSTWriter(base_path, block_entries=block_entries,
                          fit_lindex=False).write(out_slab, fr)
        outputs.append((fid, base_path, props))
        if device_cache is not None:
            # write-through for the next pick, one level above the
            # deepest input
            device_cache.stage(fid, out_slab, level=out_level)
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
        run_cache=None) -> CompactionResult:
    """The production hot path: CUDA decisions, with the device block
    codec (the default) or the native byte shell (YBTPU_DEVICE_CODEC=0,
    a job the codec cannot take, or a job whose every input the run cache
    holds) around them.

    device: 'cuda' (the default) or 'cpu' (the kernels' plain PyTorch
    versions; the tests). Without a GPU and without device='cpu' it
    raises. A skewed pick (run-layout inflation past 2x) or a deep input
    re-enters run_compaction_job's Python path (the radix re-sort, or the
    native merge). device_cache + input_ids: the resident chain (see the
    module docstring); run_cache: the native run cache."""
    from yugabyte_tpu_torch.ops import block_codec, run_merge
    from yugabyte_tpu_torch.utils.torch_setup import resolve_device

    dev = resolve_device(device)
    _check_ported()
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
                                  _no_combined=True)
    # The device codec takes the cold byte path: when the run cache holds
    # every input the shell ingests with zero decode (and its export keeps
    # the chain warm), so the shell keeps those jobs
    all_run_cached = bool(
        run_cache is not None and input_ids is not None
        and all(run_cache.contains(fid) for fid in input_ids))
    if block_codec.codec_enabled() and not all_run_cached:
        try:
            return _device_codec_attempt(
                inputs, all_inputs, input_ids, dropped_rows, out_dir,
                new_file_id, history_cutoff_ht, is_major, retain_deletes,
                dev, block_entries, device_cache)
        except block_codec.BlockCodecUnsupported:
            pass   # the native byte shell takes the job
    return _device_native_attempt(
        inputs, all_inputs, input_ids, dropped_rows, out_dir, new_file_id,
        history_cutoff_ht, is_major, retain_deletes, dev, block_entries,
        device_cache, run_cache)


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
        run_cache=None) -> CompactionResult:
    """One attempt of the pipelined device+native job. UNWINDS CLEANLY on
    any failure: every output file it wrote is deleted and every cache
    entry it installed dropped before the exception propagates, and the
    inputs it pinned are unpinned on every exit."""
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
            state)
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
        run_cache, cached_ids, state: dict) -> CompactionResult:
    from yugabyte_tpu_torch.ops import run_merge
    from yugabyte_tpu_torch.ops.merge_gc import stage_slab
    from yugabyte_tpu_torch.storage import native_engine

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

            staged_list = [
                _stage_input(fid, device_cache, state,
                             lambda f, i=i: _stage_miss(i, f))
                for i, fid in enumerate(input_ids or [None] * len(inputs))]
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
            has_deep=any(r.props.has_deep for r in inputs),
            on_span=installer.on_span if installer is not None else None,
            lindex_for_span=(installer.lindex_for_span
                             if installer is not None else None))
        state["writer"] = writer
        tombstones_written = 0
        for perm_c, keep_c, mk_c in handle.result_iter():
            surv = perm_c[keep_c]
            mk_surv = mk_c[keep_c]
            tombstones_written += int(np.count_nonzero(mk_surv))
            job.append_survivors(surv, mk_surv)
            writer.feed(job.n_survivors)
        rows_out = job.n_survivors
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
                 has_deep: bool = False, installer=None):
        self._handle = handle
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
                    start: int, end: int) -> None:
        from yugabyte_tpu_torch.ops import block_codec
        from yugabyte_tpu_torch.storage.sst import (
            data_file_name, sst_compression_enabled, write_base_file)
        from yugabyte_tpu_torch.utils.env import get_env
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

    def write_all(self, surv: np.ndarray, mk: np.ndarray, rows_out: int
                  ) -> List[Tuple[int, str, SSTProps]]:
        start = 0
        while start < rows_out:
            end = min(start + self._max_rows, rows_out)
            self._write_span(surv, mk, start, end)
            start = end
        return self.outputs


def _device_codec_attempt(
        inputs, all_inputs, input_ids, dropped_rows: int, out_dir: str,
        new_file_id, history_cutoff_ht: int, is_major: bool,
        retain_deletes: bool, device, block_entries,
        device_cache=None) -> CompactionResult:
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
            device, block_entries, device_cache, state)
    except BaseException:
        _unwind_attempt(state)
        raise
    finally:
        _release_pins(state, device_cache)


def _device_codec_body(
        inputs, all_inputs, input_ids, dropped_rows: int, out_dir: str,
        new_file_id, history_cutoff_ht: int, is_major: bool,
        retain_deletes: bool, device, block_entries, device_cache,
        state: dict) -> CompactionResult:
    from yugabyte_tpu_torch.ops import block_codec, run_merge
    from yugabyte_tpu_torch.ops.slabs import ValueArray

    # -- stage A: raw-byte ingest. One file read, per-block CRC check and
    # zero-copy value slicing per input; key columns decode on the card
    # (kernel C) unless the slab cache already holds them, so no host
    # block decode runs
    staged_list = []
    values_parts = []
    rows_in = 0
    w_out = 1
    for r, fid in zip(inputs, input_ids or [None] * len(inputs)):
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
    perm, keep, mk_all = handle.result()
    surv = perm[keep]
    mk = mk_all[keep]
    rows_out = int(surv.shape[0])

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
        has_deep=any(r.props.has_deep for r in inputs), installer=installer)
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
    raises. cancel raises NotImplementedError (see _check_ported); a
    device error propagates, and every output file written is deleted
    and every entry installed dropped first."""
    from yugabyte_tpu_torch.ops.slabs import concat_slabs
    from yugabyte_tpu_torch.parallel.dist_compact import (
        distributed_compact_with_outputs)
    from yugabyte_tpu_torch.storage import native_engine
    from yugabyte_tpu_torch.utils.torch_setup import resolve_device

    _check_ported(cancel=cancel)
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
    params = GCParams(history_cutoff_ht, is_major, retain_deletes)
    state = {"writer": None, "installer": None}
    try:
        with native_engine.NativeCompactionJob() as job:
            ingest = {"rows_in": None, "err": None}

            def _ingest_inputs():
                try:
                    for r in inputs:
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
                keep, mk, src_idx, outputs_dev = \
                    distributed_compact_with_outputs(merged, params, mesh)
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
            rows_out = int(surv.shape[0])
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
                on_span=installer.on_span if installer is not None
                else None)
            state["writer"] = writer
            job.set_survivors(surv, mk_surv)
            outputs, _ranges = writer.finish(job.n_survivors)
    except BaseException:
        _unwind_attempt(state)
        raise
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
    cancel raises NotImplementedError (see _check_ported)."""
    from yugabyte_tpu_torch.ops.slabs import concat_slabs
    from yugabyte_tpu_torch.storage import native_engine

    _check_ported(cancel=cancel)
    fr = _merge_frontiers(
        [r.props.frontier for r in (frontier_inputs or inputs)],
        history_cutoff_ht)
    has_deep = any(r.props.has_deep for r in inputs)
    rows_out = int(surv.shape[0])
    tombstones = int(np.count_nonzero(mk_surv))
    if native_engine.available() and not has_deep:
        with native_engine.NativeCompactionJob() as job:
            for r in inputs:
                with open(r.data_path, "rb") as f:
                    job.add_input(f.read(), r.block_handles)
                _count_ingest_decode()
            job.prepare()
            job.set_survivors(surv, mk_surv)
            writer = _StreamingNativeWriter(
                job, out_dir, new_file_id, fr, block_entries,
                has_deep=has_deep, on_span=on_span)
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
