"""The compaction job: device merge+GC decisions + the native byte shell.

Counterpart of yugabyte_tpu/storage/compaction.py, slice 1 of the port:
`run_compaction_job_device_native` (compaction.py:560 there), the
production L0->L1 path, in the configuration with the device block codec
off (YBTPU_DEVICE_CODEC=0 there), no HBM slab cache and no run cache:

  stage A (host thread): the native shell (native/compaction_engine.cc)
          reads and decodes the input SSTs;
  stage B: the inputs' key columns are decoded on host threads, uploaded
          (merge_gc.stage_slab), re-laid run-major on the card
          (run_merge.stage_runs_from_staged) and merged + GC'd by the CUDA
          kernels (run_merge.launch_merge_gc);
  stage C: the packed decisions stream into the shell, which writes the
          output SSTs (_StreamingNativeWriter).

Outputs are byte-identical to the stock native CompactionJob
(`_run_native_job`) and to the JAX package's job over the same inputs.

Not ported yet, each raising NotImplementedError naming its later slice:
device and run caches, run layouts past 2x inflation (the radix re-sort),
deep documents, an encrypted Env. The bucket-health routing, the
device-fault containment that re-runs natively and the sampled shadow
verifier are later slices too: here a device error propagates.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from yugabyte_tpu_torch.docdb.value import Value
from yugabyte_tpu_torch.ops.merge_gc import GCParams
from yugabyte_tpu_torch.storage.sst import Frontier, SSTProps, SSTReader
from yugabyte_tpu_torch.utils import flags

flags.define_flag("compaction_max_output_entries_per_sst", 2_000_000,
                  "split compaction output files at this row count")


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
                 block_entries: Optional[int], has_deep: bool = False):
        self._job = job
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
        props = write_base_file(base_path, index, end - start, hashes,
                                fk, lk, self._fr, size,
                                has_deep=self._has_deep)
        self.outputs.append((fid, base_path, props))
        self.ranges.append((start, end))

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


def run_compaction_job_device_native(
        inputs: Sequence[SSTReader], out_dir: str, new_file_id,
        history_cutoff_ht: int, is_major: bool,
        retain_deletes: bool = False, device=None,
        block_entries: Optional[int] = None, device_cache=None,
        run_cache=None) -> CompactionResult:
    """The production hot path: CUDA decisions + the native byte shell.

    device: 'cuda' (the default) or 'cpu' (the kernels' plain PyTorch
    versions; the tests). Without a GPU and without device='cpu' it
    raises. device_cache and run_cache must be None in this slice."""
    from yugabyte_tpu_torch.ops import run_merge
    from yugabyte_tpu_torch.utils.env import get_env
    from yugabyte_tpu_torch.utils.torch_setup import resolve_device

    dev = resolve_device(device)
    if device_cache is not None or run_cache is not None:
        raise NotImplementedError(
            "device slab cache / native run cache: a later slice of the "
            "port (write-through with the survivor-gather kernels)")
    if get_env().encrypted:
        raise NotImplementedError(
            "compaction under an encrypted Env: a later slice of the port")
    all_inputs = list(inputs)
    if any(r.props.has_deep for r in all_inputs):
        raise NotImplementedError(
            "deep documents (FLAG_DEEP) need the native overwrite-stack "
            "routing of run_compaction_job: a later slice of the port")
    inputs, dropped = filter_expired_inputs(
        all_inputs, history_cutoff_ht, is_major, retain_deletes)
    dropped_rows = sum(r.props.n_entries for r in dropped)
    inputs = [r for r in inputs if r.props.n_entries]
    if not inputs:
        return CompactionResult([], dropped_rows, 0)
    if run_merge.run_layout_inflation(
            [r.props.n_entries for r in inputs]) > 2.0:
        raise NotImplementedError(
            "run layout inflation > 2: the radix re-sort (sort_and_gc) is "
            "a later slice of the port")
    return _device_native_attempt(
        inputs, all_inputs, dropped_rows, out_dir, new_file_id,
        history_cutoff_ht, is_major, retain_deletes, dev, block_entries)


def _device_native_attempt(
        inputs, all_inputs, dropped_rows: int, out_dir: str, new_file_id,
        history_cutoff_ht: int, is_major: bool, retain_deletes: bool,
        device, block_entries) -> CompactionResult:
    """One attempt of the pipelined device+native job. UNWINDS CLEANLY on
    any failure: every output file it wrote is deleted before the
    exception propagates."""
    state = {"writer": None}
    try:
        return _device_native_body(
            inputs, all_inputs, dropped_rows, out_dir, new_file_id,
            history_cutoff_ht, is_major, retain_deletes, device,
            block_entries, state)
    except BaseException:
        w = state["writer"]
        if w is not None:
            from yugabyte_tpu_torch.storage.sst import data_file_name
            for _fid, base_path, _props in w.outputs:
                for p in (base_path, data_file_name(base_path)):
                    try:
                        os.remove(p)
                    except OSError:  # the file may not exist yet
                        pass
        raise


def _device_native_body(
        inputs, all_inputs, dropped_rows: int, out_dir: str, new_file_id,
        history_cutoff_ht: int, is_major: bool, retain_deletes: bool,
        device, block_entries, state: dict) -> CompactionResult:
    from yugabyte_tpu_torch.ops import run_merge
    from yugabyte_tpu_torch.ops.merge_gc import stage_slab
    from yugabyte_tpu_torch.storage import native_engine

    with native_engine.NativeCompactionJob() as job:
        # -- stage A (host): the native shell ingests the input bytes on
        # its own thread (file reads, block decode and CRC release the
        # GIL), overlapping the staging + kernel launches below
        ingest = {"rows_in": None, "err": None}

        def _ingest_inputs():
            try:
                for r in inputs:
                    with open(r.data_path, "rb") as f:
                        job.add_input(f.read(), r.block_handles)
                ingest["rows_in"] = job.prepare()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                ingest["err"] = e

        ingest_thread = threading.Thread(target=_ingest_inputs,
                                         name="compaction-ingest",
                                         daemon=True)
        ingest_thread.start()
        try:
            # -- stage B: decode the inputs' key columns on host threads,
            # upload each, re-lay them run-major on the card and enqueue
            # the merge + GC kernels
            slabs: dict = {}

            def _read(i):
                slabs[i] = inputs[i].read_all()

            readers = [threading.Thread(target=_read, args=(i,), daemon=True)
                       for i in range(len(inputs))]
            for t in readers:
                t.start()
            for t in readers:
                t.join()
            staged_list = []
            for i, r in enumerate(inputs):
                slab = slabs.get(i)
                if slab is None:   # a reader thread failed: surface it here
                    slab = r.read_all()
                staged_list.append(stage_slab(slab, device))
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
        # output file whose survivor span is complete
        fr = _merge_frontiers([r.props.frontier for r in all_inputs],
                              history_cutoff_ht)
        writer = _StreamingNativeWriter(
            job, out_dir, new_file_id, fr, block_entries,
            has_deep=any(r.props.has_deep for r in inputs))
        state["writer"] = writer
        tombstones_written = 0
        for perm_c, keep_c, mk_c in handle.result_iter():
            surv = perm_c[keep_c]
            mk_surv = mk_c[keep_c]
            tombstones_written += int(np.count_nonzero(mk_surv))
            job.append_survivors(surv, mk_surv)
            writer.feed(job.n_survivors)
        rows_out = job.n_survivors
        outputs, _ranges = writer.finish(rows_out)
    return CompactionResult(outputs, rows_in + dropped_rows, rows_out,
                            tombstones_written=tombstones_written)


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
