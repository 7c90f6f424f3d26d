#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (yugabyte_tpu_torch) on one GPU.

Drives the port's main paths over a YCSB-A tablet — disk-to-disk L0->L1
compaction through `storage.compaction.run_compaction_job_device_native`
on its default device-codec path and on its native-shell path
(YBTPU_DEVICE_CODEC=0), chunked and skewed picks through the router
`storage.compaction.run_compaction_job`, and the snapshot scan `ops.scan.
visible_entries_sources`, the DB's own entry points (scheduled
compactions, scans, checkpoint, cancellation, the compaction pool), the
tablet and the tablet replicated three ways by Raft — and holds every
CUDA kernel of those paths against its plain PyTorch version, the
compaction decisions against the native C++ heap-merge oracle and the
scan against the native host scan.
Imports nothing of JAX.

Phases (any failure exits non-zero):
  1. name the card (nvidia-smi name and power limit);
  2. build the CUDA kernels (nvcc, sm_90a) and the native shell (g++),
     one compiler process per source, all started together;
  3. kernels A and B at the main path's shapes: a 10M-row YCSB-A tablet
     in 4 sorted L0 runs (key space n/2, 5% row tombstones, 19-byte
     column keys -> w = 8, cutoff above all writes, major compaction):
     m = 2^22, k_pad = 4, n_pad = 2^24. Kernel A (merge-path level) ==
     its plain version at each level, its split launch == merge_splits_
     plain, the split and tile launches also timed apart; kernel B (GC +
     packing) == its plain version; decisions == the C++ oracle
     compact_cpu_baseline. Times with CUDA events; A, B (and D, G below)
     also by torch.profiler's device time with their launches, memsets
     and copies per call;
  4. compaction: the 4 runs written as SST files; the stock native
     CompactionJob, the port's shell path and the port's codec path over
     the same inputs must write byte-identical files. Every launch
     counter is set to 0 just before each port job and read just after:
     the shell path must launch A, B and H, the codec path A-F and H.
     Then both paths' stages run one after the other for a time
     breakdown;
  5. kernels C-F (block decode, survivor scan, span gather, block encode)
     at the codec job's shapes == their plain versions, timed with CUDA
     events beside their bounds and, for D and E, a PyTorch call that
     computes the same function;
 5a. the resident chain over the same inputs: the 4 runs staged into a
     DeviceSlabCache at level 0 and exported into a run cache (flush
     write-through); L0->L1 with the cache and input_ids on the codec
     route (no run cache: A, B, D, E, F, H, P4, no C) and on the shell
     route (every input run-cached: A, B, D, E, H, P4, no file read, no
     host decode), files == the native job's, outputs installed at level
     1; L1->L2 warm over the shell job's first two outputs (no key-column
     upload, no host block decode, no shell file ingest by the port's
     counters) beside the native and the cold job; a range scan over
     ResidentSources of the L1 outputs == the host reference; the digest
     check at sample 1.0 on sampled entries; zero pins after every job.
     After the skewed pick (5b) the same pick runs with the cache (the
     resident L1 file + the 4 flushes: H, G, I.1, B, outputs at level 2),
     and after the pushdown (8) q1_agg and q6_agg run over the lineitem
     SSTs as ResidentSources staged with their value words, beside the
     SlabSource calls;
 5b. chunked subcompactions through the router `storage.compaction.
     run_compaction_job(device="cuda")` over the same inputs, on the
     codec and the shell route, each an unchunked job and then a chunked
     one (YBTPU_MERGE_CHUNK_ROWS = --chunk-rows, 2^20: 20 chunks); every
     job's files == the native job's; the chunked jobs launch kernel L
     once, the carve (kernel H) once per chunk, A twice and B once per
     chunk, H for the restage (and the parent payload), C-F on the codec
     route. Kernel L and the carve at the chunked job's shapes == their
     plain versions, timed beside their bounds (L also on the device,
     one launch a call, and beside its latency floor: one launch and its
     longest dependent-load chain, from step 9's HBM probe); kernels A
     and B on every
     carved chunk and kernel H's parent payload (index row remapped) ==
     their plain versions, the payload == the job's. A skewed pick
     through the router: the codec job's first output file plus 4 L0
     runs of --skew-rows (65,536) YCSB-A updates above every write (k_pad
     8, 4x inflation): the radix re-sort (kernels G, I.1, B over the
     host-concatenated slab), files == the native job's, and G, I.1, B
     on the job's staged matrix == their plain versions;
 5c. the mesh (8 virtual shards of the one card, `parallel.mesh.
     make_mesh(8, devices=[cuda:0] * 8)`): the 10M-row job through
     `run_compaction_job(device="cuda", mesh=mesh)` (the dist-native
     job: kernels M1 once, M2, M3, G, I.1, B once a shard per attempt)
     and the skewed pick's inputs through `run_compaction_job(device=
     None, mesh=mesh)` (the Python path's `distributed_compact`), both
     == the native job's files, launch counts exact; the 10M-row job's
     `DistOutputs.gather_span` over every output file's span == the
     single-device spans (H once, D once, E per span); the overflow retry
     over a 2^20-row skewed-prefix slab at capacity factor 0.05 (counted,
     == a first try at 2.0 == the single-device merge); the pooled wave:
     8 YCSB-A tablets (4 runs of --wave-rows each) in one
     `pooled_merge_gc` (A twice and B once a slot), then
     `run_compaction_job_with_decisions`, each == its native job, the
     decisions == sequential launches, one span == the sequential one;
     kernels M1-M3 at the 10M-row job's shard shapes == their plain
     versions, timed beside their bounds and on the device (one launch a
     call, no memset, no copy; M1 also beside its latency floor, as L's),
     the exchange copy, and the job's M2 + M3 time on the device;
 5d. the faults phase (`faults_phase`; `faults:` lines on stdout, each
     with the card): device-fault containment and the bucket-health
     board at config 2's width on the codec route — oom:result:1 absorbed
     by the download's relaunch, oom:result:2 completed natively (files
     == native, the (k_pad, m) and the decode bucket QUARANTINED, counts
     exact) and the next job parked (no A-F launch); a real
     torch.cuda.OutOfMemoryError under set_per_process_memory_fraction
     at half the codec job's peak (files == native, no pin), then a
     device job after the cap; decay to PROBATION and HEALTHY on a
     --fault-rows (1M) tablet; the shadow verifier (bitflip caught,
     sticky past its window, clear_mismatch, one job at sample 1.0
     beside one at 0; 8 1M-row jobs at the default sample, 3 at 1.0
     beside 3 at 0); a fault after the mesh job's M1-M3 (files ==
     native); the reference's rate race (the board's route, state and
     EWMAs per job, COLD first and prewarmed first). After the pushdown
     a fault in q6_agg (PushdownUnsupported, the host answer == the
     device's, the next call parked with no launch) and after the point
     reads one at P3's result site (answers == `_multi_get_native`, the
     next call launches no P1-P3). Every other phase must leave every
     containment counter, the board's native routings among them, where
     it found it (`no_fallbacks`), and the
     timed phases run with shadow_verify_sample pinned to 0;
  6. the snapshot scan over the same 4 input SSTs: the full-tablet
     seq-scan (`ops.scan.visible_entries_sources` over
     SlabSource(read_all()), read time above every write, no bounds)
     drained and timed (rows, key + value bytes, MB/s), beside the native
     host reference `_visible_entries_host`; both walked in lockstep,
     entry for entry, over their first 2^20 entries; a range scan at a read time inside the runs' span
     with a lower and a truncated upper bound, equal to the host
     reference. The seq-scans must launch kernels G, H, I.1 and B and no
     I.2 (an unbounded scan's keep is plane 0 of B's packed buffer); the
     range scan must launch G, H, I.1, B and I.2 exactly once. Then the
     seq-scan's stages run one after the other for a time breakdown;
  7. kernels G-I (radix sort, staged concat, sorted payload, bound pack)
     at the seq-scan's shapes == their plain versions, timed beside their
     bounds and a PyTorch call that computes the same function (I.2 with
     the range scan's bounds, also by torch.profiler's device time, one
     launch and no copy a call, and beside a bound counted in 32-byte
     sectors, as E's and J.1's); G's
     statistics launches == their plain versions, and its plan (the
     sorted prefix before the pad block, the 8-bit passes kept and
     dropped per row) in the kernels line;
  8. the query pushdown over a TPC-H lineitem tablet in 4 SSTs: five
     queries each equal to a host oracle, their launch counters, stage
     breakdowns, kernels J and K == their plain versions, each also by
     torch.profiler's device time (J.1, J.3 and K one launch and no copy
     a call, J.2 one launch after one memset);
  9. batched point reads through `storage.db.DB.multi_get` over a
     DeviceSlabCache: the YCSB tablet (the compaction phase's shape) as
     a DB (runs 0-2 bulk-loaded with ingest_packed, run 3 written and
     flushed, YCSB-B's updates in the memtable); YCSB-C scrambled-
     zipfian reads in calls of 1024 (the cold first call timed apart),
     reads at a mid read time, 32 small calls, reads with the learned
     index off, and learned-index reads over the lineitem SSTs opened as
     a DB. Every answer equals the native per-key path's, a sample equals
     sequential gets; P1 + P2 over every SST (`hash_probe_files`) and
     P3 + the fold (`locate_fold`) launch once per chunk, P1 on its own
     and the per-file P2 and P3 never; P3 in exact and learned-index mode (no lineitem key
     mispredicted); each call's chunks replayed through the per-file
     launches and the host fold give the same folds and counters; P4 on
     every SST equals its persisted model. Stage breakdowns of one warm
     chunk per DB; kernels P1-P4, P1 + P2 and P3 over every file ==
     their plain versions (the path's hashes == P1's), timed beside their bounds (P3's beside its floor:
     one launch and its dependent-load chain at an HBM load latency
     measured on the card);
 10. the DB's own entry points (`db_phase`), each beside a "native" DB
     that takes the same writes in the same call: a DB on the card
     (DeviceSlabCache, auto_compact) bulk-loads 4 L0 runs of rows/4 and
     the universal pick on the 4th runs the codec route; 4 flushes of
     rows/100 and compact_all take the resident chain (no block decode);
     files == native; scan_visible unbounded (its first 2^20 entries)
     and over a range == the native DB's scan_native(visible=True); the
     checkpoint reopened on the card answers alike; q6_agg and
     filter_rows through scan_aggregate / scan_filtered on the lineitem
     SSTs as a DB == step 8's answers; close() during the scheduled
     compaction of a --fault-rows DB (held at its first output file by a
     sync point) installs nothing and leaves no file or pin;
     cancel_background_work leaves another such DB readable, and its
     compaction under compaction_rate_bytes_per_sec takes at least the
     paced bytes' time; a DB with DBOptions.mesh (8
     virtual shards) runs its mesh-sized scheduled compaction on the
     dist-native job (M1-M3), == native; 8 tablet DBs behind one
     CompactionPool (DBOptions.mesh_pool, 8 virtual shards) compact in
     one wave, files == native. Launches per part in the kernels line
     (`launches_db_*`); no containment counter moves;
 11. the tablet (`tablet_phase`): a Tablet on the card
     (TabletOptions(device, DeviceSlabCache)) beside a device-free Tablet
     (TabletOptions(device="native"): its DBs run "native"; the port's
     default tablet is the card) that takes the same operations in the
     same call, both on one deterministic clock. Config 2 at full width
     bulk-loaded (ingest_packed at op id (0, 0); the device-free tablet
     opens a checkpoint of it, a second checkpoint seeds step 12) and
     read as rows of YCSB's usertable
     (ycsb_key, field0); YCSB-A: --tablet-ops reads through
     Tablet.multi_read and as many updates through Tablet.write in calls
     of 1024 (ScrambledZipfian); Tablet.flush and Tablet.compact
     (the codec route); the first page of a full-table Tablet.scan and a
     range scan on the card; a FaultInjectionEnv ENOSPC during a flush
     (the DB parks, writes are refused with ServiceUnavailable, reads go
     on on the card, the tablet recovers after clear_faults); 1,024
     transactional writes read while their intents are pending, after
     the commit and after the apply (the read_row route: no P1-P3);
     scan_aggregate q6 on the lineitem SSTs as a tablet == step 8's
     answer. Every answer == the device-free tablet's, files == its
     files (data byte for byte; the MANIFEST line for line), launches
     exact per part (`launches_tablet_*`), no containment counter moves,
     no pin left. No encrypted job runs here: its routes are held on the
     CPU (tests/test_torch_env.py); a line says so;
 12. the replicated tablet (`consensus_phase`): two Raft groups of three
     TabletPeers (ts0-ts2) on localhost Messengers over RpcTransport,
     one on the card (a DeviceSlabCache a replica), one device-free
     (device="native"), every clock of a group over one physical time
     the driver moves on at each write (`StepTime`), so both leaders
     assign equal hybrid times. Every replica opens step 11's seed (hard
     links), bootstraps and starts; ts0 is elected; YCSB-A through the
     leader (--consensus-ops reads through TabletPeer.multi_read and as
     many updates through TabletPeer.write, in calls of 1024), each
     write applied on all three; flush on every replica (the six
     replicas' files byte for byte); compact on every replica (the card
     replicas' device-native job against the native one: data files byte
     for byte, MANIFEST edit for edit); failover (ts0 down, ts1 elected,
     a call through ts1) and ts0's restart (its bootstrap replays its
     WAL above the flushed frontier into a card tablet, then it catches
     up); every replica's reads == the device-free group's. Launches
     exact per part (`launches_consensus_*`), no containment counter
     moves, no pin left;
 13. the tablet server (`tserver_phase`): a TabletServer with default
     options (its ServerExecutionContext on the card) beside one with a
     device-free tablet factory, each hosting step 11's seed as
     usertable and the lineitem SSTs as a tablet, driven by a client
     Messenger through the `tserver` service over the wire: YCSB-A
     (--tserver-ops reads and as many updates, in calls of 1024), Q6
     over the whole lineitem tablet (== the host oracle) and Q6 and a
     filtered row scan over a 64th of its hash space, flush_tablet and
     the compaction the maintenance manager picks, a bounded
     PrewarmKernelsOp, the compacted tablet remote-bootstrapped into a
     third card server that joins the Raft group and leads, and the card
     server's /healthz, /compactionz and /servez. Answers == the
     device-free server's, files byte for byte (MANIFEST edit for edit),
     launches exact per part (`launches_tserver_*`), no containment
     counter moves, no pin left;
 14. a `kernels` JSON line, the card line, and last
     {"ok": true, "device": {...}}.

Every --rows the script accepts runs: below 4 x 2M rows every job of
the run splits its outputs at rows/4 (compaction_max_output_entries_
per_sst, so the resident chain's L1->L2 step gets two L0->L1 outputs);
--chunk-rows is at most an eighth of the largest power of two in --rows
(the chunked jobs still cut several chunks); and below 2^20 rows the
mesh threshold (distributed_compaction_min_rows) comes down to the
smaller of --rows and 4 x --skew-rows, so every mesh job still routes to
the mesh. At the default 10M rows none of these moves.

Usage: python3 chip_smoke.py [--rows N] [--seed S] [--reps R]
       [--chunk-rows C] [--skew-rows L] [--wave-rows W] [--sf-orders M]
       [--point-reads K] [--fault-rows F] [--tablet-ops T]
       [--consensus-ops O] [--tserver-ops V]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# device memory bandwidth by card name (NVIDIA data sheets), bytes/s
_BANDWIDTH = (("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12), ("H200", 4.8e12),
              ("H100", 3.35e12))


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def synth_ycsb_runs(n_total: int, n_runs: int, key_space: int, seed: int,
                    tombstone_frac: float = 0.05, value_bytes: int = 64,
                    ht_base: int = 0):
    """YCSB-A-like tablet: n_runs sorted runs of row writes (the JAX
    package's bench.synth_ycsb_runs, copied). Key layout (DocDB encoding):
    root = 'S' 'user%08d' 00 00 '!' (16B); column write = root + 'K' +
    2B col id (19B); tombstones hit the row root.

    Run g's hybrid times are ht_base + span*(g+1) + a permutation of its
    rows, with span = max(10^6, rows per run): the JAX package's formula
    (ht_base = 0) up to 10^6
    rows per run. Above that its runs' time ranges overlap and two runs can
    write one key at one hybrid time, which no tablet does (a write's
    hybrid time is unique) and which leaves the merge order of the two
    copies to each merge's tie rule."""
    from yugabyte_tpu_torch.ops.slabs import (FLAG_TOMBSTONE, KVSlab,
                                              ValueArray)
    rng = np.random.default_rng(seed)
    per_run = n_total // n_runs
    span = max(1_000_000, per_run)
    stride = 20
    runs = []
    for g in range(n_runs):
        ids = rng.integers(0, key_space, size=per_run)
        is_tomb = rng.random(per_run) < tombstone_frac
        keys = np.zeros((per_run, stride), dtype=np.uint8)
        keys[:, 0] = ord("S")
        keys[:, 1:5] = np.frombuffer(b"user", dtype=np.uint8)
        digits = ids[:, None] // (10 ** np.arange(7, -1, -1)[None, :]) % 10
        keys[:, 5:13] = (digits + ord("0")).astype(np.uint8)
        keys[:, 15] = ord("!")
        keys[:, 16:19] = np.where(is_tomb[:, None],
                                  np.zeros((per_run, 3), np.uint8),
                                  np.array([[ord("K"), 0, 0]], np.uint8))
        key_len = np.where(is_tomb, 16, 19).astype(np.int32)
        ht = ((ht_base + span * (g + 1) + rng.permutation(per_run))
              .astype(np.uint64) << 12)
        flags = np.where(is_tomb, FLAG_TOMBSTONE, 0).astype(np.uint32)
        order = np.lexsort([~ht] + [keys[:, j]
                                    for j in range(stride - 1, -1, -1)])
        kw = keys[order].reshape(per_run, stride // 4, 4).astype(np.uint32)
        key_words = (kw[:, :, 0] << 24) | (kw[:, :, 1] << 16) \
            | (kw[:, :, 2] << 8) | kw[:, :, 3]
        ht = ht[order]
        vals = rng.integers(0, 256, size=per_run * value_bytes,
                            dtype=np.uint8)
        runs.append(KVSlab(
            key_words=key_words, key_len=key_len[order],
            doc_key_len=np.full(per_run, 16, dtype=np.int32),
            ht_hi=(ht >> 32).astype(np.uint32),
            ht_lo=(ht & 0xFFFFFFFF).astype(np.uint32),
            write_id=np.zeros(per_run, dtype=np.uint32),
            flags=flags[order], ttl_ms=np.zeros(per_run, dtype=np.int64),
            value_idx=np.arange(per_run, dtype=np.int32),
            values=ValueArray(vals, np.arange(per_run + 1, dtype=np.int64)
                              * value_bytes)))
    return runs


def history_cutoff(n_total: int, n_runs: int = 4) -> int:
    """A history cutoff above every write of synth_ycsb_runs."""
    span = max(1_000_000, n_total // n_runs)
    return max(10_000_000, span * (n_runs + 1)) << 12


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call, CUDA events around `reps` calls after
    one warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profiled(fn, reps: int, tries: int = 6, lead: int = 512) -> list:
    """(name, device microseconds) of every kernel, memset and copy that
    `reps` calls of `fn` run, from torch.profiler: one call before the
    profiler; inside it, `lead` one-element adds and one sacrificial call,
    then the timed calls between two marker kernels (`torch.cuda._sleep`)
    on the same stream, whose device events are those that start between
    the markers (the host's and the device's clocks can disagree by more
    than a short call lasts). In a long process a trace has been seen to
    lose its first 20-40 device events (the sacrificial call, the opening
    marker and, for a short `fn`, every timed call), and a wait before the
    first launch did not help: the adds are there to be lost instead. A
    trace that lost a marker, holds no device event between them or a
    count that is not a multiple of `reps` is taken again, up to `tries`
    traces."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                pad.add_(1)
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            for _ in range(reps):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        marks = sorted(e.time_range.start for e in events
                       if "spin_kernel" in e.name)
        kept_lead = sum(e.name.startswith("void at::native::") and
                        e.time_range.start < (marks or [float("inf")])[0]
                        for e in events)
        out = []
        if len(marks) == 2:
            out = [(e.name, e.time_range.elapsed_us()) for e in events
                   if marks[0] < e.time_range.start < marks[1]
                   and "spin_kernel" not in e.name]
        if out and len(out) % reps == 0:
            if kept_lead < lead:
                log(f"profiler trace {attempt + 1}: {lead - kept_lead} of "
                    f"{lead} lead events lost, the window whole")
            return out
        log(f"profiler trace {attempt + 1}: {len(marks)} of 2 markers, "
            f"{len(out)} device events between them, {kept_lead} of {lead} "
            f"lead events ({len(events)} in all: "
            f"{[e.name for e in events][:6]})")
    return []


def device_profile(fn, reps: int) -> dict:
    """torch.profiler's CUDA activity over `reps` calls of `fn` (see
    profiled): the device milliseconds per call of the kernels, memsets
    and copies it launches (their own time, without the wrapper's host
    work between calls), and how many of each a call launches."""
    out = {"device_ms": 0.0, "launches_per_call": 0.0,
           "memsets_per_call": 0.0, "copies_per_call": 0.0}
    for name, us in profiled(fn, reps):
        out["device_ms"] += us / reps / 1e3
        kind = ("memsets_per_call" if name.startswith("Memset") else
                "copies_per_call" if name.startswith("Memcpy") else
                "launches_per_call")
        out[kind] += 1
    for kind in ("launches_per_call", "memsets_per_call", "copies_per_call"):
        out[kind] /= reps
    if out["device_ms"] <= 0:
        raise AssertionError("the profiler saw no device time")
    return out


def device_ms(fn, reps: int) -> float:
    """Device milliseconds per call of the kernels, memsets and copies `fn`
    launches (see device_profile)."""
    return device_profile(fn, reps)["device_ms"]


def max_abs_err(x, y) -> int:
    """Largest |x - y| over two integer tensors (u32 bits compared as
    unsigned values), in slices of 2^24 to bound the temporaries."""
    import torch
    from yugabyte_tpu_torch.ops.merge_gc import _u
    torch.cuda.synchronize()
    xf, yf = x.reshape(-1).to(torch.int32), y.reshape(-1).to(torch.int32)
    step = 1 << 24
    return max(int((_u(xf[i:i + step]) - _u(yf[i:i + step])).abs().max())
               for i in range(0, xf.numel(), step))


def same_or_raise(what, got, want) -> int:
    """max_abs_err of a kernel's output against its plain version's on the
    same inputs; raises unless the two are equal."""
    import torch
    err = max_abs_err(got, want)
    if err or got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{what} != its plain version (max_abs_err "
                             f"{err})")
    return err


def lexsort_level(p_mat, L, cmp_rows):
    """library_ms yardstick of kernel A: a chained stable torch.sort
    lexsort of the same rows (pair, compare rows, index) -> the order.
    Timed here only; the port never calls it."""
    import torch
    from yugabyte_tpu_torch.ops.merge_gc import _u
    from yugabyte_tpu_torch.ops.merge_path import cmp_desc
    rp, n = p_mat.shape
    rows, inv = cmp_desc(cmp_rows)
    pair = torch.arange(n, device=p_mat.device) // (2 * L)
    order = torch.arange(n, device=p_mat.device)
    for row, iv in [(rp - 1, 0)] + list(zip(rows, inv))[::-1]:
        key = (pair << 32) | (_u(p_mat[row, order]) ^ iv)
        order = order[torch.sort(key, stable=True).indices]
    return order


def kernel_phase(args, runs, bandwidth, device="cuda"):
    import torch
    from yugabyte_tpu_torch.ops import merge_gc, merge_path, run_merge
    from yugabyte_tpu_torch.ops.slabs import concat_slabs
    from yugabyte_tpu_torch.storage.cpu_baseline import compact_cpu_baseline

    cutoff = history_cutoff(args.rows)
    params = merge_gc.GCParams(cutoff, True)
    t0 = time.time()
    staged = run_merge.stage_runs_from_slabs(runs, device=device)
    torch.cuda.synchronize()
    log(f"staged k_pad={staged.k_pad} m={staged.m} w={staged.w} "
        f"n_pad={staged.n_pad} cmp_rows={staged.cmp_rows.tolist()} "
        f"in {time.time() - t0:.1f}s")
    r = merge_gc._ROW_WORDS + staged.w
    cols = staged.cols_dev
    pos = torch.arange(staged.n_pad, dtype=torch.int32, device=cols.device)
    p_k = torch.cat([cols, pos[None]])
    p_p = p_k.clone()
    rp, n = p_k.shape
    a = {"name": "merge_path_level", "route": "cuda",
         "source": "yugabyte_tpu_torch/csrc/merge_path.cu",
         "replaces": "yugabyte_tpu/ops/pallas_merge.py:222",
         "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
         "device_ms": 0.0, "bound_by": "bytes", "max_abs_err": 0,
         "levels": []}
    c = len(merge_path.cmp_desc(staged.cmp_rows)[0])
    length = staged.m
    while length < n:
        out_k = merge_path.merge_level(p_k, length, staged.cmp_rows)
        out_p = merge_path.merge_level_plain(p_p, length, staged.cmp_rows)
        err = max_abs_err(out_k, out_p)
        if err:
            bad = int((out_k != out_p).any(dim=0).sum())
            raise AssertionError(f"kernel A != plain at L={length}: "
                                 f"{bad} columns differ")
        tile, threads, smem = merge_path.tile_plan(rp, c, length)
        splits = merge_path.merge_splits(p_k, length, staged.cmp_rows, tile)
        split_err = same_or_raise(
            f"kernel A's split launch at L={length}", splits,
            merge_path.merge_splits_plain(p_k, length, staged.cmp_rows,
                                          tile))
        a["max_abs_err"] = max(a["max_abs_err"], err, split_err)
        ms = cuda_ms(lambda: merge_path.merge_level(p_k, length,
                                                    staged.cmp_rows),
                     args.reps)
        split_ms = cuda_ms(lambda: merge_path.merge_splits(
            p_k, length, staged.cmp_rows, tile), args.reps)
        tile_ms = cuda_ms(lambda: merge_path.merge_tiles(
            p_k, splits, length, staged.cmp_rows, tile), args.reps)
        split_dev = device_ms(lambda: merge_path.merge_splits(
            p_k, length, staged.cmp_rows, tile), args.reps)
        tile_dev = device_ms(lambda: merge_path.merge_tiles(
            p_k, splits, length, staged.cmp_rows, tile), args.reps)
        plain_ms = cuda_ms(lambda: merge_path.merge_level_plain(
            p_k, length, staged.cmp_rows), 2)
        lib_ms = cuda_ms(lambda: lexsort_level(p_k, length, staged.cmp_rows),
                         2)
        bound = (2 * rp * n * 4 + splits.numel() * 4) / bandwidth * 1e3
        a["levels"].append({"L": length, "tile": tile, "threads": threads,
                            "smem_bytes": smem, "ms": ms,
                            "split_ms": split_ms, "tile_ms": tile_ms,
                            "split_plus_tile_ms": split_ms + tile_ms,
                            "split_device_ms": split_dev,
                            "tile_device_ms": tile_dev,
                            "plain_ms": plain_ms, "library_ms": lib_ms,
                            "bound_ms": bound})
        a["ms"] += ms
        a["plain_ms"] += plain_ms
        a["library_ms"] += lib_ms
        a["bound_ms"] += bound
        a["device_ms"] += split_dev + tile_dev
        log(f"kernel A L={length}: equal, splits equal; {ms:.3f} ms (split "
            f"{split_ms:.4f} + tile {tile_ms:.3f}; on the device "
            f"{split_dev:.4f} + {tile_dev:.3f}; plain {plain_ms:.3f}, "
            f"lexsort {lib_ms:.3f}, bound {bound:.3f})")
        del splits
        p_k, p_p = out_k, out_p
        length *= 2
    del p_p, out_p

    packed, keep, mk = merge_gc.gc_pack(p_k, r, staged.w, params,
                                        staged.k_pad, staged.m)
    packed_p, keep_p, mk_p = merge_gc.gc_pack_plain(p_k, r, staged.w, params,
                                                    staged.k_pad, staged.m)
    b_err = 0
    for what, x, y in (("packed", packed, packed_p), ("keep", keep, keep_p),
                       ("make_tombstone", mk, mk_p)):
        err = max_abs_err(x, y)
        if err:
            raise AssertionError(f"kernel B != plain: {what} differs at "
                                 f"{int((x != y).sum())} places")
        b_err = max(b_err, err)
    b_ms = cuda_ms(lambda: merge_gc.gc_pack(p_k, r, staged.w, params,
                                            staged.k_pad, staged.m), args.reps)
    b_plain = cuda_ms(lambda: merge_gc.gc_pack_plain(
        p_k, r, staged.w, params, staged.k_pad, staged.m), 2)
    nb = merge_gc.n_src_planes(staged.k_pad)
    b_bytes = (r + 1) * n * 4 + (n // 32) * (2 + nb) * 4 + 2 * n
    b = {"name": "gc_pack", "route": "cuda",
         "source": "yugabyte_tpu_torch/csrc/gc_pack.cu",
         "replaces": "yugabyte_tpu/ops/merge_gc.py:85",
         "ms": b_ms, "plain_ms": b_plain, "library_ms": None,
         "bound_ms": b_bytes / bandwidth * 1e3, "bound_by": "bytes",
         "max_abs_err": b_err}
    b.update(device_profile(lambda: merge_gc.gc_pack(
        p_k, r, staged.w, params, staged.k_pad, staged.m), args.reps))
    log(f"kernel B: equal; {b_ms:.3f} ms, on the device "
        f"{b['device_ms']:.4f} ({b['launches_per_call']:g} launches and "
        f"{b['memsets_per_call']:g} memsets a call; plain {b_plain:.3f}, "
        f"bound {b['bound_ms']:.3f})")

    # decisions against the C++ heap-merge oracle on the same runs
    h = run_merge.MergeGCHandle(packed, staged)
    perm, keep_h, mk_h = h.result()
    t0 = time.time()
    merged = concat_slabs(runs)
    offsets = np.concatenate(([0], np.cumsum([s.n for s in runs]))).tolist()
    order_c, keep_c, mk_c = compact_cpu_baseline(merged, offsets, cutoff,
                                                 True)
    if not (np.array_equal(perm[keep_h], order_c[keep_c])
            and np.array_equal(perm[mk_h], order_c[mk_c])):
        raise AssertionError("device decisions differ from the C++ oracle")
    log(f"decisions == C++ oracle ({int(keep_h.sum())} survivors of "
        f"{len(perm)}; oracle {time.time() - t0:.1f}s)")
    del p_k, packed, packed_p, keep, keep_p, mk, mk_p, staged, cols, pos
    torch.cuda.empty_cache()
    return a, b


def write_inputs(runs, in_dir):
    from yugabyte_tpu_torch.storage.sst import Frontier, SSTReader, SSTWriter
    readers = []
    for i, slab in enumerate(runs):
        p = os.path.join(in_dir, f"{i:06d}.sst")
        SSTWriter(p).write(slab, Frontier())
        readers.append(SSTReader(p))
    return readers


def stage_breakdown(readers, cutoff, device="cuda"):
    """Seconds of each stage of the shell path's device job, run one after the
    other (the job overlaps the shell's ingest with stages 1-3): read the
    inputs' columns, upload them, re-lay them run-major, the merge levels
    (kernel A), GC + packing (kernel B), and the download + host decode of
    the packed decisions. Host clock, each stage ended by a synchronize."""
    from yugabyte_tpu_torch.ops import merge_gc, run_merge

    out = {}
    t0 = time.time()
    slabs = [r.read_all() for r in readers]
    out["read_columns_s"] = time.time() - t0
    t0 = time.time()
    staged = [merge_gc.stage_slab(s, device) for s in slabs]
    sync()
    out["upload_s"] = time.time() - t0
    t0 = time.time()
    runs = run_merge.stage_runs_from_staged(staged)
    sync()
    out["restage_s"] = time.time() - t0
    t0 = time.time()
    p_mat = run_merge.merge_payload(runs)
    sync()
    out["merge_levels_s"] = time.time() - t0
    t0 = time.time()
    r = merge_gc._ROW_WORDS + runs.w
    packed, keep, mk = merge_gc.gc_pack(p_mat, r, runs.w,
                                        merge_gc.GCParams(cutoff, True),
                                        runs.k_pad, runs.m)
    sync()
    out["gc_pack_s"] = time.time() - t0
    t0 = time.time()
    run_merge.MergeGCHandle(packed, runs).result()
    out["download_decode_s"] = time.time() - t0
    return out


def _wrappers():
    """Every kernel wrapper of the main paths, by its name in the kernels
    line."""
    from yugabyte_tpu_torch.ops import (block_codec, merge_gc, merge_path,
                                       radix, run_merge, scan)
    return {"merge_path_level": merge_path.merge_level,
            "gc_pack": merge_gc.gc_pack,
            "block_decode": block_codec.block_decode,
            "survivor_scan": run_merge.survivor_scan,
            "span_gather": run_merge.span_gather,
            "block_encode": block_codec.block_encode,
            "staged_concat": run_merge.staged_concat,
            "radix_sort": radix.radix_sort,
            "sorted_payload": radix.sorted_payload,
            "bound_pack": scan.bound_pack,
            "chunk_split_search": run_merge.chunk_split_search,
            "carve_chunk": run_merge.carve_chunk}


# the kernels each path must launch
_PATH_KERNELS = {
    "shell": ("merge_path_level", "gc_pack", "staged_concat"),
    "codec": ("merge_path_level", "gc_pack", "block_decode", "survivor_scan",
              "span_gather", "block_encode", "staged_concat"),
    "scan": ("staged_concat", "radix_sort", "sorted_payload", "gc_pack"),
    "range_scan": ("staged_concat", "radix_sort", "sorted_payload",
                   "gc_pack", "bound_pack"),
    "skewed": ("radix_sort", "sorted_payload", "gc_pack"),
}


def check_launches(launches, path):
    for k in _PATH_KERNELS[path]:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the "
                                 f"{path} path")


def sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def same_files(a, b, what):
    if (a.rows_in, a.rows_out) != (b.rows_in, b.rows_out) \
            or len(a.outputs) != len(b.outputs) or not a.outputs:
        raise AssertionError(f"{what}: jobs disagree on rows/files")
    for (_, pa, _), (_, pb, _) in zip(a.outputs, b.outputs):
        for suffix in ("", ".sblock.0"):
            with open(pa + suffix, "rb") as f1, open(pb + suffix, "rb") as f2:
                if f1.read() != f2.read():
                    raise AssertionError(f"{what}: output "
                                         f"{os.path.basename(pa)}{suffix} "
                                         f"differs")


def compaction_phase(runs, workdir, reps, bandwidth, device="cuda"):
    """The three jobs over the same input SSTs: the stock native
    CompactionJob, the port's shell path (YBTPU_DEVICE_CODEC=0, slice 1)
    and the port's default device-codec path (slice 2). Each port job runs
    with every launch counter set to 0 just before it and read just
    after."""
    import torch
    from yugabyte_tpu_torch.storage import compaction

    cutoff = history_cutoff(sum(s.n for s in runs))
    in_dir = os.path.join(workdir, "in")
    os.makedirs(in_dir)
    t0 = time.time()
    readers = write_inputs(runs, in_dir)
    rows = sum(s.n for s in runs)
    log(f"wrote {len(readers)} input SSTs ({rows} rows) in "
        f"{time.time() - t0:.1f}s")
    wrappers = _wrappers()
    out, launches, peak = {}, {}, {}
    for name, codec in (("native", None), ("shell", "0"), ("codec", "1")):
        d = os.path.join(workdir, name)
        os.makedirs(d)
        ids = iter(range(1000, 100000))
        if codec is None:
            t0 = time.time()
            res = compaction._run_native_job(readers, d, lambda: next(ids),
                                             cutoff, True, False, None)
            secs = time.time() - t0
        else:
            os.environ["YBTPU_DEVICE_CODEC"] = codec
            for w in wrappers.values():
                w.launches = 0
            if torch.cuda.is_available():
                torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            res = compaction.run_compaction_job_device_native(
                readers, d, lambda: next(ids), cutoff, True, device=device)
            sync()
            secs = time.time() - t0
            launches[name] = {k: w.launches for k, w in wrappers.items()}
            peak[name] = (torch.cuda.max_memory_allocated()
                          if torch.cuda.is_available() else 0)
        out[name] = (res, secs)
        log(f"{name} job: {res.rows_in} -> {res.rows_out} rows, "
            f"{len(res.outputs)} files, {secs:.2f}s "
            f"({res.rows_in / secs:,.0f} rows/s)")
    os.environ["YBTPU_DEVICE_CODEC"] = "1"
    same_files(out["shell"][0], out["native"][0], "shell path vs native")
    same_files(out["codec"][0], out["native"][0], "codec path vs native")
    same_files(out["codec"][0], out["shell"][0], "codec path vs shell path")
    log("output SSTs byte-identical: codec path == shell path == native "
        "CompactionJob")
    check_launches(launches["codec"], "codec")
    check_launches(launches["shell"], "shell")
    log(f"launches: codec job {launches['codec']}, shell job "
        f"{launches['shell']}")
    stages = stage_breakdown(readers, cutoff, device)
    log("shell path stages, one after the other: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    codec_stages, tensors = codec_breakdown(
        readers, cutoff, os.path.join(workdir, "breakdown"), reps, bandwidth,
        device)
    log("codec path stages, one after the other: " + ", ".join(
        f"{k} {v:.3f}" for k, v in codec_stages.items()))
    summary = {"rows": rows, "rows_out": out["codec"][0].rows_out,
               "files": len(out["codec"][0].outputs),
               "shell_stages": stages, "codec_stages": codec_stages}
    for name in ("native", "shell", "codec"):
        summary[f"{name}_s"] = out[name][1]
        summary[f"{name}_rows_per_s"] = rows / out[name][1]
    for name in ("shell", "codec"):
        summary[f"{name}_peak_bytes"] = peak[name]
    return summary, launches, tensors, readers


def codec_breakdown(readers, cutoff, out_dir, reps, bandwidth,
                    device="cuda"):
    """Seconds of each stage of the codec job's path, run one after the
    other with the same module functions, each ended by a synchronize:
    raw read + CRC parse, the host column layout, upload + kernel C, the
    value concat, restage (kernel H), kernel A, kernel B, the decision
    download + decode, kernels D + E, the host value gather, kernel F +
    the host block assembly, and the file writes. The restage is also
    timed with CUDA events beside its bound.
    Returns the stages and the tensors the kernel phase checks kernels
    C-F on."""
    from yugabyte_tpu_torch.docdb.value import Value
    from yugabyte_tpu_torch.ops import block_codec, merge_gc, run_merge
    from yugabyte_tpu_torch.ops.slabs import ValueArray
    from yugabyte_tpu_torch.storage.sst import data_file_name, write_base_file
    from yugabyte_tpu_torch.utils import flags

    os.makedirs(out_dir)
    out = {}
    t0 = time.time()
    rfbs = [block_codec.parse_raw_file(r.read_raw(), r.block_handles)
            for r in readers]
    out["raw_read_parse_s"] = time.time() - t0
    t0 = time.time()
    raws = [block_codec.raw_cols(rfb) for rfb in rfbs]
    out["decode_host_layout_s"] = time.time() - t0
    t0 = time.time()
    staged = []
    for rfb, (cols_in, n_pad, w_pad) in zip(rfbs, raws):
        cols, is_const, first = block_codec.block_decode(
            merge_gc.u32_to_device(cols_in, device), rfb.n)
        staged.append(merge_gc.StagedCols(
            cols, rfb.n, n_pad, w_pad, is_const.cpu().numpy(),
            first.cpu().numpy().view(np.uint32)))
    sync()
    out["upload_decode_s"] = time.time() - t0
    tensors = {"cols_in": raws[0][0], "n": rfbs[0].n}
    del raws
    t0 = time.time()
    values = ValueArray.concat([p for rfb in rfbs for p in rfb.value_parts])
    out["values_concat_s"] = time.time() - t0
    t0 = time.time()
    runs = run_merge.stage_runs_from_staged(staged)
    sync()
    out["restage_s"] = time.time() - t0
    r = merge_gc._ROW_WORDS + runs.w
    restage_bytes = r * runs.n_pad * 4 + sum(
        s.n * (merge_gc._ROW_WORDS + s.w) * 4 for s in staged)
    out["restage_ms_cuda_events"] = cuda_ms(
        lambda: run_merge.stage_runs_from_staged(staged), reps)
    out["restage_bound_ms"] = restage_bytes / bandwidth * 1e3
    del staged
    t0 = time.time()
    p_mat = run_merge.merge_payload(runs)
    sync()
    out["merge_levels_s"] = time.time() - t0
    t0 = time.time()
    packed, keep, mk = merge_gc.gc_pack(p_mat, r, runs.w,
                                        merge_gc.GCParams(cutoff, True),
                                        runs.k_pad, runs.m)
    sync()
    out["gc_pack_s"] = time.time() - t0
    t0 = time.time()
    handle = run_merge.MergeGCHandle(packed, runs, p_mat, keep, mk)
    perm, keep_h, mk_h = handle.result()
    surv, mk_s = perm[keep_h], mk_h[keep_h]
    out["download_decode_s"] = time.time() - t0
    del runs
    max_rows = flags.get_flag("compaction_max_output_entries_per_sst")
    spans = [(s, min(s + max_rows, len(surv)))
             for s in range(0, len(surv), max_rows)]
    t0 = time.time()
    pos = run_merge.survivor_positions(handle)
    sts = [run_merge.gather_staged_output_span(handle, pos, s, e)
           for s, e in spans]
    sync()
    out["survivor_gather_s"] = time.time() - t0
    t0 = time.time()
    tomb = Value.tombstone().encode()
    vals = [values.gather(surv[s:e], replace_mask=mk_s[s:e],
                          replacement=tomb) for s, e in spans]
    out["value_gather_s"] = time.time() - t0
    t0 = time.time()
    w_out = max(rfb.w for rfb in rfbs)
    block_entries = flags.get_flag("sst_block_entries")
    enc = [block_codec.encode_span(st, e - s, w_out, v, block_entries,
                                   compress=False)
           for st, (s, e), v in zip(sts, spans, vals)]
    out["encode_s"] = time.time() - t0
    t0 = time.time()
    for i, ((s, e), (blocks, index, hashes, fk, lk)) in enumerate(
            zip(spans, enc)):
        base = os.path.join(out_dir, f"{i:06d}.sst")
        with open(data_file_name(base), "wb") as f:
            for blk in blocks:
                f.write(blk)
            f.flush()
            os.fsync(f.fileno())
        write_base_file(base, index, e - s, hashes, fk, lk, None,
                        sum(len(b) for b in blocks))
    out["write_s"] = time.time() - t0
    tensors.update(keep=keep, p_mat=p_mat, r=r, pos=pos, mk=mk,
                   span=spans[0], span_cols=sts[0].cols_dev)
    return out, tensors


def span_gather_sector_bytes(src, start, end, r, n_out_pad) -> int:
    """Bytes of the 32-byte sectors kernel E must move for one span: the
    survivor positions pos[start:end] (contiguous), the make-tombstone
    byte and the r payload words at each position (each sector that holds
    one counted once), and the [r, n_out_pad] output."""
    import torch
    p = src.long()
    pos_sectors = -(-4 * end // 32) - 4 * start // 32
    mk_sectors = torch.unique(p // 32).numel()
    word_sectors = torch.unique(p // 8).numel()
    return 32 * (pos_sectors + mk_sectors + r * word_sectors) \
        + n_out_pad * 4 * r


def codec_kernel_phase(args, t, launches, bandwidth):
    """Kernels C-F against their plain versions at the codec job's shapes
    (max_abs_err must be 0), timed with CUDA events, beside their bounds
    (bytes over the card's memory rate) and, for D and E, one PyTorch
    call that computes the same function."""
    import torch
    from yugabyte_tpu_torch.ops import block_codec, merge_gc, run_merge

    dev = t["p_mat"].device
    rows = []

    def check(name, got, want):
        err = max(max_abs_err(g, w) for g, w in zip(got, want))
        if err:
            raise AssertionError(f"kernel {name} != its plain version "
                                 f"(max_abs_err {err})")
        return err

    def entry(name, source, replaces, err, ms, plain_ms, nbytes, lib_ms):
        e = {"name": name, "route": "cuda",
             "source": f"yugabyte_tpu_torch/csrc/{source}",
             "replaces": replaces, "launches": launches[name],
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": nbytes / bandwidth * 1e3, "bound_by": "bytes",
             "library_ms": lib_ms}
        log(f"kernel {name}: equal; {ms:.4f} ms (plain {plain_ms:.4f}, "
            f"library {lib_ms}, bound {e['bound_ms']:.4f}), "
            f"{launches[name]} launches in the codec job")
        rows.append(e)

    # C: one input file's raw columns
    ci = merge_gc.u32_to_device(t["cols_in"], dev)
    n = t["n"]
    err = check("block_decode", block_codec.block_decode(ci, n),
                block_codec.block_decode_plain(ci, n))
    rc, n_pad = ci.shape
    entry("block_decode", "block_codec.cu",
          "yugabyte_tpu/ops/block_codec.py:97",
          err, cuda_ms(lambda: block_codec.block_decode(ci, n), args.reps),
          cuda_ms(lambda: block_codec.block_decode_plain(ci, n), 2),
          2 * rc * n_pad * 4 + 8 * rc, None)
    del ci

    # D: the merge's keep bytes
    keep = t["keep"]
    err = check("survivor_scan", [run_merge.survivor_scan(keep)],
                [run_merge.survivor_scan_plain(keep)])
    entry("survivor_scan", "write_through.cu",
          "yugabyte_tpu/ops/run_merge.py:866", err,
          cuda_ms(lambda: run_merge.survivor_scan(keep), args.reps),
          cuda_ms(lambda: run_merge.survivor_scan_plain(keep), 2),
          keep.numel() * 5, cuda_ms(lambda: torch.nonzero(keep), args.reps))
    rows[-1]["device_ms"] = device_ms(lambda: run_merge.survivor_scan(keep),
                                      args.reps)
    log(f"kernel survivor_scan on the device: {rows[-1]['device_ms']:.4f} "
        f"ms")

    # E: the first output file's span
    p_mat, r, pos, mk = t["p_mat"], t["r"], t["pos"], t["mk"]
    start, end = t["span"]
    n_out_pad = merge_gc.bucket_size(end - start)
    args_e = (p_mat, r, pos, mk, start, end, n_out_pad)
    err = check("span_gather", [run_merge.span_gather(*args_e)],
                [run_merge.span_gather_plain(*args_e)])
    src = pos[start:end]
    entry("span_gather", "write_through.cu",
          "yugabyte_tpu/ops/run_merge.py:901", err,
          cuda_ms(lambda: run_merge.span_gather(*args_e), args.reps),
          cuda_ms(lambda: run_merge.span_gather_plain(*args_e), 2),
          (end - start) * (4 + 1 + 4 * r) + n_out_pad * 4 * r,
          cuda_ms(lambda: torch.index_select(p_mat[:r], 1, src), 2))
    e_row = rows[-1]
    e_row["bound_sectors_ms"] = span_gather_sector_bytes(
        src, start, end, r, n_out_pad) / bandwidth * 1e3
    log(f"kernel span_gather: bound in sectors "
        f"{e_row['bound_sectors_ms']:.4f} ms, "
        f"{e_row['bound_sectors_ms'] / e_row['ms']:.3f} of its time")

    # F: the first output file's gathered cols
    sc = t["span_cols"]
    err = check("block_encode", block_codec.block_encode(sc),
                block_codec.block_encode_plain(sc))
    w_pad = sc.shape[0] - merge_gc._ROW_WORDS
    entry("block_encode", "block_codec.cu",
          "yugabyte_tpu/ops/block_codec.py:161", err,
          cuda_ms(lambda: block_codec.block_encode(sc), args.reps),
          cuda_ms(lambda: block_codec.block_encode_plain(sc), 2),
          sc.shape[1] * ((3 + w_pad) * 4 + w_pad * 4 + 2 + 2 + 1 + 8), None)
    return rows


# ---------------------------------------------- chunked subcompactions


def check_chunked_launches(launches, handle, parent_m, k_pad, route,
                           files, n_inputs):
    """The chunked job's exact launch counts: kernel L once, the carve
    once per chunk, log2(k_pad) merge levels and one GC a chunk, kernel H
    for the restage (and, on the codec route, the parent payload), and
    the codec route's C, D, E and F."""
    from yugabyte_tpu_torch.ops import run_merge
    if not isinstance(handle, run_merge._ChunkedMergeGCHandle):
        raise AssertionError(f"{route}: the job did not run chunked")
    nc = len(handle._handles)
    m_c = handle._handles[0]._staged.m
    if nc < 2 or any(h._staged.m != m_c for h in handle._handles) \
            or m_c >= parent_m:
        raise AssertionError(f"{route}: {nc} chunks at m_c={m_c} against "
                             f"the parent's m={parent_m}")
    want = {"chunk_split_search": 1, "carve_chunk": nc,
            "merge_path_level": nc * (k_pad.bit_length() - 1),
            "gc_pack": nc, "staged_concat": 1}
    if route == "codec":
        want.update(staged_concat=2, block_decode=n_inputs, survivor_scan=1,
                    span_gather=files, block_encode=files)
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{route} chunked job launches {got}, "
                             f"expected {want}")
    return nc, m_c


def chunked_phase(args, readers, workdir, device="cuda"):
    """The tablet's 4 input SSTs through `run_compaction_job(device=
    "cuda")` on the codec route and the shell route (YBTPU_DEVICE_CODEC=0),
    each as a pair: unchunked, then chunked (YBTPU_MERGE_CHUNK_ROWS =
    args.chunk_rows). Every job's files == the native job's; every launch
    counter set to 0 just before each job and read just after. Returns
    the summary, the chunked codec job's launches, the parent staged runs
    and chunk windows of that job (kernel L's and the carve's inputs), and
    the unchunked codec job's first output file."""
    from yugabyte_tpu_torch.ops import run_merge
    from yugabyte_tpu_torch.storage import compaction

    rows = sum(r.props.n_entries for r in readers)
    cutoff = history_cutoff(rows)
    wrappers = _wrappers()
    ids = iter(range(200000, 300000))
    d = os.path.join(workdir, "chunk_native")
    os.makedirs(d)
    native = compaction._run_native_job(readers, d, lambda: next(ids),
                                        cutoff, True, False, None)
    captured = {}
    real = run_merge._launch_chunked

    def spy(staged, params, snapshot, target):
        h = real(staged, params, snapshot, target)
        captured.update(staged=staged, handle=h, target=target,
                        params=params)
        return h

    out, launches, kin, base_file = {}, {}, None, None
    run_merge._launch_chunked = spy
    try:
        for route, codec in (("codec", "1"), ("shell", "0")):
            os.environ["YBTPU_DEVICE_CODEC"] = codec
            for chunked in (False, True):
                name = f"{route}_{'chunked' if chunked else 'unchunked'}"
                if chunked:
                    os.environ["YBTPU_MERGE_CHUNK_ROWS"] = str(
                        args.chunk_rows)
                else:
                    os.environ.pop("YBTPU_MERGE_CHUNK_ROWS", None)
                captured.clear()
                d = os.path.join(workdir, name)
                os.makedirs(d)
                for w in wrappers.values():
                    w.launches = 0
                t0 = time.time()
                res = compaction.run_compaction_job(
                    readers, d, lambda: next(ids), cutoff, True,
                    device=device)
                sync()
                secs = time.time() - t0
                launches[name] = {k: w.launches for k, w in wrappers.items()}
                same_files(res, native, f"{name} job vs native")
                out[f"{name}_s"] = secs
                out[f"{name}_rows_per_s"] = rows / secs
                if chunked:
                    st = captured["staged"]
                    nc, m_c = check_chunked_launches(
                        launches[name], captured["handle"], st.m, st.k_pad,
                        route, len(res.outputs), len(readers))
                    out.update(nc=nc, m_c=m_c, m=st.m, k_pad=st.k_pad)
                    if route == "codec":
                        h = captured["handle"]
                        if h._p_mat is None:
                            raise AssertionError("the chunked codec job "
                                                 "built no parent payload")
                        kin = {"staged": st, "m_c": m_c,
                               "target": captured["target"],
                               "params": captured["params"],
                               "metas": h._metas,
                               "parent": (h._p_mat, h._mk_dev)}
                else:
                    if "handle" in captured:
                        raise AssertionError(f"{name}: chunked unasked")
                    check_launches(launches[name], route)
                    if route == "codec":
                        base_file = res.outputs[0][1]
                captured.clear()
                log(f"{name} job: {res.rows_in} -> {res.rows_out} rows, "
                    f"{len(res.outputs)} files, {secs:.2f}s "
                    f"({rows / secs:,.0f} rows/s) == native")
    finally:
        run_merge._launch_chunked = real
        os.environ.pop("YBTPU_MERGE_CHUNK_ROWS", None)
        os.environ["YBTPU_DEVICE_CODEC"] = "1"
    log(f"chunked jobs: nc={out['nc']} chunks at m_c={out['m_c']} (parent "
        f"m={out['m']}, k_pad={out['k_pad']}); codec route "
        f"{out['codec_chunked_rows_per_s']:,.0f} rows/s chunked, "
        f"{out['codec_unchunked_rows_per_s']:,.0f} unchunked; shell route "
        f"{out['shell_chunked_rows_per_s']:,.0f} chunked, "
        f"{out['shell_unchunked_rows_per_s']:,.0f} unchunked; launches "
        f"{launches['codec_chunked']}")
    return out, launches["codec_chunked"], kin, base_file


def skewed_phase(args, base_file, workdir, device="cuda"):
    """A skewed pick through the router: the codec job's first output
    file (a full L1 file) plus 4 L0 runs of args.skew_rows (65,536) YCSB-A
    updates (5% row tombstones) written above every hybrid time of the
    tablet, as four memtable flushes. k = 5 -> k_pad 8 at m =
    run_bucket(2,000,000): the run layout inflates 4x, so
    `run_compaction_job(device="cuda")` takes the radix re-sort (kernels
    G, I.1, B over the slabs concatenated on the host). Its files == the
    native job's; its launch counters set to 0 just before and read just
    after. Then G, I.1 and B against their plain versions on the job's own
    staged matrix (captured at `merge_gc._merge_gc_fused`), G's perm ==
    the job's."""
    import torch
    from yugabyte_tpu_torch.ops import merge_gc, radix, run_merge
    from yugabyte_tpu_torch.storage import compaction
    from yugabyte_tpu_torch.storage.sst import SSTReader

    ht_base = history_cutoff(args.rows) >> 12
    runs = synth_ycsb_runs(4 * args.skew_rows, 4, max(1, args.rows // 2),
                           args.seed + 1, ht_base=ht_base)
    in_dir = os.path.join(workdir, "skewed_in")
    os.makedirs(in_dir)
    readers = [SSTReader(base_file)] + write_inputs(runs, in_dir)
    del runs
    ns = [r.props.n_entries for r in readers]
    infl = run_merge.run_layout_inflation(ns)
    if infl <= 2.0:
        raise AssertionError(f"the skewed pick inflates {infl}x only")
    cutoff = skewed_cutoff(args)
    wrappers = _wrappers()
    out = {"inputs": ns, "inflation": infl}
    ids = iter(range(300000, 400000))
    res = {}
    seen = []
    real = merge_gc._merge_gc_fused

    def spy(cols, sort_rows, n_sort, params, w):
        out = real(cols, sort_rows, n_sort, params, w)
        seen.append((cols, sort_rows, n_sort, params, w, out[0]))
        return out

    for name in ("native", "router"):
        d = os.path.join(workdir, f"skewed_{name}")
        os.makedirs(d)
        for w in wrappers.values():
            w.launches = 0
        t0 = time.time()
        if name == "native":
            res[name] = compaction._run_native_job(
                readers, d, lambda: next(ids), cutoff, True, False, None)
        else:
            merge_gc._merge_gc_fused = spy
            try:
                res[name] = compaction.run_compaction_job(
                    readers, d, lambda: next(ids), cutoff, True,
                    device=device)
            finally:
                merge_gc._merge_gc_fused = real
        sync()
        secs = time.time() - t0
        out[f"{name}_s"] = secs
        out[f"{name}_rows_per_s"] = sum(ns) / secs
    launches = {k: w.launches for k, w in wrappers.items()}
    check_launches(launches, "skewed")
    if (launches["merge_path_level"] or launches["chunk_split_search"]
            or launches["staged_concat"] or len(seen) != 1):
        raise AssertionError(f"the skewed pick did not take the radix "
                             f"route once: {launches}, {len(seen)} calls")
    same_files(res["router"], res["native"], "skewed pick vs native")
    cols, sort_rows, n_sort, params, w, perm_job = seen.pop()
    errs = {}
    perm = radix.radix_sort(cols, sort_rows, n_sort)
    errs["radix_sort"] = same_or_raise(
        "kernel G (skewed pick)", perm,
        radix.radix_sort_plain(cols, sort_rows, n_sort))
    if not torch.equal(perm, perm_job):
        raise AssertionError("kernel G's perm differs from the job's")
    p_mat = radix.sorted_payload(cols, perm)
    errs["sorted_payload"] = same_or_raise(
        "kernel I.1 (skewed pick)", p_mat,
        radix.sorted_payload_plain(cols, perm))
    r = merge_gc._ROW_WORDS + w
    got = merge_gc.gc_pack(p_mat, r, w, params, 1, cols.shape[1])
    want = merge_gc.gc_pack_plain(p_mat, r, w, params, 1, cols.shape[1])
    errs["gc_pack"] = max(same_or_raise(f"kernel B (skewed pick) {what}",
                                        x, y)
                          for what, x, y in zip(
                              ("packed", "keep", "make_tombstone"), got,
                              want))
    out["n_pad"] = int(cols.shape[1])
    del cols, perm, perm_job, p_mat, got, want
    out.update(rows_out=res["router"].rows_out,
               files=len(res["router"].outputs), launches=launches)
    log(f"skewed pick: {sum(ns)} rows in {ns} (inflation {infl}x) -> "
        f"{out['rows_out']} rows, {out['files']} files == native; router "
        f"{out['router_rows_per_s']:,.0f} rows/s, native "
        f"{out['native_rows_per_s']:,.0f}; launches {launches}; G, I.1, "
        f"B on its {out['n_pad']} lanes == plain")
    paths = [rd.base_path for rd in readers]
    for rd in readers:
        rd.close()
    return out, launches, errs, paths


def skewed_cutoff(args) -> int:
    """The skewed pick's history cutoff: above its L0 runs, which are
    written above every hybrid time of the tablet."""
    ht_base = history_cutoff(args.rows) >> 12
    return (ht_base + (history_cutoff(4 * args.skew_rows) >> 12)) << 12


def split_search_bytes(cols, run_ns, splitters, m, w_route, n_iters):
    """(bytes, chain): the bytes kernel L must move on these inputs (the
    distinct cells its probes read: doc_key_len, and the route words up
    to the first that differs from the splitter; the splitters, the run
    sizes and the output), and the longest chain of dependent loads a
    lane makes on them (`chain_loads_max`: its run size, then in each
    bisection step the route words it reads one after the other, since
    word q + 1 is read only where word q ties; `steps_max`: the most
    bisection steps a lane takes). The probes are those of the kernel's
    bisection."""
    import torch
    from yugabyte_tpu_torch.ops.merge_gc import _u, route_word_mask
    k_pad, ns = run_ns.numel(), splitters.shape[0]
    lo = torch.zeros((k_pad, ns), dtype=torch.int64, device=cols.device)
    hi = run_ns.long()[:, None].expand(k_pad, ns)
    base = torch.arange(k_pad, device=cols.device)[:, None] * m
    sp = _u(splitters)[None]
    cells = set()
    steps = torch.zeros((k_pad, ns), dtype=torch.int64, device=cols.device)
    chain = torch.ones((k_pad, ns), dtype=torch.int64, device=cols.device)
    for _ in range(n_iters):
        live = lo < hi
        if not bool(live.any()):
            break
        mid = (lo + hi) >> 1
        idx = (base + mid).clamp(max=cols.shape[1] - 1)
        kr = (_u(cols[8:8 + w_route][:, idx]).permute(1, 2, 0)
              & _u(route_word_mask(cols[1][idx], w_route, leading=False)))
        diff = kr != sp
        nread = torch.where(diff.any(-1), diff.int().argmax(-1),
                            w_route - 1) + 1
        steps += live.long()
        chain += torch.where(live, nread, 0)
        for i, nr in zip(idx[live].tolist(), nread[live].tolist()):
            cells.add((1, i))
            cells.update((8 + q, i) for q in range(nr))
        lt = torch.zeros_like(live)
        eq = torch.ones_like(live)
        for q in range(w_route):
            lt = lt | (eq & (kr[..., q] < sp[..., q]))
            eq = eq & (kr[..., q] == sp[..., q])
        hi = torch.where(live & ~lt, mid, hi)
        lo = torch.where(live & lt, mid + 1, lo)
    return (4 * (len(cells) + splitters.numel() + k_pad + k_pad * ns),
            {"chain_loads_max": int(chain.max()),
             "steps_max": int(steps.max())})


def chunk_window(starts, lens, k_pad):
    """A chunk's window (starts, lens over the live runs) padded to k_pad
    slots of zero length."""
    s_full = np.zeros(k_pad, np.int64)
    l_full = np.zeros(k_pad, np.int64)
    s_full[:len(starts)], l_full[:len(lens)] = starts, lens
    return s_full, l_full


def chunk_merge_check(kin):
    """Kernels A and B on every carved chunk of the chunked codec job, and
    kernel H's parent payload built from them (`to_parent_products`, what
    D and E read), each against its plain version on the same inputs:
    merge_level_plain per level, gc_pack_plain, and staged_concat_plain of
    the chunks' plain merged prefixes with the index row remapped to
    parent lanes (slot*m + starts[slot] + j) and keep / make-tombstone
    concatenated. The rebuilt payload and make-tombstone bytes must equal
    the job's, and every parent lane's payload the parent cols at its
    index. Returns the max_abs_err of A, B and H."""
    import torch
    from yugabyte_tpu_torch.ops import merge_gc, merge_path, run_merge

    st, m_c, params = kin["staged"], kin["m_c"], kin["params"]
    cols, m, k_pad, w = st.cols_dev, st.m, st.k_pad, st.w
    dev = cols.device
    r = merge_gc._ROW_WORDS + w
    errs = {"merge_path_level": 0, "gc_pack": 0, "staged_concat": 0}
    handles, plain = [], []
    for c, (starts, lens) in enumerate(kin["metas"]):
        s_full, l_full = chunk_window(starts, lens, k_pad)
        carved = run_merge.carve_chunk(cols, s_full, l_full, m, m_c, k_pad)
        sub = run_merge.StagedRuns(carved, m_c, k_pad, w,
                                   [int(x) for x in lens], st.cmp_rows,
                                   st.n_cmp)
        pos = torch.arange(sub.n_pad, dtype=torch.int32, device=dev)
        p_k = p_p = torch.cat([carved, pos[None]])
        length = m_c
        while length < sub.n_pad:
            p_k = merge_path.merge_level(p_k, length, st.cmp_rows)
            p_p = merge_path.merge_level_plain(p_p, length, st.cmp_rows)
            errs["merge_path_level"] = max(
                errs["merge_path_level"],
                same_or_raise(f"kernel A, chunk {c}, L={length}", p_k, p_p))
            length *= 2
        got = merge_gc.gc_pack(p_k, r, w, params, k_pad, m_c)
        want = merge_gc.gc_pack_plain(p_p, r, w, params, k_pad, m_c)
        for what, x, y in zip(("packed", "keep", "make_tombstone"), got,
                              want):
            errs["gc_pack"] = max(errs["gc_pack"], same_or_raise(
                f"kernel B, chunk {c}, {what}", x, y))
        handles.append(run_merge.MergeGCHandle(got[0], sub, p_k, got[1],
                                               got[2]))
        plain.append((p_p, want[1], want[2], int(lens.sum()), starts))
    h = run_merge._ChunkedMergeGCHandle(handles, kin["metas"], st)
    h.to_parent_products()
    ns = [x[3] for x in plain]
    offs = np.concatenate(([0], np.cumsum(ns)[:-1])).tolist()
    tmpl = np.concatenate([merge_gc.pad_template(r),
                           [merge_gc.PAD_SENTINEL]]).astype(np.uint32)
    p_mat = run_merge.staged_concat_plain([x[0] for x in plain], ns, offs,
                                          st.n_pad, tmpl)
    keep = torch.zeros(st.n_pad, dtype=torch.bool, device=dev)
    mk = torch.zeros(st.n_pad, dtype=torch.bool, device=dev)
    for (_p, kp, mkp, n_c, starts), o in zip(plain, offs):
        idx = p_mat[-1, o:o + n_c].long()
        slot = idx // m_c
        first = torch.as_tensor(np.asarray(starts, np.int64), device=dev)
        p_mat[-1, o:o + n_c] = (slot * m + first[slot]
                                + idx % m_c).to(torch.int32)
        keep[o:o + n_c] = kp[:n_c]
        mk[o:o + n_c] = mkp[:n_c]
    for what, x, y in (("payload", h._p_mat, p_mat), ("keep", h._keep_dev,
                                                      keep),
                       ("make_tombstone", h._mk_dev, mk)):
        errs["staged_concat"] = max(errs["staged_concat"], same_or_raise(
            f"the parent products' {what}", x, y))
    # the job's keep bytes were consumed by kernel D (survivor_positions)
    for what, x, y in zip(("payload", "make_tombstone"), kin["parent"],
                          (p_mat, mk)):
        if not torch.equal(x, y):
            raise AssertionError(f"the chunked job's parent {what} differs "
                                 f"from the rebuilt one")
    n = st.n
    step = 1 << 22
    for i in range(0, n, step):
        j = min(n, i + step)
        if not torch.equal(cols[:, p_mat[-1, i:j].long()], p_mat[:r, i:j]):
            raise AssertionError("a parent lane's payload is not the "
                                 "parent cols at its index")
    log(f"chunks: kernels A and B on {len(handles)} carved chunks and the "
        f"parent payload (kernel H, index row remapped) == plain; the "
        f"job's parent products == the rebuilt ones")
    return errs


def chunk_kernel_phase(args, kin, launches, bandwidth):
    """Kernel L and the carve at the chunked codec job's shapes, against
    their plain versions (max_abs_err must be 0): L over the job's parent
    matrix and splitters, the carve for every chunk's windows. Timed with
    CUDA events (the carve at chunk 0) beside their bounds and, for the
    carve, one torch.cat of the windows and the template fills; L also on
    the device (one launch a call, no copy), with the longest chain of
    dependent loads a lane makes (its latency floor comes in main, once
    the point-read phase has measured an HBM load)."""
    import torch
    from yugabyte_tpu_torch.ops import merge_gc, run_merge

    st = kin["staged"]
    cols, m, k_pad, m_c = st.cols_dev, st.m, st.k_pad, kin["m_c"]
    dev = cols.device
    r = cols.shape[0]
    nc, w_route, run_ns, splitters = run_merge._chunk_plan(st, kin["target"])
    rn = torch.from_numpy(run_ns).to(dev)
    sp = torch.from_numpy(splitters.view(np.int32)).to(dev)
    n_iters = int(m).bit_length() + 1
    a_l = (cols, rn, sp, k_pad, m, w_route, n_iters)
    got = run_merge.chunk_split_search(*a_l)
    want = run_merge.chunk_split_search_plain(*a_l)
    err_l = max_abs_err(got, want)
    if err_l or not torch.equal(got, want) or got.shape != (k_pad, nc - 1):
        raise AssertionError(f"kernel L != its plain version (max_abs_err "
                             f"{err_l})")
    l_bytes, l_chain = split_search_bytes(cols, rn, sp, m, w_route, n_iters)
    prof = device_profile(lambda: run_merge.chunk_split_search(*a_l),
                          args.reps)
    one_launch_no_copy("chunk_split_search", prof)
    rows = [{"name": "chunk_split_search", "route": "cuda",
             "source": "yugabyte_tpu_torch/csrc/chunk.cu",
             "replaces": "yugabyte_tpu/ops/run_merge.py:1029",
             "launches": launches["chunk_split_search"], "max_abs_err": err_l,
             "ms": cuda_ms(lambda: run_merge.chunk_split_search(*a_l),
                           args.reps),
             "plain_ms": cuda_ms(
                 lambda: run_merge.chunk_split_search_plain(*a_l), 2),
             "bound_ms": l_bytes / bandwidth * 1e3, "bound_by": "bytes",
             "library_ms": None, "lanes": k_pad * (nc - 1),
             "n_iters": n_iters, "bytes": l_bytes, "chain": l_chain,
             "device_ms": prof["device_ms"],
             "launches_per_call": prof["launches_per_call"]}]
    log(f"kernel chunk_split_search on the device: {prof['device_ms']:.4f} "
        f"ms a call, one launch; longest chain {l_chain}")

    err_c = 0
    for starts, lens in kin["metas"]:
        s_full, l_full = chunk_window(starts, lens, k_pad)
        err = max_abs_err(
            run_merge.carve_chunk(cols, s_full, l_full, m, m_c, k_pad),
            run_merge.carve_chunk_plain(cols, s_full, l_full, m, m_c, k_pad))
        if err:
            raise AssertionError(f"the carve != its plain version "
                                 f"(max_abs_err {err})")
        err_c = max(err_c, err)
    s0, l0 = chunk_window(*kin["metas"][0], k_pad)
    tmpl = merge_gc.u32_to_device(merge_gc.pad_template(r), dev)[:, None]

    def cat_fill():
        pieces = []
        for i in range(k_pad):
            a = i * m + int(s0[i])
            pieces += [cols[:, a:a + int(l0[i])],
                       tmpl.expand(r, m_c - int(l0[i]))]
        return torch.cat(pieces, 1)

    a_c = (cols, s0, l0, m, m_c, k_pad)
    want = run_merge.carve_chunk_plain(*a_c)
    if not torch.equal(cat_fill(), want):
        raise AssertionError("the carve's library yardstick differs")
    launch_only_ms = None
    if cols.is_cuda:
        # the carve's kernel alone, its descriptors and template already on
        # the card: what the wrapper's two blocking uploads add
        from yugabyte_tpu_torch.utils import torch_setup
        parts, ns, offs, sts = run_merge._carve_parts(*a_c)
        desc = run_merge._concat_desc(parts, ns, offs, sts, k_pad * m_c, r,
                                      "carve_chunk")
        desc_dev = torch.tensor(desc, dtype=torch.int64).to(dev)
        tmpl_dev = tmpl[:, 0].contiguous()
        lib = run_merge._concat()

        def launch_only():
            out = torch.empty((r, k_pad * m_c), dtype=torch.int32,
                              device=dev)
            torch_setup.raise_on_cuda_error(lib.ybt_staged_concat(
                desc_dev.data_ptr(), len(desc), r, k_pad * m_c,
                tmpl_dev.data_ptr(), out.data_ptr(),
                torch_setup.stream_ptr(dev)), "carve_chunk")
            return out

        if not torch.equal(launch_only(), want):
            raise AssertionError("the carve's bare launch differs")
        launch_only_ms = cuda_ms(launch_only, args.reps)
    # the windows' cells read, the chunk written, the template and the
    # descriptors read
    c_bytes = 4 * r * (int(l0.sum()) + k_pad * m_c + 1) + 40 * k_pad
    rows.append({"name": "carve_chunk", "route": "cuda",
                 "source": "yugabyte_tpu_torch/csrc/concat.cu",
                 "replaces": "yugabyte_tpu/ops/run_merge.py:1068",
                 "launches": launches["carve_chunk"], "max_abs_err": err_c,
                 "ms": cuda_ms(lambda: run_merge.carve_chunk(*a_c),
                               args.reps),
                 "plain_ms": cuda_ms(
                     lambda: run_merge.carve_chunk_plain(*a_c), 2),
                 "bound_ms": c_bytes / bandwidth * 1e3, "bound_by": "bytes",
                 "library_ms": cuda_ms(cat_fill, 2), "m_c": m_c,
                 "chunk_rows": int(l0.sum()),
                 "launch_only_ms": launch_only_ms})
    for e in rows:
        log(f"kernel {e['name']}: equal; {e['ms']:.4f} ms (plain "
            f"{e['plain_ms']:.4f}, library {e['library_ms']}, bound "
            f"{e['bound_ms']:.6f}), {e['launches']} launches in the chunked "
            f"codec job")
    return rows


# ---------------------------------------------------------------- the mesh


def _mesh_wrappers():
    """The kernel wrappers of the mesh paths, by their names in the
    kernels line (M1-M3 beside every earlier one)."""
    from yugabyte_tpu_torch.parallel import dist_compact
    w = _wrappers()
    w.update(splitter_pick=dist_compact.splitter_pick,
             route_dest=dist_compact.route_dest,
             bucket_scatter=dist_compact.bucket_scatter)
    return w


def check_mesh_launches(launches, attempts, n_shards, what):
    """A mesh job's exact launch counts: M1 once and M2, M3 once a shard
    per attempt (an attempt that overflowed stops before the exchange),
    G, I.1 and B once a shard; no other kernel."""
    want = {k: 0 for k in launches}
    want.update(splitter_pick=attempts, route_dest=n_shards * attempts,
                bucket_scatter=n_shards * attempts, radix_sort=n_shards,
                sorted_payload=n_shards, gc_pack=n_shards)
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected "
                             f"{want}")


def _counted_run(wrappers, fn):
    """fn() with every launch counter set to 0 just before and read just
    after; returns (result, seconds, launches, overflow retries)."""
    from yugabyte_tpu_torch.parallel import dist_compact
    for w in wrappers.values():
        w.launches = 0
    retries = dist_compact.overflow_retries()
    t0 = time.time()
    res = fn()
    sync()
    secs = time.time() - t0
    return (res, secs, {k: w.launches for k, w in wrappers.items()},
            dist_compact.overflow_retries() - retries)


def skewed_prefix_slab(n: int, groups: int, seed: int):
    """n root writes, in random order, over documents whose 24-byte doc
    keys share their first 16 bytes ('Sgroup%02d' padded with '_') within
    each of `groups` prefixes: the 16-byte route cannot tell a group's
    documents apart, so each group lands in one bucket. About 4 versions
    a document; hybrid times unique (no repeated internal key)."""
    from yugabyte_tpu_torch.ops.slabs import KVSlab, ValueArray
    rng = np.random.default_rng(seed)
    doc = rng.integers(0, max(1, n // 4), size=n).astype(np.uint64)
    keys = np.full((n, 24), ord("_"), dtype=np.uint8)
    keys[:, :6] = np.frombuffer(b"Sgroup", dtype=np.uint8)
    g = (doc % groups).astype(np.int64)
    keys[:, 6] = ord("0") + g // 10
    keys[:, 7] = ord("0") + g % 10
    keys[:, 16:] = ((doc[:, None] >> (8 * np.arange(7, -1, -1,
                                                    dtype=np.uint64)))
                    & 0xFF).astype(np.uint8)
    kw = keys.reshape(n, 6, 4).astype(np.uint32)
    words = (kw[:, :, 0] << 24) | (kw[:, :, 1] << 16) | (kw[:, :, 2] << 8) \
        | kw[:, :, 3]
    ht = (rng.permutation(n).astype(np.uint64) + 1) << 12
    return KVSlab(
        key_words=words, key_len=np.full(n, 24, np.int32),
        doc_key_len=np.full(n, 24, np.int32),
        ht_hi=(ht >> 32).astype(np.uint32),
        ht_lo=(ht & 0xFFFFFFFF).astype(np.uint32),
        write_id=np.zeros(n, np.uint32), flags=np.zeros(n, np.uint32),
        ttl_ms=np.zeros(n, np.int64), value_idx=np.arange(n, dtype=np.int32),
        values=ValueArray(rng.integers(0, 256, size=8 * n, dtype=np.uint8),
                          np.arange(n + 1, dtype=np.int64) * 8))


def mesh_phase(args, readers, skew_paths, workdir, comp, card="",
               device="cuda"):
    """The port's mesh paths on 8 virtual shards of one device
    (`make_mesh(8, devices=[device] * 8)`), each with every launch counter
    set to 0 just before it and read just after:
      1. the 10M-row job through `run_compaction_job(device=device,
         mesh=mesh)`: `run_compaction_job_dist_native`; files == the
         native job's; launches exact for its attempts;
      2. the skewed pick's inputs through `run_compaction_job(device=None,
         mesh=mesh)`: the Python path's `distributed_compact`; files ==
         the native job's;
      3. the 10M-row job's DistOutputs: every output file's span ==
         the single-device job's `gather_staged_output_span`;
      4. the overflow retry over a skewed-prefix slab of 2^20 rows at
         capacity_factor 0.05: retries counted, decisions == a first try
         at 2.0 == the single-device radix merge;
      5. the pooled wave: 8 YCSB-A tablets (seeds 0-7, 4 runs each) as one
         `pooled_merge_gc`; `run_compaction_job_with_decisions` files ==
         each tablet's native job; decisions == sequential launches; one
         slot's span == the sequential span.
    Returns (summary, launches per path, kernel-check inputs)."""
    import torch
    from yugabyte_tpu_torch.ops import merge_gc, run_merge
    from yugabyte_tpu_torch.ops.slabs import concat_slabs
    from yugabyte_tpu_torch.parallel import dist_compact
    from yugabyte_tpu_torch.parallel.mesh import make_mesh
    from yugabyte_tpu_torch.storage import compaction
    from yugabyte_tpu_torch.storage.sst import SSTReader
    from yugabyte_tpu_torch.utils import flags

    t_phase = time.time()
    dev = torch.device(device)
    n_shards = 8
    mesh = make_mesh(n_shards, devices=[dev] * n_shards)
    log(f"mesh: {n_shards} virtual shards on {dev} (the machine has "
        f"{torch.cuda.device_count()} CUDA device(s))")
    wrappers = _mesh_wrappers()
    out = {"n_shards": n_shards, "cuda_device_count":
           torch.cuda.device_count()}
    launches = {}
    ids = iter(range(400000, 500000))
    rows = sum(r.props.n_entries for r in readers)
    cutoff = history_cutoff(rows)

    # -- 1: the 10M-row job, the combined path
    captured = {}
    real = dist_compact.distributed_compact_with_outputs

    def spy(slab, params, mesh_, **kw):
        t0 = time.time()
        got = real(slab, params, mesh_, **kw)   # ends in its downloads
        captured.update(slab=slab, params=params, outputs=got[3],
                        dist_s=time.time() - t0)
        return got

    d_native = os.path.join(workdir, "mesh_native")
    os.makedirs(d_native)
    native, native_s, _l, _r = _counted_run(wrappers, lambda: (
        compaction._run_native_job(readers, d_native, lambda: next(ids),
                                   cutoff, True, False, None)))
    d = os.path.join(workdir, "mesh_job")
    os.makedirs(d)
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    dist_compact.distributed_compact_with_outputs = spy
    try:
        res, secs, launches["mesh_job"], retries = _counted_run(
            wrappers, lambda: compaction.run_compaction_job(
                readers, d, lambda: next(ids), cutoff, True, device=device,
                mesh=mesh))
    finally:
        dist_compact.distributed_compact_with_outputs = real
    if "outputs" not in captured:
        raise AssertionError("the mesh job did not reach "
                             "run_compaction_job_dist_native")
    same_files(res, native, "mesh job vs native")
    check_mesh_launches(launches["mesh_job"], retries + 1, n_shards,
                        "mesh job")
    outputs = captured["outputs"]
    out.update(rows=rows, rows_out=res.rows_out, files=len(res.outputs),
               mesh_job_s=secs, mesh_job_rows_per_s=rows / secs,
               mesh_job_dist_step_s=captured["dist_s"],
               native_s=native_s, native_rows_per_s=rows / native_s,
               attempts=retries + 1, capacity=outputs.capacity,
               mesh_job_peak_bytes=(torch.cuda.max_memory_allocated()
                                    if torch.cuda.is_available() else 0))
    log(f"mesh job on {card}: {rows} -> {res.rows_out} rows, "
        f"{len(res.outputs)} "
        f"files == native; {secs:.2f}s ({rows / secs:,.0f} rows/s; the "
        f"distributed step {captured['dist_s']:.3f}s of it, pack and "
        f"upload to decisions down), native "
        f"{rows / native_s:,.0f} rows/s here; this call's codec job "
        f"{comp['codec_rows_per_s']:,.0f}, shell job "
        f"{comp['shell_rows_per_s']:,.0f}; {retries + 1} attempt(s) at "
        f"capacity {outputs.capacity}; launches {launches['mesh_job']}; "
        f"peak device memory {out['mesh_job_peak_bytes']:,} bytes")

    # -- 3: DistOutputs.gather_span against the single-device spans
    max_rows = flags.get_flag("compaction_max_output_entries_per_sst")
    spans = [(a, min(a + max_rows, res.rows_out))
             for a in range(0, res.rows_out, max_rows)]
    slabs = [r.read_all() for r in readers]
    staged = run_merge.stage_runs_from_slabs(slabs, device)
    del slabs
    h = run_merge.launch_unchunked(staged, captured["params"])
    del staged
    pos = run_merge.survivor_positions(h)
    got_spans, _s, launches["mesh_gather_span"], _r = _counted_run(
        wrappers, lambda: [outputs.gather_span(a, b) for a, b in spans])
    want = {k: 0 for k in wrappers}
    want.update(staged_concat=1, survivor_scan=1, span_gather=len(spans))
    if launches["mesh_gather_span"] != want:
        raise AssertionError(f"gather_span launches "
                             f"{launches['mesh_gather_span']}, expected "
                             f"{want}")
    for (a, b), st in zip(spans, got_spans):
        ref = run_merge.gather_staged_output_span(h, pos, a, b)
        if (st.n, st.n_pad) != (ref.n, ref.n_pad) or not torch.equal(
                st.cols_dev, ref.cols_dev):
            raise AssertionError(f"gather_span [{a}, {b}) != the single-"
                                 f"device span")
    del h, pos, got_spans, ref
    out["spans"] = spans
    log(f"DistOutputs.gather_span: spans {spans} == the single-device "
        f"job's; launches H 1, D 1, E {len(spans)}")
    kin = {"slab": captured["slab"], "params": captured["params"],
           "capacity": outputs.capacity, "mesh": mesh}
    del outputs, captured
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    # -- 2: the Python path's branch over the skewed pick's inputs
    skew = [SSTReader(p) for p in skew_paths]
    skew_rows = sum(r.props.n_entries for r in skew)
    if skew_rows < flags.get_flag("distributed_compaction_min_rows"):
        raise AssertionError(f"the skewed pick ({skew_rows} rows) is below "
                             f"distributed_compaction_min_rows")
    s_cut = skewed_cutoff(args)
    reached = []
    real_dc = dist_compact.distributed_compact

    def spy_dc(*a, **k):
        reached.append(1)
        return real_dc(*a, **k)

    d_native = os.path.join(workdir, "mesh_py_native")
    os.makedirs(d_native)
    native = compaction._run_native_job(skew, d_native, lambda: next(ids),
                                        s_cut, True, False, None)
    d = os.path.join(workdir, "mesh_py")
    os.makedirs(d)
    dist_compact.distributed_compact = spy_dc
    try:
        res, secs, launches["mesh_python"], retries = _counted_run(
            wrappers, lambda: compaction.run_compaction_job(
                skew, d, lambda: next(ids), s_cut, True, device=None,
                mesh=mesh))
    finally:
        dist_compact.distributed_compact = real_dc
    if reached != [1]:
        raise AssertionError("the Python path did not reach "
                             "distributed_compact once")
    same_files(res, native, "mesh Python path vs native")
    check_mesh_launches(launches["mesh_python"], retries + 1, n_shards,
                        "mesh Python path")
    for r in skew:
        r.close()
    out.update(python_rows=skew_rows, python_s=secs,
               python_rows_per_s=skew_rows / secs,
               python_attempts=retries + 1)
    log(f"mesh Python path (device=None): {skew_rows} rows -> "
        f"{res.rows_out}, {len(res.outputs)} files == native; "
        f"{skew_rows / secs:,.0f} rows/s; launches {launches['mesh_python']}")

    # -- 4: the overflow retry
    slab = skewed_prefix_slab(1 << 20, 64, args.seed + 2)
    params = merge_gc.GCParams(history_cutoff(1 << 20), True)
    tight, t_s, launches["mesh_overflow"], retries = _counted_run(
        wrappers, lambda: dist_compact.distributed_compact(
            slab, params, mesh, capacity_factor=0.05))
    check_mesh_launches(launches["mesh_overflow"], retries + 1, n_shards,
                        "overflow retry")
    first, _s, _l, retries_2 = _counted_run(
        wrappers, lambda: dist_compact.distributed_compact(slab, params,
                                                           mesh))
    if retries < 1 or retries_2:
        raise AssertionError(f"overflow retries {retries} at 0.05, "
                             f"{retries_2} at 2.0")
    perm, keep, mk = merge_gc.merge_and_gc_device(slab, params, device)
    single = (perm[keep], mk[keep])
    for what, got in (("0.05", tight), ("2.0", first)):
        _cols, k, m, src = got
        if not (np.array_equal(src[k], single[0])
                and np.array_equal(m[k], single[1])):
            raise AssertionError(f"the decisions at capacity factor {what} "
                                 f"differ from the single-device merge")
    out.update(overflow_rows=slab.n, overflow_retries=retries,
               overflow_s=t_s)
    log(f"overflow retry: {slab.n} rows in 64 prefix groups; {retries} "
        f"retries at factor 0.05 (counted), none at 2.0; both == the "
        f"single-device radix merge ({int(keep.sum())} survivors)")
    del slab, tight, first, perm, keep, mk, single

    # -- 5: the pooled wave
    wave = pool_wave_phase(args, workdir, mesh, device, wrappers, ids)
    out["wave"] = wave.pop("summary")
    launches["pool_wave"] = wave.pop("launches")
    out["seconds"] = time.time() - t_phase
    return out, launches, kin


def pool_wave_phase(args, workdir, mesh, device, wrappers, ids):
    """8 YCSB-A tablets (seeds 0-7), each 4 L0 runs of args.wave_rows
    rows, through `stage_pool_slot` -> `pooled_merge_gc` (one wave of 8
    slots, counted) -> `run_compaction_job_with_decisions` per tablet.
    Files == each tablet's native job; decisions == a sequential
    launch_merge_gc per tablet; slot 0's first span == the sequential
    span."""
    import torch
    from yugabyte_tpu_torch.ops import merge_gc, run_merge
    from yugabyte_tpu_torch.parallel import dist_compact
    from yugabyte_tpu_torch.storage import compaction

    n_tab = mesh.size
    n = 4 * args.wave_rows
    tablets = []
    t0 = time.time()
    for seed in range(n_tab):
        in_dir = os.path.join(workdir, f"wave_in{seed}")
        os.makedirs(in_dir)
        runs = synth_ycsb_runs(n, 4, max(1, n // 2), seed)
        tablets.append(write_inputs(runs, in_dir))
    del runs
    log(f"pool wave: wrote {n_tab} tablets of {n} rows in "
        f"{time.time() - t0:.1f}s")
    cutoff = history_cutoff(n)
    natives, native_s = [], 0.0
    for i, readers in enumerate(tablets):
        d = os.path.join(workdir, f"wave_native{i}")
        os.makedirs(d)
        t0 = time.time()
        natives.append(compaction._run_native_job(
            readers, d, lambda: next(ids), cutoff, True, False, None))
        native_s += time.time() - t0
    t0 = time.time()
    slabs = [[r.read_all() for r in readers] for readers in tablets]
    bucket = dist_compact.pool_slot_bucket(slabs[0])
    params = merge_gc.GCParams(cutoff, True)
    jobs = [(dist_compact.stage_pool_slot(s, *bucket), params)
            for s in slabs]
    stage_s = time.time() - t0
    handle, wave_s, launches, _r = _counted_run(
        wrappers, lambda: dist_compact.pooled_merge_gc(mesh, jobs))
    levels = bucket[0].bit_length() - 1
    want = {k: 0 for k in wrappers}
    want.update(merge_path_level=n_tab * levels, gc_pack=n_tab)
    if launches != want:
        raise AssertionError(f"pool wave launches {launches}, expected "
                             f"{want}")
    t0 = time.time()
    for i, readers in enumerate(tablets):
        perm, keep, mk = handle.decisions[i]
        d = os.path.join(workdir, f"wave_out{i}")
        os.makedirs(d)
        res = compaction.run_compaction_job_with_decisions(
            readers, slabs[i], d, lambda: next(ids), cutoff, True, False,
            None, perm[keep], mk[keep], sum(s.n for s in slabs[i]))
        same_files(res, natives[i], f"pool wave tablet {i} vs native")
    write_s = time.time() - t0
    seq0 = None
    for i, s in enumerate(slabs):
        h = run_merge.launch_merge_gc(
            run_merge.stage_runs_from_slabs(s, device), params)
        for a, b in zip(handle.decisions[i], h.result()):
            if not np.array_equal(a, b):
                raise AssertionError(f"pool wave slot {i}'s decisions != "
                                     f"the sequential launch's")
        if i == 0:
            seq0 = h
    n_out = int(handle.decisions[0][1].sum())
    end = min(n_out, 2_000_000)
    got = handle.gather_span(0, 0, end)
    ref = run_merge.gather_staged_output_span(
        seq0, run_merge.survivor_positions(seq0), 0, end)
    if not torch.equal(got.cols_dev, ref.cols_dev):
        raise AssertionError("pool wave slot 0's span != the sequential "
                             "span")
    for readers in tablets:
        for r in readers:
            r.close()
    rows = n_tab * n
    summary = {"tablets": n_tab, "rows": rows, "bucket": list(bucket),
               "stage_s": stage_s, "wave_s": wave_s, "write_s": write_s,
               "wave_rows_per_s": rows / wave_s,
               "pooled_rows_per_s": rows / (stage_s + wave_s + write_s),
               "native_rows_per_s": rows / native_s}
    log(f"pool wave: {n_tab} tablets x {n} rows (bucket k_pad, m, w = "
        f"{bucket}) == native each; wave {wave_s:.3f}s, host staging "
        f"{stage_s:.2f}s, stage C {write_s:.2f}s: "
        f"{summary['pooled_rows_per_s']:,.0f} rows/s against the native "
        f"jobs' {summary['native_rows_per_s']:,.0f}; launches {launches}; "
        f"decisions == sequential, slot 0's span [0, {end}) == sequential")
    return {"summary": summary, "launches": launches}


def mesh_kernel_phase(args, kin, launches, bandwidth):
    """Kernels M1-M3 at the 10M-row mesh job's shard shapes (shard 0 for
    M2 and M3), against their plain versions (max_abs_err must be 0; M3's
    send buffer and overflow word bit for bit), timed with CUDA events
    beside their byte bounds, M1-M3 also on the device (one launch a
    call, no memset, no copy); M3 beside torch.sort(dest, stable=True),
    which gives the stable order alone; the exchange (`_exchange_copies`,
    the job's own) timed beside its byte bound and beside one permuted
    copy of the same stacked sends; the job's routing (M1 once, M2 and M3
    a shard) on the device by kernel, one attempt of it. Returns (rows,
    exchange, routing)."""
    import torch
    from yugabyte_tpu_torch.parallel import dist_compact

    mesh, cap = kin["mesh"], kin["capacity"]
    n_shards = mesh.size
    cols, n_local = dist_compact.stage_sharded_cols(kin["slab"], mesh)
    r = cols[0].shape[0]
    w_route = min(dist_compact._W_ROUTE, r - 8)
    dev = mesh.devices[0]
    samp = dist_compact._sample_matrix(cols, n_local, w_route, dev)
    m1 = (samp, w_route, n_shards)
    split = dist_compact.splitter_pick(*m1)
    err1 = same_or_raise("kernel M1", split,
                         dist_compact.splitter_pick_plain(*m1))
    c0 = cols[0]
    m2 = (c0, split, w_route, n_shards)
    got2 = dist_compact.route_dest(*m2)
    err2 = max(same_or_raise(f"kernel M2 {what}", a, b) for what, a, b in
               zip(("dest", "hist", "real_hist"), got2,
                   dist_compact.route_dest_plain(*m2)))
    dest, hist, real = got2
    m3 = (c0, dest, hist, real, cap, n_shards, 0)
    got3 = dist_compact.bucket_scatter(*m3)
    err3 = max(same_or_raise(f"kernel M3 {what}", a, b) for what, a, b in
               zip(("send", "overflow"), got3,
                   dist_compact.bucket_scatter_plain(*m3)))
    tiles = hist.shape[1]
    width = n_shards * cap
    b1 = samp.numel() * 4 + split.numel() * 4
    b2 = n_local * (4 * (2 + w_route) + 4) + split.numel() * 4 \
        + 2 * hist.numel() * 4
    b3 = (r * n_local + n_local + 2 * n_shards * tiles) * 4 \
        + (r + 1) * width * 4 + 4
    rows = []
    for name, fn, plain, lib, nbytes, err, src_line in (
            ("splitter_pick", lambda: dist_compact.splitter_pick(*m1),
             lambda: dist_compact.splitter_pick_plain(*m1), None, b1, err1,
             125),
            ("route_dest", lambda: dist_compact.route_dest(*m2),
             lambda: dist_compact.route_dest_plain(*m2), None, b2, err2,
             113),
            ("bucket_scatter", lambda: dist_compact.bucket_scatter(*m3),
             lambda: dist_compact.bucket_scatter_plain(*m3),
             lambda: torch.sort(dest, stable=True), b3, err3, 150)):
        rows.append({
            "name": name, "route": "cuda",
            "source": "yugabyte_tpu_torch/csrc/dist.cu",
            "replaces": f"yugabyte_tpu/parallel/dist_compact.py:{src_line}",
            "launches": launches[name], "max_abs_err": err,
            "ms": cuda_ms(fn, args.reps), "plain_ms": cuda_ms(plain, 2),
            "bound_ms": nbytes / bandwidth * 1e3, "bound_by": "bytes",
            "library_ms": cuda_ms(lib, args.reps) if lib else None,
            "bytes": nbytes})
    rows[2]["library_call"] = "torch.sort(dest, stable=True), the order alone"
    rows[2]["shard_lanes"] = n_local
    rows[2]["send_lanes"] = width
    for e, fn, m in ((rows[0], dist_compact.splitter_pick, m1),
                     (rows[1], dist_compact.route_dest, m2),
                     (rows[2], dist_compact.bucket_scatter, m3)):
        prof = device_profile(lambda fn=fn, m=m: fn(*m), args.reps)
        one_launch_no_copy(e["name"], prof)
        e.update(device_ms=prof["device_ms"],
                 launches_per_call=prof["launches_per_call"])
    # M1's latency floor (set in main): one launch and one dependent load,
    # the samples' words; its compare pass in shared memory is not counted
    rows[0].update(samples=int(samp.shape[1]), chain={"chain_loads_max": 1})
    del got3
    # the mesh job's routing, one attempt of it as the job runs it (M1
    # once, M2 and M3 a shard on the job's capacity), device time by
    # kernel: M2 + M3 a job is this attempt's times the job's attempts
    attempts = launches["splitter_pick"]
    by_kernel = {}
    for kname, us in profiled(lambda: dist_compact._route_and_bucket(
            cols, n_local, cap, mesh, w_route), 1):
        ms, k = by_kernel.get(kernel_name(kname), (0.0, 0))
        by_kernel[kernel_name(kname)] = (ms + us / 1e3, k + 1)
    m23 = sum(ms for kname, (ms, _k) in by_kernel.items()
              if kname in ("route_dest_kernel", "bucket_scatter_kernel"))
    if not m23:
        raise AssertionError("the profiler saw no M2 or M3 in the job's "
                             "routing")
    routing = {"attempts": attempts, "m2_m3_device_ms_attempt": m23,
               "m2_m3_device_ms_job": m23 * attempts,
               "device_kernels": {k: list(v) for k, v in by_kernel.items()}}
    log(f"the mesh job's M2 + M3 on the device: {m23:.4f} ms an attempt, "
        f"{attempts} attempt(s): {m23 * attempts:.4f} ms a job "
        f"({routing['device_kernels']})")
    # the exchange: the job's per-destination copies of the 8 shards'
    # send buffers, and for comparison one permuted copy of them stacked
    send_all = torch.arange(n_shards * (r + 1) * width, dtype=torch.int32,
                            device=dev).view(n_shards, r + 1, width)
    sends = list(send_all)
    devs = list(mesh.devices.flat)
    want = send_all.view(n_shards, r + 1, n_shards, cap).permute(2, 1, 0, 3)
    for d, recv in enumerate(dist_compact._exchange_copies(sends, cap,
                                                           devs)):
        if not torch.equal(recv.view(r + 1, n_shards, cap),
                           want[d].to(recv.device)):
            raise AssertionError(f"exchange: recv[{d}] differs")
    del recv
    ex_ms = cuda_ms(lambda: dist_compact._exchange_copies(sends, cap, devs),
                    args.reps)
    perm_ms = cuda_ms(lambda: want.contiguous(), args.reps)
    ex_bytes = 2 * send_all.numel() * 4
    del sends, want, send_all, cols
    exchange = {"ms": ex_ms, "one_permuted_copy_ms": perm_ms,
                "bound_ms": ex_bytes / bandwidth * 1e3, "bytes": ex_bytes}
    for e in rows:
        log(f"kernel {e['name']}: equal; {e['ms']:.4f} ms (plain "
            f"{e['plain_ms']:.4f}, library {e['library_ms']}, bound "
            f"{e['bound_ms']:.6f}; device {e['device_ms']:.4f}), "
            f"{e['launches']} launches in the mesh job")
    log(f"exchange copies: {ex_ms:.4f} ms for {ex_bytes:,} bytes moved "
        f"(one permuted copy {perm_ms:.4f} ms, bound "
        f"{exchange['bound_ms']:.4f} ms)")
    return rows, exchange, routing


# ---------------------------------------------------------------- the scan


def scan_bounds(rows: int):
    """(read time, lower, upper) of the range scan: a read time half way
    through run 1's writes (runs 2 and 3 and half of run 1 are newer), a
    lower bound at user id key_space/5 and an upper bound at 3/5 that is
    longer than the 32-byte key stride (truncated on the device)."""
    span = max(1_000_000, rows // 4)
    key_space = max(1, rows // 2)
    read_ht = (span * 5 // 2) << 12
    lower = b"Suser%08d" % (key_space // 5)
    upper = b"Suser%08d\x00\x00!K" % (3 * key_space // 5) + b"\xff" * 20
    return read_ht, lower, upper


def entries_lockstep(got, want, what: str) -> int:
    """Walk two entry iterators in lockstep; every entry must be equal and
    both must end together. Returns the entry count."""
    import itertools
    n = 0
    for x, y in itertools.zip_longest(got, want):
        if x != y:
            raise AssertionError(f"{what}: entry {n} differs: {x!r} != {y!r}")
        n += 1
    return n


def drain(it):
    """(rows, key + value bytes) of an entry iterator."""
    rows = nbytes = 0
    for k, v, _ht in it:
        rows += 1
        nbytes += len(k) + len(v)
    return rows, nbytes


def check_scan_launches(launches, path, what):
    """The scan's kernels launched; I.2 exactly once on a range scan and
    never on a seq-scan (whose keep is plane 0 of B's packed buffer)."""
    check_launches(launches, path)
    want = 1 if path == "range_scan" else 0
    if launches["bound_pack"] != want:
        raise AssertionError(f"{what}: kernel bound_pack launched "
                             f"{launches['bound_pack']} times, not {want}")


def counted(make_iter, wrappers, what, path, out=None):
    """Iterate make_iter() with every launch counter set to 0 just before;
    once it is drained, require the path's kernels to have launched (the
    device work runs before the first entry is yielded); the counts go
    into `out` when given."""
    for w in wrappers.values():
        w.launches = 0
    yield from make_iter()
    launches = {k: w.launches for k, w in wrappers.items()}
    check_scan_launches(launches, path, what)
    if out is not None:
        out.update(launches)
    log(f"{what}: launches {launches}")


def scan_phase(readers, n_rows, device="cuda"):
    """The snapshot scan path over the tablet's 4 input SSTs:

    1. full-tablet seq-scan: `visible_entries_sources` over
       SlabSource(read_all()) at a read time above every write, no bounds,
       drained; seconds from the first read_all to the drained iterator;
       every launch counter set to 0 just before and read just after;
    2. the same for the native host reference `_visible_entries_host`;
    3. both walked in lockstep (entry for entry) over their first 2^20
       entries, with the counters set to 0 before that seq-scan too and
       G, H, I.1 and B required to launch, I.2 not (the unbounded keep is
       plane 0 of B's packed buffer);
    4. a range scan at a read time inside the runs' span, with a lower and
       a truncated upper bound, in lockstep with the host reference, its
       counters likewise set to 0 before and checked after: I.2's bounded
       mask runs on the card exactly once within the main run.
    Returns (summary, the seq-scan's launches, the range scan's, the read
    time).
    """
    import torch
    from yugabyte_tpu_torch.ops import scan

    read_ht = history_cutoff(n_rows)
    wrappers = _wrappers()
    out = {}

    def sources():
        return [scan.SlabSource(r.read_all()) for r in readers]

    for w in wrappers.values():
        w.launches = 0
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    rows, nbytes = drain(scan.visible_entries_sources(sources(), read_ht,
                                                      device=device))
    sync()
    secs = time.time() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    out["peak_bytes"] = (torch.cuda.max_memory_allocated()
                         if torch.cuda.is_available() else 0)
    check_scan_launches(launches, "scan", "seq-scan")
    t0 = time.time()
    h_rows, h_bytes = drain(scan._visible_entries_host(
        [r.read_all() for r in readers], read_ht, None, None))
    h_secs = time.time() - t0
    out.update(rows=rows, bytes=nbytes, seconds=secs,
               mb_per_s=nbytes / secs / 1e6, rows_per_s=rows / secs,
               host_rows=h_rows, host_bytes=h_bytes, host_seconds=h_secs,
               host_mb_per_s=h_bytes / h_secs / 1e6,
               host_rows_per_s=h_rows / h_secs)
    log(f"seq-scan: {rows} rows, {nbytes} bytes in {secs:.2f}s "
        f"({out['mb_per_s']:.1f} MB/s, {out['rows_per_s']:,.0f} rows/s); "
        f"host reference {h_rows} rows in {h_secs:.2f}s "
        f"({out['host_mb_per_s']:.1f} MB/s); launches {launches}")
    if (rows, nbytes) != (h_rows, h_bytes) or rows == 0:
        raise AssertionError("seq-scan and host reference disagree on rows "
                             "or bytes")
    srcs = sources()
    slabs = [s.slab for s in srcs]
    # the first page in lockstep (the device resolves the whole tablet
    # before its first entry; the host drain is what a page cuts)
    page = 1 << 20
    for w in wrappers.values():
        w.launches = 0
    stream = scan.visible_entries_sources(srcs, read_ht, device=device)
    n = entries_lockstep(
        itertools.islice(stream, page),
        itertools.islice(scan._visible_entries_host(slabs, read_ht, None,
                                                    None), page),
        "seq-scan")
    stream.close()
    lock_launches = {k: w.launches for k, w in wrappers.items()}
    check_scan_launches(lock_launches, "scan", "seq-scan (lockstep)")
    log(f"seq-scan (lockstep): launches {lock_launches}")
    log(f"seq-scan == host reference, entry for entry (the first {n} "
        f"entries; all {rows} agree in rows and bytes)")
    r_ht, lower, upper = scan_bounds(n_rows)
    t0 = time.time()
    range_launches = {}
    n_range = entries_lockstep(
        counted(lambda: scan.visible_entries_sources(srcs, r_ht, lower,
                                                     upper, device=device),
                wrappers, "range scan", "range_scan", range_launches),
        scan._visible_entries_host(slabs, r_ht, lower, upper), "range scan")
    if n_range == 0:
        raise AssertionError("the range scan found no entry")
    out.update(range_rows=n_range, range_read_ht=r_ht,
               range_check_seconds=time.time() - t0)
    log(f"range scan at ht {r_ht >> 12} in [{lower!r}, {upper[:16]!r}...) "
        f"== host reference ({n_range} entries)")
    del srcs, slabs
    return out, launches, range_launches, read_ht


def scan_breakdown(readers, read_ht, device="cuda"):
    """Seconds of each stage of the seq-scan, run one after the other with
    the same module functions, each ended by a synchronize: read_all, host
    pack + upload, kernel H (concat), kernel G (radix), kernels I.1 + B
    (the unbounded keep is plane 0 of B's packed buffer, as `_scan_fused`
    takes it: no I.2), the decisions down, the host drain. Returns the
    stages and the tensors the kernel phase checks G, H and I on."""
    from yugabyte_tpu_torch.ops import merge_gc, radix, scan
    from yugabyte_tpu_torch.storage.device_cache import concat_staged

    out = {}
    t0 = time.time()
    srcs = [scan.SlabSource(r.read_all()) for r in readers]
    out["read_all_s"] = time.time() - t0
    t0 = time.time()
    staged = [merge_gc.stage_slab(s.slab, device) for s in srcs]
    sync()
    out["pack_upload_s"] = time.time() - t0
    t0 = time.time()
    cat = concat_staged(staged)
    sync()
    out["concat_h_s"] = time.time() - t0
    t0 = time.time()
    perm = radix.radix_sort(cat.cols_dev, cat.sort_rows, cat.n_sort)
    sync()
    out["radix_g_s"] = time.time() - t0
    t0 = time.time()
    w = cat.w
    p_mat = radix.sorted_payload(cat.cols_dev, perm)
    packed, keep, _mk = merge_gc.gc_pack(
        p_mat, merge_gc._ROW_WORDS + w, w, merge_gc.GCParams(read_ht, True),
        1, cat.n_pad, snapshot=True)
    keep_p = packed[:, 0].contiguous()
    sync()
    out["gather_gc_s"] = time.time() - t0
    t0 = time.time()
    perm_h = perm.cpu().numpy()
    keep_h = merge_gc._unpack_bits(keep_p.cpu().numpy(), cat.n_pad) \
        & (perm_h < cat.n)
    out["decisions_down_s"] = time.time() - t0
    t0 = time.time()
    rows, _nbytes = drain(scan.survivor_entries(srcs, perm_h, keep_h))
    out["host_drain_s"] = time.time() - t0
    out["rows"] = rows
    tensors = {"staged": staged, "cat": cat, "perm": perm, "p_mat": p_mat,
               "keep": keep}
    return out, tensors


def scan_kernel_phase(args, t, launches, codec_launches, bandwidth, n_rows,
                      range_launches):
    """Kernels G, H, I.1 and I.2 against their plain versions at the
    seq-scan's shapes (max_abs_err must be 0, perm identical), timed with
    CUDA events beside their bounds and one PyTorch call that computes the
    same function (G: stable torch.sort per row on u32 keys; H: torch.cat
    plus the template fill; I.1: torch.index_select). I.2 runs with the
    range scan's bounds and counts the range scan's launches
    (`range_launches`); the seq-scan launches none."""
    import torch
    from yugabyte_tpu_torch.ops import merge_gc, radix, run_merge, scan

    cat, staged, perm = t["cat"], t["staged"], t["perm"]
    cols = cat.cols_dev
    r, n = cols.shape
    w = cat.w
    rows = []

    def entry(name, source, replaces, err, ms, plain_ms, nbytes, lib_ms,
              extra=None):
        e = {"name": name, "route": "cuda",
             "source": f"yugabyte_tpu_torch/csrc/{source}",
             "replaces": replaces, "launches": launches[name],
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": nbytes / bandwidth * 1e3, "bound_by": "bytes",
             "library_ms": lib_ms}
        e.update(extra or {})
        log(f"kernel {name}: equal; {ms:.4f} ms (plain {plain_ms:.4f}, "
            f"library {lib_ms}, bound {e['bound_ms']:.4f}), "
            f"{launches[name]} launches in the seq-scan")
        rows.append(e)

    def check(name, got, want):
        err = max_abs_err(got, want)
        if err or not torch.equal(got, want):
            raise AssertionError(f"kernel {name} != its plain version "
                                 f"(max_abs_err {err})")
        return err

    # G: the seq-scan's pruned schedule over the concatenated matrix
    sched = [int(x) for x in cat.sort_rows[:cat.n_sort]]
    err = check("radix_sort", radix.radix_sort(cols, sched, len(sched)),
                radix.radix_sort_plain(cols, sched, len(sched)))
    if not torch.equal(radix.radix_sort(cols, sched, len(sched)), perm):
        raise AssertionError("kernel G's perm differs between two calls")

    def torch_sort_chain():
        order = torch.arange(n, device=cols.device)
        for row in sched:
            inv = -1 if merge_gc._ROW_HT_HI <= row <= merge_gc._ROW_WID else 0
            # u32 order as int32 order: flip the sign bit
            key = cols[row][order] ^ inv ^ (-(1 << 31))
            order = order[torch.sort(key, stable=True).indices]
        return order

    # the statistics launches against their plain versions, and the plan
    # they give: the sorted prefix before the tail block of equal (pad)
    # columns, the 8-bit passes kept and dropped per scheduled row
    counts, tail = radix.sort_stats(cols, sched)
    want_c, want_t = radix.sort_stats_plain(cols, sched)
    err = max(err, check("radix_sort", counts, want_c),
              check("radix_sort", tail, want_t))
    plan, n_prefix, at = radix.sort_plan(counts.cpu().numpy(),
                                         tail.cpu().numpy(), sched, n)
    passes = {str(row): {"kept": [int(d) for r_, d in plan[:, :2]
                                  if r_ == row]} for row in sched}
    for v in passes.values():
        v["dropped"] = [d for d in range(4) if d not in v["kept"]]
    log(f"kernel G's plan: the first {n_prefix} of {n} columns sorted, the "
        f"tail block placed at {at}; {len(plan)} of {4 * len(sched)} "
        f"passes kept; per row {passes}")

    def g():
        return radix.radix_sort(cols, sched, len(sched))
    entry("radix_sort", "radix.cu", "yugabyte_tpu/ops/merge_gc.py:181", err,
          cuda_ms(g, args.reps),
          cuda_ms(lambda: radix.radix_sort_plain(cols, sched, len(sched)), 2),
          (len(sched) + 1) * n * 4, cuda_ms(torch_sort_chain, 2),
          dict(device_profile(g, args.reps), n_sort=len(sched), rows=sched,
               n_prefix=n_prefix, tail_at=at, passes_kept=len(plan),
               passes=passes))
    log(f"kernel G on the device: {rows[-1]['device_ms']:.4f} ms, "
        f"{rows[-1]['launches_per_call']:g} launches, "
        f"{rows[-1]['memsets_per_call']:g} memsets and "
        f"{rows[-1]['copies_per_call']:g} copies a call")

    # H: the 4 staged inputs into the concatenated matrix
    parts = [s.cols_dev for s in staged]
    ns = [s.n for s in staged]
    offs = np.concatenate(([0], np.cumsum(ns)[:-1])).tolist()
    tmpl = merge_gc.pad_template(r)
    err = check("staged_concat",
                run_merge.staged_concat(parts, ns, offs, n, tmpl),
                run_merge.staged_concat_plain(parts, ns, offs, n, tmpl))
    tmpl_dev = merge_gc.u32_to_device(tmpl, cols.device)
    total = sum(ns)

    def cat_fill():
        out = torch.empty((r, n), dtype=torch.int32, device=cols.device)
        out[:, :total] = torch.cat([p[:, :k] for p, k in zip(parts, ns)], 1)
        out[:, total:] = tmpl_dev[:, None]
        return out

    entry("staged_concat", "concat.cu", "yugabyte_tpu/ops/run_merge.py:672",
          err, cuda_ms(lambda: run_merge.staged_concat(parts, ns, offs, n,
                                                        tmpl), args.reps),
          cuda_ms(lambda: run_merge.staged_concat_plain(parts, ns, offs, n,
                                                        tmpl), 2),
          sum(p.shape[0] * k for p, k in zip(parts, ns)) * 4 + r * n * 4,
          cuda_ms(cat_fill, 2), {"launches_codec_job":
                                 codec_launches["staged_concat"]})
    del parts, staged, t["staged"]

    # I.1: the sorted payload
    err = check("sorted_payload", radix.sorted_payload(cols, perm),
                radix.sorted_payload_plain(cols, perm))
    perm_l = perm.long()
    entry("sorted_payload", "scan.cu", "yugabyte_tpu/ops/scan.py:56", err,
          cuda_ms(lambda: radix.sorted_payload(cols, perm), args.reps),
          cuda_ms(lambda: radix.sorted_payload_plain(cols, perm), 2),
          2 * (r + 1) * n * 4,
          cuda_ms(lambda: torch.index_select(cols, 1, perm_l), 2))
    del perm_l

    # I.2: the range scan's bounds over the seq-scan's sorted payload
    p_mat, keep = t["p_mat"], t["keep"]
    _r_ht, lower, upper = scan_bounds(n_rows)
    lo_w, lo_l = scan._pack_bound(lower, w)
    hi_w, hi_l = scan._pack_bound(upper[:4 * w], w)
    args_i2 = (p_mat, keep, w, lo_w, lo_l, hi_w, hi_l, True, True, True)
    err = check("bound_pack", scan.bound_pack(*args_i2),
                scan.bound_pack_plain(*args_i2))
    nbytes, sectors = bound_pack_bytes(p_mat, keep, w, lo_w, hi_w)

    def i2():
        return scan.bound_pack(*args_i2)
    prof = device_profile(i2, args.reps)
    entry("bound_pack", "scan.cu", "yugabyte_tpu/ops/scan.py:59", err,
          cuda_ms(i2, args.reps),
          cuda_ms(lambda: scan.bound_pack_plain(*args_i2), 2), nbytes, None,
          dict(prof, bound_sectors_ms=sectors / bandwidth * 1e3,
               launches_seq_scan=launches["bound_pack"]))
    rows[-1]["launches"] = range_launches["bound_pack"]
    one_launch_no_copy("bound_pack", prof)
    log(f"kernel I.2 on the device: {prof['device_ms']:.4f} ms (bound "
        f"{rows[-1]['bound_ms']:.4f}, in sectors "
        f"{rows[-1]['bound_sectors_ms']:.4f}); {rows[-1]['launches']} launch "
        f"in the range scan, {launches['bound_pack']} in the seq-scan")
    return rows


def one_launch_no_copy(name, prof, memsets=0):
    """A wrapper call must launch one kernel, copy nothing and make
    `memsets` memsets."""
    if prof["launches_per_call"] != 1 or prof["copies_per_call"] \
            or prof["memsets_per_call"] != memsets:
        raise AssertionError(f"kernel {name}: a call made {prof}, not one "
                             f"launch, no copy and {memsets} memsets")


def sector_bytes(need) -> int:
    """Bytes of the 32-byte sectors that hold a lane of `need` (bool [rows,
    n] over rows of 4-byte words, n a multiple of 8): each sector that any
    lane must read counted once."""
    rows, n = need.shape
    return 32 * int(need.reshape(rows, n // 8, 8).any(-1).sum())


def bound_pack_bytes(p_mat, keep, w, lo_w, hi_w):
    """(bytes, sector bytes) kernel I.2 must move on these inputs: the keep
    bytes, the packed words out, and the rows each kept lane must read: key
    word j while the lane is tied with a bound it has not failed (the two
    compares share the leading words, so a word is counted once), key_len
    where a tie lasts through all w words. Bytes count 4 a word; sector
    bytes count each 32-byte sector that any lane must read once."""
    import torch
    from yugabyte_tpu_torch.ops.merge_gc import _ROW_WORDS, _u
    n = p_mat.shape[1]
    alive = keep.bool().clone()
    tie_lo, tie_hi = alive.clone(), alive.clone()
    need = torch.zeros((w + 1, n), dtype=torch.bool, device=p_mat.device)
    for j in range(w):
        need[j] = (tie_lo | tie_hi) & alive
        x = _u(p_mat[_ROW_WORDS + j])
        lo, hi = int(lo_w[j]), int(hi_w[j])
        d = tie_lo & (x != lo)
        alive &= ~(d & (x < lo))
        tie_lo &= ~d
        d = tie_hi & (x != hi)
        alive &= ~(d & (x > hi))
        tie_hi &= ~d
    need[w] = (tie_lo | tie_hi) & alive
    out = n + n // 8
    return out + 4 * int(need.sum()), out + sector_bytes(need)


# ------------------------------------------------------------ the pushdown
#
# One tablet of TPC-H SF1 lineitem as a YCQL table (TPC-H spec 1.4, the
# dbgen distributions of 4.2.3): l_orderkey INT64 the hash key,
# l_linenumber INT32 the range key, four value columns. Decimals are
# integers (cents, percent) and dates days since 1970-01-01: the pushdown
# stages 12 value bytes and compiles integer and bool columns only.

LINEITEM_COLS = (("l_orderkey", "INT64"), ("l_linenumber", "INT32"),
                 ("l_quantity", "INT64"), ("l_extendedprice", "INT64"),
                 ("l_discount", "INT32"), ("l_shipdate", "INT32"))
_VALUE_COLS = ("l_quantity", "l_extendedprice", "l_discount", "l_shipdate")
SF1_ORDERS = 1_500_000
# days since 1970-01-01: dbgen's STARTDATE 1992-01-01, ENDDATE 1998-12-31
# less 151 days (the last order date), and the queries' literals
D_START, D_LAST_ORDER = 8035, 10440
D_1998_09_02, D_1994_01_01, D_1995_01_01, D_1998_08_01 = \
    10471, 8766, 9131, 10439
# op kinds: INSERT, UPDATE l_quantity, UPDATE l_discount = NULL, DELETE_ROW
OP_INSERT, OP_SET_QTY, OP_NULL_DISC, OP_DELETE = 0, 1, 2, 3
_DOC_KEY_LEN = 23      # 'G' hash16 'I' orderkey8 '!' 'I' linenumber8 '!'


def lineitem_schema():
    from yugabyte_tpu_torch.common.schema import ColumnSchema, DataType, Schema
    return Schema([ColumnSchema(n, DataType[t]) for n, t in LINEITEM_COLS],
                  num_hash_key_columns=1, num_range_key_columns=1)


def _biased(v) -> np.ndarray:
    """v + 2^63 mod 2^64 of int64 values, as uint64."""
    return np.asarray(v, np.int64).view(np.uint64) ^ np.uint64(1 << 63)


def _int_payload(v) -> np.ndarray:
    """[n, 9] bytes of each int's encoding: kInt64, then v + 2^63 as 8
    big-endian bytes (docdb/doc_key.PrimitiveValue)."""
    out = np.empty((len(v), 9), dtype=np.uint8)
    out[:, 0] = ord("I")
    out[:, 1:] = _biased(v).astype(">u8").view(np.uint8).reshape(-1, 8)
    return out


def _hash16(payload: np.ndarray) -> np.ndarray:
    """common/partition.hash_column_compound_value of each row of
    encoded hash columns: FNV-1a 64 folded to 16 bits."""
    h = np.full(payload.shape[0], 0xCBF29CE484222325, dtype=np.uint64)
    prime = np.uint64(0x100000001B3)
    for j in range(payload.shape[1]):
        h ^= payload[:, j].astype(np.uint64)
        h *= prime
    h ^= h >> np.uint64(32)
    h ^= h >> np.uint64(16)
    return (h & np.uint64(0xFFFF)).astype(np.int64)


def lineitem_rows(sf_orders: int, seed: int, tablet=(0, 0x8000)) -> dict:
    """The line items of the orders among TPC-H's first sf_orders whose
    partition hash falls in the tablet's range (the first of two hash
    tablets by default), as numpy columns. Order keys are dbgen's sparse
    keys (8 of every 32); per order 1-7 lines and an order date in
    [STARTDATE, ENDDATE - 151]; per line a quantity in 1-50, a part key in
    1-200,000 whose retail price in cents is 90000 + (pk / 10) mod 20001
    + 100 (pk mod 1000), the extended price quantity x retail, a discount
    in 0-10 percent and a ship date 1-121 days after the order date."""
    rng = np.random.default_rng(seed)
    i = np.arange(sf_orders, dtype=np.int64)
    okey = (i // 8) * 32 + i % 8 + 1
    h = _hash16(_int_payload(okey))
    mine = (h >= tablet[0]) & (h < tablet[1])
    okey, h = okey[mine], h[mine]
    lcnt = rng.integers(1, 8, size=len(okey))
    odate = rng.integers(D_START, D_LAST_ORDER + 1, size=len(okey))
    order = np.repeat(np.arange(len(okey)), lcnt)
    n = len(order)
    line = np.arange(n) - np.repeat(np.cumsum(lcnt) - lcnt, lcnt) + 1
    qty = rng.integers(1, 51, size=n)
    pk = rng.integers(1, 200_001, size=n)
    retail = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)
    return {"orderkey": okey[order], "hash": h[order], "linenumber": line,
            "l_quantity": qty, "l_extendedprice": qty * retail,
            "l_discount": rng.integers(0, 11, size=n),
            "l_shipdate": odate[order] + rng.integers(1, 122, size=n)}


def lineitem_ops(rows: dict, seed: int, n_runs: int = 3) -> dict:
    """The writes, as op arrays (kind, row, value, run): each row's INSERT
    in one of runs 0..n_runs-1 at random, so the runs overlap in key order
    as flushes do; then run n_runs: UPDATE l_quantity of 2% of the rows,
    l_discount = NULL of 1%, DELETE_ROW of 1%."""
    rng = np.random.default_rng(seed + 1)
    n = len(rows["orderkey"])
    kind, row = [np.full(n, OP_INSERT)], [np.arange(n)]
    value, run = [np.zeros(n, np.int64)], [rng.integers(0, n_runs, size=n)]
    for k, frac in ((OP_SET_QTY, 0.02), (OP_NULL_DISC, 0.01),
                    (OP_DELETE, 0.01)):
        sel = np.flatnonzero(rng.random(n) < frac)
        kind.append(np.full(len(sel), k))
        row.append(sel)
        value.append(rng.integers(1, 51, size=len(sel)) if k == OP_SET_QTY
                     else np.zeros(len(sel), np.int64))
        run.append(np.full(len(sel), n_runs))
    return {"kind": np.concatenate(kind), "row": np.concatenate(row),
            "value": np.concatenate(value), "run": np.concatenate(run)}


def encode_lineitem(rows: dict, ops: dict) -> dict:
    """Every entry the ops write, in op order, as QLWriteOp.to_kv_pairs
    writes them: an INSERT the liveness column (write id 0) and the four
    value columns (1-4), an UPDATE its column (a NULL a column tombstone),
    a DELETE_ROW a tombstone at the doc key. Returns numpy arrays: op,
    write id, rank (0 the doc key, 1 liveness, 2 + cid a column: the key
    order below the doc key), the key as 7 big-endian words and its
    length, the value bytes [m, 9] and length, and the tombstone flag."""
    kind, row = ops["kind"], ops["row"]
    per_op = np.where(kind == OP_INSERT, 5, 1)
    op = np.repeat(np.arange(len(kind)), per_op)
    wid = np.arange(len(op)) - np.repeat(np.cumsum(per_op) - per_op, per_op)
    k, r = kind[op], row[op]
    rank = np.select([k == OP_INSERT, k == OP_SET_QTY, k == OP_NULL_DISC],
                     [1 + wid, 2, 4], 0)
    # 'G' hash16 'I' orderkey8 '!' 'I' linenumber8 '!' ['J'|'K' cid16]
    ok, ln = _biased(rows["orderkey"][r]), _biased(rows["linenumber"][r])
    sub_tag = np.select([rank == 1, rank > 1], [ord("J"), ord("K")], 0)
    cid = np.where(rank == 1, 1, np.maximum(rank - 2, 0))
    u = np.uint64
    words = np.stack([
        (u(ord("G")) << u(24)) | (rows["hash"][r].astype(u) << u(8))
        | u(ord("I")),
        ok >> u(32), ok & u(0xFFFFFFFF),
        (u(ord("!")) << u(24)) | (u(ord("I")) << u(16)) | (ln >> u(48)),
        (ln >> u(16)) & u(0xFFFFFFFF),
        ((ln & u(0xFFFF)) << u(16)) | (u(ord("!")) << u(8))
        | sub_tag.astype(u),
        np.where(rank > 0, cid, 0).astype(u) << u(16)], axis=1)
    cols = np.stack([rows[c] for c in _VALUE_COLS])
    ival = np.where(k == OP_SET_QTY, ops["value"][op],
                    cols[np.clip(rank - 2, 0, 3), r])
    is_int = (k == OP_SET_QTY) | ((k == OP_INSERT) & (wid > 0))
    tomb = (k == OP_NULL_DISC) | (k == OP_DELETE)
    val = _int_payload(ival)
    val[~is_int, 0] = np.where(tomb[~is_int], ord("X"), ord("$"))
    return {"op": op, "wid": wid, "rank": rank,
            "key_words": words.astype(np.uint32),
            "key_len": np.where(rank > 0, 26, _DOC_KEY_LEN).astype(np.int32),
            "val": val, "val_len": np.where(is_int, 9, 1), "tomb": tomb}


def lineitem_runs(rows: dict, ops: dict, seed: int):
    """The sorted runs (KVSlabs) of the ops' entries and the read times:
    run g's ops take the hybrid times span (g + 1) + a permutation of its
    ops, span = max(10^6, ops per run), write ids 0..k-1 within an op.
    Returns (runs, read time above every write, read time between the
    last INSERT run and the update run)."""
    from yugabyte_tpu_torch.ops.slabs import (FLAG_TOMBSTONE, KVSlab,
                                              ValueArray)
    rng = np.random.default_rng(seed + 2)
    ent = encode_lineitem(rows, ops)
    n_runs = int(ops["run"].max()) + 1
    counts = np.bincount(ops["run"], minlength=n_runs)
    span = max(1_000_000, int(counts.max()))
    op_ht = np.zeros(len(ops["kind"]), dtype=np.uint64)
    for g in range(n_runs):
        sel = np.flatnonzero(ops["run"] == g)
        op_ht[sel] = (span * (g + 1) + rng.permutation(len(sel))) << 12
    run_of, ht = ops["run"][ent["op"]], op_ht[ent["op"]]
    r = ops["row"][ent["op"]]
    # run, then the key order: hash, order key, line number, rank (a key
    # is written at most once per run)
    u = np.uint64
    order = np.argsort(
        (run_of.astype(u) << u(60)) | (rows["hash"][r].astype(u) << u(40))
        | (rows["orderkey"][r].astype(u) << u(8))
        | (rows["linenumber"][r].astype(u) << u(4)) | ent["rank"].astype(u),
        kind="stable")
    bounds = np.concatenate(([0], np.cumsum(np.bincount(run_of,
                                                        minlength=n_runs))))
    runs = []
    for g in range(n_runs):
        sel = order[bounds[g]:bounds[g + 1]]
        n = len(sel)
        vlen = ent["val_len"][sel]
        valid = np.arange(9)[None, :] < vlen[:, None]
        runs.append(KVSlab(
            key_words=ent["key_words"][sel], key_len=ent["key_len"][sel],
            doc_key_len=np.full(n, _DOC_KEY_LEN, dtype=np.int32),
            ht_hi=(ht[sel] >> u(32)).astype(np.uint32),
            ht_lo=(ht[sel] & u(0xFFFFFFFF)).astype(np.uint32),
            write_id=ent["wid"][sel].astype(np.uint32),
            flags=np.where(ent["tomb"][sel], FLAG_TOMBSTONE, 0)
            .astype(np.uint32),
            ttl_ms=np.zeros(n, dtype=np.int64),
            value_idx=np.arange(n, dtype=np.int32),
            values=ValueArray(ent["val"][sel][valid], np.concatenate(
                ([0], np.cumsum(vlen))).astype(np.int64))))
    return runs, (span * (n_runs + 1)) << 12, ((span * n_runs) << 12) - 1


def pushdown_queries(schema):
    """name -> (mode, ScanSpec) of the phase's queries (TPC-H Q1 and Q6
    without GROUP BY and, for Q6, without its fifth conjunct
    l_quantity < 24: the kernels hold 4 predicate slots)."""
    from yugabyte_tpu_torch.docdb import scan_spec as ss

    def pred(c, op, v):
        return ss.compile_predicate(schema, c, op, v)

    def agg(f, c):
        return ss.compile_aggregate(schema, f, c)

    q1 = ss.ScanSpec(
        (pred("l_shipdate", "<=", D_1998_09_02),),
        (agg("count", None),)
        + tuple(agg(f, c) for c in ("l_quantity", "l_extendedprice")
                for f in ("sum", "min", "max")))
    q6 = ss.ScanSpec(
        (pred("l_shipdate", ">=", D_1994_01_01),
         pred("l_shipdate", "<", D_1995_01_01),
         pred("l_discount", ">=", 5), pred("l_discount", "<=", 7)),
        (agg("count", None), agg("sum", "l_extendedprice")))
    rows = ss.ScanSpec((pred("l_quantity", "<", 24),
                        pred("l_discount", "!=", 6),
                        pred("l_shipdate", ">=", D_1998_08_01)))
    if None in q1.predicates + q1.aggregates + q6.predicates \
            + q6.aggregates + rows.predicates:
        raise AssertionError("a query did not compile for the pushdown")
    return {"q1_agg": ("aggregate", q1), "q6_agg": ("aggregate", q6),
            "filter_rows": ("filtered", rows)}


class LineitemOracle:
    """The host reference of the pushdown queries, independent of the
    pushdown code: the native C++ heap merge + GC in snapshot shape
    (`compact_cpu_baseline` at cutoff = read time, the engine of
    `_visible_entries_host`), the visible entries assembled into rows with
    numpy (a row exists iff its liveness column or a value column is
    visible), and the predicates and aggregates evaluated over the rows
    under the two NULL contracts."""

    _OPS = {"=": np.equal, "!=": np.not_equal, "<": np.less,
            "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal}

    def __init__(self, slabs, read_ht: int):
        from yugabyte_tpu_torch.ops.slabs import concat_slabs
        from yugabyte_tpu_torch.storage.cpu_baseline import \
            compact_cpu_baseline
        merged = concat_slabs(slabs)
        offsets = np.cumsum([0] + [s.n for s in slabs]).tolist()
        order, keep, _ = compact_cpu_baseline(merged, offsets, read_ht, True)
        idx = order[keep]
        ht = (merged.ht_hi[idx].astype(np.uint64) << np.uint64(32)) \
            | merged.ht_lo[idx]
        idx = idx[ht <= np.uint64(read_ht)]
        kb = merged.key_words[idx].astype(">u4").view(np.uint8) \
            .reshape(len(idx), -1)
        doc = np.concatenate([kb[:, :_DOC_KEY_LEN],
                              np.zeros((len(idx), 1), np.uint8)], 1) \
            .view(">u8").reshape(len(idx), -1)
        new_doc = np.ones(len(idx), dtype=bool)
        new_doc[1:] = (doc[1:] != doc[:-1]).any(axis=1)
        self.doc = np.cumsum(new_doc) - 1
        self.n_rows = int(self.doc[-1]) + 1 if len(idx) else 0
        va = merged.values
        start = va.offsets[merged.value_idx[idx].astype(np.int64)]
        data = np.concatenate([va.data, np.zeros(9, np.uint8)])
        val = np.lib.stride_tricks.sliding_window_view(data, 9)[start]
        tag = val[:, 0]
        ival = (np.ascontiguousarray(val[:, 1:]).view(">u8")[:, 0]
                .astype(np.uint64) ^ np.uint64(1 << 63)).view(np.int64)
        is_col = (merged.key_len[idx] == 26) & (kb[:, 23] == ord("K"))
        cid = (kb[:, 24].astype(np.int64) << 8) | kb[:, 25]
        self.cols = {}
        for c, name in enumerate(_VALUE_COLS):
            sel = is_col & (cid == c) & (tag == ord("I"))
            have = np.zeros(self.n_rows, dtype=bool)
            val = np.zeros(self.n_rows, dtype=np.int64)
            have[self.doc[sel]] = True
            val[self.doc[sel]] = ival[sel]
            self.cols[name] = (have, val)
        self.merged, self.idx = merged, idx

    def passing(self, spec, wire: bool) -> np.ndarray:
        """Rows satisfying every predicate: a NULL or absent column fails
        every operator (the CQL _match contract), or with wire=True
        passes != (common/wire.FILTER_OPS)."""
        ok = np.ones(self.n_rows, dtype=bool)
        for p in spec.predicates:
            have, val = self.cols[p.col]
            m = have & self._OPS[p.op](val, int(p.value))
            ok &= (m | ~have) if wire and p.op == "!=" else m
        return ok

    def aggregate(self, spec, schema) -> dict:
        ok = self.passing(spec, wire=False)
        out = {"rows": int(ok.sum()), "cols": {}}
        for cid in spec.agg_cids:
            have, val = self.cols[schema.column_by_id(cid).name]
            v = [int(x) for x in val[ok & have]]
            out["cols"][cid] = {"nonnull": len(v), "sum": sum(v),
                                "min": min(v) if v else None,
                                "max": max(v) if v else None}
        return out

    def entries(self, spec) -> list:
        sel = self.idx[self.passing(spec, wire=True)[self.doc]]
        m = self.merged
        return [(m.key_bytes(i), m.values[int(m.value_idx[i])],
                 (int(m.ht_hi[i]) << 32) | int(m.ht_lo[i]))
                for i in sel.tolist()]


def _pushdown_wrappers():
    from yugabyte_tpu_torch.ops import pushdown
    return {"row_flags": pushdown.row_flags,
            "segment_or": pushdown.segment_or,
            "row_pass_pack": pushdown.row_pass_pack,
            "agg_reduce": pushdown.agg_reduce}


def check_pushdown_launches(launches, mode: str, presorted: bool, what: str):
    """Multi-source: G, H on cols and vals, I.1 on cols and vals, B, J.1,
    J.2 and J.3 or K; presorted: B, J.1, J.2 and K only."""
    last = "agg_reduce" if mode == "aggregate" else "row_pass_pack"
    need = {k: 1 for k in ("gc_pack", "row_flags", "segment_or", last)}
    if not presorted:
        need.update(staged_concat=2, radix_sort=1, sorted_payload=2)
    for k, least in need.items():
        if launches[k] < least:
            raise AssertionError(f"{what}: kernel {k} launched "
                                 f"{launches[k]} times (at least {least})")
    if presorted and any(launches[k] for k in ("staged_concat", "radix_sort",
                                                "sorted_payload")):
        raise AssertionError(f"{what}: the presorted route launched G, H or "
                             f"I.1: {launches}")


def pushdown_phase(args, workdir, device="cuda"):
    """The query pushdown over a TPC-H lineitem tablet in 4 SSTs: each
    query through `ops.scan.aggregate_sources` / `filtered_entries_sources`
    over SlabSource(read_all(), sorted_source=True), every launch counter
    set to 0 just before it and read just after, the answer equal to
    LineitemOracle's. Returns (summary, the phase's launch totals, the
    slabs, the read times)."""
    import torch
    from yugabyte_tpu_torch.ops import scan
    from yugabyte_tpu_torch.storage.sst import SSTReader

    schema = lineitem_schema()
    t0 = time.time()
    rows = lineitem_rows(args.sf_orders, args.seed)
    ops = lineitem_ops(rows, args.seed)
    runs, top_ht, mid_ht = lineitem_runs(rows, ops, args.seed)
    n_entries = sum(s.n for s in runs)
    out = {"orders": int(len(np.unique(rows["orderkey"]))),
           "rows": int(len(rows["orderkey"])), "entries": n_entries,
           "run_entries": [s.n for s in runs],
           "generate_s": time.time() - t0}
    del rows, ops
    in_dir = os.path.join(workdir, "lineitem")
    os.makedirs(in_dir)
    readers = write_inputs(runs, in_dir)
    del runs
    log(f"lineitem tablet: {out['orders']} orders, {out['rows']} rows, "
        f"{n_entries} entries in 4 SSTs ({out['generate_s']:.1f}s)")
    t0 = time.time()
    slabs = [r.read_all() for r in readers]
    out["read_all_s"] = time.time() - t0
    del readers
    queries = pushdown_queries(schema)
    plan = [("q1_agg", "q1_agg", top_ht, slabs),
            ("q6_agg", "q6_agg", top_ht, slabs),
            ("q6_agg@mid", "q6_agg", mid_ht, slabs),
            ("filter_rows", "filter_rows", top_ht, slabs),
            ("presorted_q1", "q1_agg", top_ht, slabs[:1])]
    wrappers = {**_wrappers(), **_pushdown_wrappers()}
    totals = {k: 0 for k in wrappers}
    oracles = {}
    for name, qname, read_ht, inputs in plan:
        mode, spec = queries[qname]
        presorted = len(inputs) == 1
        for w in wrappers.values():
            w.launches = 0
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        srcs = [scan.SlabSource(s, sorted_source=True) for s in inputs]
        if mode == "aggregate":
            got = scan.aggregate_sources(srcs, read_ht, spec, device=device)
        else:
            got = list(scan.filtered_entries_sources(srcs, read_ht, spec,
                                                     device=device))
        sync()
        secs = time.time() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        peak = (torch.cuda.max_memory_allocated()
                if torch.cuda.is_available() else 0)
        check_pushdown_launches(launches, mode, presorted, name)
        for k, v in launches.items():
            totals[k] += v
        t0 = time.time()
        key = (read_ht, len(inputs))
        if key not in oracles:
            oracles[key] = LineitemOracle(inputs, read_ht)
        oracle = oracles[key]
        t_assemble = time.time() - t0
        t0 = time.time()
        want = oracle.aggregate(spec, schema) if mode == "aggregate" \
            else oracle.entries(spec)
        t_eval = time.time() - t0
        if got != want:
            raise AssertionError(f"{name}: the pushdown's answer differs "
                                 f"from the host oracle's")
        if (mode == "aggregate" and got["rows"] == 0) or not got:
            raise AssertionError(f"{name}: an empty answer")
        res = {"mode": mode, "read_ht": read_ht, "sources": len(inputs),
               "entries_in": sum(s.n for s in inputs),
               "visible_rows": oracle.n_rows, "seconds": secs,
               "rows_per_s": oracle.n_rows / secs, "peak_bytes": peak,
               "oracle_assemble_s": t_assemble, "oracle_eval_s": t_eval,
               "launches": {k: v for k, v in launches.items() if v}}
        if mode == "aggregate":
            res["answer"] = {"rows": got["rows"], "cols": {
                str(c): st for c, st in got["cols"].items()}}
        else:
            res["entries_out"] = len(got)
            res["entries_sha256"] = entries_sha256(got)
        out[name] = res
        log(f"{name}: equal to the host oracle; {secs:.3f}s "
            f"({res['rows_per_s']:,.0f} rows/s over {oracle.n_rows} visible "
            f"rows; oracle {t_assemble:.2f}s + {t_eval:.2f}s); peak "
            f"{peak} bytes; launches {res['launches']}")
    del oracles
    return out, totals, slabs, (top_ht, mid_ht)


def entries_sha256(entries) -> str:
    """sha256 of an entry list's repr: (key, value, hybrid time) tuples
    in order."""
    import hashlib
    return hashlib.sha256(repr(list(entries)).encode()).hexdigest()


def pushdown_breakdown(slabs, read_ht, spec, mode, device="cuda"):
    """Seconds of each stage of one pushdown query over the 4 inputs, run
    one after the other with the same module functions, each ended by a
    synchronize: host pack + upload of cols and vals, kernel H (cols and
    vals), kernel G, kernels I.1 (cols and vals) + B, kernel J, kernel K,
    the decisions down and the host finish (the drain of the kept entries,
    or the aggregate's reconstruction). Returns the stages, the answer
    and the tensors the kernel phase checks J and K on."""
    from yugabyte_tpu_torch.ops import merge_gc, pushdown, radix, scan
    from yugabyte_tpu_torch.storage.device_cache import concat_staged

    out = {}
    t0 = time.time()
    staged = [merge_gc.stage_slab(s, device) for s in slabs]
    vals = [merge_gc.u32_to_device(scan.pack_vals(s, st.n_pad),
                                   st.cols_dev.device)
            for s, st in zip(slabs, staged)]
    sync()
    out["pack_upload_s"] = time.time() - t0
    t0 = time.time()
    cat = concat_staged(staged)
    cvals = scan.concat_vals(vals, [st.n for st in staged], cat.n_pad)
    sync()
    out["concat_h_s"] = time.time() - t0
    parts = {"vals": vals, "ns": [st.n for st in staged], "n_pad": cat.n_pad}
    del staged
    t0 = time.time()
    perm = radix.radix_sort(cat.cols_dev, cat.sort_rows, cat.n_sort)
    sync()
    out["radix_g_s"] = time.time() - t0
    t0 = time.time()
    w = cat.w
    s = radix.sorted_payload(cat.cols_dev, perm)
    _packed, keep, _mk = merge_gc.gc_pack(
        s, merge_gc._ROW_WORDS + w, w, merge_gc.GCParams(read_ht, True), 1,
        cat.n_pad, snapshot=True)
    sv = radix.sorted_payload(cvals, perm)
    sync()
    out["gather_gc_s"] = time.time() - t0
    wire = mode == "filtered"
    p_ops = scan._pack_predicate_operands(
        spec, scan.pred_slot_bucket(len(spec.predicates)), wire)
    c_pad = scan.agg_slot_bucket(max(len(spec.agg_cids), 1))
    a_ops = scan._pack_agg_operands(spec, c_pad) if not wire else None
    bounds, _lo, _hi = scan._bound_operands(cat, None, None)
    t0 = time.time()
    flags = pushdown.row_flags(s, keep, sv, w, bounds, p_ops, a_ops)
    seg = pushdown.segment_or(flags)
    if wire:
        keep_p = pushdown.row_pass_pack(flags, seg, p_ops[1], p_ops[2])
    sync()
    out["j_s"] = time.time() - t0
    if wire:
        t0 = time.time()
        perm_h = perm.cpu().numpy()
        keep_h = merge_gc._unpack_bits(keep_p.cpu().numpy(), cat.n_pad) \
            & (perm_h < cat.n)
        out["decisions_down_s"] = time.time() - t0
        t0 = time.time()
        srcs = [scan.SlabSource(sl, sorted_source=True) for sl in slabs]
        answer = list(scan.survivor_entries(srcs, perm_h, keep_h))
        out["host_drain_s"] = time.time() - t0
    else:
        t0 = time.time()
        acc, ext = pushdown.agg_reduce(flags, seg, sv, p_ops[1], p_ops[2],
                                       c_pad, c_pad)
        sync()
        out["k_s"] = time.time() - t0
        t0 = time.time()
        answer = scan.agg_partial(spec, acc, ext, c_pad)
        out["decisions_down_finish_s"] = time.time() - t0
    tensors = {"s": s, "keep": keep, "sv": sv, "w": w, "bounds": bounds,
               "p_ops": p_ops, "a_ops": a_ops, "c_pad": c_pad,
               "flags": flags, "seg": seg, "cvals": cvals, "parts": parts}
    return out, answer, tensors


def pushdown_kernel_phase(args, t_agg, t_rows, launches, bandwidth):
    """Kernels J.1, J.2, J.3 and K against their plain versions on the
    card, bit for bit, on q6_agg's and filter_rows' tensors; timed with
    CUDA events on q6_agg's (J.3 on filter_rows') beside their bounds:
    the bytes each must move on these inputs; each also on the device
    (torch.profiler: J.1, J.3 and K one launch a call, J.2 one launch
    after one memset). No single PyTorch call
    computes any of them (library_ms null). Also H's vals launch (the zero
    template) at the phase's shapes, beside torch.cat + a zero fill."""
    import torch
    from yugabyte_tpu_torch.ops import pushdown, run_merge, scan

    def calls(t):
        s, keep, sv, w = t["s"], t["keep"], t["sv"], t["w"]
        p_op, p_neg = t["p_ops"][1], t["p_ops"][2]
        c = 0 if t["a_ops"] is None else t["c_pad"]
        return {
            "row_flags": (
                lambda: pushdown.row_flags(s, keep, sv, w, t["bounds"],
                                           t["p_ops"], t["a_ops"]),
                lambda: pushdown.row_flags_plain(s, keep, sv, w, t["bounds"],
                                                 t["p_ops"], t["a_ops"])),
            "segment_or": (lambda: pushdown.segment_or(t["flags"]),
                           lambda: pushdown.segment_or_plain(t["flags"])),
            "row_pass_pack": (
                lambda: pushdown.row_pass_pack(t["flags"], t["seg"], p_op,
                                               p_neg),
                lambda: pushdown.row_pass_pack_plain(t["flags"], t["seg"],
                                                     p_op, p_neg)),
            "agg_reduce": (
                lambda: pushdown.agg_reduce(t["flags"], t["seg"], sv, p_op,
                                            p_neg, c, t["c_pad"]),
                lambda: pushdown.agg_reduce_plain(t["flags"], t["seg"], sv,
                                                  p_op, p_neg, c,
                                                  t["c_pad"]))}

    errs = {}
    for what, t in (("q6_agg", t_agg), ("filter_rows", t_rows)):
        for name, (kern, plain) in calls(t).items():
            got, want = kern(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(max_abs_err(g, x) for g, x in zip(got, want))
            if err or not all(torch.equal(g, x) for g, x in zip(got, want)):
                raise AssertionError(f"kernel {name} != its plain version on "
                                     f"{what}'s tensors (max_abs_err {err})")
            errs[name] = max(errs.get(name, 0), err)
    log("kernels J.1, J.2, J.3 and K == their plain versions on q6_agg's and "
        "filter_rows' tensors")

    rows = []
    replaces = {
        "row_flags": "yugabyte_tpu/ops/scan.py:496",
        "segment_or": "yugabyte_tpu/ops/scan.py:435",
        "row_pass_pack": "yugabyte_tpu/ops/scan.py:585",
        "agg_reduce": "yugabyte_tpu/ops/scan.py:612"}
    nbytes = pushdown_bytes(t_agg, t_rows)
    for name in ("row_flags", "segment_or", "row_pass_pack", "agg_reduce"):
        t = t_rows if name == "row_pass_pack" else t_agg
        kern, plain = calls(t)[name]
        ms = cuda_ms(kern, args.reps)
        plain_ms = cuda_ms(plain, 2)
        e = {"name": name, "route": "cuda",
             "source": "yugabyte_tpu_torch/csrc/pushdown.cu",
             "replaces": replaces[name], "launches": launches[name],
             "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
             "bound_ms": nbytes[name] / bandwidth * 1e3, "bound_by": "bytes",
             "library_ms": None,
             "timed_on": "filter_rows" if name == "row_pass_pack"
             else "q6_agg"}
        # J.1, J.3 and K one launch a call, J.2 one launch after one memset
        prof = device_profile(kern, args.reps)
        one_launch_no_copy(name, prof, int(name == "segment_or"))
        e.update(prof)
        if name == "row_flags":
            e["bound_sectors_ms"] = nbytes["row_flags_sectors"] \
                / bandwidth * 1e3
        log(f"kernel {name} on the device: {prof['device_ms']:.4f} ms "
            f"({prof['launches_per_call']} launches, "
            f"{prof['memsets_per_call']} memsets a call)")
        log(f"kernel {name}: equal; {ms:.4f} ms (plain {plain_ms:.4f}, bound "
            f"{e['bound_ms']:.4f}), {launches[name]} launches in the "
            f"pushdown phase")
        rows.append(e)

    # H on the vals: the 4 inputs' value words into one matrix
    p = t_agg["parts"]
    vals, ns, n_pad = p["vals"], p["ns"], p["n_pad"]
    offs = np.concatenate(([0], np.cumsum(ns)[:-1])).tolist()
    zero = np.zeros(scan._VAL_ROWS, dtype=np.uint32)
    got = run_merge.staged_concat(vals, ns, offs, n_pad, zero)
    err = max_abs_err(got, run_merge.staged_concat_plain(vals, ns, offs,
                                                         n_pad, zero))
    if err or not torch.equal(got, t_agg["cvals"]):
        raise AssertionError("kernel H on the vals != its plain version")
    total = sum(ns)

    def cat_fill():
        o = torch.empty((scan._VAL_ROWS, n_pad), dtype=torch.int32,
                        device=got.device)
        o[:, :total] = torch.cat([v[:, :k] for v, k in zip(vals, ns)], 1)
        o[:, total:] = 0
        return o

    h_vals = {"ms": cuda_ms(lambda: run_merge.staged_concat(
        vals, ns, offs, n_pad, zero), args.reps),
        "plain_ms": cuda_ms(lambda: run_merge.staged_concat_plain(
            vals, ns, offs, n_pad, zero), 2),
        "library_ms": cuda_ms(cat_fill, 2),
        "bound_ms": (scan._VAL_ROWS * total + scan._VAL_ROWS * n_pad) * 4
        / bandwidth * 1e3, "max_abs_err": err,
        "launches": launches["staged_concat"]}
    log(f"kernel staged_concat on the vals: equal; {h_vals['ms']:.4f} ms "
        f"(plain {h_vals['plain_ms']:.4f}, torch.cat + fill "
        f"{h_vals['library_ms']:.4f}, bound {h_vals['bound_ms']:.4f})")
    return rows, h_vals


def pushdown_bytes(t_agg, t_rows) -> dict:
    """Bytes each of J.1, J.2, J.3 and K must move on these inputs, each
    input read once and each output written once. J.1: per lane key_len
    and keep; per real lane dkl and the key words through its subkey
    (ceil((dkl + 3) / 4); the lower bound is empty and the upper one
    infinite here, so they add no word), the 16 value bytes of each base
    entry with a 3-byte subkey, 4 bytes out; also counted in 32-byte
    sectors (`row_flags_sectors`: each sector of a row that any lane must
    read once). J.2: 4 bytes in and out per lane. J.3: 8 bytes in per
    lane, n/8 out. K: 8 bytes in per lane, the 12 payload bytes of each
    entry that qualifies for a slot, the output words."""
    import torch
    from yugabyte_tpu_torch.ops import pushdown
    from yugabyte_tpu_torch.ops.merge_gc import (_ROW_DKL, _ROW_KEY_LEN,
                                                 PAD_SENTINEL, _u)
    s, flags = t_agg["s"], t_agg["flags"]
    n = s.shape[1]
    real = _u(s[_ROW_KEY_LEN]) != PAD_SENTINEL
    dkl, kl = s[_ROW_DKL].long(), s[_ROW_KEY_LEN].long()
    words = torch.clamp((dkl + 3 + 3) // 4, max=t_agg["w"])
    f = flags.long()
    base3 = ((f >> pushdown.BASE_BIT) & 1).bool() & (kl - dkl == 3)
    j1 = n * 5 + int(real.sum()) * 4 + 4 * int(words[real].sum()) \
        + 16 * int(base3.sum()) + 4 * n
    w = t_agg["w"]
    rows_needed = torch.stack(
        [real] + [real & (words > j) for j in range(w)] + [base3])
    j1_sectors = n * 5 + sector_bytes(rows_needed) \
        + 3 * sector_bytes(base3[None]) + 4 * n
    p_op, p_neg = t_agg["p_ops"][1], t_agg["p_ops"][2]
    rowpass = pushdown._row_pass(t_agg["seg"].long(), p_op, p_neg)
    qual = sum(int((((f >> (5 + c)) & 1).bool() & rowpass).sum())
               for c in range(t_agg["c_pad"]))
    k = 8 * n + 12 * qual + 4 * (1 + 9 * t_agg["c_pad"]) \
        + 16 * t_agg["c_pad"]
    n_rows = t_rows["flags"].shape[0]
    return {"row_flags": j1, "row_flags_sectors": j1_sectors,
            "segment_or": 8 * n,
            "row_pass_pack": 8 * n_rows + n_rows // 8, "agg_reduce": k}


# --------------------------------------------------------------------------
# Point reads (slice 5): DB.multi_get over a YCSB tablet


def scrambled_zipfian(n: int, item_count: int, rng) -> np.ndarray:
    """n draws of YCSB's ScrambledZipfianGenerator over [0, item_count)
    (core/generator/ScrambledZipfianGenerator.java): a zipfian (theta
    0.99) over 10^10 items with YCSB's precomputed zeta, each draw
    scrambled by YCSB's 8-octet FNV-1a-64 (`Utils.fnvhash64`, absolute
    value as a signed long) modulo item_count."""
    items, zetan, theta = 10_000_000_000, 26.46902820178302, 0.99
    alpha = 1.0 / (1.0 - theta)
    eta = (1 - (2.0 / items) ** (1 - theta)) / (1 - (1 + 0.5 ** theta)
                                                / zetan)
    u = rng.random(n)
    uz = u * zetan
    draw = (items * (eta * u - eta + 1) ** alpha).astype(np.int64)
    draw = np.where(uz < 1.0, 0, np.where(uz < 1.0 + 0.5 ** theta, 1, draw))
    val = draw.astype(np.uint64)
    h = np.full(n, 0xCBF29CE484222325, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for _ in range(8):
            h = (h ^ (val & np.uint64(0xFF))) * np.uint64(1099511628211)
            val = val >> np.uint64(8)
    return np.abs(h.view(np.int64)) % item_count


def ycsb_keys(ids: np.ndarray, is_tomb=None) -> np.ndarray:
    """uint8 [n, 19] key rows of synth_ycsb_runs' layout: root 'S'
    'user%08d' 00 00 '!' (16 bytes), a column write + 'K' 00 00; a row
    tombstone is the root alone (its length 16)."""
    n = len(ids)
    keys = np.zeros((n, 19), dtype=np.uint8)
    keys[:, 0] = ord("S")
    keys[:, 1:5] = np.frombuffer(b"user", dtype=np.uint8)
    digits = ids[:, None] // (10 ** np.arange(7, -1, -1)[None, :]) % 10
    keys[:, 5:13] = (digits + ord("0")).astype(np.uint8)
    keys[:, 15] = ord("!")
    keys[:, 16] = ord("K")
    if is_tomb is not None:
        keys[is_tomb, 16] = 0
    return keys


def ycsb_packed_run(ids, is_tomb, ht, rng):
    """One packed run (keys_blob, key_offs, ht, wid, vals_blob, val_offs)
    of YCSB writes: 19-byte column keys with 64-byte DocDB string values
    (kString, 61 letters, the 00 00 terminator), 16-byte row tombstones
    with Value.tombstone().encode()."""
    from yugabyte_tpu_torch.docdb.value import Value
    n = len(ids)
    keys = ycsb_keys(ids, is_tomb)
    klen = np.where(is_tomb, 16, 19)
    vals = np.zeros((n, 64), dtype=np.uint8)
    vals[:, 0] = ord("S")
    vals[:, 1:62] = rng.integers(ord("a"), ord("z") + 1, size=(n, 61),
                                 dtype=np.uint8)
    tomb = Value.tombstone().encode()
    vals[is_tomb, :len(tomb)] = np.frombuffer(tomb, dtype=np.uint8)
    vlen = np.where(is_tomb, len(tomb), 64)
    return (keys[np.arange(19)[None, :] < klen[:, None]].tobytes(),
            np.concatenate(([0], np.cumsum(klen))).astype(np.int64), ht,
            np.zeros(n, dtype=np.uint32),
            vals[np.arange(64)[None, :] < vlen[:, None]].tobytes(),
            np.concatenate(([0], np.cumsum(vlen))).astype(np.int64))


def _split(blob: bytes, offs) -> list:
    o = offs.tolist()
    return [blob[a:b] for a, b in zip(o[:-1], o[1:])]


def point_options(device):
    """A serving DB's options: the device and the shared slab cache, a
    4 GiB decoded-block cache (the winners' value fetch decodes each
    touched block once), no compaction, and a memtable large enough that
    only explicit flushes cut files."""
    from yugabyte_tpu_torch.storage.db import DBOptions
    from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
    from yugabyte_tpu_torch.storage.sst import BlockCache
    return DBOptions(device=device, device_cache=DeviceSlabCache(device),
                     block_cache=BlockCache(4 << 30), auto_compact=False,
                     memstore_size_bytes=1 << 40)


def ycsb_point_db(args, workdir, device="cuda"):
    """The YCSB tablet as a DB: n rows in 4 runs (key space n/2, 5% row
    tombstones), runs 0-2 bulk-loaded with ingest_packed (not resident),
    run 3 written with write_batch_columns and flushed (staged by the
    flush's write-through), then YCSB-B's updates (5% of the read count,
    scrambled-zipfian ids, column writes above every run) left in the
    memtable. Returns (db, summary, top read time, mid read time)."""
    from yugabyte_tpu_torch.storage.db import DB
    rng = np.random.default_rng(args.seed + 50)
    n, key_space = args.rows, max(1, args.rows // 2)
    per_run = n // 4
    span = max(1_000_000, per_run)
    db = DB(os.path.join(workdir, "ycsb"), point_options(device))
    out = {"rows": 4 * per_run, "key_space": key_space}
    t0 = time.time()
    for g in range(4):
        ids = rng.integers(0, key_space, size=per_run)
        is_tomb = rng.random(per_run) < 0.05
        ht = ((span * (g + 1) + rng.permutation(per_run)).astype(np.uint64)
              << np.uint64(12))
        run = ycsb_packed_run(ids, is_tomb, ht, rng)
        if g < 3:
            db.ingest_packed(*run, op_id=(1, g + 1))
        else:
            db.write_batch_columns(_split(run[0], run[1]), run[2], run[3],
                                   _split(run[4], run[5]), op_id=(1, 4))
            if db.flush() is None:
                raise AssertionError("the flush of run 3 wrote no file")
    out["load_s"] = time.time() - t0
    n_upd = args.point_reads // 20
    ids = scrambled_zipfian(n_upd, key_space, rng)
    ht = ((span * 5 + np.arange(n_upd)).astype(np.uint64) << np.uint64(12))
    run = ycsb_packed_run(ids, np.zeros(n_upd, bool), ht, rng)
    db.write_batch_columns(_split(run[0], run[1]), run[2], run[3],
                           _split(run[4], run[5]), op_id=(1, 5))
    out["memtable_updates"] = n_upd
    out["files"] = [r.props.n_entries for r in db._readers.values()]
    out["resident_after_load"] = [db._device_cache.contains(fid)
                                  for fid in db._readers]
    log(f"YCSB tablet: {out['rows']} rows in {len(out['files'])} SSTs "
        f"({out['load_s']:.1f}s; resident after load "
        f"{out['resident_after_load']}), {n_upd} updates in the memtable")
    return db, out, (span * 6) << 12, ((span * 4) << 12) - 1


def lineitem_point_db(lineitem_dir, workdir, device="cuda",
                      name="lineitem_db"):
    """The pushdown phase's 4 lineitem SSTs opened as a DB (hard links
    under file ids 1-4 and a manifest): SSTWriter fitted a learned index
    into each, so P3 runs its model mode here."""
    from yugabyte_tpu_torch.storage.db import DB
    d = os.path.join(workdir, name)
    link_lineitem(lineitem_dir, d)
    return DB(d, point_options(device))


def link_lineitem(lineitem_dir, d):
    """The pushdown phase's 4 lineitem SSTs as a DB directory `d`: hard
    links under file ids 1-4 and a manifest."""
    from yugabyte_tpu_torch.storage.sst import SSTReader, data_file_name
    from yugabyte_tpu_torch.storage.version_set import VersionSet
    os.makedirs(d)
    vs = VersionSet(d)
    for src in sorted(f for f in os.listdir(lineitem_dir)
                      if f.endswith(".sst")):
        fid = vs.new_file_id()
        path = os.path.join(d, f"{fid:06d}.sst")
        os.link(os.path.join(lineitem_dir, src), path)
        os.link(data_file_name(os.path.join(lineitem_dir, src)),
                data_file_name(path))
        r = SSTReader(path)
        vs.add_file(fid, path, r.props)
        r.close()


def lineitem_point_keys(db, n: int, seed: int) -> list:
    """n keys of the lineitem DB's entries (every entry of 16 random
    blocks per file, shuffled); each key lives in one of the runs, so the
    other files' seeks miss."""
    from yugabyte_tpu_torch.ops.slabs import unpack_keys
    rng = np.random.default_rng(seed + 60)
    keys = []
    for r in db._readers.values():
        for b in rng.choice(r.n_blocks, size=min(16, r.n_blocks),
                            replace=False):
            keys.extend(unpack_keys(r.read_block(int(b))))
    return [keys[i] for i in rng.permutation(len(keys))[:n]]


def _point_wrappers():
    from yugabyte_tpu_torch.ops import point_read
    return {"fnv64": point_read.fnv64,
            "hash_probe_files": point_read.hash_probe_files,
            "locate_fold": point_read.locate_fold,
            "bloom_probe": point_read.bloom_probe,
            "locate_gather": point_read.locate_gather,
            "index_fit": point_read.index_fit}


_POINT_COUNTERS = ("bloom_skips", "learned_hits", "learned_fallbacks")


def point_reads(db, keys, read_ht, batch: int, what: str):
    """multi_get over keys in calls of `batch`, every launch counter set
    to 0 just before and read just after; each call's seconds, ended by
    the call's own downloads. Then every chunk of those calls replayed,
    uncounted, through the per-file launches (`per_file_chunk`): its
    fold equals the one `_device_chunk` gives, and the counters
    (bloom_skips, learned_hits, learned_fallbacks) summed over the
    replay equal the calls'. Returns (results, seconds, launches,
    {learned-index locates, keys a model mispredicted (each re-sought
    exactly inside P3's launch)})."""
    from yugabyte_tpu_torch.common.hybrid_time import HybridTime
    from yugabyte_tpu_torch.ops import point_read
    wrappers = _point_wrappers()
    for w in wrappers.values():
        w.launches = 0
    m = point_read.point_read_metrics()
    before = {k: m[k].value() for k in _POINT_COUNTERS}
    res, secs = [], []
    for s in range(0, len(keys), batch):
        t0 = time.time()
        res.extend(db.multi_get(keys[s:s + batch], read_ht))
        secs.append(time.time() - t0)
    launches = {k: w.launches for k, w in wrappers.items()}
    counters = {k: m[k].value() - v for k, v in before.items()}
    replay_per_file(db, [keys[s:s + batch]
                         for s in range(0, len(keys), batch)],
                    read_ht, counters, what)
    learned = {k: counters[k] for k in ("learned_hits", "learned_fallbacks")}
    log(f"{what}: {len(keys)} keys in {len(secs)} calls, "
        f"{sum(secs):.3f}s; launches {launches}; counters {counters}, equal "
        f"to the per-file launches' on the same chunks, and so are the "
        f"folds")
    return res, secs, launches, learned


def replay_per_file(db, calls, read_ht, counters, what: str) -> None:
    """Every chunk of `calls` (key lists, one multi_get each) through
    `_device_chunk` and through the per-file launches (`per_file_chunk`),
    uncounted: the two folds agree on every real lane, and the per-file
    counters summed over the chunks equal `counters`, the calls' own."""
    from yugabyte_tpu_torch.common.hybrid_time import HybridTime
    ht = read_ht if isinstance(read_ht, HybridTime) else HybridTime(read_ht)
    staged_by = db._stage_live(list(db._readers.items()))
    replay = {k: 0 for k in _POINT_COUNTERS}
    for call in calls:
        for c in range(0, len(call), 1024):
            chunk = call[c:c + 1024]
            got = db._device_chunk(chunk, None, ht, staged_by)
            want, counts = per_file_chunk(db, chunk, ht, staged_by)
            for k in _POINT_COUNTERS:
                replay[k] += counts[k]
            same_fold(got, want, len(chunk), what)
    if replay != counters:
        raise AssertionError(f"{what}: counters {counters} != the per-file "
                             f"launches' {replay} on the same calls")


def per_file_chunk(db, chunk, read_ht, staged_by):
    """The batched read's device stage as it ran before P1, P2 and P3
    ran in a launch each over every file: P1 (`fnv64`), per live SST one
    P2 (`bloom_probe`) and its
    download, per located SST one P3 (`locate_gather`) and its download,
    an exact P3 relaunch where the learned index mispredicted a real
    lane, and the newest-wins fold on the host. Returns (fold arrays (ht
    u64, wid, row, file, hit) or None, counters)."""
    from yugabyte_tpu_torch.ops import point_read as pr
    from yugabyte_tpu_torch.utils import flags
    table = db._file_table(staged_by)
    hw, dk, qbuf, ql = db._pack_chunk(chunk, None, table)
    h1, h2 = pr.fnv64(hw, dk)
    b, b_pad = len(chunk), ql.shape[0]
    rhi, rlo = read_ht.value >> 32, read_ht.value & 0xFFFFFFFF
    counts = {k: 0 for k in _POINT_COUNTERS}
    best = None
    for fi, f in enumerate(table.files):
        if f.bloom is not None and not \
                pr.bloom_probe(h1, h2, *f.bloom).cpu().numpy()[:b].any():
            counts["bloom_skips"] += 1
            continue
        qw = table.file_queries(qbuf, f, b_pad)
        model = (f.model if flags.get_flag("point_read_learned_index")
                 else None)
        idx, hit, hh, hl, wid, miss = (x.cpu().numpy() for x in
                                       pr.locate_gather(f.cols, f.n, qw, ql,
                                                        rhi, rlo, model, f.w))
        if model is not None:
            counts["learned_hits"] += 1
            n_miss = int(miss[:b].sum())
            if n_miss:
                counts["learned_fallbacks"] += n_miss
                exact = [x.cpu().numpy() for x in pr.locate_gather(
                    f.cols, f.n, qw, ql, rhi, rlo, None, f.w)]
                idx, hit, hh, hl, wid = (
                    np.where(miss, e, m_) for m_, e in
                    zip((idx, hit, hh, hl, wid), exact[:5]))
        ht = ((hh.view(np.uint32).astype(np.uint64) << np.uint64(32))
              | hl.view(np.uint32).astype(np.uint64))
        wid = wid.view(np.uint32)
        if best is None:
            best = [np.zeros(b_pad, np.uint64), np.zeros(b_pad, np.uint32),
                    np.zeros(b_pad, np.int64), np.zeros(b_pad, np.int64),
                    np.zeros(b_pad, bool)]
        upd = hit & (~best[4] | (ht > best[0])
                     | ((ht == best[0]) & (wid > best[1])))
        best[0] = np.where(upd, ht, best[0])
        best[1] = np.where(upd, wid, best[1])
        best[2] = np.where(upd, idx.astype(np.int64), best[2])
        best[3] = np.where(upd, fi, best[3])
        best[4] = best[4] | hit
    return best, counts


def same_fold(got, want, b: int, what: str) -> None:
    """Two folds (None: no file located) agree on the first b lanes."""
    if got is None or want is None:
        if got is not want:
            raise AssertionError(f"{what}: one fold located no file")
        return
    for name, g, x in zip(("ht", "wid", "row", "file", "hit"), got, want):
        if not np.array_equal(g[:b], x[:b]):
            raise AssertionError(f"{what}: the fold's {name} differs from "
                                 f"the per-file launches'")


def check_point_launches(launches, chunks: int, files: int, what: str):
    """P1 + P2 over every file and P3 + the fold once per chunk, whatever
    the number of live SSTs (`files`); no P1 on its own, no per-file P2
    or P3 and no P4 on the read path."""
    want = {"fnv64": 0, "hash_probe_files": chunks,
            "locate_fold": chunks, "bloom_probe": 0, "locate_gather": 0,
            "index_fit": 0}
    if files < 1 or {k: launches[k] for k in want} != want:
        raise AssertionError(f"{what}: launches {launches} over {files} "
                             f"SSTs, not {want}")


def same_answers(got, db, keys, read_ht, what: str) -> float:
    """got == _multi_get_native on the same DB and keys, key for key, in
    calls of 1024. Returns the native path's seconds."""
    from yugabyte_tpu_torch.common.hybrid_time import HybridTime
    ht = HybridTime(read_ht)
    t0 = time.time()
    want = []
    for s in range(0, len(keys), 1024):
        want.extend(db._multi_get_native(keys[s:s + 1024], ht))
    secs = time.time() - t0
    if got != want:
        bad = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        raise AssertionError(f"{what}: multi_get differs from the native "
                             f"path at key {bad}: {got[bad]} != {want[bad]}")
    return secs


def point_read_phase(args, workdir, lineitem_dir, device="cuda"):
    """Batched point reads through `DB.multi_get` (kernels P1-P3 over
    the resident staged cols) on the YCSB tablet: YCSB workload C's
    scrambled-zipfian reads at a read time above every write in calls of
    1024 (the first, cold call timed apart), reads at a mid read time,
    small calls (the 64 bucket) and reads with the learned index off;
    then learned-index reads over the lineitem SSTs. Every answer equals
    the native per-key path's; a sample equals sequential gets."""
    import torch
    from yugabyte_tpu_torch.common.hybrid_time import HybridTime
    from yugabyte_tpu_torch.ops import point_read
    from yugabyte_tpu_torch.utils import flags
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    db, out, top_ht, mid_ht = ycsb_point_db(args, workdir, device)
    rng = np.random.default_rng(args.seed + 70)
    key_space = out["key_space"]

    def col_keys(ids):
        return [bytes(k) for k in ycsb_keys(ids)]

    n = args.point_reads
    files = len(db._readers)
    top = HybridTime(top_ht)
    keys = col_keys(scrambled_zipfian(n, key_space, rng))
    out["distinct_keys"] = len(set(keys))
    t0 = time.time()
    cold = db.multi_get(keys[:1024], top)
    out["cold_call_s"] = time.time() - t0
    out["read_stages"] = db.opts.device_cache.read_stages
    log(f"cold call: {out['cold_call_s']:.3f}s (staged "
        f"{out['read_stages']} files on a miss)")
    got, secs, launches, learned = point_reads(db, keys, top, 1024,
                                               "warm reads")
    check_point_launches(launches, len(secs), files, "warm reads")
    if got[:1024] != cold:
        raise AssertionError("the cold call and the warm call differ")
    native_s = same_answers(got, db, keys, top_ht, "warm reads")
    lat = np.asarray(secs)
    out.update({
        "warm_keys": n, "warm_calls": len(secs), "warm_s": float(lat.sum()),
        "warm_keys_per_s": n / float(lat.sum()),
        "call_p50_ms": float(np.percentile(lat, 50) * 1e3),
        "call_p99_ms": float(np.percentile(lat, 99) * 1e3),
        "native_s": native_s, "native_keys_per_s": n / native_s,
        "hits": sum(r is not None for r in got), "launches": launches,
        "learned": learned})
    total = {k: v for k, v in launches.items()}
    t0 = time.time()
    sample = keys[:16384]
    if [db.get(k, top) for k in sample] != got[:16384]:
        raise AssertionError("warm reads differ from sequential gets")
    out["sequential_get_s"] = time.time() - t0
    log(f"warm reads: {out['warm_keys_per_s']:,.0f} keys/s, call p50 "
        f"{out['call_p50_ms']:.3f} ms p99 {out['call_p99_ms']:.3f} ms; "
        f"native path {out['native_keys_per_s']:,.0f} keys/s; equal to it "
        f"and (16,384 keys) to sequential gets; {out['hits']} hits")

    mid_keys = col_keys(scrambled_zipfian(n // 4, key_space, rng))
    got, secs, launches, learned = point_reads(
        db, mid_keys, HybridTime(mid_ht), 1024, "reads at the mid read time")
    check_point_launches(launches, len(secs), files, "mid reads")
    same_answers(got, db, mid_keys, mid_ht, "mid reads")
    out["mid"] = {"keys": len(mid_keys), "s": sum(secs),
                  "hits": sum(r is not None for r in got),
                  "learned": learned}
    for k, v in launches.items():
        total[k] += v

    small = col_keys(scrambled_zipfian(32 * 64, key_space, rng))
    sizes = rng.integers(1, 65, size=32)
    small_keys = [small[64 * i: 64 * i + int(s)] for i, s in enumerate(sizes)]
    wrappers = _point_wrappers()
    for w in wrappers.values():
        w.launches = 0
    m = point_read.point_read_metrics()
    before = {k: m[k].value() for k in _POINT_COUNTERS}
    t0 = time.time()
    got = [db.multi_get(ks, top) for ks in small_keys]
    small_s = time.time() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    check_point_launches(launches, 32, files, "small calls")
    replay_per_file(db, small_keys, top,
                    {k: m[k].value() - v for k, v in before.items()}, "small calls")
    for ks, g in zip(small_keys, got):
        same_answers(g, db, ks, top_ht, "small calls")
    out["small"] = {"calls": 32, "keys": int(sizes.sum()), "s": small_s}
    for k, v in launches.items():
        total[k] += v

    exact_keys = col_keys(scrambled_zipfian(n // 4, key_space, rng))
    flags.set_flag("point_read_learned_index", False)
    try:
        got, secs, launches, learned = point_reads(
            db, exact_keys, top, 1024, "reads with the learned index off")
    finally:
        flags.set_flag("point_read_learned_index", True)
    check_point_launches(launches, len(secs), files, "exact reads")
    same_answers(got, db, exact_keys, top_ht, "exact reads")
    if learned["learned_hits"]:
        raise AssertionError(f"exact reads used a learned index: {learned}")
    out["exact"] = {"keys": len(exact_keys), "s": sum(secs),
                    "learned": learned}
    for k, v in launches.items():
        total[k] += v
    out["lindex"] = [r.props.lindex is not None
                     for r in db._readers.values()]

    li_db = lineitem_point_db(lineitem_dir, workdir, device)
    li_keys = lineitem_point_keys(li_db, n // 4, args.seed)
    li_top = HybridTime.kMax
    li_db.multi_get(li_keys[:1024], li_top)             # stages the files
    got, secs, launches, learned = point_reads(
        li_db, li_keys, li_top, 1024, "lineitem reads, learned index on")
    check_point_launches(launches, len(secs), len(li_db._readers),
                         "lineitem reads")
    if learned["learned_hits"] < 1 or learned["learned_fallbacks"]:
        raise AssertionError(f"lineitem reads: learned-index locates and "
                             f"mispredicted keys {learned}; every locate "
                             f"should be seeded and none mispredicted")
    same_answers(got, li_db, li_keys, li_top.value, "lineitem reads")
    out["lineitem"] = {"keys": len(li_keys), "s": sum(secs),
                       "learned": learned,
                       "lindex": [r.props.lindex and r.props.lindex["max_err"]
                                  for r in li_db._readers.values()]}
    for k, v in launches.items():
        total[k] += v
    out["peak_bytes"] = (torch.cuda.max_memory_allocated()
                         if torch.cuda.is_available() else 0)

    fits, fit_launches = point_fit_check(db, li_db)
    out["fits"] = fits
    total["index_fit"] = fit_launches
    return out, total, db, li_db, (keys[:1024], top, li_keys[:1024])


def point_fit_check(*dbs):
    """P4 on every SST's staged cols, the launch counter set to 0 just
    before and read just after: the model it fits (learned_index.
    finish_model over its anchors, p and max_err, as
    `fit_learned_index_device` builds it) equals the file's persisted
    one; a file whose max_err exceeds the bound has none, in both.
    Returns ({file: P4's max_err}, launches)."""
    from yugabyte_tpu_torch.ops import point_read
    from yugabyte_tpu_torch.storage import learned_index
    point_read.index_fit.launches = 0
    out = {}
    for db in dbs:
        for fid, r in db._readers.items():
            st = db._device_cache.get(fid)
            a_hi, a_lo, p, err = point_read.index_fit(st.cols_dev, st.n, st.w)
            model = learned_index.finish_model(
                a_hi.cpu().numpy().view(np.uint32),
                a_lo.cpu().numpy().view(np.uint32), int(p), int(err), st.n)
            if model != r.props.lindex:
                raise AssertionError(f"P4 on {r.base_path}: {model} != "
                                     f"the persisted {r.props.lindex}")
            out[os.path.join(os.path.basename(db.db_dir),
                             os.path.basename(r.base_path))] = int(err)
    log(f"P4 on every SST equals its persisted model (or both none); "
        f"max_err measured {out}")
    return out, point_read.index_fit.launches


def point_breakdown(db, chunk, read_ht):
    """Seconds of each stage of one warm 1024-key chunk, run one after
    the other through the DB's own steps of `_multi_get_device` (the
    body of `_device_chunk` unrolled), each ended by its download or a
    synchronize: host pack (`_pack_chunk`: _doc_key_len,
    pack_query_batch per width, one upload), the P1 + P2 launch over
    every SST (`hash_probe_files`), P3 + the fold over every
    located SST (`locate_fold`) with its one download and the counters,
    combine (the memtable probe, `_mem_probe_many`) and the winners'
    value fetch (`_combine_device_chunk`). Returns the stages, the
    answers and the tensors of the kernel checks."""
    from yugabyte_tpu_torch.ops import point_read as pr
    from yugabyte_tpu_torch.utils import flags
    staged_by = db._stage_live(list(db._readers.items()))
    mems = [m for m in db._mem_snapshot() if not m.empty]
    st_t = {}
    b = len(chunk)
    t0 = time.time()
    table = db._file_table(staged_by)
    hw, dk, qbuf, ql = db._pack_chunk(chunk, None, table)
    sync()
    st_t["host_pack_s"] = time.time() - t0
    t0 = time.time()
    _maybe, located, h1, h2 = pr.hash_probe_files(hw, dk, table, b)
    sync()
    st_t["p1_p2_s"] = time.time() - t0
    t0 = time.time()
    model_on = flags.get_flag("point_read_learned_index")
    rd = read_ht.value
    out = pr.locate_fold(table, qbuf, ql, b, rd >> 32, rd & 0xFFFFFFFF,
                         model_on, located)
    best, loc, _misses = pr.fold_arrays(out.cpu().numpy(), ql.shape[0],
                                        len(table.files))
    best = best if loc.any() else None
    st_t["p3_fold_download_s"] = time.time() - t0
    t = {"qwords_hash": hw, "dkls": dk, "h1": h1, "h2": h2, "b": b,
         "table": table, "qbuf": qbuf, "ql": ql, "located": located,
         "model_on": model_on, "blooms": [f.bloom for f in table.files],
         "locates": [(f.cols, f.n, table.file_queries(qbuf, f, ql.shape[0]),
                      ql, f.model, f.w)
                     for f, on in zip(table.files, loc) if on]}
    t0 = time.time()
    mem_hits = db._mem_probe_many(mems, chunk, read_ht)
    st_t["combine_s"] = time.time() - t0
    t0 = time.time()
    res = [None] * b
    db._combine_device_chunk(chunk, 0, mem_hits, staged_by, best, res)
    st_t["value_fetch_s"] = time.time() - t0
    t["read_ht"] = rd
    t["staged"] = [st for _fid, _r, st in staged_by]
    return st_t, res, t


def bloom_words_touched(h1, h2, bloom) -> int:
    """Distinct words of one filter that the probes of every lane read,
    each lane up to its first zero bit."""
    import torch
    from yugabyte_tpu_torch.ops import point_read as pr
    from yugabyte_tpu_torch.ops.merge_gc import _u
    words, m_bits, k = bloom
    h1, h2 = _u(h1), _u(h2)
    alive = torch.ones_like(h1, dtype=torch.bool)
    touched = []
    for i in range(min(k, pr._K_MAX)):
        pos = (h1 + i * h2) % m_bits
        touched.append((pos >> 5)[alive])
        alive &= ((_u(words)[pos >> 5] >> (pos & 31)) & 1) == 1
    return int(torch.cat(touched).unique().numel())


def point_bytes(t, calls):
    """Bytes each of P1-P4 must move on these inputs, each input read
    once and each output written once. P1: per lane its key words up to
    its doc-key length, the length, 8 bytes out. P2: per lane h1 and h2,
    the distinct filter words the probes read up to each lane's first
    zero bit, 1 byte out. P1 + P2 over every file: P1's bytes, those
    words of every filter and a maybe byte per lane and file plus a flag
    per file out. P3: see locate_bytes and fold_bytes. P4: the two
    coordinate rows of the n real entries, 17 x 8 + 8 bytes out."""
    w = t["qwords_hash"].shape[1]
    dk = t["dkls"].long().clamp(0, 4 * w)
    p1 = int((4 * ((dk + 3) // 4)).sum()) + 12 * dk.numel()
    bloom = next(filter(None, t["blooms"]))
    b_pad = t["h1"].numel()
    p2 = 9 * b_pad + 4 * bloom_words_touched(t["h1"], t["h2"], bloom)
    nf = len(t["blooms"])
    p12_files = p1 + nf * (b_pad + 1) + 4 * sum(
        bloom_words_touched(t["h1"], t["h2"], bl)
        for bl in t["blooms"] if bl is not None)
    p3, chain = locate_bytes(*calls["locate_gather"])
    p3_model, chain_model = locate_bytes(*calls["locate_gather_model"])
    fold, fold_chain = fold_bytes(*calls["locate_fold"])
    fold_model, fold_chain_model = fold_bytes(*calls["locate_fold_model"])
    return {"fnv64": p1, "bloom_probe": p2, "hash_probe_files": p12_files,
            "locate_gather": p3, "locate_gather_model": p3_model,
            "locate_fold": fold, "locate_fold_model": fold_model,
            "index_fit": 8 * calls["index_fit"][1] + 144,
            "chain": chain, "chain_model": chain_model,
            "fold_chain": fold_chain, "fold_chain_model": fold_chain_model}


def fold_bytes(table, qbuf, ql, b, rhi, rlo, model_on, located):
    """P3 + the fold over every located file (locate_fold's arguments):
    the bytes of locate_bytes on each located file, less the per-file
    lengths and outputs, plus the lengths once, the files' flags, and the
    [5, b_pad] result and two counters a file out; the chain is the
    longest of the files' (they run side by side)."""
    b_pad = ql.shape[0]
    nbytes, chains = 0, []
    for f, on in zip(table.files, located.tolist()):
        if not on:
            continue
        fb, ch = locate_bytes(f.cols, f.n, table.file_queries(qbuf, f, b_pad),
                              ql, rhi, rlo, f.model if model_on else None,
                              f.w)
        nbytes += fb - 4 * b_pad - 18 * b_pad
        chains.append(ch)
    nf = len(table.files)
    nbytes += 4 * b_pad + nf + 20 * b_pad + 8 * nf
    chain = max(chains, key=lambda c: c["chain_loads_max"])
    return nbytes, chain


def hbm_load_ns(staged, reps: int) -> dict:
    """Nanoseconds of one dependent load from HBM on this card, from P3
    (`locate_gather`, exact mode) on one lane: each launch timed alone by
    CUDA events after a 256 MiB memset that evicts the 50 MB L2 and a
    spin kernel that keeps the card busy while the host enqueues the
    launch (so the events time the kernel, not the wrapper), over the
    tablet's largest staged SST (the key of its middle entry) and over a
    one-entry matrix (its first column); the difference of the medians
    over the difference of the two chains' distinct 32-byte sectors
    (locate_bytes: the chain's loads that go to HBM). The launch's own
    time is the intercept: the one-entry call less its sectors at that
    latency."""
    import torch
    from yugabyte_tpu_torch.ops import point_read as pr
    from yugabyte_tpu_torch.ops.merge_gc import _ROW_WORDS
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    big = max(staged, key=lambda st: st.n)
    out = {}
    for name, cols, n in (("big", big.cols_dev, big.n),
                          ("one", big.cols_dev[:, :1].contiguous(), 1)):
        j = n // 2
        q = cols[_ROW_WORDS:, j][None].contiguous()
        ql = cols[0, j:j + 1].contiguous()
        args = (cols, n, q, ql, 0xFFFFFFFF, 0xFFFFFFFF, None, big.w)
        _nb, chain = locate_bytes(*args)
        times = []
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(1_000_000)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            pr.locate_gather(*args)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        out[name] = (float(np.median(times)), chain["chain_sectors_max"],
                     chain["chain_loads_max"])
    (t_big, s_big, l_big), (t_one, s_one, l_one) = out["big"], out["one"]
    ns = (t_big - t_one) * 1e6 / max(1, s_big - s_one)
    return {"hbm_load_ns": ns, "launch_ms": t_one - s_one * ns / 1e6,
            "one_lane_ms": {"big": t_big, "one": t_one},
            "one_lane_sectors": {"big": s_big, "one": s_one},
            "one_lane_loads": {"big": l_big, "one": l_one}}


def locate_bytes(cols, n, qw, ql, rhi, rlo, model, w):
    """P3's bytes on one SST (the arguments are locate_gather's) and its
    dependent-load chain, from the cells the kernel reads as
    `locate_gather_plain(trace=)` reports them: a probe reads the key
    words up to the first that differs, key_len only when every word is
    equal and the two ht limbs only when key_len is equal too; the gather
    reads the same prefix and always the ht limbs and wid. Bytes: every
    distinct (row, column) cell read, each lane's query words up to the
    last it compared (at least the model's two coordinate words) and its
    length, the model's 17 x 3 anchors and two scalars, 18 bytes out per
    lane. Chain: per lane the loads of its probes and its gather, one
    after the other (each load depends on the compare before it)."""
    import torch
    from yugabyte_tpu_torch.ops import point_read as pr
    from yugabyte_tpu_torch.ops.merge_gc import _ROW_WORDS
    trace = []
    pr.locate_gather_plain(cols, n, qw, ql, rhi, rlo, model, w, trace=trace)
    b, n_pad = qw.shape[0], cols.shape[1]
    cells, sectors = [], []
    loads = torch.zeros(b, dtype=torch.int64, device=cols.device)
    qwords = torch.zeros(b, dtype=torch.int64, device=cols.device)
    rows = torch.arange(cols.shape[0], device=cols.device)
    for col, read in trace:
        lane, row = read.nonzero(as_tuple=True)
        cells.append(row * n_pad + col[lane])
        # each read cell's 32-byte sector, -1 where the lane reads none
        sectors.append(torch.where(
            read, (rows[None] * n_pad + col[:, None]) // 8, -1))
        loads += read.sum(1)
        qwords = torch.maximum(qwords, read[:, _ROW_WORDS:].sum(1))
    # per lane the distinct sectors of its chain: the loads that can miss
    # the caches (a later load of a sector the chain read hits them)
    sec = torch.sort(torch.cat(sectors, 1), dim=1).values
    fresh = (sec >= 0) & torch.cat(
        [torch.ones_like(sec[:, :1], dtype=torch.bool),
         sec[:, 1:] != sec[:, :-1]], 1)
    if model is not None:
        qwords = torch.clamp(qwords, min=min(max(int(model[3]), 0), w - 2)
                             + 2)
    nbytes = (4 * int(torch.cat(cells).unique().numel())
              + 4 * int(qwords.sum()) + 4 * b + 18 * b
              + (4 * 3 * 17 + 8 if model is not None else 0))
    probes = len(trace) - 1
    return nbytes, {"probes": probes,
                    "chain_loads_mean": float(loads.double().mean()),
                    "chain_loads_max": int(loads.max()),
                    "chain_sectors_max": int(fresh.sum(1).max()),
                    "loads_per_probe_mean": float(
                        (loads - trace[-1][1].sum(1)).double().mean()
                        / probes)}


def point_kernel_phase(args, t, t_li, launches, bandwidth):
    """P1-P4, P1 + P2 and P3 over every file against their plain versions
    on the card, bit for bit, on the point-read phase's tensors: P1 on the
    breakdown chunk's hash batch, P2 on every SST's filter, P3 on every
    located SST of the YCSB chunk (exact mode) and of the lineitem chunk
    (learned-index mode), P1 + P2 (its maybe mask, flags and the hashes,
    also against P1's plain version) and P3 + the fold over every file on
    both chunks (the model on and off), P4 on every staged YCSB and
    lineitem SST (timed at the largest YCSB SST, one launch and no memset
    or copy a call in the profiler). Timed with CUDA events and
    torch.profiler's device time beside their bounds (bytes over the
    card's rate); P3 over every file also beside its floor, one launch
    and its longest dependent-load chain at the HBM load latency measured
    here (hbm_load_ns). No single PyTorch
    call computes any of them (library_ms null). The path's rows are P1,
    P1 + P2 and P3 over every file and P4; P1's row is the P1 + P2
    launch, which computes it on the path, with P1's own bound; the
    per-query P1 and the per-file P2 and P3, which the path no longer
    launches, are checked and timed inside them (`standalone`,
    `per_file`)."""
    import torch
    from yugabyte_tpu_torch.ops import point_read as pr

    def same(got, want, what):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(max_abs_err(g.reshape(-1), x.reshape(-1))
                  for g, x in zip(got, want))
        if err or not all(torch.equal(g.reshape(-1), x.reshape(-1))
                          for g, x in zip(got, want)):
            raise AssertionError(f"{what} != its plain version "
                                 f"(max_abs_err {err})")
        return err

    names = ("fnv64", "bloom_probe", "locate_gather", "index_fit",
             "hash_probe_files", "locate_fold")
    errs = {k: 0 for k in names}
    calls = {}
    for tt in (t, t_li):
        args1 = (tt["qwords_hash"], tt["dkls"])
        errs["fnv64"] = max(errs["fnv64"], same(
            pr.fnv64(*args1), pr.fnv64_plain(*args1), "P1"))
        calls.setdefault("fnv64", args1)
        for words, m_bits, k in filter(None, tt["blooms"]):
            a = (tt["h1"], tt["h2"], words, m_bits, k)
            errs["bloom_probe"] = max(errs["bloom_probe"], same(
                pr.bloom_probe(*a), pr.bloom_probe_plain(*a), "P2"))
            calls.setdefault("bloom_probe", a)
        rd = tt["read_ht"]
        for cols, n, qw, ql, model, w in tt["locates"]:
            # exact mode on every located SST; learned-index mode where
            # the file has a model
            for m in {id(None): None, id(model): model}.values():
                a = (cols, n, qw, ql, rd >> 32, rd & 0xFFFFFFFF, m, w)
                errs["locate_gather"] = max(errs["locate_gather"], same(
                    pr.locate_gather(*a), pr.locate_gather_plain(*a), "P3"))
                calls.setdefault("locate_gather" if m is None
                                 else "locate_gather_model", a)
        a2 = (tt["qwords_hash"], tt["dkls"], tt["table"], tt["b"])
        got2 = pr.hash_probe_files(*a2)
        errs["hash_probe_files"] = max(
            errs["hash_probe_files"],
            same(got2, pr.hash_probe_files_plain(*a2),
                 "P1 + P2 over every file"),
            same(got2[2:], pr.fnv64_plain(*args1), "the path's hash"))
        calls.setdefault("hash_probe_files", a2)
        for model_on in (True, False):
            a3 = (tt["table"], tt["qbuf"], tt["ql"], tt["b"], rd >> 32,
                  rd & 0xFFFFFFFF, model_on, tt["located"])
            errs["locate_fold"] = max(errs["locate_fold"], same(
                pr.locate_fold(*a3), pr.locate_fold_plain(*a3),
                "P3 + the fold over every file"))
            uses = model_on and any(f.model is not None
                                    for f in tt["table"].files)
            calls.setdefault("locate_fold_model" if uses else "locate_fold",
                             a3)
        for st in tt["staged"]:
            a4 = (st.cols_dev, st.n, st.w)
            errs["index_fit"] = max(errs["index_fit"], same(
                pr.index_fit(*a4), pr.index_fit_plain(*a4), "P4"))
            if tt is t and st.n > calls.get("index_fit", (None, 0))[1]:
                calls["index_fit"] = a4      # timed at the largest YCSB SST
    for need in ("locate_gather", "locate_gather_model", "locate_fold",
                 "locate_fold_model"):
        if need not in calls:
            raise AssertionError(f"{need} was not checked")
    log("kernels P1-P4, P1 + P2 and P3 over every file == their plain "
        "versions on the point-read phase's tensors (P3 in exact and "
        "learned-index mode; the path's hashes == P1's)")
    nbytes = point_bytes(t, calls)
    kern = {"fnv64": pr.fnv64, "bloom_probe": pr.bloom_probe,
            "locate_gather": pr.locate_gather,
            "locate_gather_model": pr.locate_gather,
            "index_fit": pr.index_fit,
            "hash_probe_files": pr.hash_probe_files,
            "locate_fold": pr.locate_fold,
            "locate_fold_model": pr.locate_fold}
    plain = {"fnv64": pr.fnv64_plain, "bloom_probe": pr.bloom_probe_plain,
             "locate_gather": pr.locate_gather_plain,
             "locate_gather_model": pr.locate_gather_plain,
             "index_fit": pr.index_fit_plain,
             "hash_probe_files": pr.hash_probe_files_plain,
             "locate_fold": pr.locate_fold_plain,
             "locate_fold_model": pr.locate_fold_plain}
    times = {k: (cuda_ms(lambda k=k: kern[k](*calls[k]), args.reps),
                 cuda_ms(lambda k=k: plain[k](*calls[k]), 2))
             for k in kern}
    dev = {k: device_profile(lambda k=k: kern[k](*calls[k]), args.reps)
           for k in ("hash_probe_files", "locate_fold", "locate_fold_model",
                     "index_fit")}
    one_launch_no_copy("index_fit", dev["index_fit"])
    lat = hbm_load_ns(t["staged"], 3 * args.reps)
    log(f"HBM load latency {lat['hbm_load_ns']:.1f} ns, launch "
        f"{lat['launch_ms']:.4f} ms (one lane: {lat['one_lane_ms']}, chain "
        f"sectors {lat['one_lane_sectors']}, loads {lat['one_lane_loads']})")
    replaces = {"fnv64": "yugabyte_tpu/ops/point_read.py:150",
                "bloom_probe": "yugabyte_tpu/ops/point_read.py:171",
                "locate_gather": "yugabyte_tpu/ops/point_read.py:317",
                "index_fit": "yugabyte_tpu/ops/point_read.py:257"}
    replaces["hash_probe_files"] = replaces["bloom_probe"]
    replaces["locate_fold"] = replaces["locate_gather"]

    def entry(name):
        ms, plain_ms = times[name]
        return {"name": name, "route": "cuda",
                "source": "yugabyte_tpu_torch/csrc/point_read.cu",
                "replaces": replaces[name], "launches": launches[name],
                "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": nbytes[name] / bandwidth * 1e3,
                "bound_by": "bytes", "library_ms": None}

    rows = []
    for name in ("fnv64", "hash_probe_files", "locate_fold", "index_fit"):
        e = entry(name)
        if name == "fnv64":
            e.update(launches=launches["hash_probe_files"],
                     ms=times["hash_probe_files"][0],
                     device_ms=dev["hash_probe_files"]["device_ms"],
                     max_abs_err=max(errs["fnv64"],
                                     errs["hash_probe_files"]),
                     fused_into="hash_probe_files",
                     standalone=entry("fnv64"))
        if name == "index_fit":
            e.update(device_ms=dev[name]["device_ms"],
                     launches_per_call=dev[name]["launches_per_call"],
                     n=int(calls[name][1]))
        if name == "hash_probe_files":
            e["device_ms"] = dev[name]["device_ms"]
            e["launches_per_call"] = dev[name]["launches_per_call"]
            e["per_file"] = entry("bloom_probe")
            e["files"] = len(t["blooms"])
        if name == "locate_fold":
            mm, mp = times["locate_fold_model"]
            pf = entry("locate_gather")
            pm, pp = times["locate_gather_model"]
            pf.update({"chain": nbytes["chain"], "ms_model": pm,
                       "plain_ms_model": pp,
                       "bound_ms_model": nbytes["locate_gather_model"]
                       / bandwidth * 1e3,
                       "chain_model": nbytes["chain_model"]})
            ns = lat["hbm_load_ns"]
            e.update({
                "device_ms": dev[name]["device_ms"],
                "launches_per_call": dev[name]["launches_per_call"],
                "chain": nbytes["fold_chain"], "ms_model": mm,
                "plain_ms_model": mp,
                "device_ms_model": dev["locate_fold_model"]["device_ms"],
                "bound_ms_model": nbytes["locate_fold_model"]
                / bandwidth * 1e3,
                "chain_model": nbytes["fold_chain_model"],
                "hbm_load_ns": ns, "launch_ms": lat["launch_ms"],
                "floor_ms": lat["launch_ms"]
                + nbytes["fold_chain"]["chain_loads_max"] * ns / 1e6,
                "floor_ms_model": lat["launch_ms"]
                + nbytes["fold_chain_model"]["chain_loads_max"] * ns / 1e6,
                "floor_ms_sectors": lat["launch_ms"]
                + nbytes["fold_chain"]["chain_sectors_max"] * ns / 1e6,
                "hbm_probe": lat, "located": int(t["located"].sum()),
                "files": len(t["table"].files), "per_file": pf})
        log(f"kernel {name}: equal; {e['ms']:.4f} ms (plain "
            f"{e['plain_ms']:.4f}, bound {e['bound_ms']:.6f}), "
            f"{e['launches']} launches"
            + (f"; device {e['device_ms']:.4f} ms, model mode "
               f"{e['ms_model']:.4f} ms, floor {e['floor_ms']:.4f} / "
               f"{e['floor_ms_model']:.4f} ms, chains {e['chain']} / "
               f"{e['chain_model']}; per file {e['per_file']['ms']:.4f} ms"
               if name == "locate_fold" else "")
            + (f"; device {e['device_ms']:.4f} ms; per file "
               f"{e['per_file']['ms']:.4f} ms"
               if name == "hash_probe_files" else "")
            + (f"; device {e['device_ms']:.4f} ms at {e['n']} entries, one "
               f"launch a call" if name == "index_fit" else "")
            + (f"; the P1 + P2 launch; standalone "
               f"{e['standalone']['ms']:.4f} ms" if name == "fnv64" else ""))
        rows.append(e)
    return rows


# --------------------------------------------------------------------------
# The resident chain: flush write-through, chained L0->L1->L2 compaction
# with the device slab cache and the run cache, the skewed pick and the
# reads over resident sources.


def _chain_wrappers():
    """The main-path wrappers plus P4 (the learned-index fit of each
    write-through span)."""
    from yugabyte_tpu_torch.ops import point_read
    return {**_wrappers(), "index_fit": point_read.index_fit}


# per chained job: the kernels it must launch, and those it must not
_CHAIN_KERNELS = {
    "l0_l1_codec": (("merge_path_level", "gc_pack", "survivor_scan",
                     "span_gather", "block_encode", "staged_concat",
                     "index_fit"), ("block_decode",)),
    "l0_l1_shell": (("merge_path_level", "gc_pack", "survivor_scan",
                     "span_gather", "staged_concat", "index_fit"),
                    ("block_decode", "block_encode")),
    "l1_l2_warm": (("merge_path_level", "gc_pack", "survivor_scan",
                    "span_gather", "staged_concat", "index_fit"),
                   ("block_decode", "block_encode")),
    "skewed_resident": (("staged_concat", "radix_sort", "sorted_payload",
                         "gc_pack"), ("merge_path_level",)),
}


def chain_counters() -> dict:
    """The port's own process counters: host block decodes (SSTReader),
    key-column uploads (stage_slab, stage_runs_from_slabs, the codec's raw
    column upload) and native-shell file ingests."""
    from yugabyte_tpu_torch.ops import merge_gc
    from yugabyte_tpu_torch.storage import compaction, sst
    return {"host_block_decodes": sst.blocks_decoded(),
            "key_col_uploads": merge_gc.key_col_uploads(),
            "shell_file_ingests": compaction.ingest_decodes()}


def chain_job(tag, fn, wrappers, cache):
    """Run one chained job with every launch counter set to 0 just before
    and read just after: (result, seconds, launches, counter deltas).
    Checks the job's kernels (_CHAIN_KERNELS) and that no pin is left."""
    for w in wrappers.values():
        w.launches = 0
    c0 = chain_counters()
    t0 = time.time()
    res = fn()
    sync()
    secs = time.time() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    counts = {k: v - c0[k] for k, v in chain_counters().items()}
    if tag in _CHAIN_KERNELS:
        need, absent = _CHAIN_KERNELS[tag]
        for k in need:
            if launches[k] <= 0:
                raise AssertionError(f"{tag}: kernel {k} was not launched")
        for k in absent:
            if launches[k]:
                raise AssertionError(f"{tag}: kernel {k} launched "
                                     f"{launches[k]} times")
    if cache is not None and cache.pinned_count():
        raise AssertionError(f"{tag}: {cache.pinned_count()} pins left")
    return res, secs, launches, counts


def profile_top(fn, n: int) -> dict:
    """Host seconds of one call of fn under cProfile (the calling thread;
    a helper thread shows as the join that waits for it) and its n
    functions with the most cumulative seconds."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    t0 = time.time()
    prof.enable()
    fn()
    sync()
    prof.disable()
    secs = time.time() - t0
    rows = sorted(((v[3], v[2], f"{os.path.basename(k[0])}:{k[1]}:{k[2]}")
                   for k, v in pstats.Stats(prof).stats.items()),
                  reverse=True)
    return {"seconds": secs, "top_cumulative_s": [
        [name, cum, tot] for cum, tot, name in rows[:n]]}


def same_data(a, b, what):
    """The data files of two jobs byte for byte (a job with a cache fits
    the learned index into its base files; the native job does not)."""
    if (a.rows_in, a.rows_out) != (b.rows_in, b.rows_out) \
            or len(a.outputs) != len(b.outputs) or not a.outputs:
        raise AssertionError(f"{what}: jobs disagree on rows/files")
    for (_, pa, _), (_, pb, _) in zip(a.outputs, b.outputs):
        with open(pa + ".sblock.0", "rb") as f1, \
                open(pb + ".sblock.0", "rb") as f2:
            if f1.read() != f2.read():
                raise AssertionError(f"{what}: {os.path.basename(pa)} "
                                     f"differs")


def check_installed(cache, result, level, what):
    for fid, _p, props in result.outputs:
        if cache.level_of(fid) != level or cache.get(fid).n != \
                props.n_entries:
            raise AssertionError(f"{what}: output {fid} is not installed "
                                 f"at level {level}")


def verify_entries(cache, samples, what):
    """The digest check at sample 1.0 on (fid, base path) samples: each
    entry's cols == a host re-stage of its SST."""
    from yugabyte_tpu_torch.storage import integrity
    from yugabyte_tpu_torch.utils import flags
    old = flags.get_flag("resident_digest_sample")
    flags.set_flag("resident_digest_sample", 1.0)
    try:
        for fid, base in samples:
            if not integrity.maybe_verify_resident_entry(cache.get(fid),
                                                         base):
                raise AssertionError(f"{what}: entry {fid} differs from a "
                                     f"host re-stage of {base}")
    finally:
        flags.set_flag("resident_digest_sample", old)


def resident_chain_phase(args, runs, readers, workdir, card, device="cuda"):
    """The resident chain over the compaction phase's 4 input SSTs (the
    10M-row tablet, w = 8, 64-byte values):

    1. flush write-through: the 4 runs staged into a DeviceSlabCache at
       level 0 (from the slabs written, as flush does) and exported into
       a run cache (export_reader);
    2. L0->L1 twice over the same inputs: the codec route (no run cache:
       the inputs come from the slab cache, no kernel C) and the shell
       route (every input run-cached: no file read, no host decode);
       files == the native job's, each output installed under its id at
       level 1; rows/s beside the native job's in this call;
    3. L1->L2 warm: the shell job's first two outputs (resident and
       run-cached) through the device-native job: no key-column upload,
       no host block decode, no shell file ingest (the port's counters),
       files == the native job's; rows/s beside native and the same job
       cold (no caches);
    4. the range scan of section 6's bounds over ResidentSources of the
       codec job's L1 outputs, in lockstep with the host reference, with
       no key-column upload and only survivor blocks decoded;
    5. the digest check at sample 1.0 on a sample of entries; no pin is
       left after any job; peak device memory.
    Every launch counter is set to 0 just before each job and read just
    after. Returns (summary, per-job launches, the chain state)."""
    import torch
    from yugabyte_tpu_torch.ops import scan
    from yugabyte_tpu_torch.storage import compaction, integrity
    from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
    from yugabyte_tpu_torch.storage.run_cache import (NamespacedRunCache,
                                                      NativeRunCache,
                                                      export_reader)
    from yugabyte_tpu_torch.storage.sst import SSTReader
    from yugabyte_tpu_torch.utils import flags

    # the sampled digest check decodes the file it checks: off inside the
    # counted windows, on at 1.0 for the explicit checks (verify_entries)
    old_sample = flags.get_flag("resident_digest_sample")
    flags.set_flag("resident_digest_sample", 0.0)
    cutoff = history_cutoff(args.rows)
    wrappers = _chain_wrappers()
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    cache = DeviceSlabCache(device, capacity_bytes=32 << 30)
    rc = NamespacedRunCache(NativeRunCache(capacity_bytes=32 << 30), "chain")
    out = {"card": card}
    launches = {}
    ids_l0 = list(range(len(readers)))
    t0 = time.time()
    for fid, slab in zip(ids_l0, runs):
        cache.stage(fid, slab, level=0)
    sync()
    out["flush_stage_s"] = time.time() - t0
    t0 = time.time()
    for fid, r in zip(ids_l0, readers):
        export_reader(rc, fid, r)
    out["flush_export_s"] = time.time() - t0
    rows = sum(r.props.n_entries for r in readers)
    n_id = iter(range(5000, 10 ** 6))

    def run(tag, inputs, ids, run_cache, cache_=cache):
        d = os.path.join(workdir, f"chain_{tag}")
        os.makedirs(d)
        if tag.startswith("native"):
            return lambda: compaction._run_native_job(
                inputs, d, lambda: next(n_id), cutoff, True, False, None)
        return lambda: compaction.run_compaction_job_device_native(
            inputs, d, lambda: next(n_id), cutoff, True, device=device,
            device_cache=cache_, input_ids=ids, run_cache=run_cache)

    res = {}
    for tag, inputs, ids, run_cache, cache_ in (
            ("native_l0_l1", readers, None, None, None),
            ("l0_l1_codec", readers, ids_l0, None, cache),
            ("l0_l1_shell", readers, ids_l0, rc, cache)):
        r, secs, launches[tag], counts = chain_job(
            tag, run(tag, inputs, ids, run_cache, cache_), wrappers, cache_)
        res[tag] = r
        out[tag] = {"seconds": secs, "rows_per_s": rows / secs,
                    "rows_out": r.rows_out, "files": len(r.outputs),
                    "counters": counts}
        if cache_ is not None:
            same_data(r, res["native_l0_l1"], f"{tag} vs native")
            check_installed(cache, r, 1, tag)
        log(f"chain {tag}: {rows} rows -> {r.rows_out} rows, "
            f"{len(r.outputs)} files, {secs:.2f}s ({rows / secs:,.0f} "
            f"rows/s); counters {counts}; launches "
            f"{ {k: v for k, v in launches[tag].items() if v} } [{card}]")
    if out["l0_l1_shell"]["counters"] != {"host_block_decodes": 0,
                                          "key_col_uploads": 0,
                                          "shell_file_ingests": 0}:
        raise AssertionError("the run-cached L0->L1 job decoded or "
                             "uploaded: " + str(out["l0_l1_shell"]))
    if not all(rc.contains(f) for f, _p, _pr in res["l0_l1_shell"].outputs):
        raise AssertionError("the shell route did not export its outputs")

    if len(res["l0_l1_shell"].outputs) < 2:
        raise AssertionError(f"the L0->L1 job wrote "
                             f"{len(res['l0_l1_shell'].outputs)} file(s); "
                             f"L1->L2 takes two (main lowers "
                             f"compaction_max_output_entries_per_sst)")
    l1 = res["l0_l1_shell"].outputs[:2]
    l1_readers = [SSTReader(p) for _f, p, _pr in l1]
    l1_ids = [f for f, _p, _pr in l1]
    rows2 = sum(r.props.n_entries for r in l1_readers)
    for tag, ids, run_cache, cache_ in (
            ("native_l1_l2", None, None, None),
            ("l1_l2_warm", l1_ids, rc, cache),
            ("l1_l2_cold", None, None, None)):
        r, secs, launches[tag], counts = chain_job(
            tag, run(tag, l1_readers, ids, run_cache, cache_), wrappers,
            cache_)
        res[tag] = r
        out[tag] = {"seconds": secs, "rows_per_s": rows2 / secs,
                    "rows_out": r.rows_out, "files": len(r.outputs),
                    "counters": counts}
        if tag != "native_l1_l2":
            same_data(r, res["native_l1_l2"], f"{tag} vs native")
        log(f"chain {tag}: {rows2} rows in {l1_ids} -> {r.rows_out} rows, "
            f"{secs:.2f}s ({rows2 / secs:,.0f} rows/s); counters {counts}; "
            f"launches { {k: v for k, v in launches[tag].items() if v} } "
            f"[{card}]")
    if out["l1_l2_warm"]["counters"] != {"host_block_decodes": 0,
                                         "key_col_uploads": 0,
                                         "shell_file_ingests": 0}:
        raise AssertionError("the warm L1->L2 job decoded or uploaded: "
                             + str(out["l1_l2_warm"]))
    check_installed(cache, res["l1_l2_warm"], 2, "l1_l2_warm")
    # where the warm job's host time goes: the same job once more under
    # cProfile (its outputs under fresh ids)
    out["l1_l2_warm_profile"] = profile_top(
        run("l1_l2_warm_profiled", l1_readers, l1_ids, rc), 16)
    log("warm L1->L2 under cProfile: " + json.dumps(
        out["l1_l2_warm_profile"]))

    # the range scan over the codec job's resident L1 outputs
    _r_ht, lower, upper = scan_bounds(args.rows)
    codec_l1 = res["l0_l1_codec"].outputs
    s_readers = [SSTReader(p) for _f, p, _pr in codec_l1]
    slabs = [r.read_all() for r in s_readers]
    srcs = [scan.ResidentSource(r, cache.get(f))
            for (f, _p, _pr), r in zip(codec_l1, s_readers)]
    c0 = chain_counters()
    t0 = time.time()
    range_launches = {}
    n = entries_lockstep(
        counted(lambda: scan.visible_entries_sources(srcs, cutoff, lower,
                                                     upper, device=device),
                wrappers, "resident range scan", "range_scan",
                range_launches),
        scan._visible_entries_host(slabs, cutoff, lower, upper),
        "resident range scan")
    counts = {k: v - c0[k] for k, v in chain_counters().items()}
    decoded = sum(s.decoded_blocks for s in srcs)
    launches["resident_range_scan"] = range_launches
    if n == 0 or counts["key_col_uploads"] or \
            counts["host_block_decodes"] != decoded:
        raise AssertionError(f"resident range scan: {n} entries, counters "
                             f"{counts}, {decoded} survivor blocks")
    out["resident_range_scan"] = {
        "entries": n, "seconds_with_host_reference": time.time() - t0,
        "decoded_blocks": decoded,
        "blocks": sum(r.n_blocks for r in s_readers), "counters": counts}
    log(f"resident range scan over {len(srcs)} L1 files == host reference "
        f"({n} entries); decoded {decoded} of "
        f"{out['resident_range_scan']['blocks']} blocks; no key-column "
        f"upload")
    del slabs, srcs

    verify_entries(cache, [(codec_l1[0][0], codec_l1[0][1]),
                           (res["l1_l2_warm"].outputs[0][0],
                            res["l1_l2_warm"].outputs[0][1])],
                   "resident chain")
    snap = integrity.resident_digest_snapshot()
    if snap["mismatches"]:
        raise AssertionError(f"resident digest mismatches: {snap}")
    out["digest"] = snap
    out["cache"] = cache.snapshot()
    out["run_cache_bytes"] = rc._shared.used_bytes
    out["peak_bytes"] = (torch.cuda.max_memory_allocated()
                         if torch.cuda.is_available() else 0)
    flags.set_flag("resident_digest_sample", old_sample)
    for r in l1_readers + s_readers:
        r.close()
    log(f"resident chain: warm L1->L2 {out['l1_l2_warm']['rows_per_s']:,.0f}"
        f" rows/s, cold {out['l1_l2_cold']['rows_per_s']:,.0f}, native "
        f"{out['native_l1_l2']['rows_per_s']:,.0f}; L0->L1 codec "
        f"{out['l0_l1_codec']['rows_per_s']:,.0f}, shell "
        f"{out['l0_l1_shell']['rows_per_s']:,.0f}, native "
        f"{out['native_l0_l1']['rows_per_s']:,.0f}; peak "
        f"{out['peak_bytes']} bytes [{card}]")
    state = {"cache": cache, "rc": rc, "l1_first": codec_l1[0][:2]}
    return out, launches, state


def resident_skewed_phase(args, state, skew_paths, workdir, card,
                          device="cuda"):
    """The skewed pick with the cache: the codec chain's first L1 file
    (resident at level 1, the same data bytes as the skewed phase's base
    file, and its base file's but for a learned index)
    plus the skewed phase's 4 L0 flushes of --skew-rows updates, staged
    at level 0 as flush does, through the router's Python path with the
    cache (kernels H, G, I.1, B over the concatenated resident cols):
    files == the native job's, no key column uploaded for an input (one
    upload per output: the Python path's write-through re-stages its
    output slabs), every output installed at level 2, one entry == a
    host re-stage of its SST. Returns (summary, launches)."""
    from yugabyte_tpu_torch.storage import compaction
    from yugabyte_tpu_torch.storage.sst import SSTReader
    cache = state["cache"]
    base_fid, base_path = state["l1_first"]
    # the same data file byte for byte; the base files too, but for the
    # learned index the chain's job may fit into its own (P4; the
    # router's job fits none)
    with open(base_path + ".sblock.0", "rb") as f1, \
            open(skew_paths[0] + ".sblock.0", "rb") as f2:
        same = f1.read() == f2.read()
    with open(base_path, "rb") as f1, open(skew_paths[0], "rb") as f2:
        if same and f1.read() != f2.read():
            ra, rb = SSTReader(base_path), SSTReader(skew_paths[0])
            pa, pb = ra.props, rb.props
            ra.close()
            rb.close()
            same = pa.lindex is not None and pb.lindex is None and (
                pa.n_entries, pa.first_key, pa.last_key, pa.data_size,
                pa.frontier) == (pb.n_entries, pb.first_key, pb.last_key,
                                 pb.data_size, pb.frontier)
    if not same:
        raise AssertionError("the chain's L1 file differs from the "
                             "skewed pick's base file")
    readers = [SSTReader(base_path)] + [SSTReader(p) for p in skew_paths[1:]]
    ids = [base_fid] + [9000 + i for i in range(len(skew_paths) - 1)]
    for fid, r in zip(ids[1:], readers[1:]):
        cache.stage(fid, r.read_all(), level=0)
    cutoff = skewed_cutoff(args)
    wrappers = _chain_wrappers()
    n_id = iter(range(20000, 30000))
    res = {}
    out = {}
    for tag in ("native", "skewed_resident"):
        d = os.path.join(workdir, f"chain_skewed_{tag}")
        os.makedirs(d)
        if tag == "native":
            fn = (lambda d=d: compaction._run_native_job(
                readers, d, lambda: next(n_id), cutoff, True, False, None))
        else:
            fn = (lambda d=d: compaction.run_compaction_job(
                readers, d, lambda: next(n_id), cutoff, True, device=device,
                device_cache=cache, input_ids=ids))
        res[tag], secs, launches, counts = chain_job(
            tag, fn, wrappers, cache if tag != "native" else None)
        out[tag] = {"seconds": secs, "counters": counts,
                    "rows_per_s": sum(r.props.n_entries
                                      for r in readers) / secs}
    r = res["skewed_resident"]
    same_files(r, res["native"], "resident skewed pick vs native")
    check_installed(cache, r, 2, "resident skewed pick")
    if out["skewed_resident"]["counters"]["key_col_uploads"] != \
            len(r.outputs):
        raise AssertionError(f"resident skewed pick uploaded inputs: "
                             f"{out['skewed_resident']}")
    verify_entries(cache, [r.outputs[0][:2]], "resident skewed pick")
    out.update(rows_out=r.rows_out, files=len(r.outputs), launches=launches)
    log(f"resident skewed pick: {r.rows_out} rows, {len(r.outputs)} files "
        f"== native; {out['skewed_resident']['rows_per_s']:,.0f} rows/s, "
        f"native {out['native']['rows_per_s']:,.0f}; counters "
        f"{out['skewed_resident']['counters']}; launches "
        f"{ {k: v for k, v in launches.items() if v} } [{card}]")
    for rd in readers:
        rd.close()
    return out, launches


def kernel_name(name: str) -> str:
    """A profiler event's kernel name without namespace, template
    arguments and parameters; "Memset" or "Memcpy" for those."""
    if name.startswith(("Memset", "Memcpy")):
        return name.split(" ")[0]
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    for cut in ("(", "<"):
        name = name.split(cut)[0]
    return name.split("::")[-1]


def resident_device_breakdown(call, wall_s: float) -> dict:
    """torch.profiler's device time of one call by kernel name (H, G, I.1,
    B, J.1, J.2, K, memsets and copies: {name: [ms, launches]}), their sum
    and its share of the call's wall time `wall_s`."""
    kernels = {}
    for name, us in profiled(call, 1):
        ms, k = kernels.get(kernel_name(name), (0.0, 0))
        kernels[kernel_name(name)] = (ms + us / 1e3, k + 1)
    dev_ms = sum(ms for ms, _k in kernels.values())
    return {"device_ms": dev_ms, "device_share": dev_ms / 1e3 / wall_s,
            "device_kernels": {k: list(v) for k, v in sorted(
                kernels.items(), key=lambda kv: -kv[1][0])}}


def resident_pushdown_phase(args, workdir, slabs, push_out, top_ht, card,
                            device="cuda"):
    """q1_agg and q6_agg over the lineitem SSTs as ResidentSources: the
    files staged into a DeviceSlabCache with include_vals=True (flush
    write-through with the value words), then each query once over the
    SlabSources (pack + upload inside) and over the resident sources:
    the first resident call counted (it uploads no key column and
    launches the multi-source kernels), then --reps warm calls timed (the
    median) and one on the device by kernel name (torch.profiler), all in
    this call; the answers equal each other and the pushdown phase's.
    Returns (summary, launches)."""
    from yugabyte_tpu_torch.ops import scan
    from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
    from yugabyte_tpu_torch.storage.sst import SSTReader
    cache = DeviceSlabCache(device, capacity_bytes=32 << 30)
    t0 = time.time()
    for i, s in enumerate(slabs):
        cache.stage(i, s, include_vals=True)
    sync()
    out = {"stage_with_vals_s": time.time() - t0}
    readers = [SSTReader(os.path.join(workdir, "lineitem", f"{i:06d}.sst"))
               for i in range(len(slabs))]
    queries = pushdown_queries(lineitem_schema())
    wrappers = {**_wrappers(), **_pushdown_wrappers()}
    launches = {}
    srcs = [scan.ResidentSource(r, cache.get(i))
            for i, r in enumerate(readers)]
    for qname in ("q1_agg", "q6_agg"):
        mode, spec = queries[qname]
        t0 = time.time()
        want = scan.aggregate_sources(
            [scan.SlabSource(s, sorted_source=True) for s in slabs], top_ht,
            spec, device=device)
        sync()
        t_slab = time.time() - t0

        def call():
            return scan.aggregate_sources(srcs, top_ht, spec, device=device)
        for w in wrappers.values():
            w.launches = 0
        c0 = chain_counters()
        got = call()
        counts = {k: v - c0[k] for k, v in chain_counters().items()}
        launches[qname] = {k: w.launches for k, w in wrappers.items()}
        check_pushdown_launches(launches[qname], mode, False,
                                f"resident {qname}")
        if got != want or got["rows"] != push_out[qname]["answer"]["rows"]:
            raise AssertionError(f"resident {qname}: the answer differs")
        if counts["key_col_uploads"] or counts["host_block_decodes"]:
            raise AssertionError(f"resident {qname} uploaded or decoded: "
                                 f"{counts}")
        # warm calls: the median wall time; one call on the device
        walls = []
        for _ in range(args.reps):
            t0 = time.time()
            again = call()   # its answer is on the host: a synchronize
            walls.append(time.time() - t0)
            if again != want:
                raise AssertionError(f"resident {qname}: a warm call's "
                                     f"answer differs")
        t_res = float(np.median(walls))
        res = {"resident_s": t_res, "resident_walls_s": walls,
               "slab_source_s": t_slab, "rows": got["rows"],
               "counters": counts, **resident_device_breakdown(call, t_res)}
        out[qname] = res
        log(f"resident {qname} == SlabSource answer ({got['rows']} rows): "
            f"{t_res:.4f}s resident (median of {args.reps}), {t_slab:.3f}s "
            f"over SlabSources; counters {counts}; device "
            f"{res['device_ms']:.4f} ms a call (share "
            f"{res['device_share']:.3f}): {res['device_kernels']} [{card}]")
    for r in readers:
        r.close()
    return out, launches


def latency_floors(point_rows, rows) -> None:
    """Each row's latency floor beside its byte bound, as P3's: one launch
    plus its longest chain of dependent loads (`chain_loads_max`) at one
    HBM load each, both from the point-read phase's probe (hbm_load_ns)."""
    lat = next(e["hbm_probe"] for e in point_rows
               if e["name"] == "locate_fold")
    for e in rows:
        loads = e["chain"]["chain_loads_max"]
        e.update(hbm_load_ns=lat["hbm_load_ns"], launch_ms=lat["launch_ms"],
                 floor_ms=lat["launch_ms"] + loads * lat["hbm_load_ns"] / 1e6)
        log(f"kernel {e['name']}: floor {e['floor_ms']:.4f} ms (one launch "
            f"{lat['launch_ms']:.4f} + {loads} dependent loads at "
            f"{lat['hbm_load_ns']:.1f} ns), device {e['device_ms']:.4f} ms")


# ------------------------------------------------------------------ faults
# The counters of a containment, which no phase that armed no fault may
# move: the native completions after a device fault, the quarantines
# (timed and sticky), the shadow verifier's mismatches, the point read's
# native batches, the download retries, and the work the health board's
# gate sent native (a parked bucket, or a degraded one with no probe).
_FAULT_COUNTERS = (
    ("board_routing", "board_routed_native_total"),
    ("offload_policy", "compaction_device_fallback_total"),
    ("offload_policy", "offload_quarantine_added_total"),
    ("bucket_health", "bucket_health_quarantines_total"),
    ("bucket_health", "bucket_health_mismatch_total"),
    ("integrity", "device_shadow_mismatch_total"),
    ("point_read", "point_read_device_fallback_total"),
    ("kernels", "kernel_chunk_retry_total"),
)
_fault_base: dict = {}


def fault_counts() -> dict:
    from yugabyte_tpu_torch.utils.metrics import ROOT_REGISTRY
    return {f"{e}:{n}": ROOT_REGISTRY.entity("server", e).counter(n).value()
            for e, n in _FAULT_COUNTERS}


def no_fallbacks(what: str) -> None:
    """Fail when a phase that armed no fault moved a containment counter;
    then take the current counts as the next phase's baseline."""
    now = fault_counts()
    moved = {k: v - _fault_base.get(k, 0) for k, v in now.items()
             if v != _fault_base.get(k, 0)}
    if _fault_base and moved:
        raise AssertionError(f"{what}: a phase that armed no fault moved "
                             f"containment counters {moved}")
    _fault_base.clear()
    _fault_base.update(now)


def reset_fault_base() -> None:
    """After a phase that armed faults (and checked every count it
    moved): its counts are the next phase's baseline."""
    _fault_base.clear()
    _fault_base.update(fault_counts())


def fault_moves(before: dict, want: dict, what: str) -> dict:
    """The counters a faulted step moved, which must be exactly `want`
    (short names: the part after the entity)."""
    moved = fault_counts_delta(before)
    if moved != want:
        raise AssertionError(f"{what}: containment counters moved "
                             f"{moved}, expected {want}")
    return moved


def fault_line(card: str, what: str, rec: dict) -> None:
    """One line of the faults phase on stdout, with the card."""
    print("faults: " + json.dumps({"step": what, "card": card, **rec}),
          flush=True)


def _device_launches(launches: dict, names) -> int:
    return sum(launches[k] for k in names)


_CODEC_KERNELS = ("merge_path_level", "gc_pack", "block_decode",
                  "survivor_scan", "span_gather", "block_encode",
                  "staged_concat")


def faults_phase(args, readers, workdir, card, comp, device="cuda"):
    """Containment at the main path's width and the reference's rate race,
    each step with its faults armed and its counters checked exactly:

      - the 10M-row tablet (config 2) on the codec route: oom:result:1 is
        absorbed by the download's one relaunch (job on the device);
        oom:result:2 exhausts it: the job completes natively (files ==
        native), the (k_pad, m) bucket and the first file's decode bucket
        are QUARANTINED, and the next job over the bucket launches no
        A-F (five armed faults stay armed);
      - a real torch.cuda.OutOfMemoryError: the caching allocator capped
        at half the codec job's peak above what is allocated; the job
        over a DeviceSlabCache completes natively with no pin left, and
        after the cap is lifted, empty_cache() and the window's decay a
        device job writes the same files;
      - decay and probation on a 1M-row tablet of the same generator: a
        dispatch fault, the window decays (device_fault_quarantine_s 1),
        the next job re-proves the bucket on the card (kernels launched,
        PROBATION), the next one makes it HEALTHY;
      - the shadow verifier (sample 1.0): bitflip:survivor:1 is caught
        before install, contained (files == native), the bucket sticky
        past its window's decay, until clear_mismatch re-opens it on
        probation; one job's seconds with the verifier at 1.0 beside one
        at 0; then, on the 1M-row tablet, 8 jobs at the default sample
        and 3 at 1.0 beside 3 at 0 (default_sample_step);
      - the mesh job (8 virtual shards of the card): a fault at the
        routing attempt's download (after M1-M3) completes natively;
      - the rate race: jobs over the 1M-row tablet through
        run_compaction_job(..., offload_policy=health_board()) under
        device_offload_mode=auto, as the reference routes and records
        them: a COLD start (native, timed), then prewarm_buckets, then
        the jobs the board routes; and a second board prewarmed first.
        Each job's route, state and both EWMAs are printed; a finding,
        not a gate.

    Every step prints a `faults:` line with the card. The board is reset
    (an operator's reset) before and after, so the phases around it see
    no parked bucket."""
    import torch
    from yugabyte_tpu_torch.ops import device_faults, run_merge
    from yugabyte_tpu_torch.parallel.mesh import make_mesh
    from yugabyte_tpu_torch.storage import compaction, integrity
    from yugabyte_tpu_torch.storage.bucket_health import (
        HEALTHY, PROBATION, QUARANTINED, health_board)
    from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
    from yugabyte_tpu_torch.storage.offload_policy import bucket_key
    from yugabyte_tpu_torch.utils import flags
    from yugabyte_tpu_torch.utils.trace import Trace

    board = health_board()
    board.reset()
    device_faults.disarm_all()
    wrappers = {**_wrappers(), **_mesh_wrappers()}
    rows = sum(r.props.n_entries for r in readers)
    cutoff = history_cutoff(rows)
    qkey = bucket_key(run_merge.packed_run_ns(
        [r.props.n_entries for r in readers]))
    out = {"bucket": list(qkey)}
    counter = [0]

    def job(tag, inputs, fn=None, **kw):
        """One job, every launch counter at 0 just before and read just
        after: (result, seconds, launches)."""
        d = os.path.join(workdir, "faults", tag)
        os.makedirs(d)
        counter[0] += 1
        ids = iter(range(counter[0] * 10_000, counter[0] * 10_000 + 9_000))
        for w in wrappers.values():
            w.launches = 0
        t0 = time.time()
        cut = history_cutoff(sum(r.props.n_entries for r in inputs))
        if fn is None:
            res = compaction.run_compaction_job_device_native(
                inputs, d, lambda: next(ids), cut, True, device=device, **kw)
        else:
            res = fn(inputs, d, lambda: next(ids), cut, True, **kw)
        sync()
        return (res, time.time() - t0,
                {k: w.launches for k, w in wrappers.items()})

    def native_of(inputs, tag):
        res, secs, _ = job(tag, inputs, fn=lambda *a, **k:
                           compaction._run_native_job(*a, False, None))
        return res, secs

    os.environ["YBTPU_DEVICE_CODEC"] = "1"
    try:
        native, t_native = native_of(readers, "native")
        out["native_s"] = t_native

        # -- injected faults at full width, codec route
        before = fault_counts()
        device_faults.arm("oom", "result", 1)
        res, secs, l = job("retried", readers)
        same_files(res, native, "oom:result:1 job vs native")
        check_launches(l, "codec")
        fault_moves(before, {"kernel_chunk_retry_total": 1}, "oom:result:1")
        if device_faults.armed_count() or board.state(
                "run_merge_fused", qkey) == QUARANTINED:
            raise AssertionError("oom:result:1: the fault did not fire, or "
                                 "the retried job was contained")
        out["retried"] = {"s": secs, "on_device": True}
        fault_line(card, "oom:result:1", out["retried"])

        board.reset()
        before = fault_counts()
        device_faults.arm("oom", "result", 2)
        with Trace("faults: contained job") as trace:
            res, secs, l = job("contained", readers)
        same_files(res, native, "oom:result:2 job vs native")
        if "quarantined; completing via the native merge" not in \
                trace.dump():
            raise AssertionError("the contained job left no TRACE")
        fault_moves(before, {"compaction_device_fallback_total": 1,
                             "offload_quarantine_added_total": 2,
                             "bucket_health_quarantines_total": 2,
                             "kernel_chunk_retry_total": 1},
                    "oom:result:2")
        n_pad0 = run_merge.bucket_size(readers[0].props.n_entries)
        states = {"run_merge_fused": board.state("run_merge_fused", qkey),
                  "block_decode": board.state("block_decode", (1, n_pad0))}
        if set(states.values()) != {QUARANTINED}:
            raise AssertionError(f"oom:result:2: buckets {states}")
        out["contained"] = {"s": secs, "states": states,
                            "attempt_launches": {k: v for k, v in l.items()
                                                 if v}}
        fault_line(card, "oom:result:2 contained", out["contained"])
        device_faults.arm("oom", "result", 5)
        before = fault_counts()
        res, secs, l = job("parked", readers)
        same_files(res, native, "parked job vs native")
        fault_moves(before, {"board_routed_native_total": 1}, "parked job")
        if _device_launches(l, _CODEC_KERNELS) or \
                device_faults.armed_count() != 5:
            raise AssertionError(f"parked job launched {l} or fired a "
                                 f"fault")
        device_faults.disarm_all()
        out["parked"] = {"s": secs, "launches": 0}
        fault_line(card, "parked bucket", out["parked"])

        # -- a real device fault: the caching allocator capped
        board.reset()
        flags.set_flag("device_fault_quarantine_s", 1.0)
        cache = DeviceSlabCache(device)
        torch.cuda.empty_cache()
        total = torch.cuda.get_device_properties(0).total_memory
        base = torch.cuda.memory_allocated()
        cap = base + comp["codec_peak_bytes"] // 2
        before = fault_counts()
        torch.cuda.set_per_process_memory_fraction(min(1.0, cap / total))
        try:
            res, secs, l = job("real_oom", readers, device_cache=cache,
                               input_ids=[0, 1, 2, 3])
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
            torch.cuda.empty_cache()
        same_files(res, native, "capped job vs native")
        # where the cap bites decides which buckets park (the merge's,
        # and the decode's when its retry ran out too): one native
        # completion in any case
        moved = fault_counts_delta(before)
        if moved.get("compaction_device_fallback_total") != 1 \
                or cache.pinned_count():
            raise AssertionError(f"capped job: counters {moved}, pins "
                                 f"{cache.pinned_count()}")
        out["real_oom"] = {"s": secs, "cap_bytes": cap - base,
                           "peak_bytes": comp["codec_peak_bytes"],
                           "moved": moved, "pins": cache.pinned_count(),
                           "attempt_launches": {k: v for k, v in l.items()
                                                if v}}
        fault_line(card, "real OutOfMemoryError contained", out["real_oom"])
        del cache
        time.sleep(1.1)
        before = fault_counts()
        res, secs, l = job("after_oom", readers)
        same_files(res, native, "job after the cap vs native")
        check_launches(l, "codec")
        fault_moves(before, {}, "job after the cap")
        out["after_oom"] = {"s": secs,
                            "state": board.state("run_merge_fused", qkey)}
        fault_line(card, "after the cap lifted", out["after_oom"])

        # -- decay and probation on the 1M-row tablet
        board.reset()
        small_dir = os.path.join(workdir, "faults", "in_small")
        os.makedirs(small_dir)
        small = write_inputs(synth_ycsb_runs(
            args.fault_rows, 4, max(1, args.fault_rows // 2), args.seed + 7),
            small_dir)
        skey = bucket_key(run_merge.packed_run_ns(
            [r.props.n_entries for r in small]))
        small_native, t_small_native = native_of(small, "native_small")
        before = fault_counts()
        device_faults.arm("runtime", "dispatch", 1)
        res, secs, l = job("decay_fault", small)
        same_files(res, small_native, "1M faulted job vs native")
        fault_moves(before, {"compaction_device_fallback_total": 1,
                             "offload_quarantine_added_total": 1,
                             "bucket_health_quarantines_total": 1},
                    "1M dispatch fault")
        seq = [(board.state("run_merge_fused", skey), secs, 0)]
        time.sleep(1.1)
        for i in range(2):
            res, secs, l = job(f"reprove{i}", small)
            same_files(res, small_native, "1M re-proving job vs native")
            seq.append((board.state("run_merge_fused", skey), secs,
                        _device_launches(l, _CODEC_KERNELS)))
        if [s for s, _t, _n in seq] != [QUARANTINED, PROBATION, HEALTHY] \
                or not all(n for _s, _t, n in seq[1:]):
            raise AssertionError(f"decay and probation: {seq}")
        out["decay"] = {"rows": sum(r.props.n_entries for r in small),
                        "bucket": list(skey), "native_s": t_small_native,
                        "jobs": [{"state": s, "s": t, "launches": n}
                                 for s, t, n in seq]}
        fault_line(card, "decay to probation to healthy", out["decay"])

        # -- the shadow verifier at full width
        board.reset()
        flags.set_flag("shadow_verify_sample", 1.0)
        before = fault_counts()
        device_faults.arm("bitflip", "survivor", 1)
        res, secs, l = job("bitflip", readers)
        same_files(res, native, "bit-flipped job vs native")
        fault_moves(before, {"compaction_device_fallback_total": 1,
                             "offload_quarantine_added_total": 1,
                             "bucket_health_quarantines_total": 1,
                             "bucket_health_mismatch_total": 1,
                             "device_shadow_mismatch_total": 1},
                    "bitflip")
        t_flip = secs
        time.sleep(1.1)   # the mismatch's timed window decays; it stays
        res, secs, l = job("sticky", readers)
        same_files(res, native, "sticky-parked job vs native")
        if _device_launches(l, _CODEC_KERNELS) or board.state(
                "run_merge_fused", qkey) != QUARANTINED:
            raise AssertionError("the shadow mismatch did not stay sticky")
        if board.clear_mismatch("run_merge_fused", qkey) != 1 or \
                board.state("run_merge_fused", qkey) != PROBATION:
            raise AssertionError("clear_mismatch did not re-open the "
                                 "bucket on probation")
        verified0 = integrity.shadow_snapshot()["jobs_verified"]
        res, t_on, l = job("verified", readers)
        same_files(res, native, "verified job vs native")
        check_launches(l, "codec")
        if integrity.shadow_snapshot()["jobs_verified"] != verified0 + 1:
            raise AssertionError("the clean job was not shadow-verified")
        flags.set_flag("shadow_verify_sample", 0.0)
        res, t_off, l = job("unverified", readers)
        same_files(res, native, "unverified job vs native")
        fault_moves(before, {"board_routed_native_total": 1,
                             "compaction_device_fallback_total": 1,
                             "offload_quarantine_added_total": 1,
                             "bucket_health_quarantines_total": 1,
                             "bucket_health_mismatch_total": 1,
                             "device_shadow_mismatch_total": 1},
                    "shadow verifier steps")
        out["shadow"] = {"bitflip_job_s": t_flip, "verifier_on_s": t_on,
                         "verifier_off_s": t_off,
                         "verifier_cost_s": t_on - t_off,
                         "snapshot": integrity.shadow_snapshot()}
        fault_line(card, "shadow verifier", out["shadow"])

        # -- the verifier at its default sample, on the 1M-row tablet
        board.reset()
        out["default_sample"] = default_sample_step(
            args, small, small_native, skey, job, board, card)

        # -- the mesh job: a fault after the routing kernels
        board.reset()
        mesh = make_mesh(8, devices=[torch.device(device)] * 8)
        before = fault_counts()
        device_faults.arm("oom", "result", 1)
        res, secs, l = job("mesh", readers, fn=compaction.run_compaction_job,
                           device=device, mesh=mesh)
        same_files(res, native, "faulted mesh job vs native")
        fault_moves(before, {"compaction_device_fallback_total": 1,
                             "offload_quarantine_added_total": 1,
                             "bucket_health_quarantines_total": 1},
                    "mesh fault")
        snap = board.snapshot()
        if [(k["family"], k["state"]) for k in snap["keys"]] != \
                [("dist_compact", QUARANTINED)] or not all(
                    l[k] for k in ("splitter_pick", "route_dest",
                                   "bucket_scatter")):
            raise AssertionError(f"mesh fault: board {snap['keys']}, "
                                 f"launches {l}")
        out["mesh"] = {"s": secs, "bucket": snap["keys"][0]["bucket"],
                       "routing_launches": {k: l[k] for k in (
                           "splitter_pick", "route_dest",
                           "bucket_scatter")}}
        fault_line(card, "mesh fault at M2/M3", out["mesh"])

        # -- the reference's rate race at the card's rates
        out["rate_race"] = {}
        routed = "board_routing:board_routed_native_total"
        for order in ("cold_first", "prewarmed_first"):
            board.reset()
            flags.set_flag("device_offload_mode", "auto")
            steps = []
            base = fault_counts()
            for i in range(8):
                if (order == "prewarmed_first" and i == 0) or \
                        (order == "cold_first" and i == 1):
                    run_merge.prewarm_buckets([(skey[0], skey[1], 4, 8)],
                                              device=device)
                res, secs, l = job(
                    f"race_{order}{i}", small,
                    fn=compaction.run_compaction_job, device=device,
                    offload_policy=board)
                same_files(res, small_native, f"rate race job {i}")
                rec = {k["family"]: k for k in board.snapshot()["keys"]}[
                    "run_merge_fused"]
                now = fault_counts()
                steps.append({
                    "job": i, "s": secs,
                    "route": ("device" if _device_launches(
                        l, _CODEC_KERNELS) else "native"),
                    "board_routed_native": now[routed] - base[routed],
                    "state": rec["state"],
                    "device_ewma": rec["device_rows_per_sec"],
                    "native_ewma": rec["native_rows_per_sec"]})
                base = now
                fault_line(card, f"rate race {order}", steps[-1])
            out["rate_race"][order] = steps
        flags.reset_flag("device_offload_mode")
    finally:
        device_faults.disarm_all()
        torch.cuda.set_per_process_memory_fraction(1.0)
        flags.set_flag("shadow_verify_sample", 0.0)
        flags.reset_flag("device_fault_quarantine_s")
        flags.reset_flag("device_offload_mode")
        board.reset()
    reset_fault_base()
    return out


def default_sample_step(args, small, small_native, skey, job, board,
                        card, n_default=8, n_pair=3):
    """The sampled shadow verifier at its default sample on the 1M-row
    tablet: after one uncounted job, n_default device jobs with
    shadow_verify_sample at its default (random seeded from --seed),
    then n_pair jobs at 1.0 and at
    0 alternated. Prints each set's seconds (mean, p50, max), the
    verified jobs' count, the cost of one verified job and the default's
    cost per job on average, and the device rate the board kept (the
    verifier's wait is left out of it). Moves no containment counter."""
    import random
    from yugabyte_tpu_torch.storage import integrity
    from yugabyte_tpu_torch.utils import flags
    flags.reset_flag("shadow_verify_sample")
    sample = float(flags.get_flag("shadow_verify_sample"))
    random.seed(args.seed)
    before = fault_counts()

    def timed(tag, n):
        secs, verified = [], []
        for i in range(n):
            v0 = integrity.shadow_snapshot()["jobs_verified"]
            res, t, l = job(f"{tag}{i}", small)
            same_files(res, small_native, f"{tag} job {i} vs native")
            if not _device_launches(l, _CODEC_KERNELS):
                raise AssertionError(f"{tag} job {i} ran no kernel")
            secs.append(t)
            verified.append(integrity.shadow_snapshot()["jobs_verified"]
                            - v0)
        return secs, verified

    flags.set_flag("shadow_verify_sample", 0.0)
    timed("warmup", 1)     # not counted: the first 1M job after 10M ones
    flags.reset_flag("shadow_verify_sample")
    d_secs, d_ver = timed("default", n_default)
    on, off = [], []
    for i in range(n_pair):
        flags.set_flag("shadow_verify_sample", 1.0)
        s_on, v_on = timed(f"on{i}_", 1)
        flags.set_flag("shadow_verify_sample", 0.0)
        s_off, v_off = timed(f"off{i}_", 1)
        if v_on != [1] or v_off != [0]:
            raise AssertionError("the verifier ran where it was not asked "
                                 "or not where it was")
        on += s_on
        off += s_off
    fault_moves(before, {}, "default sample")

    def stats(xs):
        xs = sorted(xs)
        return {"n": len(xs), "mean": float(np.mean(xs)),
                "p50": xs[len(xs) // 2], "max": xs[-1]}
    rec = {k["family"]: k for k in board.snapshot()["keys"]}[
        "run_merge_fused"]
    d_plain = [t for t, v in zip(d_secs, d_ver) if not v]
    out = {"sample": sample, "rows": sum(r.props.n_entries for r in small),
           "bucket": list(skey), "default": stats(d_secs),
           "default_verified": int(sum(d_ver)),
           "default_verified_s": [t for t, v in zip(d_secs, d_ver) if v],
           "default_unverified": stats(d_plain) if d_plain else None,
           "verifier_on": stats(on), "verifier_off": stats(off),
           "verified_job_cost_s": float(np.mean(on) - np.mean(off)),
           "default_cost_per_job_s": float(np.mean(d_secs) - np.mean(off)),
           "expected_cost_per_job_s": float(
               sample * (np.mean(on) - np.mean(off))),
           "board_device_ewma": rec["device_rows_per_sec"],
           "board_state": rec["state"]}
    fault_line(card, "shadow verifier at its default sample", out)
    return out


def fault_counts_delta(before: dict) -> dict:
    now = fault_counts()
    return {k.split(":", 1)[1]: v - before[k] for k, v in now.items()
            if v != before[k]}


def pushdown_fault_phase(slabs, top_ht, push_out, card, device="cuda"):
    """A fault in q6_agg's download: the pushdown raises
    PushdownUnsupported("fault") and the (1, n_pad) scan_agg bucket is
    parked; the query is answered by the host path (LineitemOracle, the
    host evaluation the caller falls back to, computed once), equal to
    the healthy device answer; the next call refuses before any launch.
    Seconds are the device attempt to its refusal."""
    from yugabyte_tpu_torch.docdb.scan_spec import PushdownUnsupported
    from yugabyte_tpu_torch.ops import device_faults, scan
    from yugabyte_tpu_torch.storage.bucket_health import (QUARANTINED,
                                                          health_board)
    board = health_board()
    board.reset()
    mode, spec = pushdown_queries(lineitem_schema())["q6_agg"]
    wrappers = {**_wrappers(), **_pushdown_wrappers()}
    srcs = [scan.SlabSource(s, sorted_source=True) for s in slabs]
    t0 = time.time()
    host = LineitemOracle(slabs, top_ht).aggregate(spec, lineitem_schema())
    host_j = {"rows": host["rows"], "cols": {
        str(c): st for c, st in host["cols"].items()}}
    out = {"host_s": time.time() - t0}
    if host_j != push_out["q6_agg"]["answer"]:
        raise AssertionError("q6_agg: the host path's answer differs from "
                             "the healthy device answer")
    before = fault_counts()
    try:
        for attempt, spec_arm, reason in (
                ("fault", ("runtime", "result", 1), "fault"),
                ("parked", ("runtime", "dispatch", 3), "quarantined")):
            device_faults.arm(*spec_arm)
            for w in wrappers.values():
                w.launches = 0
            t0 = time.time()
            try:
                scan.aggregate_sources(srcs, top_ht, spec, device=device)
            except PushdownUnsupported as e:
                got_reason = e.reason
            else:
                raise AssertionError(f"q6_agg {attempt}: no refusal")
            # the caller's host path answers: host_j, equal to the
            # healthy device answer (checked above)
            secs = time.time() - t0
            launched = {k: w.launches for k, w in wrappers.items()
                        if w.launches}
            if got_reason != reason:
                raise AssertionError(f"q6_agg {attempt}: refused "
                                     f"{got_reason}, not {reason}")
            if attempt == "parked" and (launched or
                                        device_faults.armed_count() != 3):
                raise AssertionError(f"parked q6_agg launched {launched}")
            device_faults.disarm_all()
            out[attempt] = {"reason": got_reason, "s": secs,
                            "launches": launched}
        states = [k["state"] for k in board.snapshot()["keys"]
                  if k["family"] == "scan_agg"]
        if states != [QUARANTINED]:
            raise AssertionError(f"q6_agg fault: board {states}")
        fault_moves(before, {"board_routed_native_total": 1,
                             "offload_quarantine_added_total": 1,
                             "bucket_health_quarantines_total": 1},
                    "q6_agg fault")
    finally:
        device_faults.disarm_all()
        board.reset()
    reset_fault_base()
    fault_line(card, "q6_agg fault", out)
    return out


def point_fault_phase(db, keys, read_ht, card):
    """A fault at P3's result site on the YCSB point DB: the batch is
    answered by _multi_get_native (equal), the (1, n_pad) bucket of the
    first live file is parked, and the next call launches no P1-P3."""
    from yugabyte_tpu_torch.ops import device_faults
    from yugabyte_tpu_torch.storage.bucket_health import (QUARANTINED,
                                                          health_board)
    board = health_board()
    board.reset()
    wrappers = _point_wrappers()
    want = db._multi_get_native(keys, read_ht)
    before = fault_counts()
    out = {}
    try:
        for attempt, spec_arm in (("fault", ("oom", "result", 1)),
                                  ("parked", ("oom", "dispatch", 3))):
            device_faults.arm(*spec_arm)
            for w in wrappers.values():
                w.launches = 0
            t0 = time.time()
            got = db.multi_get(keys, read_ht)
            secs = time.time() - t0
            launched = {k: w.launches for k, w in wrappers.items()
                        if w.launches}
            if got != want:
                raise AssertionError(f"point read {attempt}: answers differ "
                                     f"from _multi_get_native")
            if attempt == "parked" and (launched or
                                        device_faults.armed_count() != 3):
                raise AssertionError(f"parked point read launched "
                                     f"{launched}")
            device_faults.disarm_all()
            out[attempt] = {"keys": len(keys), "s": secs,
                            "launches": launched}
        keys_q = [(k["family"], k["bucket"]) for k in
                  board.snapshot()["keys"] if k["state"] == QUARANTINED]
        if len(keys_q) != 1 or keys_q[0][0] != "point_read_locate":
            raise AssertionError(f"point-read fault: parked {keys_q}")
        out["bucket"] = keys_q[0][1]
        fault_moves(before, {"board_routed_native_total": 1,
                             "offload_quarantine_added_total": 1,
                             "bucket_health_quarantines_total": 1,
                             "point_read_device_fallback_total": 1},
                    "point-read fault")
    finally:
        device_faults.disarm_all()
        board.reset()
    reset_fault_base()
    fault_line(card, "point-read fault", out)
    return out


# ---------------------------------------------------------------------------
# The DB's own entry points

def _db_ycsb_runs(n_runs, rows_per_run, key_space, span, seed, gen0=0):
    """YCSB-A packed runs (ycsb_packed_run) over key_space: run g's rows
    at hybrid times span * (gen0 + g + 1) + a permutation of its rows (no
    internal key repeats across runs)."""
    rng = np.random.default_rng(seed)
    runs = []
    for g in range(n_runs):
        ids = rng.integers(0, key_space, size=rows_per_run)
        is_tomb = rng.random(rows_per_run) < 0.05
        ht = ((span * (gen0 + g + 1) + rng.permutation(rows_per_run))
              .astype(np.uint64) << np.uint64(12))
        runs.append(ycsb_packed_run(ids, is_tomb, ht, rng))
    return runs


def _db_columns(run):
    """A packed run as write_batch_columns' arguments (keys, ht, wid,
    values), split once for every DB that takes it."""
    return (_split(run[0], run[1]), run[2], run[3], _split(run[4], run[5]))


def _db_flush(db, cols, op):
    """One run's columns written through the memtable and flushed."""
    db.write_batch_columns(*cols, op_id=(1, op))
    if db.flush() is None:
        raise AssertionError("a flush wrote no file")


def _file_sha(path) -> str:
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def same_db_files(dev, nat, what) -> dict:
    """The live files of a device DB and its "native" twin: equal ids and
    data files byte for byte; base files byte for byte where the device
    job fitted no learned index (the native job cannot), else equal
    props. Returns {files, with_lindex}."""
    from yugabyte_tpu_torch.storage.sst import data_file_name
    a = sorted(dev.versions.live_files(), key=lambda f: f.file_id)
    b = sorted(nat.versions.live_files(), key=lambda f: f.file_id)
    if [f.file_id for f in a] != [f.file_id for f in b] or not a:
        raise AssertionError(f"{what}: live files {[f.file_id for f in a]}"
                             f" != {[f.file_id for f in b]}")
    lidx = 0
    for fa, fb in zip(a, b):
        if _file_sha(data_file_name(fa.path)) != \
                _file_sha(data_file_name(fb.path)):
            raise AssertionError(f"{what}: data file {fa.file_id} differs")
        pa, pb = fa.props, fb.props
        if pa.lindex is not None:
            lidx += 1
            if (pa.n_entries, pa.first_key, pa.last_key, pa.data_size,
                    pa.frontier) != (pb.n_entries, pb.first_key,
                                     pb.last_key, pb.data_size,
                                     pb.frontier):
                raise AssertionError(f"{what}: file {fa.file_id}'s props "
                                     f"differ")
        elif _file_sha(fa.path) != _file_sha(fb.path):
            raise AssertionError(f"{what}: base file {fa.file_id} differs")
    return {"files": len(a), "with_lindex": lidx}


def check_resident(db, what, min_level=1) -> list:
    """Every live file resident at min_level or deeper, its entry's n that
    of the file; no pin left. Returns the levels."""
    levels = []
    for fm in db.versions.live_files():
        st = db._device_cache.get(fm.file_id)
        lv = db._device_cache.level_of(fm.file_id)
        if st is None or st.n != fm.props.n_entries or lv < min_level:
            raise AssertionError(f"{what}: file {fm.file_id} is not "
                                 f"resident at level >= {min_level}")
        levels.append(lv)
    if db._device_cache.pinned_count():
        raise AssertionError(f"{what}: pins left")
    return sorted(levels)


def _launches_of(wrappers):
    return {k: w.launches for k, w in wrappers.items()}


def _zero(wrappers):
    for w in wrappers.values():
        w.launches = 0


def _need(launches, need, absent, what):
    for k in need:
        if launches[k] <= 0:
            raise AssertionError(f"{what}: kernel {k} was not launched")
    for k in absent:
        if launches[k]:
            raise AssertionError(f"{what}: kernel {k} launched "
                                 f"{launches[k]} times")


def _scan_digest(entries):
    """(entries, key + value bytes, sha256) of a (key, value, ...)
    stream, walked once: each entry's two lengths, then its key and
    value, enter the hash."""
    import hashlib
    import struct
    lens = struct.Struct("<II").pack
    h = hashlib.sha256()
    n = nbytes = 0
    for e in entries:
        k, v = e[0], e[1]
        h.update(lens(len(k), len(v)))
        h.update(k)
        h.update(v)
        n += 1
        nbytes += len(k) + len(v)
    return n, nbytes, h.hexdigest()


def _native_visible(db, read_ht, lower=b"", upper=None):
    for b in db.scan_native(lower, upper, read_ht, visible=True).batches():
        keys, vals, ko, vo = b.keys, b.vals, b.key_offs, b.val_offs
        for i in range(b.n):
            yield (keys[ko[i]:ko[i + 1]].tobytes(),
                   vals[vo[i]:vo[i + 1]].tobytes())


def _hold_point(name):
    """Arm sync point `name` to park the thread that hits it until
    released: returns (held event, release event)."""
    import threading
    from yugabyte_tpu_torch.utils import sync_point
    held, go = threading.Event(), threading.Event()

    def hold():
        held.set()
        if not go.wait(300):
            raise AssertionError(f"{name} was never released")
    sync_point.arm(name, hold)
    return held, go


def db_phase(args, workdir, card, push_out, top_ht, device="cuda"):
    """The DB's own entry points on the card, beside a "native" DB (no
    device path) that takes the same writes in the same call:

      - scheduled compaction: a DB with DBOptions(device, DeviceSlabCache,
        auto_compact) bulk-loads 4 L0 runs of rows/4 (ingest_packed); the
        universal pick fires on the 4th and runs the codec route (C on
        the cache misses, A, B, D, E, F, H, P4), outputs installed at L1;
        the files == the native DB's. Then 4 flushes of rows/100
        (write_batch_columns) and compact_all take the resident chain
        (every input a cache hit: no C; outputs one level above their
        deepest input), == native;
      - scans: scan_visible unbounded and over a range (G, H, I.1, B; I.2
        once on the range) == the native DB's scan_native(visible=True),
        entry for entry (one sha256 over each ordered stream; the
        unbounded stream's first 2^20 entries: the device resolves the
        whole DB, the host drain is what a page cuts); q6_agg and
        filter_rows through scan_aggregate / scan_filtered on the lineitem
        SSTs opened as a DB == the pushdown phase's answers, first call
        (staging the value words) and resident call;
      - cancellation and pacing: close() while the DB's scheduled
        compaction of --fault-rows rows is parked at its first output
        file (the
        compaction:output_written sync point) on its compaction thread:
        nothing installed, no partial file, zero pins, no L1 entry;
        cancel_background_work on a --fault-rows DB the same way leaves
        it readable and healthy, retry_background_work re-arms it, and
        its compaction under compaction_rate_bytes_per_sec takes at least
        (paced bytes - burst) / rate;
      - checkpoint: the DB's checkpoint reopened as a DB on the card
        answers the range scan and a multi_get as the original (P1 + P2
        and P3 a chunk in both);
      - DBOptions.mesh: 4 bulk loads of distributed_compaction_min_rows/4
        + 4096 rows; the pick on the 4th runs the dist-native job on 8
        virtual shards (M1, M2, M3, G, I.1, B; the outputs installed from
        the shards: H, D, E), == native;
      - the pool: 8 tablet DBs with DBOptions.mesh_pool =
        CompactionPool(8 virtual shards of the card), --wave-rows rows a
        tablet in 4 flushes; the pool's loop is held (the
        compaction_pool:take_round sync point) until all 8 scheduled jobs
        queue: one wave (A, B a slot), files == each native twin's.

    Every launch counter is set to 0 just before each part and read just
    after. Returns (summary, {part: launches})."""
    import threading
    import torch
    from yugabyte_tpu_torch.parallel.mesh import make_mesh
    from yugabyte_tpu_torch.storage import compaction
    from yugabyte_tpu_torch.storage.db import DB, DBOptions
    from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
    from yugabyte_tpu_torch.tserver.compaction_pool import CompactionPool
    from yugabyte_tpu_torch.utils import flags, sync_point
    from yugabyte_tpu_torch.utils.threadpool import PriorityThreadPool

    wrappers = {**_mesh_wrappers(), **_pushdown_wrappers(),
                **_point_wrappers()}
    launches, out = {}, {"card": card}
    t_phase = time.time()
    n = args.rows
    key_space = max(1, n // 2)
    span = max(1_000_000, n // 4)
    cutoff = (span * 10) << 12          # above every write of the phase
    d = os.path.join(workdir, "db_phase")
    os.makedirs(d)

    def opts(dev, **kw):
        """Options of a phase DB: a history cutoff above every write, a
        memtable only explicit flushes cut, and on the card a 16 GiB
        device cache unless one is given."""
        if dev != "native" and kw.get("device_cache") is None:
            kw["device_cache"] = DeviceSlabCache(dev, capacity_bytes=16 << 30)
        return DBOptions(device=dev, retention_policy=lambda: cutoff,
                         memstore_size_bytes=1 << 40, **kw)

    # -- scheduled compaction: 4 bulk-loaded L0 runs, the pick on the 4th
    t0 = time.time()
    runs = _db_ycsb_runs(4, n // 4, key_space, span, args.seed + 80)
    out["generate_s"] = time.time() - t0
    dev = DB(os.path.join(d, "dev"), opts(device))
    nat = DB(os.path.join(d, "nat"), opts("native"))
    ingest_s = {}
    for tag, db in (("native", nat), ("device", dev)):
        _zero(wrappers)
        secs = []
        for g, run in enumerate(runs):
            t0 = time.time()
            db.ingest_packed(*run, op_id=(1, g + 1))
            sync()
            secs.append(time.time() - t0)
        ingest_s[tag] = secs
        if db.compaction_stats.to_dict()["compactions"] != 1:
            raise AssertionError(f"{tag} DB: the 4th ingest did not "
                                 f"compact")
    launches["db_sched"] = _launches_of(wrappers)
    _need(launches["db_sched"], _CODEC_KERNELS + ("index_fit",), (),
          "db scheduled compaction")
    out["sched"] = {
        "rows": n, **same_db_files(dev, nat, "db scheduled compaction"),
        "levels": check_resident(dev, "db scheduled compaction"),
        "ingest_s": ingest_s,
        # the 4th ingest's seconds beyond the mean of the first three:
        # the compaction it scheduled
        "compaction_s": {k: v[3] - sum(v[:3]) / 3
                         for k, v in ingest_s.items()}}
    out["sched"]["rows_per_s"] = {k: n / v for k, v in
                                  out["sched"]["compaction_s"].items()}
    rates = out["sched"]["rows_per_s"]
    log(f"db scheduled compaction: {n} rows in 4 ingests, the universal "
        f"pick on the 4th (codec route): {rates['device']:,.0f}"
        f" rows/s on the card vs {rates['native']:,.0f}"
        f" native (the 4th ingest's seconds beyond the mean of the first "
        f"three); files == native ({out['sched']['files']} files, "
        f"{out['sched']['with_lindex']} with a learned index); levels "
        f"{out['sched']['levels']}; launches "
        f"{ {k: v for k, v in launches['db_sched'].items() if v} } [{card}]")

    # -- the resident chain: 4 flushes, then compact_all
    small = [_db_columns(r) for r in _db_ycsb_runs(
        4, max(1, n // 100), key_space, span, args.seed + 81, gen0=4)]
    chain_s = {}
    for tag, db in (("native", nat), ("device", dev)):
        _zero(wrappers)
        t0 = time.time()
        for g, cols in enumerate(small):
            _db_flush(db, cols, 5 + g)
        t1 = time.time()
        db.compact_all()
        sync()
        chain_s[tag] = {"flushes_s": t1 - t0, "compact_all_s":
                        time.time() - t1}
    launches["db_chain"] = _launches_of(wrappers)
    _need(launches["db_chain"], ("merge_path_level", "gc_pack",
                                 "survivor_scan", "span_gather",
                                 "block_encode", "staged_concat",
                                 "index_fit"), ("block_decode",),
          "db resident chain")
    stats = dev.compaction_stats.to_dict()
    chain_rows = stats["compaction_rows_in"] - n
    out["chain"] = {
        **same_db_files(dev, nat, "db resident chain"),
        "levels": check_resident(dev, "db resident chain", 2),
        "compactions": stats["compactions"], "seconds": chain_s,
        "write_amplification": stats["write_amplification"],
        "rows_compacted": chain_rows}
    out["chain"]["rows_per_s"] = {
        k: chain_rows / (v["flushes_s"] + v["compact_all_s"])
        for k, v in chain_s.items()}
    log(f"db resident chain: 4 flushes of {n // 100} rows + compact_all "
        f"({stats['compactions'] - 1} compactions, {chain_rows} rows in, "
        f"every input a cache hit: no block_decode) "
        f"{out['chain']['rows_per_s']['device']:,.0f} rows/s on the card "
        f"vs {out['chain']['rows_per_s']['native']:,.0f} native (flushes "
        f"included); files == native; levels {out['chain']['levels']}; "
        f"launches "
        f"{ {k: v for k, v in launches['db_chain'].items() if v} } [{card}]")
    del small

    # -- scans: unbounded (its first page) and a range (a tenth of the
    # keys), each == the native scan
    lower = b"Suser%08d" % (key_space // 5)
    upper = b"Suser%08d" % (3 * key_space // 10)
    page = 1 << 20
    out["scans"] = {}
    for tag, lo, hi, path in (("scan", None, None, "scan"),
                              ("range_scan", lower, upper, "range_scan")):
        limit = page if path == "scan" else None
        _zero(wrappers)
        t0 = time.time()
        stream = dev.scan_visible(cutoff, lo, hi)
        got = _scan_digest(itertools.islice(stream, limit))
        stream.close()      # a page ends the stream: unpin
        secs = time.time() - t0
        launches[f"db_{tag}"] = _launches_of(wrappers)
        # G, I.1, B; H concatenates the files (one file: no H); I.2 once
        # on the range, never on the unbounded scan
        _need(launches[f"db_{tag}"], ("radix_sort", "sorted_payload",
                                      "gc_pack")
              + (("staged_concat",) if dev.n_live_files > 1 else ()),
              ("block_decode",), f"db {tag}")
        if launches[f"db_{tag}"]["bound_pack"] != (path == "range_scan"):
            raise AssertionError(f"db {tag}: launches "
                                 f"{launches[f'db_{tag}']}")
        t0 = time.time()
        want = _scan_digest(itertools.islice(
            _native_visible(nat, cutoff, lo or b"", hi), limit))
        nsecs = time.time() - t0
        if got != want or not got[0]:
            raise AssertionError(f"db {tag}: {got} != native {want}")
        if dev._pins:
            raise AssertionError(f"db {tag}: pins left {dev._pins}")
        out["scans"][tag] = {"entries": got[0], "bytes": got[1],
                             "seconds": secs, "native_seconds": nsecs,
                             "rows_per_s": got[0] / secs,
                             "native_rows_per_s": got[0] / nsecs}
        log(f"db {tag}: {got[0]} entries == the native DB's "
            f"scan_native(visible=True) (sha256 of the stream); "
            f"{got[0] / secs:,.0f} rows/s ({got[1] / secs / 1e6:,.1f} MB/s)"
            f" on the card vs {got[0] / nsecs:,.0f} native; launches "
            f"{ {k: v for k, v in launches[f'db_{tag}'].items() if v} } "
            f"[{card}]")

    # -- checkpoint: reopened on the card, it answers as the original
    ck = os.path.join(d, "checkpoint")
    _zero(wrappers)
    dev.checkpoint(ck)
    ckdb = DB(ck, opts(device, auto_compact=False))
    rng = np.random.default_rng(args.seed + 82)
    keys = [bytes(k) for k in ycsb_keys(rng.integers(0, key_space,
                                                     size=4096))]
    want = dev.multi_get(keys)
    if ckdb.multi_get(keys) != want or _scan_digest(ckdb.scan_visible(
            cutoff, lower, upper))[2] != _scan_digest(
                dev.scan_visible(cutoff, lower, upper))[2]:
        raise AssertionError("db checkpoint: the reopened DB answers "
                             "otherwise")
    out["checkpoint"] = {"files": ckdb.n_live_files, "keys": len(keys)}
    # both DBs' multi_get (P1 + P2, P3 + the fold a chunk) and range scans
    launches["db_checkpoint"] = _launches_of(wrappers)
    _need(launches["db_checkpoint"], ("hash_probe_files", "locate_fold",
                                      "radix_sort", "bound_pack"), (),
          "db checkpoint")
    ckdb.close()
    log(f"db checkpoint: reopened on the card ({out['checkpoint']['files']}"
        f" files), 4096 multi_get keys and the range scan == the original")
    dev.close()
    nat.close()
    torch.cuda.empty_cache()

    # -- the pushdown on the lineitem SSTs opened as a DB
    queries = pushdown_queries(lineitem_schema())
    ldb = lineitem_point_db(os.path.join(workdir, "lineitem"), workdir,
                            device, name="lineitem_db_phase")
    out["pushdown"] = {}
    for qname in ("q6_agg", "filter_rows"):
        mode, spec = queries[qname]
        ref = push_out[qname]
        rec = {}
        for call in ("first", "resident"):
            _zero(wrappers)
            t0 = time.time()
            if mode == "aggregate":
                got = ldb.scan_aggregate(top_ht, spec)
                sync()
                ok = {"rows": got["rows"], "cols": {
                    str(c): st for c, st in got["cols"].items()}} \
                    == ref["answer"]
            else:
                got = list(ldb.scan_filtered(top_ht, spec))
                ok = (len(got) == ref["entries_out"]
                      and entries_sha256(got) == ref["entries_sha256"])
            rec[f"{call}_s"] = time.time() - t0
            if not ok:
                raise AssertionError(f"db {qname} ({call} call): the DB's "
                                     f"answer differs from the pushdown "
                                     f"phase's")
            if ldb._pins:
                raise AssertionError(f"db {qname}: pins left")
            launches[f"db_{qname}_{call}"] = _launches_of(wrappers)
            check_pushdown_launches(launches[f"db_{qname}_{call}"], mode,
                                    False, f"db {qname}")
        rec["rows_per_s"] = ref["visible_rows"] / rec["resident_s"]
        rec["slab_source_rows_per_s"] = ref["rows_per_s"]
        out["pushdown"][qname] = rec
        log(f"db {qname}: == the pushdown phase's answer; first call "
            f"{rec['first_s']:.3f}s (stages the value words), resident "
            f"{rec['resident_s']:.3f}s = {rec['rows_per_s']:,.0f} rows/s vs "
            f"{ref['rows_per_s']:,.0f} over SlabSources [{card}]")
    ldb.close()
    torch.cuda.empty_cache()

    # -- close() during a scheduled compaction of --fault-rows rows (the
    # same runs serve cancel_background_work and the paced job below)
    del runs
    m = args.fault_rows
    runs = _db_ycsb_runs(4, max(1, m // 4), max(1, m // 2),
                         max(1_000_000, m // 4), args.seed + 83)
    threads = PriorityThreadPool(1, name="db-phase-compactions")
    try:
        cache = DeviceSlabCache(device, capacity_bytes=16 << 30)
        cdb = DB(os.path.join(d, "close"), opts(
            device, device_cache=cache, compaction_pool=threads))
        for g, run in enumerate(runs[:3]):
            cdb.ingest_packed(*run, op_id=(1, g + 1))
        held, go = _hold_point("compaction:output_written")
        try:
            cdb.ingest_packed(*runs[3], op_id=(1, 4))
            in_ids = sorted(cdb.versions.files)
            if not held.wait(600):
                raise AssertionError("the scheduled compaction never "
                                     "wrote its first file")
        finally:
            sync_point.disarm("compaction:output_written")
        t0 = time.time()
        cdb.close()
        go.set()
        threads.wait_idle()
        abort_s = time.time() - t0
        names = sorted(f for f in os.listdir(cdb.db_dir)
                       if f.endswith(".sst") or f.endswith(".sblock.0"))
        want_names = sorted([f"{f:06d}.sst" for f in in_ids]
                            + [f"{f:06d}.sst.sblock.0" for f in in_ids])
        reopened = DB(cdb.db_dir, opts("native", auto_compact=False))
        live = sorted(reopened.versions.files)
        reopened.close()
        if names != want_names or live != in_ids or cache.pinned_count() \
                or cache.snapshot()["entries"]:
            raise AssertionError(
                f"db close mid-compaction: files {names}, live {live}, "
                f"pins {cache.pinned_count()}, entries "
                f"{cache.snapshot()['entries']}")
        out["close_cancel"] = {"rows": m, "abort_s": abort_s,
                               "inputs": len(in_ids)}
        log(f"db close() during the scheduled {m}-row compaction (parked "
            f"at its first output file): aborted {abort_s:.3f}s after the "
            f"close; nothing installed, no partial file, zero pins")
        torch.cuda.empty_cache()

        # -- cancel_background_work, then the paced compaction
        cache = DeviceSlabCache(device, capacity_bytes=16 << 30)
        bdb = DB(os.path.join(d, "cancel"), opts(
            device, device_cache=cache, compaction_pool=threads))
        for g, run in enumerate(runs[:3]):
            bdb.ingest_packed(*run, op_id=(1, g + 1))
        held, go = _hold_point("compaction:output_written")
        try:
            bdb.ingest_packed(*runs[3], op_id=(1, 4))
            if not held.wait(600):
                raise AssertionError("the scheduled compaction never "
                                     "wrote its first file")
        finally:
            sync_point.disarm("compaction:output_written")
        in_ids = sorted(bdb.versions.files)
        keys = [bytes(k) for k in ycsb_keys(np.random.default_rng(
            args.seed + 84).integers(0, max(1, m // 2), size=4096))]
        before = bdb.multi_get(keys)
        visible = _scan_digest(bdb.scan_visible(cutoff))
        bdb.cancel_background_work("tablet failed")
        go.set()
        threads.wait_idle()
        if (bdb.background_error is not None
                or sorted(bdb.versions.files) != in_ids
                or bdb.multi_get(keys) != before or cache.pinned_count()):
            raise AssertionError("db cancel_background_work: the DB is not "
                                 "as it was")
        if not bdb.retry_background_work() or bdb._cancel.cancelled:
            raise AssertionError("db retry_background_work did not re-arm")
        in_bytes = sum(fm.total_size for fm in bdb.versions.live_files())
        rate = max(1, int(in_bytes / 2.0))
        flags.set_flag("compaction_rate_bytes_per_sec", rate)
        max_out = flags.get_flag("compaction_max_output_entries_per_sst")
        flags.set_flag("compaction_max_output_entries_per_sst",
                       max(1, m // 10))
        try:
            lim = compaction.compaction_rate_limiter()
            through = lim.total_through
            t0 = time.time()
            if not bdb.maybe_schedule_compaction():
                raise AssertionError("nothing was due after the retry")
            threads.wait_idle()
            paced_s = time.time() - t0
            paced = lim.total_through - through
        finally:
            flags.reset_flag("compaction_rate_bytes_per_sec")
            flags.set_flag("compaction_max_output_entries_per_sst", max_out)
        # the major compaction keeps every visible entry
        if _scan_digest(bdb.scan_visible(cutoff)) != visible:
            raise AssertionError("db paced job: the visible entries "
                                 "changed")
        floor = (paced - lim.capacity) / rate
        if bdb.compaction_stats.to_dict()["compactions"] != 1 \
                or paced <= 0 or paced_s < floor:
            raise AssertionError(f"db paced job: {paced} bytes paced in "
                                 f"{paced_s:.3f}s, floor {floor:.3f}s")
        out["cancel_and_pace"] = {
            "rows": m, "rate_bytes_per_s": rate, "paced_bytes": paced,
            "seconds": paced_s, "floor_s": floor,
            "files": bdb.n_live_files}
        log(f"db cancel_background_work mid-compaction: DB healthy, "
            f"{len(keys)} reads unchanged, retry re-armed; the {m}-row job "
            f"(visible entries unchanged) under "
            f"{rate:,} bytes/s paced {paced:,} bytes in {paced_s:.3f}s "
            f"(floor {floor:.3f}s) [{card}]")
        bdb.close()
        del runs
    finally:
        go.set()
        threads.shutdown()
    torch.cuda.empty_cache()

    # -- DBOptions.mesh: a mesh-sized scheduled compaction (dist-native)
    mesh = make_mesh(8, devices=[device] * 8)
    per = flags.get_flag("distributed_compaction_min_rows") // 4 + 4096
    mruns = _db_ycsb_runs(4, per, max(1, 2 * per), max(1_000_000, per),
                          args.seed + 85)
    mdb = DB(os.path.join(d, "mesh"), opts(device, mesh=mesh))
    mnat = DB(os.path.join(d, "meshn"), opts("native"))
    mesh_s = {}
    for tag, db in (("native", mnat), ("device", mdb)):
        _zero(wrappers)
        secs = []
        for g, run in enumerate(mruns):
            t0 = time.time()
            db.ingest_packed(*run, op_id=(1, g + 1))
            sync()
            secs.append(time.time() - t0)
        mesh_s[tag] = secs[3] - sum(secs[:3]) / 3
    launches["db_mesh"] = _launches_of(wrappers)
    # M1 once an attempt, M2 and M3 a shard an attempt, G, I.1, B a
    # shard; the installer's H, D, E
    _need(launches["db_mesh"], ("splitter_pick", "route_dest",
                                "bucket_scatter", "radix_sort",
                                "sorted_payload", "gc_pack", "survivor_scan",
                                "span_gather"), ("merge_path_level",),
          "db mesh compaction")
    if launches["db_mesh"]["radix_sort"] != 8:
        raise AssertionError(f"db mesh compaction: launches "
                             f"{launches['db_mesh']}")
    rows = 4 * per
    out["mesh"] = {"rows": rows, **same_db_files(mdb, mnat,
                                                 "db mesh compaction"),
                   "levels": check_resident(mdb, "db mesh compaction"),
                   "compaction_s": mesh_s,
                   "rows_per_s": {k: rows / v for k, v in mesh_s.items()}}
    log(f"db mesh compaction (DBOptions.mesh, 8 virtual shards): {rows} "
        f"rows, the 4th ingest's pick on the dist-native job: "
        f"{rows / mesh_s['device']:,.0f} rows/s on the card vs "
        f"{rows / mesh_s['native']:,.0f} native; files == native; levels "
        f"{out['mesh']['levels']}; launches "
        f"{ {k: v for k, v in launches['db_mesh'].items() if v} } [{card}]")
    mdb.close()
    mnat.close()
    del mruns, mesh
    torch.cuda.empty_cache()

    # -- 8 tablet DBs behind one CompactionPool
    release = threading.Event()
    sync_point.arm("compaction_pool:take_round", lambda: release.wait(600))
    pool = CompactionPool(make_mesh(8, devices=[device] * 8))
    threads = PriorityThreadPool(8, name="db-phase-tablets")
    shared = DeviceSlabCache(device, capacity_bytes=16 << 30)
    pairs = []
    try:
        snap0 = pool.snapshot()
        wr = args.wave_rows
        native_s = 0.0
        for t in range(8):
            pdb = DB(os.path.join(d, f"tab{t}"), opts(
                device, mesh_pool=pool, compaction_pool=threads,
                device_cache=pool.partition_for(shared, f"tab{t}",
                                                f"tab{t}")))
            ndb = DB(os.path.join(d, f"tabn{t}"), opts("native"))
            pairs.append((pdb, ndb))
        _zero(wrappers)
        for t, (pdb, ndb) in enumerate(pairs):
            truns = _db_ycsb_runs(4, max(1, wr // 4), max(1, wr // 2),
                                  1_000_000, args.seed + 90 + t)
            secs = []
            for g, run in enumerate(truns):
                cols = _db_columns(run)
                _db_flush(pdb, cols, g + 1)
                t0 = time.time()
                _db_flush(ndb, cols, g + 1)
                secs.append(time.time() - t0)
            native_s += secs[3] - sum(secs[:3]) / 3
        for _ in range(6000):
            if pool.snapshot()["queue_depth"] == 8:
                break
            time.sleep(0.01)
        t0 = time.time()
        release.set()
        threads.wait_idle()
        pool_s = time.time() - t0
        launches["db_pool"] = _launches_of(wrappers)
        snap = pool.snapshot()
        waves = (snap["waves"] - snap0["waves"],
                 snap["wave_jobs"] - snap0["wave_jobs"])
        if waves != (1, 8) or launches["db_pool"]["gc_pack"] != 8:
            raise AssertionError(f"db pool: waves {waves}, launches "
                                 f"{launches['db_pool']}")
        for t, (pdb, ndb) in enumerate(pairs):
            if pdb.compaction_stats.to_dict()["compactions"] != 1:
                raise AssertionError(f"db pool: tablet {t} did not compact")
            same_db_files(pdb, ndb, f"db pool tablet {t}")
        if shared.pinned_count():
            raise AssertionError("db pool: pins left")
        rows = 8 * 4 * max(1, wr // 4)
        out["pool"] = {"tablets": 8, "rows": rows, "seconds": pool_s,
                       "native_seconds": native_s,
                       "rows_per_s": rows / pool_s,
                       "native_rows_per_s": rows / native_s}
        log(f"db pool: 8 tablet DBs' scheduled compactions in one wave "
            f"({rows} rows) {rows / pool_s:,.0f} rows/s from the loop's "
            f"release to the last install vs {rows / native_s:,.0f} for the "
            f"native DBs' own compactions; files == native; launches "
            f"{ {k: v for k, v in launches['db_pool'].items() if v} } "
            f"[{card}]")
    finally:
        release.set()
        sync_point.disarm("compaction_pool:take_round")
        for pair in pairs:
            for db in pair:
                db.close()
        threads.shutdown()
        pool.shutdown()
    torch.cuda.empty_cache()
    out["seconds"] = time.time() - t_phase
    log(f"db phase: {out['seconds']:.1f}s [{card}]")
    return out, launches


# ------------------------------------------------------------------ tablet
def _row(r):
    """A tablet row as a comparable tuple (None: the row is absent)."""
    return None if r is None else (r.doc_key.encode(),
                                   sorted(r.columns.items()),
                                   r.write_ht.value)


def same_dir_bytes(a, b, what) -> int:
    """Every SST file and the MANIFEST of two DB directories byte for
    byte (two hard links of one file are one file: not read). Returns the
    number of files."""
    def names(d):
        return sorted(f for f in os.listdir(d)
                      if ".sst" in f or f == "MANIFEST")
    if names(a) != names(b) or not names(a):
        raise AssertionError(f"{what}: files {names(a)} != {names(b)}")
    for f in names(a):
        fa, fb = os.path.join(a, f), os.path.join(b, f)
        if not os.path.samefile(fa, fb) and _file_sha(fa) != _file_sha(fb):
            raise AssertionError(f"{what}: {f} differs")
    return len(names(a))


def same_live_bytes(a, b, what) -> int:
    """Two DBs' live files: the same ids, each data file and base file
    byte for byte. Returns the number of files."""
    from yugabyte_tpu_torch.storage.sst import data_file_name
    fa = sorted(a.versions.live_files(), key=lambda f: f.file_id)
    fb = sorted(b.versions.live_files(), key=lambda f: f.file_id)
    if [f.file_id for f in fa] != [f.file_id for f in fb] or not fa:
        raise AssertionError(f"{what}: live files {[f.file_id for f in fa]}"
                             f" != {[f.file_id for f in fb]}")
    for x, y in zip(fa, fb):
        for pa, pb in ((x.path, y.path),
                       (data_file_name(x.path), data_file_name(y.path))):
            if _file_sha(pa) != _file_sha(pb):
                raise AssertionError(f"{what}: {os.path.basename(pa)} "
                                     f"differs")
    return len(fa)


def same_manifest(dev, nat, what) -> int:
    """Two DBs' MANIFESTs edit for edit: equal but for the props of a file
    the card's job fitted a learned index into (its `lindex` and
    `base_size`; the native job fits none). Returns the edits."""
    def edits(db):
        with open(db.versions.manifest_path, "rb") as f:
            return [json.loads(x) for x in f.read().splitlines() if x.strip()]
    a, b = edits(dev), edits(nat)
    if len(a) != len(b):
        raise AssertionError(f"{what}: {len(a)} MANIFEST edits != "
                             f"{len(b)}")
    for ea, eb in zip(a, b):
        pa, pb = ea.get("props"), eb.get("props")
        if pa is not None and pb is not None and "lindex" in pa \
                and "lindex" not in pb:
            ea = {**ea, "props": {k: v for k, v in pa.items()
                                  if k not in ("lindex", "base_size")}}
            eb = {**eb, "props": {k: v for k, v in pb.items()
                                  if k != "base_size"}}
        if ea != eb:
            raise AssertionError(f"{what}: MANIFEST edit {ea} != {eb}")
    return len(a)


def exact_launches(counts, want, what):
    """Exact launches: `want` for the kernels it names, 0 for every
    other."""
    full = {k: want.get(k, 0) for k in counts}
    if counts != full:
        raise AssertionError(
            f"tablet {what}: launches "
            f"{ {k: v for k, v in counts.items() if v} }, not "
            f"{ {k: v for k, v in full.items() if v} }")


def tablet_phase(args, workdir, card, push_out, top_ht, device="cuda"):
    """The tablet layer on the card (tablet/tablet.py): a Tablet with
    TabletOptions(device, DeviceSlabCache) beside a device-free Tablet
    (TabletOptions(device="native"): its DBs "native"; the port's default
    is the card) taking the same operations in the same call. Both draw
    hybrid times from one fixed physical time (HybridClock's logical
    ticks), so their writes carry the same hybrid times and their files
    must be equal:

      - config 2 at full width: rows in 4 runs (key space rows/2, 5% row
        tombstones, 19-byte column keys, 64-byte values) bulk-loaded into
        the card tablet's regular DB with ingest_packed at op id (0, 0);
        the device-free tablet opens its checkpoint (hard links), and a
        second checkpoint is the consensus phase's seed; read as rows of
        YCSB's usertable (ycsb_key, field0: the generator's column key is
        field0's);
      - YCSB workload A (read 0.5, update 0.5, ScrambledZipfian 0.99):
        --tablet-ops reads through Tablet.multi_read and as many updates
        through Tablet.write, in calls of 1024 (P1 + P2 and P3 + the fold
        once per 1024-key chunk: 3 keys a row);
      - Tablet.flush (byte for byte) and Tablet.compact (the codec route:
        A a level, B, D, H once, C a cache miss, E, F and P4 an output);
        data files byte for byte, MANIFESTs edit for edit (the card's job
        fits a learned index into its base files);
      - the first page (131,072 rows) of a full-table Tablet.scan (G, H,
        I.1, B over the whole tablet on the card) and a range scan over
        a fiftieth of the keys forced onto the card (+ I.2 once), each
        == the device-free tablet's host iterator;
      - a FaultInjectionEnv ENOSPC on SST appends during a flush: both
        regular DBs park, Tablet.write is refused (ServiceUnavailable),
        multi_read goes on on the card, and after clear_faults
        retry_background_work flushes and writes flow again;
      - 1,024 transactional writes read while their intents are
        pending, once committed and once applied: the read_row route
        (the intents DB is not empty: no point-read launch), then a
        flush of both DBs of each tablet (the intents' byte for byte);
      - scan_aggregate q6 on the lineitem SSTs as a tablet on the card
        == step 8's answer (first call and resident call: G, H, I.1, B,
        J.1, J.2, K); the device-free tablet refuses the pushdown (None).

    Every launch counter is set to 0 just before each part and read just
    after. Returns (summary, {part: launches}, (the consensus seed's
    directory, the clocks' physical time))."""
    import importlib.util
    import torch
    from yugabyte_tpu_torch.common.hybrid_time import HybridClock, HybridTime
    from yugabyte_tpu_torch.common.schema import (ColumnSchema, DataType,
                                                  Schema)
    from yugabyte_tpu_torch.docdb.doc_key import DocKey
    from yugabyte_tpu_torch.docdb.doc_operations import (QLWriteOp,
                                                         WriteOpKind)
    from yugabyte_tpu_torch.docdb.intents import TransactionMetadata
    from yugabyte_tpu_torch.ops import run_merge
    from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
    from yugabyte_tpu_torch.storage.sst import BlockCache
    from yugabyte_tpu_torch.tablet.tablet import Tablet, TabletOptions
    from yugabyte_tpu_torch.utils import env as env_mod
    from yugabyte_tpu_torch.utils.status import Code, StatusError

    wrappers = {**_mesh_wrappers(), **_pushdown_wrappers(),
                **_point_wrappers()}
    launches, out = {}, {"card": card}
    t_phase = time.time()
    n = args.rows
    key_space = max(1, n // 2)
    span = max(1_000_000, n // 4)
    d = os.path.join(workdir, "tablet_phase")
    schema = Schema([ColumnSchema("ycsb_key", DataType.STRING),
                     ColumnSchema("field0", DataType.STRING)],
                    num_range_key_columns=1)
    # the clocks' physical time: 900 s (the retention interval) above
    # every bulk-loaded write, so the compaction's history cutoff
    # collects the loaded versions a newer one shadows
    now_us = span * 10 + 1_000_000_000

    def tablet(tag, sub, **kw):
        return Tablet(f"{sub}-{tag}", os.path.join(d, f"{sub}_{tag}"),
                      kw.pop("schema", schema),
                      clock=HybridClock(kw.pop("time_us", lambda: now_us)),
                      options=TabletOptions(
                          auto_compact=False, memstore_size_bytes=1 << 40,
                          block_cache=BlockCache(4 << 30), **kw))

    def on_card():
        return dict(device=device, device_cache=DeviceSlabCache(
            device, capacity_bytes=16 << 30))

    dev = tablet("card", "ycsb", **on_card())
    cache = dev.regular_db._device_cache

    def both(what, fn):
        """fn(tablet) on each tablet: (answers, {tag: seconds}); the
        answers must be equal."""
        got, secs = {}, {}
        for tag, t in pair:
            t0 = time.time()
            got[tag] = fn(t)
            sync()
            secs[tag] = time.time() - t0
        if got["device"] != got["free"]:
            raise AssertionError(f"tablet {what}: the card's answer differs "
                                 f"from the device-free tablet's")
        return got["device"], secs

    def keys_of(ids):
        return [DocKey(range_components=("user%08d" % i,)) for i in ids]

    def multi_read(ids):
        return lambda t: [_row(r) for r in t.multi_read(keys_of(ids))]

    def updates(ids, rng):
        letters = rng.integers(ord("a"), ord("z") + 1, size=(len(ids), 61),
                               dtype=np.uint8)
        return [QLWriteOp(WriteOpKind.UPDATE, k,
                          {"field0": letters[j].tobytes().decode()})
                for j, k in enumerate(keys_of(ids))]

    def point_launches(what, calls, rows_a_call):
        counts = _launches_of(wrappers)
        chunks = calls * -(-3 * rows_a_call // 1024)
        exact_launches(counts, {"hash_probe_files": chunks, "locate_fold": chunks},
             what)
        return counts

    # -- config 2 bulk-loaded into the card tablet's regular DB; the
    # device-free tablet opens a checkpoint of it (the DB phase holds a
    # device DB's and a native DB's loads of the same runs byte for byte)
    t0 = time.time()
    runs = _db_ycsb_runs(4, n // 4, key_space, span, args.seed + 100)
    out["generate_s"] = time.time() - t0
    t0 = time.time()
    for run in runs:
        # op id (0, 0): the load precedes any consensus op (the consensus
        # phase's replicas open it under an empty Raft log)
        dev.regular_db.ingest_packed(*run)
    out["load_s"] = time.time() - t0
    del runs
    dev.regular_db.checkpoint(os.path.join(d, "ycsb_free", "regular"))
    seed = os.path.join(d, "consensus_seed")
    dev.regular_db.checkpoint(seed)
    nat = tablet("free", "ycsb", device="native")
    pair = (("device", dev), ("free", nat))

    # -- YCSB workload A: reads and updates in calls of 1024
    rng = np.random.default_rng(args.seed + 101)
    calls = max(1, args.tablet_ops // 1024)
    read_s = {"device": [], "free": []}
    write_s = {"device": [], "free": []}
    found = 0
    _zero(wrappers)
    for c in range(calls):
        rows, secs = both("multi_read", multi_read(
            scrambled_zipfian(1024, key_space, rng)))
        found += sum(r is not None for r in rows)
        for k in secs:
            read_s[k].append(secs[k])
        ops = updates(scrambled_zipfian(1024, key_space, rng), rng)
        _, secs = both("write", lambda t: t.write(ops).value)
        for k in secs:
            write_s[k].append(secs[k])
    launches["tablet_reads"] = point_launches("YCSB-A reads", calls, 1024)
    rates = {k: {"reads": 1024 * (calls - 1) / sum(v[1:]) if calls > 1
                 else None, "cold_first_call_s": v[0]}
             for k, v in read_s.items()}
    for k, v in write_s.items():
        rates[k]["updates"] = 1024 * calls / sum(v)
        rates[k]["read_p50_ms"] = 1e3 * float(np.median(read_s[k][1:] or
                                                        read_s[k]))
    out["ycsb_a"] = {"calls": calls, "rows_found": found, **rates}
    log(f"tablet YCSB-A: {calls} multi_read calls of 1024 rows ({found} "
        f"found) == the device-free tablet's, and {calls} writes of 1024 "
        f"updates; reads {rates['device']['reads'] or 0:,.0f} rows/s on "
        f"the card (p50 {rates['device']['read_p50_ms']:.1f} ms a call, "
        f"the cold first {rates['device']['cold_first_call_s']:.2f} s) vs "
        f"{rates['free']['reads'] or 0:,.0f} device-free; updates "
        f"{rates['device']['updates']:,.0f} vs "
        f"{rates['free']['updates']:,.0f} a second; launches "
        f"{ {k: v for k, v in launches['tablet_reads'].items() if v} } "
        f"[{card}]")

    # -- flush and compact
    _, out["flush_s"] = both("flush", lambda t: t.flush())
    same_dir_bytes(dev.regular_db.db_dir, nat.regular_db.db_dir, "flush")
    live = dev.regular_db.versions.live_files()
    ns = [fm.props.n_entries for fm in live]
    misses = sum(not cache.contains(fm.file_id) for fm in live)
    _zero(wrappers)
    t0 = time.time()
    dev.compact()
    sync()
    comp_s = {"device": time.time() - t0}
    launches["tablet_compact"] = _launches_of(wrappers)
    t0 = time.time()
    nat.compact()
    comp_s["free"] = time.time() - t0
    outs = dev.regular_db.n_live_files
    k_pad, _m = run_merge._layout(ns)
    exact_launches(launches["tablet_compact"], {
        "merge_path_level": k_pad.bit_length() - 1, "gc_pack": 1,
        "block_decode": misses, "survivor_scan": 1, "staged_concat": 1,
        "span_gather": outs, "block_encode": outs, "index_fit": outs},
        "compact")
    out["compact"] = {
        "rows_in": sum(ns), "inputs": len(ns), "cache_misses": misses,
        **same_db_files(dev.regular_db, nat.regular_db, "tablet compact"),
        "manifest_edits": same_manifest(dev.regular_db, nat.regular_db,
                                        "tablet compact"),
        "seconds": comp_s,
        "rows_per_s": {k: sum(ns) / v for k, v in comp_s.items()}}
    log(f"tablet flush + compact: {sum(ns)} rows in {len(ns)} files "
        f"({misses} cache misses) -> {outs} files, "
        f"{sum(ns) / comp_s['device']:,.0f} rows/s on the card vs "
        f"{sum(ns) / comp_s['free']:,.0f} device-free; data files == the "
        f"device-free tablet's, MANIFEST edit for edit; launches "
        f"{ {k: v for k, v in launches['tablet_compact'].items() if v} } "
        f"[{card}]")

    # -- scans: the first page of the full table, and a range
    page = 131_072
    lower = DocKey(range_components=("user%08d" % (key_space // 5),)
                   ).encode()
    upper = DocKey(range_components=(
        "user%08d" % (key_space // 5 + key_space // 50),)).encode()
    out["scans"] = {}
    for part, kw, limit in (("scan", {}, page),
                            ("range_scan", dict(lower_doc_key=lower,
                                                upper_doc_key=upper), None)):
        def scan(t, kw=kw, limit=limit):
            it = t.scan(**kw, use_device=(t is dev) or None)
            rows = [_row(r) for r in it.rows(limit=limit)]
            if t is dev:
                it._entries.close()   # the page ends the stream: unpin
            return rows
        _zero(wrappers)
        rows, secs = both(part, scan)
        launches[f"tablet_{part}"] = _launches_of(wrappers)
        sources = dev.regular_db.n_live_files
        exact_launches(launches[f"tablet_{part}"], {
            "radix_sort": 1, "sorted_payload": 1, "gc_pack": 1,
            "staged_concat": int(sources > 1),
            "bound_pack": int(part == "range_scan")}, part)
        if not rows or dev.regular_db._pins:
            raise AssertionError(f"tablet {part}: {len(rows)} rows, pins "
                                 f"{dev.regular_db._pins}")
        out["scans"][part] = {"rows": len(rows), "seconds": secs,
                              "rows_per_s": {k: len(rows) / v
                                             for k, v in secs.items()}}
        log(f"tablet {part}: {len(rows)} rows == the device-free tablet's "
            f"host iterator; {len(rows) / secs['device']:,.0f} rows/s on "
            f"the card vs {len(rows) / secs['free']:,.0f}; launches "
            f"{ {k: v for k, v in launches[f'tablet_{part}'].items() if v} }"
            f" [{card}]")

    # -- a disk fault during a flush: park, refuse, serve, recover
    fi = env_mod.enable_fault_injection()
    try:
        frng = np.random.default_rng(args.seed + 102)
        ops = updates(scrambled_zipfian(1024, key_space, frng), frng)
        both("writes before the fault", lambda t: t.write(ops).value)
        fi.set_fault("enospc", path_filter=".sst")
        parked, _ = both("faulted flush", lambda t: (
            t.flush(), t.regular_db.background_error is not None)[1])
        ops2 = updates(scrambled_zipfian(1024, key_space, frng), frng)

        def refused(t):
            try:
                t.write(ops2)
                return None
            except StatusError as e:
                return e.status.code
        code, _ = both("write while parked", refused)
        ids = scrambled_zipfian(1024, key_space, frng)
        _zero(wrappers)
        both("multi_read while parked", multi_read(ids))
        launches["tablet_parked_reads"] = point_launches(
            "reads while parked", 1, 1024)
        fi.clear_faults()
        healed, _ = both("recovery", lambda t: (
            t.regular_db.retry_background_work(),
            t.regular_db.background_error))
        both("write after recovery", lambda t: t.write(ops2).value)
        if not parked or code != Code.SERVICE_UNAVAILABLE \
                or healed != (True, None) or fi.faults_injected < 2:
            raise AssertionError(f"tablet fault: parked {parked}, write "
                                 f"{code}, recovery {healed}, faults "
                                 f"{fi.faults_injected}")
    finally:
        env_mod.disable_fault_injection()
    out["fault"] = {"faults_injected": fi.faults_injected,
                    "write_refused": str(code)}
    log(f"tablet disk fault: ENOSPC on the flush's SST appends "
        f"({fi.faults_injected} injected) parked both regular DBs; writes "
        f"refused ({code.name}); 1024 reads on the card == device-free "
        f"(launches "
        f"{ {k: v for k, v in launches['tablet_parked_reads'].items() if v} }"
        f"); after clear_faults retry_background_work flushed and writes "
        f"flowed")

    # -- transactional writes: pending, committed, applied
    trng = np.random.default_rng(args.seed + 103)
    tids = trng.choice(key_space, size=1024, replace=False)
    meta = TransactionMetadata(b"\x5a" * 16, "status-tablet")
    statuses = {}
    tops = updates(tids, trng)
    for _tag, t in pair:
        t.status_resolver = lambda _st, txn, read_ht=None: statuses.get(
            txn, {"status": "pending", "commit_ht": None})
    both("transactional write", lambda t: t.write_transactional(tops,
                                                                meta).value)
    want = [o.values["field0"] for o in tops]
    out["transaction"] = {}
    for stage in ("pending", "committed", "applied"):
        if stage == "committed":
            commit_ht, _ = both("commit time", lambda t: t.clock.now().value)
            statuses[meta.txn_id] = {"status": "committed",
                                     "commit_ht": commit_ht}
        if stage == "applied":
            both("apply", lambda t: t.apply_txn_update(
                "apply", meta.txn_id, commit_ht, t.clock.now().value,
                (2, 1)))
        _zero(wrappers)
        rows, secs = both(f"multi_read, intents {stage}", multi_read(tids))
        launches[f"tablet_txn_{stage}"] = _launches_of(wrappers)
        exact_launches(launches[f"tablet_txn_{stage}"], {}, f"txn {stage}")
        vals = [dict(r[1]).get(0) if r else None for r in rows]
        if (stage == "pending") == (vals == want):
            raise AssertionError(f"tablet transaction {stage}: the rows "
                                 f"read {'show' if stage == 'pending' else 'miss'}"
                                 f" the transaction's values")
        out["transaction"][stage] = {"seconds": secs}
    _, out["transaction"]["flush_s"] = both("flush after the transaction",
                                            lambda t: t.flush())
    out["transaction"]["intents_files"] = same_dir_bytes(
        dev.intents_db.db_dir, nat.intents_db.db_dir, "intents")
    same_db_files(dev.regular_db, nat.regular_db, "tablet at the end")
    same_manifest(dev.regular_db, nat.regular_db, "tablet at the end")
    log(f"tablet transaction: 1024 transactional writes read while "
        f"pending, committed and applied == the device-free tablet's, "
        f"through read_row (the intents DB is not empty: no point-read "
        f"launch); intents files byte for byte "
        f"({out['transaction']['intents_files']}) [{card}]")
    if cache.pinned_count() or dev.regular_db._pins:
        raise AssertionError("tablet: pins left")
    dev.close()
    nat.close()
    del dev, nat, cache
    torch.cuda.empty_cache()

    # -- q6_agg on the lineitem SSTs as a tablet
    queries = pushdown_queries(lineitem_schema())
    mode, spec = queries["q6_agg"]
    li = {}
    for tag, kw in (("card", on_card()), ("free", {"device": "native"})):
        link_lineitem(os.path.join(workdir, "lineitem"),
                      os.path.join(d, f"lineitem_{tag}", "regular"))
        li[tag] = tablet(tag, "lineitem", schema=lineitem_schema(),
                         time_us=lambda: (top_ht >> 12) + 1, **kw)
    ref = push_out["q6_agg"]["answer"]
    rec = {}
    for call in ("first", "resident"):
        _zero(wrappers)
        t0 = time.time()
        got = li["card"].scan_aggregate(HybridTime(top_ht), spec=spec)
        sync()
        rec[f"{call}_s"] = time.time() - t0
        launches[f"tablet_q6_agg_{call}"] = _launches_of(wrappers)
        check_pushdown_launches(launches[f"tablet_q6_agg_{call}"], mode,
                                False, "tablet q6_agg")
        if got is None or {"rows": got["rows"], "cols": {
                str(c): v for c, v in got["cols"].items()}} != ref:
            raise AssertionError(f"tablet q6_agg ({call} call): {got} != "
                                 f"the pushdown phase's {ref}")
    if li["free"].scan_aggregate(HybridTime(top_ht), spec=spec) is not None:
        raise AssertionError("the device-free lineitem tablet ran the "
                             "pushdown")
    if li["card"].regular_db._pins:
        raise AssertionError("tablet q6_agg: pins left")
    for t in li.values():
        t.close()
    out["q6_agg"] = rec
    log(f"tablet q6_agg on the lineitem tablet == step 8's answer: first "
        f"call {rec['first_s']:.3f} s (stages the value words), resident "
        f"{rec['resident_s']:.4f} s; the device-free tablet refuses the "
        f"pushdown (None) [{card}]")
    crypto = importlib.util.find_spec("cryptography") is not None
    out["encrypted_route"] = "held on the CPU (tests/test_torch_env.py)"
    log(f"tablet: the encrypted Env is not run here (the cryptography "
        f"package is {'present' if crypto else 'absent'} on this machine); "
        f"its routes are held against the JAX package on the CPU by "
        f"tests/test_torch_env.py")
    torch.cuda.empty_cache()
    out["seconds"] = time.time() - t_phase
    log(f"tablet phase: {out['seconds']:.1f}s [{card}]")
    return out, launches, (seed, now_us)


# --------------------------------------------------------------- consensus
class StepTime:
    """The physical time (microseconds) of one replica group's clocks:
    fixed, and moved on by `step` at the first reading the driving thread
    takes after `arm()`. The driver arms it just before each write, so the
    write's hybrid time is (the new physical time, logical 0) however
    many readings the group's raft threads took in between (each of those
    only bumps the logical part): two groups driven alike assign equal
    hybrid times. With `threads`, the driving thread is any thread whose
    name starts so (a tablet server's RPC workers, `rpc-worker-ts-<id>`:
    a write sent over the wire is picked there)."""

    def __init__(self, us: int, step: int, threads: str = ""):
        self.us, self.step = us, step
        self._owner = threading.get_ident()
        self._threads = threads
        self._armed = False

    def arm(self) -> None:
        self._armed = True

    def _driving(self) -> bool:
        if self._threads:
            return threading.current_thread().name.startswith(self._threads)
        return threading.get_ident() == self._owner

    def __call__(self) -> int:
        if self._armed and self._driving():
            self._armed = False
            self.us += self.step
        return self.us


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _wait(pred, what: str, timeout: float = 120.0) -> float:
    """Seconds until pred() holds; raises after `timeout`."""
    t0 = time.time()
    while not pred():
        if time.time() - t0 > timeout:
            raise AssertionError(f"consensus: timed out waiting for {what}")
        time.sleep(0.002)
    return time.time() - t0


def consensus_phase(args, workdir, card, seed, now_us, device="cuda"):
    """The replicated tablet (tablet/tablet_peer.py over consensus/raft.py
    and rpc/): two Raft groups of three TabletPeers, ts0-ts2, each peer
    on a localhost Messenger of its own and talking over RpcTransport.
    The card group's replicas hold TabletOptions(device, DeviceSlabCache)
    with a cache each; the device-free group's TabletOptions(device=
    "native"). Every clock of a group reads one StepTime (a fixed physical
    time the driver moves on at each write), so both leaders assign equal
    hybrid times:

      1. every replica opens the tablet phase's bulk-loaded config-2
         checkpoint (`seed`, hard links, op id (0, 0): before the Raft
         log's first entry), then bootstrap() and start();
      2. ts0 is elected (start_election(ignore_lease=True));
      3. YCSB core workload A (read 0.5, update 0.5, ScrambledZipfian
         0.99): --consensus-ops reads through the leader's
         TabletPeer.multi_read (P1 + P2 and P3 + the fold a 1024-key
         chunk) and as many updates through TabletPeer.write, in calls of
         1024; each write is replicated, then applied on all three;
      4. flush on every replica: the six replicas' files byte for byte;
      5. compact on every replica: the card replicas run the device-native
         job (A a level, B, D, H once, C a cache miss, E, F, P4 an
         output), the device-free ones the native job; data files byte
         for byte, MANIFESTs edit for edit, the card replicas' byte for
         byte;
      6. failover and bootstrap: one call of updates through ts0, ts0
         shuts down, ts1 is elected, one call through ts1; ts0 restarts
         (its bootstrap replays the first call from its WAL into a card
         tablet) and catches up; every replica's multi_read over the last
         call's keys (followers: vouched, at the last write's hybrid time)
         == the device-free group's.

    Every launch counter is set to 0 just before each part and read just
    after. Returns (summary, {part: launches})."""
    import torch
    from yugabyte_tpu_torch.common.hybrid_time import HybridClock, HybridTime
    from yugabyte_tpu_torch.common.schema import (ColumnSchema, DataType,
                                                  Schema)
    from yugabyte_tpu_torch.docdb.doc_key import DocKey
    from yugabyte_tpu_torch.docdb.doc_operations import (QLWriteOp,
                                                         WriteOpKind)
    from yugabyte_tpu_torch.ops import run_merge
    from yugabyte_tpu_torch.rpc.consensus_service import RpcTransport
    from yugabyte_tpu_torch.rpc.messenger import Messenger
    from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
    from yugabyte_tpu_torch.storage.sst import BlockCache
    from yugabyte_tpu_torch.tablet.tablet import TabletOptions
    from yugabyte_tpu_torch.tablet.tablet_peer import TabletPeer, peer_address

    wrappers = {**_mesh_wrappers(), **_pushdown_wrappers(),
                **_point_wrappers()}
    launches, out = {}, {"card": card}
    t_phase = time.time()
    n = args.rows
    key_space = max(1, n // 2)
    d = os.path.join(workdir, "consensus_phase")
    tid = "usertable"
    servers = ("ts0", "ts1", "ts2")
    schema = Schema([ColumnSchema("ycsb_key", DataType.STRING),
                     ColumnSchema("field0", DataType.STRING)],
                    num_range_key_columns=1)

    def options(tag):
        kw = dict(auto_compact=False, memstore_size_bytes=1 << 40,
                  block_cache=BlockCache(1 << 30))
        if tag == "card":
            return TabletOptions(device=device, device_cache=DeviceSlabCache(
                device, capacity_bytes=8 << 30), **kw)
        return TabletOptions(device="native", **kw)

    groups = {}
    for tag in ("card", "free"):
        ms = {s: Messenger(f"{tag}-{s}") for s in servers}
        addr = {peer_address(s, tid): ms[s].address for s in servers}
        groups[tag] = {"time": StepTime(now_us, 1000), "messengers": ms,
                       "transports": {s: RpcTransport(ms[s], addr.get)
                                      for s in servers},
                       "peers": {}}

    replays = {}

    def open_peer(tag, s):
        """A replica over its copy of the seed (made on its first open):
        bootstrap() (its count of replayed entries kept) and start()."""
        g = groups[tag]
        data = os.path.join(d, tag, s)
        if not os.path.exists(data):
            shutil.copytree(seed, os.path.join(data, "regular"),
                            copy_function=os.link)
            os.remove(os.path.join(data, "regular", "MANIFEST"))
            shutil.copy(os.path.join(seed, "MANIFEST"),
                        os.path.join(data, "regular", "MANIFEST"))
        p = TabletPeer(tid, data, schema, s, servers, g["transports"][s],
                       clock=HybridClock(g["time"]), options=options(tag))

        def bootstrap():
            replays[(tag, s)] = TabletPeer.bootstrap(p)
            return replays[(tag, s)]
        p.bootstrap = bootstrap
        p.start(election_timer=False)
        g["peers"][s] = p
        return p

    def elect(tag, s):
        p = groups[tag]["peers"][s]
        p.raft.start_election(ignore_lease=True)
        return _wait(lambda: p.raft.is_leader() and p.raft.leader_ready()
                     and p.raft.has_leader_lease(), f"{tag} {s} to lead")

    def all_applied(tag, leader):
        ps = groups[tag]["peers"]
        target = ps[leader].raft.commit_index
        return _wait(lambda: all(p.raft.last_applied >= target
                                 for p in ps.values()),
                     f"{tag}: every replica to apply index {target}")

    def keys_of(ids):
        return [DocKey(range_components=("user%08d" % i,)) for i in ids]

    def updates(ids, rng):
        letters = rng.integers(ord("a"), ord("z") + 1, size=(len(ids), 61),
                               dtype=np.uint8)
        return [QLWriteOp(WriteOpKind.UPDATE, k,
                          {"field0": letters[j].tobytes().decode()})
                for j, k in enumerate(keys_of(ids))]

    def write(tag, leader, ops):
        g = groups[tag]
        g["time"].arm()
        t0 = time.time()
        ht = g["peers"][leader].write(ops)
        return ht.value, time.time() - t0

    def both(what, fn):
        """fn(tag) for each group: (answer, {tag: seconds}); the answers
        must be equal."""
        got, secs = {}, {}
        for tag in ("card", "free"):
            t0 = time.time()
            got[tag] = fn(tag)
            sync()
            secs[tag] = time.time() - t0
        if got["card"] != got["free"]:
            raise AssertionError(f"consensus {what}: the card group's answer "
                                 f"differs from the device-free group's")
        return got["card"], secs

    def card_pins():
        return [s for s, p in groups["card"]["peers"].items()
                if p.tablet.regular_db._pins
                or p.tablet.regular_db._device_cache.pinned_count()]

    try:
        # -- 1, 2: open every replica over the seed, bootstrap, start; elect
        _, out["open_s"] = both("open", lambda tag: [
            open_peer(tag, s).raft.last_applied for s in servers])
        _, out["elect_s"] = both("election",
                                 lambda tag: elect(tag, "ts0") < 0)

        # -- 3: YCSB-A through the leader
        rng = np.random.default_rng(args.seed + 110)
        calls = max(1, args.consensus_ops // 1024)
        read_s = {"card": [], "free": []}
        write_s = {"card": [], "free": []}
        found = 0
        _zero(wrappers)
        for _c in range(calls):
            keys = keys_of(scrambled_zipfian(1024, key_space, rng))
            rows, secs = both("multi_read", lambda tag: [
                _row(r) for r in groups[tag]["peers"]["ts0"].multi_read(
                    keys)])
            found += sum(r is not None for r in rows)
            for k in secs:
                read_s[k].append(secs[k])
            ops = updates(scrambled_zipfian(1024, key_space, rng), rng)
            hts = {}
            for tag in ("card", "free"):
                hts[tag], s = write(tag, "ts0", ops)
                write_s[tag].append(s)
            if hts["card"] != hts["free"]:
                raise AssertionError(f"consensus write: hybrid times "
                                     f"{hts} differ")
        launches["consensus_reads"] = _launches_of(wrappers)
        chunks = calls * -(-3 * 1024 // 1024)
        exact_launches(launches["consensus_reads"], {
            "hash_probe_files": chunks, "locate_fold": chunks},
            "consensus YCSB-A reads")
        _, apply_s = both("apply on every replica",
                          lambda tag: all_applied(tag, "ts0") < 0)
        rates = {k: {"reads": 1024 * (calls - 1) / sum(v[1:]) if calls > 1
                     else None, "cold_first_call_s": v[0],
                     "read_p50_ms": 1e3 * float(np.median(v[1:] or v))}
                 for k, v in read_s.items()}
        for k, v in write_s.items():
            rates[k]["updates"] = 1024 * calls / sum(v)
            rates[k]["write_p50_ms"] = 1e3 * float(np.median(v))
        out["ycsb_a"] = {"calls": calls, "rows_found": found,
                         "followers_applied_s": apply_s, **rates}
        log(f"consensus YCSB-A: {calls} multi_read calls of 1024 rows "
            f"through the leader ({found} found) == the device-free "
            f"group's; {calls} writes of 1024 updates replicated to 3 "
            f"replicas over RpcTransport: "
            f"{rates['card']['updates']:,.0f} updates/s in the card group "
            f"vs {rates['free']['updates']:,.0f} device-free; leader reads "
            f"{rates['card']['reads'] or 0:,.0f} rows/s vs "
            f"{rates['free']['reads'] or 0:,.0f} (the cold first call "
            f"{rates['card']['cold_first_call_s']:.2f} s); launches "
            f"{_nonzero(launches['consensus_reads'])} [{card}]")

        # -- 4: flush on every replica; the six replicas' files are equal
        flush_s = {}
        _zero(wrappers)
        for tag in ("card", "free"):
            for s in servers:
                t0 = time.time()
                groups[tag]["peers"][s].tablet.flush()
                sync()
                flush_s[f"{tag}_{s}"] = time.time() - t0
        launches["consensus_flush"] = _launches_of(wrappers)
        exact_launches(launches["consensus_flush"], {}, "consensus flush")
        ref = groups["card"]["peers"]["ts0"].tablet.regular_db.db_dir
        files = 0
        for tag in ("card", "free"):
            for s in servers:
                if (tag, s) != ("card", "ts0"):
                    files = same_dir_bytes(
                        ref, groups[tag]["peers"][s].tablet.regular_db.db_dir,
                        f"consensus flush, {tag} {s}")
        out["flush"] = {"seconds": flush_s, "files": files}
        log(f"consensus flush: the six replicas' files byte for byte "
            f"({files} files, the MANIFEST among them, each) [{card}]")

        # -- 5: compact on every replica
        out["compact"] = {}
        for s in servers:
            dev = groups["card"]["peers"][s].tablet
            nat = groups["free"]["peers"][s].tablet
            cache = dev.regular_db._device_cache
            live = dev.regular_db.versions.live_files()
            ns = [fm.props.n_entries for fm in live]
            misses = sum(not cache.contains(fm.file_id) for fm in live)
            _zero(wrappers)
            t0 = time.time()
            dev.compact()
            sync()
            secs = {"card": time.time() - t0}
            launches[f"consensus_compact_{s}"] = _launches_of(wrappers)
            t0 = time.time()
            nat.compact()
            secs["free"] = time.time() - t0
            outs = dev.regular_db.n_live_files
            k_pad, _m = run_merge._layout(ns)
            exact_launches(launches[f"consensus_compact_{s}"], {
                "merge_path_level": k_pad.bit_length() - 1, "gc_pack": 1,
                "block_decode": misses, "survivor_scan": 1,
                "staged_concat": 1, "span_gather": outs,
                "block_encode": outs, "index_fit": outs},
                f"consensus compact {s}")
            rec = {"rows_in": sum(ns), "inputs": len(ns),
                   "cache_misses": misses,
                   **same_db_files(dev.regular_db, nat.regular_db,
                                   f"consensus compact {s}"),
                   "manifest_edits": same_manifest(
                       dev.regular_db, nat.regular_db,
                       f"consensus compact {s}"),
                   "seconds": secs,
                   "rows_per_s": {k: sum(ns) / v for k, v in secs.items()}}
            if s != "ts0":
                same_dir_bytes(
                    groups["card"]["peers"]["ts0"].tablet.regular_db.db_dir,
                    dev.regular_db.db_dir, f"consensus compact, card {s}")
            out["compact"][s] = rec
            log(f"consensus compact {s}: {sum(ns)} rows in {len(ns)} files "
                f"({misses} cache misses) -> {outs} files, "
                f"{rec['rows_per_s']['card']:,.0f} rows/s on the card vs "
                f"{rec['rows_per_s']['free']:,.0f} native; data files == "
                f"the device-free replica's, MANIFEST edit for edit, "
                f"== the card's ts0 byte for byte; launches "
                f"{_nonzero(launches[f'consensus_compact_{s}'])} [{card}]")

        # -- 6: failover and bootstrap
        frng = np.random.default_rng(args.seed + 111)
        pre = updates(scrambled_zipfian(1024, key_space, frng), frng)
        both("write before the failover",
             lambda tag: write(tag, "ts0", pre)[0])
        both("apply before the failover",
             lambda tag: all_applied(tag, "ts0") < 0)
        flushed = {tag: groups[tag]["peers"]["ts0"].tablet.regular_db
                   .versions.flushed_frontier.op_id_max[1]
                   for tag in groups}

        def failover(tag):
            g = groups[tag]
            t0 = time.time()
            g["peers"].pop("ts0").shutdown()
            g["transports"]["ts0"].unregister(peer_address("ts0", tid))
            elect(tag, "ts1")
            return time.time() - t0
        _, failover_s = both("failover", lambda tag: failover(tag) < 0)
        ids = scrambled_zipfian(1024, key_space, frng)
        post = updates(ids, frng)
        last_ht, _ = both("write through ts1",
                          lambda tag: write(tag, "ts1", post)[0])

        def restart(tag):
            t0 = time.time()
            open_peer(tag, "ts0")
            boot[tag] = time.time() - t0
            all_applied(tag, "ts1")
            return replays[(tag, "ts0")]
        boot = {}
        replayed, secs = both("restart ts0", restart)
        if replayed < 1:
            raise AssertionError(f"consensus: ts0's bootstrap replayed "
                                 f"{replayed} entries")
        out["failover"] = {"failover_s": failover_s, "bootstrap_s": boot,
                           "bootstrap_and_catch_up_s": secs,
                           "replayed": replayed,
                           "flushed_index": flushed["card"]}
        keys = keys_of(ids)
        read_ht = HybridTime(last_ht)
        _zero(wrappers)
        answers = {}
        for tag in ("card", "free"):
            for s, p in sorted(groups[tag]["peers"].items()):
                if not p.raft.is_leader():
                    p.grant_vouch(0)
                answers[(tag, s)] = [_row(r) for r in p.multi_read(
                    keys, read_ht=read_ht, allow_follower=True)]
        launches["consensus_failover_reads"] = _launches_of(wrappers)
        exact_launches(launches["consensus_failover_reads"], {
            "hash_probe_files": 3 * 3, "locate_fold": 3 * 3},
            "consensus reads after the failover")
        want = answers[("free", "ts1")]
        if any(a != want for a in answers.values()) or \
                sum(r is not None for r in want) != len(want):
            raise AssertionError("consensus: the replicas' reads after the "
                                 "failover differ")
        if card_pins():
            raise AssertionError(f"consensus: pins left on {card_pins()}")
        log(f"consensus failover: ts0 down, ts1 elected in "
            f"{failover_s['card']:.3f} s (device-free "
            f"{failover_s['free']:.3f}); one call of 1024 updates through "
            f"ts1; ts0 restarted: its bootstrap replayed {replayed} WAL "
            f"entry(ies) above index {flushed['card']} into a card tablet "
            f"in {boot['card']:.3f} s, caught up {secs['card']:.3f} s after "
            f"the restart (device-free {secs['free']:.3f}); every replica's "
            f"1024 reads == the device-free group's; launches "
            f"{_nonzero(launches['consensus_failover_reads'])} [{card}]")
    finally:
        for g in groups.values():
            for p in g["peers"].values():
                p.shutdown()
            for m in g["messengers"].values():
                m.shutdown()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    out["seconds"] = time.time() - t_phase
    log(f"consensus phase: {out['seconds']:.1f}s [{card}]")
    return out, launches


def tserver_phase(args, workdir, card, seed, now_us, push_out, top_ht):
    """The tablet server (tserver/): two TabletServers on localhost
    Messengers, "card" with default options (its ServerExecutionContext
    takes the card: one DeviceSlabCache, block cache, compaction pool and
    health board for its tablets) and "free" with a device-free tablet
    factory (TabletOptions(device="native")). Each hosts, before it
    starts (open_existing at start()), the tablet phase's bulk-loaded
    config-2 tablet as YCSB's usertable (hard links of `seed`, op id
    (0, 0)) and the pushdown phase's lineitem SSTs as a tablet; both are
    elected. The servers' clocks read a StepTime each, moved on at the
    first reading an RPC worker of that server takes after the driver
    arms it, so a write sent over the wire draws equal hybrid times on
    both. A client Messenger drives, through the `tserver` service:

      1. YCSB core workload A (read 0.5, update 0.5, ScrambledZipfian
         0.99): --tserver-ops reads (multi_read) and as many updates
         (write), in calls of 1024 (P1 + P2 and P3 + the fold a 1024-key
         chunk: 3 keys a row);
      2. on the lineitem tablet, Q6's filters and aggregates at the
         pushdown phase's read time over the whole tablet on the card
         (G, H, I.1, B, J.1, J.2, K) == the pushdown phase's host oracle
         (LineitemOracle); Q6 over a 64th of the hash space on both
         servers (the device-free one answers in rows, aggregated here as
         a client does) and the filtered row scan over that range: the
         card's answers == the device-free server's;
      3. flush_tablet on both (files byte for byte), then the compaction
         the card server's MaintenanceManager.run_once() picks (and the
         device-free server's): A a level, B, D, H once, C a cache
         miss, E, F and P4 an output on the card; data files byte for
         byte, MANIFESTs edit for edit;
      4. a PrewarmKernelsOp at one bounded bucket (k_pad 2, m 2^16)
         registered on the card server and picked by run_once(): A and B
         once each per is_major variant and the point-read family; the
         bucket prewarmed on the board;
      5. the compacted usertable remote-bootstrapped from the card server
         into a third server "card2" (default options), added to the
         Raft config and elected; its multi_read over the last call's
         keys == the device-free server's;
      6. /healthz, /compactionz and /servez of the card server over HTTP:
         JSON that names the board's kernel families, the point-read and
         pushdown counters and the device cache.

    The phase pins device_offload_mode to "device" (the card server's
    compaction dispatch is a policy site of the board, which the faults
    phase exercises) and lets the universal picker take every run. Every
    launch counter is set to 0 just before each part and read just after.
    Returns (summary, {part: launches})."""
    import dataclasses
    import urllib.request
    import torch
    from yugabyte_tpu_torch.common.hybrid_time import HybridClock
    from yugabyte_tpu_torch.common.partition import Partition, doc_key_bounds
    from yugabyte_tpu_torch.common.schema import (ColumnSchema, DataType,
                                                  Schema)
    from yugabyte_tpu_torch.common.wire import (doc_key_to_wire,
                                                schema_to_wire,
                                                write_op_to_wire)
    from yugabyte_tpu_torch.docdb.doc_key import DocKey
    from yugabyte_tpu_torch.docdb.doc_operations import (QLWriteOp,
                                                         WriteOpKind)
    from yugabyte_tpu_torch.ops import run_merge
    from yugabyte_tpu_torch.rpc.messenger import Messenger
    from yugabyte_tpu_torch.storage import compaction
    from yugabyte_tpu_torch.storage.bucket_health import health_board
    from yugabyte_tpu_torch.storage.sst import BlockCache
    from yugabyte_tpu_torch.tablet.tablet import TabletOptions
    from yugabyte_tpu_torch.tserver import TabletServer, TabletServerOptions
    from yugabyte_tpu_torch.tserver import server_context  # noqa: F401 (flags)
    from yugabyte_tpu_torch.tserver.maintenance_manager import (
        PrewarmKernelsOp)
    from yugabyte_tpu_torch.utils import flags, jsonutil

    wrappers = {**_mesh_wrappers(), **_pushdown_wrappers(),
                **_point_wrappers()}
    launches, out = {}, {"card": card}
    t_phase = time.time()
    key_space = max(1, args.rows // 2)
    d = os.path.join(workdir, "tserver_phase")
    ycsb = Schema([ColumnSchema("ycsb_key", DataType.STRING),
                   ColumnSchema("field0", DataType.STRING)],
                  num_range_key_columns=1)
    li_schema = lineitem_schema()
    # one physical time above the tablet phase's (900 s past every loaded
    # write) and the lineitem tablet's newest write
    t0_us = max(now_us, (top_ht >> 12) + 1)
    # the phase's settings: the servers' maintenance loops held (the
    # driver calls run_once), no mesh pool, the card server's compaction
    # dispatch on the card (a policy site of the board, which the faults
    # phase exercises), a size ratio that lets the universal picker take
    # every run (a major compaction, as the earlier phases' compact()),
    # the caches of the earlier phases' tablets
    pinned = {"tserver_mesh_compaction_pool": 0,
              "maintenance_manager_polling_interval_s": 3600,
              "device_offload_mode": "device",
              "universal_compaction_size_ratio_pct": 1 << 30,
              "device_cache_capacity_bytes": 16 << 30,
              "block_cache_bytes": 1 << 30}
    for name, value in pinned.items():
        flags.set_flag(name, value)

    def held(opts):
        # the phase's tablets compact when the driver (or the maintenance
        # manager) says so, and never flush on their own
        return dataclasses.replace(opts, auto_compact=False,
                                   memstore_size_bytes=1 << 40)

    def seed_tablet(root, tid, schema, regular, hash_partitioning):
        tdir = os.path.join(root, "tablets", tid)
        regular(os.path.join(tdir, "regular"))
        jsonutil.write_atomic(os.path.join(tdir, "meta.json"), {
            "tablet_id": tid, "table_id": tid,
            "schema": schema_to_wire(schema),
            "peer_server_ids": [os.path.basename(root)], "partition": None,
            "hash_partitioning": hash_partitioning})

    def ycsb_regular(dst):
        shutil.copytree(seed, dst, copy_function=os.link)
        os.remove(os.path.join(dst, "MANIFEST"))
        shutil.copy(os.path.join(seed, "MANIFEST"),
                    os.path.join(dst, "MANIFEST"))

    servers, times = {}, {}

    def new_server(sid, with_tablets=True):
        root = os.path.join(d, sid)
        if with_tablets:
            seed_tablet(root, "usertable", ycsb, ycsb_regular, False)
            seed_tablet(root, "lineitem", li_schema, lambda dst: link_lineitem(
                os.path.join(workdir, "lineitem"), dst), True)
        if sid == "free":
            opts = TabletServerOptions(sid, root, webserver_port=None,
                                       tablet_options_factory=lambda: held(
                                           TabletOptions(
                                               device="native",
                                               block_cache=BlockCache(
                                                   1 << 30))))
        else:
            opts = TabletServerOptions(sid, root)
        ts = TabletServer(opts)
        servers[sid] = ts
        if ts.exec_context is not None:
            ctx = ts.exec_context
            ts.tablet_manager._tablet_options_factory = \
                lambda: held(ctx.tablet_options())
        times[sid] = StepTime(t0_us, 1000, threads=f"rpc-worker-ts-{sid}-")
        ts.clock = ts.tablet_manager.clock = HybridClock(times[sid])
        t0 = time.time()
        ts.start()
        for tid in ts.tablet_manager.tablet_ids():
            p = ts.tablet_manager.get_tablet(tid)
            p.raft.start_election(ignore_lease=True)
            _wait(lambda: p.raft.is_leader() and p.raft.leader_ready()
                  and p.raft.has_leader_lease(), f"{sid} {tid} to lead")
        return time.time() - t0

    client = Messenger("tserver-client")

    def call(sid, method, **kw):
        return client.call(servers[sid].address, "tserver", method,
                           timeout_s=600.0, **kw)

    def both(what, fn):
        """fn(server id) for "card" and "free": (answer, {sid: seconds});
        the answers must be equal."""
        got, secs = {}, {}
        for sid in ("card", "free"):
            t0 = time.time()
            got[sid] = fn(sid)
            sync()
            secs[sid] = time.time() - t0
        if got["card"] != got["free"]:
            raise AssertionError(f"tserver {what}: the card server's answer "
                                 f"differs from the device-free server's")
        return got["card"], secs

    def keys_of(ids):
        return [doc_key_to_wire(DocKey(range_components=("user%08d" % i,)))
                for i in ids]

    def updates(ids, rng):
        letters = rng.integers(ord("a"), ord("z") + 1, size=(len(ids), 61),
                               dtype=np.uint8)
        return [write_op_to_wire(QLWriteOp(
            WriteOpKind.UPDATE, DocKey(range_components=("user%08d" % i,)),
            {"field0": letters[j].tobytes().decode()}))
            for j, i in enumerate(ids)]

    def write(sid, ops):
        times[sid].arm()
        return call(sid, "write", tablet_id="usertable",
                    ops=ops)["propagated_ht"]

    def scan(sid, **kw):
        ans = call(sid, "scan", tablet_id="lineitem", read_ht=top_ht,
                   limit=1 << 30, **kw)
        return {k: v for k, v in ans.items() if k != "read_ht"}

    def db_of(sid, tid="usertable"):
        return servers[sid].tablet_manager.get_tablet(tid).tablet.regular_db

    try:
        _, out["start_s"] = both("start", lambda sid: new_server(sid) < 0)
        ctx = servers["card"].exec_context
        if ctx.device.type != "cuda" or ctx.device_cache is None:
            raise AssertionError(f"tserver: the default server's context is "
                                 f"on {ctx.device}, not the card")

        # -- 1: YCSB-A over the wire
        rng = np.random.default_rng(args.seed + 120)
        calls = max(1, args.tserver_ops // 1024)
        read_s = {"card": [], "free": []}
        write_s = {"card": [], "free": []}
        found = 0
        _zero(wrappers)
        for _c in range(calls):
            keys = keys_of(scrambled_zipfian(1024, key_space, rng))
            rows, secs = both("multi_read", lambda sid: call(
                sid, "multi_read", tablet_id="usertable",
                doc_keys=keys)["rows"])
            found += sum(r is not None for r in rows)
            for k in secs:
                read_s[k].append(secs[k])
            ids = scrambled_zipfian(1024, key_space, rng)
            ops = updates(ids, rng)
            _, secs = both("write", lambda sid: write(sid, ops))
            for k in secs:
                write_s[k].append(secs[k])
        launches["tserver_reads"] = _launches_of(wrappers)
        chunks = calls * -(-3 * 1024 // 1024)
        exact_launches(launches["tserver_reads"], {
            "hash_probe_files": chunks, "locate_fold": chunks},
            "tserver YCSB-A reads")
        rates = {k: {"reads": 1024 * (calls - 1) / sum(v[1:]) if calls > 1
                     else None, "cold_first_call_s": v[0],
                     "read_p50_ms": 1e3 * float(np.median(v[1:] or v))}
                 for k, v in read_s.items()}
        for k, v in write_s.items():
            rates[k]["updates"] = 1024 * calls / sum(v)
            rates[k]["write_p50_ms"] = 1e3 * float(np.median(v))
        out["ycsb_a"] = {"calls": calls, "rows_found": found, **rates}
        last_keys = keys_of(ids)
        log(f"tserver YCSB-A over the wire: {calls} multi_read calls of 1024 "
            f"rows ({found} found) == the device-free server's, "
            f"{rates['card']['reads'] or 0:,.0f} rows/s on the card vs "
            f"{rates['free']['reads'] or 0:,.0f} (the cold first call "
            f"{rates['card']['cold_first_call_s']:.2f} s); {calls} writes of "
            f"1024 updates, {rates['card']['updates']:,.0f} updates/s vs "
            f"{rates['free']['updates']:,.0f}, equal hybrid times; launches "
            f"{_nonzero(launches['tserver_reads'])} [{card}]")

        # -- 2: the pushdown and a filtered row scan on the lineitem tablet
        q6 = [["l_shipdate", ">=", D_1994_01_01],
              ["l_shipdate", "<", D_1995_01_01],
              ["l_discount", ">=", 5], ["l_discount", "<=", 7]]
        q6_aggs = [["count", None], ["sum", "l_extendedprice"]]
        _zero(wrappers)
        t0 = time.time()
        full = scan("card", filters=q6, aggregates=q6_aggs)
        sync()
        out["q6_full_s"] = time.time() - t0
        launches["tserver_q6_full"] = _launches_of(wrappers)
        # the multi-source route over the tablet's 4 SSTs: G once, H and
        # I.1 on the key and the value columns, B, J.1, J.2, then K (or
        # J.3 for rows)
        multi = {"radix_sort": 1, "staged_concat": 2, "sorted_payload": 2,
                 "gc_pack": 1, "row_flags": 1, "segment_or": 1}
        exact_launches(launches["tserver_q6_full"],
                       {**multi, "agg_reduce": 1},
                       "tserver q6 over the whole tablet")
        ref = push_out["q6_agg"]["answer"]
        if "agg" not in full or {"rows": full["agg"]["rows"], "cols": {
                str(c): v for c, v in full["agg"]["cols"].items()}} != ref:
            raise AssertionError(f"tserver q6: {full} != the pushdown "
                                 f"phase's {ref}")
        lo, hi = doc_key_bounds(Partition(b"\x20\x00", b"\x24\x00"), True)
        price = li_schema.column_id("l_extendedprice")

        def q6_range(sid):
            ans = scan(sid, filters=q6, aggregates=q6_aggs,
                       lower_doc_key=lo, upper_doc_key=hi)
            if "agg" in ans:
                a = ans["agg"]
                return a["rows"], a["cols"][price]["sum"]
            vals = [r["columns"].get(price) for r in ans["rows"]]
            return len(ans["rows"]), sum(v for v in vals if v is not None)
        _zero(wrappers)
        (q6_rows, q6_sum), q6_s = both("q6 over a 64th of the hash space",
                                       q6_range)
        launches["tserver_q6_range"] = _launches_of(wrappers)
        rows_filter = [["l_quantity", "<", 24], ["l_discount", "!=", 6],
                       ["l_shipdate", ">=", D_1998_08_01]]
        _zero(wrappers)
        routed = {}

        def filtered(sid):
            ans = scan(sid, filters=rows_filter, lower_doc_key=lo,
                       upper_doc_key=hi)
            routed[sid] = ans.pop("pushdown")
            return ans
        frows, filter_s = both("filtered row scan over a 64th", filtered)
        launches["tserver_filter_rows"] = _launches_of(wrappers)
        if not routed["card"] or routed["free"]:
            raise AssertionError(f"tserver filtered scan routes {routed}")
        exact_launches(launches["tserver_q6_range"],
                       {**multi, "agg_reduce": 1}, "tserver q6 over a 64th")
        exact_launches(launches["tserver_filter_rows"],
                       {**multi, "row_pass_pack": 1},
                       "tserver filtered row scan")
        out["scan"] = {"q6_full": full["agg"], "q6_range": [q6_rows, q6_sum],
                       "q6_range_s": q6_s, "filter_rows": len(frows["rows"]),
                       "filter_s": filter_s}
        log(f"tserver scans: q6 over the whole lineitem tablet on the card "
            f"{out['q6_full_s']:.3f} s == the pushdown phase's oracle; q6 "
            f"over a 64th ({q6_rows} rows, sum {q6_sum}) and the filtered "
            f"row scan ({len(frows['rows'])} rows) == the device-free "
            f"server's ({q6_s['card']:.3f} s vs {q6_s['free']:.3f}, "
            f"{filter_s['card']:.3f} vs {filter_s['free']:.3f}); launches "
            f"{_nonzero(launches['tserver_q6_full'])}, "
            f"{_nonzero(launches['tserver_q6_range'])}, "
            f"{_nonzero(launches['tserver_filter_rows'])} [{card}]")

        # -- 3: flush, then the maintenance manager's compaction
        _zero(wrappers)
        _, flush_s = both("flush_tablet", lambda sid: call(
            sid, "flush_tablet", tablet_id="usertable"))
        launches["tserver_flush"] = _launches_of(wrappers)
        exact_launches(launches["tserver_flush"], {}, "tserver flush")
        files = same_dir_bytes(db_of("card").db_dir, db_of("free").db_dir,
                               "tserver flush")
        dev, nat = db_of("card"), db_of("free")
        pick = compaction.pick_universal(dev.versions.live_files())
        ns = [fm.props.n_entries for fm in pick.inputs]
        misses = sum(not dev._device_cache.contains(fm.file_id)
                     for fm in pick.inputs)
        before = dev.n_live_files
        _zero(wrappers)
        secs = {}
        picked = {}
        for sid in ("card", "free"):
            t0 = time.time()
            picked[sid] = servers[sid].maintenance_manager.run_once()
            if servers[sid].exec_context is not None:
                servers[sid].exec_context.pool.wait_idle()
            sync()
            secs[sid] = time.time() - t0
            if sid == "card":
                launches["tserver_compact"] = _launches_of(wrappers)
        if picked != {"card": "compact:usertable",
                      "free": "compact:usertable"}:
            raise AssertionError(f"tserver maintenance picked {picked}")
        outs = dev.n_live_files - (before - len(ns))
        k_pad, _m = run_merge._layout(ns)
        exact_launches(launches["tserver_compact"], {
            "merge_path_level": k_pad.bit_length() - 1, "gc_pack": 1,
            "block_decode": misses, "survivor_scan": 1, "staged_concat": 1,
            "span_gather": outs, "block_encode": outs, "index_fit": outs},
            "tserver compact")
        out["compact"] = {
            "rows_in": sum(ns), "inputs": len(ns), "outputs": outs,
            "cache_misses": misses, "flush_files": files,
            "flush_s": flush_s, "seconds": secs,
            "rows_per_s": {k: sum(ns) / v for k, v in secs.items()},
            **same_db_files(dev, nat, "tserver compact"),
            "manifest_edits": same_manifest(dev, nat, "tserver compact")}
        log(f"tserver flush ({files} files byte for byte) and the "
            f"maintenance manager's compact:usertable: {sum(ns)} rows in "
            f"{len(ns)} files ({misses} cache misses) -> {outs}, "
            f"{out['compact']['rows_per_s']['card']:,.0f} rows/s on the card "
            f"vs {out['compact']['rows_per_s']['free']:,.0f} native; data "
            f"files byte for byte, MANIFEST edit for edit; launches "
            f"{_nonzero(launches['tserver_compact'])} [{card}]")

        # -- 4: a bounded PrewarmKernelsOp on the card server
        board = health_board()
        shape = (2, 1 << 16, 4, 8)
        op = PrewarmKernelsOp(shapes=[shape], enabled_fn=lambda: True,
                              device=ctx.device)
        mm = servers["card"].maintenance_manager
        mm.register_op(op)
        _zero(wrappers)
        t0 = time.time()
        try:
            name = mm.run_once()
        finally:
            mm.unregister_op(op)
        sync()
        out["prewarm_s"] = time.time() - t0
        launches["tserver_prewarm"] = _launches_of(wrappers)
        rec = [k for k in board.snapshot()["keys"]
               if k["family"] == "run_merge_fused"
               and tuple(k["bucket"]) == shape[:2]]
        if name != "prewarm_kernels" or not op.done or not rec \
                or not rec[0]["prewarmed"]:
            raise AssertionError(f"tserver prewarm: picked {name}, board "
                                 f"{rec}")
        # A and B once per is_major variant at the one bucket; the
        # point-read family over its declared buckets (ops/point_read.
        # prewarm_point_read: P1 + P2, P3 + the fold with the model off
        # and on, P4)
        exact_launches(launches["tserver_prewarm"], {
            "merge_path_level": 2, "gc_pack": 2, "hash_probe_files": 8,
            "locate_fold": 16, "index_fit": 4}, "tserver prewarm")
        log(f"tserver prewarm: run_once picked prewarm_kernels, "
            f"{out['prewarm_s']:.3f} s; bucket {shape[:2]} "
            f"{rec[0]['state']}, prewarmed; launches "
            f"{_nonzero(launches['tserver_prewarm'])} [{card}]")

        # -- 5: remote bootstrap into a third server; it joins and leads
        t0 = time.time()
        new_server("card2", with_tablets=False)
        src, dst = servers["card"], servers["card2"]
        src.update_addr_map({"card2": dst.address})
        dst.update_addr_map({"card": src.address})
        t1 = time.time()
        client.call(dst.address, "tserver", "start_remote_bootstrap",
                    timeout_s=600.0, tablet_id="usertable",
                    source_addr=src.address)
        boot_s = time.time() - t1
        call("card", "change_config", tablet_id="usertable", add=["card2"])
        lead = src.tablet_manager.get_tablet("usertable")
        rep = dst.tablet_manager.get_tablet("usertable")
        _wait(lambda: len(rep.raft.config.peer_ids) == 2
              and rep.raft.last_applied >= lead.raft.commit_index,
              "card2 to join and catch up")
        rep.raft.start_election(ignore_lease=True)
        _wait(lambda: rep.raft.is_leader() and rep.raft.leader_ready()
              and rep.raft.has_leader_lease(), "card2 to lead")
        join_s = time.time() - t1
        files2 = same_live_bytes(db_of("card"), rep.tablet.regular_db,
                                 "tserver remote bootstrap")
        _zero(wrappers)
        got2 = client.call(dst.address, "tserver", "multi_read",
                           tablet_id="usertable", doc_keys=last_keys)["rows"]
        sync()
        launches["tserver_bootstrap_reads"] = _launches_of(wrappers)
        exact_launches(launches["tserver_bootstrap_reads"], {
            "hash_probe_files": 3, "locate_fold": 3},
            "tserver reads on the bootstrapped replica")
        want = call("free", "multi_read", tablet_id="usertable",
                    doc_keys=last_keys)["rows"]
        if got2 != want or None in want:
            raise AssertionError("tserver: the bootstrapped replica's reads "
                                 "differ from the device-free server's")
        out["bootstrap"] = {"files": files2, "download_and_open_s": boot_s,
                            "join_and_lead_s": join_s,
                            "with_server_start_s": time.time() - t0}
        log(f"tserver remote bootstrap: the compacted usertable ({files2} "
            f"files, byte for byte) into card2 in {boot_s:.3f} s, joined "
            f"and elected {join_s:.3f} s after the start; its 1024 reads "
            f"== the device-free server's; launches "
            f"{_nonzero(launches['tserver_bootstrap_reads'])} [{card}]")

        # -- 6: the card server's pages over HTTP
        pages = {}
        for page in ("/healthz", "/compactionz", "/servez"):
            with urllib.request.urlopen(
                    f"http://{src.webserver.address}{page}",
                    timeout=60) as r:
                pages[page] = json.loads(r.read())
        fams = {k["family"] for k in pages["/healthz"]["bucket_health"]
                ["keys"]}
        cz, sz = pages["/compactionz"], pages["/servez"]
        if pages["/healthz"]["status"] != "ok" or "run_merge_fused" not in \
                fams or not cz["point_reads"]["batches"] or "scans" not in \
                cz or "device_cache" not in cz or "pipeline" not in cz or \
                not sz["point_reads"]["batches"]:
            raise AssertionError(f"tserver pages: {sorted(fams)}, "
                                 f"{sorted(cz)}, {sorted(sz)}")
        out["pages"] = {"healthz_families": sorted(fams),
                        "compactionz_keys": sorted(cz),
                        "point_read_batches": cz["point_reads"]["batches"],
                        "device_cache_entries": cz["device_cache"]["entries"]}
        log(f"tserver pages: /healthz names {sorted(fams)}; /compactionz "
            f"{cz['point_reads']['batches']} point-read batches, "
            f"{cz['device_cache']['entries']} resident entries; /servez "
            f"the serve path [{card}]")
        if ctx.device_cache.pinned_count():
            raise AssertionError("tserver: pins left")
    finally:
        client.shutdown()
        for ts in servers.values():
            ts.shutdown()
        for name in pinned:
            flags.reset_flag(name)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    out["seconds"] = time.time() - t_phase
    log(f"tserver phase: {out['seconds']:.1f}s [{card}]")
    return out, launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=10_000_000,
                    help="tablet rows")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sf-orders", type=int, default=SF1_ORDERS,
                    help="TPC-H orders generated before the lineitem "
                    "tablet keeps its hash half (1,500,000 = SF1)")
    ap.add_argument("--chunk-rows", type=int, default=1 << 20,
                    help="YBTPU_MERGE_CHUNK_ROWS of the chunked jobs")
    ap.add_argument("--skew-rows", type=int, default=65_536,
                    help="rows of each L0 run of the skewed pick")
    ap.add_argument("--wave-rows", type=int, default=131_072,
                    help="rows of each of the 4 L0 runs of each of the "
                    "pool wave's 8 tablets (and of each of the db "
                    "phase's 8 pool DBs)")
    ap.add_argument("--point-reads", type=int, default=131_072,
                    help="YCSB-C reads above every write; the mid-time, "
                    "exact-mode and lineitem read sets take a quarter "
                    "each")
    ap.add_argument("--tablet-ops", type=int, default=16_384,
                    help="YCSB-A reads and as many updates through the "
                    "tablet phase's Tablet.multi_read / Tablet.write")
    ap.add_argument("--consensus-ops", type=int, default=16_384,
                    help="YCSB-A reads and as many updates through the "
                    "consensus phase's leader (TabletPeer.multi_read / "
                    "TabletPeer.write)")
    ap.add_argument("--tserver-ops", type=int, default=16_384,
                    help="YCSB-A reads and as many updates through the "
                    "tserver phase's `tserver` service over the wire "
                    "(multi_read / write)")
    ap.add_argument("--fault-rows", type=int, default=1_000_000,
                    help="rows of the faults phase's decay and rate-race "
                    "tablet (the YCSB-A generator, cut in rows only)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from yugabyte_tpu_torch.common.hybrid_time import HybridTime
        from yugabyte_tpu_torch.utils import native_build
    except ImportError as e:
        print(f"chip_smoke: the port is not next to this script: {e}",
              file=sys.stderr)
        return 2
    t_start = time.time()
    card = card_line()
    print(f"card: {card}", flush=True)
    # the timed phases run with the sampled shadow verifier off, as PRs
    # 1-17 ran them (the port had none), so their rates stay comparable;
    # the faults phase turns it on where it measures it
    from yugabyte_tpu_torch.storage import integrity  # noqa: F401 (flags)
    from yugabyte_tpu_torch.utils import flags
    flags.set_flag("shadow_verify_sample", 0.0)
    log("shadow_verify_sample pinned to 0 for the timed phases")
    # the mesh paths take a job of distributed_compaction_min_rows (2^20)
    # or more: below that --rows the threshold comes down to the smaller
    # of --rows and the skewed pick's L0 rows, so every mesh job still
    # routes to the mesh (at the default 10M rows it stands)
    from yugabyte_tpu_torch.storage import compaction  # noqa: F401 (flags)
    # the resident chain's L1->L2 step takes two L0->L1 outputs: every job
    # splits its files at a quarter of --rows where that is below the
    # default (2M), so a 4-run major compaction over a key space of
    # rows/2 (about 0.41 rows out) writes at least two (one setting for
    # the whole run: the skewed pick's base file is the chain's L1 file)
    max_out = flags.get_flag("compaction_max_output_entries_per_sst")
    if args.rows // 4 < max_out:
        flags.set_flag("compaction_max_output_entries_per_sst",
                       max(1, args.rows // 4))
        log(f"--rows {args.rows}: compaction_max_output_entries_per_sst "
            f"{max_out} lowered to {max(1, args.rows // 4)}")
    # the chunked jobs cut the staged tablet (about 2^bit_length lanes)
    # into chunks of --chunk-rows: at most an eighth of it, so a small
    # --rows still gives several chunks (at 10M rows 2^20 stands)
    chunk_rows = min(args.chunk_rows,
                     max(1024, (1 << (args.rows.bit_length() - 1)) // 8))
    if chunk_rows != args.chunk_rows:
        log(f"--rows {args.rows}: --chunk-rows {args.chunk_rows} lowered "
            f"to {chunk_rows}")
        args.chunk_rows = chunk_rows
    min_rows = flags.get_flag("distributed_compaction_min_rows")
    if args.rows < min_rows:
        flags.set_flag("distributed_compaction_min_rows",
                       min(args.rows, 4 * args.skew_rows))
        log(f"--rows {args.rows} < distributed_compaction_min_rows "
            f"{min_rows}: lowered to "
            f"{flags.get_flag('distributed_compaction_min_rows')}")
    no_fallbacks("start")
    name = torch.cuda.get_device_name(0)
    bandwidth = next(bw for key, bw in _BANDWIDTH if key in name) \
        if any(key in name for key, _ in _BANDWIDTH) else 3.35e12

    t0 = time.time()
    built = native_build.build_all(cuda=True)
    for src, text in built.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"{src}: {line.strip()}")
    log(f"built {sorted(built)} in {time.time() - t0:.1f}s")

    t0 = time.time()
    runs = synth_ycsb_runs(args.rows, 4, max(1, args.rows // 2), args.seed)
    log(f"generated {args.rows} rows in 4 runs in {time.time() - t0:.1f}s")
    a, b = kernel_phase(args, runs, bandwidth)

    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        comp, launches, tensors, readers = compaction_phase(
            runs, workdir, args.reps, bandwidth)
        codec_rows = codec_kernel_phase(args, tensors, launches["codec"],
                                        bandwidth)
        del tensors
        torch.cuda.empty_cache()
        no_fallbacks("compaction")
        chain_out, chain_launches, chain_state = resident_chain_phase(
            args, runs, readers, workdir, card)
        del runs
        no_fallbacks("resident chain")
        chunk_out, launches["chunked"], kin, base_file = chunked_phase(
            args, readers, workdir)
        no_fallbacks("chunked jobs")
        chunk_rows = chunk_kernel_phase(args, kin, launches["chunked"],
                                        bandwidth)
        errs_chunked = chunk_merge_check(kin)
        del kin
        torch.cuda.empty_cache()
        chunk_out["skewed"], launches["skewed"], errs_skewed, skew_paths = \
            skewed_phase(args, base_file, workdir)
        chain_out["skewed"], chain_launches["skewed_resident"] = \
            resident_skewed_phase(args, chain_state, skew_paths, workdir,
                                  card)
        del chain_state
        torch.cuda.empty_cache()
        no_fallbacks("skewed pick")
        mesh_out, mesh_launches, mesh_kin = mesh_phase(
            args, readers, skew_paths, workdir, comp, card)
        launches.update(mesh_launches)
        mesh_rows, mesh_out["exchange"], mesh_out["routing"] = \
            mesh_kernel_phase(args, mesh_kin, launches["mesh_job"],
                              bandwidth)
        del mesh_kin
        torch.cuda.empty_cache()
        no_fallbacks("mesh")
        faults_out = faults_phase(args, readers, workdir, card, comp)
        torch.cuda.empty_cache()
        scan_out, launches["scan"], launches["range_scan"], read_ht = \
            scan_phase(readers, args.rows)
        stages, scan_tensors = scan_breakdown(readers, read_ht)
        log("seq-scan stages, one after the other: " + ", ".join(
            f"{k} {v:.3f}" for k, v in stages.items()))
        if stages["rows"] != scan_out["rows"]:
            raise AssertionError("the stage breakdown drained another row "
                                 "count than the seq-scan")
        scan_out["stages"] = stages
        scan_rows = scan_kernel_phase(args, scan_tensors, launches["scan"],
                                      launches["codec"], bandwidth, args.rows,
                                      launches["range_scan"])
        del scan_tensors, readers
        torch.cuda.empty_cache()
        no_fallbacks("scan")
        push_out, launches["pushdown"], slabs, (top_ht, _mid) = \
            pushdown_phase(args, workdir)
        queries = pushdown_queries(lineitem_schema())
        push_t = {}
        for qname in ("q6_agg", "filter_rows"):
            mode, spec = queries[qname]
            stages, answer, push_t[qname] = pushdown_breakdown(
                slabs, top_ht, spec, mode)
            want = push_out[qname]
            if (answer["rows"] != want["answer"]["rows"] if mode ==
                    "aggregate" else len(answer) != want["entries_out"]):
                raise AssertionError(f"{qname}: the stage breakdown's "
                                     f"answer differs from the query's")
            want["stages"] = stages
            log(f"{qname} stages, one after the other: " + ", ".join(
                f"{k} {v:.4f}" for k, v in stages.items()))
        chain_out["pushdown"], push_launches = resident_pushdown_phase(
            args, workdir, slabs, push_out, top_ht, card)
        for qname, counts in push_launches.items():
            chain_launches[f"resident_{qname}"] = counts
        no_fallbacks("pushdown")
        faults_out["pushdown"] = pushdown_fault_phase(slabs, top_ht,
                                                      push_out, card)
        del slabs
        torch.cuda.empty_cache()
        push_rows, h_vals = pushdown_kernel_phase(
            args, push_t["q6_agg"], push_t["filter_rows"],
            launches["pushdown"], bandwidth)
        del push_t
        torch.cuda.empty_cache()
        point_out, launches["point"], ydb, ldb, (chunk, top, li_chunk) = \
            point_read_phase(args, workdir, os.path.join(workdir, "lineitem"))
        t_pt = {}
        for what, db, keys, read_ht in (
                ("ycsb", ydb, chunk, top),
                ("lineitem", ldb, li_chunk, HybridTime.kMax)):
            stages, answer, t_pt[what] = point_breakdown(db, keys, read_ht)
            if answer != db.multi_get(keys, read_ht):
                raise AssertionError(f"{what}: the stage breakdown's "
                                     f"answers differ from multi_get's")
            point_out[f"{what}_stages"] = stages
            log(f"{what} chunk stages, one after the other: " + ", ".join(
                f"{k} {v}" for k, v in stages.items()))
        point_rows = point_kernel_phase(args, t_pt["ycsb"],
                                        t_pt["lineitem"], launches["point"],
                                        bandwidth)
        latency_floors(point_rows, [chunk_rows[0], mesh_rows[0]])
        del t_pt
        no_fallbacks("point reads")
        faults_out["point_read"] = point_fault_phase(ydb, chunk, top, card)
        ydb.close()
        ldb.close()
        torch.cuda.empty_cache()
        reset_fault_base()
        db_out, db_launches = db_phase(args, workdir, card, push_out, top_ht)
        no_fallbacks("db")
        tablet_out, tablet_launches, (seed, now_us) = tablet_phase(
            args, workdir, card, push_out, top_ht)
        no_fallbacks("tablet")
        consensus_out, consensus_launches = consensus_phase(
            args, workdir, card, seed, now_us)
        no_fallbacks("consensus")
        tserver_out, tserver_launches = tserver_phase(
            args, workdir, card, seed, now_us, push_out, top_ht)
        no_fallbacks("tserver")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for entry in (a, b):
        entry["launches"] = launches["codec"][entry["name"]]
        entry["launches_shell_path"] = launches["shell"][entry["name"]]
    b["launches_scan"] = launches["scan"]["gc_pack"]
    b["launches_pushdown"] = launches["pushdown"]["gc_pack"]
    for entry in scan_rows:
        entry["launches_pushdown"] = launches["pushdown"][entry["name"]]
        if entry["name"] == "staged_concat":
            entry["vals"] = h_vals
    for entry in [a, b] + codec_rows + chunk_rows + scan_rows + mesh_rows:
        for path in ("mesh_job", "mesh_python", "pool_wave"):
            entry[f"launches_{path}"] = launches[path][entry["name"]]
    for entry in [a, b] + codec_rows + scan_rows:
        name_k = entry["name"]
        entry["launches_chunked_job"] = launches["chunked"][name_k]
        entry["launches_skewed_job"] = launches["skewed"][name_k]
        # A, B and H (the parent payload) at the chunks' shapes; G, I.1
        # and B at the skewed pick's
        for tag, errs in (("chunked", errs_chunked),
                          ("skewed", errs_skewed)):
            if name_k in errs:
                entry[f"max_abs_err_{tag}"] = errs[name_k]
                entry["max_abs_err"] = max(entry["max_abs_err"],
                                           errs[name_k])
    for entry in ([a, b] + codec_rows + chunk_rows + mesh_rows + scan_rows
                  + push_rows + point_rows):
        # launches per resident-chain job (kernels that job can run)
        for tag, counts in chain_launches.items():
            if entry["name"] in counts:
                entry[f"launches_chain_{tag}"] = counts[entry["name"]]
        # launches per part of the DB, the tablet, the consensus and the
        # tserver phases (their entry points)
        for tag, counts in {**db_launches, **tablet_launches,
                            **consensus_launches,
                            **tserver_launches}.items():
            if entry["name"] in counts:
                entry[f"launches_{tag}"] = counts[entry["name"]]
    summary = {"card": card, "kernel_rows": args.rows, "compaction": comp,
               "resident_chain": chain_out,
               "chunked": chunk_out, "mesh": mesh_out, "scan": scan_out,
               "pushdown": push_out,
               "point_read": point_out, "faults": faults_out, "db": db_out,
               "tablet": tablet_out, "consensus": consensus_out,
               "tserver": tserver_out,
               "seconds": time.time() - t_start}
    print("summary: " + json.dumps(summary), flush=True)
    print(json.dumps({"kernels": [a, b] + codec_rows + chunk_rows
                      + mesh_rows + scan_rows + push_rows + point_rows}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
