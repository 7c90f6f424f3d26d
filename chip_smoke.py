#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (yugabyte_tpu_torch) on one GPU.

Drives the port's main paths over a YCSB-A tablet — disk-to-disk L0->L1
compaction through `storage.compaction.run_compaction_job_device_native`
on its default device-codec path and on its native-shell path
(YBTPU_DEVICE_CODEC=0), chunked and skewed picks through the router
`storage.compaction.run_compaction_job`, and the snapshot scan `ops.scan.
visible_entries_sources` — and holds every CUDA kernel of those paths
against its plain PyTorch version, the compaction decisions against the
native C++ heap-merge oracle and the scan against the native host scan.
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
  6. the snapshot scan over the same 4 input SSTs: the full-tablet
     seq-scan (`ops.scan.visible_entries_sources` over
     SlabSource(read_all()), read time above every write, no bounds)
     drained and timed (rows, key + value bytes, MB/s), beside the native
     host reference `_visible_entries_host`; both walked in lockstep,
     entry for entry; a range scan at a read time inside the runs' span
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
 10. a `kernels` JSON line, the card line, and last
     {"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py [--rows N] [--seed S] [--reps R]
       [--chunk-rows C] [--skew-rows L] [--wave-rows W] [--sf-orders M]
       [--point-reads K]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
    retries = dist_compact.dist_compact_overflow_retry_total
    t0 = time.time()
    res = fn()
    sync()
    secs = time.time() - t0
    return (res, secs, {k: w.launches for k, w in wrappers.items()},
            dist_compact.dist_compact_overflow_retry_total - retries)


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
    3. both walked in lockstep (entry for entry), with the counters set to
       0 before that seq-scan too and G, H, I.1 and B required to launch,
       I.2 not (the unbounded keep is plane 0 of B's packed buffer);
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
    n = entries_lockstep(
        counted(lambda: scan.visible_entries_sources(srcs, read_ht,
                                                     device=device),
                wrappers, "seq-scan (lockstep)", "scan"),
        scan._visible_entries_host(slabs, read_ht, None, None), "seq-scan")
    log(f"seq-scan == host reference, entry for entry ({n} entries)")
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
        out[name] = res
        log(f"{name}: equal to the host oracle; {secs:.3f}s "
            f"({res['rows_per_s']:,.0f} rows/s over {oracle.n_rows} visible "
            f"rows; oracle {t_assemble:.2f}s + {t_eval:.2f}s); peak "
            f"{peak} bytes; launches {res['launches']}")
    del oracles
    return out, totals, slabs, (top_ht, mid_ht)


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


def lineitem_point_db(lineitem_dir, workdir, device="cuda"):
    """The pushdown phase's 4 lineitem SSTs opened as a DB (hard links
    under file ids 1-4 and a manifest): SSTWriter fitted a learned index
    into each, so P3 runs its model mode here."""
    from yugabyte_tpu_torch.storage.db import DB
    from yugabyte_tpu_torch.storage.sst import SSTReader, data_file_name
    from yugabyte_tpu_torch.storage.version_set import VersionSet
    d = os.path.join(workdir, "lineitem_db")
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
    return DB(d, point_options(device))


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
    before = {k: m[k] for k in _POINT_COUNTERS}
    res, secs = [], []
    for s in range(0, len(keys), batch):
        t0 = time.time()
        res.extend(db.multi_get(keys[s:s + batch], read_ht))
        secs.append(time.time() - t0)
    launches = {k: w.launches for k, w in wrappers.items()}
    counters = {k: m[k] - v for k, v in before.items()}
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
    before = {k: m[k] for k in _POINT_COUNTERS}
    t0 = time.time()
    got = [db.multi_get(ks, top) for ks in small_keys]
    small_s = time.time() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    check_point_launches(launches, 32, files, "small calls")
    replay_per_file(db, small_keys, top,
                    {k: m[k] - v for k, v in before.items()}, "small calls")
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
    (resident at level 1, the same bytes as the skewed phase's base file)
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
    for suffix in ("", ".sblock.0"):
        with open(base_path + suffix, "rb") as f1, \
                open(skew_paths[0] + suffix, "rb") as f2:
            if f1.read() != f2.read():
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
    ap.add_argument("--wave-rows", type=int, default=262_144,
                    help="rows of each of the 4 L0 runs of each of the "
                    "pool wave's 8 tablets")
    ap.add_argument("--point-reads", type=int, default=262_144,
                    help="YCSB-C reads above every write; the mid-time, "
                    "exact-mode and lineitem read sets take a quarter "
                    "each")
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
        chain_out, chain_launches, chain_state = resident_chain_phase(
            args, runs, readers, workdir, card)
        del runs
        chunk_out, launches["chunked"], kin, base_file = chunked_phase(
            args, readers, workdir)
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
        mesh_out, mesh_launches, mesh_kin = mesh_phase(
            args, readers, skew_paths, workdir, comp, card)
        launches.update(mesh_launches)
        mesh_rows, mesh_out["exchange"], mesh_out["routing"] = \
            mesh_kernel_phase(args, mesh_kin, launches["mesh_job"],
                              bandwidth)
        del mesh_kin
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
        ydb.close()
        ldb.close()
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
    summary = {"card": card, "kernel_rows": args.rows, "compaction": comp,
               "resident_chain": chain_out,
               "chunked": chunk_out, "mesh": mesh_out, "scan": scan_out,
               "pushdown": push_out,
               "point_read": point_out, "seconds": time.time() - t_start}
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
