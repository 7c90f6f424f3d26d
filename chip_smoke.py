#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (yugabyte_tpu_torch) on one GPU.

Drives the port's main paths over a YCSB-A tablet — disk-to-disk L0->L1
compaction through `storage.compaction.run_compaction_job_device_native`
on its default device-codec path and on its native-shell path
(YBTPU_DEVICE_CODEC=0), and the snapshot scan `ops.scan.
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
     its plain version at each level; kernel B (GC + packing) == its
     plain version; decisions == the C++ oracle compact_cpu_baseline.
     Times with CUDA events;
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
  6. the snapshot scan over the same 4 input SSTs: the full-tablet
     seq-scan (`ops.scan.visible_entries_sources` over
     SlabSource(read_all()), read time above every write, no bounds)
     drained and timed (rows, key + value bytes, MB/s), beside the native
     host reference `_visible_entries_host`; both walked in lockstep,
     entry for entry; a range scan at a read time inside the runs' span
     with a lower and a truncated upper bound, equal to the host
     reference. The scan must launch kernels G, H, I.1, B and I.2. Then
     its stages run one after the other for a time breakdown;
  7. kernels G-I (radix sort, staged concat, sorted payload, bound pack)
     at the seq-scan's shapes == their plain versions, timed beside their
     bounds and a PyTorch call that computes the same function;
  8. a `kernels` JSON line, the card line, and last
     {"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py [--rows N] [--seed S] [--reps R]
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
                    tombstone_frac: float = 0.05, value_bytes: int = 64):
    """YCSB-A-like tablet: n_runs sorted runs of row writes (the JAX
    package's bench.synth_ycsb_runs, copied). Key layout (DocDB encoding):
    root = 'S' 'user%08d' 00 00 '!' (16B); column write = root + 'K' +
    2B col id (19B); tombstones hit the row root.

    Run g's hybrid times are span*(g+1) + a permutation of its rows, with
    span = max(10^6, rows per run): the JAX package's formula up to 10^6
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
        ht = ((span * (g + 1) + rng.permutation(per_run))
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
         "bound_by": "bytes", "max_abs_err": 0, "levels": []}
    length = staged.m
    while length < n:
        out_k = merge_path.merge_level(p_k, length, staged.cmp_rows)
        out_p = merge_path.merge_level_plain(p_p, length, staged.cmp_rows)
        err = max_abs_err(out_k, out_p)
        if err:
            bad = int((out_k != out_p).any(dim=0).sum())
            raise AssertionError(f"kernel A != plain at L={length}: "
                                 f"{bad} columns differ")
        a["max_abs_err"] = max(a["max_abs_err"], err)
        ms = cuda_ms(lambda: merge_path.merge_level(p_k, length,
                                                    staged.cmp_rows),
                     args.reps)
        plain_ms = cuda_ms(lambda: merge_path.merge_level_plain(
            p_k, length, staged.cmp_rows), 2)
        lib_ms = cuda_ms(lambda: lexsort_level(p_k, length, staged.cmp_rows),
                         2)
        bound = 2 * rp * n * 4 / bandwidth * 1e3
        a["levels"].append({"L": length, "tile": merge_path.tile_for(
            len(merge_path.cmp_desc(staged.cmp_rows)[0]), length),
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound})
        a["ms"] += ms
        a["plain_ms"] += plain_ms
        a["library_ms"] += lib_ms
        a["bound_ms"] += bound
        log(f"kernel A L={length}: equal; {ms:.3f} ms (plain {plain_ms:.3f}, "
            f"lexsort {lib_ms:.3f}, bound {bound:.3f})")
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
    log(f"kernel B: equal; {b_ms:.3f} ms (plain {b_plain:.3f}, bound "
        f"{b['bound_ms']:.3f})")

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
            "bound_pack": scan.bound_pack}


# the kernels each path must launch
_PATH_KERNELS = {
    "shell": ("merge_path_level", "gc_pack", "staged_concat"),
    "codec": ("merge_path_level", "gc_pack", "block_decode", "survivor_scan",
              "span_gather", "block_encode", "staged_concat"),
    "scan": ("staged_concat", "radix_sort", "sorted_payload", "gc_pack",
             "bound_pack"),
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
          keep.numel() * 5, cuda_ms(lambda: torch.nonzero(keep), 2))

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


def counted(make_iter, wrappers, what):
    """Iterate make_iter() with every launch counter set to 0 just before;
    once it is drained, require the scan path's kernels to have launched
    (the device work runs before the first entry is yielded)."""
    for w in wrappers.values():
        w.launches = 0
    yield from make_iter()
    launches = {k: w.launches for k, w in wrappers.items()}
    check_launches(launches, "scan")
    log(f"{what}: launches {launches}")


def scan_phase(readers, n_rows, device="cuda"):
    """The snapshot scan path over the tablet's 4 input SSTs:

    1. full-tablet seq-scan: `visible_entries_sources` over
       SlabSource(read_all()) at a read time above every write, no bounds,
       drained; seconds from the first read_all to the drained iterator;
       every launch counter set to 0 just before and read just after;
    2. the same for the native host reference `_visible_entries_host`;
    3. both walked in lockstep (entry for entry), with the counters set to
       0 before that seq-scan too and every scan kernel required to launch;
    4. a range scan at a read time inside the runs' span, with a lower and
       a truncated upper bound, in lockstep with the host reference, its
       counters likewise set to 0 before and checked after (I.2's bounded
       mask runs on the card within the main run).
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
    check_launches(launches, "scan")
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
                wrappers, "seq-scan (lockstep)"),
        scan._visible_entries_host(slabs, read_ht, None, None), "seq-scan")
    log(f"seq-scan == host reference, entry for entry ({n} entries)")
    r_ht, lower, upper = scan_bounds(n_rows)
    t0 = time.time()
    n_range = entries_lockstep(
        counted(lambda: scan.visible_entries_sources(srcs, r_ht, lower,
                                                     upper, device=device),
                wrappers, "range scan"),
        scan._visible_entries_host(slabs, r_ht, lower, upper), "range scan")
    if n_range == 0:
        raise AssertionError("the range scan found no entry")
    out.update(range_rows=n_range, range_read_ht=r_ht,
               range_check_seconds=time.time() - t0)
    log(f"range scan at ht {r_ht >> 12} in [{lower!r}, {upper[:16]!r}...) "
        f"== host reference ({n_range} entries)")
    del srcs, slabs
    return out, launches, read_ht


def scan_breakdown(readers, read_ht, device="cuda"):
    """Seconds of each stage of the seq-scan, run one after the other with
    the same module functions, each ended by a synchronize: read_all, host
    pack + upload, kernel H (concat), kernel G (radix), kernels I.1 + B +
    I.2, the decisions down, the host drain. Returns the stages and the
    tensors the kernel phase checks G, H and I on."""
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
    _packed, keep, _mk = merge_gc.gc_pack(
        p_mat, merge_gc._ROW_WORDS + w, w, merge_gc.GCParams(read_ht, True),
        1, cat.n_pad, snapshot=True)
    zero = np.zeros(w, dtype=np.uint32)
    keep_p = scan.bound_pack(p_mat, keep, w, zero, 0, zero, 0, False, False)
    sync()
    out["gather_gc_mask_s"] = time.time() - t0
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


def scan_kernel_phase(args, t, launches, codec_launches, bandwidth, n_rows):
    """Kernels G, H, I.1 and I.2 against their plain versions at the
    seq-scan's shapes (max_abs_err must be 0, perm identical), timed with
    CUDA events beside their bounds and one PyTorch call that computes the
    same function (G: stable torch.sort per row on u32 keys; H: torch.cat
    plus the template fill; I.1: torch.index_select)."""
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

    entry("radix_sort", "radix.cu", "yugabyte_tpu/ops/merge_gc.py:181", err,
          cuda_ms(lambda: radix.radix_sort(cols, sched, len(sched)),
                  args.reps),
          cuda_ms(lambda: radix.radix_sort_plain(cols, sched, len(sched)), 2),
          (len(sched) + 1) * n * 4, cuda_ms(torch_sort_chain, 2),
          {"n_sort": len(sched), "rows": sched})

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
    entry("bound_pack", "scan.cu", "yugabyte_tpu/ops/scan.py:59", err,
          cuda_ms(lambda: scan.bound_pack(*args_i2), args.reps),
          cuda_ms(lambda: scan.bound_pack_plain(*args_i2), 2),
          bound_pack_bytes(p_mat, keep, w, lo_w, lo_l, hi_w, hi_l), None)
    return rows


def bound_pack_bytes(p_mat, keep, w, lo_w, lo_l, hi_w, hi_l) -> int:
    """Bytes kernel I.2 must move on these inputs: the keep bytes, and for
    each kept lane the key words up to the first that differs from each
    bound it is tested against (plus key_len where all are equal); the
    packed words out. The upper bound is tested only where the lower one
    passed."""
    import torch
    from yugabyte_tpu_torch.ops.merge_gc import _ROW_KEY_LEN, _ROW_WORDS, _u
    n = p_mat.shape[1]
    words = _u(p_mat[_ROW_WORDS:_ROW_WORDS + w])
    s_len = p_mat[_ROW_KEY_LEN].long()

    def cost(bw, blen):
        differs = words != torch.as_tensor(bw.astype(np.int64),
                                           device=words.device)[:, None]
        first = torch.where(differs.any(0), differs.int().argmax(0) + 1,
                            torch.full_like(s_len, w + 1))
        lt = torch.zeros(n, dtype=torch.bool, device=words.device)
        eq = torch.ones(n, dtype=torch.bool, device=words.device)
        for i in range(w):
            lt |= eq & (words[i] < int(bw[i]))
            eq &= words[i] == int(bw[i])
        lt |= eq & (s_len < blen)
        return first, lt

    k = keep.bool()
    first_lo, lt_lo = cost(lo_w, lo_l)
    first_hi, _ = cost(hi_w, hi_l)
    words_read = int((first_lo * k).sum()) + int((first_hi * (k & ~lt_lo))
                                                 .sum())
    return n + 4 * words_read + n // 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=10_000_000,
                    help="tablet rows")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
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
        del runs
        codec_rows = codec_kernel_phase(args, tensors, launches["codec"],
                                        bandwidth)
        del tensors
        torch.cuda.empty_cache()
        scan_out, launches["scan"], read_ht = scan_phase(readers, args.rows)
        stages, scan_tensors = scan_breakdown(readers, read_ht)
        log("seq-scan stages, one after the other: " + ", ".join(
            f"{k} {v:.3f}" for k, v in stages.items()))
        if stages["rows"] != scan_out["rows"]:
            raise AssertionError("the stage breakdown drained another row "
                                 "count than the seq-scan")
        scan_out["stages"] = stages
        scan_rows = scan_kernel_phase(args, scan_tensors, launches["scan"],
                                      launches["codec"], bandwidth, args.rows)
        del scan_tensors
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for entry in (a, b):
        entry["launches"] = launches["codec"][entry["name"]]
        entry["launches_shell_path"] = launches["shell"][entry["name"]]
    b["launches_scan"] = launches["scan"]["gc_pack"]
    summary = {"card": card, "kernel_rows": args.rows, "compaction": comp,
               "scan": scan_out, "seconds": time.time() - t_start}
    print("summary: " + json.dumps(summary), flush=True)
    print(json.dumps({"kernels": [a, b] + codec_rows + scan_rows}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
