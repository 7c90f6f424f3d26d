#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (yugabyte_tpu_torch) on one GPU.

Drives the port's main path — disk-to-disk L0->L1 compaction of a YCSB-A
tablet through `storage.compaction.run_compaction_job_device_native` —
and holds every CUDA kernel of that path against its plain PyTorch
version and the native C++ heap-merge oracle. Imports nothing of JAX.

Phases (any failure exits non-zero):
  1. name the card (nvidia-smi name and power limit);
  2. build the CUDA kernels (nvcc, sm_90a) and the native shell (g++),
     one compiler process per source, all started together;
  3. kernels at the main path's shapes: a 10M-row YCSB-A tablet in 4
     sorted L0 runs (key space n/2, 5% row tombstones, 19-byte column keys
     -> w = 8, cutoff above all writes, major compaction): m = 2^22,
     k_pad = 4, n_pad = 2^24. Kernel A (merge-path level) == its plain
     version at each level; kernel B (GC + packing) == its plain version
     (packed buffer, perm, keep, make-tombstone); decisions == the C++
     oracle compact_cpu_baseline. Times with CUDA events;
  4. compaction: the 4 runs written as SST files; the port's job and the
     stock native CompactionJob over the same inputs must write
     byte-identical files; the kernels' launch counters, zeroed just
     before the port's job, must have risen; then the job's stages run
     one after the other for a time breakdown;
  5. a `kernels` JSON line, the card line, and last
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
    """Seconds of each stage of the device job's path, run one after the
    other (the job overlaps the shell's ingest with stages 1-3): read the
    inputs' columns, upload them, re-lay them run-major, the merge levels
    (kernel A), GC + packing (kernel B), and the download + host decode of
    the packed decisions. Host clock, each stage ended by a synchronize."""
    import torch
    from yugabyte_tpu_torch.ops import merge_gc, run_merge

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

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


def compaction_phase(runs, workdir, device="cuda"):
    import torch
    from yugabyte_tpu_torch.ops import merge_gc, merge_path
    from yugabyte_tpu_torch.storage import compaction

    cutoff = history_cutoff(sum(s.n for s in runs))
    in_dir = os.path.join(workdir, "in")
    os.makedirs(in_dir)
    t0 = time.time()
    readers = write_inputs(runs, in_dir)
    rows = sum(s.n for s in runs)
    log(f"wrote {len(readers)} input SSTs ({rows} rows) in "
        f"{time.time() - t0:.1f}s")
    out = {}
    for name in ("device", "native"):
        d = os.path.join(workdir, name)
        os.makedirs(d)
        ids = iter(range(1000, 100000))
        if name == "device":
            merge_path.merge_level.launches = 0
            merge_gc.gc_pack.launches = 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            res = compaction.run_compaction_job_device_native(
                readers, d, lambda: next(ids), cutoff, True, device=device)
            torch.cuda.synchronize()
            secs = time.time() - t0
            launches = {"merge_path_level": merge_path.merge_level.launches,
                        "gc_pack": merge_gc.gc_pack.launches}
            peak = torch.cuda.max_memory_allocated()
        else:
            t0 = time.time()
            res = compaction._run_native_job(readers, d, lambda: next(ids),
                                             cutoff, True, False, None)
            secs = time.time() - t0
        out[name] = (res, secs)
        log(f"{name} job: {res.rows_in} -> {res.rows_out} rows, "
            f"{len(res.outputs)} files, {secs:.2f}s "
            f"({res.rows_in / secs:,.0f} rows/s)")
    dev, nat = out["device"][0], out["native"][0]
    if (dev.rows_in, dev.rows_out) != (nat.rows_in, nat.rows_out) \
            or len(dev.outputs) != len(nat.outputs) or not dev.outputs:
        raise AssertionError("device and native jobs disagree on rows/files")
    for (_, pd, _), (_, pn, _) in zip(dev.outputs, nat.outputs):
        for suffix in ("", ".sblock.0"):
            with open(pd + suffix, "rb") as f1, open(pn + suffix, "rb") as f2:
                if f1.read() != f2.read():
                    raise AssertionError(f"output {os.path.basename(pd)}"
                                         f"{suffix} differs from native")
    log("output SSTs byte-identical to the native CompactionJob")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched by the "
                                 f"main path")
    stages = stage_breakdown(readers, cutoff, device)
    log("device path stages, one after the other: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    return {"rows": rows, "device_s": out["device"][1],
            "native_s": out["native"][1],
            "device_rows_per_s": rows / out["device"][1],
            "native_rows_per_s": rows / out["native"][1],
            "rows_out": dev.rows_out, "files": len(dev.outputs),
            "device_peak_bytes": peak, "stages": stages,
            "launches": launches}


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
        comp = compaction_phase(runs, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    a["launches"] = comp["launches"]["merge_path_level"]
    b["launches"] = comp["launches"]["gc_pack"]
    summary = {"card": card, "kernel_rows": args.rows,
               "compaction": {k: v for k, v in comp.items()
                              if k != "launches"},
               "seconds": time.time() - t_start}
    print("summary: " + json.dumps(summary), flush=True)
    print(json.dumps({"kernels": [a, b]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
