#!/usr/bin/env python3
"""Kernels A, B, D, G, H, I.2, J.1-J.3, K and M1-M3 of the PyTorch port,
the resident aggregates and the point read's P1-P4, timed for several
checkouts in one run on one GPU.

    python3 kernel_ab.py [--rows N] [--sf-orders M] [--seed S] [--reps R]
        [--only SECTION,...] ROOT [ROOT ...]

Each ROOT is a checkout of this repository (`.` for this one). Each is
timed in its own process, in the order given, so that two versions of a
kernel are compared on one card in turns (old, new, new, old). Every
process builds its checkout's kernels, stages the same YCSB-A tablet
(chip_smoke's generator: --rows rows in 4 sorted runs, key space rows/2),
and times with CUDA events, --reps launches after a warm-up, the
sections that --only names (default: all; `merge` is A-K, then `m3`
(M1-M3), `point`, `resident`):
  - kernel A (`merge_path.merge_level`) at each tournament level, its
    output held against the first process's (the same bytes everywhere);
  - kernel B (`merge_gc.gc_pack`) on the merged payload (the codec job's
    shape);
  - kernel D (`run_merge.survivor_scan`) on the merge's keep bytes, beside
    `torch.nonzero` on the same bytes;
  - kernel G (`radix.radix_sort`) over the tablet as one unsorted matrix
    (`stage_slab(concat_slabs(runs))`, the seq-scan's pruned schedule);
  - kernel H (`run_merge.staged_concat`): the 4 staged runs into one
    matrix, and a 2^17-lane window of each into one 2^19-lane chunk (the
    chunk carve's shape, where the wrapper's host work is the time);
  - kernel I.2 (`scan.bound_pack`) with the range scan's bounds
    (chip_smoke's `scan_bounds`, the upper one truncated) over the
    seq-scan's sorted payload and kernel B's snapshot keep;
  - kernel J.1 (`pushdown.row_flags`) over the same payload and keep, no
    bounds, one predicate slot and one aggregate slot on the column subkey
    and the sorted value words (`scan.pack_vals`, gathered by kernel I.1);
  - kernel J.2 (`pushdown.segment_or`) on J.1's flags, and on the same
    flags with every start but lane 0's cleared (one segment over every
    tile, whose writes fall to the last tile's CTA);
  - kernel K (`pushdown.agg_reduce`) with the aggregate slot over J.1's
    flags, J.2's output and the sorted value words;
  - kernel J.3 (`pushdown.row_pass_pack`) with the predicate slot over
    J.1's flags and J.2's output (2^24 lanes at 10M rows);
  - kernels M1 (`dist_compact.splitter_pick`), M2
    (`dist_compact.route_dest`) and M3 (`dist_compact.bucket_scatter`) at
    the mesh job's shapes (the tablet as one slab on 8 virtual shards of
    the card; M1 over the 8 shards' 512 gathered samples at w_route 4, M2
    over shard 0's 2^21 lanes with M1's splitters, M3 on M2's dest and
    counts at capacity factor 2: a [17, 2^22] send buffer at 10M rows);
  - the resident aggregates: q1_agg and q6_agg (chip_smoke's TPC-H
    lineitem tablet, --sf-orders, in 4 SSTs staged with their value words
    into a DeviceSlabCache) over `ResidentSource`s: the median wall time
    of --reps calls and the device time and launches of one call by
    kernel name, memsets and copies included;
  - the batched point read's device stage (`DB._device_chunk`: P1 + P2,
    then P3 with the newest-wins fold) on one warm 1024-key chunk over
    chip_smoke's YCSB point DB (--rows rows in 4 SSTs, exact mode) and
    over the lineitem SSTs opened as a DB (learned-index mode): the
    median wall time of --reps chunks (each ended by its downloads) and
    the device time and launches of one chunk by kernel name, with P1's,
    P2's, P1 + P2's and P3's summed (a checkout whose P1 runs in a launch
    of its own counts it apart; one whose P2 and P3 run per SST launches
    them once a file), and kernel P4 (`point_read.index_fit`, the
    learned-index fit) over each staged SST of the YCSB point DB;
  - for every wrapper, the host's milliseconds to enqueue one call, and
    the device's milliseconds and launches per call by kernel name
    (torch.profiler): where the enqueue takes longer than the device, the
    events time the host.
The outputs (A's levels, B's packed words, keep and make-tombstone bytes,
D's positions, H's matrices, G's perm, I.2's packed words, J.1's flag
words, J.2's outputs, K's accumulators, J.3's packed words, M1's
splitters, M2's dest and counts, M3's send
buffer and overflow word, the resident answers, the point read chunks'
folds, P4's answers) go into one sha256 that must match across the
checkouts. Prints one JSON line per process and the card's name and
power limit.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SECTIONS = ("merge", "m3", "point", "resident")


def host_ms(fn, reps: int) -> float:
    """Host milliseconds to enqueue one call (no synchronize inside)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e3


def device_ms(fn, reps: int, launches: bool = False) -> dict:
    """Device milliseconds per call by kernel (and memset) name, from
    torch.profiler's CUDA activity: one call before the profiler; inside
    it 512 one-element adds and one sacrificial call (a trace's first
    events can be lost: without the adds, a trace here kept 7 of 10 short
    calls), a marker kernel (`torch.cuda._sleep`), then `reps` timed
    calls inside a record_function range, whose device events are those
    that start after the marker; with `launches`, {name: [ms, launches
    per call]}. Kept here, not taken from the root's chip_smoke: an older
    checkout's chip_smoke has no such helper."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    fn()
    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(512):
            pad.add_(1)
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        with record_function("timed_calls"):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    events = prof.events()
    # the window starts at the marker on the device's timeline; without
    # one, at the range there, else on the host's (the host's clock and
    # the device's can disagree by more than a short call lasts)
    marks = [e.time_range.start for e in events
             if e.device_type == DeviceType.CUDA and "spin_kernel" in e.name]
    ranges = {e.device_type: e.time_range.start for e in events
              if e.name == "timed_calls"}
    t0 = max(marks) if marks else ranges.get(DeviceType.CUDA,
                                             ranges[DeviceType.CPU])
    out = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.time_range.start >= t0 \
                and e.name != "timed_calls" and "spin_kernel" not in e.name:
            ms, n = out.get(e.name[:80], (0.0, 0))
            out[e.name[:80]] = (ms + e.time_range.elapsed_us() / reps / 1e3,
                                n + 1)
    return {k: [ms, n / reps] if launches else ms
            for k, (ms, n) in out.items()}


def timed(fn, reps: int) -> dict:
    """Events, enqueue and profiler times of one wrapper call."""
    import chip_smoke as cs
    dev = device_ms(fn, reps, launches=True)
    return {"ms": cs.cuda_ms(fn, reps), "host_ms": host_ms(fn, reps),
            "device_ms": sum(v[0] for v in dev.values()),
            "device": dev}


def point_chunk(db, keys, read_ht, reps: int, digest) -> dict:
    """The device stage of one warm chunk (`DB._device_chunk`) over the
    DB's live SSTs: its fold into the digest, the median wall
    milliseconds of `reps` chunks, and the device milliseconds and
    launches of one chunk by kernel name, P2 ("bloom") and P3 ("locate")
    summed."""
    import torch
    db.multi_get(keys, read_ht)                  # stages every file
    staged_by = db._stage_live(list(db._readers.items()))

    def stage():
        return db._device_chunk(keys, None, read_ht, staged_by)
    best = stage()
    for x, dt in zip(best, (np.uint64, np.uint32, np.int64, np.int64,
                            np.bool_)):
        digest.update(np.ascontiguousarray(x, dtype=dt).tobytes())
    wall = []
    for _ in range(reps):
        t0 = time.perf_counter()
        stage()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    dev = device_ms(stage, reps, launches=True)
    out = {"files": len(staged_by), "hits": int(best[4].sum()),
           "wall_ms": statistics.median(wall), "device": dev}
    for tag, keys in (("p1", ("fnv64",)), ("p2", ("bloom",)),
                      ("p1_p2", ("fnv64", "bloom", "hash_probe")),
                      ("p3", ("locate",))):
        mine = [v for k, v in dev.items() if any(x in k for x in keys)]
        out[f"{tag}_device_ms"] = sum(v[0] for v in mine)
        out[f"{tag}_launches"] = sum(v[1] for v in mine)
    return out


def mesh_routing(runs, reps: int, digest) -> dict:
    """Kernels M1-M3 at the mesh job's shapes: the runs as one slab on 8
    virtual shards of the card (`stage_sharded_cols`), M1 over the
    shards' gathered samples, M2's dest and counts on shard 0 with M1's
    splitters, M3 on them at the job's capacity at factor 2. M1's
    splitters, M2's dest and counts, then M3's send buffer and overflow
    word, go into the digest."""
    import torch
    from yugabyte_tpu_torch.ops.slabs import concat_slabs
    from yugabyte_tpu_torch.parallel import dist_compact as dc
    from yugabyte_tpu_torch.parallel.mesh import make_mesh
    n_shards = 8
    mesh = make_mesh(n_shards, devices=["cuda"] * n_shards)
    cols, n_local = dc.stage_sharded_cols(concat_slabs(runs), mesh)
    w_route = min(dc._W_ROUTE, cols[0].shape[0] - 8)
    samp = dc._sample_matrix(cols, n_local, w_route, cols[0].device)

    def m1():
        return dc.splitter_pick(samp, w_route, n_shards)
    split = m1()
    digest.update(split.cpu().numpy().tobytes())
    m1_entry = dict(timed(m1, reps), samples=int(samp.shape[1]),
                    w_route=w_route)
    c0 = cols[0]
    del cols

    def m2():
        return dc.route_dest(c0, split, w_route, n_shards)
    dest, hist, real = m2()
    for x in (dest, hist, real):
        digest.update(x.cpu().numpy().tobytes())
    cap = dc._quantized_capacity(n_local, n_shards, 2.0)

    def m3():
        return dc.bucket_scatter(c0, dest, hist, real, cap, n_shards, 0)
    send, ovf = m3()
    digest.update(send.cpu().numpy().tobytes())
    digest.update(ovf.cpu().numpy().tobytes())
    del send, ovf
    out = {"splitter_pick": m1_entry,
           "route_dest": dict(timed(m2, reps), shard_lanes=n_local,
                              w_route=w_route),
           "bucket_scatter": dict(timed(m3, reps), shard_lanes=n_local,
                                  capacity=cap,
                                  send=[int(c0.shape[0]) + 1,
                                        n_shards * cap])}
    del c0, dest, hist, real
    torch.cuda.empty_cache()
    return out


def index_fits(db, reps: int, digest) -> list:
    """Kernel P4 (`point_read.index_fit`) over each staged SST of the DB
    (staged by point_chunk), in file order: its answer into the digest,
    then its times."""
    from yugabyte_tpu_torch.ops import point_read as pr
    out = []
    for fid in sorted(db._readers):
        st = db._device_cache.get(fid)

        def fit(st=st):
            return pr.index_fit(st.cols_dev, st.n, st.w)
        for x in fit():
            digest.update(x.cpu().numpy().tobytes())
        out.append(dict(timed(fit, reps), n=st.n, w=st.w))
    return out


def point_read(rows: int, seed: int, reps: int, digest) -> dict:
    """point_chunk over chip_smoke's YCSB point DB and a YCSB-C chunk of
    1024 scrambled-zipfian keys at the top read time (exact mode: the
    files of a 10M-row tablet carry no learned index)."""
    import types
    import chip_smoke as cs
    from yugabyte_tpu_torch.common.hybrid_time import HybridTime
    workdir = tempfile.mkdtemp(prefix="kernel_ab_pt_")
    try:
        args = types.SimpleNamespace(rows=rows, seed=seed, point_reads=4096)
        db, summary, top_ht, _mid = cs.ycsb_point_db(args, workdir, "cuda")
        rng = np.random.default_rng(seed + 70)
        keys = [bytes(k) for k in cs.ycsb_keys(cs.scrambled_zipfian(
            1024, summary["key_space"], rng))]
        out = point_chunk(db, keys, HybridTime(top_ht), reps, digest)
        out["index_fit"] = index_fits(db, reps, digest)
        db.close()
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def resident(sf_orders: int, seed: int, reps: int, digest) -> dict:
    """q1_agg and q6_agg over the lineitem SSTs as ResidentSources (see the
    module docstring): per query the median wall seconds of `reps` warm
    calls, the device milliseconds and launches of one call by kernel
    name, and the device's share of the call."""
    import torch
    import chip_smoke as cs
    from yugabyte_tpu_torch.ops import scan
    from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache

    rows = cs.lineitem_rows(sf_orders, seed)
    runs, top_ht, _mid = cs.lineitem_runs(rows, cs.lineitem_ops(rows, seed),
                                          seed)
    del rows
    workdir = tempfile.mkdtemp(prefix="kernel_ab_")
    try:
        readers = cs.write_inputs(runs, workdir)
        del runs
        cache = DeviceSlabCache("cuda", capacity_bytes=32 << 30)
        for i, r in enumerate(readers):
            cache.stage(i, r.read_all(), include_vals=True)
        srcs = [scan.ResidentSource(r, cache.get(i))
                for i, r in enumerate(readers)]
        queries = cs.pushdown_queries(cs.lineitem_schema())
        out = {}
        for q in ("q1_agg", "q6_agg"):
            spec = queries[q][1]

            def call():
                return scan.aggregate_sources(srcs, top_ht, spec,
                                              device="cuda")
            answer = call()
            digest.update(json.dumps(answer, sort_keys=True,
                                     default=str).encode())
            wall = []
            for _ in range(reps):
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                wall.append(time.perf_counter() - t0)
            dev = device_ms(call, 1, launches=True)
            dev_ms = sum(v[0] for v in dev.values())
            med = statistics.median(wall)
            out[q] = {"rows": answer["rows"], "median_s": med,
                      "wall_s": wall, "device_ms": dev_ms,
                      "device_share": dev_ms / 1e3 / med, "device": dev}
        for r in readers:
            r.close()
        del cache, srcs
        torch.cuda.empty_cache()
        # the same SSTs as a DB: the point read's learned-index mode
        from yugabyte_tpu_torch.common.hybrid_time import HybridTime
        li_db = cs.lineitem_point_db(workdir, workdir, "cuda")
        keys = cs.lineitem_point_keys(li_db, 1024, seed)
        out["point_read_lineitem"] = point_chunk(li_db, keys,
                                                 HybridTime.kMax, reps,
                                                 digest)
        li_db.close()
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def child(root: str, rows: int, seed: int, reps: int, sf_orders: int,
          only) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    runs = cs.synth_ycsb_runs(rows, 4, max(1, rows // 2), seed)
    digest = hashlib.sha256()
    out = {"root": root, "sections": sorted(only)}
    if "merge" in only:
        out.update(merge_kernels(runs, rows, reps, digest))
        torch.cuda.empty_cache()
    if "m3" in only:
        out.update(mesh_routing(runs, reps, digest))
    del runs
    if "point" in only:
        out["point_read"] = point_read(rows, seed, reps, digest)
        torch.cuda.empty_cache()
    if "resident" in only:
        out["resident"] = resident(sf_orders, seed, reps, digest)
    out["sha256"] = digest.hexdigest()
    return out


def merge_kernels(runs, rows: int, reps: int, digest) -> dict:
    """Kernels A, B, D, H, G, I.2, J.1, J.2, K and J.3 over the runs (see the
    module docstring); their outputs go into the digest."""
    import torch
    import chip_smoke as cs
    from yugabyte_tpu_torch.ops import (merge_gc, merge_path, pushdown,
                                       radix, run_merge, scan)
    from yugabyte_tpu_torch.ops.slabs import concat_slabs

    st = run_merge.stage_runs_from_slabs(runs, device="cuda")
    p = torch.cat([st.cols_dev, torch.arange(
        st.n_pad, dtype=torch.int32, device="cuda")[None]])
    levels = []
    length = st.m
    while length < st.n_pad:
        def level():
            return merge_path.merge_level(p, length, st.cmp_rows)
        entry = {"L": length, "ms": cs.cuda_ms(level, reps),
                 "host_ms": host_ms(level, reps),
                 "device_ms": device_ms(level, reps)}
        p = level()
        digest.update(p.cpu().numpy().tobytes())
        levels.append(entry)
        length *= 2
    r = merge_gc._ROW_WORDS + st.w
    params = merge_gc.GCParams(cs.history_cutoff(rows), True)

    def gc():
        return merge_gc.gc_pack(p, r, st.w, params, st.k_pad, st.m)
    packed, keep, mk = gc()
    for x in (packed, keep, mk):
        digest.update(x.cpu().numpy().tobytes())
    gc_entry = timed(gc, reps)
    pos = run_merge.survivor_scan(keep)
    digest.update(pos.cpu().numpy().tobytes())

    def survivors():
        return run_merge.survivor_scan(keep)
    out = {"rp": int(p.shape[0]), "n": int(p.shape[1]),
           "levels": levels, "gc_pack": gc_entry,
           "survivor_scan_ms": cs.cuda_ms(survivors, reps),
           "survivor_scan_host_ms": host_ms(survivors, reps),
           "survivor_scan_device_ms": device_ms(survivors, reps),
           "nonzero_ms": cs.cuda_ms(lambda: torch.nonzero(keep), reps),
           "kept": int(keep.sum())}
    del p, packed, keep, mk, pos, st
    torch.cuda.empty_cache()

    # kernel H: the 4 staged runs into one matrix (the scan's concat), and
    # windows of 2^17 lanes of each into a 2^19-lane chunk (the carve's
    # shape): for small calls the wrapper's host work is the time
    staged = [merge_gc.stage_slab(r, "cuda") for r in runs]
    parts = [x.cols_dev for x in staged]
    ns = [x.n for x in staged]
    rh = parts[0].shape[0]
    tmpl = merge_gc.pad_template(rh)
    offs = np.concatenate(([0], np.cumsum(ns)[:-1])).tolist()
    n_cat = merge_gc.bucket_size(sum(ns))
    m_c = 1 << 17

    def concat():
        return run_merge.staged_concat(parts, ns, offs, n_cat, tmpl)

    def carve():
        return run_merge.staged_concat(
            parts, [min(m_c, k) for k in ns],
            [i * m_c for i in range(len(parts))], len(parts) * m_c, tmpl)
    for fn in (concat, carve):
        digest.update(fn().cpu().numpy().tobytes())
    out["staged_concat"] = timed(concat, reps)
    out["staged_concat_window"] = timed(carve, reps)
    del staged, parts
    slab = concat_slabs(runs)
    del runs
    cat = merge_gc.stage_slab(slab, "cuda")
    sched = [int(x) for x in cat.sort_rows[:cat.n_sort]]

    def sort():
        return radix.radix_sort(cat.cols_dev, sched, len(sched))
    perm = sort()
    digest.update(perm.cpu().numpy().tobytes())
    out["radix_sort"] = dict(timed(sort, reps), rows=sched,
                             n=int(cat.cols_dev.shape[1]))

    # I.2 and J.1 over the seq-scan's sorted payload and B's snapshot keep
    w = cat.w
    s = radix.sorted_payload(cat.cols_dev, perm)
    _packed, keep, _mk = merge_gc.gc_pack(
        s, merge_gc._ROW_WORDS + w, w, params, 1, cat.n_pad, snapshot=True)
    _r_ht, lower, upper = cs.scan_bounds(rows)
    lo_w, lo_l = scan._pack_bound(lower, w)
    hi_w, hi_l = scan._pack_bound(upper[:4 * w], w)

    def i2():
        return scan.bound_pack(s, keep, w, lo_w, lo_l, hi_w, hi_l, True,
                               True, True)
    digest.update(i2().cpu().numpy().tobytes())
    out["bound_pack"] = timed(i2, reps)
    vals = merge_gc.u32_to_device(scan.pack_vals(slab, cat.n_pad), "cuda")
    sv = radix.sorted_payload(vals, perm)
    del vals, slab
    zero = np.zeros(w, dtype=np.uint32)
    bounds = (zero, 0, zero, 0, True, False)
    # one slot: the column subkey 'K' 00 00, payload > 0x4880.. under two
    # tags; one aggregate slot on the same column and tags
    p_ops = (np.array([0x4B0000], np.uint32), np.array([5], np.int32),
             np.zeros(1, np.int32), np.array([0x48], np.uint32),
             np.array([0x49], np.uint32),
             np.array([[0x48800000, 0, 0]], np.uint32),
             np.array([12], np.int32))
    a_ops = (np.array([0x4B0000], np.uint32), np.array([0x48], np.uint32),
             np.array([0x49], np.uint32))

    def j1():
        return pushdown.row_flags(s, keep, sv, w, bounds, p_ops, a_ops)
    flags = j1()
    digest.update(flags.cpu().numpy().tobytes())
    out["row_flags"] = dict(timed(j1, reps), base=int(
        ((flags >> pushdown.BASE_BIT) & 1).sum()), pred=int((flags & 1).sum()),
        agg=int(((flags >> 5) & 1).sum()))
    del s, keep
    one = flags & ~(1 << pushdown.NEW_DOC_BIT)   # lane 0 starts on its own

    def j2():
        return pushdown.segment_or(flags)

    def j2_one():
        return pushdown.segment_or(one)
    seg = j2()
    digest.update(seg.cpu().numpy().tobytes())
    digest.update(j2_one().cpu().numpy().tobytes())
    out["segment_or"] = dict(timed(j2, reps), starts=int(
        ((flags >> pushdown.NEW_DOC_BIT) & 1).sum()))
    out["segment_or_one_segment"] = timed(j2_one, reps)

    def k():
        return pushdown.agg_reduce(flags, seg, sv, p_ops[1], p_ops[2], 1, 1)
    for x in k():
        digest.update(x.cpu().numpy().tobytes())
    out["agg_reduce"] = timed(k, reps)

    def j3():
        return pushdown.row_pass_pack(flags, seg, p_ops[1], p_ops[2])
    digest.update(j3().cpu().numpy().tobytes())
    out["row_pass_pack"] = dict(timed(j3, reps), n=int(flags.shape[0]))
    del flags, one, seg, sv
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--sf-orders", type=int, default=1_500_000,
                    help="TPC-H orders of the resident aggregates' lineitem "
                    "tablet (chip_smoke's; 1,500,000 = SF1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", default=",".join(SECTIONS),
                    help="comma-separated sections to time, of "
                    f"{','.join(SECTIONS)}")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not only <= set(SECTIONS):
        ap.error(f"--only: sections are {','.join(SECTIONS)}")
    if args.child:
        print(json.dumps(child(args.roots[0], args.rows, args.seed,
                               args.reps, args.sf_orders, only)), flush=True)
        return 0
    results = []
    for root in args.roots:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             "--rows", str(args.rows), "--seed", str(args.seed), "--reps",
             str(args.reps), "--sf-orders", str(args.sf_orders), "--only",
             args.only, root],
            capture_output=True, text=True, check=False, timeout=900)
        sys.stderr.write(out.stderr)
        if out.returncode != 0:
            print(f"kernel_ab: {root} failed ({out.returncode})",
                  file=sys.stderr)
            return 1
        results.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    if len({r["sha256"] for r in results}) != 1:
        print("kernel_ab: the checkouts' outputs differ", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
