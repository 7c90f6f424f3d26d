"""Distributed compaction over a mesh: range repartition + per-shard merge/GC.

Counterpart of yugabyte_tpu/parallel/dist_compact.py, in its two shapes:

1. `distributed_compact` — ONE large job, key-range-sharded: each key
   range is one shard of a `parallel.mesh.Mesh` (one device, or a virtual
   shard of one). Per attempt:
     1. each shard's strided route samples are gathered onto the first
        device (the JAX program's all_gather) and kernel M1 picks the
        splitters once — every JAX shard computes the same ones;
     2. per shard, kernel M2 computes each row's route and destination,
        and kernel M3 buckets the shard's columns plus the global-index row
        stably into [r+1, S*capacity] send slots (pad template elsewhere,
        rows past capacity dropped) and raises the overflow word;
     3. the exchange: recv[d] is the concatenation over s of
        send[s][:, d*capacity:(d+1)*capacity] (the all_to_all), built by
        copies on recv[d]'s device (peer copies through `Tensor.to`
        across cards, copies within the device on a virtual mesh);
     4. per shard, the radix merge + GC of ops/merge_gc.sort_and_gc:
        kernel G sorts, kernel I.1 gathers the sorted payload with the
        index row riding along, kernel B decides (it never keeps a pad).
   The input uploads ONCE (one contiguous tensor per shard); the overflow
   retry doubles the capacity factor up to 64x and re-launches from those
   device-resident columns, with no re-pack and no re-upload. The overflow
   words are read before the exchange, so an attempt that overflowed runs
   no exchange and no merge: M1, M2 and M3 launch once per attempt, G,
   I.1 and B once per shard. The input is freed once an attempt fits (the
   JAX package donates it to XLA instead).

2. `pooled_merge_gc` — MANY small jobs, one per mesh slot: the compaction
   pool's wave. Slot i runs the unchunked merge + GC of
   run_merge.launch_merge_gc (kernel A's levels, then kernel B) on
   mesh.devices[i] with the wave-wide comparator width, so its decisions
   are bit-identical to a sequential launch; only the packed decisions
   come down.

Routing is by the first _W_ROUTE key words of the DOC KEY (masked to
doc_key_len by merge_gc.route_word_mask's arithmetic): every entry and
version of one document routes alike, so the GC segments never straddle
shards, and shard s's keys all sort <= shard s+1's.

Each kernel wrapper runs its plain PyTorch version on a CPU tensor and
launches csrc/dist.cu on a CUDA tensor, or raises; it never falls back.
The fault-injection sites of the JAX package (dist_compact.py:353, :366,
:629, :635 there) sit at each attempt's routing launch ("dispatch") and
its overflow download ("result"), and at the pool wave's launch (with
its (k_pad, m)) and download; the mesh job's containment lives in
storage/compaction.run_compaction_job_dist_native. The overflow retries
count in the registry (`dist_compact_overflow_retry_total`, read by
`overflow_retries()`). `prewarm_dist_compact` launches the mesh families
once at the declared capacities and pool shapes.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from yugabyte_tpu_torch.ops import radix, run_merge
from yugabyte_tpu_torch.ops.merge_gc import (
    _ROW_DKL, _ROW_KEY_LEN, _ROW_WORDS, PAD_SENTINEL, GCParams, StagedCols,
    _u, bucket_size, column_stats, full_sort_sequence, gc_pack, pack_cols,
    pad_template, route_word_mask, to_u32_bits, u32_to_device)
from yugabyte_tpu_torch.parallel.mesh import Mesh
from yugabyte_tpu_torch.utils import torch_setup

# Route on up to this many leading doc-key words (16 bytes). Documents
# whose doc keys share all 16 bytes route to one bucket; the overflow
# retry absorbs the skew.
_W_ROUTE = 4

_SAMPLES_PER_SHARD = 64

# Capacity lattice floor + retry ceiling: capacity quantizes to powers of
# two >= _CAPACITY_MIN, and the overflow retry doubles capacity_factor up
# to _MAX_CAPACITY_FACTOR before declaring the splitters hopeless.
_CAPACITY_MIN = 64
_MAX_CAPACITY_FACTOR = 64

# lanes per tile of kernels M2 and M3 (csrc/dist.cu kTile): M2's per-tile
# destination counts are M3's tile bases
_TILE = 4096
_U32 = 0xFFFFFFFF

def _overflow_retry_counter():
    from yugabyte_tpu_torch.utils.metrics import kernel_metrics
    return kernel_metrics().counter(
        "dist_compact_overflow_retry_total",
        "distributed-compaction attempts re-launched at doubled "
        "per-destination capacity after a bucket overflow (splitter "
        "skew); retries re-shard from the device-resident cols")


def overflow_retries() -> int:
    """Distributed-compaction overflow retries so far in this process."""
    return _overflow_retry_counter().value()


def _quantized_capacity(n_local: int, n_shards: int, factor: float) -> int:
    """Per-destination exchange capacity on the power-of-two lattice."""
    cap_raw = max(_CAPACITY_MIN, int(n_local / n_shards * factor))
    return 1 << (cap_raw - 1).bit_length()


# --------------------------------------------------------------------------
# Kernels M1-M3 (csrc/dist.cu) and their plain versions.

_dist_lib = None


def _lib():
    global _dist_lib
    if _dist_lib is None:
        lib = torch_setup.load_cuda_lib("dist.cu")
        lib.ybt_splitter_pick.restype = ctypes.c_int
        lib.ybt_splitter_pick.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.ybt_route_dest.restype = ctypes.c_int
        lib.ybt_route_dest.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.ybt_bucket_scatter.restype = ctypes.c_int
        lib.ybt_bucket_scatter.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        _dist_lib = lib
    return _dist_lib


def _routes(key_len: torch.Tensor, dkl: torch.Tensor, words: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(route int64 [w, n], is_pad [n]): the key words masked to
    doc_key_len, all-0xFFFFFFFF on pad rows."""
    pad = _u(key_len) == PAD_SENTINEL
    route = _u(words) & _u(route_word_mask(dkl, words.shape[0]))
    return torch.where(pad[None], _U32, route), pad


def splitter_pick_plain(samp: torch.Tensor, w_route: int, n_shards: int
                        ) -> torch.Tensor:
    """Plain PyTorch version of kernel M1 (`per_shard` :113-140). samp:
    int32 [2 + w_route, n_samp], the sampled rows' key_len, doc_key_len
    and first w_route key words. Their routes are lexsorted with the pad
    flag as the final key (u32 words widened to int64, so 0xFFFFFFFF sorts
    last); the splitters are the sorted routes at (q * n_real) // S for q
    = 1..S-1, n_real = max(#non-pad samples, 1). Ties are equal tuples, so
    the values do not depend on the sort's stability. Returns int32 (u32
    bits) [w_route, S-1]."""
    route, pad = _routes(samp[_ROW_KEY_LEN], samp[_ROW_DKL],
                         samp[2:2 + w_route])
    order = torch.arange(samp.shape[1], device=samp.device)
    for key in [pad.long()] + [route[q] for q in range(w_route - 1, -1, -1)]:
        order = order[torch.sort(key[order], stable=True).indices]
    n_real = max(int(samp.shape[1] - int(pad.sum())), 1)
    qs = (torch.arange(1, n_shards, device=samp.device) * n_real) // n_shards
    return to_u32_bits(route[:, order[qs]])


def splitter_pick(samp: torch.Tensor, w_route: int, n_shards: int
                  ) -> torch.Tensor:
    """Kernel M1 wrapper (see splitter_pick_plain): no sort, each sample's
    rank counted by a warp over the samples in shared memory, the sample
    at each pick position writing its splitter. CPU tensor: the plain
    version. CUDA tensor: csrc/dist.cu, one launch, counted in
    `splitter_pick.launches`. A one-shard mesh has no splitters: an empty
    [w_route, 0] tensor on either device, with no launch and no sort."""
    if n_shards == 1:
        return torch.empty((w_route, 0), dtype=torch.int32,
                           device=samp.device)
    if not samp.is_cuda:
        return splitter_pick_plain(samp, w_route, n_shards)
    torch_setup.check_u32_matrix(samp, "splitter_pick", rows=2 + w_route)
    n_samp = samp.shape[1]
    if not (1 <= w_route <= 4 and 2 <= n_shards <= 256
            and 1 <= n_samp <= 8192):
        raise ValueError(f"splitter_pick: {n_samp} samples, w_route="
                         f"{w_route}, {n_shards} shards out of range")
    dev = samp.device
    out = torch.empty((w_route, n_shards - 1), dtype=torch.int32, device=dev)
    rc = _lib().ybt_splitter_pick(samp.data_ptr(), n_samp, w_route,
                                  n_shards, out.data_ptr(),
                                  torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "splitter_pick")
    splitter_pick.launches += 1
    return out


splitter_pick.launches = 0


def _n_tiles(n: int) -> int:
    return (n + _TILE - 1) // _TILE


def route_dest_plain(cols: torch.Tensor, splitters: torch.Tensor,
                     w_route: int, n_shards: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel M2 (`per_shard` :113-124,
    :142-158). cols: int32 [8+w, n], one shard; splitters: int32 [w_route,
    S-1]. Returns (dest int32 [n], the number of splitters
    lexicographically <= the row's route; hist and real_hist int32 [S,
    tiles], the rows of each destination per tile of _TILE lanes, over
    every row and over the real rows)."""
    n = cols.shape[1]
    dev = cols.device
    route, pad = _routes(cols[_ROW_KEY_LEN], cols[_ROW_DKL],
                         cols[_ROW_WORDS:_ROW_WORDS + w_route])
    sp = _u(splitters)
    lt = torch.zeros((n, n_shards - 1), dtype=torch.bool, device=dev)
    eq = torch.ones((n, n_shards - 1), dtype=torch.bool, device=dev)
    for i in range(w_route):
        rw, sw = route[i][:, None], sp[i][None, :]
        lt = lt | (eq & (rw < sw))
        eq = eq & (rw == sw)
    dest = (~lt).sum(dim=1)
    tiles = _n_tiles(n)
    cell = dest * tiles + torch.arange(n, device=dev) // _TILE
    hist = torch.bincount(cell, minlength=n_shards * tiles)
    real = torch.bincount(cell[~pad], minlength=n_shards * tiles)
    return (dest.to(torch.int32), hist.view(n_shards, tiles).to(torch.int32),
            real.view(n_shards, tiles).to(torch.int32))


def route_dest(cols: torch.Tensor, splitters: torch.Tensor, w_route: int,
               n_shards: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel M2 wrapper (see route_dest_plain): one thread per lane, the
    splitters in shared memory. CPU tensor: the plain version. CUDA
    tensor: csrc/dist.cu, counted in `route_dest.launches`."""
    if not cols.is_cuda:
        return route_dest_plain(cols, splitters, w_route, n_shards)
    torch_setup.check_u32_matrix(cols, "route_dest")
    r, n = cols.shape
    dev = cols.device
    if not (1 <= w_route <= 4 and r >= _ROW_WORDS + w_route
            and 1 <= n_shards <= 256 and 0 < n < (1 << 31)
            and splitters.dtype == torch.int32 and splitters.device == dev
            and splitters.shape == (w_route, n_shards - 1)
            and splitters.is_contiguous()):
        raise ValueError(f"route_dest: bad arguments for cols "
                         f"{tuple(cols.shape)}, splitters "
                         f"{tuple(splitters.shape)}, w_route={w_route}, "
                         f"{n_shards} shards")
    tiles = _n_tiles(n)
    dest = torch.empty(n, dtype=torch.int32, device=dev)
    hist = torch.empty((n_shards, tiles), dtype=torch.int32, device=dev)
    real = torch.empty((n_shards, tiles), dtype=torch.int32, device=dev)
    rc = _lib().ybt_route_dest(cols.data_ptr(), n, w_route,
                               splitters.data_ptr(), n_shards,
                               dest.data_ptr(), hist.data_ptr(),
                               real.data_ptr(), torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "route_dest")
    route_dest.launches += 1
    return dest, hist, real


route_dest.launches = 0


def send_template(r: int) -> np.ndarray:
    """One empty send slot: the pad template of r rows plus the index row's
    0xFFFFFFFF."""
    return np.concatenate([pad_template(r), [_U32]]).astype(np.uint32)


def bucket_scatter_plain(cols: torch.Tensor, dest: torch.Tensor,
                         hist: torch.Tensor, real_hist: torch.Tensor,
                         capacity: int, n_shards: int, idx_base: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel M3 (`per_shard` :150-178): rows
    ranked inside their destination in input order over EVERY row, pads
    included (the JAX program's stable argsort); row i goes to slot
    dest*capacity + rank when rank < capacity and is dropped otherwise;
    the global index idx_base + i rides as row r. Every other slot holds
    send_template(r). The overflow flag is set when a destination's REAL
    rows exceed the capacity. Returns (send int32 [r+1, S*capacity],
    overflow int32 [1])."""
    r, n = cols.shape
    dev = cols.device
    d = dest.long()
    order = torch.sort(d, stable=True).indices
    counts = hist.long().sum(dim=1)
    offsets = torch.cumsum(counts, 0) - counts
    d_sorted = d[order]
    rank = torch.arange(n, device=dev) - offsets[d_sorted]
    valid = rank < capacity
    slot = d_sorted * capacity + rank
    idx = to_u32_bits(idx_base + torch.arange(n, device=dev))
    ship = torch.cat([cols, idx[None]], dim=0)
    send = u32_to_device(send_template(r), dev)[:, None].repeat(
        1, n_shards * capacity)
    send[:, slot[valid]] = ship[:, order[valid]]
    overflow = (real_hist.long().sum(dim=1) > capacity).any()
    return send, overflow.to(torch.int32).reshape(1)


def bucket_scatter(cols: torch.Tensor, dest: torch.Tensor,
                   hist: torch.Tensor, real_hist: torch.Tensor,
                   capacity: int, n_shards: int, idx_base: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel M3 wrapper (see bucket_scatter_plain): one launch over M2's
    tiles that writes every send slot once, a row's run of each
    destination as consecutive slots and the pad template only where no
    row lands; M2's per-tile counts give each tile its bases. Counted in
    `bucket_scatter.launches`. CPU tensor: the plain version. CUDA
    tensor: csrc/dist.cu."""
    if not cols.is_cuda:
        return bucket_scatter_plain(cols, dest, hist, real_hist, capacity,
                                    n_shards, idx_base)
    torch_setup.check_u32_matrix(cols, "bucket_scatter")
    r, n = cols.shape
    dev = cols.device
    tiles = _n_tiles(n)
    width = n_shards * capacity
    if not (r > _ROW_WORDS and 0 < n < (1 << 31) and 1 <= n_shards <= 256
            and capacity >= 1 and capacity % 4 == 0 and width < (1 << 31)
            and dest.dtype == hist.dtype == real_hist.dtype == torch.int32
            and dest.shape == (n,) and dest.is_contiguous()
            and hist.shape == real_hist.shape == (n_shards, tiles)
            and hist.is_contiguous() and real_hist.is_contiguous()
            and dest.device == hist.device == real_hist.device == dev):
        raise ValueError(f"bucket_scatter: bad arguments for cols "
                         f"{tuple(cols.shape)}, capacity={capacity}, "
                         f"{n_shards} shards")
    out = torch.empty((r + 1, width), dtype=torch.int32, device=dev)
    overflow = torch.empty(1, dtype=torch.int32, device=dev)
    rc = _lib().ybt_bucket_scatter(
        cols.data_ptr(), n, r, dest.data_ptr(), hist.data_ptr(),
        real_hist.data_ptr(), capacity, n_shards, idx_base & _U32,
        out.data_ptr(), overflow.data_ptr(), torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "bucket_scatter")
    bucket_scatter.launches += 1
    return out, overflow


bucket_scatter.launches = 0


# --------------------------------------------------------------------------
# The key-range-sharded job.

def _check_mesh(mesh: Mesh) -> None:
    """Resolve every shard's device as the port's entry points do: a CUDA
    device raises without CUDA."""
    for dev in mesh.devices.flat:
        torch_setup.resolve_device(dev)


def stage_sharded_cols(slab, mesh: Mesh) -> Tuple[List[torch.Tensor], int]:
    """Pack a slab's key columns ONCE and upload them ONCE, one contiguous
    int32 [8+w, n_local] tensor per shard on its device. Returns (cols,
    n_local). Overflow retries re-shard from these tensors."""
    n_shards = mesh.size
    cols = pack_cols(slab)[0]
    if cols.shape[1] % n_shards:
        extra = n_shards - (cols.shape[1] % n_shards)
        pad_block = np.tile(pad_template(cols.shape[0])[:, None], (1, extra))
        cols = np.concatenate([cols, pad_block], axis=1)
    n_local = cols.shape[1] // n_shards
    return [u32_to_device(cols[:, s * n_local:(s + 1) * n_local], dev)
            for s, dev in enumerate(mesh.devices.flat)], n_local


def _sample_matrix(cols: Sequence[torch.Tensor], n_local: int, w_route: int,
                   device: torch.device) -> torch.Tensor:
    """The all_gather of the route samples: every shard's rows at lanes 0,
    step, 2*step, ... (at most _SAMPLES_PER_SHARD) as int32 [2 + w_route,
    S * s_loc] on `device`: key_len, doc_key_len and the first w_route key
    words (kernel M1 computes their routes)."""
    step = max(1, n_local // _SAMPLES_PER_SHARD)
    rows = [_ROW_KEY_LEN, _ROW_DKL] + list(range(_ROW_WORDS,
                                                 _ROW_WORDS + w_route))
    parts = []
    for c in cols:
        lanes = torch.arange(0, n_local, step,
                             device=c.device)[:_SAMPLES_PER_SHARD]
        ri = torch.tensor(rows, device=c.device)
        parts.append(c[ri[:, None], lanes[None, :]].to(device))
    return torch.cat(parts, dim=1).contiguous()


def _route_and_bucket(cols: Sequence[torch.Tensor], n_local: int,
                      capacity: int, mesh: Mesh, w_route: int):
    """One attempt's routing: M1 once, then M2 and M3 per shard. Returns
    (sends, overflow): sends[s] int32 [r+1, S*capacity] on shard s's
    device."""
    n_shards = mesh.size
    splitters = splitter_pick(
        _sample_matrix(cols, n_local, w_route, mesh.devices[0]),
        w_route, n_shards)                                          # M1
    sends, overflows = [], []
    for s, c in enumerate(cols):
        dest, hist, real = route_dest(c, splitters.to(c.device), w_route,
                                      n_shards)                     # M2
        send, ovf = bucket_scatter(c, dest, hist, real, capacity, n_shards,
                                   s * n_local)                     # M3
        del dest, hist, real
        sends.append(send)
        overflows.append(ovf)
    overflow = any(bool(int(o.item())) for o in overflows)
    return sends, overflow


def _exchange_copies(sends: Sequence[torch.Tensor], capacity: int,
                     devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The all_to_all: recv[d] on devices[d] gathers its column block of
    every send (recv[d][:, s*capacity + j] = send[s][:, d*capacity + j]),
    by peer copies across cards and by copies within a device shared by
    virtual shards. Each recv[d] is a tensor of its own, so it can be
    freed once shard d is merged."""
    return [torch.cat([s[:, d * capacity:(d + 1) * capacity].to(dev)
                       for s in sends], dim=1)
            for d, dev in enumerate(devices)]


def _shard_merge(recv: torch.Tensor, params: GCParams, w: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One shard's radix merge + GC (sort_and_gc over the full schedule):
    kernel G sorts recv [r+1, n] (its last row, the source index, is not in
    the schedule), kernel I.1 gathers the payload [r+2, n] (rows 0..r-1
    the merged cols, row r the source index, row r+1 the perm) and kernel
    B decides over it. Returns (payload, keep, make_tombstone); keep never
    holds a pad row (the JAX program's `keep & ~is_pad`)."""
    r = _ROW_WORDS + w
    perm = radix.radix_sort(recv, full_sort_sequence(w), 4 + w)      # G
    p_mat = radix.sorted_payload(recv, perm)                         # I.1
    del perm
    _packed, keep, mk = gc_pack(p_mat, r, w, params, 1, recv.shape[1],
                                perm=p_mat[r + 1])                   # B
    return p_mat, keep, mk


@dataclass
class DistOutputs:
    """Device-resident products of one distributed compaction step, per
    shard: the merged payload [r+2, S*capacity] (rows 0..r-1 the merged
    cols, row r the source index) and keep / make-tombstone, on the
    shard's device — for survivor-span staging without a host round
    trip."""
    cols_dev: List[torch.Tensor]
    keep_dev: List[torch.Tensor]
    mk_dev: List[torch.Tensor]
    w: int                     # key words (r - _ROW_WORDS)
    capacity: int
    n_shards: int
    device: torch.device       # mesh.devices[0]: where the spans land
    _parent: Optional[tuple] = field(default=None, repr=False)

    def bucket_key(self) -> Tuple[int, int]:
        """Quarantine vocabulary of the dist family: (n_shards,
        capacity)."""
        return (self.n_shards, self.capacity)

    def _parent_products(self):
        """(payload, survivor positions, make_tombstone) over the global
        merged order on self.device, built once: kernel H lays the shards'
        merged cols back to back (one launch, a descriptor per shard),
        kernel D scans the concatenated keep."""
        if self._parent is None:
            r = _ROW_WORDS + self.w
            width = self.n_shards * self.capacity
            dev = self.device
            parts = [p.to(dev) for p in self.cols_dev]
            p_all = run_merge.staged_concat(
                parts, [width] * self.n_shards,
                [s * width for s in range(self.n_shards)],
                self.n_shards * width, pad_template(r))              # H
            del parts
            keep = torch.cat([k.to(dev) for k in self.keep_dev])
            mk = torch.cat([m.to(dev) for m in self.mk_dev])
            self._parent = (p_all, run_merge.survivor_scan(keep), mk)  # D
        return self._parent

    def gather_span(self, start: int, end: int) -> StagedCols:
        """Stage ONE output file's [start, end) survivor span from the
        sharded outputs (kernel E over the parent payload: the gather and
        the tombstone-flag rewrite of `_dist_gather_span`), padded to its
        power-of-two bucket on the mesh's first device."""
        p_all, pos_all, mk = self._parent_products()
        r = _ROW_WORDS + self.w
        n_out = end - start
        n_out_pad = bucket_size(n_out)
        out = run_merge.span_gather(p_all, r, pos_all, mk, start, end,
                                    n_out_pad)                       # E
        return StagedCols(out, n_out, n_out_pad, self.w, None, None)


def distributed_compact(slab, params: GCParams, mesh: Mesh,
                        axis: str = "shard", capacity_factor: float = 2.0):
    """Host wrapper: pack a slab, shard it over the mesh, run the step.

    Returns (cols_out, keep, make_tombstone, src_idx) as host arrays;
    cols_out (uint32 [8+w, S*S*capacity]) in globally range-partitioned
    sorted order (shard s holds keys <= shard s+1's); src_idx[i] is the
    input slab row that produced merged position i (int64; the fill slots
    carry 0xFFFFFFFF and keep=False)."""
    (out, keep, mk, src_idx), _outputs = _distributed_compact_impl(
        slab, params, mesh, capacity_factor, want_outputs=False)
    return out, keep, mk, src_idx


def distributed_compact_with_outputs(slab, params: GCParams, mesh: Mesh,
                                     axis: str = "shard",
                                     capacity_factor: float = 2.0
                                     ) -> Tuple[np.ndarray, np.ndarray,
                                                np.ndarray, DistOutputs]:
    """The dist-native form: decisions as host arrays (keep, mk, src_idx)
    plus the DEVICE-RESIDENT merged outputs for span staging — the merged
    cols never come down."""
    (_out, keep, mk, src_idx), outputs = _distributed_compact_impl(
        slab, params, mesh, capacity_factor, want_outputs=True)
    return keep, mk, src_idx, outputs


def _distributed_compact_impl(slab, params: GCParams, mesh: Mesh,
                              capacity_factor: float, want_outputs: bool):
    from yugabyte_tpu_torch.ops import device_faults
    _check_mesh(mesh)
    n_shards = mesh.size
    cols, n_local = stage_sharded_cols(slab, mesh)
    r = cols[0].shape[0]
    w = r - _ROW_WORDS
    w_route = min(_W_ROUTE, w)
    factor = capacity_factor
    while True:
        capacity = _quantized_capacity(n_local, n_shards, factor)
        # fault sites: a launch failure of the routing kernels surfaces
        # at "dispatch", an asynchronous one at the overflow download
        # (containment in storage/compaction)
        device_faults.maybe_fault("dispatch")
        sends, overflow = _route_and_bucket(cols, n_local, capacity, mesh,
                                            w_route)
        device_faults.maybe_fault("result")
        if not overflow:
            break
        del sends
        if factor >= _MAX_CAPACITY_FACTOR:
            raise RuntimeError(f"distributed compaction bucket overflow at "
                               f"{_MAX_CAPACITY_FACTOR}x")
        _overflow_retry_counter().increment()
        factor *= 2
    del cols                    # the attempt fit: the input is dead
    recvs = _exchange_copies(sends, capacity, list(mesh.devices.flat))
    del sends
    p_mats, keeps, mks = [], [], []
    for d in range(n_shards):
        p_mat, keep, mk = _shard_merge(recvs[d], params, w)
        recvs[d] = None         # shard d's recv goes as soon as it is merged
        p_mats.append(p_mat)
        keeps.append(keep)
        mks.append(mk)
    del recvs
    keep_h = np.concatenate([k.cpu().numpy() for k in keeps])
    mk_h = np.concatenate([m.cpu().numpy() for m in mks])
    src_h = np.concatenate([p[r].cpu().numpy().view(np.uint32)
                            for p in p_mats]).astype(np.int64)
    if want_outputs:
        return (None, keep_h, mk_h, src_h), DistOutputs(
            p_mats, keeps, mks, w=w, capacity=capacity, n_shards=n_shards,
            device=mesh.devices[0])
    out = np.concatenate([p[:r].cpu().numpy().view(np.uint32)
                          for p in p_mats], axis=1)
    return (out, keep_h, mk_h, src_h), None


# --------------------------------------------------------------------------
# Pooled multi-job waves: one tablet job per mesh slot.

def pool_slot_bucket(slabs: Sequence) -> Tuple[int, int, int]:
    """(k_pad, m, w) shape bucket a job's runs stage into — computed as
    stage_pool_slot lays the matrix out (greedy run packing included),
    without packing anything."""
    live = [s for s in slabs if s.n]
    ns = run_merge.packed_run_ns([s.n for s in live])
    k = len(ns)
    k_pad = 1 << max(0, (k - 1).bit_length()) if k > 1 else 1
    m = max(run_merge.run_bucket(n) for n in ns)
    w = run_merge.quantize_width(max(int(s.width_words) for s in live))
    return (k_pad, m, w)


def stage_pool_slot(slabs: Sequence, k_pad: int, m: int, w: int
                    ) -> run_merge.StagedRuns:
    """Pack one job's runs into a HOST [8+w, k_pad*m] run-major matrix.
    Returns a StagedRuns whose cols_dev is the host ndarray —
    pooled_merge_gc uploads it to the slot's device; run_ns, run_maps and
    the compare schedule are what stage_runs_from_slabs records for the
    same job."""
    live, run_maps = run_merge.pack_runs_greedy([s for s in slabs if s.n])
    r = _ROW_WORDS + w
    cols = np.empty((r, k_pad * m), dtype=np.uint32)
    cols[:] = pad_template(r)[:, None]
    stats = []
    for i, s in enumerate(live):
        sub, n_s, _, _ = pack_cols(s, n_pad_override=s.n, w_pad_override=w)
        cols[:, i * m: i * m + n_s] = sub
        stats.append(column_stats(sub, n_s))
    cmp_rows, n_cmp = run_merge._cmp_schedule(
        w, run_merge._merge_const_stats(stats, r))
    return run_merge.StagedRuns(cols, m, k_pad, w, [s.n for s in live],
                                cmp_rows, n_cmp, run_maps=run_maps)


class PoolWaveHandle:
    """Result of one pooled wave: per-job host decisions, plus each slot's
    device-resident merge products (its run_merge.MergeGCHandle) for
    survivor-span staging."""

    def __init__(self, decisions, handles):
        self.decisions = decisions     # [(perm, keep, mk)] per job
        self._handles = handles        # one MergeGCHandle per slot
        self._pos_all: dict = {}

    def gather_span(self, slot: int, start: int, end: int) -> StagedCols:
        """Stage job `slot`'s [start, end) survivor span on that slot's
        device (kernels D once per slot, then E): the pooled twin of
        run_merge.gather_staged_output_span."""
        h = self._handles[slot]
        pos_all = self._pos_all.get(slot)
        if pos_all is None:
            pos_all = self._pos_all[slot] = run_merge.survivor_positions(h)
        return run_merge.gather_staged_output_span(h, pos_all, start, end)


def pooled_merge_gc(mesh: Mesh, jobs: Sequence[Tuple[object, GCParams]],
                    axis: str = "shard") -> PoolWaveHandle:
    """Run up to mesh-size merge+GC jobs as ONE wave.

    jobs: [(staged, params)] where staged is a StagedRuns from
    stage_pool_slot (host cols) or run_merge.stage_runs_from_staged
    (device cols; moved to the slot's device when they sit elsewhere).
    All jobs share one (k_pad, m, w) bucket and one (is_major,
    retain_deletes) pair. Slot i runs run_merge.launch_unchunked on
    mesh.devices[i] with the wave-wide n_cmp (a job's compare rows padded
    with its last row, a comparator no-op); unfilled slots run all-pad
    matrices, which keep nothing. Decisions per job are bit-identical to
    a sequential launch_merge_gc of the same staged runs."""
    _check_mesh(mesh)
    n_slots = mesh.size
    if not 0 < len(jobs) <= n_slots:
        raise ValueError(f"pooled_merge_gc: {len(jobs)} jobs for "
                         f"{n_slots} slots")
    k_pad, m, w = (jobs[0][0].k_pad, jobs[0][0].m, jobs[0][0].w)
    p0 = jobs[0][1]
    for st, p in jobs:
        if (st.k_pad, st.m, st.w) != (k_pad, m, w):
            raise ValueError("wave jobs must share one shape bucket")
        if (p.is_major_compaction, p.retain_deletes) != \
                (p0.is_major_compaction, p0.retain_deletes):
            raise ValueError("wave jobs must share GC statics")
    from yugabyte_tpu_torch.ops import device_faults
    r = _ROW_WORDS + w
    n = k_pad * m
    n_cmp = max(st.n_cmp for st, _p in jobs)
    # fault sites of the wave (the bucket lets a "slow" nemesis throttle
    # one (k_pad, m)); the pool's containment demotes the bucket
    device_faults.maybe_fault("dispatch", bucket=(k_pad, m))
    handles = []
    for i, dev in enumerate(mesh.devices.flat):
        if i < len(jobs):
            st, p = jobs[i]
            rows = np.asarray(st.cmp_rows, dtype=np.int32)
            rows = np.concatenate(
                [rows, np.full(n_cmp - len(rows), rows[-1], np.int32)])
            cd = st.cols_dev
            cols = (u32_to_device(cd, dev) if isinstance(cd, np.ndarray)
                    else cd.to(dev))
            slot = dataclasses.replace(st, cols_dev=cols, cmp_rows=rows,
                                       n_cmp=n_cmp)
        else:
            p = GCParams(0, p0.is_major_compaction, p0.retain_deletes)
            cols = u32_to_device(pad_template(r), dev)[:, None].repeat(1, n)
            slot = run_merge.StagedRuns(
                cols, m, k_pad, w, [], np.full(n_cmp, _ROW_KEY_LEN, np.int32),
                n_cmp)
        handles.append(run_merge.launch_unchunked(slot, p))
        del cols, slot
    device_faults.maybe_fault("result")
    decisions = [h.result() for h in handles[:len(jobs)]]
    return PoolWaveHandle(decisions, handles)


# --------------------------------------------------------------------------
# Prewarm: the mesh families' declared lattice (the JAX package's
# _PREWARM_CAPACITIES and _PREWARM_POOL_SHAPES).

_PREWARM_CAPACITIES = (1 << 13, 1 << 14)
_PREWARM_POOL_SHAPES = ((2, 1 << 16, 4, 8), (4, 1 << 16, 4, 8))


def prewarm_dist_compact(mesh: Mesh,
                         capacities: Optional[Sequence[int]] = None,
                         pool_shapes: Optional[Sequence[Tuple[int, int,
                                                              int, int]]]
                         = None) -> int:
    """Ahead-of-traffic warm of the mesh families: one key-range-sharded
    job per declared capacity (M1-M3, G, I.1, B on every shard, over
    n_shards^2 * capacity / 2 rows of distinct keys: n_shards * capacity
    / 2 a shard, which quantizes to the declared capacity) and one pool wave per declared
    (k_pad, m, w) bucket, each marked prewarmed on the health board
    (dist_compact (n_shards, capacity); the wave's run_merge_fused
    (k_pad, m)). Returns the jobs and waves run; a failure is reported on
    stderr and never blocks."""
    from yugabyte_tpu_torch.ops.slabs import KVSlab, ValueArray
    from yugabyte_tpu_torch.storage.bucket_health import health_board
    caps = tuple(capacities) if capacities is not None \
        else _PREWARM_CAPACITIES
    shapes = tuple(pool_shapes) if pool_shapes is not None \
        else _PREWARM_POOL_SHAPES
    board = health_board()
    n_shards = mesh.size
    done = 0

    def _warm(what: str, fn) -> bool:
        try:
            fn()
            return True
        except Exception as e:  # noqa: BLE001 — prewarm must never block
            import sys as _sys
            print(f"[dist_compact] prewarm of {what} failed: {e!r}",
                  file=_sys.stderr, flush=True)
            return False

    def _slab(n: int) -> KVSlab:
        keys = np.zeros((n, 4), dtype=np.uint32)
        keys[:, 0] = (np.arange(n, dtype=np.uint64) * 2654435761
                      & 0xFFFFFFFF).astype(np.uint32)
        keys[:, 1] = np.arange(n, dtype=np.uint32)
        z32 = np.zeros(n, dtype=np.uint32)
        return KVSlab(key_words=keys, key_len=np.full(n, 16, np.int32),
                      doc_key_len=np.full(n, 16, np.int32),
                      ht_hi=z32, ht_lo=np.ones(n, np.uint32),
                      write_id=z32, flags=z32,
                      ttl_ms=np.zeros(n, np.int64),
                      value_idx=np.zeros(n, np.int32),
                      values=ValueArray.from_list([b""]))

    for capacity in caps:
        n = n_shards * n_shards * capacity // 2
        got = []
        if _warm(f"dist_compact (n_shards={n_shards} capacity={capacity})",
                 lambda: got.append(distributed_compact_with_outputs(
                     _slab(n), GCParams(0, True, False), mesh)[3]
                     .bucket_key())):
            # the bucket the job really ran (the declared one unless a
            # retry doubled its capacity)
            board.record_prewarmed("dist_compact", got[0])
            done += 1
    for (k_pad, m, w, _n_cmp) in shapes:
        def _wave():
            r = _ROW_WORDS + w
            cols = np.ascontiguousarray(np.broadcast_to(
                pad_template(r)[:, None], (r, k_pad * m)))
            cmp_rows, n_cmp = run_merge._cmp_schedule(w, np.zeros(r, bool))
            st = run_merge.StagedRuns(cols, m, k_pad, w, [], cmp_rows, n_cmp)
            pooled_merge_gc(mesh, [(st, GCParams(0, True, False))])
        if _warm(f"pool_wave (slots={n_shards} k_pad={k_pad} m={m} w={w})",
                 _wave):
            board.record_prewarmed("run_merge_fused", (k_pad, m))
            done += 1
    return done
