"""The port's device-codec path against the JAX package, on the CPU.

Held bit for bit (every value is an integer, so the tolerance is exact
equality) against the JAX package's functions on the same inputs, made
from a seed with numpy:
  - kernel C's plain version and `decode_file_to_staged` against
    `_block_decode_impl` / `decode_file_to_staged` (the same SST files);
  - kernel F's plain version against `_block_encode_impl`, its hashes
    against storage/bloom.fnv64_masked;
  - kernels D and E (survivor positions, span gather) against
    `_survivor_positions_impl` / `_gather_staged_output` over the merge
    products of both packages' launches;
  - the codec job against the JAX package's codec job, the port's shell
    path (YBTPU_DEVICE_CODEC=0) and the native CompactionJob.
The JAX side runs on the CPU as its own tests run it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_run_merge import _make_run
from yugabyte_tpu.ops import block_codec as ref_codec
from yugabyte_tpu.ops import run_merge as ref_run_merge
from yugabyte_tpu.ops.merge_gc import GCParams as RefGCParams
from yugabyte_tpu.ops.merge_gc import pack_cols as ref_pack_cols
from yugabyte_tpu.ops.slabs import ValueArray
from yugabyte_tpu.storage import compaction as ref_compaction
from yugabyte_tpu.storage.sst import Frontier, SSTReader, SSTWriter
from yugabyte_tpu.utils import flags as ref_flags
from yugabyte_tpu_torch.ops import block_codec, merge_gc, point_read, run_merge
from yugabyte_tpu_torch.ops.slabs import ValueArray as PortValueArray
from yugabyte_tpu_torch.ops.slabs import slab_from_arrays
from yugabyte_tpu_torch.storage import block_format
from yugabyte_tpu_torch.storage import compaction as port_compaction
from yugabyte_tpu_torch.storage.bloom import fnv64_masked
from yugabyte_tpu_torch.storage.sst import SSTReader as PortSSTReader
from yugabyte_tpu_torch.utils import flags as port_flags
from yugabyte_tpu_torch.utils.status import Code, StatusError

# The tier-1 run shares the host's cores among its workers: one intra-op
# thread keeps these small tensors from starving the cluster tests
# running beside them.
torch.set_num_threads(1)

CUTOFF = (10_000_000 << 12)


@pytest.fixture(autouse=True)
def _codec_on(monkeypatch):
    monkeypatch.setenv("YBTPU_DEVICE_CODEC", "1")


def _cpu():
    return jax.devices("cpu")[0]


def _mk_run(rng, n, key_space, value_bytes=16, ttl_frac=0.0, w=3,
            tomb_frac=0.1):
    slab = _make_run(rng, n, key_space, ttl_frac=ttl_frac, w=w,
                     tomb_frac=tomb_frac)
    slab.values = ValueArray(
        rng.integers(0, 256, size=n * value_bytes, dtype=np.uint8),
        np.arange(n + 1, dtype=np.int64) * value_bytes)
    return slab


def _port_slab(slab):
    return slab_from_arrays(
        values=slab.values, key_words=slab.key_words, key_len=slab.key_len,
        doc_key_len=slab.doc_key_len, ht_hi=slab.ht_hi, ht_lo=slab.ht_lo,
        write_id=slab.write_id, flags=slab.flags, ttl_ms=slab.ttl_ms,
        value_idx=slab.value_idx)


def _write_runs(workdir, runs, block_entries=None, compress=False):
    old = ref_flags.get_flag("sst_compression")
    ref_flags.set_flag("sst_compression", "zlib" if compress else "none")
    try:
        paths = []
        for i, slab in enumerate(runs):
            p = os.path.join(workdir, f"in{i:03d}.sst")
            SSTWriter(p, block_entries=block_entries).write(
                slab, Frontier(op_id_min=(1, i), op_id_max=(1, i + 5),
                               ht_min=1, ht_max=100 + i))
            paths.append(p)
        return paths
    finally:
        ref_flags.set_flag("sst_compression", old)


def _u32(t):
    return t.numpy().view(np.uint32)


# ---------------------------------------------------------------- decode

DECODE_CASES = {
    "multi_block": dict(n=700, block_entries=128),
    "single_block_ttl": dict(n=700, block_entries=4096, ttl_frac=0.3),
    "single_entry": dict(n=1, block_entries=64),
    "one_entry_per_block": dict(n=129, block_entries=1),
    "wide_keys": dict(n=350, block_entries=100, w=7),
    "compressed": dict(n=500, block_entries=128, compress=True,
                       ttl_frac=0.2),
    "max_width_keys": dict(n=200, block_entries=64, max_width=True),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_file_matches_reference(tmp_path, case):
    """The port's decode_file_to_staged == the JAX package's, over the
    same SST file: cols, is_const, first, n_pad and the width bucket."""
    c = dict(DECODE_CASES[case])
    n = c.pop("n")
    rng = np.random.default_rng(31)
    slab = _mk_run(rng, n, max(2, n // 2), ttl_frac=c.get("ttl_frac", 0.0),
                   w=c.get("w", 3))
    if c.get("max_width"):
        slab.key_len[:] = 12        # every key exactly fills its stride
        slab.doc_key_len[:] = 12
    [path] = _write_runs(str(tmp_path), [slab], c["block_entries"],
                         compress=c.get("compress", False))
    ref_r = SSTReader(path)
    want = ref_codec.decode_file_to_staged(
        ref_codec.parse_raw_file(ref_r.read_raw(), ref_r.block_handles),
        _cpu())
    port_r = PortSSTReader(path)
    rfb = block_codec.parse_raw_file(port_r.read_raw(), port_r.block_handles)
    got = block_codec.decode_file_to_staged(rfb, device="cpu")
    assert (got.n, got.n_pad, got.w) == (want.n, want.n_pad, want.w)
    assert np.array_equal(_u32(got.cols_dev), np.asarray(want.cols_dev))
    assert np.array_equal(got.col_const, want.col_const)
    assert np.array_equal(got.col_first, want.col_first)
    values = PortValueArray.concat(rfb.value_parts)
    assert len(values) == n
    assert values.blob() == slab.values.blob()
    ref_r.close()
    port_r.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_decode_plain_matches_reference_impl(seed):
    """Kernel C's plain version == `_block_decode_impl` on random raw
    words: every TTL bit pattern, negative milliseconds included."""
    rng = np.random.default_rng(seed)
    n_pad, n = 512, 300 + 50 * seed
    cols_in = rng.integers(0, 1 << 32, size=(12, n_pad), dtype=np.uint64
                           ).astype(np.uint32)
    cols_in[:, :n:7] = cols_in[:, :1]     # some rows repeat their first
    cols_in[3, :n] = cols_in[3, 0]        # one constant row
    want = ref_codec._block_decode_impl(jnp.asarray(cols_in), jnp.int32(n))
    got = block_codec.block_decode_plain(
        torch.from_numpy(cols_in.view(np.int32)), n)
    assert np.array_equal(_u32(got[0]), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.array_equal(_u32(got[2]), np.asarray(want[2]))
    assert got[1].numpy()[3]


def test_block_decode_ttl_is_the_64_bit_product():
    """The plain version's limb arithmetic == ttl_ms * 1000 mod 2^64 split
    20/32 (the kernel's uint64 form), for negative values too."""
    rng = np.random.default_rng(7)
    ms = np.concatenate([rng.integers(-(1 << 62), 1 << 62, size=200),
                         [-1, -1000, 0, 1, (1 << 63) - 1, -(1 << 63)]])
    raw = ms.astype("<i8").view("<u4").reshape(-1, 2)
    cols_in = np.zeros((12, len(ms)), dtype=np.uint32)
    cols_in[6], cols_in[7] = raw[:, 0], raw[:, 1]
    got = _u32(block_codec.block_decode_plain(
        torch.from_numpy(cols_in.view(np.int32)), len(ms))[0])
    us = [(int(v) * 1000) % (1 << 64) for v in ms]
    assert got[6].tolist() == [(u >> 20) & 0xFFFFFFFF for u in us]
    assert got[7].tolist() == [u & 0xFFFFF for u in us]


def test_decode_empty_file_unsupported():
    rfb = block_codec.RawFileBlocks(
        n=0, w=1, counts=np.zeros(0, dtype=np.int64),
        strides_w=np.zeros(0, dtype=np.int64), bodies=[], value_parts=[])
    with pytest.raises(block_codec.BlockCodecUnsupported):
        block_codec.decode_file_to_staged(rfb, device="cpu")


def test_corrupt_crc_raises_typed_corruption(tmp_path, monkeypatch):
    """A flipped body byte or magic surfaces Status.Corruption from the
    raw parse, and the codec job fails with it before any decode."""
    rng = np.random.default_rng(34)
    paths = _write_runs(str(tmp_path), [_mk_run(rng, 300, 120)
                                        for _ in range(2)], 64)
    r = PortSSTReader(paths[1])
    raw = bytearray(r.read_raw())
    off, _size, _cnt = r.block_handles[1]
    r.close()
    raw[off + block_format.HEADER_BYTES + 5] ^= 0x40
    with pytest.raises(StatusError) as ei:
        block_codec.parse_raw_file(bytes(raw), r.block_handles)
    assert ei.value.status.code == Code.CORRUPTION
    raw2 = bytearray(raw)
    raw2[off + block_format.HEADER_BYTES + 5] ^= 0x40   # restore the body
    raw2[off] ^= 0xFF                                   # break the magic
    with pytest.raises(StatusError) as ei2:
        block_codec.parse_raw_file(bytes(raw2), r.block_handles)
    assert ei2.value.status.code == Code.CORRUPTION
    with open(paths[1] + ".sblock.0", "wb") as f:
        f.write(bytes(raw))
    decodes = []
    decode = block_codec.block_decode

    def counting_decode(*a):
        decodes.append(1)
        return decode(*a)

    monkeypatch.setattr(block_codec, "block_decode", counting_decode)
    out = tmp_path / "out"
    out.mkdir()
    ids = iter(range(100, 200))
    with pytest.raises(StatusError) as ei3:
        port_compaction.run_compaction_job_device_native(
            [PortSSTReader(p) for p in paths], str(out), lambda: next(ids),
            CUTOFF, True, device="cpu")
    assert ei3.value.status.code == Code.CORRUPTION
    assert len(decodes) == 1          # the first file only; none after
    assert not os.listdir(out)


# ---------------------------------------------------------------- encode

def _span_cols(seed, w, ttl_frac):
    """A span cols matrix as the gather leaves it: real rows, tombstone
    flags OR'd on some, the pad template in the tail."""
    rng = np.random.default_rng(seed)
    slab = _mk_run(rng, 900, 300, w=w, ttl_frac=ttl_frac, tomb_frac=0.2)
    cols, n, _n_pad, _w = ref_pack_cols(slab)
    cols[5, :n][rng.random(n) < 0.1] |= 1
    return cols, n


@pytest.mark.parametrize("w,ttl_frac", [(3, 0.0), (3, 0.4), (7, 0.0),
                                        (7, 0.4)])
def test_block_encode_plain_matches_reference_impl(w, ttl_frac):
    """Kernel F's plain version == `_block_encode_impl`, all ten outputs."""
    cols, _n = _span_cols(w * 10, w, ttl_frac)
    want = ref_codec._block_encode_impl(jnp.asarray(cols))
    got = block_codec.block_encode_plain(torch.from_numpy(cols.view(np.int32)))
    assert len(got) == len(want) == 10
    for i, (g, w_) in enumerate(zip(got, want)):
        assert np.array_equal(_u32(g.contiguous()), np.asarray(w_)), i


def test_block_encode_hashes_match_bloom():
    """The encode's doc-key hashes == storage/bloom.fnv64_masked over the
    key bytes, and the limb multiply == the 64-bit product."""
    cols, n = _span_cols(5, 3, 0.2)
    out = block_codec.block_encode_plain(torch.from_numpy(cols.view(np.int32)))
    keys, h_hi, h_lo = _u32(out[0]), _u32(out[8]), _u32(out[9])
    u8 = keys[:n].view(np.uint8).reshape(n, -1)
    want = fnv64_masked(u8, cols[1, :n].astype(np.int64))
    got = (h_hi[:n].astype(np.uint64) << np.uint64(32)) | h_lo[:n]
    assert np.array_equal(got, want)
    rng = np.random.default_rng(6)
    h = rng.integers(0, 1 << 63, size=300, dtype=np.int64).astype(np.uint64) \
        * np.uint64(2) + rng.integers(0, 2, size=300).astype(np.uint64)
    hi = torch.from_numpy((h >> np.uint64(32)).astype(np.uint32)
                          .view(np.int32))
    lo = torch.from_numpy((h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                          .view(np.int32))
    nhi, nlo = point_read._mul64_by_prime(hi, lo)
    prod = [(int(x) * 0x100000001B3) % (1 << 64) for x in h]
    assert _u32(nhi).tolist() == [p >> 32 for p in prod]
    assert _u32(nlo).tolist() == [p & 0xFFFFFFFF for p in prod]


# ------------------------------------------------------- survivor scan, D

@pytest.mark.parametrize("n", [256, 4096])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_survivor_scan_matches_reference(n, density):
    keep = np.random.default_rng(n).random(n) < density
    want = np.asarray(ref_run_merge._survivor_positions_impl(
        jnp.asarray(keep)))
    got = run_merge.survivor_scan(torch.from_numpy(keep))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


# ------------------------------------------------------ span gather, D + E

def _both_handles(k, seed):
    """The same runs merged by both packages (non-major, TTL: the merge
    marks make-tombstone rows)."""
    rng = np.random.default_rng(seed)
    runs = [_mk_run(rng, 300 + 10 * i, 250, ttl_frac=0.4, tomb_frac=0.15)
            for i in range(k)]         # no two runs share a 512-row slot
    params = ((1 << 22) << 12, False)
    ref_st = ref_run_merge.stage_runs_from_slabs(runs, device=_cpu())
    ref_h = ref_run_merge.launch_merge_gc(ref_st, RefGCParams(*params))
    port_st = run_merge.stage_runs_from_slabs(
        [_port_slab(s) for s in runs], device="cpu")
    port_h = run_merge.launch_merge_gc(port_st, merge_gc.GCParams(*params))
    assert (port_st.k_pad, port_st.m, port_st.w) == \
        (ref_st.k_pad, ref_st.m, ref_st.w)
    return ref_st, ref_h, port_h


@pytest.mark.parametrize("k,k_pad", [(1, 1), (2, 2), (4, 4), (7, 8)])
def test_span_gather_matches_reference(k, k_pad):
    ref_st, ref_h, port_h = _both_handles(k, 40 + k)
    assert ref_st.k_pad == k_pad
    assert np.array_equal(port_h._perm_dev.numpy(),
                          np.asarray(ref_h._perm_dev))
    want_pos = ref_run_merge._survivor_positions_impl(ref_h._keep_dev)
    got_pos = run_merge.survivor_positions(port_h)
    assert np.array_equal(got_pos.numpy(), np.asarray(want_pos))
    assert port_h._keep_dev is None          # scanned once, then let go
    n_surv = int(ref_h._keep_dev.sum())
    assert np.asarray(ref_h._mk_dev).any(), "no TTL rewrite to check"
    spans = [(0, min(n_surv, 300)), (min(n_surv, 300), n_surv),
             (n_surv - 1, n_surv), (n_surv, n_surv + 5)]
    for start, end in spans:
        n_out_pad = merge_gc.bucket_size(end - start)
        want = ref_run_merge._gather_staged_output(
            ref_st.cols_dev, ref_h._perm_dev, want_pos, ref_h._mk_dev,
            jnp.int32(start), jnp.int32(end), n_out_pad)
        got = run_merge.gather_staged_output_span(port_h, got_pos, start, end)
        assert (got.n, got.n_pad) == (end - start, n_out_pad)
        assert np.array_equal(_u32(got.cols_dev), np.asarray(want)), \
            (start, end)


def test_gather_staged_outputs_covers_every_span():
    ref_st, ref_h, port_h = _both_handles(3, 9)
    n_surv = int(ref_h._keep_dev.sum())
    a, b = n_surv // 3, 2 * n_surv // 3
    ranges = [(0, a), (a, b), (b, n_surv)]
    outs = run_merge.gather_staged_outputs(port_h, ranges)
    cat = np.concatenate([_u32(o.cols_dev)[:, :o.n] for o in outs], axis=1)
    whole = ref_run_merge._gather_staged_output(
        ref_st.cols_dev, ref_h._perm_dev,
        ref_run_merge._survivor_positions_impl(ref_h._keep_dev),
        ref_h._mk_dev, jnp.int32(0), jnp.int32(n_surv),
        merge_gc.bucket_size(n_surv))
    assert np.array_equal(cat, np.asarray(whole)[:, :n_surv])


# ------------------------------------------------------------ the job

def _files(outputs):
    out = []
    for _fid, base, _props in outputs:
        for p in (base, base + ".sblock.0"):
            with open(p, "rb") as f:
                out.append((os.path.basename(p), f.read()))
    return out


def _port_job(paths, out_dir, codec, is_major, monkeypatch):
    monkeypatch.setenv("YBTPU_DEVICE_CODEC", codec)
    os.makedirs(out_dir)
    ids = iter(range(100, 1000))
    return port_compaction.run_compaction_job_device_native(
        [PortSSTReader(p) for p in paths], out_dir, lambda: next(ids),
        CUTOFF, is_major, device="cpu")


@pytest.mark.parametrize("compress", [False, True])
def test_codec_job_byte_identical_everywhere(tmp_path, monkeypatch,
                                             compress):
    """Codec job (compression on and off, a multi-file split, TTL at a
    non-major compaction) == the JAX package's codec job == the port's
    shell path == the native CompactionJob: base and data files."""
    rng = np.random.default_rng(36)
    runs = [_mk_run(rng, 900, 3000, ttl_frac=0.2) for _ in range(3)]
    paths = _write_runs(str(tmp_path), runs)
    keys = ("sst_compression", "compaction_max_output_entries_per_sst")
    vals = ("zlib" if compress else "none", 700)
    saved = {(f, k): f.get_flag(k) for f in (ref_flags, port_flags)
             for k in keys}
    for f, k in saved:
        f.set_flag(k, dict(zip(keys, vals))[k])
    try:
        codec = _port_job(paths, str(tmp_path / "codec"), "1", False,
                          monkeypatch)
        shell = _port_job(paths, str(tmp_path / "shell"), "0", False,
                          monkeypatch)
        monkeypatch.setenv("YBTPU_DEVICE_CODEC", "1")
        os.makedirs(tmp_path / "ref")
        ids = iter(range(100, 1000))
        ref = ref_compaction.run_compaction_job_device_native(
            [SSTReader(p) for p in paths], str(tmp_path / "ref"),
            lambda: next(ids), CUTOFF, False, device=_cpu())
        os.makedirs(tmp_path / "native")
        ids = iter(range(100, 1000))
        native = port_compaction._run_native_job(
            [PortSSTReader(p) for p in paths], str(tmp_path / "native"),
            lambda: next(ids), CUTOFF, False, False, None)
    finally:
        for (f, k), v in saved.items():
            f.set_flag(k, v)
    assert len(codec.outputs) >= 2, "expected a multi-file split"
    assert codec.tombstones_written > 0
    for other in (shell, ref, native):
        assert (codec.rows_in, codec.rows_out) == (other.rows_in,
                                                   other.rows_out)
        assert _files(codec.outputs) == _files(other.outputs)
    assert codec.tombstones_written == shell.tombstones_written \
        == ref.tombstones_written


@pytest.mark.parametrize("codec", ["1", "0"])
def test_routing_follows_the_flag(tmp_path, monkeypatch, codec):
    """The codec path runs by default (kernels C and F's plain versions
    are called); YBTPU_DEVICE_CODEC=0 takes the shell path (neither is)."""
    calls = {"decode": 0, "encode": 0}
    dec, enc = block_codec.block_decode_plain, block_codec.block_encode_plain

    def count_decode(*a):
        calls["decode"] += 1
        return dec(*a)

    def count_encode(*a):
        calls["encode"] += 1
        return enc(*a)

    monkeypatch.setattr(block_codec, "block_decode_plain", count_decode)
    monkeypatch.setattr(block_codec, "block_encode_plain", count_encode)
    rng = np.random.default_rng(37)
    paths = _write_runs(str(tmp_path), [_mk_run(rng, 400, 200)
                                        for _ in range(2)], 100)
    res = _port_job(paths, str(tmp_path / "out"), codec, True, monkeypatch)
    assert res.outputs
    want = {"decode": 2, "encode": 1} if codec == "1" else \
        {"decode": 0, "encode": 0}
    assert calls == want


def test_unsupported_takes_the_shell_path(tmp_path, monkeypatch):
    """BlockCodecUnsupported mid-job: the codec attempt unwinds its
    outputs and the shell path writes the same files."""
    rng = np.random.default_rng(38)
    paths = _write_runs(str(tmp_path), [_mk_run(rng, 500, 250)
                                        for _ in range(3)])
    key = "compaction_max_output_entries_per_sst"
    old = port_flags.get_flag(key)
    port_flags.set_flag(key, 300)
    encode_span = block_codec.encode_span
    spans = []

    def second_span_unsupported(*a, **kw):
        spans.append(1)
        if len(spans) == 2:
            raise block_codec.BlockCodecUnsupported("test")
        return encode_span(*a, **kw)

    try:
        want = _port_job(paths, str(tmp_path / "want"), "0", True,
                         monkeypatch)
        monkeypatch.setattr(block_codec, "encode_span",
                            second_span_unsupported)
        got = _port_job(paths, str(tmp_path / "got"), "1", True, monkeypatch)
    finally:
        port_flags.set_flag(key, old)
    assert len(spans) == 2 and len(want.outputs) >= 2
    # the failed attempt took one file id, so names move on by one; the
    # file it wrote is gone
    assert [b for _, b in _files(got.outputs)] == \
        [b for _, b in _files(want.outputs)]
    assert len(os.listdir(tmp_path / "got")) == 2 * len(want.outputs)
