"""Device SST block codec: decode and encode block columns on the card.

Counterpart of yugabyte_tpu/ops/block_codec.py. The device-codec
compaction job (storage/compaction.py `_device_codec_attempt`) runs
without the native byte shell:

  - decode (kernel C, csrc/block_codec.cu): the host CRC-checks each raw
    block (`parse_raw_file`) and lays its CONTIGUOUS column regions
    straight into the cols layout (memcpy-class slicing and u16/u8
    widening, no per-entry work); the kernel does the per-entry
    transforms — key-word byteswap, the TTL ms -> 20/32-bit microsecond
    limb split — and the column stats (is_const, first). Values never
    upload: they are zero-copy slices of the raw bodies.
  - encode (kernel F, same file): a gathered survivor span's cols become
    the on-disk column encodings — entry-major byteswapped keys, packed
    u16 length pairs, packed u8 flags — plus the FNV-1a-64 doc-key hashes
    for the bloom filter; the host (`encode_span`) splices value bytes,
    compresses, stamps headers and CRCs and returns the blocks.

CRC and zlib stay on the host, as in the JAX package: corrupt blocks
surface a typed Status.Corruption before anything uploads.
`YBTPU_DEVICE_CODEC=0` turns the codec off, and the job takes the native
byte shell. `block_decode` and `block_encode` are the kernels' wrappers:
on a CPU tensor they run their plain PyTorch versions, on a CUDA tensor
they launch the kernel or raise, and each counts its launches.

Not ported: the JAX package's bucket-health board, device-fault injection
and retry-once, donation, prewarm and manifest shapes, and the codec
metrics (this package has no metrics registry yet; the launch counters
take their place).
"""

from __future__ import annotations

import ctypes
import os
import zlib
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from yugabyte_tpu_torch.ops.merge_gc import (
    _ROW_FLAGS, _ROW_WORDS, _U32, StagedCols, _u, bucket_size,
    count_key_col_upload, to_u32_bits, u32_to_device)
from yugabyte_tpu_torch.ops.point_read import (
    _FNV_OFFSET_HI, _FNV_OFFSET_LO, _mul64_by_prime)
from yugabyte_tpu_torch.storage import block_format
from yugabyte_tpu_torch.utils import torch_setup


class BlockCodecUnsupported(Exception):
    """The device codec cannot run this job (the native byte shell takes
    it)."""


def codec_enabled() -> bool:
    """YBTPU_DEVICE_CODEC=0 turns the codec off (default on)."""
    return os.environ.get("YBTPU_DEVICE_CODEC", "1").lower() \
        not in ("0", "false", "off")


def _bswap32(x: torch.Tensor) -> torch.Tensor:
    """Byte swap of u32 values held in int64 (big-endian key bytes <-> the
    u32 key-word convention of ops/slabs.py)."""
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
            | ((x >> 8) & 0xFF00) | (x >> 24))


# --------------------------------------------------------------------------
# Kernel C: block decode


def block_decode_plain(cols_in: torch.Tensor, n: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel C (`_block_decode_impl`).

    cols_in: int32 [8+w_pad, n_pad] (u32 bits), the cols layout except
    rows 6..7 hold the raw (lo, hi) words of the i64 millisecond TTL and
    rows 8.. the little-endian raw key words; lanes >= n hold the pad
    template. Returns (cols int32 [8+w_pad, n_pad], is_const bool [R],
    first int32 [R]). The TTL goes through the JAX package's 16-bit
    partial products, widened to int64 and wrapped to 32 bits."""
    x = _u(cols_in)
    t_lo, t_hi = x[6], x[7]
    p0 = (t_lo & 0xFFFF) * 1000
    p1 = (t_lo >> 16) * 1000
    add = (p1 & 0xFFFF) << 16
    us_lo = (p0 + add) & _U32
    carry = (us_lo < add).long()
    us_hi = ((p1 >> 16) + t_hi * 1000 + carry) & _U32
    ttl_hi = ((us_lo >> 20) | (us_hi << 12)) & _U32
    ttl_lo = us_lo & 0xFFFFF
    cols = to_u32_bits(torch.cat([x[:6], ttl_hi[None], ttl_lo[None],
                                  _bswap32(x[_ROW_WORDS:])]))
    first = cols[:, 0].clone()
    valid = torch.arange(cols.shape[1], device=cols.device) < n
    is_const = ((cols == first[:, None]) | ~valid[None, :]).all(dim=1)
    return cols, is_const, first


_codec_lib = None


def _lib():
    global _codec_lib
    if _codec_lib is None:
        lib = torch_setup.load_cuda_lib("block_codec.cu")
        lib.ybt_block_decode.restype = ctypes.c_int
        lib.ybt_block_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.ybt_block_encode.restype = ctypes.c_int
        lib.ybt_block_encode.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
            + [ctypes.c_void_p] * 7)
        _codec_lib = lib
    return _codec_lib


def block_decode(cols_in: torch.Tensor, n: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel C wrapper (see block_decode_plain for the contract). CPU
    tensor: the plain version. CUDA tensor: csrc/block_codec.cu, counted
    in `block_decode.launches`."""
    if not cols_in.is_cuda:
        return block_decode_plain(cols_in, n)
    torch_setup.check_u32_matrix(cols_in, "block_decode")
    rows, n_pad = cols_in.shape
    if rows <= _ROW_WORDS or not 0 < n <= n_pad:
        raise ValueError(f"block_decode: bad shape {tuple(cols_in.shape)} "
                         f"for n={n}")
    dev = cols_in.device
    cols = torch.empty_like(cols_in)
    first = torch.empty(rows, dtype=torch.int32, device=dev)
    differs = torch.empty(rows, dtype=torch.int32, device=dev)
    rc = _lib().ybt_block_decode(
        cols_in.data_ptr(), cols.data_ptr(), rows, n_pad, n,
        first.data_ptr(), differs.data_ptr(), torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "block_decode")
    block_decode.launches += 1
    return cols, differs == 0, first


block_decode.launches = 0


# --------------------------------------------------------------------------
# Kernel F: block encode


def _encode_views(cols: torch.Tensor):
    """The encode outputs that are rows of the input (no work):
    ht_hi, ht_lo, write_id and the two TTL limb rows [2, n_pad]."""
    return cols[2], cols[3], cols[4], cols[6:8]


def block_encode_plain(cols: torch.Tensor):
    """Plain PyTorch version of kernel F (`_block_encode_impl`).

    cols: int32 [8+w_pad, n_pad] span cols (u32 bits, n_pad a multiple of
    4). Returns (keys [n_pad, w_pad], kl2 [n_pad/2], dkl2 [n_pad/2],
    ht_hi, ht_lo, wid [n_pad], fl4 [n_pad/4], ttl [2, n_pad], h_hi, h_lo
    [n_pad]), all int32 holding u32 bits. The hash keeps the JAX package's
    u32-limb form (`_mul64_by_prime`)."""
    x = _u(cols)
    kl, dkl = x[0], x[1]
    w_pad = cols.shape[0] - _ROW_WORDS
    n_pad = cols.shape[1]
    keys = to_u32_bits(_bswap32(x[_ROW_WORDS:]).T.contiguous())
    kl2 = to_u32_bits((kl[0::2] & 0xFFFF) | ((kl[1::2] << 16) & _U32))
    dkl2 = to_u32_bits((dkl[0::2] & 0xFFFF) | ((dkl[1::2] << 16) & _U32))
    fl = x[_ROW_FLAGS] & 0xFF
    fl4 = to_u32_bits(fl[0::4] | (fl[1::4] << 8) | (fl[2::4] << 16)
                      | (fl[3::4] << 24))
    h_hi = to_u32_bits(torch.full((n_pad,), _FNV_OFFSET_HI,
                                  dtype=torch.int64, device=cols.device))
    h_lo = to_u32_bits(torch.full((n_pad,), _FNV_OFFSET_LO,
                                  dtype=torch.int64, device=cols.device))
    dkl_i = cols[1].long()          # a pad lane's 0xFFFFFFFF reads as -1
    for j in range(w_pad * 4):
        word = x[_ROW_WORDS + j // 4]
        byte = (word >> (8 * (3 - j % 4))) & 0xFF
        active = dkl_i > j
        nhi, nlo = _mul64_by_prime(h_hi, to_u32_bits(_u(h_lo) ^ byte))
        h_hi = torch.where(active, nhi, h_hi)
        h_lo = torch.where(active, nlo, h_lo)
    ht_hi, ht_lo, wid, ttl = _encode_views(cols)
    return keys, kl2, dkl2, ht_hi, ht_lo, wid, fl4, ttl, h_hi, h_lo


def block_encode(cols: torch.Tensor):
    """Kernel F wrapper (see block_encode_plain for the contract). CPU
    tensor: the plain version. CUDA tensor: csrc/block_codec.cu (n_pad a
    multiple of 128), counted in `block_encode.launches`."""
    if not cols.is_cuda:
        return block_encode_plain(cols)
    torch_setup.check_u32_matrix(cols, "block_encode")
    rows, n_pad = cols.shape
    if rows <= _ROW_WORDS or n_pad % 128:
        raise ValueError(f"block_encode: bad shape {tuple(cols.shape)} "
                         f"(n_pad must be a multiple of 128)")
    w_pad = rows - _ROW_WORDS
    dev = cols.device

    def out(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    keys, kl2, dkl2 = out(n_pad, w_pad), out(n_pad // 2), out(n_pad // 2)
    fl4, h_hi, h_lo = out(n_pad // 4), out(n_pad), out(n_pad)
    rc = _lib().ybt_block_encode(
        cols.data_ptr(), n_pad, w_pad, keys.data_ptr(), kl2.data_ptr(),
        dkl2.data_ptr(), fl4.data_ptr(), h_hi.data_ptr(), h_lo.data_ptr(),
        torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "block_encode")
    block_encode.launches += 1
    ht_hi, ht_lo, wid, ttl = _encode_views(cols)
    return keys, kl2, dkl2, ht_hi, ht_lo, wid, fl4, ttl, h_hi, h_lo


block_encode.launches = 0


# --------------------------------------------------------------------------
# Host side: raw-file parsing (CRC + zero-copy values), upload staging and
# the output-block assembler.


@dataclass
class RawFileBlocks:
    """One SST data file parsed at the raw-block level: CRC-checked bodies
    ready for upload, values as zero-copy slices; no column decode."""
    n: int                       # total entries
    w: int                       # real key words (max stride / 4)
    counts: np.ndarray           # int64 [B]
    strides_w: np.ndarray        # int64 [B]
    bodies: List[np.ndarray]     # uint8 fixed regions (keys + metadata)
    value_parts: List[object]    # per-block zero-copy ValueArrays


def parse_raw_file(raw: bytes, handles: Sequence[Tuple[int, int, int]]
                   ) -> RawFileBlocks:
    """Split one data file's bytes into CRC-checked raw block regions.
    Corruption surfaces here, typed, before anything uploads."""
    counts: List[int] = []
    strides_w: List[int] = []
    bodies: List[np.ndarray] = []
    vals: List[object] = []
    mv = memoryview(raw)   # zero-copy block/body slicing
    for off, size, _cnt in handles:
        n_b, stride, body = block_format.split_raw_block(mv[off: off + size])
        counts.append(n_b)
        strides_w.append(stride // 4)
        bodies.append(np.frombuffer(
            body, dtype=np.uint8,
            count=block_format.fixed_region_bytes(n_b, stride)))
        vals.append(block_format.raw_block_values(n_b, stride, body))
    return RawFileBlocks(
        n=int(sum(counts)),
        w=max([int(s) for s in strides_w], default=1),
        counts=np.asarray(counts, dtype=np.int64),
        strides_w=np.asarray(strides_w, dtype=np.int64),
        bodies=bodies,
        value_parts=vals)


def _quantize_width(w: int) -> int:
    # pack_cols' width formula (== run_merge.quantize_width): decoded
    # staging must land on the same bucket as host staging
    return 1 << max(2, (w - 1).bit_length() if w > 1 else 1)


def raw_cols(rfb: RawFileBlocks) -> Tuple[np.ndarray, int, int]:
    """The host half of the decode: every block's contiguous column
    regions laid into one uint32 [8+w_pad, n_pad] matrix in the cols
    layout (kernel C's input), pad template beyond n. Returns (cols_in,
    n_pad, w_pad)."""
    n = rfb.n
    n_pad = bucket_size(n)
    w_pad = _quantize_width(rfb.w)
    cols_in = np.zeros((_ROW_WORDS + w_pad, n_pad), dtype=np.uint32)
    cols_in[0, n:] = np.uint32(0xFFFFFFFF)   # PAD_SENTINEL key_len
    cols_in[1, n:] = np.uint32(0xFFFFFFFF)   # PAD_SENTINEL doc_key_len
    cols_in[_ROW_WORDS:, n:] = np.uint32(0xFFFFFFFF)   # pad keys: last
    pos = 0
    for n_b, sw, body in zip(rfb.counts, rfb.strides_w, rfb.bodies):
        n_b = int(n_b)
        sw = int(sw)
        sl = slice(pos, pos + n_b)
        ks = n_b * sw * 4                      # key-slab bytes
        kv = np.frombuffer(body, dtype="<u4",
                           count=n_b * sw).reshape(n_b, sw)
        cols_in[_ROW_WORDS: _ROW_WORDS + sw, sl] = kv.T
        cols_in[0, sl] = np.frombuffer(body, dtype="<u2", count=n_b,
                                       offset=ks)
        cols_in[1, sl] = np.frombuffer(body, dtype="<u2", count=n_b,
                                       offset=ks + 2 * n_b)
        cols_in[2, sl] = np.frombuffer(body, dtype="<u4", count=n_b,
                                       offset=ks + 4 * n_b)
        cols_in[3, sl] = np.frombuffer(body, dtype="<u4", count=n_b,
                                       offset=ks + 8 * n_b)
        cols_in[4, sl] = np.frombuffer(body, dtype="<u4", count=n_b,
                                       offset=ks + 12 * n_b)
        cols_in[5, sl] = np.frombuffer(body, dtype=np.uint8, count=n_b,
                                       offset=ks + 16 * n_b)
        # the ttl region is 8*n bytes at a possibly-odd alignment: read
        # through an aligned u8 copy, then de-interleave the i64 limbs
        t = np.frombuffer(body, dtype=np.uint8, count=8 * n_b,
                          offset=ks + 17 * n_b).copy().view("<u4")
        cols_in[6, sl] = t[0::2]
        cols_in[7, sl] = t[1::2]
        pos += n_b
    return cols_in, n_pad, w_pad


def decode_file_to_staged(rfb: RawFileBlocks, device=None) -> StagedCols:
    """Upload one file's raw column regions and decode them on the device
    (kernel C) into the StagedCols that merge_gc.stage_slab would build
    from the host decode, bit for bit (cuda unless the caller passes
    device='cpu')."""
    dev = torch_setup.resolve_device(device)
    if rfb.n == 0:
        raise BlockCodecUnsupported("empty file has nothing to stage")
    cols_in, n_pad, w_pad = raw_cols(rfb)
    count_key_col_upload()
    cols, is_const, first = block_decode(u32_to_device(cols_in, dev), rfb.n)
    return StagedCols(cols, rfb.n, n_pad, w_pad, is_const.cpu().numpy(),
                      first.cpu().numpy().view(np.uint32))


def _host(t: torch.Tensor) -> np.ndarray:
    """A device int32 tensor (u32 bits) as a contiguous host uint32 array."""
    return t.contiguous().cpu().numpy().view(np.uint32)


def encode_span(st: StagedCols, n_rows: int, w_out: int, values,
                block_entries: int, compress: bool):
    """Assemble the finished block bytes of one survivor span.

    st: the span's gathered cols (device); n_rows real rows; w_out the
    output key stride in words (the largest real input stride, the native
    shell's rule, so files stay byte-identical); values: the span's value
    rows (tombstone rewrite already applied). Kernel F runs on the span;
    only the real rows and the real stride are sliced (on the device) and
    copied to the host. Returns (blocks, index_items, bloom_hashes,
    first_key, last_key) in write_base_file's vocabulary."""
    (keys_d, kl2_d, dkl2_d, ht_hi_d, ht_lo_d, wid_d, fl4_d, ttl_d,
     h_hi_d, h_lo_d) = block_encode(st.cols_dev)
    keys = _host(keys_d[:n_rows, :w_out])
    kl = _host(kl2_d[: (n_rows + 1) // 2]).view("<u2")[:n_rows]
    dkl = _host(dkl2_d[: (n_rows + 1) // 2]).view("<u2")[:n_rows]
    ht_hi = _host(ht_hi_d[:n_rows])
    ht_lo = _host(ht_lo_d[:n_rows])
    wid = _host(wid_d[:n_rows])
    fl = _host(fl4_d[: (n_rows + 3) // 4]).view(np.uint8)[:n_rows]
    ttl = _host(ttl_d[:, :n_rows])
    h_hi = _host(h_hi_d[:n_rows])
    h_lo = _host(h_lo_d[:n_rows])
    keys_u8 = keys.view(np.uint8).reshape(n_rows, w_out * 4)
    # ttl rows are [hi20, lo]: the pack_cols 20/32 microsecond split; the
    # limbs were ms * 1000, so the division back is exact
    ttl_us = ((ttl[0].astype(np.uint64) << np.uint64(20))
              | ttl[1].astype(np.uint64))
    ttl_ms = (ttl_us // np.uint64(1000)).astype("<i8")
    hashes = (h_hi.astype(np.uint64) << np.uint64(32)) \
        | h_lo.astype(np.uint64)

    def key_at(i: int) -> bytes:
        return keys_u8[i, : int(kl[i])].tobytes()

    blocks: List[bytes] = []
    index_items: List[Tuple[bytes, int, int, int]] = []
    data_off = 0
    voffs = values.offsets
    for s in range(0, n_rows, block_entries):
        e = min(s + block_entries, n_rows)
        vo = (voffs[s: e + 1] - voffs[s]).astype("<u4")
        body = b"".join([
            keys_u8[s:e].tobytes(),
            kl[s:e].tobytes(), dkl[s:e].tobytes(),
            ht_hi[s:e].tobytes(), ht_lo[s:e].tobytes(),
            wid[s:e].tobytes(), fl[s:e].tobytes(),
            ttl_ms[s:e].tobytes(), vo.tobytes(),
            values.data[voffs[s]: voffs[e]].tobytes(),
        ])
        raw_len = len(body)
        bflags = 0
        stored = body
        if compress:
            c = zlib.compress(body, 1)
            if len(c) < raw_len:
                stored = c
                bflags = 1
        header = block_format._HEADER.pack(
            block_format.BLOCK_MAGIC, e - s, w_out * 4, bflags,
            len(stored), raw_len)
        crc = zlib.crc32(header[4:] + stored)
        blk = header + stored + np.uint32(crc).tobytes()
        blocks.append(blk)
        index_items.append((key_at(e - 1), data_off, len(blk), e - s))
        data_off += len(blk)
    first_key = key_at(0) if n_rows else b""
    last_key = key_at(n_rows - 1) if n_rows else b""
    return blocks, index_items, hashes, first_key, last_key
