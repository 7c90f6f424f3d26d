"""The port's MVCC GC + decision packing against the JAX package's.

`yugabyte_tpu_torch.ops.merge_gc.gc_over_sorted` + `pack_bits_u32` (and
the kernel-B plain version `gc_pack_plain`) are held against
`yugabyte_tpu.ops.merge_gc.gc_over_sorted` + `pack_bits_u32` over
pre-sorted cols matrices made from a seed with numpy. Every value is an
integer, so the tolerance is exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_run_merge import _make_run
from yugabyte_tpu.ops import merge_gc as ref
from yugabyte_tpu.ops.slabs import FLAG_HAS_TTL, FLAG_TOMBSTONE, concat_slabs
from yugabyte_tpu_torch.ops import merge_gc as port

# The tier-1 run shares the host's cores among its workers: one intra-op
# thread keeps these small tensors from starving the cluster tests
# running beside them.
torch.set_num_threads(1)

W = 4

# The JAX package runs gc_over_sorted inside its jitted programs; jitted
# here too, it compiles once per shape and mode (w, is_major,
# retain_deletes, snapshot static) instead of compiling each of its
# operations eagerly, about 16 s in every process that runs a case.
_gc_jit = jax.jit(ref.gc_over_sorted, static_argnums=(1, 6, 7, 8))


def _sorted_cols(runs):
    """Merge the runs on the host (internal-key order, stable) and pack
    them padded to a power-of-two bucket: a pre-sorted matrix with pad
    rows at the tail."""
    slab = concat_slabs(runs)
    inv = np.uint32(0xFFFFFFFF)
    keys = [slab.write_id ^ inv, slab.ht_lo ^ inv, slab.ht_hi ^ inv,
            slab.key_len.astype(np.uint32)]
    keys += [slab.key_words[:, j] for j in range(slab.width_words - 1, -1, -1)]
    order = np.lexsort(tuple(keys))
    cols, n, n_pad, w = ref.pack_cols(slab, w_pad_override=W)
    real = cols[:, :n][:, order]
    cols[:, :n] = real
    return cols, n


def _equal_ht_runs(rng):
    """Version stacks that share a hybrid time and differ in write id
    (INSERT batches), with tombstones and root overwrites mixed in."""
    runs = []
    for g in range(3):
        slab = _make_run(rng, 120, key_space=12, tomb_frac=0.2)
        slab.ht_hi[:] = 0
        slab.ht_lo[:] = ((rng.integers(1, 4, size=slab.n) << 12)
                         .astype(np.uint32))
        slab.write_id[:] = rng.integers(0, 3, size=slab.n).astype(np.uint32)
        inv = np.uint32(0xFFFFFFFF)
        order = np.lexsort((slab.write_id ^ inv, slab.ht_lo ^ inv,
                            slab.key_len.astype(np.uint32),
                            slab.key_words[:, 2], slab.key_words[:, 1],
                            slab.key_words[:, 0]))
        for f in ("key_words", "key_len", "doc_key_len", "ht_hi", "ht_lo",
                  "write_id", "flags", "ttl_ms"):
            setattr(slab, f, getattr(slab, f)[order])
        runs.append(slab)
    return runs


def _case(name, seed):
    rng = np.random.default_rng(seed)
    if name == "stacks":
        return [_make_run(rng, 300, key_space=40) for _ in range(3)]
    if name == "ttl":
        return [_make_run(rng, 250, key_space=30, ttl_frac=0.5,
                          tomb_frac=0.2) for _ in range(3)]
    if name == "tombstones":
        return [_make_run(rng, 200, key_space=25, tomb_frac=0.5)
                for _ in range(4)]
    if name == "equal_ht":
        return _equal_ht_runs(rng)
    if name == "wide_ht":    # ht_hi varies: cutoff compare on both limbs
        return [_make_run(rng, 300, key_space=50, ht_lo_bits=34)
                for _ in range(2)]
    raise AssertionError(name)


CASES = ["stacks", "ttl", "tombstones", "equal_ht", "wide_ht"]
CUTOFFS = [0, (1 << 19) << 12, (1 << 21) << 12, (1 << 62)]


def _limbs(cutoff):
    phys = cutoff >> 12
    return cutoff >> 32, cutoff & 0xFFFFFFFF, phys >> 20, phys & 0xFFFFF


def _ref_gc(cols, cutoff, is_major, retain, snapshot):
    hi, lo, phi, plo = _limbs(cutoff)
    keep, mk = _gc_jit(
        jnp.asarray(cols), W, jnp.uint32(hi), jnp.uint32(lo),
        jnp.uint32(phi), jnp.uint32(plo), is_major, retain, snapshot)
    n = cols.shape[1]
    return (np.asarray(keep), np.asarray(mk),
            np.asarray(ref.pack_bits_u32(keep, n)),
            np.asarray(ref.pack_bits_u32(mk, n)))


def _port_gc(cols, cutoff, is_major, retain, snapshot):
    s = torch.from_numpy(cols.view(np.int32))
    keep, mk = port.gc_over_sorted(s, W, *_limbs(cutoff), is_major=is_major,
                                   retain_deletes=retain, snapshot=snapshot)
    n = cols.shape[1]
    return (keep.numpy(), mk.numpy(),
            port.pack_bits_u32(keep, n).numpy().view(np.uint32),
            port.pack_bits_u32(mk, n).numpy().view(np.uint32))


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("cutoff", CUTOFFS)
@pytest.mark.parametrize("is_major,retain", [(True, False), (False, False),
                                             (True, True)])
def test_gc_matches_reference(name, cutoff, is_major, retain):
    cols, _n = _sorted_cols(_case(name, 7))
    got = _port_gc(cols, cutoff, is_major, retain, False)
    want = _ref_gc(cols, cutoff, is_major, retain, False)
    for g, w_ in zip(got, want):
        assert np.array_equal(g, w_)


@pytest.mark.parametrize("name", CASES)
def test_gc_snapshot_matches_reference(name):
    cols, _n = _sorted_cols(_case(name, 11))
    cutoff = (1 << 20) << 12
    got = _port_gc(cols, cutoff, False, False, True)
    want = _ref_gc(cols, cutoff, False, False, True)
    for g, w_ in zip(got, want):
        assert np.array_equal(g, w_)


def test_gc_exercises_every_rule():
    """The cases above reach every GC rule at least once."""
    cols, n = _sorted_cols(_case("ttl", 7))
    keep, mk, _, _ = _port_gc(cols, (1 << 22) << 12, False, False, False)
    assert mk.any()                                  # TTL -> tombstone
    keep_maj, _, _, _ = _port_gc(cols, (1 << 22) << 12, True, False, False)
    flags = cols[port._ROW_FLAGS, :n]
    assert not keep_maj[:n][(flags & FLAG_TOMBSTONE) != 0].all()
    assert ((flags & FLAG_HAS_TTL) != 0).any()
    # the raw GC keeps the first pad row (a visible version of the pad
    # "key"); the decision packing masks every pad row out
    assert cols.shape[1] > n and keep[n] and not keep[n + 1:].any()
    p_mat = torch.from_numpy(np.concatenate(
        [cols, np.arange(cols.shape[1], dtype=np.uint32)[None]]).view(np.int32))
    _packed, keep_p, _mk = port.gc_pack(
        p_mat, cols.shape[0], W, port.GCParams((1 << 22) << 12, False), 1,
        cols.shape[1])
    assert not keep_p.numpy()[n:].any()


@pytest.mark.parametrize("k_pad,m", [(1, 1024), (2, 512), (4, 256)])
@pytest.mark.parametrize("is_major", [True, False])
def test_gc_pack_plain_matches_reference_packing(k_pad, m, is_major):
    """gc_pack_plain (kernel B's twin) == the JAX package's GC + pad mask +
    keep/mk/source-plane packing (pallas_merge.py:310-320)."""
    cols, n = _sorted_cols(_case("ttl", 3))
    assert cols.shape[1] == 1024
    rng = np.random.default_rng(5)
    perm = rng.permutation(1024).astype(np.int32)
    cutoff = (1 << 21) << 12
    hi, lo, phi, plo = _limbs(cutoff)
    s = jnp.asarray(cols)
    keep, mk = _gc_jit(
        s, W, jnp.uint32(hi), jnp.uint32(lo), jnp.uint32(phi),
        jnp.uint32(plo), is_major, False, False)
    keep = keep & (s[ref._ROW_KEY_LEN] != jnp.uint32(ref.PAD_SENTINEL))
    groups = [ref.pack_bits_u32(keep, 1024), ref.pack_bits_u32(mk, 1024)]
    src = (jnp.asarray(perm) >> (m.bit_length() - 1)).astype(jnp.uint32)
    for t in range(max(1, (k_pad - 1).bit_length())):
        groups.append(ref.pack_bits_u32((src >> t) & 1, 1024))
    want = np.asarray(jnp.stack(groups, axis=1))

    p_mat = torch.from_numpy(np.concatenate(
        [cols, perm.view(np.uint32)[None]], axis=0).view(np.int32))
    packed, keep_t, mk_t = port.gc_pack(
        p_mat, cols.shape[0], W, port.GCParams(cutoff, is_major),
        k_pad, m)

    assert np.array_equal(packed.numpy().view(np.uint32), want)
    assert np.array_equal(keep_t.numpy(), np.asarray(keep))
    assert np.array_equal(mk_t.numpy(), np.asarray(mk))
