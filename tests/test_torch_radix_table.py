"""Radix table of the PyTorch port against the JAX package: the host build,
the shared `.idx.npz` cache, and the plain-PyTorch probe (twin of kernel
K2, on forged hi collisions and hot rows too), all held to exact equality;
and the bin plan of the grouped probes K2 and K8."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from jn_cuclark_tpu.ops import radix_table as jrt
from jn_cuclark_tpu_torch.ops import kernels
from jn_cuclark_tpu_torch.ops import radix_table as rt

# (n keys, key bits, max label+1, c, load): the default build, a forced
# stash (narrow rows at high load), and lb = 17 (65,534 targets, the
# reference's MTRGTS cap) where a signed hit test would take false hits
CASES = {
    "default": (20_000, 54, 100, None, None),
    "stash": (3000, 54, 50, 4, 16.0),
    "lb17": (300_000, 64, 65535, None, None),
}


def _keys(case):
    n, kbits, maxlab, c, load = CASES[case]
    rng = np.random.default_rng(n)
    top = (1 << kbits) - 2
    keys = np.unique(rng.integers(0, top, size=2 * n, dtype=np.uint64))[:n]
    labels1 = rng.integers(1, maxlab + 1, size=len(keys)).astype(np.int32)
    return rng, keys, labels1, c, load


@pytest.fixture(scope="module", params=sorted(CASES))
def built(request):
    rng, keys, labels1, c, load = _keys(request.param)
    want = jrt.build(keys, labels1, k=31, c=c, load=load)
    got = rt.build(keys, labels1, k=31, c=c, load=load)
    return request.param, rng, keys, labels1, want, got


def test_build_equals_jax(built):
    case, _, _, _, want, got = built
    assert (got.m1, got.lb, got.slot_width) == (want.m1, want.lb, want.slot_width)
    assert np.array_equal(got.slots, want.slots)
    assert np.array_equal(got.stash_keys, want.stash_keys)
    assert np.array_equal(got.stash_labels, want.stash_labels)
    if case == "stash":
        assert (got.stash_keys != rt.EMPTY).any()
    if case == "lb17":
        assert got.lb == 17


def test_probe_plain_equals_jax(built):
    case, rng, keys, labels1, want, got = built
    miss = rng.integers(0, (1 << 64) - 2, size=4000, dtype=np.uint64)
    q = np.concatenate([keys, miss, np.full(16, jrt.EMPTY, np.uint64)])
    q = q[rng.permutation(len(q))]
    ref = np.asarray(jrt.probe(
        jnp.asarray(want.slots), jnp.asarray(want.labels),
        jnp.asarray(want.stash_keys), jnp.asarray(want.stash_labels),
        jnp.asarray(q), **want.meta,
    ))
    tbl = rt.to_device(got, "cpu")
    lab = rt.probe(tbl, torch.from_numpy(q.view(np.int64)))
    assert lab.dtype == torch.int32
    assert np.array_equal(lab.numpy(), ref)
    # every stored key answers its own label, EMPTY queries answer 0
    assert np.array_equal(
        rt.probe(tbl, torch.from_numpy(keys.view(np.int64))).numpy(), labels1
    )
    assert not lab.numpy()[q == jrt.EMPTY].any()


def test_to_device_keeps_the_bits(built):
    _, _, _, _, _, got = built
    tbl = rt.to_device(got, "cpu")
    assert tbl.slots.dtype == torch.int32 and tbl.stash_keys.dtype == torch.int64
    assert np.array_equal(tbl.slots.numpy().view(np.uint32), got.slots)
    assert np.array_equal(tbl.stash_keys.numpy().view(np.uint64), got.stash_keys)
    assert (tbl.m1, tbl.lb, tbl.c) == (got.m1, got.lb, got.slot_width)
    assert tbl.nbytes == got.slots.nbytes + 64 * 12


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cache_loads_in_the_other_package(tmp_path, writer):
    _, keys, labels1, c, load = _keys("stash")
    table = rt.build(keys, labels1, c=c, load=load)
    sig = np.array([1, 2, 3], np.int64)
    path = str(tmp_path / "t.idx.npz")
    save, load_ = (jrt.save_cache, rt.load_cache) if writer == "jax" else (
        rt.save_cache, jrt.load_cache)
    save(path, table, signature=sig)
    back = load_(path, signature=sig)
    assert back is not None
    assert np.array_equal(back.slots, table.slots)
    assert np.array_equal(back.stash_keys, table.stash_keys)
    assert np.array_equal(back.stash_labels, table.stash_labels)
    assert back.meta == table.meta
    assert load_(path, signature=sig + 1) is None  # stale signature rebuilds


@pytest.mark.parametrize("kbits", [54, 64])  # k = 27 and k = 32 keys
def test_probe_plain_hi_collisions_and_hot_rows_equal_jax(kbits):
    """Slots whose hi half equals a missing query's t_hi (a miss only the
    lo word tells apart: K2 reads lo words only behind a matching hi word)
    and one row carrying 5,000 queries (K2 reads a row once for all of its
    queries)."""
    rng = np.random.default_rng(kbits)
    keys = np.unique(rng.integers(0, (1 << kbits) - 2, size=8000,
                                  dtype=np.uint64))
    labels1 = rng.integers(1, 300, size=len(keys)).astype(np.int32)
    table = jrt.build(keys, labels1)
    miss = rng.integers(0, (1 << 64) - 2, size=2001, dtype=np.uint64)
    assert chip_smoke.forge_hi_collisions(table, miss) > 1000
    hot = chip_smoke.hot_row_queries(rng, keys, table.m1, 5000)
    assert (jrt._mix_np(hot, table.m1) == jrt._mix_np(hot[:1], table.m1)).all()
    q = np.concatenate([keys, miss, hot])
    want = np.asarray(jrt.probe(
        jnp.asarray(table.slots), jnp.asarray(table.labels),
        jnp.asarray(table.stash_keys), jnp.asarray(table.stash_labels),
        jnp.asarray(q), **table.meta))
    lab = rt.probe(rt.to_device(table, "cpu"), torch.from_numpy(q.view(np.int64)))
    assert np.array_equal(lab.numpy(), want)
    assert np.array_equal(want[: len(keys)], labels1)
    assert not want[len(keys) : len(keys) + len(miss)].any()
    assert want[len(keys) + len(miss):].any()  # stored keys of the hot row


@pytest.mark.parametrize("c", [2, 6, 128])
@pytest.mark.parametrize("m", range(1, 27))
def test_group_bins_cover_each_row_once(m, c):
    """K2's and K8's bin plan for a plane of 2^m rows: bin = row >> shift
    puts every row in one of n_bins bins, none empty, no more bins than the
    partition passes take, and a tile's shared memory (its queries and one
    counter per row >> kshift of a bin) fits one block.  K8's plane-2 form
    at the same shape: local only where the plane's hi halves fit
    GROUP_LOCAL_BYTES, which keeps the staged plane in shared memory."""
    rows = 1 << m
    shift, n_bins, kshift = kernels.group_bins(rows)
    assert 1 <= n_bins <= kernels.K7_MAX_BINS
    assert (n_bins - 1) << shift < rows <= n_bins << shift
    assert n_bins == min(rows, kernels.K7_MAX_BINS)
    if m <= 16:
        per_bin = np.bincount(np.arange(rows) >> shift)
        assert len(per_bin) == n_bins and per_bin.min() > 0
    assert shift - kshift <= kernels.GROUP_KEY_BITS
    assert kernels.group_smem_bytes(shift, kshift) <= kernels.SMEM_BYTES
    local = kernels.plane2_form(m, c) == "local"
    assert local == ((4 * c) << m <= kernels.GROUP_LOCAL_BYTES)
    if local:  # the plane's slots and a count a row, staged by every block
        assert kernels.plane2_smem_bytes(m, c) <= kernels.SMEM_BYTES
