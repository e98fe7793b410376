"""K6's bucketed form on the CPU: the level plan (ops/bucket_plan.py) and
the plain-PyTorch twin of each of its launches
(db/device_build.aggregate_bucketed_plain), run at a bucket capacity of 64
so that every branch of the plan runs at a small size -- a bucket split
over several levels, a single-key group over the capacity in the middle of
the range and as the 2^64-1 pad, k = 32 keys with bit 63 set, n = 0 and 1,
all keys equal, labels up to 65,535 -- each case exact against the JAX
package's device aggregate and the native host aggregate."""

import numpy as np
import pytest
import torch

from jn_cuclark_tpu.db import device_build as jdevice_build
from jn_cuclark_tpu_torch.db import builder, device_build
from jn_cuclark_tpu_torch.ops import bucket_plan, kernels
from jn_cuclark_tpu_torch.utils import native

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
PG5 = np.array([0, 1, 2, 2, 3], np.int32)


def _labels(rng, n, n_labels=5):
    return rng.integers(0, n_labels, size=n).astype(np.int32)


def _nested(rng):
    """Four populations of 200 keys from one base, spans 2^50, 2^35, 2^20
    and 2^8: each level's densest bucket holds the narrower ones."""
    base = np.uint64(1 << 40)
    c = np.concatenate([base + rng.integers(0, 1 << s, size=200,
                                            dtype=np.uint64)
                        for s in (50, 35, 20, 8)])
    return c, _labels(rng, len(c)), PG5


def _single_mid(rng):
    """500 occurrences of one key in the middle of 2,000 spread keys."""
    bg = rng.integers(0, 1 << 62, size=2000, dtype=np.uint64)
    mid = np.uint64(1 << 61)
    c = np.concatenate([bg[:1000], np.full(500, mid), bg[1000:]])
    return c, _labels(rng, len(c)), PG5


def _k32(rng, pad=0):
    """k = 32 keys, half with bit 63 set, repeats of up to 300; `pad`
    entries of the 2^64-1 sentinel appended."""
    uniq = rng.integers(0, 1 << 63, size=1000, dtype=np.uint64)
    uniq[::2] |= np.uint64(1 << 63)
    c = np.concatenate([uniq[rng.integers(0, 1000, size=3000)],
                        np.full(300, uniq[1]), np.full(pad, U64_MAX)])
    label = _labels(rng, len(c))
    label[3000:3300] = np.arange(300) % 5  # mult caps at 255
    label[3300:] = 0
    return c, label, PG5


def _wide_labels(rng):
    """Labels up to 65,535 over 65,536 prefix groups of pairs."""
    uniq = rng.integers(0, 1 << 62, size=600, dtype=np.uint64)
    c = uniq[rng.integers(0, 600, size=4000)]
    label = rng.integers(0, 65536, size=len(c)).astype(np.int32)
    label[:50] = 65535
    return c, label, (np.arange(65536) // 2).astype(np.int32)


CASES = {
    # name: (make, lelement, the plan's count that must rise)
    "split over levels": (_nested, True, "split"),
    "single key mid-range": (_single_mid, False, "single"),
    "k32 bit 63": (_k32, True, None),
    "k32 bit 63 lelement off": (_k32, False, None),
    "pad group": (lambda rng: _k32(rng, pad=1000), True, "single"),
    "all keys equal": (
        lambda rng: (np.full(500, np.uint64(12345)), _labels(rng, 500), PG5),
        True, "single"),
    "n=1": (lambda rng: (np.full(1, np.uint64(7)), np.zeros(1, np.int32),
                         PG5), True, "small"),
    "n=0": (lambda rng: (np.zeros(0, np.uint64), np.zeros(0, np.int32), PG5),
            True, None),
    "labels to 65535": (_wide_labels, True, None),
}


def _twin(canon, label, pg, lelement, cap, stats=None):
    got = device_build.aggregate_bucketed_plain(
        torch.from_numpy(canon.view(np.int64)), torch.from_numpy(label),
        torch.from_numpy(pg), lelement, cap=cap, stats=stats)
    got = [g.numpy() for g in got]
    got[0] = got[0].view(np.uint64)
    return got


def _same_rows(got, *wants):
    for want in wants:
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            assert np.array_equal(g, w)


@pytest.mark.parametrize("name", sorted(CASES))
def test_bucketed_twin_matches_jax_and_host(name):
    make, lelement, branch = CASES[name]
    canon, label, pg = make(np.random.default_rng(len(name)))
    stats = {}
    got = _twin(canon, label, pg, lelement, 64, stats)
    _same_rows(got, jdevice_build.aggregate_device(canon, label, pg, lelement),
               native.aggregate_occurrences(canon, label, pg, lelement))
    if branch:
        assert stats[branch] > 0, stats
    if name == "split over levels":
        assert stats["levels"] >= 3
    if name == "pad group":
        assert got[0][-1] == U64_MAX and got[3][-1] == 254
    if name == "all keys equal":
        assert stats == dict(levels=1, ranges=1, small=0, single=1, split=0)


@pytest.mark.parametrize("cap", [64, 128, bucket_plan.CAP])
def test_bucketed_twin_capacities_agree(cap):
    """One input through three capacities (three plans) gives one answer;
    a capacity past the kernel's, whose places would not fit IDX_BITS, is
    refused."""
    rng = np.random.default_rng(cap)
    c1, l1, _ = _nested(rng)
    c2, l2, _ = _k32(rng, pad=700)
    canon, label = np.concatenate([c1, c2]), np.concatenate([l1, l2])
    got = _twin(canon, label, PG5, True, cap)
    _same_rows(got, native.aggregate_occurrences(canon, label, PG5, True))
    with pytest.raises(ValueError, match="capacity"):
        _twin(canon, label, PG5, True, 2 * bucket_plan.CAP)


def test_digit_plan():
    cap = bucket_plan.CAP
    assert bucket_plan.digit_plan(5, 5, 10**6, 64) == (0, 0)
    # 21M keys: 18 bits of buckets in two levels of 9
    assert bucket_plan.digit_plan(0, (1 << 60) - 1, 21_000_000, cap) == (
        51, 9)
    assert bucket_plan.digit_plan(0, (1 << 64) - 1, 1 << 25, cap) == (55, 9)
    assert bucket_plan.digit_plan(0, (1 << 51) - 1, 660_000, cap) == (38, 13)
    assert bucket_plan.digit_plan(0, (1 << 62) - 1, 1 << 31, cap) == (50, 12)
    # few keys over a wide range: still KEY_BITS at most below the digit
    assert bucket_plan.digit_plan(0, (1 << 64) - 1, 100, cap) == (56, 8)
    assert bucket_plan.digit_plan(8, 11, 4000, 64) == (0, 2)  # 2 bits differ
    assert bucket_plan.digit_plan(1 << 63, (1 << 63) + 1000, 1000, 64) == (
        5, 5)


def test_read_plan_and_sort_lengths():
    """The plan reads back the counts, and min and max keys only for the
    buckets over the capacity (those split or, of one key, reduce)."""
    plan = torch.tensor([[0, 1, 64, 65, 65, 1000],
                         [0, 3, 3, 9, 9, -2], [0, 3, 8, 9, 10, -2]])
    counts, over, mins, maxs = bucket_plan.read_plan(plan, 64)
    assert counts.tolist() == [0, 1, 64, 65, 65, 1000]
    assert over.tolist() == [3, 4, 5]
    assert mins.tolist() == [9, 9, 2**64 - 2] and maxs.tolist() == [
        9, 10, 2**64 - 2]
    assert bucket_plan.sort_lens(np.array([1, 64, 65, 200]), 256) == [
        64, 128, 256]
    assert bucket_plan.sort_lens(np.array([129, 256]), 256) == [256]
    assert bucket_plan.sort_lens(np.array([3, 64]), 64) == [64]
    assert bucket_plan.sort_lens(np.array([100]), 100) == [128]
    assert bucket_plan.capacity(1) == 1024
    assert bucket_plan.capacity(21_000_000) == 1 << 25
    assert bucket_plan.capacity(1 << 25) == 1 << 25


def test_block_table_covers_each_range_once():
    ranges = [(0, 100_000, 0, 1 << 40), (100_000, 37, 5, 900),
              (100_037, 9000, 0, 1 << 20)]
    table = bucket_plan.level_table(ranges, bucket_plan.CAP)
    assert table[:, 3].tolist() == [10, 1, 7]
    assert table[:, 4].tolist() == [0, 1 << 10, (1 << 10) + 2]
    blocks = bucket_plan.block_table(table, 8)
    for r, (s, c, *_) in enumerate(table):
        mine = blocks[blocks[:, 0] == r]
        assert mine[0, 1] == s and mine[-1, 2] == s + c
        assert np.array_equal(mine[1:, 1], mine[:-1, 2])
    chunks = blocks[:, 2] - blocks[:, 1]
    assert chunks.max() % 32 == 0 and chunks.max() >= 4096


def test_unpadded_partition_equals_padded_form():
    """The builder now hands a partition's n occurrences to the device as
    they are; the rows equal those of the padded form it used before (pad
    to a power of two with the 2^64-1 sentinel, aggregate, drop the pad's
    trailing group)."""
    rng = np.random.default_rng(9)
    canon, label, pg = _k32(rng)
    kv = np.empty(len(canon), native.KV_DTYPE)
    kv["k"] = canon
    kv["v"] = (np.arange(len(canon)) << 16) | label
    got = builder._aggregate_partition_device(kv, 0, len(canon), pg, True,
                                              "cpu")
    pad = (1 << 20) - len(canon)
    padded = device_build.aggregate_device(
        np.concatenate([canon, np.full(pad, U64_MAX)]),
        np.concatenate([label, np.zeros(pad, np.int32)]), pg, True, "cpu")
    assert padded[0][-1] == U64_MAX
    _same_rows(list(got), [a[:-1] for a in padded])


def test_wrapper_takes_cuda_tensors_only():
    """kernels.aggregate launches K6 or raises: a CPU tensor is refused
    (the CPU runs the twin through device_build._aggregate_device)."""
    canon = torch.zeros(4, dtype=torch.int64)
    label = torch.zeros(4, dtype=torch.int32)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="must be on"):
        kernels.aggregate(canon, label, label[:1], True)
    assert kernels.LAUNCHES["aggregate"] == 0
