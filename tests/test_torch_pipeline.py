"""Device step of the PyTorch port against the JAX package, on the CPU:
the plain-PyTorch twins of kernels K1 (window_canonicals, also at the edges
of the kernel's rolled runs, and the rolling recurrence itself), K3 (top2,
also at the edges of its forms, given the largest label T where known)
and the whole classify_batch in its three scoring forms, held to exact
integer equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jn_cuclark_tpu.ops import device_pipeline as jdp
from jn_cuclark_tpu.ops import radix_table as jrt
from jn_cuclark_tpu.ops import score as jscore
from jn_cuclark_tpu_torch.ops import (bits, device_pipeline, kernels,
                                      radix_table, score)
from jn_cuclark_tpu_torch.utils import native

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)


def _reads(rng, n, lo, hi, n_frac=0.05):
    """FASTA of random reads of lengths [lo, hi) with N characters, plus
    reads shorter than any k and an all-T read (the all-ones window)."""
    seqs = []
    for _ in range(n):
        s = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=rng.integers(lo, hi))
        s[rng.random(len(s)) < n_frac] = ord("N")
        seqs.append(s.tobytes())
    seqs += [b"ACG", b"", b"T" * 80, b"A" * 40]
    return b"".join(b">r%d\n%s\n" % (i, s) for i, s in enumerate(seqs))


def _packed(data, stride):
    _, _, _, ss, se, ln = native.scan_reads(data)
    return native.pack_batch(data, ss, se, stride), ln


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


def _jax_q(words, vwords, k, pc):
    canon, valid = jdp.window_canonicals(
        jnp.asarray(words), jnp.asarray(vwords), k, pc
    )
    return np.where(np.asarray(valid), np.asarray(canon), EMPTY)


@pytest.mark.parametrize("k", [9, 27, 31, 32])
def test_window_canonicals_plain_equals_jax(k):
    rng = np.random.default_rng(k)
    data = _reads(rng, 40, 1, 250)
    (words, vwords), ln = _packed(data, 256)
    for pc in (None, 64, 1):  # full width, a probe_cols trim, W = 1
        want = _jax_q(words, vwords, k, pc)
        got = device_pipeline.window_canonicals(_t(words), _t(vwords), k, pc)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy().view(np.uint64), want), pc


def test_valid_canonical_is_never_empty_at_k32():
    """classify_batch recomputes the miss mask as q != EMPTY; at k = 32 all
    64 bits are in use, and the all-ones window (all T) must still come out
    as its reverse complement 0, never as EMPTY."""
    k = 32
    data = b">t\n" + b"T" * 128 + b"\n>a\n" + b"A" * 100 + b"\n"
    (words, vwords), _ = _packed(data, 128)
    q = device_pipeline.window_canonicals(_t(words), _t(vwords), k)
    canon, valid = jdp.window_canonicals(jnp.asarray(words), jnp.asarray(vwords), k)
    valid = np.asarray(valid)
    assert np.array_equal(q.numpy() != bits.EMPTY, valid)
    assert (q.numpy()[0, : 128 - k + 1] == 0).all()  # TTT...T -> AAA...A = 0


def _edge_reads(rng, stride, k):
    """Reads up to `stride` long with N as the first and as the last
    character of some window, reads of exactly k characters and an all-T
    read (the all-ones window at k = 32)."""
    seqs = []
    for n_at in ((0,), (k - 1, k), (stride // 2,), (stride - 1,)):
        s = bytearray(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=stride))
        for i in n_at:
            s[i] = ord("N")
        seqs.append(bytes(s))
    seqs += [b"G" * k, b"T" * stride, b"A" * (k - 1)]
    for _ in range(12):
        s = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                       size=rng.integers(1, stride + 1))
        s[rng.random(len(s)) < 0.02] = ord("N")
        seqs.append(s.tobytes())
    return b"".join(b">r%d\n%s\n" % (i, s) for i, s in enumerate(seqs))


@pytest.mark.parametrize("stride", [64, 4096])
@pytest.mark.parametrize("k", [27, 31, 32])
def test_window_canonicals_plain_equals_jax_at_edges(stride, k):
    """K1's rolled runs meet their edges at these shapes: rows of one and
    of many run tiles, N on window edges, rows of exactly k characters, and
    W no multiple of the run length (a probe_cols trim of 13 or 3,001)."""
    rng = np.random.default_rng(stride + k)
    (words, vwords), _ = _packed(_edge_reads(rng, stride, k), stride)
    for pc in (None, 13 if stride == 64 else 3001):
        want = _jax_q(words, vwords, k, pc)
        got = device_pipeline.window_canonicals(_t(words), _t(vwords), k, pc)
        assert np.array_equal(got.numpy().view(np.uint64), want), pc


@pytest.mark.parametrize("k", [1, 31, 32])
def test_rolled_revcomp_equals_revcomp(k):
    """K1's rolling recurrence on int64 carriers: from one window's x and
    rc = revcomp(x), each next character c gives x' = (x >> 2) |
    (c << (2k-2)) and rc' = ((rc << 2) | (3 - c)) & mask, which equal the
    next window's value and _revcomp of it (at k = 32 the mask is all ones
    and the sign bit is in use)."""
    rng = np.random.default_rng(k)
    n, steps = 64, 40
    chars = torch.from_numpy(rng.integers(0, 4, size=(n, k + steps)))
    chars[0] = 3  # all T: x all ones at k = 32
    shifts = 2 * torch.arange(k, dtype=torch.int64)

    def value(p):
        return (chars[:, p : p + k] << shifts).sum(dim=1)

    mask = -1 if k == 32 else (1 << (2 * k)) - 1
    x = value(0)
    rc = device_pipeline._revcomp(x, k)
    for p in range(1, steps + 1):
        c = chars[:, p + k - 1]
        x = bits.lsr(x, 2) | (c << (2 * k - 2))
        rc = ((rc << 2) | (3 - c)) & mask
        assert torch.equal(x, value(p))
        assert torch.equal(rc, device_pipeline._revcomp(x, k))


TOP2_CASES = {
    # ties on count resolve to the lowest label, for best and second best
    "ties": (np.array([[3, 3, 5, 5, 7, 0], [2, 2, 9, 9, 9, 1],
                       [4, 0, 4, 6, 6, 6]], np.int32), 9),
    "empty_rows": (np.zeros((3, 7), np.int32), 1),
    "one_window": (np.array([[0], [5], [65535]], np.int32), 65535),
}


def _top2_case(case):
    """(lab [R, W] int32, T: the largest label it may hold, or None) from a
    numpy seed; beside the fixed cases, the edges of K3's forms
    (kernels.top2_forms)."""
    if case in TOP2_CASES:
        return TOP2_CASES[case]
    rng = np.random.default_rng(TOP2_CASE_NAMES.index(case))
    tile = kernels.K3_TILE_W
    top = (1 << 31) - 1
    if case == "random":
        lab = rng.integers(0, 6, size=(64, 300))
        lab[::5] = 0
        return lab.astype(np.int32), 5
    if case in ("W=tile", "W=tile+1"):
        w = tile + (case == "W=tile+1")
        return rng.integers(0, 300, size=(3, w)).astype(np.int32), 299
    if case == "224 distinct":  # the hash form's fullest table
        return np.stack([rng.permutation(65535)[:224] + 1
                         for _ in range(4)]).astype(np.int32), 65535
    if case == "one label":  # the most same-address atomics
        return np.full((4, 224), 9, np.int32), 9
    if case == "labels equal to T":
        lab = rng.choice([0, 16, 16, 2], size=(8, 224))
        lab[0] = 16
        return lab.astype(np.int32), 16
    if case == "17-bit labels":
        return rng.integers(0, 1 << 17, size=(8, 400)).astype(np.int32), None
    if case == "near 2^31-1":
        lab = rng.integers(top - 3000, top + 1, size=(8, 224))
        lab[0, :30] = top
        lab[1, ::2] = 0
        return lab.astype(np.int32), None
    if case == "ragged R":  # no multiple of the 8 reads a block
        return rng.integers(0, 17, size=(13, 224)).astype(np.int32), 16
    # "W=672": the cycled-labels width, 3 cycles of 224 windows
    return rng.integers(0, 5001, size=(8, 672)).astype(np.int32), 5000


TOP2_CASE_NAMES = ["ties", "empty_rows", "one_window", "random", "W=tile",
                   "W=tile+1", "224 distinct", "one label",
                   "labels equal to T", "17-bit labels", "near 2^31-1",
                   "ragged R", "W=672"]


@pytest.mark.parametrize("case", TOP2_CASE_NAMES)
def test_top2_plain_equals_jax(case):
    lab, T = _top2_case(case)
    want = [np.asarray(a) for a in jscore.top2_from_labels(jnp.asarray(lab))]
    got = score.top2_from_labels(torch.from_numpy(lab), n_targets=T)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("k", [9, 31])
def test_classify_batch_equals_jax(k):
    """Reads drawn from stored k-mer sequences hit; the rest mostly miss."""
    rng = np.random.default_rng(100 + k)
    data = _reads(rng, 60, 20, 200, n_frac=0.01)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=3000).tobytes()
    keys = native.extract_canonical(b">g\n" + genome + b"\n", k, False, 1)
    keys = np.unique(keys)
    labels1 = rng.integers(1, 4, size=len(keys)).astype(np.int32)
    table = jrt.build(keys, labels1, k=k)
    hits = b"".join(
        b">h%d\n%s\n" % (i, genome[p : p + 150])
        for i, p in enumerate(rng.integers(0, 2800, size=20))
    )
    (words, vwords), ln = _packed(data + hits, 256)
    pc = 224
    want = jdp.classify_batch(
        jnp.asarray(table.slots), jnp.asarray(table.labels),
        jnp.asarray(table.stash_keys), jnp.asarray(table.stash_labels),
        jnp.asarray(words), jnp.asarray(vwords), k=k, n_targets=3,
        extended=False, probe_cols=pc, **table.meta,
    )
    tbl = radix_table.to_device(table, "cpu")
    got = device_pipeline.classify_batch(
        tbl, _t(words), _t(vwords), k=k, n_targets=3, probe_cols=pc
    )
    for g, w in zip(got[:4], want[:4]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got[4].shape == (len(words), 0)
    assert (got[2].numpy()[-20:] > 0).all()  # the drawn reads hit


def test_classify_batch_rejects_extended():
    """The extended forms, formerly rejected here, score as the JAX
    package's classify_batch does: the sorted u16 label grid ("sorted") and
    the dense [R, T+1] counts (True)."""
    rng = np.random.default_rng(11)
    keys = np.unique(rng.integers(0, 1 << 18, size=3000, dtype=np.uint64))
    labels1 = rng.integers(1, 6, size=len(keys)).astype(np.int32)
    table = jrt.build(keys, labels1, k=9)
    data = _reads(rng, 50, 9, 120, n_frac=0.02)
    (words, vwords), _ = _packed(data, 128)
    tbl = radix_table.to_device(table, "cpu")
    for ext in (True, "sorted"):
        want = jdp.classify_batch(
            jnp.asarray(table.slots), jnp.asarray(table.labels),
            jnp.asarray(table.stash_keys), jnp.asarray(table.stash_labels),
            jnp.asarray(words), jnp.asarray(vwords), k=9, n_targets=5,
            extended=ext, probe_cols=96, **table.meta,
        )
        got = device_pipeline.classify_batch(
            tbl, _t(words), _t(vwords), k=9, n_targets=5, extended=ext,
            probe_cols=96,
        )
        for g, w in zip(got[:4], want[:4]):
            assert np.array_equal(g.numpy(), np.asarray(w)), ext
        extra = got[4].numpy()
        if ext == "sorted":
            extra = extra.view(np.uint16)
        assert np.array_equal(extra, np.asarray(want[4])), ext
