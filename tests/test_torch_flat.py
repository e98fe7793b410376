"""The flat sorted-array path of the PyTorch port (packed=False) on the CPU,
against the JAX package: the search's plain twins (the whole-array
searchsorted, and K9's steps through the radix directory) against
`lookup.lookup_labels`, K5's flat form's twin against `counts_from_hits` +
`read_results`, `_query_single`, the blocks of `shard_index`, and whole
CSVs of `Classifier(packed=False)` (plain, extended, FASTQ, on meshes of
3, 5 and 8), byte for byte; integer arrays exactly (tolerance 0)."""

import functools
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from jn_cuclark_tpu import params as jparams
from jn_cuclark_tpu.db import builder
from jn_cuclark_tpu.engine import BatchPlan as JBatchPlan
from jn_cuclark_tpu.engine import Classifier as JClassifier
from jn_cuclark_tpu.engine import _query_single as jquery_single
from jn_cuclark_tpu.io.targets import parse_targets as jparse_targets
from jn_cuclark_tpu.ops import lookup as jlookup
from jn_cuclark_tpu.ops import score as jscore
from jn_cuclark_tpu.parallel import mesh as jmesh
from jn_cuclark_tpu_torch.engine import BatchPlan, Classifier, _query_single
from jn_cuclark_tpu_torch.ops import lookup, score
from jn_cuclark_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_index

K = 9


@functools.lru_cache(maxsize=None)
def _k9_cases():
    return {label: (keys, labels1, q)
            for label, keys, labels1, q in chip_smoke.k9_cases()}


@pytest.mark.parametrize("case", ["k=32 bit 63", "one key", "n=1000003 k=31",
                                  "Q=1", "one key queried"])
def test_lookup_plain_equals_jax(case):
    """K9's twin searches u64 keys as the JAX package's searchsorted does:
    keys with bit 63 set, 2^64 - 2, the pad query, queries below the
    first key and past the last, N not a power of two."""
    keys, labels1, q = _k9_cases()[case]
    got = lookup.lookup_labels_plain(*chip_smoke._k9_tensors(
        keys, labels1, q, torch.device("cpu")))
    want = np.asarray(jlookup.lookup_labels(jnp.asarray(keys),
                                            jnp.asarray(labels1),
                                            jnp.asarray(q)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_lookup_empty_index_misses():
    """An empty index misses every query, through the whole-array search
    and through its directory (kmin > kmax)."""
    keys, labels1, q = _k9_cases()["empty index"]
    tk, tl, tq = chip_smoke._k9_tensors(keys, labels1, q, torch.device("cpu"))
    assert lookup.lookup_labels_plain(tk, tl, tq).tolist() == [0] * len(q)
    index = lookup.build_index(tk, tl)
    assert index.kmin > index.kmax and index.bits == 0
    got = lookup.lookup_labels_dir_plain(index, tq)
    assert got.tolist() == [0] * len(q)


# every phase-2 case but the empty index, which the JAX package cannot
# search (test_lookup_empty_index_misses)
K9_CASES = ["k=32 bit 63", "one key", "n=1000003 k=31", "Q=1",
            "one key queried", "cluster in one bucket",
            "two clusters far apart", "padded block", "pad keys alone",
            "range edges", "b=0 shift 64", "duplicate keys"]


@pytest.mark.parametrize("case", K9_CASES)
def test_lookup_directory_twin_equals_jax(case):
    """K9's steps (lookup_labels_dir_plain: the bucket of the radix
    directory, then a binary search of its keys) give the JAX package's
    lookup_labels on every phase-2 case: skewed and empty
    buckets, padded blocks, the range's edges, a shift of 64, the first of
    duplicate keys; and every stored key finds its first copy's label."""
    keys, labels1, q = _k9_cases()[case]
    tk, tl, tq = chip_smoke._k9_tensors(keys, labels1, q, torch.device("cpu"))
    index = lookup.build_index(tk, tl)
    got = lookup.lookup_labels_dir_plain(index, tq)
    want = np.asarray(jlookup.lookup_labels(jnp.asarray(keys),
                                            jnp.asarray(labels1),
                                            jnp.asarray(q)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        lookup.lookup_labels(index, tk).numpy(),
        chip_smoke.k9_stored(keys, labels1))


@pytest.mark.parametrize("case", ["one key", "empty index", "pad keys alone",
                                  "padded block", "cluster in one bucket",
                                  "b=0 shift 64", "n=1000003 k=31"])
def test_directory_layout(case):
    """build_index: 2^bits + 1 offsets, bits = clamp(ceil(log2 n) - 3,
    0, 22) for the n keys below the pad value, the least shift that fits
    kmax - kmin into 2^bits buckets, offsets[j] the first key at or above
    kmin + j * 2^shift, offsets[-1] = n (pads past it); an index of no key
    but pads has kmin > kmax."""
    keys, labels1, _ = _k9_cases()[case]
    d = lookup.build_index(chip_smoke._i64(keys), torch.from_numpy(labels1))
    n = int((keys != lookup.PAD_QUERY).sum())
    assert d.keys.shape == (len(keys),) and d.offsets.dtype == torch.int32
    assert d.offsets.shape == ((1 << d.bits) + 1,)
    if n == 0:
        assert d.kmin > d.kmax and d.offsets.tolist() == [0, 0]
        return
    assert d.bits == min(max((n - 1).bit_length() - 3, 0), 22)
    kmin, kmax = int(keys[0]), int(keys[n - 1])
    assert (kmax - kmin) >> d.shift < 1 << d.bits
    assert d.shift == 0 or (kmax - kmin) >> (d.shift - 1) >= 1 << d.bits
    # the first 64 buckets' starts, and the last's
    js = list(range(min(64, 1 << d.bits))) + [(1 << d.bits) - 1]
    starts = np.array([kmin + (j << d.shift) for j in js], np.uint64)
    np.testing.assert_array_equal(d.offsets[js].numpy(),
                                  np.searchsorted(keys[:n], starts))
    assert int(d.offsets[-1]) == n


def test_index_helpers_equal_jax():
    rng = np.random.default_rng(4)
    canon = rng.integers(0, 1 << 64, size=1001, dtype=np.uint64,
                         endpoint=False)
    labels = rng.integers(0, 300, size=1001).astype(np.uint16)
    keys, labels1 = lookup.prepare_index(canon, labels)
    jkeys, jlabels1 = jlookup.prepare_index(canon, labels)
    np.testing.assert_array_equal(keys, jkeys)
    np.testing.assert_array_equal(labels1, jlabels1)
    assert labels1.dtype == np.int32
    for m in (1, 3, 8):
        for a, b in zip(lookup.pad_index(keys, labels1, m),
                        jlookup.pad_index(jkeys, jlabels1, m)):
            np.testing.assert_array_equal(a, b)


@functools.lru_cache(maxsize=None)
def _k5_flat_cases():
    return {c[0]: c[1:] for c in chip_smoke.k5_flat_cases()}


@pytest.mark.parametrize("case", ["ties T=9", "T=16", "T=16 permuted",
                                  "T+1=4096", "T+1=4097", "T=65535",
                                  "no query", "one counter",
                                  "alternating labels"])
def test_counts_flat_plain_equals_jax(case):
    """K5's flat form's twin against counts_from_hits + read_results on
    ragged reads (of 0 and 1 queries too), ties and the pad queries, a
    permuted batch, 1,000 queries on one counter and labels alternating
    query by query; the JAX package sorts below 2^20 bins and scatters
    above."""
    lab, rid, R, T = _k5_flat_cases()[case]
    got = score.counts_flat(torch.from_numpy(lab), torch.from_numpy(rid), R, T)
    counts = jscore.counts_from_hits(jnp.asarray(lab), jnp.asarray(rid), R, T)
    want = (counts,) + tuple(jscore.read_results(counts))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_query_single_equals_jax():
    """The port's _query_single (the search, then K5's flat form) against
    the JAX package's on one padded batch: queries of 50 reads, stored keys
    and misses, the pad queries at read 0, n_reads = max_reads."""
    rng = np.random.default_rng(8)
    canon = np.unique(rng.integers(0, 1 << 18, size=3000, dtype=np.uint64))
    keys, labels1 = lookup.prepare_index(
        canon, rng.integers(0, 16, size=len(canon)).astype(np.uint16))
    sizes = rng.integers(0, 40, size=50)
    rid = np.repeat(np.arange(50, dtype=np.int32), sizes)
    q = np.where(rng.random(len(rid)) < 0.7,
                 keys[rng.integers(0, len(keys), size=len(rid))],
                 rng.integers(0, 1 << 18, size=len(rid), dtype=np.uint64))
    qcap = 4096
    q = np.concatenate([q, np.full(qcap - len(q), lookup.PAD_QUERY)])
    rid = np.concatenate([rid, np.zeros(qcap - len(rid), np.int32)])
    index = lookup.build_index(chip_smoke._i64(keys),
                               torch.from_numpy(labels1))
    got = _query_single(index, chip_smoke._i64(q), torch.from_numpy(rid),
                        n_targets=16, n_reads=64)
    want = jquery_single(jnp.asarray(keys), jnp.asarray(labels1),
                         jnp.asarray(q), jnp.asarray(rid), n_targets=16,
                         max_reads=64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def flat_db(tmp_path_factory):
    """Four random genomes, a k = 9 DB built by the JAX package's builder
    (four targets: 4 x 4,000 keys), and 240 reads of 1-300 bp (N's, junk
    and reads shorter than k among them), as FASTA and as FASTQ."""
    tmp = tmp_path_factory.mktemp("flatdb")
    rng = np.random.default_rng(21)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genomes = [rng.choice(acgt, size=1200).tobytes() for _ in range(4)]
    with open(tmp / "targets.txt", "w") as tf:
        for i, g in enumerate(genomes):
            p = tmp / f"g{i}.fa"
            p.write_bytes(b">g%d\n%s\n" % (i, g))
            tf.write(f"{p} {5000 + i}\n")
    prof = jparams.tiny(htsize=4093, k=K)
    builder.build_database(jparse_targets(str(tmp / "targets.txt")),
                           str(tmp), prof, K)
    fa, fq = [], []
    for i in range(240):
        ln = int(rng.integers(1, 300))
        g = genomes[i % 4]
        p = int(rng.integers(0, len(g) - ln))
        s = g[p : p + ln] if i % 5 else rng.choice(acgt, size=ln).tobytes()
        if i % 6 == 0 and ln > 20:
            s = s[:12] + b"N" + s[13:]
        fa.append(b">f%d x\n%s\n" % (i, s))
        fq.append(b"@f%d x\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))
    (tmp / "reads.fa").write_bytes(b"".join(fa))
    (tmp / "reads.fq").write_bytes(b"".join(fq))
    return tmp, prof


# small batches on both sides: several flat batches a file, and the JAX
# package's fixed shapes stay small on the CPU
JPLAN = dict(max_queries=2048, max_reads=64)


def _csv(clf, reads, out, extended=False) -> bytes:
    clf.classify_file(reads, out, extended=extended)
    with open(out + ".csv", "rb") as f:
        return f.read()


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst), str(dst / "targets.txt")


@pytest.mark.parametrize("mode", ["plain", "extended", "fastq", "mesh 3",
                                  "mesh 5", "mesh 8"])
def test_flat_classifier_equals_jax(flat_db, tmp_path, mode):
    """Classifier(packed=False) writes the JAX package's flat-path CSV: one
    device plain, extended and FASTQ; the index split over meshes of 3, 5
    and 8 (the JAX package on its 8 virtual CPU devices, the port on
    repeated CPU devices).  Every search goes through the radix directory
    (K9's twin of its steps): one for the index, one a mesh block."""
    tmp, prof = flat_db
    reads = str(tmp / ("reads.fq" if mode == "fastq" else "reads.fa"))
    extended = mode == "extended"
    n = int(mode.split()[1]) if mode.startswith("mesh") else None
    db, targets = _copy(tmp, tmp_path / "jax")
    jclf = JClassifier.load(db, targets, prof, K, packed=False,
                            plan=JBatchPlan(**JPLAN),
                            mesh=jmesh.make_mesh(n) if n else None)
    want = _csv(jclf, reads, str(tmp_path / "jax_out"), extended)
    db, targets = _copy(tmp, tmp_path / "torch")
    clf = Classifier.load(db, targets, prof, K, packed=False, device="cpu",
                          plan=BatchPlan(**JPLAN),
                          mesh=make_mesh(n, device="cpu") if n else None)
    assert clf.table is None and clf.packed is False
    if n:
        assert len(clf.index) == n
        assert clf.index[0].keys.shape == clf.index[-1].keys.shape
        assert all(ix.labels1.shape == ix.keys.shape for ix in clf.index)
    else:
        assert clf.index.labels1.shape == clf.index.keys.shape
        assert clf.index.bits > 0
    got = _csv(clf, reads, str(tmp_path / "torch_out"), extended)
    assert got == want
    assert got.count(b"\n") == 241 and b",5002," in got and b",NA," in got


@pytest.mark.parametrize("plan", [{}, dict(max_queries=300, max_reads=5),
                                  dict(max_reads=1)])
@pytest.mark.parametrize("extended", [False, True])
def test_flat_equals_packed(flat_db, tmp_path, plan, extended):
    """The port's flat path writes its native packed path's bytes, whatever
    the batch cuts (one batch, by queries, a read a batch)."""
    tmp, prof = flat_db
    db, targets = _copy(tmp, tmp_path / "db")
    reads = str(tmp / "reads.fa")
    packed = Classifier.load(db, targets, prof, K, device="cpu")
    flat = Classifier.load(db, targets, prof, K, device="cpu", packed=False,
                           plan=BatchPlan(**plan))
    assert (_csv(flat, reads, str(tmp_path / "flat"), extended)
            == _csv(packed, reads, str(tmp_path / "packed"), extended))


def test_read_past_the_query_budget_raises(flat_db, tmp_path):
    """A single read of more windows than max_queries raises RuntimeError,
    in the port as in the JAX package."""
    tmp, prof = flat_db
    (tmp_path / "long.fa").write_bytes(b">a\nACGTACGTACGTAC\n>b\n"
                                       + b"ACGT" * 40 + b"\n")
    reads = str(tmp_path / "long.fa")
    for side, cls, plan in (("jax", JClassifier, JBatchPlan),
                            ("torch", Classifier, BatchPlan)):
        db, targets = _copy(tmp, tmp_path / side)
        kw = {} if side == "jax" else dict(device="cpu")
        clf = cls.load(db, targets, prof, K, packed=False,
                       plan=plan(max_queries=100), **kw)
        with pytest.raises(RuntimeError, match="exceeds query budget"):
            clf.classify_file(reads, str(tmp_path / f"{side}_out"))


@pytest.mark.parametrize("n_keys, n_blocks", [(3, 4), (1001, 3)])
def test_shard_index_blocks_equal_jax(n_keys, n_blocks):
    """shard_index's blocks, each searched through its own directory (a
    padded last block; with 3 keys over 4 blocks, a block of pad keys
    alone), give the JAX package's _query_single on the whole padded
    index."""
    rng = np.random.default_rng(n_keys)
    canon = np.unique(rng.integers(0, 1 << 62, size=n_keys, dtype=np.uint64))
    keys, labels1 = lookup.prepare_index(
        canon, rng.integers(0, 16, size=len(canon)).astype(np.uint16))
    cpu = torch.device("cpu")
    blocks, query_fn = shard_index(Mesh([cpu] * n_blocks, ("db",)), keys,
                                   labels1, 16)
    assert len(blocks) == n_blocks
    if n_keys == 3:
        assert blocks[-1].kmin > blocks[-1].kmax  # pad keys alone
    rid = np.repeat(np.arange(20, dtype=np.int32), 120)
    q = np.concatenate([keys, keys + np.uint64(1), rng.integers(
        0, 1 << 62, size=len(rid) - 2 * len(keys), dtype=np.uint64),
        [lookup.PAD_QUERY] * 6]).astype(np.uint64)
    rid = np.concatenate([rid, np.zeros(6, np.int32)])
    got = query_fn(blocks, chip_smoke._i64(q), torch.from_numpy(rid),
                   n_reads=20)
    pk, pl = lookup.pad_index(keys, labels1, n_blocks)
    want = jquery_single(jnp.asarray(pk), jnp.asarray(pl), jnp.asarray(q),
                         jnp.asarray(rid), n_targets=16, max_reads=20)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
