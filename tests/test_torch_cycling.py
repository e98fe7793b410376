"""Out-of-core cycling in the PyTorch port against the JAX package, on the
CPU: the chunk probe (twin of kernel K7) and K7's bin plan, chunk_table,
the two cycled batch steps, the memory policy, and cycled CSVs byte-equal
to the port's resident run and to the JAX package's cycled run, all
exact."""

import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from jn_cuclark_tpu import params as jparams
from jn_cuclark_tpu.db import builder
from jn_cuclark_tpu.engine import BatchPlan as JBatchPlan
from jn_cuclark_tpu.engine import Classifier as JClassifier
from jn_cuclark_tpu.io.targets import parse_targets as jparse_targets
from jn_cuclark_tpu.ops import device_pipeline as jdp
from jn_cuclark_tpu.ops import radix_table as jrt
from jn_cuclark_tpu.utils import memory as jmemory
from jn_cuclark_tpu_torch import cli
from jn_cuclark_tpu_torch.database import DBConfig
from jn_cuclark_tpu_torch.engine import BatchPlan, Classifier, _ScanStream
from jn_cuclark_tpu_torch.io import dbformat
from jn_cuclark_tpu_torch.ops import device_pipeline, kernels, radix_table
from jn_cuclark_tpu_torch.params import Profile
from jn_cuclark_tpu_torch.utils import memory, native

from .test_torch_engine import GOLD, GOLDENS, golden_setup

K = 9


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


def _table(seed, n, kbits, c=None, load=None):
    """(keys, labels1, table) with random keys of kbits bits (64: bit 63
    set on half of them, as at k = 32)."""
    rng = np.random.default_rng(seed)
    top = (1 << kbits) - 2
    keys = np.unique(rng.integers(0, top, size=2 * n, dtype=np.uint64))[:n]
    labels1 = rng.integers(1, 300, size=len(keys)).astype(np.int32)
    return rng, keys, labels1, jrt.build(keys, labels1, c=c, load=load)


def _edge_keys(m1, cycles, rng):
    """One key in each first and last row of every chunk of a 2^m1-row
    table split in `cycles` (the mix is inverted: row r, random quotient)."""
    rows_per = -(-(1 << m1) // cycles)
    rows = sorted({r for i in range(cycles)
                   for r in (i * rows_per, (i + 1) * rows_per - 1)
                   if r < 1 << m1})
    low = rng.integers(0, 1 << (64 - m1), size=len(rows), dtype=np.uint64)
    mixed = (np.array(rows, np.uint64) << np.uint64(64 - m1)) | low
    with np.errstate(over="ignore"):
        return mixed * jrt._MIX1_INV


@pytest.mark.parametrize("kbits", [54, 64])  # k = 27 and k = 32 keys
@pytest.mark.parametrize("cycles", [2, 3, 5])
def test_probe_chunk_plain_equals_jax(kbits, cycles):
    """Every chunk, with stored keys on its first and last rows, misses
    and EMPTY; a forced stash that only chunk 0 answers."""
    rng, keys, labels1, table = _table(kbits + cycles, 6000, kbits, c=4,
                                       load=16.0)
    edge = _edge_keys(table.m1, cycles, rng)
    keys = np.concatenate([keys, edge])
    labels1 = np.concatenate([labels1, rng.integers(1, 300, len(edge))])
    labels1 = labels1.astype(np.int32)
    m1 = table.m1
    table = jrt.build(keys, labels1, c=4, load=16.0)
    assert table.m1 == m1 and (table.stash_keys != jrt.EMPTY).any()
    miss = rng.integers(0, (1 << 64) - 2, size=3000, dtype=np.uint64)
    q = np.concatenate([keys, miss, np.full(8, jrt.EMPTY, np.uint64)])
    chunks = radix_table.chunk_table(table, cycles)
    jchunks = jrt.chunk_table(table, cycles)
    stash = radix_table.put_stash(table.stash_keys, table.stash_labels, "cpu")
    got_sum = np.zeros(len(q), np.int64)
    for ch, jch in zip(chunks, jchunks):
        want = np.asarray(jrt.probe_chunk(
            jnp.asarray(jch["slots"]), jnp.asarray(jch["labels"]),
            jnp.asarray(table.stash_keys), jnp.asarray(table.stash_labels),
            jnp.asarray(q), jnp.int32(jch["start_row"]), m1=table.m1,
            lb=table.lb, c=table.slot_width,
            use_stash=jnp.bool_(jch["use_stash"]),
        ))
        got = radix_table.probe_chunk(
            torch.from_numpy(ch["slots"].view(np.int32)), *stash, _t(q),
            ch["start_row"], m1=table.m1, lb=table.lb,
            use_stash=ch["use_stash"],
        )
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        got_sum += got.numpy()
    # over a whole pass every key answers its label exactly once (the
    # stash counted once), misses stay 0
    assert np.array_equal(got_sum[: len(keys)], labels1)
    assert not got_sum[len(keys):].any()


@pytest.mark.parametrize("kbits", [54, 64])
@pytest.mark.parametrize("cycles", [2, 4])
def test_probe_chunk_hi_collisions_equal_jax(kbits, cycles):
    """Slots whose hi half equals a missing query's t_hi while the lo half
    has a bit at or above lb set: misses that only the lo word tells apart
    (K7 reads lo words only behind a matching hi word).  Q is odd."""
    rng, keys, labels1, table = _table(kbits + 10 * cycles, 6000, kbits)
    miss = rng.integers(0, (1 << 64) - 2, size=2001, dtype=np.uint64)
    assert chip_smoke.forge_hi_collisions(table, miss) > 1000
    q = np.concatenate([keys, miss])
    stash = radix_table.put_stash(table.stash_keys, table.stash_labels, "cpu")
    got_sum = np.zeros(len(q), np.int64)
    for ch in jrt.chunk_table(table, cycles):
        want = np.asarray(jrt.probe_chunk(
            jnp.asarray(ch["slots"]), jnp.asarray(ch["labels"]),
            jnp.asarray(table.stash_keys), jnp.asarray(table.stash_labels),
            jnp.asarray(q), jnp.int32(ch["start_row"]), m1=table.m1,
            lb=table.lb, c=table.slot_width,
            use_stash=jnp.bool_(ch["use_stash"]),
        ))
        got = radix_table.probe_chunk(
            torch.from_numpy(ch["slots"].view(np.int32)), *stash, _t(q),
            ch["start_row"], m1=table.m1, lb=table.lb,
            use_stash=ch["use_stash"],
        )
        assert np.array_equal(got.numpy(), want)
        got_sum += got.numpy()
    assert np.array_equal(got_sum[: len(keys)], labels1)
    assert not got_sum[len(keys):].any()


@pytest.mark.parametrize("c", [4, 6, 128])
@pytest.mark.parametrize("rows_per", [1, 3, 4097, 262_144, (1 << 22) + 5])
def test_chunk_bins_cover_each_row_once(rows_per, c):
    """K7's bin plan: bin = local row >> shift puts every row of the chunk
    in one of n_bins bins, none empty, each bin's hi halves (c x 4 B a row)
    inside the L2 share."""
    shift, n_bins = kernels.chunk_bins(rows_per, c)
    per_bin = np.bincount(np.arange(rows_per) >> shift)
    assert len(per_bin) == n_bins <= kernels.K7_MAX_BINS
    assert per_bin.min() > 0 and per_bin.sum() == rows_per
    assert per_bin.max() * c * 4 <= kernels.L2_SHARE_BYTES


def test_chunk_bins_cap_the_bin_count():
    """A chunk past K7_MAX_BINS bins of the L2 share (128 GiB of 1 KiB
    rows) widens its bins rather than exceed the kernel's bin array."""
    shift, n_bins = kernels.chunk_bins(1 << 28, 128)
    assert n_bins == kernels.K7_MAX_BINS and (1 << 28) >> shift == n_bins


@pytest.mark.parametrize("cycles", [1, 3, 4, 7])
def test_chunk_table_equals_jax(cycles):
    _, _, _, table = _table(cycles, 3000, 54)
    got = radix_table.chunk_table(table, cycles)
    want = jrt.chunk_table(table, cycles)
    assert len(got) == len(want) == cycles
    for g, w in zip(got, want):
        assert np.array_equal(g["slots"], w["slots"])
        assert (g["start_row"], g["use_stash"]) == (w["start_row"],
                                                    w["use_stash"])
    # a split that does not divide 2^m1 pads the last chunk with EMPTY rows
    n1 = table.slots.shape[0]
    assert sum(len(g["slots"]) for g in got) == -(-n1 // cycles) * cycles
    # only that padded chunk is a copy; the others are views of the table
    assert all(np.shares_memory(g["slots"], table.slots) for g in got[:-1])


def _reads(rng, genome, n):
    acgt = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for i in range(n):
        ln = int(rng.integers(20, 250))
        p = int(rng.integers(0, len(genome) - ln))
        s = genome[p : p + ln] if i % 3 else rng.choice(acgt, ln).tobytes()
        out.append(b">r%d\n%s\n" % (i, s))
    return b"".join(out)


@pytest.mark.parametrize("k", [27, 32])
def test_classify_batch_chunk_forms_equal_jax(k):
    """counts and labels (narrowed to u16 and not) against each chunk,
    labels of 40,000 and more riding the int16 carrier."""
    rng = np.random.default_rng(k)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 4000).tobytes()
    keys = np.unique(native.extract_canonical(b">g\n" + genome + b"\n", k,
                                              False, 1))
    labels1 = rng.integers(40_000, 45_000, size=len(keys)).astype(np.int32)
    table = jrt.build(keys, labels1, c=4, load=16.0)
    data = _reads(rng, genome, 40)
    _, _, _, ss, se, _ = native.scan_reads(data)
    words, vwords = native.pack_batch(data, ss, se, 256)
    stash = radix_table.put_stash(table.stash_keys, table.stash_labels, "cpu")
    for ch in jrt.chunk_table(table, 3):
        jargs = (jnp.asarray(ch["slots"]), jnp.asarray(ch["labels"]),
                 jnp.asarray(table.stash_keys),
                 jnp.asarray(table.stash_labels), jnp.asarray(words),
                 jnp.asarray(vwords), jnp.int32(ch["start_row"]),
                 jnp.bool_(ch["use_stash"]))
        targs = (torch.from_numpy(ch["slots"].view(np.int32)), *stash,
                 _t(words), _t(vwords), ch["start_row"], ch["use_stash"])
        kw = dict(k=k, m1=table.m1, lb=table.lb, probe_cols=224)
        want = jdp.classify_batch_counts_chunk(
            *jargs, c=table.slot_width, n_targets=45_000, **kw)
        got = device_pipeline.classify_batch_counts_chunk(
            *targs, n_targets=45_000, **kw)
        assert np.array_equal(got.numpy(), np.asarray(want))
        for narrow in (True, False):
            want = np.asarray(jdp.classify_batch_labels_chunk(
                *jargs, c=table.slot_width, narrow=narrow, **kw))
            got = device_pipeline.classify_batch_labels_chunk(
                *targs, narrow=narrow, **kw).numpy()
            if narrow:
                assert got.dtype == np.int16 and (got < 0).any()
                got = got.view(np.uint16)
            assert np.array_equal(got, want), narrow


def test_auto_db_cycles_equals_jax(monkeypatch):
    """The same budget gives the same cycles in both packages: the port's
    limit is the JAX one less the JAX transient plus the port's own."""
    port_t = memory.probe_transient_bytes(1 << 23, 6, 4 * 17 << 16)
    jax_t = jmemory.probe_transient_bytes(1 << 23, 128)
    assert port_t < jax_t  # no [Q, C] row gather
    jlimit = 16 << 30
    budget = jlimit - jmemory.RESERVED - jax_t
    for prefetch in ("1", "0"):
        monkeypatch.setenv("CLARK_TPU_PREFETCH_CHUNKS", prefetch)
        for table_bytes in (budget - 1, budget, int(budget * 2.5),
                            budget * 7 + 3):
            monkeypatch.setenv("CLARK_TPU_DEVICE_MEM_BYTES", str(jlimit))
            want = jmemory.auto_db_cycles(table_bytes, 1 << 23, 128)
            monkeypatch.setenv("CLARK_TPU_DEVICE_MEM_BYTES",
                               str(jlimit - jax_t + port_t))
            assert memory.auto_db_cycles(table_bytes, port_t) == want
    monkeypatch.setenv("CLARK_TPU_DEVICE_MEM_BYTES", str(1 << 30))
    with pytest.raises(RuntimeError, match="CLARK_TPU_DEVICE_MEM_BYTES"):
        memory.auto_db_cycles(1 << 30, port_t)  # below the 200 MB floor
    monkeypatch.delenv("CLARK_TPU_DEVICE_MEM_BYTES")
    assert memory.device_memory_limit("cpu") is None
    assert memory.auto_db_cycles(1 << 40, port_t, device="cpu") == (1, None)


def test_transient_formula():
    wb, depth, counts = 1 << 23, 6, 5 << 20
    assert memory.probe_transient_bytes(wb, depth, counts) == (
        41 * wb + (depth + 3) * (wb * 19 // 8 + counts))


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """Three random genomes, a k=9 DB built by the JAX package's builder,
    and reads of mixed length."""
    tmp = tmp_path_factory.mktemp("cyc")
    rng = np.random.default_rng(17)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genomes = [rng.choice(acgt, size=1500).tobytes() for _ in range(3)]
    with open(tmp / "targets.txt", "w") as tf:
        for i, g in enumerate(genomes):
            p = tmp / f"g{i}.fa"
            p.write_bytes(b">g%d\n%s\n" % (i, g))
            tf.write(f"{p} {5000 + i}\n")
    prof = jparams.tiny(htsize=4093, k=K)
    builder.build_database(jparse_targets(str(tmp / "targets.txt")),
                           str(tmp), prof, K)
    reads = []
    for i in range(150):
        ln = 60 if i < 40 else int(rng.integers(1, 400))
        g = genomes[i % 3]
        p = int(rng.integers(0, len(g) - ln))
        s = g[p : p + ln] if i % 4 else rng.choice(acgt, size=ln).tobytes()
        reads.append(b">read%d\n%s\n" % (i, s))
    return tmp, prof, b"".join(reads)


PLAN = dict(max_reads=64, window_budget=1 << 12)


def _load(db, tmp_path, side="torch", **kw):
    tmp, prof, _ = db
    d = tmp_path / f"{side}_db"
    if not d.exists():
        shutil.copytree(tmp, d)
    args = (str(d), str(d / "targets.txt"), prof, K)
    if side == "jax":
        strategy = kw.pop("strategy", "auto")
        return JClassifier.load(*args, plan=JBatchPlan(
            cycle_strategy=strategy, **PLAN), **kw)
    strategy = kw.pop("strategy", "auto")
    return Classifier.load(*args, device="cpu", plan=BatchPlan(
        cycle_strategy=strategy, **PLAN), **kw)


def _csv(clf, path, out, **kw):
    clf.classify_file(path, out, **kw)
    with open(out + ".csv", "rb") as f:
        return f.read()


@pytest.mark.parametrize("cycles,strategy", [(2, "counts"), (5, "counts"),
                                             (2, "labels"), (5, "labels"),
                                             (3, "auto")])
@pytest.mark.parametrize("extended", [False, True])
def test_cycled_csv_byte_equal(db, tmp_path, cycles, strategy, extended):
    """Cycled CSVs equal the port's resident run and the JAX package's
    cycled run."""
    _, _, fa = db
    reads = str(tmp_path / "reads.fa")
    with open(reads, "wb") as f:
        f.write(fa)
    want = _csv(_load(db, tmp_path), reads, str(tmp_path / "res"),
                extended=extended)
    clf = _load(db, tmp_path, db_cycles=cycles, strategy=strategy)
    assert clf.db_cycles == cycles and clf.table is None
    got = _csv(clf, reads, str(tmp_path / "cyc"), extended=extended)
    assert got == want
    jclf = _load(db, tmp_path, "jax", db_cycles=cycles, strategy=strategy)
    assert _csv(jclf, reads, str(tmp_path / "jax"), extended=extended) == got
    if strategy == "auto":  # 3 targets: dense counts are the smaller
        assert clf._cycled_strategy(100) == "counts"


@pytest.mark.parametrize("strategy", ["counts", "labels"])
@pytest.mark.parametrize("cycles", [2, 3])
def test_cycled_batches_follow_the_file_order_plan(tmp_path, monkeypatch,
                                                   cycles, strategy):
    """A cycled call packs the batches a resident call plans
    (_plan_batches_stream: consecutive reads in file order, each batch at
    its longest read's stride tier), each once, and writes the resident
    run's CSV.  The golden reads span the 64, 128 and 192 tiers; 7 reads
    a batch, and 6 at the 192 tier's window budget."""
    db, targets = golden_setup("fa", tmp_path)
    _, _, _, prof, k, reads, _ = GOLDENS["fa"]
    with open(os.path.join(GOLD, reads), "rb") as f:
        data = f.read()
    plan = BatchPlan(max_reads=7, window_budget=6 * 192,
                     cycle_strategy=strategy)
    resident = Classifier.load(db, targets, prof, k, device="cpu", plan=plan)
    want_rows = b"".join(resident.classify_bytes(data)[0])
    want = [(r0, r1, stride) for r0, r1, stride, _ in
            resident._plan_batches_stream(_ScanStream(data), 7)]
    assert len({stride for *_, stride in want}) == 3
    assert len({r1 - r0 for r0, r1, _ in want}) > 1
    cycled = Classifier.load(db, targets, prof, k, device="cpu",
                             db_cycles=cycles, plan=plan)
    starts = native.scan_reads(data)[3]
    pack_batch, packed = native.pack_batch, []

    def spy(buf, ss, se, stride):
        r0 = int(np.searchsorted(starts, ss[0]))
        packed.append((r0, r0 + len(ss), stride))
        return pack_batch(buf, ss, se, stride)

    monkeypatch.setattr(native, "pack_batch", spy)
    rows, n_reads = cycled.classify_bytes(data)
    assert b"".join(rows) == want_rows and n_reads == 202
    assert packed == want


def test_cycled_labels_widen_u16_as_unsigned(tmp_path):
    """40,000 targets, most k-mers on the last: the labels strategy's
    grids carry labels of 32,768 and up on int16, and the cycled CSV
    equals the resident run's and the JAX package's cycled run."""
    T, k = 40_000, 21
    rng = np.random.default_rng(41)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.choice(acgt, 20_000).tobytes()
    keys = np.unique(native.extract_canonical(b">g\n" + genome + b"\n", k,
                                              False, 1))
    labels = rng.integers(0, T, size=len(keys)).astype(np.uint16)
    labels[rng.random(len(keys)) < 0.5] = T - 1
    prof = Profile(name="wide", htsize=65521, light=False, default_k=k)
    dbformat.write_db(str(tmp_path / prof.db_stem(k, T, 0)), prof, k, keys,
                      labels)
    (tmp_path / "targets.txt").write_text(
        "".join(f"t{i}.fa {90000 + i}\n" for i in range(T)))
    fa = _reads(rng, genome, 300)
    args = (str(tmp_path), str(tmp_path / "targets.txt"), prof, k)
    want = b"".join(Classifier.load(*args, device="cpu", plan=BatchPlan(
        **PLAN)).classify_bytes(fa)[0])
    assert want.count(b",%d," % (90000 + T - 1)) > 100
    clf = Classifier.load(*args, device="cpu", db_cycles=3, plan=BatchPlan(
        cycle_strategy="labels", **PLAN))
    assert b"".join(clf.classify_bytes(fa)[0]) == want
    jclf = JClassifier.load(
        *args[:2], jparams.Profile(name="wide", htsize=65521, light=False,
                                   default_k=k), k,
        db_cycles=3, plan=JBatchPlan(cycle_strategy="labels", **PLAN))
    assert b"".join(jclf.classify_bytes(fa)[0]) == want


@pytest.mark.parametrize("extended", [False, True])
def test_cycled_paired_byte_equal(db, tmp_path, extended):
    _, _, fa = db
    r1, r2 = [], []
    for i, rec in enumerate(fa.split(b">")[1:]):
        seq = rec.split(b"\n")[1]
        h = len(seq) // 2
        for out, part in ((r1, seq[:h]), (r2, seq[h:])):
            out.append(b"@p%d/x\n%s\n+\n%s\n" % (i, part, b"I" * len(part)))
    p1, p2 = str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")
    for p, recs in ((p1, r1), (p2, r2)):
        with open(p, "wb") as f:
            f.write(b"".join(recs))
    kw = dict(paired_path=p2, extended=extended)
    want = _csv(_load(db, tmp_path), p1, str(tmp_path / "res"), **kw)
    for strategy in ("counts", "labels"):
        clf = _load(db, tmp_path, db_cycles=3, strategy=strategy)
        assert _csv(clf, p1, str(tmp_path / strategy), **kw) == want
    jclf = _load(db, tmp_path, "jax", db_cycles=3)
    assert _csv(jclf, p1, str(tmp_path / "jax"), **kw) == want


@pytest.mark.parametrize("strategy", ["auto", "labels", "counts"])
def test_cycled_zero_read_input(db, tmp_path, strategy):
    clf = _load(db, tmp_path, db_cycles=2, strategy=strategy)
    gen, n = clf.classify_bytes(b"@lone_header\n")
    assert b"".join(gen) == b"" and n == 0


def _samples(tmp_path, n=4):
    rng = np.random.default_rng(21)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    items = []
    for s in range(n):
        p = tmp_path / f"s{s}.fa"
        p.write_bytes(b"".join(
            b">s%d_r%d\n%s\n" % (s, i, rng.choice(acgt, int(rng.integers(
                20, 250))).tobytes())
            for i in range(30 + 10 * s)))
        items.append((str(p), None, str(tmp_path / f"res{s}")))
    return items


def test_classify_files_cycle_outer_and_cap(db, tmp_path, monkeypatch,
                                            capsys):
    """classify_files(jobs=4) over a cycled table runs cycle-outer (stats
    flagged aggregate) and writes each sample's CSV byte-equal to a serial
    run and to the JAX package's; above CLARK_TPU_CYCLE_OUTER_MAX_BYTES the
    samples run serially, with the same bytes."""
    items = _samples(tmp_path)
    clf = _load(db, tmp_path, db_cycles=3)
    monkeypatch.setenv("CLARK_TPU_CYCLE_OUTER_MAX_BYTES", str(1 << 30))
    stats = clf.classify_files(items, jobs=4)
    assert [s["reads"] for s in stats] == [30, 40, 50, 60]
    assert all(s["aggregate"] for s in stats)
    outs = [open(r + ".csv", "rb").read() for _, _, r in items]
    resident = _load(db, tmp_path)
    jclf = _load(db, tmp_path, "jax", db_cycles=3)
    for (o, _, r), want in zip(items, outs):
        assert _csv(resident, o, r + "_ref") == want
        assert _csv(jclf, o, r + "_jax") == want
    monkeypatch.setenv("CLARK_TPU_CYCLE_OUTER_MAX_BYTES", "10")
    items2 = [(o, p, r + "_f") for o, p, r in items]
    stats = clf.classify_files(items2, jobs=4)
    assert not any(s.get("aggregate") for s in stats)
    assert "cycle-outer scheduling skipped" in capsys.readouterr().err
    for (_, _, r), want in zip(items2, outs):
        assert open(r + ".csv", "rb").read() == want


def test_classify_files_threads_equal_serial(db, tmp_path):
    """jobs=4 over the resident table: concurrent files, serial bytes."""
    items = _samples(tmp_path)
    clf = _load(db, tmp_path)
    stats = clf.classify_files(items, jobs=4)
    assert not any(s.get("aggregate") for s in stats)
    for o, _, r in items:
        assert _csv(clf, o, r + "_ser") == open(r + ".csv", "rb").read()


def test_cycled_concurrent_calls_equal_serial(db, tmp_path):
    """Two threads classifying through one cycled Classifier (each call
    streams every chunk) write what serial calls write."""
    _, _, fa = db
    clf = _load(db, tmp_path, db_cycles=3)
    want = b"".join(clf.classify_bytes(fa)[0])
    with ThreadPoolExecutor(max_workers=2) as ex:
        got = list(ex.map(lambda _: b"".join(clf.classify_bytes(fa)[0]),
                          range(6)))
    assert got == [want] * 6


def test_prefetch_off_byte_equal(db, tmp_path, monkeypatch):
    _, _, fa = db
    outs = []
    for pf in ("1", "0"):
        monkeypatch.setenv("CLARK_TPU_PREFETCH_CHUNKS", pf)
        clf = _load(db, tmp_path, db_cycles=3)
        outs.append(b"".join(clf.classify_bytes(fa)[0]))
    assert outs[0] == outs[1]


def test_auto_policy_cycles_with_dense_off(db, tmp_path, monkeypatch,
                                           capsys):
    """An oversized table cycles with no flags when the dense layout is
    off: the budget decision is faked (the 200 MB floor rules out a real
    one at this size), the wiring and the bytes are real."""
    _, _, fa = db
    want = b"".join(_load(db, tmp_path).classify_bytes(fa)[0])
    monkeypatch.setattr(memory, "auto_db_cycles",
                        lambda *a, **kw: (3, 12345 << 20))
    monkeypatch.setenv("CLARK_TPU_DENSE", "0")
    clf = _load(db, tmp_path)
    assert clf.db_cycles == 3 and clf.dense_table is None
    assert "loading in 3 cycles" in capsys.readouterr().err
    assert b"".join(clf.classify_bytes(fa)[0]) == want


def test_cli_db_cycles(db, tmp_path):
    """`classify --db-cycles 3 --device cpu` (and --jobs over a list of
    files) writes what the resident library run writes."""
    tmp, prof, fa = db
    d = tmp_path / "cli_db"
    shutil.copytree(tmp, d)
    DBConfig(db_dir=str(d), targets=str(d / "targets.txt"), subdb=str(d),
             rank=0, profile_name=prof.name, k=K, gap=0, min_count_target=0,
             htsize=prof.htsize, light=False).save()
    reads = tmp_path / "reads.fa"
    reads.write_bytes(fa)
    base = ["classify", "-D", str(d), "--device", "cpu", "--db-cycles", "3"]
    assert cli.main(base + ["-O", str(reads), "-R", str(tmp_path / "cli")]) == 0
    want = _csv(_load(db, tmp_path), str(reads), str(tmp_path / "lib"))
    assert (tmp_path / "cli.csv").read_bytes() == want
    items = _samples(tmp_path, 2)
    (tmp_path / "objs").write_text("".join(o + "\n" for o, _, _ in items))
    (tmp_path / "outs").write_text("".join(r + "\n" for _, _, r in items))
    assert cli.main(base + ["-O", str(tmp_path / "objs"), "-R",
                            str(tmp_path / "outs"), "--jobs", "2"]) == 0
    for o, _, r in items:
        assert open(r + ".csv", "rb").read() == _csv(
            _load(db, tmp_path), o, r + "_lib")
    with pytest.raises(SystemExit):
        cli.main(base[:-1] + ["x", "-O", str(reads), "-R", "y"])
    assert os.path.exists(str(tmp_path / "cli.csv"))
