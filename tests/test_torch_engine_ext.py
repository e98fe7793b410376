"""Paired-end and extended classification of the PyTorch port on the CPU
(plain twins of kernels K1-K5): byte-equal CSVs against the reference
goldens and against the JAX engine at k = 9, 27, 31 and 32, the dense-count
form at 65,535 targets, HitStats, the paired-end merge, and DB recovery
from per-target .ht files."""

import os
import shutil

import numpy as np
import pytest

from jn_cuclark_tpu import params as jparams
from jn_cuclark_tpu.db import builder as jbuilder
from jn_cuclark_tpu.engine import BatchPlan as JBatchPlan
from jn_cuclark_tpu.engine import Classifier as JClassifier
from jn_cuclark_tpu.engine import HitStats as JHitStats
from jn_cuclark_tpu.io.targets import parse_targets as jparse_targets
from jn_cuclark_tpu_torch import engine
from jn_cuclark_tpu_torch.db import builder
from jn_cuclark_tpu_torch.engine import BatchPlan, Classifier, HitStats
from jn_cuclark_tpu_torch.io import dbformat, fasta
from jn_cuclark_tpu_torch.io.targets import parse_targets
from jn_cuclark_tpu_torch.params import Profile
from jn_cuclark_tpu_torch.utils import native

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "golden", "csv")
GOLD_DB = os.path.join(HERE, "golden", "db")
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _golden_targets(tmp_path):
    out = tmp_path / "targets.txt"
    inputs = os.path.join(GOLD_DB, "inputs")
    with open(os.path.join(inputs, "targets.txt")) as f, open(out, "w") as g:
        for line in f:
            path, lbl = line.split()
            g.write(f"{os.path.join(inputs, os.path.basename(path))} {lbl}\n")
    return str(out)


@pytest.mark.parametrize("plan", ["default", "small batches"])
@pytest.mark.parametrize("case", ["ext", "paired"])
def test_golden_ext_and_paired_csv_byte_equal(tmp_path, case, plan):
    targets = _golden_targets(tmp_path)
    shutil.copytree(os.path.join(GOLD_DB, "full_k9"), tmp_path / "db")
    prof = Profile(name="g65521", htsize=65521, light=False, default_k=9)
    clf = Classifier.load(
        str(tmp_path / "db"), targets, prof, 9, device="cpu",
        plan=BatchPlan(max_reads=16, window_budget=1 << 12)
        if plan == "small batches" else None,
    )
    out = str(tmp_path / case)
    if case == "ext":
        stats = clf.classify_file(os.path.join(GOLD, "reads.fa"), out,
                                  extended=True)
        assert stats["hit_stats"].n == 202
    else:
        clf.classify_file(os.path.join(GOLD, "p1.fq"), out,
                          paired_path=os.path.join(GOLD, "p2.fq"))
    want = open(os.path.join(GOLD, case + ".csv"), "rb").read()
    assert open(out + ".csv", "rb").read() == want


def _write_pairs(rng, genomes, n, tmp_path):
    """R1/R2 FASTQ of n pairs (mates of 20-140 bp, 40 bp apart, from
    genome i % 3, or random); headers carry '/1' '/2' and descriptions."""
    r1, r2 = [], []
    for i in range(n):
        g = genomes[i % len(genomes)]
        a, b = (int(x) for x in rng.integers(20, 140, size=2))
        p = int(rng.integers(0, len(g) - a - b - 40))
        m1, m2 = g[p : p + a], g[p + a + 40 : p + a + 40 + b]
        if i % 5 == 0:
            m2 = ACGT[rng.integers(0, 4, size=b)].tobytes()
        r1.append(b"@pr%d/1 desc\n%s\n+\n%s\n" % (i, m1, b"I" * a))
        r2.append(b"@pr%d/2 desc\n%s\n+\n%s\n" % (i, m2, b"I" * b))
    (tmp_path / "r1.fq").write_bytes(b"".join(r1))
    (tmp_path / "r2.fq").write_bytes(b"".join(r2))
    return str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")


@pytest.fixture(scope="module", params=[9, 27, 31, 32])
def random_k(request, tmp_path_factory):
    """A k-mer DB of three random genomes built by the JAX builder at k,
    single-end reads of mixed length (both planner branches) and pairs."""
    k = request.param
    tmp = tmp_path_factory.mktemp(f"ext{k}")
    rng = np.random.default_rng(k)
    genomes = [ACGT[rng.integers(0, 4, size=2500)].tobytes() for _ in range(3)]
    with open(tmp / "targets.txt", "w") as tf:
        for i, g in enumerate(genomes):
            (tmp / f"g{i}.fa").write_bytes(b">g%d\n%s\n" % (i, g))
            tf.write(f"{tmp / f'g{i}.fa'} {6000 + i}\n")
    prof = jparams.tiny(htsize=4093, k=k)
    jbuilder.build_database(jparse_targets(str(tmp / "targets.txt")),
                            str(tmp), prof, k)
    reads = []
    for i in range(150):
        ln = 90 if i < 40 else int(rng.integers(1, 350))
        g = genomes[i % 3]
        p = int(rng.integers(0, len(g) - ln))
        s = g[p : p + ln] if i % 4 else ACGT[rng.integers(0, 4, size=ln)].tobytes()
        if i % 6 == 0 and ln > 40:
            s = s[:20] + b"N" + s[21:]
        reads.append(b">read%d\n%s\n" % (i, s))
    (tmp / "reads.fa").write_bytes(b"".join(reads))
    _write_pairs(rng, genomes, 80, tmp)
    return tmp, prof, k


@pytest.mark.parametrize("mode", ["extended", "paired", "extended+paired"])
def test_matches_jax_engine(random_k, tmp_path, mode):
    tmp, prof, k = random_k
    extended = "extended" in mode
    paired = "paired" in mode
    src = str(tmp / "r1.fq") if paired else str(tmp / "reads.fa")
    mate = str(tmp / "r2.fq") if paired else None
    outs, reports = {}, {}
    for side in ("jax", "torch"):
        db = tmp_path / side
        shutil.copytree(tmp, db, ignore=shutil.ignore_patterns("*.idx.npz"))
        if side == "jax":
            clf = JClassifier.load(
                str(db), str(db / "targets.txt"), prof, k,
                plan=JBatchPlan(max_reads=32, window_budget=1 << 12),
            )
        else:
            clf = Classifier.load(
                str(db), str(db / "targets.txt"), prof, k, device="cpu",
                plan=BatchPlan(max_reads=32, window_budget=1 << 12),
            )
        stats = clf.classify_file(src, str(tmp_path / side), paired_path=mate,
                                  extended=extended)
        outs[side] = (tmp_path / f"{side}.csv").read_bytes()
        if extended:
            reports[side] = stats["hit_stats"].report()
    assert outs["torch"] == outs["jax"]
    assert outs["torch"].count(b"\n") == (81 if paired else 151)
    assert reports.get("torch") == reports.get("jax")
    assert b",6001," in outs["torch"]
    if not paired:  # a quarter of the single-end reads are random
        assert b",NA," in outs["torch"]
    if paired:  # the in-memory entry point takes the merged FASTA
        merged = fasta.merge_paired(open(src, "rb").read(),
                                    open(mate, "rb").read())
        rows, n = clf.classify_bytes(merged, paired=True, extended=extended)
        assert n == 80
        assert clf._header(extended) + b"".join(rows) == outs["torch"]


def test_dense_counts_path_at_65535_targets(tmp_path, monkeypatch):
    """At 65,535 targets extended output takes the dense [R, T+1] counts
    (K5's twin), with rows per batch capped to DENSE_COUNTS_BYTES; the CSV
    equals the JAX engine's."""
    k = 11
    T = 65535
    rng = np.random.default_rng(65535)
    genome = ACGT[rng.integers(0, 4, size=3000)].tobytes()
    keys = np.unique(native.extract_canonical(b">g\n" + genome + b"\n", k,
                                              False, 1))
    labels = rng.integers(T - 40, T, size=len(keys)).astype(np.uint16)
    labels[: len(keys) // 3] = rng.integers(0, 5, size=len(keys) // 3)
    names = ["NA"] + [f"t{i}" for i in range(T)]
    reads = b"".join(
        b">d%d\n%s\n" % (i, genome[p : p + 60 + i])
        for i, p in enumerate(rng.integers(0, 2800, size=24))
    ) + b">junk\nACGTTTGCA\n"
    (tmp_path / "r.fa").write_bytes(reads)
    prof = Profile(name="t", htsize=4093, light=False, default_k=k)
    jprof = jparams.tiny(htsize=4093, k=k)
    monkeypatch.setattr(engine, "DENSE_COUNTS_BYTES", 4 * (T + 1) * 8)
    clf = Classifier(prof, k, names, keys, labels, device="cpu")
    shapes = []
    real = clf.batch_fn

    def spy(words, vwords, extended=False, probe_cols=None):
        shapes.append((words.shape[0], extended))
        return real(words, vwords, extended=extended, probe_cols=probe_cols)

    clf.batch_fn = spy
    stats = clf.classify_file(str(tmp_path / "r.fa"), str(tmp_path / "torch"),
                              extended=True)
    assert shapes and all(r <= 8 and ext is True for r, ext in shapes)
    jclf = JClassifier(jprof, k, names, keys, labels,
                       plan=JBatchPlan(max_reads=8, window_budget=1 << 12))
    jstats = jclf.classify_file(str(tmp_path / "r.fa"), str(tmp_path / "jax"),
                                extended=True)
    got = (tmp_path / "torch.csv").read_bytes()
    assert got == (tmp_path / "jax.csv").read_bytes()
    assert got.split(b"\n")[0].count(b",") == T + 4
    assert stats["hit_stats"].report() == jstats["hit_stats"].report()


def test_hit_stats_match_jax():
    rng = np.random.default_rng(3)
    runs = np.sort(rng.integers(0, 7, size=(40, 30)), axis=1).astype(np.uint16)
    counts = np.zeros((40, 8), np.int32)
    for r in range(40):
        np.add.at(counts[r], runs[r].astype(np.int64), 1)
    reports = []
    for cls in (HitStats, JHitStats):
        a, b = cls(7), cls(7)
        a.update_runs(runs)
        a.update_runs(np.zeros((3, 0), np.uint16))
        b.update_counts(counts)
        b.update_counts(np.zeros((3, 8), np.int32))
        assert a.report() == b.report()
        reports.append(a.report())
    assert reports[0] == reports[1]
    assert HitStats(5).report() == JHitStats(5).report()  # no reads: nan


@pytest.mark.parametrize("chunk_cap", [1 << 28, 64])
def test_merge_paired_native_equals_python(chunk_cap):
    rng = np.random.default_rng(chunk_cap % 1000)
    r1, r2 = [], []
    for i in range(60):
        seps = [b" ", b"/", b"\t", b"@"][i % 4]
        a, b = (ACGT[rng.integers(0, 4, size=int(rng.integers(0, 90)))]
                .tobytes() for _ in range(2))
        r1.append(b"@@rd%d%s1 x\n%s\n+\n%s\n" % (i, seps, a, b"I" * len(a)))
        r2.append(b"@rd%d%s2\n%s\n+rd\n%s\n" % (i, seps, b, b"I" * len(b)))
    d1, d2 = b"".join(r1), b"".join(r2)
    want = fasta._merge_paired_py(d1, d2)
    assert b"".join(native.merge_paired_stream(d1, d2, chunk_cap)) == want
    assert fasta.merge_paired(d1, d2) == want
    bad = d2.replace(b"@rd7", b"@rdX", 1)
    for fn in (fasta._merge_paired_py, fasta.merge_paired):
        with pytest.raises(ValueError, match="read id"):
            fn(d1, bad)
    with pytest.raises(ValueError, match="FASTQ"):
        fasta.merge_paired(b">a\nACG\n", d2)


def test_recovery_from_ht_files(tmp_path, capsys):
    """A missing central DB is rebuilt from the per-target .ht files of a
    --tsk build, as the JAX package's Classifier.load does."""
    rng = np.random.default_rng(13)
    with open(tmp_path / "targets.txt", "w") as tf:
        genomes = []
        for i in range(2):
            g = ACGT[rng.integers(0, 4, size=500)].tobytes()
            genomes.append(g)
            (tmp_path / f"g{i}.fa").write_bytes(b">g%d\n%s\n" % (i, g))
            tf.write(f"{tmp_path / f'g{i}.fa'} {500 + i}\n")
    prof = Profile(name="t", htsize=2039, light=False, default_k=9)
    targets = parse_targets(str(tmp_path / "targets.txt"))
    db = builder.build_database(targets, str(tmp_path), prof, 9, tsk=True)
    stem = str(tmp_path / prof.db_stem(9, 2, 0, prof.default_gap))
    want = {ext: open(stem + ext, "rb").read() for ext in (".sz", ".ky", ".lb")}
    for ext in want:
        os.remove(stem + ext)
    clf = Classifier.load(str(tmp_path), targets, prof, 9, device="cpu")
    assert "recovered from saved targets-specific data" in capsys.readouterr().err
    c2, l2 = dbformat.read_db(stem, prof, 9)
    assert dict(zip(c2.tolist(), l2.tolist())) == dict(
        zip(db.canonical.tolist(), db.labels.tolist()))
    rows, _ = clf.classify_bytes(b">x\n" + genomes[1][:80] + b"\n")
    assert b"".join(rows).split(b",")[2] == b"501"
    # no .ht files either: the load names the missing DB files
    for name in os.listdir(tmp_path):
        if name.endswith((".ht", ".sz", ".ky", ".lb", ".npz")):
            os.remove(tmp_path / name)
    with pytest.raises(FileNotFoundError, match="nor per-target .ht"):
        Classifier.load(str(tmp_path), targets, prof, 9, device="cpu")
