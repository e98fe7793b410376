"""The classify slice of the PyTorch port end to end on the CPU (plain
twins of the kernels): byte-equal CSVs against the reference goldens and
against the JAX engine, the CLI (single-end, paired-end, extended), and the
modes that were rejected in earlier slices and now classify."""

import gzip
import os
import shutil

import numpy as np
import pytest
import torch

from jn_cuclark_tpu import params as jparams
from jn_cuclark_tpu.db import builder
from jn_cuclark_tpu.engine import BatchPlan as JBatchPlan
from jn_cuclark_tpu.engine import Classifier as JClassifier
from jn_cuclark_tpu.io.targets import parse_targets as jparse_targets
from jn_cuclark_tpu_torch import cli
from jn_cuclark_tpu_torch.database import DBConfig
from jn_cuclark_tpu_torch.engine import BatchPlan, Classifier
from jn_cuclark_tpu_torch.parallel.mesh import make_mesh
from jn_cuclark_tpu_torch.params import Profile

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "golden")

U32 = 16777259
GOLDENS = {
    # case: (db dir, gzipped, targets dir, profile, k, reads, golden csv)
    "fa": ("db/full_k9", False, "db/inputs",
           Profile(name="g65521", htsize=65521, light=False, default_k=9), 9,
           "csv/reads.fa", "csv/fa.csv"),
    "fq": ("db/full_k9", False, "db/inputs",
           Profile(name="g65521", htsize=65521, light=False, default_k=9), 9,
           "csv/reads.fq", "csv/fq.csv"),
    "u32_full": ("u32/full_k27", True, "u32/inputs",
                 Profile(name="u32f", htsize=U32, light=False, default_k=27),
                 27, "u32/inputs/reads.fa", "u32/full_k27.csv"),
    "u32_light": ("u32/light_k27", True, "u32/inputs",
                  Profile(name="u32l", htsize=U32, light=True, default_k=27,
                          default_gap=4),
                  27, "u32/inputs/reads.fa", "u32/light_k27.csv"),
}


def golden_setup(case, tmp_path):
    """(db dir copy, targets) for a golden case; the DB is copied (and
    gunzipped) so the index cache is never written into tests/golden."""
    db, gz, tdir, prof, k, _, _ = GOLDENS[case]
    targets_file = tmp_path / "targets.txt"
    with open(os.path.join(GOLD, tdir, "targets.txt")) as f, open(
        targets_file, "w"
    ) as g:
        for line in f:
            path, lbl = line.split()
            g.write(f"{os.path.join(GOLD, tdir, os.path.basename(path))} {lbl}\n")
    dst = tmp_path / "db"
    dst.mkdir()
    for name in os.listdir(os.path.join(GOLD, db)):
        src = os.path.join(GOLD, db, name)
        if gz:
            with gzip.open(src, "rb") as f:
                (dst / name[:-3]).write_bytes(f.read())
        else:
            shutil.copy(src, dst / name)
    return str(dst), str(targets_file)


@pytest.mark.parametrize("case", sorted(GOLDENS))
def test_golden_csv_byte_equal(tmp_path, case):
    db, targets = golden_setup(case, tmp_path)
    _, _, _, prof, k, reads, golden = GOLDENS[case]
    for attempt in ("build", "cache"):  # second load comes from .idx.npz
        clf = Classifier.load(db, targets, prof, k, device="cpu")
        out = str(tmp_path / f"{case}_{attempt}")
        stats = clf.classify_file(os.path.join(GOLD, reads), out)
        want = open(os.path.join(GOLD, golden), "rb").read()
        assert open(out + ".csv", "rb").read() == want, attempt
        assert stats["reads"] == want.count(b"\n") - 1
    assert any(n.endswith(".idx.npz") for n in os.listdir(db))


@pytest.fixture(scope="module")
def random_db(tmp_path_factory):
    """Three random genomes, a discriminative k=9 DB built by the JAX
    package's builder, and reads of mixed length (both planner branches:
    a single-tier head, then length-bucketed windows)."""
    tmp = tmp_path_factory.mktemp("rdb")
    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genomes = [rng.choice(acgt, size=1500).tobytes() for _ in range(3)]
    with open(tmp / "targets.txt", "w") as tf:
        for i, g in enumerate(genomes):
            p = tmp / f"g{i}.fa"
            p.write_bytes(b">g%d\n%s\n" % (i, g))
            tf.write(f"{p} {4000 + i}\n")
    prof = jparams.tiny(htsize=4093, k=9)
    jtargets = jparse_targets(str(tmp / "targets.txt"))
    builder.build_database(jtargets, str(tmp), prof, 9)
    reads = []
    for i in range(300):
        ln = 60 if i < 80 else int(rng.integers(1, 400))
        g = genomes[i % 3]
        p = int(rng.integers(0, len(g) - ln))
        s = g[p : p + ln] if i % 4 else rng.choice(acgt, size=ln).tobytes()
        if i % 7 == 0 and ln > 30:
            s = s[:10] + b"N" + s[11:]
        reads.append(b">read%d some description\n%s\n" % (i, s))
    return tmp, prof, b"".join(reads)


def test_matches_jax_engine(random_db, tmp_path):
    tmp, prof, fa = random_db
    (tmp_path / "reads.fa").write_bytes(fa)
    outs = {}
    for side in ("jax", "torch"):
        db = tmp_path / side
        shutil.copytree(tmp, db)
        if side == "jax":
            clf = JClassifier.load(
                str(db), str(db / "targets.txt"), prof, 9,
                plan=JBatchPlan(max_reads=64, window_budget=1 << 12),
            )
        else:
            clf = Classifier.load(
                str(db), str(db / "targets.txt"), prof, 9, device="cpu",
                plan=BatchPlan(max_reads=64, window_budget=1 << 12),
            )
        clf.classify_file(str(tmp_path / "reads.fa"), str(tmp_path / side))
        outs[side] = (tmp_path / f"{side}.csv").read_bytes()
    assert outs["torch"] == outs["jax"]
    assert outs["torch"].count(b"\n") == 301
    rows, n_reads = clf.classify_bytes(fa)  # the in-memory entry point
    assert n_reads == 300
    assert clf._header() + b"".join(rows) == outs["torch"]
    assert b",4001," in outs["torch"] and b",NA," in outs["torch"]


def _config(random_db, tmp_path):
    tmp, prof, fa = random_db
    db = tmp_path / "db"
    shutil.copytree(tmp, db)
    DBConfig(db_dir=str(db), targets=str(db / "targets.txt"), subdb=str(db),
             rank=0, profile_name=prof.name, k=9, gap=0, min_count_target=0,
             htsize=prof.htsize, light=False).save()
    (tmp_path / "reads.fa").write_bytes(fa)
    return db


def test_cli_classify_matches_library(random_db, tmp_path):
    tmp, prof, fa = random_db
    db = _config(random_db, tmp_path)
    rc = cli.main(["classify", "-D", str(db), "-O", str(tmp_path / "reads.fa"),
                   "-R", str(tmp_path / "cli"), "--device", "cpu"])
    assert rc == 0
    clf = Classifier.load(str(db), str(db / "targets.txt"), prof, 9,
                          device="cpu")
    clf.classify_file(str(tmp_path / "reads.fa"), str(tmp_path / "lib"))
    assert (tmp_path / "cli.csv").read_bytes() == (tmp_path / "lib.csv").read_bytes()


def _pairs(fa: bytes, tmp_path):
    """R1/R2 FASTQ files of the reads' first and second halves."""
    r1, r2 = [], []
    for i, rec in enumerate(fa.split(b">")[1:]):
        seq = rec.split(b"\n")[1]
        h = len(seq) // 2
        for out, part in ((r1, seq[:h]), (r2, seq[h:])):
            out.append(b"@p%d/x\n%s\n+\n%s\n" % (i, part, b"I" * len(part)))
    (tmp_path / "r1.fq").write_bytes(b"".join(r1))
    (tmp_path / "r2.fq").write_bytes(b"".join(r2))
    return str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")


@pytest.mark.parametrize("mode", ["paired", "extended", "extended+paired",
                                  "paired list", "paired gzipped"])
def test_cli_paired_and_extended_match_library(random_db, tmp_path, mode,
                                               capsys):
    """`classify -P R1 R2` (one pair, a list of pairs, gzipped) and
    `--extended --verbose` write what the library writes."""
    tmp, prof, fa = random_db
    db = _config(random_db, tmp_path)
    r1, r2 = _pairs(fa, tmp_path)
    extended = "extended" in mode
    paired = "paired" in mode
    args = ["classify", "-D", str(db), "-R", str(tmp_path / "cli"),
            "--device", "cpu"]
    if paired:
        p1, p2 = r1, r2
        if mode == "paired list":
            (tmp_path / "l1").write_text(r1 + "\n")
            (tmp_path / "l2").write_text(r2 + "\n")
            (tmp_path / "lr").write_text(str(tmp_path / "cli") + "\n")
            p1, p2 = str(tmp_path / "l1"), str(tmp_path / "l2")
            args[args.index("-R") + 1] = str(tmp_path / "lr")
        if mode == "paired gzipped":
            for src in (r1, r2):
                with open(src, "rb") as f, gzip.open(src + ".gz", "wb") as g:
                    g.write(f.read())
            p1, p2 = r1 + ".gz", r2 + ".gz"
            args.append("--gzipped")
        args += ["-P", p1, p2]
    else:
        args += ["-O", str(tmp_path / "reads.fa")]
    if extended:
        args += ["--extended", "--verbose"]
    assert cli.main(args) == 0
    clf = Classifier.load(str(db), str(db / "targets.txt"), prof, 9,
                          device="cpu")
    stats = clf.classify_file(r1 if paired else str(tmp_path / "reads.fa"),
                              str(tmp_path / "lib"),
                              paired_path=r2 if paired else None,
                              extended=extended)
    assert (tmp_path / "cli.csv").read_bytes() == (tmp_path / "lib.csv").read_bytes()
    err = capsys.readouterr().err
    assert (stats["hit_stats"].report() in err) if extended else (
        "MIN targets" not in err)


@pytest.mark.parametrize("flags,item", [
    (["--db-cycles", "2"], "A7"),
    (["--shard-db"], "A9"),
    (["-d", "2"], "A9"),
    (["--jobs", "2"], "A10"),
])
def test_cli_rejects_modes_not_ported(random_db, tmp_path, flags, item):
    """Options once rejected, each named by its ROADMAP item, now classify
    and write the resident library run's bytes: --db-cycles (A7), --jobs
    (formerly A10), and the mesh options (A9): --shard-db alone keeps one
    device, -d 2 splits the reads over two CPU shards."""
    tmp, prof, _ = random_db
    db = _config(random_db, tmp_path)
    argv = ["classify", "-D", str(db), "-O", str(tmp_path / "reads.fa"),
            "-R", str(tmp_path / "x"), "--device", "cpu", *flags]
    assert cli.main(argv) == 0
    clf = Classifier.load(str(db), str(db / "targets.txt"), prof, 9,
                          device="cpu")
    clf.classify_file(str(tmp_path / "reads.fa"), str(tmp_path / "lib"))
    assert (tmp_path / "x.csv").read_bytes() == (tmp_path / "lib.csv").read_bytes()


def test_library_rejects_modes_not_ported(random_db, tmp_path):
    tmp, prof, fa = random_db
    db = tmp_path / "db"
    shutil.copytree(tmp, db)
    args = (str(db), str(db / "targets.txt"), prof, 9)
    # a device mesh (A9), formerly rejected here, now classifies: two CPU
    # db shards write the resident run's bytes
    meshed = Classifier.load(*args, mesh=make_mesh(2, device="cpu"),
                             mesh_mode="db")
    assert meshed.sharded.ndb == 2
    assert (b"".join(meshed.classify_bytes(fa)[0])
            == b"".join(Classifier.load(*args, device="cpu")
                        .classify_bytes(fa)[0]))
    # out-of-core cycling (A7), formerly rejected here, now classifies: a
    # cycled run writes the resident run's bytes
    cycled = Classifier.load(*args, device="cpu", db_cycles=3)
    assert cycled.db_cycles == 3 and cycled.table is None
    resident = Classifier.load(*args, device="cpu")
    assert (b"".join(cycled.classify_bytes(fa)[0])
            == b"".join(resident.classify_bytes(fa)[0]))
    # the flat sorted-array path (packed=False), formerly rejected here,
    # now classifies: it writes the resident packed run's bytes
    flat = Classifier.load(*args, device="cpu", packed=False)
    assert flat.table is None and flat.index is not None
    assert (b"".join(flat.classify_bytes(fa)[0])
            == b"".join(resident.classify_bytes(fa)[0]))
    # paired and extended runs, formerly rejected here (A6), now classify:
    # extended + paired through the library equals the JAX engine
    clf = Classifier.load(*args, device="cpu")
    r1, r2 = _pairs(fa, tmp_path)
    jdb = tmp_path / "jdb"
    shutil.copytree(tmp, jdb)
    jclf = JClassifier.load(str(jdb), str(jdb / "targets.txt"), prof, 9)
    for side, c in (("torch", clf), ("jax", jclf)):
        c.classify_file(r1, str(tmp_path / side), paired_path=r2,
                        extended=True)
    assert (tmp_path / "torch.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_cuda_without_a_card_raises(random_db, monkeypatch):
    """Asking for CUDA where there is none raises; nothing falls back to
    the CPU twins."""
    tmp, prof, _ = random_db
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Classifier.load(str(tmp), str(tmp / "targets.txt"), prof, 9)
