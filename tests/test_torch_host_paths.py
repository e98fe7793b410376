"""The JAX package's host-path options in the PyTorch port on the CPU:
`use_native=False` and `BatchPlan(sort_batches=...)` are accepted and
write the CSV the JAX package writes with them (the port runs its native
path and file-order planner whatever their value), byte for byte; the
file-order planner's decisions against the JAX package's, exactly; the
Python row formatter of the flat path; and `classify --trace-dir`."""

import os
import shutil

import numpy as np
import pytest

from jn_cuclark_tpu import params as jparams
from jn_cuclark_tpu.db import builder
from jn_cuclark_tpu.engine import BatchPlan as JBatchPlan
from jn_cuclark_tpu.engine import Classifier as JClassifier
from jn_cuclark_tpu.engine import _format_row as jformat_row
from jn_cuclark_tpu.io.targets import parse_targets as jparse_targets
from jn_cuclark_tpu_torch import cli, engine
from jn_cuclark_tpu_torch.database import DBConfig
from jn_cuclark_tpu_torch.engine import BatchPlan, Classifier, _ScanStream

K = 9
# small batches: several windows and batches a file on both sides
PLAN = dict(max_reads=64, window_budget=1 << 13)


@pytest.fixture(scope="module")
def host_db(tmp_path_factory):
    """tests/test_sorted_planner.py's adversarial length mix (3 genomes of
    900 bp, k = 9; 300 reads of 20-280 bp interleaving stride tiers, junk,
    N's, a 1,400-bp straggler, a 2-bp read), as FASTA, as FASTQ, and as a
    FASTQ pair of the reads' halves."""
    tmp = tmp_path_factory.mktemp("hostdb")
    rng = np.random.default_rng(77)
    acgt = np.frombuffer(b"ACGT", np.uint8)

    def seq(n):
        return rng.choice(acgt, size=n).tobytes()

    genomes = [seq(900) for _ in range(3)]
    with open(tmp / "targets.txt", "w") as tf:
        for i, g in enumerate(genomes):
            p = tmp / f"g{i}.fa"
            p.write_bytes(b">g%d\n%s\n" % (i, g))
            tf.write(f"{p} {3000 + i}\n")
    prof = jparams.tiny(htsize=4093, k=K)
    builder.build_database(jparse_targets(str(tmp / "targets.txt")),
                           str(tmp), prof, K)
    reads = []
    for i in range(300):
        ln = int(rng.integers(20, 280))
        if i % 5 == 4:
            s = seq(ln)
        else:
            g = genomes[i % 3]
            p = int(rng.integers(0, max(len(g) - ln, 1)))
            s = g[p : p + ln]
        if i % 7 == 0 and len(s) > 40:
            s = s[:15] + b"N" + s[16:]
        reads.append((b"r%d" % i, s))
    reads.insert(50, (b"long", seq(1400)))
    reads.append((b"tiny", b"AC"))
    (tmp / "reads.fa").write_bytes(b"".join(b">%s d\n%s\n" % r for r in reads))
    (tmp / "reads.fq").write_bytes(b"".join(
        b"@%s\n%s\n+\n%s\n" % (n, s, b"I" * len(s)) for n, s in reads))
    for mate, half in (("r1", 0), ("r2", 1)):
        (tmp / f"{mate}.fq").write_bytes(b"".join(
            b"@p%d/%d\n%s\n+\n%s\n" % (
                i, half + 1, part, b"I" * len(part))
            for i, (_, s) in enumerate(reads)
            for part in ([s[: len(s) // 2], s[len(s) // 2 :]][half],)))
    return tmp, prof


def _run(clf, tmp, mode, out) -> bytes:
    """The CSV of one classify_file call in `mode`."""
    kw = dict(extended=mode == "extended")
    src = str(tmp / "reads.fa")
    if mode == "fastq":
        src = str(tmp / "reads.fq")
    elif mode == "paired":
        src, kw = str(tmp / "r1.fq"), dict(paired_path=str(tmp / "r2.fq"))
    clf.classify_file(src, str(out), **kw)
    with open(str(out) + ".csv", "rb") as f:
        return f.read()


def _load(cls, tmp, dst, **kw):
    shutil.copytree(tmp, dst)
    if cls is Classifier:
        kw["device"] = "cpu"
    return cls.load(str(dst), str(dst / "targets.txt"), jparams.tiny(
        htsize=4093, k=K), K, **kw)


@pytest.mark.parametrize("mode", ["plain", "extended", "fastq", "paired",
                                  "cycles counts", "cycles labels"])
def test_numpy_path_equals_jax(host_db, tmp_path, mode):
    """A Classifier given use_native=False writes the JAX package's
    use_native=False CSV (its numpy fallback): resident plain, extended,
    FASTQ and paired; in 3 cycles under both strategies."""
    tmp, _ = host_db
    kw = dict(use_native=False)
    plan = dict(PLAN)
    run = mode
    if mode.startswith("cycles"):
        kw["db_cycles"] = 3
        plan["cycle_strategy"] = mode.split()[1]
        run = "plain"
    jclf = _load(JClassifier, tmp, tmp_path / "jax", plan=JBatchPlan(**plan),
                 **kw)
    clf = _load(Classifier, tmp, tmp_path / "torch", plan=BatchPlan(**plan),
                **kw)
    assert clf.use_native is False
    want = _run(jclf, tmp, run, tmp_path / "jax_out")
    assert _run(clf, tmp, run, tmp_path / "torch_out") == want
    assert b",3001," in want and b",NA," in want


@pytest.mark.parametrize("mode", ["plain", "extended", "paired"])
@pytest.mark.parametrize("cycles", [1, 3])
def test_numpy_path_equals_native(host_db, tmp_path, mode, cycles):
    """use_native=False changes nothing in the port's CSV, resident and
    cycled."""
    tmp, _ = host_db
    native_clf = _load(Classifier, tmp, tmp_path / "n", db_cycles=cycles)
    numpy_clf = _load(Classifier, tmp, tmp_path / "p", db_cycles=cycles,
                      use_native=False, plan=BatchPlan(**PLAN))
    assert (_run(numpy_clf, tmp, mode, tmp_path / "p_out")
            == _run(native_clf, tmp, mode, tmp_path / "n_out"))


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("mode", ["plain", "extended", "paired",
                                  "cycles counts", "cycles labels"])
def test_sorted_equals_fileorder(host_db, tmp_path, use_native, mode):
    """sort_batches=True and False write the same CSV, with either
    use_native, resident and cycled (tests/test_sorted_planner.py's
    property; in the port both plan resident batches in file order)."""
    tmp, _ = host_db
    kw = dict(use_native=use_native)
    plan = dict(PLAN)
    run = mode
    if mode.startswith("cycles"):
        kw["db_cycles"] = 3
        plan["cycle_strategy"] = mode.split()[1]
        run = "plain"
    a = _load(Classifier, tmp, tmp_path / "a", **kw, plan=BatchPlan(
        sort_batches=True, sort_window_batches=3, **plan))
    b = _load(Classifier, tmp, tmp_path / "b", **kw, plan=BatchPlan(
        sort_batches=False, **plan))
    assert (_run(a, tmp, run, tmp_path / "a_out")
            == _run(b, tmp, run, tmp_path / "b_out"))


def test_cycle_outer_files_on_the_numpy_path(host_db, tmp_path):
    """classify_files over a cycled table runs cycle-outer with
    use_native=False too, each CSV the serial run's."""
    tmp, _ = host_db
    items = [(str(tmp / "reads.fa"), None, str(tmp_path / "fa")),
             (str(tmp / "r1.fq"), str(tmp / "r2.fq"), str(tmp_path / "pair"))]
    clf = _load(Classifier, tmp, tmp_path / "db", db_cycles=3,
                use_native=False)
    stats = clf.classify_files(items, jobs=2)
    assert all(s["aggregate"] for s in stats)
    ref = _load(Classifier, tmp, tmp_path / "ref")
    for (obj, mate, out) in items:
        ref.classify_file(obj, out + "_ref", paired_path=mate)
        with open(out + ".csv", "rb") as f, open(out + "_ref.csv", "rb") as g:
            assert f.read() == g.read()


def test_planners_equal_jax(host_db):
    """The port's resident planner (_plan_batches_stream) makes the JAX
    package's file-order decisions (_plan_batches), whatever the scan's
    chunk size."""
    tmp, prof = host_db
    rng = np.random.default_rng(3)
    lengths = np.concatenate([rng.integers(1, 300, size=500),
                              [1500, 3000], rng.integers(1, 120, size=300)])
    plan = dict(max_reads=48, window_budget=1 << 13)
    jclf = JClassifier.load(str(tmp), str(tmp / "targets.txt"), prof, K,
                            plan=JBatchPlan(**plan))
    clf = Classifier.load(str(tmp), str(tmp / "targets.txt"), prof, K,
                          device="cpu", plan=BatchPlan(**plan))
    want = list(jclf._plan_batches(lengths))
    fa = b"".join(b">x%d\n%s\n" % (i, b"A" * int(n))
                  for i, n in enumerate(lengths))
    for chunk in (4096, 1 << 20):
        scan = _ScanStream(fa, chunk_bytes=chunk)
        assert list(clf._plan_batches_stream(scan, 48)) == want


NAMES = ["NA", "3000", "3001", "3002"]


@pytest.mark.parametrize("row", [
    (b"nan_read", 0, 0, 0, 0, K - 1, None),  # len == k-1: -nan
    (b"short", 0, 0, 0, 0, 3, None),  # shorter than k: -0
    (b"na", 0, 0, 0, 0, 120, None),  # no hit: 0 as NA
    (b"hit", 57, 2, 40, 17, 150, None),
    (b"tie", 20, 1, 10, 10, 60, None),
    (b"ext", 57, 3, 40, 17, 150, np.array([5, 0, 17, 40], np.int32)),
    (b"ext_nan", 0, 0, 0, 0, K - 1, np.array([0, 0, 0, 0], np.int32)),
    (b"paired_short", 3, 1, 3, 0, -2, None),  # a pair's length less NBN
])
def test_format_row_equals_jax(row):
    """The Python formatter writes the JAX package's bytes: -nan at
    len == k-1, -0 for a read shorter than k, NA with a 0 score, %g."""
    name, total, ib, b, sb, norm, counts = row
    want = jformat_row(name, total, ib, b, sb, norm, K, NAMES, counts)
    assert engine._format_row(name, total, ib, b, sb, norm, K, NAMES,
                              counts) == want
    if norm == K - 1:
        assert b",-nan,NA," in want
    if name == b"short":
        assert want.startswith(b"short,-0,NA,0,")


@pytest.mark.parametrize("jobs", [1, 2])
def test_classify_trace_dir_on_the_cpu(host_db, tmp_path, jobs):
    """`classify --trace-dir DIR` creates DIR, writes a non-empty
    torch.profiler trace there, and the CSV equals an untraced run's; list
    mode with --jobs 2 is traced too."""
    tmp, prof = host_db
    db = tmp_path / "db"
    shutil.copytree(tmp, db)
    DBConfig(db_dir=str(db), targets=str(db / "targets.txt"), subdb=str(db),
             rank=0, profile_name=prof.name, k=K, gap=0, min_count_target=0,
             htsize=prof.htsize, light=False).save()
    reads = str(tmp / "reads.fa")
    base = ["classify", "-D", str(db), "--device", "cpu"]
    if jobs == 1:
        io_args = ["-O", reads, "-R", str(tmp_path / "traced")]
        outs = [tmp_path / "traced.csv"]
    else:
        (tmp_path / "objs").write_text(f"{reads}\n{tmp / 'reads.fq'}\n")
        (tmp_path / "res").write_text(
            f"{tmp_path / 'traced'}\n{tmp_path / 'traced_fq'}\n")
        io_args = ["-O", str(tmp_path / "objs"), "-R", str(tmp_path / "res"),
                   "--jobs", "2"]
        outs = [tmp_path / "traced.csv", tmp_path / "traced_fq.csv"]
    trace_dir = tmp_path / "trace" / "new"
    assert cli.main(base + io_args + ["--trace-dir", str(trace_dir)]) == 0
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    assert len(traces) == 1 and os.path.getsize(trace_dir / traces[0]) > 0
    assert cli.main(base + ["-O", reads, "-R", str(tmp_path / "plain")]) == 0
    assert outs[0].read_bytes() == (tmp_path / "plain.csv").read_bytes()
    assert all(o.stat().st_size > 0 for o in outs)
