"""Classification over several devices in the PyTorch port, on the CPU: a
mesh of repeated CPU devices against the JAX package's single-device run
and its own mesh of 8 virtual CPU devices, byte for byte; the sharded
table's chunks against the JAX fill; the shard budget; the CLI's mesh flags
and their errors.  Everything exact."""

import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from jn_cuclark_tpu import cli as jcli
from jn_cuclark_tpu import params as jparams
from jn_cuclark_tpu.db import builder
from jn_cuclark_tpu.engine import BatchPlan as JBatchPlan
from jn_cuclark_tpu.engine import Classifier as JClassifier
from jn_cuclark_tpu.io.targets import parse_targets as jparse_targets
from jn_cuclark_tpu.ops import radix_table as jrt
from jn_cuclark_tpu.parallel import mesh as jmesh
from jn_cuclark_tpu.utils import memory as jmemory
from jn_cuclark_tpu_torch import cli
from jn_cuclark_tpu_torch.database import DBConfig
from jn_cuclark_tpu_torch.engine import BatchPlan, Classifier
from jn_cuclark_tpu_torch.ops import device_pipeline, radix_table
from jn_cuclark_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedRadixTable,
    _reduce,
    make_mesh,
    make_mesh2d,
    shard_reads,
)
from jn_cuclark_tpu_torch.utils import memory, native

from .test_builder import rand_seq, write_fasta

K = 9
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """tests/test_mesh.py's fixture (4 genomes x 600 bp, k = 9, 200 reads of
    80 bp), plus the reads' halves as a FASTQ pair, and the JAX package's
    single-device CSVs: plain, extended and paired."""
    tmp = tmp_path_factory.mktemp("tmeshdb")
    rng = np.random.default_rng(9)
    genomes = [rand_seq(rng, 600) for _ in range(4)]
    with open(tmp / "targets.txt", "w") as tf:
        for i, g in enumerate(genomes):
            p = tmp / f"g{i}.fa"
            write_fasta(p, [(f"g{i}", g)])
            tf.write(f"{p} {2000 + i}\n")
    prof = jparams.tiny(htsize=4093, k=K)
    builder.build_database(jparse_targets(str(tmp / "targets.txt")),
                           str(tmp), prof, K)
    reads = []
    for i in range(200):
        g = genomes[i % 4]
        pos = rng.integers(0, len(g) - 80)
        reads.append((f"r{i}", g[pos : pos + 80]))
    (tmp / "reads.fa").write_bytes(
        "".join(f">{n}\n{s}\n" for n, s in reads).encode())
    for mate, part in (("r1.fq", slice(0, 40)), ("r2.fq", slice(40, 80))):
        (tmp / mate).write_bytes("".join(
            f"@{n}/x\n{s[part]}\n+\n{'I' * 40}\n" for n, s in reads).encode())
    jdb = tmp / "jax"
    jdb.mkdir()
    jclf = JClassifier.load(str(tmp), str(tmp / "targets.txt"), prof, K,
                            plan=JBatchPlan(window_budget=1 << 14))
    want = {}
    for name, kw in (("plain", {}), ("extended", dict(extended=True)),
                     ("paired", dict(paired_path=str(tmp / "r2.fq")))):
        src = tmp / ("r1.fq" if name == "paired" else "reads.fa")
        jclf.classify_file(str(src), str(jdb / name), **kw)
        want[name] = (jdb / f"{name}.csv").read_bytes()
    return tmp, prof, want


def _port(db, tmp_path, **kw):
    """The port's Classifier of a copy of the DB files, so neither
    package's index cache decides what the other loads."""
    tmp, prof, _ = db
    d = tmp_path / "port_db"
    if not d.exists():
        d.mkdir()
        for name in os.listdir(tmp):
            if name.endswith((".sz", ".ky", ".lb")) or name == "targets.txt":
                shutil.copy(tmp / name, d / name)
    kw.setdefault("plan", BatchPlan(window_budget=1 << 14))
    return Classifier.load(str(d), str(tmp / "targets.txt"), prof, K,
                           device="cpu", **kw)


def _csvs(clf, db, tmp_path, modes=("plain", "extended")):
    tmp = db[0]
    out = {}
    for name in modes:
        kw = dict(extended=name == "extended")
        src = tmp / "reads.fa"
        if name == "paired":
            src, kw = tmp / "r1.fq", dict(paired_path=str(tmp / "r2.fq"))
        clf.classify_file(str(src), str(tmp_path / name), **kw)
        out[name] = (tmp_path / f"{name}.csv").read_bytes()
    return out


def _cpu_mesh(shape, axes):
    if len(axes) == 1:
        return Mesh([CPU] * shape[0], axes)
    return Mesh([[CPU] * shape[1] for _ in range(shape[0])], axes)


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("n", [1, 3, 4, 8])
def test_db_mesh_equals_jax(db, tmp_path, n, extended):
    """A db mesh of n CPU shards, resident: the JAX package's single-device
    CSV, and at 8 and 3 shards its own mesh's too."""
    mode = "extended" if extended else "plain"
    clf = _port(db, tmp_path, mesh=make_mesh(n, device="cpu"),
                mesh_mode="db")
    assert clf.sharded.ndb == n and clf.db_cycles == 1
    got = _csvs(clf, db, tmp_path, (mode,))[mode]
    assert got == db[2][mode]
    if n in (3, 8):
        tmp, prof, _ = db
        jclf = JClassifier.load(str(tmp), str(tmp / "targets.txt"), prof, K,
                                plan=JBatchPlan(window_budget=1 << 14),
                                mesh=jmesh.make_mesh(n), mesh_mode="db")
        jclf.classify_file(str(tmp / "reads.fa"), str(tmp_path / "j"),
                           extended=extended)
        assert got == (tmp_path / "j.csv").read_bytes()


@pytest.mark.parametrize("strategy", ["counts", "labels"])
def test_db_mesh_cycles_equal_jax(db, tmp_path, strategy):
    """A db mesh of 4 in 3 cycles (rpd 66, rpc 22: no power of two, and the
    last shard's last chunk runs past the table) under each strategy."""
    clf = _port(db, tmp_path, mesh=make_mesh(4, device="cpu"),
                mesh_mode="db", db_cycles=3,
                plan=BatchPlan(window_budget=1 << 14,
                               cycle_strategy=strategy))
    sh = clf.sharded
    assert (clf.db_cycles, sh.rpd, sh.rpc) == (3, 66, 22)
    assert 3 * sh.rpd + 2 * sh.rpc + sh.rpc > 1 << sh.m1
    got = _csvs(clf, db, tmp_path)
    assert got == {m: db[2][m] for m in got}
    tmp, prof, _ = db
    jclf = JClassifier.load(
        str(tmp), str(tmp / "targets.txt"), prof, K,
        plan=JBatchPlan(window_budget=1 << 14, cycle_strategy=strategy),
        mesh=jmesh.make_mesh(4), mesh_mode="db", db_cycles=3)
    jclf.classify_file(str(tmp / "reads.fa"), str(tmp_path / "j"))
    assert got["plain"] == (tmp_path / "j.csv").read_bytes()


def test_db_mesh_cycled_concurrent_calls(db, tmp_path):
    """Four threads classify through one cycled db-mesh Classifier: each
    call keeps its own chunks, so all write the single-device bytes."""
    clf = _port(db, tmp_path, mesh=make_mesh(4, device="cpu"),
                mesh_mode="db", db_cycles=3)
    outs = [str(tmp_path / f"t{i}") for i in range(4)]
    with ThreadPoolExecutor(max_workers=4) as ex:
        list(ex.map(lambda out: clf.classify_file(str(db[0] / "reads.fa"),
                                                  out), outs, timeout=120))
    for out in outs:
        assert open(out + ".csv", "rb").read() == db[2]["plain"]


def test_db_mesh_shards_past_the_table(db, tmp_path):
    """8 shards in 9 cycles over a 256-row table: rpd 36, so shard 7 starts
    at row 252 and 8 of its 9 chunks lie wholly past the table; they probe
    as misses and the CSV is unchanged."""
    clf = _port(db, tmp_path, mesh=make_mesh(8, device="cpu"),
                mesh_mode="db", db_cycles=9)
    sh = clf.sharded
    assert 1 << sh.m1 == 256 and (sh.rpd, sh.rpc) == (36, 4)
    assert 7 * sh.rpd + sh.rpc >= 1 << sh.m1
    assert _csvs(clf, db, tmp_path, ("plain",))["plain"] == db[2]["plain"]


def test_db_mesh_paired(db, tmp_path):
    clf = _port(db, tmp_path, mesh=make_mesh(4, device="cpu"),
                mesh_mode="db")
    assert _csvs(clf, db, tmp_path, ("paired",))["paired"] == db[2]["paired"]


def test_dp_mesh_pads_and_keeps_read_order(db, tmp_path):
    """A dp mesh of 4 with batches of 7 rows (padded to 8 across the
    shards, the pad rows gone from the CSV), against the JAX single-device
    CSVs and the JAX dp mesh's."""
    clf = _port(db, tmp_path, mesh=make_mesh(4, device="cpu"),
                plan=BatchPlan(window_budget=1 << 14, max_reads=7))
    assert clf.sharded is None and set(clf.shards) == {CPU}
    got = _csvs(clf, db, tmp_path)
    assert got == {m: db[2][m] for m in got}
    tmp, prof, _ = db
    jclf = JClassifier.load(str(tmp), str(tmp / "targets.txt"), prof, K,
                            plan=JBatchPlan(window_budget=1 << 14),
                            mesh=jmesh.make_mesh(4), mesh_mode="dp")
    jclf.classify_file(str(tmp / "reads.fa"), str(tmp_path / "j"),
                       extended=True)
    assert got["extended"] == (tmp_path / "j.csv").read_bytes()


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_2d_mesh_equals_jax(db, tmp_path, shape):
    dp, ndb = shape
    clf = _port(db, tmp_path, mesh=make_mesh2d(dp, ndb, device="cpu"))
    assert len(clf.shards) == ndb  # one (device, db shard) slice each
    got = _csvs(clf, db, tmp_path)
    assert got == {m: db[2][m] for m in got}
    tmp, prof, _ = db
    jclf = JClassifier.load(str(tmp), str(tmp / "targets.txt"), prof, K,
                            plan=JBatchPlan(window_budget=1 << 14),
                            mesh=jmesh.make_mesh2d(dp, ndb))
    jclf.classify_file(str(tmp / "reads.fa"), str(tmp_path / "j"))
    assert got["plain"] == (tmp_path / "j.csv").read_bytes()


@pytest.mark.parametrize("cycles", [1, 3])
def test_2d_sharded_table_equals_single(db, tmp_path, cycles):
    """ShardedRadixTable on a (2, 2) mesh (reads over dp, rows over db),
    resident and cycled."""
    clf = _port(db, tmp_path, mesh=_cpu_mesh((2, 2), ("dp", "db")),
                mesh_mode="db", db_cycles=cycles)
    assert (clf.sharded.ndp, clf.sharded.ndb) == (2, 2)
    got = _csvs(clf, db, tmp_path)
    assert got == {m: db[2][m] for m in got}


def test_sharded_chunks_equal_jax_fill(db):
    """Each cycle's chunk of each db shard is bit-equal to the JAX
    package's fill_rows over the same row range."""
    tmp, prof, _ = db
    from jn_cuclark_tpu_torch.io import dbformat

    stem = str(tmp / prof.db_stem(K, 4, 0, prof.default_gap))
    keys, labels = dbformat.read_db(stem, prof, K, 1)
    labels1 = labels.astype(np.int32) + 1
    sh = ShardedRadixTable(make_mesh(3, device="cpu"), keys, labels1, 4, K,
                           db_cycles=2)
    jplan = jrt.plan_table(keys, labels1, k=K)
    assert sh.meta == jplan.meta and (sh.rpd, sh.rpc) == (86, 43)
    for cyc in range(2):
        for j in range(3):
            r0 = j * sh.rpd + cyc * sh.rpc
            want = jrt.fill_rows(keys, labels1, jplan, r0, r0 + sh.rpc)[0]
            got = sh._host[cyc][j]
            assert got.dtype == want.dtype and np.array_equal(got, want)


def _genome_batch(rng, k: int, n_reads: int):
    """(the canonical k-mers of a random 6,000-bp genome, words, vwords):
    n_reads reads of 150 bp drawn from it, packed at stride 192."""
    genome = rand_seq(rng, 6000).encode()
    keys = np.unique(native.extract_canonical(b">g\n" + genome + b"\n", k,
                                              False, 1))
    data = b"".join(b">r%d\n%s\n" % (i, genome[p : p + 150]) for i, p in
                    enumerate(rng.integers(0, 5800, size=n_reads)))
    _, _, _, ss, se, _ = native.scan_reads(data)
    w, v = native.pack_batch(data, ss, se, 192)
    return keys, torch.from_numpy(w.view(np.int64)), torch.from_numpy(
        v.view(np.int64))


def test_labels_sum_before_narrowing():
    """Labels of 32,768 and up ride int16 as negatives: each cycle's grid
    is the shards' int32 sum, narrowed after; the cycles' widened grids
    add up to the single-device labels."""
    rng = np.random.default_rng(4)
    keys, w, v = _genome_batch(rng, 31, 64)
    labels1 = rng.integers(40_000, 45_001, size=len(keys)).astype(np.int32)
    table = radix_table.to_device(radix_table.build(keys, labels1), CPU)
    q = device_pipeline.window_canonicals(w, v, 31)
    want = device_pipeline._masked(q, radix_table.probe(table, q.view(-1)))
    assert (want >= 32768).any()
    sh = ShardedRadixTable(make_mesh(4, device="cpu"), keys, labels1, 45_000,
                           31, db_cycles=3)
    total = torch.zeros_like(want)
    for cyc in range(3):
        chunks = {k: t for k, (t, _) in sh.upload_cycle(
            cyc, lambda h, d: (torch.from_numpy(h.view(np.int32)), None)
        ).items()}
        got = sh.cycle_step(chunks, cyc, "labels", w, v)
        assert got.dtype == torch.int16
        total += got.to(torch.int32) & 0xFFFF
    assert torch.equal(total, want)
    assert torch.equal(_reduce([want, torch.zeros_like(want)], CPU), want)


def test_db_shard_work_balance():
    """tests/test_mesh.py's key-ownership balance, on the port's plan."""
    rng = np.random.default_rng(11)
    keys = np.unique(rng.integers(1, 1 << 54, size=120_000, dtype=np.uint64))
    labels1 = rng.integers(1, 100, size=len(keys)).astype(np.int32)
    plan = radix_table.plan_table(keys, labels1)
    ndev = 8
    rpd = -(-plan.n_rows // ndev)
    per_dev = np.bincount(np.minimum(plan.bucket // rpd, ndev - 1),
                          minlength=ndev)
    assert per_dev.max() / per_dev.mean() < 1.02, per_dev


def test_dp_shard_work_balance():
    """shard_reads pads the batch to a multiple of the device count: the
    blocks are equal, the outputs come back in read order with the pad rows
    (empty reads: no hit, every window a miss) at the end, and they equal
    one device's run over the padded batch."""
    rng = np.random.default_rng(12)
    keys, words, vwords = _genome_batch(rng, K, 100)
    labels1 = rng.integers(1, 10, size=len(keys)).astype(np.int32)
    table = radix_table.build(keys, labels1)
    shards, batch_fn = shard_reads(make_mesh(8, device="cpu"), table, 9, K)
    assert list(shards) == [CPU]
    out = batch_fn(words, vwords, extended=True)
    assert all(o.shape[0] == 104 for o in out)
    pad = (torch.cat([words, words.new_zeros((4, words.shape[1]))]),
           torch.cat([vwords, vwords.new_zeros((4, vwords.shape[1]))]))
    want = device_pipeline.classify_batch(shards[CPU], *pad, k=K,
                                          n_targets=9, extended=True)
    for o, wnt in zip(out, want):
        assert torch.equal(o, wnt)
    assert not torch.stack(out[:4])[:, 100:].any() and out[0][:100].any()
    assert not out[4][100:, 1:].any()


def test_auto_db_cycles_n_shards_equals_jax(monkeypatch):
    """The per-shard budget under the same CLARK_TPU_DEVICE_MEM_BYTES,
    with the port's transient set to the JAX package's."""
    jax_t = jmemory.probe_transient_bytes(1 << 23, 128)
    monkeypatch.setenv("CLARK_TPU_DEVICE_MEM_BYTES", str(16 << 30))
    budget = (16 << 30) - jmemory.RESERVED - jax_t
    for prefetch in ("1", "0"):
        monkeypatch.setenv("CLARK_TPU_PREFETCH_CHUNKS", prefetch)
        for table_bytes in (budget * 4 - 3, budget * 4 + 1, budget * 9,
                            budget * 30 + 7):
            for n in (1, 3, 4):
                assert memory.auto_db_cycles(
                    table_bytes, jax_t, n_shards=n) == jmemory.auto_db_cycles(
                        table_bytes, 1 << 23, 128, n_shards=n)
    monkeypatch.setenv("CLARK_TPU_DEVICE_MEM_BYTES", str(1 << 30))
    with pytest.raises(RuntimeError, match="--shard-db / -d"):
        memory.auto_db_cycles(1 << 30, jax_t, n_shards=4)


def test_library_mesh_errors(db, tmp_path, monkeypatch):
    """make_mesh raises where the machine has fewer CUDA devices (it
    neither shrinks nor moves to the CPU); the JAX package's errors for a
    dp mesh that would need cycles."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="needs 4 CUDA devices"):
        make_mesh(4)
    with pytest.raises(ValueError, match="mesh 2x2 needs 4 CUDA devices"):
        make_mesh2d(2, 2)
    assert make_mesh(1).devices == [torch.device("cuda", 0)]
    monkeypatch.undo()
    with pytest.raises(NotImplementedError, match="mesh_mode='db'"):
        _port(db, tmp_path, mesh=make_mesh(2, device="cpu"), db_cycles=3)
    monkeypatch.setattr(memory, "auto_db_cycles", lambda *a, **kw: (3, 1 << 20))
    with pytest.raises(RuntimeError, match="does not compose"):
        _port(db, tmp_path, mesh=make_mesh(2, device="cpu"))


def _config(db, tmp_path):
    tmp, prof, _ = db
    d = tmp_path / "cfg"
    d.mkdir()
    for name in os.listdir(tmp):
        if name.endswith((".sz", ".ky", ".lb")) or name == "targets.txt":
            shutil.copy(tmp / name, d / name)
    DBConfig(db_dir=str(d), targets=str(tmp / "targets.txt"), subdb=str(d),
             rank=0, profile_name=prof.name, k=K, gap=prof.default_gap,
             min_count_target=0, htsize=prof.htsize, light=False).save()
    return d


@pytest.mark.parametrize("flags", [["-d", "4", "--shard-db"],
                                   ["-d", "4", "--shard-db", "--dp", "2"],
                                   ["-d", "4"]])
def test_cli_mesh_equals_jax_cli(db, tmp_path, flags):
    d = _config(db, tmp_path)
    reads = str(db[0] / "reads.fa")
    assert jcli.main(["classify", "-D", str(d), "-O", reads, "-R",
                      str(tmp_path / "jax"), *flags]) == 0
    assert cli.main(["classify", "-D", str(d), "-O", reads, "-R",
                     str(tmp_path / "port"), "--device", "cpu", *flags]) == 0
    got = (tmp_path / "port.csv").read_bytes()
    assert got == (tmp_path / "jax.csv").read_bytes() == db[2]["plain"]


@pytest.mark.parametrize("flags,message", [
    (["--dp", "2"], "requires --shard-db"),
    (["-d", "4", "--shard-db", "--dp", "3"], "must divide the device count 4"),
])
def test_cli_mesh_errors_equal_jax(db, tmp_path, flags, message):
    d = _config(db, tmp_path)
    argv = ["classify", "-D", str(d), "-O", str(db[0] / "reads.fa"), "-R",
            str(tmp_path / "x"), *flags]
    errs = []
    for main, extra in ((jcli.main, []), (cli.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main(argv + extra)
        errs.append(str(e.value))
    assert errs[0] == errs[1] and message in errs[0]


def test_cli_more_devices_than_the_machine_has(db, tmp_path):
    d = _config(db, tmp_path)
    with pytest.raises(SystemExit, match="needs 2 CUDA devices"):
        cli.main(["classify", "-D", str(d), "-O", str(db[0] / "reads.fa"),
                  "-R", str(tmp_path / "x"), "-d", "2", "--shard-db"])
    assert not (tmp_path / "x.csv").exists()


def test_classify_usage_message_equals_jax(capsys):
    rcs, errs = [], []
    for main in (jcli.main, cli.main):
        rcs.append(main(["classify", "-D", "db", "-R", "out"]))
        errs.append(capsys.readouterr().err)
    assert rcs == [1, 1] and errs[0] == errs[1]
    assert errs[0] == "classify: provide -O <reads> or -P <r1> <r2>\n"
