"""DB build of the PyTorch port on the CPU: byte-equal .sz/.ky/.lb and .ht
files against the reference goldens and the JAX builder, the device
aggregate's twins (the bucketed one, the CPU stand-in for kernel K6, and
the plain one) against the host aggregate and the JAX device aggregate,
one-shot and partitioned, and `db build` through the CLI."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from jn_cuclark_tpu import database as jdatabase
from jn_cuclark_tpu.db import builder as jbuilder
from jn_cuclark_tpu.db import device_build as jdevice_build
from jn_cuclark_tpu.db.analyser import Analyser as JAnalyser
from jn_cuclark_tpu.io.targets import parse_targets as jparse_targets
from jn_cuclark_tpu_torch import cli, database
from jn_cuclark_tpu_torch.db import builder, device_build
from jn_cuclark_tpu_torch.db.analyser import Analyser
from jn_cuclark_tpu_torch.io.targets import TargetsDef, parse_targets
from jn_cuclark_tpu_torch.params import MTRGTS, Profile
from jn_cuclark_tpu_torch.utils import native

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GOLD = os.path.join(HERE, "golden", "db")
INPUTS = os.path.join(GOLD, "inputs")
ACGT = np.frombuffer(b"ACGT", np.uint8)

G_FULL = Profile(name="g65521", htsize=65521, light=False, default_k=9)
G_LIGHT = Profile(name="g65521l", htsize=65521, light=True, default_k=27,
                  default_gap=4)
GOLDENS = {
    # case: (targets file, profile, k, kwargs, stem)
    "full_k9": ("targets.txt", G_FULL, 9, {}, "db_central_k9_t3_s65521_m0.tsk"),
    "light_k27": ("targets.txt", G_LIGHT, 27, {},
                  "db_central_k27_t3_s65521_m0_light_4.tsk"),
    "tsk_k9": ("targets.txt", G_FULL, 9, {"tsk": True},
               "db_central_k9_t3_s65521_m0.tsk"),
    "mint2_k9": ("targets_rep.txt", G_FULL, 9, {"min_count_target": 2},
                 "db_central_k9_t2_s65521_m2.tsk"),
}


def _golden_targets(tmp_path, name):
    """The recorded targets file, pointed at the committed inputs."""
    out = tmp_path / name
    with open(os.path.join(INPUTS, name)) as f, open(out, "w") as g:
        for line in f:
            path, lbl = line.split()
            g.write(f"{os.path.join(INPUTS, os.path.basename(path))} {lbl}\n")
    return str(out)


def _same_files(d1, d2, names):
    for fn in names:
        with open(os.path.join(d1, fn), "rb") as a, open(
            os.path.join(d2, fn), "rb"
        ) as b:
            assert a.read() == b.read(), fn


@pytest.mark.parametrize("device", ["host", "cpu"], ids=["host", "device-cpu"])
@pytest.mark.parametrize("case", sorted(GOLDENS))
def test_build_matches_golden_db(tmp_path, case, device):
    tfile, prof, k, kwargs, stem = GOLDENS[case]
    out = tmp_path / "db"
    out.mkdir()
    targets = parse_targets(_golden_targets(tmp_path, tfile))
    builder.build_database(targets, str(out), prof, k, device=device, **kwargs)
    names = [stem + ext for ext in (".sz", ".ky", ".lb")]
    if kwargs.get("tsk"):
        names += [f"{lbl}_k9.ht" for lbl in ("1001", "1002", "1003")]
    _same_files(os.path.join(GOLD, case), str(out), names)


def _genomes(tmp_path, rng, n, glen, shared=300, centromere=False):
    """n random genomes, the first two sharing a block (common k-mers);
    with centromere=True the labels pair up (chr1A/chr1B -> chr1C)."""
    gs = [ACGT[rng.integers(0, 4, size=glen)].tobytes() for _ in range(n)]
    block = ACGT[rng.integers(0, 4, size=shared)].tobytes()
    gs[0] += block
    gs[1] += block + b"N" + gs[2][:50]
    with open(tmp_path / "targets.txt", "w") as tf:
        for i, g in enumerate(gs):
            p = tmp_path / f"g{i}.fa"
            # multi-line records: k-mers span line breaks
            body = b"\n".join(g[j : j + 70] for j in range(0, len(g), 70))
            p.write_bytes(b">g%d\n%s\n" % (i, body))
            lbl = f"chr1{'AB'[i]} chr1C" if centromere and i < 2 else str(800 + i)
            tf.write(f"{p} {lbl}\n")
    return str(tmp_path / "targets.txt")


@pytest.mark.parametrize("k,tsk,centromere", [
    (13, False, False), (13, True, False), (21, False, True),
    (32, False, False), (32, True, False),
])
def test_build_matches_jax_builder(tmp_path, k, tsk, centromere):
    rng = np.random.default_rng(k + 100 * tsk)
    tfile = _genomes(tmp_path, rng, 4, 3000, centromere=centromere)
    prof = Profile(name="t", htsize=65521, light=False, default_k=k)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jdb = jbuilder.build_database(jparse_targets(tfile), str(tmp_path / "j"),
                                  prof, k, tsk=tsk)
    db = builder.build_database(parse_targets(tfile), str(tmp_path / "t"),
                                prof, k, tsk=tsk, device="host")
    assert np.array_equal(db.canonical, jdb.canonical)
    assert np.array_equal(db.labels, jdb.labels)
    assert db.n_mother == jdb.n_mother > len(db.canonical)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t"))
    assert len(names) == (3 + 4 * tsk)
    _same_files(str(tmp_path / "j"), str(tmp_path / "t"), names)


@pytest.mark.parametrize("k", [13, 31, 32])
@pytest.mark.parametrize("partitioned", [False, True],
                         ids=["one-shot", "partitioned"])
def test_device_cpu_equals_host_aggregate(tmp_path, monkeypatch, k,
                                          partitioned):
    """device="cpu" (the twin of torch.sort + K6) writes the same DB as
    the native host aggregate; CLARK_TPU_BUILD_PART_MIN forces the
    bounded-memory partitioned path on or off."""
    rng = np.random.default_rng(k)
    tfile = _genomes(tmp_path, rng, 3, 4000)
    prof = Profile(name="t", htsize=65521, light=False, default_k=k)
    monkeypatch.setenv("CLARK_TPU_BUILD_PART_MIN",
                       "0" if partitioned else str(1 << 40))
    calls = []
    real = device_build.aggregate_device

    def spy(*a, **kw):
        calls.append(len(a[0]))
        return real(*a, **kw)

    monkeypatch.setattr(device_build, "aggregate_device", spy)
    out = {}
    for dev in ("host", "cpu"):
        d = tmp_path / str(dev)
        d.mkdir()
        out[dev] = builder.build_database(parse_targets(tfile), str(d), prof,
                                          k, device=dev)
    assert np.array_equal(out["host"].canonical, out["cpu"].canonical)
    assert np.array_equal(out["host"].labels, out["cpu"].labels)
    assert out["host"].n_mother == out["cpu"].n_mother
    stem = prof.db_stem(k, 3, 0, prof.default_gap)
    _same_files(str(tmp_path / "host"), str(tmp_path / "cpu"),
                [stem + e for e in (".sz", ".ky", ".lb")])
    # one call one-shot; partitioned: one per partition, each with its
    # occurrences as they are (no padding to a power of two)
    n_occ = sum(len(native.extract_canonical(
        (tmp_path / f"g{i}.fa").read_bytes(), k, False, 1)) for i in range(3))
    assert sum(calls) == n_occ and (len(calls) > 1) == partitioned


def _occurrences(rng, k, n=20_000):
    """Canonical k-mers with repeats (groups of 1 to hundreds, one longer
    than 255), labels of 5 targets of which 2 share a prefix group."""
    top = 1 << (2 * k) if k < 32 else 1 << 64
    uniq = rng.integers(0, top - 1, size=n // 4, dtype=np.uint64, endpoint=False)
    if k == 32:  # keys with bit 63 set sort first as int64
        uniq[: len(uniq) // 2] |= np.uint64(1 << 63)
    canon = uniq[rng.integers(0, len(uniq), size=n)]
    canon = np.concatenate([canon, np.full(300, uniq[0], np.uint64)])
    label = rng.integers(0, 5, size=len(canon)).astype(np.int32)
    label[-300:] = np.arange(300) % 5  # the long group's mult caps at 255
    pg = np.array([0, 1, 2, 2, 3], np.int32)
    return canon, label, pg


@pytest.mark.parametrize("lelement", [True, False])
@pytest.mark.parametrize("k", [9, 27, 31, 32])
def test_aggregate_device_plain_equals_jax_and_host(k, lelement):
    rng = np.random.default_rng(k)
    canon, label, pg = _occurrences(rng, k)
    want = jdevice_build.aggregate_device(canon, label, pg, lelement)
    host = native.aggregate_occurrences(canon, label, pg, lelement)
    got = device_build.aggregate_device_plain(
        torch.from_numpy(canon.view(np.int64)), torch.from_numpy(label),
        torch.from_numpy(pg), lelement)
    got = [g.numpy() for g in got]
    got[0] = got[0].view(np.uint64)
    for g, w, h in zip(got, want, host):
        assert g.dtype == h.dtype
        assert np.array_equal(g, w) and np.array_equal(g, h)
    assert (got[2] == 255).any() and np.all(np.diff(got[0]) > 0)
    # the 300-fold repeat is the longest group: its count caps at 254
    assert got[3].max() == (254 if lelement else (canon == canon[-1]).sum())


@pytest.mark.parametrize("k", [31, 32])
def test_padded_partition_sentinel(k):
    """A partition padded with the 2^64-1 sentinel (as the builder handed
    partitions to the device before K6 took them unpadded; K6 still takes
    padded input) aggregates its pad entries to one trailing group: the top
    partition's real groups all survive, also at k = 32 where int64
    carriers would sort the pad first."""
    rng = np.random.default_rng(7)
    canon, label, pg = _occurrences(rng, k, n=5000)
    top = canon.max()
    kv = np.empty(len(canon), native.KV_DTYPE)
    kv["k"] = canon
    kv["v"] = (np.arange(len(canon)) << 16) | label
    pad = (1 << 20) - len(canon)
    got = device_build.aggregate_device(
        np.concatenate([canon, np.full(pad, np.uint64(2**64 - 1))]),
        np.concatenate([label, np.zeros(pad, np.int32)]), pg, True, "cpu")
    want = native.aggregate_kv_range(kv.copy(), 0, len(canon), pg, True)
    assert got[0][-1] == np.uint64(2**64 - 1) and got[3][-1] == 254
    for g, w in zip(got[:4], want[:4]):
        assert np.array_equal(g[:-1], w)
    assert got[0][-2] == top


def test_failing_device_aggregate_raises(tmp_path, monkeypatch):
    """No fallback to the host aggregate: a device failure propagates, one-
    shot and partitioned, and CUDA asked for without a card raises."""
    rng = np.random.default_rng(33)
    tfile = _genomes(tmp_path, rng, 3, 800)
    prof = Profile(name="t", htsize=1021, light=False, default_k=9)

    def boom(*a, **kw):
        raise RuntimeError("device aggregate failed")

    monkeypatch.setattr(device_build, "aggregate_device", boom)
    for part_min in (str(1 << 40), "0"):
        monkeypatch.setenv("CLARK_TPU_BUILD_PART_MIN", part_min)
        with pytest.raises(RuntimeError, match="device aggregate failed"):
            builder.build_database(parse_targets(tfile), str(tmp_path), prof,
                                   9, device="cpu")
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        builder.build_database(parse_targets(tfile), str(tmp_path), prof, 9,
                               device=True)


def test_default_device_is_cuda(tmp_path, monkeypatch, capsys):
    """builder.build_database, database.build and `cli db build` aggregate
    on cuda unless told otherwise: without a CUDA device the default raises
    before the aggregate (no quiet fallback to the host), while "host" and
    --tsk builds, which aggregate on the host, still build."""
    rng = np.random.default_rng(34)
    tfile = _genomes(tmp_path, rng, 3, 800)
    prof = Profile(name="t", htsize=1021, light=False, default_k=9)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert builder._device_of(True) == torch.device("cuda")
    assert builder._device_of("cuda") == torch.device("cuda")
    assert builder._device_of("host") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    monkeypatch.setattr(device_build, "aggregate_device",
                        lambda *a, **kw: calls.append(a))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        builder.build_database(parse_targets(tfile), str(tmp_path), prof, 9)
    sub = tmp_path / "sub"
    sub.mkdir()
    cfg = database.DBConfig(db_dir=str(tmp_path), targets=tfile,
                            subdb=str(sub), rank=0, profile_name="t", k=9,
                            gap=0, min_count_target=0, htsize=1021,
                            light=False)
    cfg.save()
    with pytest.raises(RuntimeError, match="--device host"):
        database.build(cfg, profile=prof)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["db", "build", str(tmp_path), "-k", "9", "--htsize", "1021"])
    assert not calls and not os.listdir(sub)
    builder.build_database(parse_targets(tfile), str(tmp_path), prof, 9,
                           tsk=True)
    assert cli.main(["db", "build", str(tmp_path), "-k", "9", "--htsize",
                     "1021", "--device", "host"]) == 0
    assert "Database built:" in capsys.readouterr().out and not calls


def test_import_builder_leaves_jax_out():
    code = (
        "import sys\n"
        "import jn_cuclark_tpu_torch.db.builder, jn_cuclark_tpu_torch.database\n"
        "import jn_cuclark_tpu_torch.db.device_build\n"
        "import jn_cuclark_tpu_torch.abundance, jn_cuclark_tpu_torch.taxonomy\n"
        "import jn_cuclark_tpu_torch.download, jn_cuclark_tpu_torch.cli\n"
        "jn_cuclark_tpu_torch.cli.build_parser()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jn_cuclark_tpu', '__graft_entry__', 'bench')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("device", ["host", "cpu"], ids=["host", "device-cpu"])
def test_cli_db_build(tmp_path, device, capsys):
    rng = np.random.default_rng(5)
    tfile = _genomes(tmp_path, rng, 3, 1500)
    sub = tmp_path / "sub"
    sub.mkdir()
    database.DBConfig(db_dir=str(tmp_path), targets=tfile, subdb=str(sub),
                      rank=0, profile_name="c", k=11, gap=0,
                      min_count_target=0, htsize=4093, light=False).save()
    args = ["db", "build", str(tmp_path), "-k", "11", "--htsize", "4093"]
    assert cli.main(args + ["--device", device]) == 0
    assert "Database built:" in capsys.readouterr().out
    (tmp_path / "lib").mkdir()
    prof = Profile(name="custom4093", htsize=4093, light=False, default_k=11)
    builder.build_database(parse_targets(tfile), str(tmp_path / "lib"), prof,
                           11, device="host")
    stem = prof.db_stem(11, 3, 0, 0)
    _same_files(str(sub), str(tmp_path / "lib"),
                [stem + e for e in (".sz", ".ky", ".lb")])
    cfg = database.DBConfig.load(str(tmp_path))
    assert (cfg.k, cfg.htsize, cfg.profile_name) == (11, 4093, "custom4093")
    # db set-targets (which raised before the tools were ported): the
    # genomes under Custom/ named by accession, each a species of a toy
    # taxonomy; it writes targets.txt and a config.json naming it
    (tmp_path / "Custom").mkdir()
    tax = tmp_path / "taxonomy"
    tax.mkdir()
    for i in range(3):
        body = (tmp_path / f"g{i}.fa").read_bytes().split(b"\n", 1)[1]
        (tmp_path / "Custom" / f"g{i}.fa").write_bytes(
            b">NC_%d.1 genome\n" % i + body)
    (tax / "nodes.dmp").write_text("".join(
        f"{t}\t|\t{p}\t|\t{r}\t|\tXX\t|\n" for t, p, r in
        [(1, 1, "no rank"), (2, 1, "superkingdom")]
        + [(800 + i, 2, "species") for i in range(3)]))
    # set-targets stops on a missing merged.dmp or file named *nodes.dmp
    for fn in ("merged.dmp", "delnodes.dmp"):
        (tax / fn).write_text("")
    (tax / "nucl_accss").write_text("".join(
        f"NC_{i}\tNC_{i}.1\t{800 + i}\t{i}\n" for i in range(3)))
    assert cli.main(["db", "set-targets", str(tmp_path)]) == 0
    assert "(3 targets)" in capsys.readouterr().out
    assert (tmp_path / "targets.txt").read_text() == "".join(
        f"{tmp_path / 'Custom' / f'g{i}.fa'}\t{800 + i}\n" for i in range(3))
    cfg = database.DBConfig.load(str(tmp_path))
    assert (cfg.targets, cfg.subdb, cfg.rank) == (
        str(tmp_path / "targets.txt"), str(tmp_path / "custom_0_canonical"), 0)


def test_db_layout_helpers_match_jax(tmp_path):
    assert database.check_layout(str(tmp_path / "none")) == \
        jdatabase.check_layout(str(tmp_path / "none"))
    (tmp_path / "Custom" / "x").mkdir(parents=True)
    (tmp_path / "Custom" / "x" / "a.fna").write_text(">a\nACGT\n")
    (tmp_path / "taxonomy").mkdir()
    (tmp_path / "taxonomy" / "nodes.dmp").write_text("")
    for req in (True, False):
        assert database.check_layout(str(tmp_path), req) == \
            jdatabase.check_layout(str(tmp_path), req)
    assert database.find_sequence_files(str(tmp_path)) == \
        jdatabase.find_sequence_files(str(tmp_path))


@pytest.mark.parametrize("light,gap", [(False, 0), (True, 3)])
def test_extract_occurrences_equals_native(light, gap):
    """The numpy extractor (the plain reference) and the native one the
    build runs agree on multi-record, multi-line FASTA with invalid chars."""
    rng = np.random.default_rng(gap)
    recs = []
    for i in range(12):
        s = ACGT[rng.integers(0, 4, size=int(rng.integers(5, 400)))].tobytes()
        if i % 3 == 0:
            s = s[:30] + b"N" + s[31:]
        recs.append(b">r%d\n%s\n" % (i, b"\n".join(
            s[j : j + 60] for j in range(0, len(s), 60))))
    data = b"".join(recs)
    for k in (7, 27, 32):
        want = native.extract_canonical(data, k, light, max(gap, 1))
        got = builder.extract_occurrences(data, k, light, gap).canonical
        assert np.array_equal(got, want), k


def test_spectrum_build_matches_jax(tmp_path):
    rng = np.random.default_rng(21)
    kmers = list(dict.fromkeys(
        ACGT[rng.integers(0, 4, size=9)].tobytes().decode() for _ in range(40)))
    (tmp_path / "t1.spec").write_text(
        f"{kmers[0]} 9\n" + "".join(f"{s} 5\n" for s in kmers[1:20])
        + f"{kmers[1]} 300\n")
    (tmp_path / "t2.spec").write_text(
        f"{kmers[0]} 4\n" + "".join(f"{s} 1\n" for s in kmers[20:]))
    (tmp_path / "targets.txt").write_text(
        f"{tmp_path}/t1.spec 700\n{tmp_path}/t2.spec 701\n")
    prof = Profile(name="t", htsize=1021, light=False, default_k=9)
    for d, (bld, parse) in {"j": (jbuilder, jparse_targets),
                            "t": (builder, parse_targets)}.items():
        (tmp_path / d).mkdir()
        bld.build_database(parse(str(tmp_path / "targets.txt")),
                           str(tmp_path / d), prof, 9, min_count_target=2)
    stem = prof.db_stem(9, 2, 2, 0)
    _same_files(str(tmp_path / "j"), str(tmp_path / "t"),
                [stem + e for e in (".sz", ".ky", ".lb")])


def test_saturating_group_sum_and_ht_strings_match_jax():
    rng = np.random.default_rng(5)
    bounds = np.concatenate([[0], np.cumsum(rng.integers(1, 40, size=200))])
    v = rng.integers(1, 120, size=int(bounds[-1])).astype(np.int64)
    assert np.array_equal(builder._saturating_group_sum(bounds, v),
                          jbuilder._saturating_group_sum(bounds, v))
    for c in rng.integers(0, 1 << 62, size=20, dtype=np.uint64):
        assert builder.ht_kmer_string(c, 31) == jbuilder.ht_kmer_string(c, 31)


def test_too_many_targets_rejected(tmp_path):
    targets = TargetsDef(files=[], file_labels=[], file_labels_c=[],
                         labels=[f"L{i}" for i in range(MTRGTS + 1)],
                         labels_c=[])
    prof = Profile(name="t", htsize=1021, light=False, default_k=31)
    with pytest.raises(ValueError, match="16-bit"):
        builder.build_database(targets, str(tmp_path), prof, 31)


def test_analyser_matches_jax(tmp_path):
    freqs = {1: 500, 2: 120, 3: 30, 10: 5, 15: 20, 18: 60, 20: 100, 22: 60,
             25: 20, 30: 5, 40: 2, 45: 1, 50: 1}
    lines = [f"KMER {c}" for c, n in freqs.items() for _ in range(n)]
    (tmp_path / "spec.txt").write_text("\n".join(lines) + "\nbad line x\n")
    a, j = Analyser(str(tmp_path / "spec.txt")), JAnalyser(str(tmp_path / "spec.txt"))
    assert a.frequency == j.frequency and a.kmer_ids == j.kmer_ids
    for div in (1, 2, 3):
        assert a.bump_interval(div) == j.bump_interval(div)
    s, e, found = a.bump_interval(1)
    assert found and s <= 20 <= e
