"""The light flavour at the reference's own constants (params.LIGHT:
HTSIZE 57,777,779, k = 27, gap 4; src/parameters_light_hh:39-49), the
flavour `kent -c` runs and the port's CLI takes with no profile flag, on
the CPU (the kernels' plain twins):

(a) the port's `.sz`/`.ky`/`.lb` against the JAX package's
    `builder.build_database`, and its plain, `--extended` and paired CSVs
    against the JAX `Classifier`'s;
(b) the port's CLI with no profile flag (`db set-targets`, `db build`,
    `classify`) against the JAX package's CLI with none: the same stem and
    the same files;
(c) where the reference tree and g++ are present (tests/tools/refbuild),
    the port against the compiled reference at its real light constants,
    as tests/test_real_profile_parity.py holds the JAX package.

The fixture is tests/test_real_profile_parity.py's: seed 57, genomes of
4,000 and 3,500 bp sharing 300 bp, 150 reads of 80-200 bp and a junk
read; the pairs are mates cut from the first genome.  Tolerance: exact,
bytes."""

import os
import sys

import numpy as np
import pytest

import chip_smoke
from jn_cuclark_tpu import cli as jcli
from jn_cuclark_tpu import params as jparams
from jn_cuclark_tpu.db import builder as jbuilder
from jn_cuclark_tpu.engine import Classifier as JClassifier
from jn_cuclark_tpu.io.targets import parse_targets as jparse_targets
from jn_cuclark_tpu_torch import cli, database, params
from jn_cuclark_tpu_torch.db import builder
from jn_cuclark_tpu_torch.engine import Classifier
from jn_cuclark_tpu_torch.io.targets import parse_targets

HERE = os.path.dirname(os.path.abspath(__file__))
K = 27
PROF = params.LIGHT
DB_EXTS = (".sz", ".ky", ".lb")
CSVS = ("plain", "extended", "paired")


def write_fixture(root):
    """tests/test_real_profile_parity.py's genomes (g0.fa, g1.fa, FASTA
    lines of 70), targets.txt (taxids 3001, 3002) and reads.fa; then 12
    pairs of 100-bp mates 150 bp apart from the first genome (r1.fq,
    r2.fq)."""
    rng = np.random.default_rng(57)

    def rs(n):
        return "".join(rng.choice(list("ACGT"), n))

    genomes = [rs(4000), rs(3500)]
    shared = rs(300)
    genomes[0] += shared
    genomes[1] += shared
    with open(root / "targets.txt", "w") as tf:
        for i, g in enumerate(genomes):
            p = root / f"g{i}.fa"
            with open(p, "w") as f:
                f.write(f">g{i}\n")
                for j in range(0, len(g), 70):
                    f.write(g[j : j + 70] + "\n")
            tf.write(f"{p} {3001 + i}\n")
    with open(root / "reads.fa", "w") as f:
        for i in range(150):
            g = genomes[i % 2]
            ln = int(rng.integers(80, 200))
            pos = int(rng.integers(0, len(g) - ln))
            f.write(f">r{i}\n{g[pos:pos+ln]}\n")
        f.write(f">junk\n{rs(120)}\n")
    g = genomes[0]
    with open(root / "r1.fq", "w") as f1, open(root / "r2.fq", "w") as f2:
        for i, p in enumerate(range(0, 12 * 340, 340)):
            f1.write(f"@p{i}/1\n{g[p:p+100]}\n+\n{'I' * 100}\n")
            f2.write(f"@p{i}/2\n{g[p+250:p+350]}\n+\n{'I' * 100}\n")


def classify_all(clf, root, out):
    """The plain, extended and paired runs of a Classifier into out."""
    reads = str(root / "reads.fa")
    clf.classify_file(reads, str(out / "plain"))
    clf.classify_file(reads, str(out / "extended"), extended=True)
    clf.classify_file(str(root / "r1.fq"), str(out / "paired"),
                      paired_path=str(root / "r2.fq"))


@pytest.fixture(scope="module")
def api_runs(tmp_path_factory):
    """The fixture built and classified by the JAX package and by the
    port (device="cpu"), each into a directory of its own."""
    root = tmp_path_factory.mktemp("light_api")
    write_fixture(root)
    stem = PROF.db_stem(K, 2, 0, 4)
    jt = jparse_targets(str(root / "targets.txt"))
    (root / "jax").mkdir()
    jbuilder.build_database(jt, str(root / "jax"), jparams.LIGHT, K)
    classify_all(JClassifier.load(str(root / "jax"), jt, jparams.LIGHT, K),
                 root, root / "jax")
    pt = parse_targets(str(root / "targets.txt"))
    (root / "port").mkdir()
    builder.build_database(pt, str(root / "port"), PROF, K, device="cpu")
    classify_all(Classifier.load(str(root / "port"), pt, PROF, K,
                                 device="cpu"), root, root / "port")
    return root, stem


def test_light_constants_and_stem(api_runs):
    """The port's LIGHT is the reference's light flavour: u32 keys at
    k = 27 (t_b = 12), a .sz of one byte a bucket, the JAX package's stem."""
    root, stem = api_runs
    assert (PROF.htsize, PROF.default_k, PROF.default_gap, PROF.light) == (
        57_777_779, 27, 4, True)
    assert PROF.key_dtype(K) == np.uint32
    assert stem == jparams.LIGHT.db_stem(K, 2, 0, 4) == (
        "db_central_k27_t2_s57777779_m0_light_4.tsk")
    assert (root / "port" / (stem + ".sz")).stat().st_size == PROF.htsize
    n_keys = (root / "port" / (stem + ".ky")).stat().st_size // 4
    assert n_keys == (root / "port" / (stem + ".lb")).stat().st_size // 2 > 0


@pytest.mark.parametrize("ext", DB_EXTS)
def test_db_equals_jax(api_runs, ext):
    root, stem = api_runs
    assert (root / "port" / (stem + ext)).read_bytes() == (
        root / "jax" / (stem + ext)).read_bytes()


@pytest.mark.parametrize("run", CSVS)
def test_csv_equals_jax(api_runs, run):
    root, _ = api_runs
    got = (root / "port" / f"{run}.csv").read_bytes()
    assert got == (root / "jax" / f"{run}.csv").read_bytes()
    rows = got.decode().splitlines()[1:]
    assert len(rows) == (12 if run == "paired" else 151)
    # a read spans a sampled k-mer (one every 108 bp) from 135 bp on, and
    # now and then below: most reads are assigned (in the shared 300 bp a
    # genome's sampled k-mers may be the other's unsampled ones, so either
    # genome), the junk read not; every pair (mates 250 bp apart) genome 0
    got = [r.split(",")[2] for r in rows]
    if run == "paired":
        assert got == ["3001"] * 12
    elif run == "plain":
        assert got[-1] == "NA"
        assert sum(a != "NA" for a in got) > 120


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory, api_runs):
    """The fixture's genomes through each package's CLI with no profile
    flag: `db set-targets` on a reference layout (chip_smoke.cli_layout:
    species 1000 and 1001), `db build`, `classify`; the port on the CPU."""
    root, _ = api_runs
    out = {}
    for pkg, main, device in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        db = root / f"cli_{pkg}"
        chip_smoke.cli_layout(str(db), str(root), 2)
        res = root / f"cli_{pkg}_res"
        assert main(["db", "set-targets", str(db)]) == 0
        assert main(["db", "build", str(db), *device]) == 0
        assert main(["classify", "-D", str(db), "-O", str(root / "reads.fa"),
                     "-R", str(res), *device]) == 0
        out[pkg] = db, res
    return root, out


def test_cli_without_a_profile_flag_is_light(cli_runs):
    """Each CLI records the light profile and builds the same stem."""
    _, out = cli_runs
    stem = PROF.db_stem(K, 2, 0, 4)
    for pkg, (db, _) in out.items():
        cfg = database.DBConfig.load(str(db))
        assert (cfg.profile_name, cfg.htsize, cfg.k, cfg.gap) == (
            "light", PROF.htsize, K, 4), pkg
        assert sorted(f for f in os.listdir(cfg.subdb)
                      if f.endswith(DB_EXTS)) == sorted(
            stem + ext for ext in DB_EXTS), pkg


@pytest.mark.parametrize("ext", (*DB_EXTS, ".csv"))
def test_cli_outputs_equal_jax(cli_runs, ext):
    """The flagless CLIs' DB files and CSV are byte-equal, and the DB is
    the API's (the same genomes in the same order)."""
    root, out = cli_runs
    stem = PROF.db_stem(K, 2, 0, 4)

    def path(pkg):
        db, res = out[pkg]
        if ext == ".csv":
            return f"{res}.csv"
        return os.path.join(database.DBConfig.load(str(db)).subdb,
                            stem + ext)

    with open(path("port"), "rb") as a, open(path("jax"), "rb") as b:
        got = a.read()
        assert got == b.read()
    if ext != ".csv":
        assert got == (root / "port" / (stem + ext)).read_bytes()


def test_port_equals_the_compiled_reference(tmp_path, api_runs):
    """The port's DB and CSV against the reference's own engine compiled
    at the real light constants (tests/tools/refbuild)."""
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import refbuild

    if not refbuild.available():
        pytest.skip("reference tree or g++ not available")
    root, stem = api_runs
    exe = refbuild.stage_engine(PROF.htsize, True, str(tmp_path / "ref"))
    dbref = tmp_path / "dbref"
    dbref.mkdir()
    refbuild.run_engine(exe, str(root / "targets.txt"), str(dbref),
                        str(root / "reads.fa"), str(tmp_path / "ref_out"), K)
    for ext in DB_EXTS:
        assert (root / "port" / (stem + ext)).read_bytes() == (
            dbref / (stem + ext)).read_bytes(), ext
    assert (root / "port" / "plain.csv").read_bytes() == (
        tmp_path / "ref_out.csv").read_bytes()
