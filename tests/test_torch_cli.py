"""Full workflow of the PyTorch port through its CLI on the CPU: db
set-targets -> build -> classify -> verify -> abundance -> merge -> report,
then clean and update-taxonomy from a local directory (the JAX package's
tests/test_cli.py less `cluster`).  Also: set-targets writes the JAX
package's files, verify fails where CUDA is asked for and absent, and
verify's toy step equals the JAX package's `__graft_entry__.entry()` step.
Outputs are text or integers: the tolerance is 0 throughout."""

import json
import os
import shutil

import numpy as np
import pytest

from jn_cuclark_tpu import database as jdatabase
from jn_cuclark_tpu_torch import cli, database

from .test_builder import rand_seq

K = 9
ACCS = ["NC_000001", "NC_000002", "NC_000003"]
TAXIDS = [562, 28901, 99901]


def make_layout(db, rng, extra_unmapped: bool = False):
    """A reference-layout database directory: toy genomes under Custom/
    and a taxonomy (the abundance goldens' tree) with a merged.dmp remap;
    with extra_unmapped, a fourth genome whose accession is not mapped.
    Returns {taxid: genome}."""
    (db / "Custom").mkdir(parents=True)
    tax = db / "taxonomy"
    tax.mkdir()
    genomes = {}
    accs = ACCS + (["NC_000004"] if extra_unmapped else [])
    for i, acc in enumerate(accs):
        seq = rand_seq(rng, 1200)
        genomes[TAXIDS[i] if i < 3 else None] = seq
        with open(db / "Custom" / f"{acc}.fa", "w") as f:
            f.write(f">{acc}.1 toy genome {i}\n")
            for j in range(0, len(seq), 70):
                f.write(seq[j : j + 70] + "\n")
    nodes = [
        (1, 1, "no rank"), (2, 1, "superkingdom"), (1224, 2, "phylum"),
        (1236, 1224, "class"), (91347, 1236, "order"), (543, 91347, "family"),
        (561, 543, "genus"), (562, 561, "species"), (590, 543, "genus"),
        (28901, 590, "species"), (86661, 543, "species group"),
        (99901, 86661, "species"),
    ]
    with open(tax / "nodes.dmp", "w") as f:
        for tid, parent, rank in nodes:
            f.write(f"{tid}\t|\t{parent}\t|\t{rank}\t|\tXX\t|\n")
    names = [
        (1, "root"), (2, "Bacteria"), (1224, "Proteobacteria"),
        (1236, "Gammaproteobacteria"), (91347, "Enterobacterales"),
        (543, "Enterobacteriaceae"), (561, "Escherichia"),
        (562, "Escherichia coli"), (590, "Salmonella"),
        (28901, "Salmonella enterica"), (99901, "Cereus group thing"),
    ]
    with open(tax / "names.dmp", "w") as f:
        for tid, nm in names:
            f.write(f"{tid}\t|\t{nm}\t|\t\t|\tscientific name\t|\n")
    with open(tax / "merged.dmp", "w") as f:
        f.write("900\t|\t562\t|\n")  # a remap
    with open(tax / "nucl_accss", "w") as f:
        f.write("accession\taccession.version\ttaxid\tgi\n")
        f.write("NC_000001\tNC_000001.1\t900\t1\n")  # remapped -> 562
        f.write("NC_000002\tNC_000002.1\t28901\t2\n")
        f.write("NC_000003\tNC_000003.1\t99901\t3\n")
    for fn in ["citations.dmp", "delnodes.dmp", "division.dmp", "gc.prt",
               "gencode.dmp", "images.dmp"]:
        (tax / fn).touch()
    return genomes


@pytest.fixture(scope="module")
def dbdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torchclidb")
    db = root / "db"
    rng = np.random.default_rng(77)
    genomes = make_layout(db, rng)
    reads_path = root / "reads.fa"
    with open(reads_path, "w") as f:
        for i in range(120):
            g = genomes[TAXIDS[i % 3]]
            pos = rng.integers(0, len(g) - 100)
            f.write(f">r{i}\n{g[pos:pos+100]}\n")
    return root, db, reads_path, genomes


def run_cli(*argv):
    return cli.main(list(argv))


def test_set_targets_and_build(dbdir, capsys):
    root, db, reads, genomes = dbdir
    rc = run_cli("db", "set-targets", str(db), "--rank", "species",
                 "--full", "--htsize", "1048573", "-k", str(K))
    assert rc == 0
    out = capsys.readouterr().out
    assert "Targets definition written:" in out and "(3 targets)" in out
    tgt = open(db / "targets.txt").read().strip().splitlines()
    assert len(tgt) == 3
    assert {line.split("\t")[1] for line in tgt} == {"562", "28901", "99901"}

    rc = run_cli("db", "build", str(db), "--htsize", "1048573", "-k", str(K),
                 "--device", "cpu")
    assert rc == 0
    assert "Database built" in capsys.readouterr().out
    assert any(f.endswith(".sz") for f in os.listdir(db / "custom_0_canonical"))


def test_classify_and_abundance(dbdir, capsys, tmp_path):
    root, db, reads, genomes = dbdir
    res = tmp_path / "out"
    rc = run_cli("classify", "-D", str(db), "-O", str(reads), "-R", str(res),
                 "--device", "cpu")
    assert rc == 0
    lines = open(str(res) + ".csv").read().splitlines()
    assert len(lines) == 121
    right = sum(1 for i, line in enumerate(lines[1:])
                if line.split(",")[2] == str(TAXIDS[i % 3]))
    assert right > 115

    ab = tmp_path / "ab.csv"
    rc = run_cli("abundance", "-D", str(db), "-F", str(res) + ".csv",
                 "-o", str(ab))
    assert rc == 0
    text = open(ab).read()
    assert "Escherichia coli" in text and "Salmonella enterica" in text

    merged = tmp_path / "merged.csv"
    assert run_cli("merge", str(ab), str(ab), "-o", str(merged)) == 0
    rep = tmp_path / "report.txt"
    assert run_cli("report", str(merged), "-o", str(rep)) == 0
    assert open(rep).read().startswith("RESULT")


def test_abundance_krona_mpa_in_cwd(dbdir, tmp_path, monkeypatch, capsys):
    """--krona and --mpa write results.krn and results.mpa in the working
    directory; without -o the table goes to stdout."""
    root, db, reads, genomes = dbdir
    res = tmp_path / "out"
    assert run_cli("classify", "-D", str(db), "-O", str(reads), "-R",
                   str(res), "--device", "cpu") == 0
    capsys.readouterr()
    monkeypatch.chdir(tmp_path)
    assert run_cli("abundance", "-D", str(db), "-F", str(res) + ".csv",
                   "--krona", "--mpa") == 0
    out = capsys.readouterr().out
    assert out.startswith("Name,TaxID,Lineage,Count,")
    krn = (tmp_path / "results.krn").read_text().splitlines()
    assert sorted(line.split(" \t ")[0] for line in krn) == sorted(
        str(t) for t in TAXIDS)
    assert "s__Escherichia_coli" in (tmp_path / "results.mpa").read_text()


def test_classify_list_mode_and_gzip(dbdir, tmp_path):
    root, db, reads, genomes = dbdir
    import gzip

    gz = tmp_path / "reads.fa.gz"
    with open(reads, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    res = tmp_path / "gzout"
    assert run_cli("classify", "-D", str(db), "-O", str(gz), "-R", str(res),
                   "--gzipped", "--device", "cpu") == 0
    plain = tmp_path / "plainout"
    run_cli("classify", "-D", str(db), "-O", str(reads), "-R", str(plain),
            "--device", "cpu")
    assert open(str(res) + ".csv").read() == open(str(plain) + ".csv").read()

    lst_o = tmp_path / "objects.txt"
    lst_r = tmp_path / "results.txt"
    lst_o.write_text(f"{reads}\n{reads}\n")
    lst_r.write_text(f"{tmp_path}/lst1\n{tmp_path}/lst2\n")
    assert run_cli("classify", "-D", str(db), "-O", str(lst_o), "-R",
                   str(lst_r), "--device", "cpu") == 0
    assert open(tmp_path / "lst1.csv").read() == open(str(plain) + ".csv").read()
    assert open(tmp_path / "lst2.csv").read() == open(str(plain) + ".csv").read()


def test_verify(dbdir, capsys):
    root, db, reads, genomes = dbdir
    rc = run_cli("verify", "--db", str(db), "--device", "cpu")
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "STATUS: READY" in out
    assert "[OK]   device pipeline (K1, K2, K3 on cpu)" in out
    assert "[OK]   native runtime" in out
    assert f"[OK]   db layout: {db}" in out
    assert "[OK]   database files:" in out


@pytest.mark.parametrize("argv", [["verify"], ["verify", "--device", "cuda"]],
                         ids=["default", "cuda"])
def test_verify_fails_without_cuda(argv, capsys):
    """CUDA asked for (the default) and absent: the toy step fails, and
    verify exits 1; it does not move to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = run_cli(*argv)
    out = capsys.readouterr().out
    assert rc == 1
    assert "[FAIL] device pipeline: device 'cuda' was asked for but CUDA " \
        "is not available" in out
    assert "[WARN] cuda devices: none" in out
    assert out.rstrip().endswith("STATUS: INCOMPLETE")


def test_verify_db_problems(tmp_path, capsys):
    """A directory missing its layout: each problem a [FAIL], exit 1; a
    layout with no config.json warns only."""
    rc = run_cli("verify", "--db", str(tmp_path / "none"), "--device", "cpu")
    out = capsys.readouterr().out
    assert rc == 1 and "[FAIL] db layout: database directory not found" in out
    make_layout(tmp_path / "db", np.random.default_rng(1))
    rc = run_cli("verify", "--db", str(tmp_path / "db"), "--device", "cpu")
    out = capsys.readouterr().out
    assert rc == 0 and "[WARN] no config.json" in out


def test_verify_toy_step_equals_jax_entry():
    """verify's toy step (K1-K3's plain twins here) gives the arrays of
    jax.jit(__graft_entry__.entry()) on the CPU."""
    import jax

    from __graft_entry__ import entry

    fn, fargs = entry()
    want = [np.asarray(o) for o in jax.jit(fn)(*fargs)]
    got = [t.cpu().numpy() for t in cli.toy_step("cpu")]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64))
    assert got[0].shape == (64,)  # the toy's random reads miss its keys


def test_multi_sample_batch_and_merge(dbdir, tmp_path):
    """bench.py config 4's shape at toy size: 8 FASTQ runs classified, an
    abundance estimate each, merged (kent -m), reported."""
    root, db, reads, genomes = dbdir
    rng = np.random.default_rng(99)
    csvs = []
    for s in range(8):
        fq = tmp_path / f"run{s}.fq"
        with open(fq, "w") as f:
            for i in range(30):
                g = genomes[TAXIDS[(i + s) % 3]]
                pos = rng.integers(0, len(g) - 80)
                f.write(f"@run{s}_r{i}\n{g[pos:pos+80]}\n+\n{'I'*80}\n")
        res = tmp_path / f"run{s}"
        assert run_cli("classify", "-D", str(db), "-O", str(fq), "-R",
                       str(res), "--device", "cpu") == 0
        ab = tmp_path / f"run{s}_ab.csv"
        assert run_cli("abundance", "-D", str(db), "-F", str(res) + ".csv",
                       "-o", str(ab)) == 0
        csvs.append(str(ab))
    merged = tmp_path / "all.csv"
    assert run_cli("merge", *csvs, "-o", str(merged)) == 0
    text = open(merged).read().splitlines()
    counts = [int(line.split(",")[3]) for line in text[1:]
              if not line.startswith("UNKNOWN")]
    assert sum(counts) >= 230
    per = {}
    for path in csvs:
        for line in open(path).read().splitlines()[1:]:
            f = line.split(",")
            per[f[1]] = per.get(f[1], 0) + int(f[3])
    assert {line.split(",")[1]: int(line.split(",")[3])
            for line in text[1:]} == per
    rep = tmp_path / "rep.txt"
    assert run_cli("report", str(merged), "-o", str(rep)) == 0
    assert "among classified" in open(rep).read()


def test_db_clean(tmp_path, monkeypatch, capsys):
    db = tmp_path / "cleanme"
    (db / "Custom").mkdir(parents=True)
    (db / "custom_0_canonical").mkdir()
    (db / "targets.txt").write_text("x 1\n")
    (db / ".custom").write_text("x\n")
    (db / "config.json").write_text("{}")
    # asked, and refused: nothing goes
    monkeypatch.setattr("builtins.input", lambda prompt: "no")
    assert run_cli("db", "clean", str(db)) == 1
    assert "Aborting database reset." in capsys.readouterr().out
    assert (db / "targets.txt").exists()
    assert run_cli("db", "clean", str(db), "--yes") == 0
    assert (db / "Custom").exists()
    assert not (db / "custom_0_canonical").exists()
    assert not (db / "targets.txt").exists()
    assert not (db / ".custom").exists() and not (db / "config.json").exists()
    assert run_cli("db", "clean", str(db), "--yes") == 0
    assert "nothing to clean" in capsys.readouterr().out
    assert run_cli("db", "clean", str(tmp_path / "absent"), "--yes") == 1


def test_db_update_taxonomy_from_local(tmp_path, capsys):
    """updateTaxonomy.sh equivalent, fetch replaced by --from: extracts
    taxdump.tar.gz, concatenates nucl_gb then nucl_wgs into nucl_accss
    (gunzipping), touches <db>/.taxondata."""
    import gzip
    import tarfile

    dl = tmp_path / "downloads"
    dl.mkdir()
    dmp_names = [
        "citations.dmp", "delnodes.dmp", "division.dmp", "gc.prt",
        "gencode.dmp", "images.dmp", "merged.dmp", "names.dmp", "nodes.dmp",
    ]
    src = tmp_path / "dumps"
    src.mkdir()
    for n in dmp_names:
        (src / n).write_text(f"content of {n}\n")
    with tarfile.open(dl / "taxdump.tar.gz", "w:gz") as t:
        for n in dmp_names:
            t.add(src / n, arcname=n)
    (dl / "nucl_gb.accession2taxid").write_text("A1\t1\tgb\n")
    with gzip.open(dl / "nucl_wgs.accession2taxid.gz", "wt") as f:
        f.write("A2\t2\twgs\n")

    db = tmp_path / "mydb"
    db.mkdir()
    rc = run_cli("db", "update-taxonomy", str(db), "--from", str(dl))
    out = capsys.readouterr().out
    assert rc == 0, out
    tax = db / "taxonomy"
    for n in dmp_names:
        assert (tax / n).read_text() == f"content of {n}\n"
    assert (tax / "nucl_accss").read_text() == "A1\t1\tgb\nA2\t2\twgs\n"
    assert (db / ".taxondata").exists()

    db2 = tmp_path / "otherdb"
    db2.mkdir()
    rc = run_cli("db", "update-taxonomy", str(db2))
    out = capsys.readouterr().out
    assert rc == 1 and "taxdump.tar.gz" in out and "missing" in out
    assert "clark-torch db download-taxonomy" in out


def test_dp_requires_shard_db(dbdir, tmp_path):
    """--dp without --shard-db must error, not silently change topology."""
    root, db, reads, genomes = dbdir
    with pytest.raises(SystemExit, match="shard-db"):
        run_cli("classify", "-D", str(db), "-O", str(reads),
                "-R", str(tmp_path / "x"), "--dp", "2", "-d", "8",
                "--device", "cpu")


# ------------------------------------------------ set-targets against JAX
SET_TARGET_FILES = (".custom", ".custom.fileToAccssnTaxID",
                    ".custom.fileToTaxIDs", "targets.txt",
                    "files_excluded.txt", ".taxondata")


@pytest.mark.parametrize("rank", ["species", "genus", "family", "phylum"])
def test_set_targets_writes_jax_files(tmp_path, rank):
    """Two copies of one directory: the port's and the JAX package's
    set-targets write the same targets.txt, dotfiles and config.json
    fields once each copy's root is replaced (they write absolute paths)."""
    make_layout(tmp_path / "seed", np.random.default_rng(3),
                extra_unmapped=True)
    out = {}
    for pkg, mod in (("port", database), ("jax", jdatabase)):
        db = tmp_path / pkg
        shutil.copytree(tmp_path / "seed", db)
        cfg = mod.set_targets(str(db), rank=rank)
        files = {f: (db / f).read_text().replace(str(db), "<root>")
                 for f in SET_TARGET_FILES}
        conf = json.loads((db / "config.json").read_text())
        conf = {key: v.replace(str(db), "<root>") if isinstance(v, str) else v
                for key, v in conf.items()}
        assert os.path.isdir(cfg.subdb)
        out[pkg] = files, conf
    assert out["port"] == out["jax"]
    files, conf = out["port"]
    assert "NC_000004.fa" in files["files_excluded.txt"]
    assert conf["rank"] == database.RANK_NAMES[rank]
    assert conf["subdb"] == f"<root>/custom_{conf['rank']}_canonical"
    n = len(files["targets.txt"].splitlines())
    assert n == {"species": 3, "genus": 2, "family": 3, "phylum": 3}[rank]


@pytest.mark.parametrize("missing", ["taxonomy/nodes.dmp",
                                     "taxonomy/merged.dmp",
                                     "taxonomy/nucl_accss", "Custom", ""])
def test_set_targets_problems_equal_jax(tmp_path, missing):
    """The layout problems that stop set-targets are the JAX package's; a
    missing names.dmp does not stop it."""
    make_layout(tmp_path / "seed", np.random.default_rng(4))
    os.remove(tmp_path / "seed" / "taxonomy" / "names.dmp")
    errs = {}
    for pkg, mod in (("port", database), ("jax", jdatabase)):
        db = tmp_path / pkg
        shutil.copytree(tmp_path / "seed", db)
        if missing:
            p = db / missing
            shutil.rmtree(p) if p.is_dir() else os.remove(p)
            with pytest.raises(RuntimeError) as e:
                mod.set_targets(str(db))
            errs[pkg] = str(e.value).replace(str(db), "<root>")
        else:
            errs[pkg] = mod.set_targets(str(db)).rank
    assert errs["port"] == errs["jax"]
    if missing:
        assert os.path.basename(missing) in errs["port"]
