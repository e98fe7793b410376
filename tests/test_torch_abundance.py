"""Abundance, merge, report and the taxonomy helpers of the PyTorch port on
the CPU: byte-equal to the goldens made from the reference binaries
(tests/tools/make_abundance_goldens.py), and to the JAX package on CSVs
made from a numpy seed.  Outputs are text: the tolerance is 0 throughout."""

import os

import numpy as np
import pytest

from jn_cuclark_tpu import abundance as jabundance
from jn_cuclark_tpu import taxonomy as jtaxonomy
from jn_cuclark_tpu_torch import abundance, taxonomy
from jn_cuclark_tpu_torch.utils import native

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "golden")
FIX = os.path.join(GOLD, "fixtures")
DB = os.path.join(FIX, "db")
TAX = os.path.join(DB, "taxonomy")


def golden(name):
    with open(os.path.join(GOLD, name)) as f:
        return f.read()


@pytest.mark.parametrize("files,kw,name", [
    (["res1.csv"], dict(db_dir=DB), "abundance_default.csv"),
    (["res1.csv", "res2.csv"], dict(db_dir=DB), "abundance_two_files.csv"),
    (["res1.csv"], dict(db_dir=DB, high_confidence=True), "abundance_hc.csv"),
    (["res1.csv"], {}, "abundance_notax.csv"),
    (["res1.csv"], dict(db_dir=DB, min_abundance=20.0),
     "abundance_minab.csv"),
], ids=["default", "two_files", "highconfidence", "no_taxonomy",
        "min_abundance"])
def test_estimate_golden(files, kw, name):
    res = abundance.estimate([os.path.join(FIX, f) for f in files], **kw)
    assert res.text() == golden(name)


def test_krona_mpa(tmp_path):
    abundance.estimate(
        [os.path.join(FIX, "res1.csv"), os.path.join(FIX, "res2.csv")],
        db_dir=DB,
        krona_path=str(tmp_path / "out.krn"),
        mpa_path=str(tmp_path / "out.mpa"),
    )
    assert (tmp_path / "out.krn").read_text() == golden("golden.krn")
    assert (tmp_path / "out.mpa").read_text() == golden("golden.mpa")


def test_merge(tmp_path):
    out = tmp_path / "merged.csv"
    abundance.merge(
        [os.path.join(GOLD, "abundance_default.csv"),
         os.path.join(GOLD, "abundance_two_files.csv")],
        str(out),
    )
    assert out.read_text() == golden("merged.csv")


def test_report(tmp_path):
    out = tmp_path / "report.txt"
    abundance.report(os.path.join(GOLD, "merged.csv"), str(out))
    assert out.read_text() == golden("report.txt")


def test_native_scan_matches_python(tmp_path, monkeypatch):
    """The native abundance_scan is line-for-line equal to the Python
    estimate loop on adversarial CSVs (odd floats, missing and empty
    fields, CRLF, truncated lines, long labels, which the scan hands to the
    loop).  A scan that returns None is the loop's path."""
    rng = np.random.default_rng(5)
    labels = ["1280", "562", "NA", "0", "99999999", "x" * 12, "-7"]
    gammas = ["0.5", "-nan", "nan", "0", "1e-3", "", "bad", "0.75", " 0.2",
              "0.7_5", "0" * 70 + ".5"]
    confs = ["0.75", "0.5", "1", "0.2", "-inf", "", "zz", "0.9"]

    def rand_csv(ncols_header, n):
        hdr = ",".join(f"c{i}" for i in range(ncols_header))
        lines = [hdr]
        for i in range(n):
            kind = rng.integers(0, 10)
            if kind == 0:
                lines.append("")
            elif kind == 1:
                lines.append(f"r{i}")
            elif kind == 2:
                lines.append(f"r{i},{rng.choice(gammas)}")
            else:
                g = rng.choice(gammas)
                lbl = rng.choice(labels)
                c = rng.choice(confs)
                sep = "\t" if kind == 3 else ","
                extra = ",,," if kind == 4 else ""
                lines.append(f"r{i}{sep}{g}{sep}{lbl}{sep}7{sep}{c}{extra}")
        eol = "\r\n" if rng.integers(0, 2) else "\n"
        return (eol.join(lines) + (eol if rng.integers(0, 2) else "")).encode()

    for trial in range(30):
        data = rand_csv(int(rng.integers(3, 8)), int(rng.integers(1, 60)))
        p = tmp_path / f"t{trial}.csv"
        p.write_bytes(data)
        got = abundance.estimate([str(p)], min_confidence=0.5, min_gamma=0.01)
        with monkeypatch.context() as m:
            m.setattr(native, "abundance_scan", lambda *a, **k: None)
            want = abundance.estimate(
                [str(p)], min_confidence=0.5, min_gamma=0.01
            )
        assert got.rows == want.rows, data[:400]
        assert got.header == want.header


# ------------------------------------------------- port against JAX, seeded
TAXIDS = ["562", "28901", "99901", "12345", "NA"]


def seeded_csv(path, seed: int, extended: bool, python_path: bool):
    """A classification CSV of 300 rows from a numpy seed: labels of the
    fixture tree, one taxid it lacks and NA; %g gammas and confidences.
    With python_path one gamma reads `0.7_5`, which the native scan hands
    to the Python loop."""
    rng = np.random.default_rng(seed)
    names = TAXIDS[:3]
    cols = ["Object_ID", *(names if extended else []), "Gamma",
            "Assignment", "Score", "Confidence"]
    lines = [",".join(cols)]
    for i in range(300):
        lbl = TAXIDS[rng.integers(0, len(TAXIDS))]
        gamma = "%g" % rng.random()
        if python_path and i == 150:
            gamma = "0.7_5"
        conf = "%g" % rng.choice([1.0, rng.random()])
        counts = [str(int(c)) for c in rng.integers(0, 90, size=3)]
        row = [f"r{i}", *(counts if extended else []), gamma, lbl,
               str(int(rng.integers(0, 120))), conf]
        lines.append(",".join(row))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("extended", [False, True], ids=["plain", "extended"])
@pytest.mark.parametrize("python_path", [False, True],
                         ids=["native_scan", "python_loop"])
@pytest.mark.parametrize("with_tax", [True, False], ids=["tax", "notax"])
def test_tools_equal_jax(tmp_path, monkeypatch, extended, python_path,
                         with_tax):
    """estimate (with Krona and MPA), merge and report write the JAX
    package's bytes; the native scan runs, or hands the file to the loop
    where a gamma is `0.7_5`."""
    scans = []
    scan = native.abundance_scan

    def spy(*a, **kw):
        scans.append(scan(*a, **kw))
        return scans[-1]

    monkeypatch.setattr(native, "abundance_scan", spy)
    db = DB if with_tax else None
    ab = {}
    for pkg, mod in (("port", abundance), ("jax", jabundance)):
        d = tmp_path / pkg
        d.mkdir()
        csvs = [seeded_csv(d / f"s{s}.csv", s, extended, python_path)
                for s in range(2)]
        outs = []
        for s, files in enumerate((csvs, csvs[:1])):
            kw = dict(krona_path=str(d / f"{s}.krn"),
                      mpa_path=str(d / f"{s}.mpa")) if with_tax else {}
            res = mod.estimate(files, db_dir=db, min_gamma=0.1, **kw)
            out = d / f"ab{s}.csv"
            out.write_text(res.text())
            outs.append(str(out))
        mod.merge(outs, str(d / "merged.csv"))
        mod.report(str(d / "merged.csv"), str(d / "report.txt"))
        # the report names its input's path: the package's own directory
        ab[pkg] = {f: (d / f).read_bytes().replace(bytes(d), b"<dir>")
                   for f in os.listdir(d)}
    assert ab["port"] == ab["jax"]
    assert len(ab["port"]) == (10 if with_tax else 6)
    assert len(scans) == 3  # one scan a file, the port's runs only
    assert all((r is None) == python_path for r in scans)
    assert ab["port"]["report.txt"].startswith(b"RESULT\n")


# ------------------------------------------------------------- taxonomy
def test_taxonomy_loaders_equal_jax():
    tree, jtree = (m.load_nodes(os.path.join(TAX, "nodes.dmp"))
                   for m in (taxonomy, jtaxonomy))
    assert np.array_equal(tree.parent, jtree.parent)
    assert np.array_equal(tree.rank, jtree.rank)
    assert tree.parent.dtype == np.uint32 and tree.rank.dtype == np.uint8
    wide = taxonomy.load_nodes(os.path.join(TAX, "nodes.dmp"),
                               max_taxid=200_000)
    assert len(wide.parent) == 200_001
    for tid in [*range(-1, 3), 543, 561, 562, 590, 28901, 86661, 99901,
                123456, 200_000]:
        assert tree.lineage6(tid) == jtree.lineage6(tid)
        assert tree.lineage8(tid) == jtree.lineage8(tid)
    assert tree.lineage8(562)[:2] == [562, 561]
    wanted = {1, 2, 562, 99901, 424242}
    assert taxonomy.load_names(os.path.join(TAX, "names.dmp"), wanted) == \
        jtaxonomy.load_names(os.path.join(TAX, "names.dmp"), wanted)


def test_taxonomy_targets_equal_jax(tmp_path):
    """Accessions of headers, the accession2taxid join with merged.dmp
    remaps, the targets definition at every rank and its file."""
    headers = [b">NC_004061.1 desc", b">gi|123|ref|NC_000913.3|",
               b">NZ_CP1:2 x", b">plain", b"no header", b">", b">a|b.c\td"]
    for h in headers:
        assert taxonomy.accession_of_header(h) == \
            jtaxonomy.accession_of_header(h)
    (tmp_path / "merged.dmp").write_text("900\t|\t562\t|\n901\t|\t1\t|\n")
    (tmp_path / "nucl_accss").write_text(
        "accession\taccession.version\ttaxid\tgi\n"
        "NC_1\tNC_1.1\t900\t1\nNC_2\tNC_2.1\t28901\t2\n"
        "NC_3\tNC_3.1\t99901\t3\nNC_5\tNC_5.1\t424242\t5\n")
    files = []
    for i, acc in enumerate(["NC_1", "NC_2", "NC_3", "NC_4", "NC_5"]):
        p = tmp_path / f"g{i}.fa"
        p.write_text(f">{acc}.1 genome\nACGT\n")
        files.append(str(p))
    files.append(str(tmp_path / "absent.fa"))
    merged = taxonomy.load_merged(str(tmp_path / "merged.dmp"))
    assert merged == jtaxonomy.load_merged(str(tmp_path / "merged.dmp"))
    mapped = taxonomy.map_files_to_taxids(
        files, str(tmp_path / "nucl_accss"), merged)
    assert mapped == jtaxonomy.map_files_to_taxids(
        files, str(tmp_path / "nucl_accss"), merged)
    assert [t for _, _, t in mapped] == [562, 28901, 99901, -1, 424242]
    tree, jtree = (m.load_nodes(os.path.join(TAX, "nodes.dmp"))
                   for m in (taxonomy, jtaxonomy))
    for rank in range(6):
        got = taxonomy.targets_definition(mapped, tree, rank)
        assert got == jtaxonomy.targets_definition(mapped, jtree, rank)
        taxonomy.write_targets_file(str(tmp_path / "port.txt"), got[0])
        jtaxonomy.write_targets_file(str(tmp_path / "jax.txt"), got[0])
        assert (tmp_path / "port.txt").read_bytes() == \
            (tmp_path / "jax.txt").read_bytes()
