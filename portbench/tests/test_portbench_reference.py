"""The plain reference against the port's CPU path."""

import os

import numpy as np
import pytest
import torch

from jn_cuclark_tpu_torch.db.builder import build_database
from jn_cuclark_tpu_torch.engine import Classifier
from jn_cuclark_tpu_torch.io.dbformat import read_db
from jn_cuclark_tpu_torch.io.targets import parse_targets
from portbench import gen, run
from portbench.references import clark
from portbench.tests import tiny


@pytest.mark.parametrize("name", tiny.CELLS)
def test_a_cpu_run_is_correct(name):
    out = run.run_cell(tiny.cell(name), 2**33 + 5, 0.5, False, device="cpu")
    assert out["correct"] and out["failed"] == 0
    assert out["checks"] == {"rows_wrong": {"value": 0, "limit": 0}}
    assert out["attempted"] >= 3000 and out["attempted"] % 3000 == 0
    assert set(out["metrics"]) == {"reads_per_s", "setup_s"}


def _program_db(c, tmp_path, seed=3):
    cfg = c.config
    genomes = gen.make_genomes(cfg, seed, "cpu")
    targets_file = gen.write_genomes(genomes, cfg, str(tmp_path))
    profile = run._profile(cfg)
    build_database(parse_targets(targets_file), str(tmp_path), profile,
                   cfg["k"], device="cpu")
    stem = os.path.join(str(tmp_path), profile.db_stem(
        cfg["k"], cfg["targets"], 0, cfg["gap"]))
    keys, labels = read_db(stem, profile, cfg["k"])
    files = [ln.split()[0] for ln in open(targets_file)]
    return genomes, targets_file, (keys, labels), files


@pytest.mark.parametrize("name", tiny.CELLS)
def test_the_database_is_the_programs(name, tmp_path):
    c = tiny.cell(name)
    _, _, (keys, labels), files = _program_db(c, tmp_path)
    cfg = c.config
    rk, rl = clark.database(files, cfg["k"], cfg["light"], cfg["gap"], "cpu")
    order = np.argsort(keys)
    assert np.array_equal(rk.numpy().astype(np.uint64), keys[order])
    assert np.array_equal(rl.numpy(), labels[order].astype(np.int64))
    if cfg["light"]:  # one 27-mer in 4 of each genome's 7,407 blocks
        assert len(rk) == 4 * 1852


def test_edge_reads_match_the_program(tmp_path):
    """Short reads, a read of k - 1 bases (-nan), N bases, lower case,
    chimeras of two genomes and a CRLF line (the CR counts as a base)."""
    c = tiny.cell("full16x3M-se-mixed")
    genomes, targets_file, (keys, labels), files = _program_db(c, tmp_path)
    acgt = np.array(list(b"ACGT"), np.uint8)
    g = [bytes(acgt[x.numpy()]) for x in genomes]
    seqs = [g[0][100:400], g[1][:30], g[2][5:35], g[3][:10], b"N" * 60,
            g[0][:50] + b"N" + g[0][51:160], g[1][:60] + g[2][:60],
            g[3][1000:1200].lower(), g[0][7:38] + g[1][7:38] + g[2][7:38],
            g[2][500:800]]
    fa = b"".join(b">q%d x\n%s%s\n" % (i, s, b"\r" if i == 7 else b"")
                 for i, s in enumerate(seqs))
    cfg = c.config
    clf = Classifier.load(str(tmp_path), parse_targets(targets_file),
                          run._profile(cfg), cfg["k"], device="cpu")
    rk, rl = clark.database(files, cfg["k"], False, 0, "cpu")
    names = ["NA"] + [str(1000 + i) for i in range(4)]
    got = b"".join(clf.classify_bytes(fa)[0])
    recs = clark.Records(fa)
    sc = clark.scores(recs, rk, rl, cfg["k"], 4, "cpu")
    want = b"".join(clark.rows(recs, sc, cfg["k"], names))
    assert got == want
    assert b"-nan" in want and b",NA," in want and b",1002," in want


def test_ties_go_to_the_lowest_target():
    recs = clark.Records(b">a\nACGTA\n")
    sc = {"total": np.array([6]), "ibest": np.array([2]),
          "best": np.array([3]), "sbest": np.array([3])}
    assert clark.rows(recs, sc, 3, ["NA", "x", "y"]) == [b"a,2,y,3,0.5\n"]
    keys = torch.tensor([5, 9])
    out = clark._table(keys | (1 << 40), torch.tensor([1, 0]), 32)
    assert out[0].tolist() == [5, 9] and out[1].tolist() == [1, 0]
