"""A DB label outside [0, n_targets) is refused by the port's Classifier
(ValueError), however it arrives: given to the constructor, read from a
DB's .lb file through Classifier.load, or stored in the .idx.npz cache of
a DB built for more targets than the targets file names.  Left unchecked,
the native formatter indexes the target names past their end, and K3's
small form skips labels above T."""

import os
import shutil

import numpy as np
import pytest

from jn_cuclark_tpu_torch.db import builder
from jn_cuclark_tpu_torch.engine import Classifier
from jn_cuclark_tpu_torch.io import dbformat
from jn_cuclark_tpu_torch.io.targets import parse_targets
from jn_cuclark_tpu_torch.ops import radix_table
from jn_cuclark_tpu_torch.params import Profile

ACGT = np.frombuffer(b"ACGT", np.uint8)
PROF = Profile(name="c4093", htsize=4093, light=False, default_k=11)
K = 11


@pytest.mark.parametrize("bad", [2, -1], ids=["n_targets", "minus_one"])
def test_constructor_refuses_label_out_of_range(bad):
    rng = np.random.default_rng(0)
    keys = np.unique(rng.integers(1, 1 << 40, size=500, dtype=np.uint64))
    labels = rng.integers(0, 2, size=len(keys)).astype(np.int32)
    names = ["NA", "t0", "t1"]
    clf = Classifier(PROF, K, names, keys, labels, device="cpu")
    assert clf.n_targets == 2
    labels[len(labels) // 2] = bad
    with pytest.raises(ValueError, match=rf"label {bad} lies outside \[0, 2\)"):
        Classifier(PROF, K, names, keys, labels, device="cpu")


def test_constructor_refuses_the_reproduced_case():
    """The case that wrote byte 0x01 as an Assignment: names ["NA", "t0"],
    half of a genome's k-mers labelled 5."""
    rng = np.random.default_rng(1)
    keys = np.unique(rng.integers(1, 1 << 50, size=3000, dtype=np.uint64))
    labels = np.zeros(len(keys), np.int32)
    labels[::2] = 5
    with pytest.raises(ValueError, match="label 5 lies outside"):
        Classifier(PROF, 27, ["NA", "t0"], keys, labels, device="cpu")


def _db(tmp_path, n_targets: int = 3):
    """A DB of n_targets random genomes, and a targets file naming one
    target fewer whose DB stem holds copies of the DB's files (as where a
    user renames a DB, or points -T at a smaller targets file)."""
    rng = np.random.default_rng(2)
    with open(tmp_path / "targets.txt", "w") as tf:
        for i in range(n_targets):
            p = tmp_path / f"g{i}.fa"
            p.write_bytes(b">g%d\n%s\n" % (
                i, ACGT[rng.integers(0, 4, size=2000)].tobytes()))
            tf.write(f"{p} {700 + i}\n")
    targets = parse_targets(str(tmp_path / "targets.txt"))
    builder.build_database(targets, str(tmp_path), PROF, K, device="host")
    with open(tmp_path / "targets.txt") as f, open(
            tmp_path / "fewer.txt", "w") as g:
        g.writelines(f.readlines()[:-1])
    return (os.path.join(tmp_path, PROF.db_stem(K, n_targets, 0)),
            os.path.join(tmp_path, PROF.db_stem(K, n_targets - 1, 0)))


def _copy(stem, to, exts=(".sz", ".ky", ".lb")):
    for ext in exts:
        shutil.copyfile(stem + ext, to + ext)


def test_load_refuses_lb_labels_past_the_targets(tmp_path):
    stem, fewer = _db(tmp_path)
    _copy(stem, fewer)
    assert not os.path.exists(fewer + ".idx.npz")
    with pytest.raises(ValueError, match=r"label 2 lies outside \[0, 2\)"):
        Classifier.load(str(tmp_path), str(tmp_path / "fewer.txt"), PROF, K,
                        device="cpu")


def test_load_refuses_cached_table_past_the_targets(tmp_path, monkeypatch):
    stem, fewer = _db(tmp_path)
    clf = Classifier.load(str(tmp_path), str(tmp_path / "targets.txt"), PROF,
                          K, device="cpu")  # writes the .idx.npz cache
    assert clf.n_targets == 3
    table = radix_table.load_cache(stem + ".idx.npz")
    assert radix_table.max_label1(table) == 3
    assert radix_table.max_label1(table, rows_per_step=3) == 3
    _copy(stem, fewer, (".sz", ".ky", ".lb", ".idx.npz"))

    def no_read(*a, **kw):
        raise AssertionError("the DB files were read, not the cache")

    monkeypatch.setattr(dbformat, "read_db", no_read)
    # the cache (keyed on the DB files, which are equal) holds label+1 = 3
    with pytest.raises(ValueError, match=r"label 2 lies outside \[0, 2\)"):
        Classifier.load(str(tmp_path), str(tmp_path / "fewer.txt"), PROF, K,
                        device="cpu")
    # the same cache with the targets it was built for loads
    assert Classifier.load(str(tmp_path), str(tmp_path / "targets.txt"),
                           PROF, K, device="cpu").n_targets == 3
