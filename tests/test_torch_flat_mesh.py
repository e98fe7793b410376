"""The flat sorted-array path (packed=False) of the PyTorch port on meshes
across processes and on two-axis meshes, on the CPU, against the JAX
package's flat path.

Two processes over gloo on 127.0.0.1 (test_torch_cluster's WORKER, one
spawn for every run) classify on process meshes: one block a rank, two
blocks a rank, mesh_mode="dp", a two-axis (1, 2) mesh across processes,
and an index of 3 keys over 4 blocks whose last, rank 1's only one, holds
pad keys alone.  Both ranks' CSVs (plain, extended, paired) equal the JAX
package's one-process flat CSV byte for byte; each rank holds only its own
blocks, and a batch issues one all_reduce of int32 labels.  In one
process, two-axis meshes of CPU devices give the CSVs of the JAX
package's two-axis meshes on its 8 virtual devices.  Everything exact."""

import os
import shutil

import numpy as np
import pytest

from jn_cuclark_tpu import params as jparams
from jn_cuclark_tpu.engine import BatchPlan as JBatchPlan
from jn_cuclark_tpu.engine import Classifier as JClassifier
from jn_cuclark_tpu.io.targets import parse_targets as jparse_targets
from jn_cuclark_tpu.parallel import mesh as jmesh
from jn_cuclark_tpu_torch import params
from jn_cuclark_tpu_torch.engine import BatchPlan, Classifier, flat_queries
from jn_cuclark_tpu_torch.io import dbformat
from jn_cuclark_tpu_torch.io.fasta import parse_reads
from jn_cuclark_tpu_torch.parallel.mesh import make_mesh2d

from .test_torch_cluster import HTSIZE, K, _workers, world  # noqa: F401

JPLAN = dict(max_queries=1024, max_reads=64)
MAX_QUERIES = 700  # the port's batches: several a file, so several reduces
# tag: (mesh shape, owners, mesh_mode, the blocks each rank holds)
RUNS = {
    "one block a rank": ([2], None, "db", [1, 1]),
    "two blocks a rank": ([4], None, "db", [2, 2]),
    "mesh_mode dp": ([2], None, "dp", [1, 1]),
    "2d across processes": ([1, 2], None, "db", [1, 0]),
    "pad keys alone": ([4], [0, 0, 0, 1], "db", [3, 1]),
}


def _tag(name):
    return name.replace(" ", "_") + "_"


def _jax_csv(jclf, tmp, name, reads, mate, extended):
    out = str(tmp / f"jax_{name}")
    jclf.classify_file(reads, out, paired_path=mate, extended=extended)
    with open(out + ".csv", "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def flat_world(world, tmp_path_factory):
    """The cluster tests' DB and samples; the JAX package's one-process
    flat CSVs of each input, on the DB and on an index of 3 of its keys;
    then one spawn of two processes that run every process mesh of RUNS."""
    tmp, _ = world
    out = tmp_path_factory.mktemp("flat_mesh")
    inputs = [("plain", str(tmp / "sample.fa"), None, False),
              ("extended", str(tmp / "sample.fa"), None, True),
              ("paired", str(tmp / "r1.fq"), str(tmp / "r2.fq"), False)]
    db, targets = str(tmp / "db" / "sub"), str(tmp / "db" / "targets.txt")
    jprof = jparams.tiny(htsize=HTSIZE, k=K)
    jclf = JClassifier.load(db, targets, jprof, K, packed=False,
                            plan=JBatchPlan(**JPLAN))
    want = {name: _jax_csv(jclf, out, name, *rest)
            for name, *rest in inputs}
    # 3 keys, one of each target's
    prof = params.tiny(htsize=HTSIZE, k=K)
    keys, labels = dbformat.read_db(
        os.path.join(db, prof.db_stem(K, 3, 0, prof.default_gap)), prof, K, 1)
    pick = [int(ix[len(ix) // 2])
            for ix in (np.flatnonzero(labels == t) for t in range(3))]
    np.savez(out / "keys3.npz", keys=keys[pick], labels=labels[pick])
    jclf3 = JClassifier(jprof, K, jparse_targets(targets).target_names,
                        keys[pick], labels[pick], packed=False,
                        plan=JBatchPlan(**JPLAN))
    want["keys3"] = _jax_csv(jclf3, out, "keys3", *inputs[0][1:])
    runs = [dict(tag=_tag(name), mesh=shape, owners=owners, mode=mode,
                 max_queries=MAX_QUERIES, refuse=name == "two blocks a rank")
            for name, (shape, owners, mode, _) in RUNS.items()]
    runs[-1].update(keys=str(out / "keys3.npz"), n_inputs=1)
    res = _workers(tmp, dict(db=db, targets=targets, htsize=HTSIZE, k=K,
                             out=str(out), inputs=inputs, flat=runs))
    return out, want, res, inputs


@pytest.mark.parametrize("name", list(RUNS))
def test_flat_process_mesh_equals_jax(flat_world, name):
    """Both ranks' CSVs equal the JAX package's one-process flat CSV, and
    each rank holds only its own blocks: on a one-axis mesh of equal
    shares half the padded index each, every block once in the world;
    each block a copy of its own keys and labels (no view of the whole)."""
    out, want, res, inputs = flat_world
    tag = _tag(name)
    wants = ({"plain": want["keys3"]} if name == "pad keys alone"
             else {n: want[n] for n, *_ in inputs})
    for rank in range(2):
        for n, w in wants.items():
            got = (out / f"{tag}{n}_r{rank}.csv").read_bytes()
            assert got == w, (name, n, rank)
    held = [r["flat"][tag] for r in res]
    assert [h["blocks"] for h in held] == RUNS[name][3]
    assert all(h["storage"] == h["bytes"] for h in held)
    n_blocks = sum(h["blocks"] for h in held)
    if name == "pad keys alone":
        # 3 keys padded to 4: 12 B a key, rank 1's block the pad key alone
        assert [h["bytes"] for h in held] == [36, 12]
        rows = want["keys3"].splitlines()[1:]
        assert len(rows) == 40 and b",NA," in want["keys3"]
        assert any(b",NA," not in row for row in rows)  # some hit
    else:
        whole = sum(h["bytes"] for h in held)
        assert whole % (12 * n_blocks) == 0
        per = whole // n_blocks
        assert [h["bytes"] for h in held] == [per * b for b in RUNS[name][3]]


def test_flat_process_mesh_one_reduce_a_batch(flat_world):
    """A batch is one all_reduce of int32 labels on every process: as many
    as the batches (several a file), 4 B for each counted window."""
    out, want, res, inputs = flat_world
    with open(inputs[0][1], "rb") as f:
        windows = len(flat_queries(parse_reads(f.read()), K)[0])
    for r in res:
        for tag, rec in r["flat"].items():
            for name, ph in rec["phases"].items():
                calls = ph["calls"]
                assert calls["all_reduce"] == calls["dispatch"] > 1, (
                    tag, name)
                if name != "paired":
                    assert ph["bytes"]["all_reduce"] == 4 * windows
    for tag, rec in res[0]["flat"].items():  # the same calls on both ranks
        assert rec["phases"] == res[1]["flat"][tag]["phases"]


def test_flat_process_mesh_one_call_at_a_time(flat_world):
    """A flat process-mesh Classifier refuses classify_files(jobs=2) and a
    second call while one holds it; the held call's rows are the JAX
    package's CSV."""
    out, want, res, _ = flat_world
    tag = _tag("two blocks a rank")
    for rank in range(2):
        assert res[rank]["flat"][tag]["refused"] == ["jobs=2",
                                                     "a second call"]
        body = (out / f"{tag}rows_r{rank}").read_bytes()
        assert want["plain"].endswith(body) and body.count(b"\n") == 40


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_flat_two_axis_mesh_equals_jax(world, tmp_path, shape):
    """In one process, the flat path on a two-axis mesh of CPU devices
    writes the JAX package's CSVs on its two-axis mesh of the same shape
    (8 virtual devices), plain and extended: the index in blocks over the
    first axis, the second only repeating them."""
    tmp, _ = world
    reads, targets = str(tmp / "sample.fa"), str(tmp / "db" / "targets.txt")
    for side in ("jax", "torch"):
        shutil.copytree(tmp / "db", tmp_path / side)
    jclf = JClassifier.load(str(tmp_path / "jax" / "sub"), targets,
                            jparams.tiny(htsize=HTSIZE, k=K), K,
                            packed=False, plan=JBatchPlan(**JPLAN),
                            mesh=jmesh.make_mesh2d(*shape))
    clf = Classifier.load(str(tmp_path / "torch" / "sub"), targets,
                          params.tiny(htsize=HTSIZE, k=K), K, packed=False,
                          device="cpu", plan=BatchPlan(max_queries=MAX_QUERIES),
                          mesh=make_mesh2d(*shape, device="cpu"))
    assert len(clf.index) == shape[0]
    assert not clf.mesh.collective and clf._one_call is None
    for extended in (False, True):
        got, w = (_jax_csv(c, tmp_path, f"{side}_{extended}", reads, None,
                           extended)
                  for side, c in (("torch", clf), ("jax", jclf)))
        assert got == w and got.count(b"\n") == 41
