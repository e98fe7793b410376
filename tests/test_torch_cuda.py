"""The port's hand-written CUDA kernels on the card: each against its
plain-PyTorch twin on the same inputs (exact equality), and the goldens
classified through them.  The cases are chip_smoke.py's phases 2 and 3.

Marked `cuda`: every test skips where torch.cuda.is_available() is false.
On a GPU machine without jax (which tests/conftest.py imports), run
`python -m pytest --noconftest tests/test_torch_cuda.py`."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import chip_smoke
from jn_cuclark_tpu_torch import engine
from jn_cuclark_tpu_torch.engine import Classifier
from jn_cuclark_tpu_torch.io import dbformat
from jn_cuclark_tpu_torch.ops import kernels, lookup, radix_table, score
from jn_cuclark_tpu_torch.params import Profile
from jn_cuclark_tpu_torch.utils import native, profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def test_kernels_equal_their_twins(dev):
    kernels.reset_launches()
    # + 2: the two kshift = 1 tables (big_tables), each probed twice;
    # + 13 + 1 + 9: K9's cases (each searched for its queries and for its
    # stored keys) and its 48M-key index, K5's flat form's cases; + 6:
    # K5's small form started from a prior
    assert chip_smoke.check_kernels(dev) == (
        21 + 10 + 45 + 12 + 12 + 13 + 29 + 9 + 2 + 13 + 1 + 9 + 6)
    assert kernels.LAUNCHES == {"window_canonicals": 24, "probe": 10 + 2,
                                "top2": 45, "sort_top2": 12,
                                "counts_top2": 12 + 6,
                                "aggregate": 13, "probe_chunk": 29,
                                "probe_dense": 18 + 2, "lookup": 13 * 2 + 1,
                                "counts_flat": 9, "top2 small": 13,
                                "top2 hash": 15, "top2 block": 17}


def test_goldens_through_the_kernels(dev, tmp_path):
    assert chip_smoke.check_goldens(dev, str(tmp_path)) == 6
    assert chip_smoke.check_golden_dbs(dev, str(tmp_path)) == 3


def test_dense_targets_through_the_counts_kernel(dev, tmp_path):
    launches = chip_smoke.check_dense_targets(dev, str(tmp_path))
    assert launches["counts_top2"] > 0 and launches["sort_top2"] == 0


def test_new_wrappers_reject_bad_input(dev):
    kernels.reset_launches()
    lab = torch.ones((2, 3), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        kernels.sort_top2(lab.to(torch.int64))
    with pytest.raises(ValueError):
        kernels.counts_top2(lab, 0)
    prior = torch.zeros((2, 4097), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # K5's large form takes no prior
        kernels.counts_top2(lab, 4096, prior)
    with pytest.raises(ValueError):  # a prior of another shape
        kernels.counts_top2(lab, 4, prior[:, :4])
    with pytest.raises(TypeError):
        kernels.counts_top2(lab, 4096 - 1, prior[:, :4096].long())
    canon = torch.zeros(4, dtype=torch.int64, device=dev)
    label = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # label of another length
        kernels.aggregate(canon, label[:3], label[:1], True)
    with pytest.raises(TypeError):  # int32 keys
        kernels.aggregate(label, label, label[:1], True)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_chunk_and_dense_wrappers_reject_bad_input(dev):
    kernels.reset_launches()
    slots = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    sk = torch.full((64,), -1, dtype=torch.int64, device=dev)
    sl = torch.zeros(64, dtype=torch.int32, device=dev)
    q = torch.zeros(5, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):  # a start at 2^62 (a start past the
        # table, as a db shard's chunk may have, probes as misses: below)
        kernels.probe_chunk(slots, sk, sl, q, 1 << 62, 3, 2, True)
    with pytest.raises(ValueError):  # a stash of the wrong size
        kernels.probe_chunk(slots, sk[:3], sl[:3], q, 0, 3, 2, True)
    with pytest.raises(ValueError):  # plane 1 of 4 rows is not 2^3
        kernels.probe_dense(slots, slots, sk, sl, q, 3, 2, 1)
    with pytest.raises(TypeError):
        kernels.probe_dense(slots, slots, sk, sl, q.int(), 2, 2, 1)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    assert kernels.probe_chunk(slots, sk, sl, q, 4, 3, 2, False).tolist() == [0] * 5
    assert kernels.probe_chunk(slots, sk, sl, q, 8, 3, 2, True).tolist() == [0] * 5
    assert kernels.LAUNCHES["probe_chunk"] == 2


def test_flat_wrappers_reject_bad_input(dev):
    """K9's and K5's flat form's wrappers refuse what their kernels do not
    take, launching nothing; an empty index or batch launches and gives
    misses or zero rows."""
    kernels.reset_launches()
    keys = torch.arange(10, dtype=torch.int64, device=dev)
    labels1 = torch.ones(10, dtype=torch.int32, device=dev)
    q = torch.arange(5, dtype=torch.int64, device=dev)
    index = lookup.build_index(keys, labels1)
    with pytest.raises(ValueError):  # labels of another length
        kernels.lookup(index._replace(labels1=labels1[:9]), q)
    with pytest.raises(TypeError):  # int32 queries
        kernels.lookup(index, q.int())
    with pytest.raises(ValueError):  # keys on the CPU
        kernels.lookup(index._replace(keys=keys.cpu()), q)
    with pytest.raises(ValueError):  # offsets of no 2^bits + 1
        kernels.lookup(index._replace(offsets=index.offsets[[0, 1, 2, 2]]), q)
    with pytest.raises(ValueError):  # too few buckets for the key range
        kernels.lookup(index._replace(offsets=index.offsets[:2]), q)
    lab, rid = q.int(), torch.zeros(5, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        kernels.counts_flat(lab, rid[:4], 1, 16)
    with pytest.raises(ValueError):
        kernels.counts_flat(lab, rid, 1, 0)
    with pytest.raises(TypeError):
        kernels.counts_flat(lab.long(), rid, 1, 16)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    empty = lookup.build_index(keys[:0], labels1[:0])
    assert kernels.lookup(empty, q).tolist() == [0] * 5
    counts, total, *_ = kernels.counts_flat(lab[:0], rid[:0], 3, 4)
    assert counts.tolist() == [[0] * 5] * 3 and total.tolist() == [0] * 3
    assert kernels.LAUNCHES["lookup"] == kernels.LAUNCHES["counts_flat"] == 1


def test_host_paths_on_the_card(dev, tmp_path):
    """chip_smoke.py's phase 8 at a small scale on the card (3 genomes x
    16,000 bp, 1,500 reads): every flat path's CSV byte-equal to the
    native resident run's (the golden CSVs in a world of one), each
    launched K9 and K5's flat form (on process meshes: K9 a block, two
    blocks a rank over gloo), and a trace kept every kernel of a burst,
    and both `classify --trace-dir` sessions, in sessions the check
    found whole (taken again where it did not)."""
    chip_smoke.check_goldens(dev, str(tmp_path))
    scale = tmp_path / "scale"
    scale.mkdir()
    prof = Profile(name="t", htsize=1048573, light=False, default_k=31)
    _, launches, clf, _, _ = chip_smoke.run_scale(dev, str(scale), 3, 16_000,
                                                  1500, n_pairs=300, prof=prof)
    chip_smoke.run_tools(dev, str(tmp_path), clf, str(scale), 3, prof,
                         launches, n_c3=600, c4_samples=2, n_c4=200)
    flat, _ = chip_smoke._load(dev, str(scale), prof, packed=False)
    host = chip_smoke.run_host_paths(dev, str(scale), prof, flat, launches,
                                     str(tmp_path / "tools"),
                                     str(tmp_path / "golden0"), mesh_n=2,
                                     sub=700)
    assert all(host["host trace"]["kernels_named"].values())
    burst = host["host trace"]["burst"]
    assert burst["trace_kept"] == burst["launched"] == chip_smoke.TRACE_BURST
    assert burst["trace_retakes"] <= chip_smoke.TRACE_RETAKES
    for key in ("check", "check_in_process"):
        assert host["host trace"][key]["whole"], key
        assert host["host trace"][key]["launched"] > 0, key
    assert max(host["host trace"]["retakes"], host["host trace"][
        "retakes_in_process"]) <= chip_smoke.TRACE_RETAKES
    for path, need in chip_smoke.PATH_KERNELS.items():
        if path.startswith("host"):
            assert all(launches[path][n] > 0 for n in need), path
    assert launches["host flat"]["lookup"] == launches["host flat"][
        "counts_flat"] >= 1
    assert launches["host flat mesh"]["lookup"] == 2 * launches[
        "host flat mesh"]["counts_flat"]
    for path in ("host flat processes", "host flat processes extended"):
        assert launches[path]["lookup"] == 2 * launches[path][
            "counts_flat"] > 0
    assert launches["host flat one process"]["lookup"] == launches[
        "host flat one process"]["counts_flat"] > 0
    assert host["host flat processes"]["backend"] == "gloo"
    assert host["host flat one process"]["backend"] == "nccl"


def test_wrapper_rejects_bad_input(dev):
    kernels.reset_launches()
    with pytest.raises(TypeError):
        kernels.top2(torch.ones((2, 3), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):
        kernels.top2(torch.ones((3, 2), dtype=torch.int32, device=dev).t())
    with pytest.raises(ValueError):
        kernels.top2(torch.ones((2, 3), dtype=torch.int32))  # on the CPU
    lab = torch.ones((2, 3), dtype=torch.int32, device=dev)
    for n_targets in (0, -3, (1 << 31) - 1):
        with pytest.raises(ValueError):
            kernels.top2(lab, n_targets)
    with pytest.raises(ValueError):  # the small form needs T
        kernels.top2(lab, form="small")
    with pytest.raises(ValueError):  # past the hash form's tile
        kernels.top2(torch.ones((2, kernels.K3_TILE_W + 1), dtype=torch.int32,
                                device=dev), 70_000, form="hash")
    with pytest.raises(ValueError):
        kernels.top2(lab, 4, form="sort")
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    score.top2_from_labels(lab)
    assert kernels.LAUNCHES["top2"] == kernels.LAUNCHES["top2 hash"] == 1


@pytest.mark.parametrize("n_targets, w, form", [
    (16, 224, "small"), (4095, 224, "small"), (4096, 224, "hash"),
    (None, 672, "hash"), (65535, 4096, "hash"), (65535, 4097, "block"),
    (None, 100_000, "block"), (16, 100_000, "small"),
])
def test_top2_takes_its_form_on_the_card(dev, n_targets, w, form):
    """K3 launches the form top2_form names for the shape (the main path's
    16 targets: small; 65,535 targets: hash; past the tile: block), and
    every form gives its twin's scalars."""
    top = 1 << 17 if n_targets is None else n_targets
    rng = np.random.default_rng(w)
    lab = torch.from_numpy(rng.integers(0, top + 1, size=(37, w)).astype(
        np.int32)).to(dev)
    lab[::3] = lab[::3, :1]  # rows of one label
    kernels.reset_launches()
    got = score.top2_from_labels(lab, n_targets)
    assert kernels.LAUNCHES["top2"] == kernels.LAUNCHES[f"top2 {form}"] == 1
    want = score.top2_from_labels_plain(lab)
    for g, x in zip(got, want):
        assert torch.equal(g, x)


def _cycled_inputs(tmp_path):
    """(Classifier.load's first arguments, FASTA reads) of a random DB of
    8 targets at k = 21: a quarter of the 2,000 reads random, the others
    from its genome."""
    k, T = 21, 8
    rng = np.random.default_rng(9)
    genome = chip_smoke.ACGT[rng.integers(0, 4, size=40_000)].tobytes()
    keys = np.unique(native.extract_canonical(b">g\n" + genome + b"\n", k,
                                              False, 1))
    labels = rng.integers(0, T, size=len(keys)).astype(np.uint16)
    prof = Profile(name="cyc", htsize=65521, light=False, default_k=k)
    dbformat.write_db(str(tmp_path / prof.db_stem(k, T, 0)), prof, k, keys,
                      labels)
    (tmp_path / "targets.txt").write_text(
        "".join(f"t{i}.fa {7000 + i}\n" for i in range(T)))
    recs = []
    for i in range(2000):
        ln = int(rng.integers(50, 250))
        p = int(rng.integers(0, len(genome) - ln))
        s = (genome[p : p + ln] if i % 4
             else chip_smoke.ACGT[rng.integers(0, 4, size=ln)].tobytes())
        recs.append(b">c%d\n%s\n" % (i, s))
    return (str(tmp_path), str(tmp_path / "targets.txt"), prof, k), \
        b"".join(recs)


def test_cycled_uploads_under_concurrent_calls(dev, tmp_path, monkeypatch):
    """Chunks stream through the two pinned staging slices (4 KiB here, so
    one chunk takes dozens of them) while two threads classify through one
    cycled Classifier: every call writes the resident run's bytes."""
    monkeypatch.setattr(engine, "STAGING_SLICE_BYTES", 4096)
    args, fa = _cycled_inputs(tmp_path)
    want = b"".join(Classifier.load(*args, device=dev).classify_bytes(fa)[0])
    clf = Classifier.load(*args, device=dev, db_cycles=3)
    assert clf.table_chunks[0]["slots"].nbytes > 16 * 4096
    with ThreadPoolExecutor(max_workers=2) as ex:
        got = list(ex.map(lambda _: b"".join(clf.classify_bytes(fa)[0]),
                          range(6)))
    assert got == [want] * 6


def test_chunk_upload_counts_the_chunks_bytes(dev, tmp_path):
    """Under a collector a cycled call records one `chunk_upload` a chunk,
    its `nbytes` the bytes of the chunks copied to the card."""
    args, fa = _cycled_inputs(tmp_path)
    clf = Classifier.load(*args, device=dev, db_cycles=3)
    with profiling.collect() as ph:
        b"".join(clf.classify_bytes(fa)[0])
    assert ph.counts["chunk_upload"] == 3
    assert ph.nbytes["chunk_upload"] == sum(
        c["slots"].nbytes for c in clf.table_chunks)


def test_grouped_probes_on_hot_rows(dev):
    """K2 and K8 against their twins where one row carries 20,000 queries
    and every query of a second call lies on one row; each call counts one
    launch whatever its passes."""
    rng = np.random.default_rng(11)
    keys = np.unique(rng.integers(0, (1 << 64) - 2, size=60_000,
                                  dtype=np.uint64))
    labels1 = rng.integers(1, 31, size=len(keys)).astype(np.int32)
    table = radix_table.to_device(radix_table.build(keys, labels1, c=128), dev)
    dense = radix_table.to_device(
        radix_table.build_dense(keys, labels1, c=128), dev)
    hot = chip_smoke.hot_row_queries(rng, keys, table.m1, 20_000)
    for q in (np.concatenate([keys, hot]), hot[:3000]):
        q = torch.from_numpy(q.view(np.int64)).to(dev)
        kernels.reset_launches()
        got = radix_table.probe(table, q)
        got_dense = radix_table.probe_dense(dense, q)
        assert kernels.LAUNCHES["probe"] == kernels.LAUNCHES["probe_dense"] == 1
        assert torch.equal(got, radix_table.probe_plain(
            table.slots, table.stash_keys, table.stash_labels, q,
            m1=table.m1, lb=table.lb))
        assert torch.equal(got_dense, radix_table.probe_dense_plain(
            dense.slots1, dense.slots2, dense.stash_keys, dense.stash_labels,
            q, m1=dense.m1, m2=dense.m2, lb=dense.lb))
    assert torch.equal(radix_table.probe(
        table, torch.from_numpy(keys.view(np.int64)).to(dev)).cpu(),
        torch.from_numpy(labels1))


# A rank of a world on the card: each rank holds the labels of every
# n-th window of a config-2 batch (32,768 x 224 int32, the rest 0), as a
# db shard does; after the all-reduce every rank holds every label.
REDUCE = """\
import os
import sys
import torch
from jn_cuclark_tpu_torch.parallel import dist
from jn_cuclark_tpu_torch.parallel.mesh import process_devices

dist.initialize(device="cuda")
rank, n = dist.process_index(), dist.process_count()
idx = torch.arange(32768 * 224, device="cuda")
want = (idx % 65535 + 1).to(torch.int32)
lab = torch.where(idx % n == rank, want, 0).to(torch.int32)
dist.all_reduce_sum_(lab)
ok = lab.is_cuda and lab.dtype == torch.int32 and torch.equal(lab, want)
# under torchrun the process drives cuda:LOCAL_RANK, and only that card
card = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
ok = ok and torch.cuda.current_device() == card.index and (
    "LOCAL_RANK" not in os.environ or process_devices(None) == [card])
dist.shutdown()
sys.exit(0 if ok else 1)
"""


def _reduce_world(tmp_path, n, env_of):
    """REDUCE in n processes, rank r with the variables env_of(r, port)."""
    import os
    import socket
    import subprocess
    import sys

    script = tmp_path / "reduce.py"
    script.write_text(REDUCE)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("CLARK_TPU_") and k not in (
                "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")}
    procs = []
    for rank in range(n):
        env = dict(base, PYTHONPATH=root, GLOO_SOCKET_IFNAME="lo",
                   **env_of(rank, port))
        procs.append(subprocess.Popen([sys.executable, str(script)], env=env,
                                      stderr=subprocess.PIPE, text=True))
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0] * n, errs


@pytest.mark.parametrize("backend, n", [("gloo", 2), ("nccl", 1)])
def test_labels_all_reduce_on_the_card(dev, tmp_path, backend, n):
    """The db shards' label sum across processes: gloo with two ranks on
    one card (CUDA tensors staged through the host), NCCL in a world of
    one; every rank ends with every label."""
    _reduce_world(tmp_path, n, lambda rank, port: dict(
        CLARK_TPU_DIST_BACKEND=backend, CLARK_TPU_NUM_PROCESSES=str(n),
        CLARK_TPU_PROCESS_ID=str(rank),
        CLARK_TPU_COORDINATOR=f"127.0.0.1:{port}"))


def test_torchrun_world_on_the_card(dev, tmp_path):
    """A world formed from torchrun's variables, one process a card over
    NCCL: each drives cuda:LOCAL_RANK alone and ends with every label."""
    n = torch.cuda.device_count()
    _reduce_world(tmp_path, n, lambda rank, port: dict(
        WORLD_SIZE=str(n), RANK=str(rank), LOCAL_RANK=str(rank),
        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)))
