"""The dense two-plane table in the PyTorch port against the JAX package, on
the CPU: build_dense, dense_nbytes, recover_keys, the dense cache shared by
both packages, the dense probe (twin of kernel K8), classify_batch_dense,
the dense-or-cycle policy, and dense CSVs byte-equal to the port's resident
run and to the JAX package's dense run, all exact; the dense probe also on
forged hi collisions in both planes and on a hot row."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from jn_cuclark_tpu import params as jparams
from jn_cuclark_tpu.db import builder
from jn_cuclark_tpu.engine import BatchPlan as JBatchPlan
from jn_cuclark_tpu.engine import Classifier as JClassifier
from jn_cuclark_tpu.io.targets import parse_targets as jparse_targets
from jn_cuclark_tpu.ops import device_pipeline as jdp
from jn_cuclark_tpu.ops import radix_table as jrt
from jn_cuclark_tpu_torch.engine import BatchPlan, Classifier
from jn_cuclark_tpu_torch.ops import device_pipeline, radix_table
from jn_cuclark_tpu_torch.utils import memory, native

K = 9
# (n keys, key bits, max label+1, c): wide and narrow rows, k = 27 and
# k = 32 keys (bit 63 set), 17 label bits, and narrow rows crowded enough
# that plane 2 overflows into the stash.  PLANE2 cases fill plane 1 to a
# load near 0.9, so some keys live in plane 2.
CASES = {
    "n500 c16": (500, 54, 200, 16),
    "n29000 c16 k32": (29_000, 64, 200, 16),
    "n58000 c128": (58_000, 54, 200, 128),
    "lb17 k32": (50_000, 64, 65535, 16),
    "stash": (40_000, 54, 50, 2),
}
PLANE2 = ("n29000 c16 k32", "n58000 c128", "stash")


def _keys(case):
    n, kbits, maxlab, c = CASES[case]
    rng = np.random.default_rng(n + kbits)
    keys = np.unique(rng.integers(0, (1 << kbits) - 2, size=2 * n,
                                  dtype=np.uint64))[:n]
    labels1 = rng.integers(1, maxlab + 1, size=len(keys)).astype(np.int32)
    return rng, keys, labels1, c


@pytest.fixture(scope="module", params=sorted(CASES))
def built(request):
    rng, keys, labels1, c = _keys(request.param)
    return (request.param, rng, keys, labels1,
            jrt.build_dense(keys, labels1, c=c),
            radix_table.build_dense(keys, labels1, c=c))


def test_build_dense_equals_jax(built):
    case, _, keys, _, want, got = built
    assert got.meta == want.meta
    for name in ("slots1", "slots2", "stash_keys", "stash_labels"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert got.nbytes == want.nbytes
    n, _, maxlab, c = CASES[case]
    assert radix_table.dense_nbytes(len(keys), maxlab, c=c) == (
        jrt.dense_nbytes(len(keys), maxlab, c=c))
    if c >= 16:  # the prediction is an upper bound at real row widths
        assert got.nbytes <= radix_table.dense_nbytes(len(keys), maxlab, c=c)
    if case == "stash":
        assert (got.stash_keys != radix_table.EMPTY).any()


def test_probe_dense_plain_equals_jax(built):
    """Stored keys (in plane 1, plane 2 and the stash), misses, EMPTY."""
    case, rng, keys, labels1, want, got = built
    miss = rng.integers(0, (1 << 64) - 2, size=4000, dtype=np.uint64)
    q = np.concatenate([keys, miss, np.full(16, jrt.EMPTY, np.uint64)])
    q = q[rng.permutation(len(q))]
    ref = np.asarray(jrt.probe_dense(
        jnp.asarray(want.slots1), jnp.asarray(want.slots2),
        jnp.asarray(want.stash_keys), jnp.asarray(want.stash_labels),
        jnp.asarray(q), **want.meta,
    ))
    tbl = radix_table.to_device(got, "cpu")
    assert isinstance(tbl, radix_table.DeviceDenseTable)
    lab = radix_table.probe_dense(tbl, torch.from_numpy(q.view(np.int64)))
    assert lab.dtype == torch.int32
    assert np.array_equal(lab.numpy(), ref)
    assert np.array_equal(radix_table.probe_dense(
        tbl, torch.from_numpy(keys.view(np.int64))).numpy(), labels1)
    if case not in PLANE2:
        return
    # keys live in plane 2 (and, for "stash", in the stash) too
    in_plane1 = radix_table.probe_plain(
        tbl.slots1, torch.zeros_like(tbl.stash_keys) - 1,
        torch.zeros_like(tbl.stash_labels),
        torch.from_numpy(keys.view(np.int64)), m1=got.m1, lb=got.lb).numpy()
    assert (in_plane1 == 0).any()


@pytest.mark.parametrize("kbits", [54, 64])  # k = 27 and k = 32 keys
def test_probe_dense_plain_hi_collisions_and_hot_rows_equal_jax(kbits):
    """Slots forged in both planes whose hi half equals a missing query's
    t_hi (a miss only the lo word tells apart: K8 reads lo words only
    behind a matching hi word), and one plane-1 row carrying 5,000
    queries (K8 reads a row once for all of its queries)."""
    rng = np.random.default_rng(kbits + 1)
    keys = np.unique(rng.integers(0, (1 << kbits) - 2, size=60_000,
                                  dtype=np.uint64))[:29_000]
    labels1 = rng.integers(1, 201, size=len(keys)).astype(np.int32)
    table = jrt.build_dense(keys, labels1, c=16)
    miss = rng.integers(0, (1 << 64) - 2, size=4000, dtype=np.uint64)
    assert chip_smoke.forge_hi_collisions(table, miss[:2000], plane=1) > 500
    assert chip_smoke.forge_hi_collisions(table, miss[2000:], plane=2) > 500
    hot = chip_smoke.hot_row_queries(rng, keys, table.m1, 5000)
    q = np.concatenate([keys, miss, hot])
    want = np.asarray(jrt.probe_dense(
        jnp.asarray(table.slots1), jnp.asarray(table.slots2),
        jnp.asarray(table.stash_keys), jnp.asarray(table.stash_labels),
        jnp.asarray(q), **table.meta))
    lab = radix_table.probe_dense(radix_table.to_device(table, "cpu"),
                                  torch.from_numpy(q.view(np.int64)))
    assert np.array_equal(lab.numpy(), want)
    assert np.array_equal(want[: len(keys)], labels1)
    assert not want[len(keys) : len(keys) + len(miss)].any()


def test_recover_keys_equals_jax(built):
    case, _, keys, labels1, _, _ = built
    _, _, _, c = CASES[case]
    table = jrt.build(keys, labels1, c=c)
    rk, rl = radix_table.recover_keys(table)
    jk, jl = jrt.recover_keys(table)
    assert np.array_equal(rk, jk) and np.array_equal(rl, jl)
    assert radix_table.occupied_count(table.slots, c) == (
        jrt.occupied_count(table.slots, c))
    order, korder = np.argsort(rk), np.argsort(keys)
    assert np.array_equal(rk[order], keys[korder])
    assert np.array_equal(rl[order], labels1[korder])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_dense_cache_loads_in_the_other_package(tmp_path, writer):
    _, keys, labels1, c = _keys("stash")
    table = radix_table.build_dense(keys, labels1, c=c)
    sig = np.array([1, 2, 3], np.int64)
    path = str(tmp_path / "t.idx.npz.dense")
    save, load = ((jrt.save_dense_cache, radix_table.load_dense_cache)
                  if writer == "jax" else
                  (radix_table.save_dense_cache, jrt.load_dense_cache))
    save(path, table, signature=sig)
    back = load(path, signature=sig)
    assert back is not None and back.meta == table.meta
    for name in ("slots1", "slots2", "stash_keys", "stash_labels"):
        assert np.array_equal(getattr(back, name), getattr(table, name))
    assert load(path, signature=sig + 1) is None  # stale signature rebuilds


@pytest.mark.parametrize("extended", [False, "sorted", True])
@pytest.mark.parametrize("k", [27, 32])
def test_classify_batch_dense_equals_jax(k, extended):
    rng = np.random.default_rng(k)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 6000).tobytes()
    keys = np.unique(native.extract_canonical(b">g\n" + genome + b"\n", k,
                                              False, 1))
    labels1 = rng.integers(1, 40_000, size=len(keys)).astype(np.int32)
    table = jrt.build_dense(keys, labels1, c=4)
    reads = []
    for i in range(50):
        ln = int(rng.integers(20, 250))
        p = int(rng.integers(0, len(genome) - ln))
        reads.append(b">r%d\n%s\n" % (i, genome[p : p + ln] if i % 3 else
                                      rng.choice(np.frombuffer(
                                          b"ACGT", np.uint8), ln).tobytes()))
    data = b"".join(reads)
    _, _, _, ss, se, _ = native.scan_reads(data)
    words, vwords = native.pack_batch(data, ss, se, 256)
    want = jdp.classify_batch_dense(
        jnp.asarray(table.slots1), jnp.asarray(table.slots2),
        jnp.asarray(table.stash_keys), jnp.asarray(table.stash_labels),
        jnp.asarray(words), jnp.asarray(vwords), k=k, n_targets=40_000,
        extended=extended, probe_cols=224, **table.meta,
    )
    got = device_pipeline.classify_batch_dense(
        radix_table.to_device(table, "cpu"),
        torch.from_numpy(words.view(np.int64)),
        torch.from_numpy(vwords.view(np.int64)), k=k, n_targets=40_000,
        extended=extended, probe_cols=224,
    )
    for g, w in zip(got[:4], want[:4]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert (got[2].numpy() > 0).sum() > 20  # the genome reads hit
    extra = got[4].numpy()
    if extended == "sorted":
        extra = extra.view(np.uint16)
    assert np.array_equal(extra, np.asarray(want[4]))


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dense")
    rng = np.random.default_rng(29)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genomes = [rng.choice(acgt, size=1200).tobytes() for _ in range(3)]
    with open(tmp / "targets.txt", "w") as tf:
        for i, g in enumerate(genomes):
            p = tmp / f"g{i}.fa"
            p.write_bytes(b">g%d\n%s\n" % (i, g))
            tf.write(f"{p} {6000 + i}\n")
    prof = jparams.tiny(htsize=4093, k=K)
    builder.build_database(jparse_targets(str(tmp / "targets.txt")),
                           str(tmp), prof, K)
    reads = []
    for i in range(120):
        ln = int(rng.integers(20, 300))
        g = genomes[i % 3]
        p = int(rng.integers(0, len(g) - ln))
        s = g[p : p + ln] if i % 5 else rng.choice(acgt, size=ln).tobytes()
        reads.append(b">d%d\n%s\n" % (i, s))
    return tmp, prof, b"".join(reads)


PLAN = dict(max_reads=64, window_budget=1 << 12)


def _copy(db, tmp_path, name):
    d = tmp_path / name
    shutil.copytree(db[0], d)
    return (str(d), str(d / "targets.txt"), db[1], K)


@pytest.mark.parametrize("extended", [False, True])
def test_forced_dense_byte_equal(db, tmp_path, monkeypatch, extended):
    """CLARK_TPU_DENSE=force: CSV equal to the resident run's and to the
    JAX package's forced dense run, from the DB files and (second load)
    from the .idx cache through recover_keys, then from the dense cache."""
    fa = db[2]
    args = _copy(db, tmp_path, "t")
    plan = BatchPlan(**PLAN)
    want = b"".join(Classifier.load(*args, device="cpu", plan=plan)
                    .classify_bytes(fa, extended=extended)[0])
    monkeypatch.setenv("CLARK_TPU_DENSE", "force")
    seen = []
    orig = radix_table.recover_keys
    monkeypatch.setattr(radix_table, "recover_keys",
                        lambda t: seen.append(1) or orig(t))
    for attempt in ("idx cache", "dense cache"):
        clf = Classifier.load(*args, device="cpu", plan=plan)
        assert clf.dense_table is not None and clf.db_cycles == 1
        assert isinstance(clf.table, radix_table.DeviceDenseTable)
        got = b"".join(clf.classify_bytes(fa, extended=extended)[0])
        assert got == want, attempt
    assert seen == [1]  # the first dense load recovered the keys
    jclf = JClassifier.load(*_copy(db, tmp_path, "j"),
                            plan=JBatchPlan(**PLAN))
    assert jclf.dense_table is not None
    assert b"".join(jclf.classify_bytes(fa, extended=extended)[0]) == want


def test_forced_dense_wins_over_explicit_cycles(db, tmp_path, monkeypatch):
    fa = db[2]
    args = _copy(db, tmp_path, "t")
    want = b"".join(Classifier.load(*args, device="cpu", plan=BatchPlan(
        **PLAN)).classify_bytes(fa)[0])
    monkeypatch.setenv("CLARK_TPU_DENSE", "force")
    clf = Classifier.load(*args, device="cpu", db_cycles=3,
                          plan=BatchPlan(**PLAN))
    assert clf.db_cycles == 1 and clf.dense_table is not None
    assert b"".join(clf.classify_bytes(fa)[0]) == want


@pytest.mark.parametrize("budget,dense", [(128 << 20, True), (1 << 10, False)])
def test_auto_policy_dense_or_cycles(db, tmp_path, monkeypatch, capsys,
                                     budget, dense):
    """A table above the budget stays resident in the dense layout where
    that fits the budget and cycles where it does not, printing the JAX
    package's lines; the budget decision is faked (the 200 MB floor rules
    out a real one at this size), the wiring and the bytes are real."""
    fa = db[2]
    args = _copy(db, tmp_path, "t")
    want = b"".join(Classifier.load(*args, device="cpu", plan=BatchPlan(
        **PLAN)).classify_bytes(fa)[0])
    monkeypatch.setattr(memory, "auto_db_cycles",
                        lambda *a, **kw: (3, budget))
    clf = Classifier.load(*args, device="cpu", plan=BatchPlan(**PLAN))
    err = capsys.readouterr().err
    assert "loading in 3 cycles" in err
    assert ("dense two-choice" in err) == dense
    assert (clf.dense_table is not None) == dense
    assert clf.db_cycles == (1 if dense else 3)
    assert b"".join(clf.classify_bytes(fa)[0]) == want


@pytest.mark.parametrize("offset", [0, -1])
def test_dense_or_cycle_decision_equals_jax(db, tmp_path, monkeypatch,
                                           offset):
    """Both engines at a budget on each side of the dense layout's
    predicted bytes take the same residency, once each package's own
    transient is taken off: the JAX package adds its second plane's [Q, C]
    row gather to the dense bytes, the port (K8 reads in place) nothing."""
    import jn_cuclark_tpu.utils.memory as jmem

    fa = db[2]
    jargs, args = _copy(db, tmp_path, "j"), _copy(db, tmp_path, "t")
    probe = Classifier.load(*args, device="cpu", plan=BatchPlan(**PLAN))
    want = b"".join(probe.classify_bytes(fa)[0])
    n_keys = radix_table.occupied_count(
        radix_table.load_cache(args[0] + "/" + _idx(args[0])).slots, 16)
    predicted = radix_table.dense_nbytes(n_keys, 3, c=16)
    extra = jmem.probe_transient_bytes(PLAN["window_budget"], 16) - (
        PLAN["window_budget"] * 8 * 6)
    jbudget = predicted + extra + offset
    monkeypatch.setattr(jmem, "auto_db_cycles", lambda *a, **kw: (3, jbudget))
    monkeypatch.setattr(memory, "auto_db_cycles",
                        lambda *a, **kw: (3, jbudget - extra))
    jclf = JClassifier.load(*jargs, plan=JBatchPlan(**PLAN))
    clf = Classifier.load(*args, device="cpu", plan=BatchPlan(**PLAN))
    assert (clf.dense_table is not None) == (jclf.dense_table is not None)
    assert (clf.dense_table is not None) == (offset == 0)
    assert clf.db_cycles == jclf.db_cycles
    assert b"".join(clf.classify_bytes(fa)[0]) == want
    assert b"".join(jclf.classify_bytes(fa)[0]) == want


def _idx(folder):
    import os

    return next(n for n in os.listdir(folder) if n.endswith(".idx.npz"))
