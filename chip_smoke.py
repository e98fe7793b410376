#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (jn_cuclark_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printed with what it checked and its seconds; any failure
raises and exits non-zero before the result lines:

  0 device   a CUDA device of compute capability 9.0 (Hopper); prints the
             card's name and power limit (nvidia-smi) and torch/CUDA versions
  1 build    compiles the native host runtime (g++) and the two CUDA kernel
             libraries (nvcc, sm_90a), all at once, from the checkout's
             sources
  2 kernels  K1-K6 on the card against their plain-PyTorch twins on the
             same inputs, exact equality (integers; tolerance 0)
  3 goldens  classify the reference's golden reads on the card (single-end,
             --extended, paired): the six CSVs must be byte-equal to
             tests/golden; rebuild three golden DBs with device="cuda"
             (byte-equal to tests/golden/db); an extended classify against
             a synthetic DB of 65,535 targets (the dense-count path, K5)
             must equal the same run on the CPU
  4 scale    the main paths at the shape of bench.py config 2: 16 random
             genomes x 3 Mbp, full profile (k=31).  `db build` twice (the
             DB-build aggregate on the card, then on the host; the DBs must
             be byte-equal), then, each after a warm-up run: 400,000 reads
             of 100-250 bp (half drawn from the genomes, half random) plain
             and --extended, and 100,000 pairs of 125 + 125 bp mates 200 bp
             apart from genome 0.  Every genome read must be assigned its
             genome's taxid, every random read NA, every pair taxid 1000;
             the extended CSV less its 16 count columns must equal the
             plain one.  Kernel launch counts are reset just before each
             path (the device build, each timed classify, and phase 3's
             65,535-target run) and read after it
  5 timing   each kernel and its twin at the shapes of those paths

The last two lines are the kernels' JSON record and the run's contract
line {"ok": true, "device": {...}}.  With no CUDA device it exits 1 and
prints neither.  Smaller scales (--genomes/--genome-len/--reads) are for
rehearsal; the defaults are the measured configuration.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from jn_cuclark_tpu_torch import params
from jn_cuclark_tpu_torch.db import builder, device_build
from jn_cuclark_tpu_torch.engine import BatchPlan, Classifier
from jn_cuclark_tpu_torch.io import dbformat
from jn_cuclark_tpu_torch.io.targets import parse_targets
from jn_cuclark_tpu_torch.ops import (
    bits,
    device_pipeline,
    kernels,
    radix_table,
    score,
)
from jn_cuclark_tpu_torch.params import Profile
from jn_cuclark_tpu_torch.utils import native, profiling

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(ROOT, "tests", "golden")
_KDIR = "jn_cuclark_tpu_torch/ops/kernels/"
# (source, the JAX package's device function -- or its one Pallas kernel --
# that the kernel replaces)
KERNELS = {
    "window_canonicals": (_KDIR + "classify.cu",
                          "jn_cuclark_tpu/ops/device_pipeline.py:21"),
    "probe": (_KDIR + "classify.cu", "benchmarks/experiments.py:276"),
    "top2": (_KDIR + "classify.cu", "jn_cuclark_tpu/ops/score.py:41"),
    "sort_top2": (_KDIR + "classify.cu",
                  "jn_cuclark_tpu/ops/device_pipeline.py:155"),
    "counts_top2": (_KDIR + "classify.cu", "jn_cuclark_tpu/ops/score.py:17"),
    "aggregate": (_KDIR + "aggregate.cu",
                  "jn_cuclark_tpu/db/device_build.py:30"),
}
ACGT = np.frombuffer(b"ACGT", np.uint8)
U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _i64(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


# --------------------------------------------------------------- phase 2
# Inputs that reach the kernels' edge cases; tests/test_torch_cuda.py runs
# the same cases under pytest.
def k1_cases(seed: int = 0):
    """(label, (words, vwords, k, probe_cols)) on the CPU: reads with N
    characters, reads shorter than k, an all-T read (k = 32's all-ones
    window), the full width and probe_cols trims."""
    rng = np.random.default_rng(seed)
    seqs = [
        rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=rng.integers(1, 256),
                   p=[0.245, 0.245, 0.245, 0.245, 0.02]).tobytes()
        for _ in range(2000)
    ] + [b"ACG", b"T" * 200]
    data = b"".join(b">r%d\n%s\n" % (i, s) for i, s in enumerate(seqs))
    _, _, _, ss, se, _ = native.scan_reads(data)
    w, v = native.pack_batch(data, ss, se, 256)
    for k in (9, 27, 31, 32):
        for pc in (None, 96, 1):
            yield f"k={k} probe_cols={pc}", (_i64(w), _i64(v), k, pc)


def k2_cases(seed: int = 0):
    """(label, (RadixTable, q)) on the host: a forced stash (c=4 at load
    16), lb = 17 (65,535 labels), and an all-EMPTY stash (the row probe of
    benchmarks/experiments.py:exp_probe_pallas); queries are stored keys,
    random misses and EMPTY."""
    rng = np.random.default_rng(seed)
    for label, n, maxlab, kw in (
        ("forced stash", 20_000, 40, dict(c=4, load=16.0)),
        ("lb=17", 300_000, 65535, {}),
        ("empty stash", 50_000, 1000, {}),
    ):
        keys = np.unique(rng.integers(0, (1 << 64) - 2, size=n, dtype=np.uint64))
        labels1 = rng.integers(1, maxlab + 1, size=len(keys)).astype(np.int32)
        table = radix_table.build(keys, labels1, **kw)
        if label == "forced stash":
            assert (table.stash_keys != radix_table.EMPTY).any()
        if label == "empty stash":
            table.stash_keys[:] = radix_table.EMPTY
            table.stash_labels[:] = 0
        if label == "lb=17":
            assert table.lb == 17
        q = np.concatenate([
            keys, rng.integers(0, (1 << 64) - 2, size=20_000, dtype=np.uint64),
            np.full(64, radix_table.EMPTY, np.uint64),
        ])
        yield label, (table, _i64(q[rng.permutation(len(q))]))


def k3_cases(seed: int = 0):
    """(label, lab [R, W] int32) on the CPU: ties, all-zero rows, W = 1,
    one row of 100,000 windows, and labels spanning 17 bits."""
    rng = np.random.default_rng(seed)
    cases = {
        "ties": np.array([[3, 3, 5, 5, 7, 0], [2, 2, 9, 9, 9, 1],
                          [4, 0, 4, 6, 6, 6]], np.int32),
        "zero rows": np.zeros((5, 33), np.int32),
        "W=1": np.array([[0], [5], [65535]], np.int32),
        "100k-window row": rng.integers(0, 18, size=(1, 100_000)),
        "17-bit labels": rng.integers(0, 1 << 17, size=(256, 400)),
        "random": rng.integers(0, 6, size=(4096, 224)),
    }
    for label, lab in cases.items():
        yield label, torch.from_numpy(lab.astype(np.int32))


def k4_cases(seed: int = 0):
    """(label, lab [R, W] int32) on the CPU for the sorted label grid: ties,
    all-zero rows, W = 1, one row of 100,000 windows, labels up to 65,534
    (u16 values above int16's range)."""
    rng = np.random.default_rng(seed)
    cases = {
        "ties": np.array([[3, 3, 5, 5, 7, 0], [2, 2, 9, 9, 9, 1],
                          [4, 0, 4, 6, 6, 6]], np.int32),
        "zero rows": np.zeros((5, 33), np.int32),
        "W=1": np.array([[0], [5], [65534]], np.int32),
        "100k-window row": rng.integers(0, 18, size=(1, 100_000)),
        "labels up to 65,534": rng.integers(0, 65535, size=(256, 400)),
        "random": rng.integers(0, 17, size=(4096, 224)),
    }
    for label, lab in cases.items():
        yield label, torch.from_numpy(lab.astype(np.int32))


def k5_cases(seed: int = 0):
    """(label, lab [R, W] int32, T) on the CPU for the dense counts: ties,
    T = 16, 1,000 and 65,535 (small R there: a row is 256 KiB)."""
    rng = np.random.default_rng(seed)
    yield "ties T=9", torch.from_numpy(np.array(
        [[3, 3, 5, 5, 7, 0], [2, 2, 9, 9, 9, 1], [0, 0, 0, 0, 0, 0]],
        np.int32)), 9
    for T, R, W in ((16, 4096, 224), (1000, 1024, 300), (65535, 64, 500)):
        lab = rng.integers(0, T + 1, size=(R, W)).astype(np.int32)
        lab[::9] = 0
        yield f"T={T}", torch.from_numpy(lab), T


def occurrences(rng, k: int, n: int):
    """(canon u64, label i32, pg i32): n canonical k-mer occurrences drawn
    from n/4 distinct values (at k = 32 half of them with bit 63 set), plus
    one group of 300 occurrences of alternating labels (mult and count
    both cap); 5 labels, two in one prefix group."""
    top = (1 << (2 * k)) if k < 32 else (1 << 64) - 1
    uniq = rng.integers(0, top, size=max(n // 4, 1), dtype=np.uint64)
    if k == 32:
        uniq[: len(uniq) // 2] |= np.uint64(1 << 63)
    canon = np.concatenate([uniq[rng.integers(0, len(uniq), size=n)],
                            np.full(300, uniq[0], np.uint64)])
    label = rng.integers(0, 5, size=len(canon)).astype(np.int32)
    label[-300:] = np.arange(300) % 5
    return canon, label, np.array([0, 1, 2, 2, 3], np.int32)


def k6_cases(seed: int = 0):
    """(label, (canon, label, pg, lelement)) as CPU tensors for the build
    aggregate: k = 9, 27, 31, 32, lelement on and off, and a partition
    padded with the 2^64-1 sentinel at k = 32."""
    rng = np.random.default_rng(seed)
    for k in (9, 27, 31, 32):
        for lelement in (True, False):
            c, l, pg = occurrences(rng, k, 200_000)
            yield f"k={k} lelement={lelement}", (c, l, pg, lelement)
    c, l, pg = occurrences(rng, 32, 150_000)
    pad = (1 << 18) - len(c)
    yield "padded partition k=32", (
        np.concatenate([c, np.full(pad, U64_MAX, np.uint64)]),
        np.concatenate([l, np.zeros(pad, np.int32)]), pg, True)


def _agg_tensors(case, dev):
    c, l, pg, lelement = case
    return (_i64(c).to(dev), torch.from_numpy(l).to(dev),
            torch.from_numpy(pg).to(dev), lelement)


def check_kernels(dev) -> int:
    """Every phase-2 case through the kernels on `dev` against the plain
    twins on the same inputs; returns the number of cases."""
    n = 0
    for label, (w, v, k, pc) in k1_cases():
        w, v = w.to(dev), v.to(dev)
        got = device_pipeline.window_canonicals(w, v, k, pc)
        want = device_pipeline.window_canonicals_plain(w, v, k, pc)
        _same(f"K1 {label}", [got], [want])
        n += 1
    for label, (table, q) in k2_cases():
        tbl, q = radix_table.to_device(table, dev), q.to(dev)
        got = radix_table.probe(tbl, q)
        want = radix_table.probe_plain(tbl.slots, tbl.stash_keys,
                                       tbl.stash_labels, q, m1=tbl.m1, lb=tbl.lb)
        _same(f"K2 {label}", [got], [want])
        n += 1
    for label, lab in k3_cases():
        lab = lab.to(dev)
        _same(f"K3 {label}", score.top2_from_labels(lab),
              score.top2_from_labels_plain(lab))
        n += 1
    for label, lab in k4_cases():
        lab = lab.to(dev)
        _same(f"K4 {label}", score.sort_top2(lab), score.sort_top2_plain(lab))
        n += 1
    for label, lab, T in k5_cases():
        lab = lab.to(dev)
        R, W = lab.shape
        rid = torch.arange(R, device=dev).repeat_interleave(W)
        counts = score.counts_from_hits_plain(lab.view(-1), rid, R, T)
        _same(f"K5 {label}", score.counts_top2(lab, T),
              (counts,) + score.read_results_plain(counts))
        n += 1
    for label, case in k6_cases():
        args = _agg_tensors(case, dev)
        got = device_build._aggregate_device(*args)
        _same(f"K6 {label}", got, device_build.aggregate_device_plain(*args))
        if label.startswith("padded"):  # the pad is one trailing group
            assert got[0][-1].item() == bits.EMPTY, "K6 pad group"
        n += 1
    return n


def _same(what, got, want) -> float:
    """Exact equality of int tensors; returns the max absolute difference
    (0.0) for the record."""
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{what}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        if not torch.equal(g, w):
            bad = int((g != w).sum())
            raise AssertionError(f"{what}: {bad} of {g.numel()} values differ")
        if g.numel():
            err = max(err, (g.double() - w.double()).abs().max().item())
    return err


# --------------------------------------------------------------- phase 3
_G9 = Profile(name="g65521", htsize=65521, light=False, default_k=9)
GOLDENS = (
    # (db dir, gzipped, targets dir, profile, k, reads, mate, extended,
    #  golden csv)
    ("db/full_k9", False, "db/inputs", _G9, 9, "csv/reads.fa", None, False,
     "csv/fa.csv"),
    ("db/full_k9", False, "db/inputs", _G9, 9, "csv/reads.fq", None, False,
     "csv/fq.csv"),
    ("db/full_k9", False, "db/inputs", _G9, 9, "csv/reads.fa", None, True,
     "csv/ext.csv"),
    ("db/full_k9", False, "db/inputs", _G9, 9, "csv/p1.fq", "csv/p2.fq",
     False, "csv/paired.csv"),
    ("u32/full_k27", True, "u32/inputs",
     Profile(name="u32f", htsize=16777259, light=False, default_k=27), 27,
     "u32/inputs/reads.fa", None, False, "u32/full_k27.csv"),
    ("u32/light_k27", True, "u32/inputs",
     Profile(name="u32l", htsize=16777259, light=True, default_k=27,
             default_gap=4), 27,
     "u32/inputs/reads.fa", None, False, "u32/light_k27.csv"),
)
GOLDEN_DBS = (
    # (case, targets file, profile, k, min_count_target)
    ("full_k9", "targets.txt", _G9, 9, 0),
    ("light_k27", "targets.txt",
     Profile(name="g65521l", htsize=65521, light=True, default_k=27,
             default_gap=4), 27, 0),
    ("mint2_k9", "targets_rep.txt", _G9, 9, 2),
)


def _targets_copy(src: str, dst: str) -> str:
    """A targets file pointed at the inputs in tests/golden."""
    with open(src) as f, open(dst, "w") as g:
        for line in f:
            path, lbl = line.split()
            g.write(f"{os.path.join(os.path.dirname(src), os.path.basename(path))}"
                    f" {lbl}\n")
    return dst


def check_goldens(dev, tmp: str) -> int:
    """Classify the golden reads against tmp copies of the golden DBs (the
    index cache must not land in tests/golden); CSVs must be byte-equal."""
    for i, (db, gz, tdir, prof, k, reads, mate, ext, golden) in enumerate(
        GOLDENS
    ):
        work = os.path.join(tmp, f"golden{i}")
        os.makedirs(os.path.join(work, "db"))
        targets = _targets_copy(os.path.join(GOLD, tdir, "targets.txt"),
                                os.path.join(work, "targets.txt"))
        for name in os.listdir(os.path.join(GOLD, db)):
            src = os.path.join(GOLD, db, name)
            if gz:
                with gzip.open(src, "rb") as f, open(
                    os.path.join(work, "db", name[:-3]), "wb"
                ) as g:
                    g.write(f.read())
            else:
                shutil.copy(src, os.path.join(work, "db"))
        clf = Classifier.load(os.path.join(work, "db"), targets, prof, k,
                              device=dev)
        out = os.path.join(work, "res")
        clf.classify_file(os.path.join(GOLD, reads), out,
                          paired_path=mate and os.path.join(GOLD, mate),
                          extended=ext)
        with open(out + ".csv", "rb") as a, open(os.path.join(GOLD, golden), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{golden}: the CSV differs from the golden")
    return len(GOLDENS)


def check_golden_dbs(dev, tmp: str) -> int:
    """`build_database(..., device=dev)` from tests/golden/db/inputs into
    tmp; the .sz/.ky/.lb files must be byte-equal to the goldens."""
    inputs = os.path.join(GOLD, "db", "inputs")
    for case, tfile, prof, k, minc in GOLDEN_DBS:
        work = os.path.join(tmp, f"golden_db_{case}")
        os.makedirs(work)
        targets = parse_targets(_targets_copy(
            os.path.join(inputs, tfile), os.path.join(work, tfile)))
        builder.build_database(targets, work, prof, k, min_count_target=minc,
                               device=dev)
        for name in os.listdir(os.path.join(GOLD, "db", case)):
            with open(os.path.join(GOLD, "db", case, name), "rb") as a, open(
                os.path.join(work, name), "rb"
            ) as b:
                if a.read() != b.read():
                    raise AssertionError(f"db/{case}/{name} differs")
    return len(GOLDEN_DBS)


def check_dense_targets(dev, tmp: str, n_reads: int = 200, seed: int = 3):
    """Extended classify against a synthetic DB of 65,535 targets, which
    takes the dense [R, T+1] count path (K5); the CSV must equal the same
    run on the CPU.  Returns the kernel launches of the run on `dev`."""
    T, k = params.MTRGTS, 21
    rng = np.random.default_rng(seed)
    work = os.path.join(tmp, "dense")
    os.makedirs(work)
    genome = ACGT[rng.integers(0, 4, size=40_000)].tobytes()
    keys = np.unique(native.extract_canonical(b">g\n" + genome + b"\n", k,
                                              False, 1))
    labels = rng.integers(0, T, size=len(keys)).astype(np.uint16)
    labels[rng.random(len(keys)) < 0.5] = T - 1  # a majority target
    prof = Profile(name="dense", htsize=65521, light=False, default_k=k)
    dbformat.write_db(os.path.join(work, prof.db_stem(k, T, 0)), prof, k,
                      keys, labels)
    with open(os.path.join(work, "targets.txt"), "w") as f:
        f.writelines(f"t{i}.fa {90000 + i}\n" for i in range(T))
    lens = rng.integers(40, 300, size=n_reads)
    pos = rng.integers(0, len(genome) - 300, size=n_reads)
    with open(os.path.join(work, "reads.fa"), "wb") as f:
        for i in range(n_reads):
            s = genome[pos[i] : pos[i] + lens[i]]
            if i % 4 == 0:
                s = ACGT[rng.integers(0, 4, size=lens[i])].tobytes()
            f.write(b">d%d\n%s\n" % (i, s))
    csv, launches = {}, {}
    for d in (dev, torch.device("cpu")):
        clf = Classifier.load(work, os.path.join(work, "targets.txt"), prof,
                              k, device=d, plan=BatchPlan(max_reads=256))
        kernels.reset_launches()
        clf.classify_file(os.path.join(work, "reads.fa"),
                          os.path.join(work, d.type), extended=True)
        launches.setdefault("run", dict(kernels.LAUNCHES))
        with open(os.path.join(work, d.type + ".csv"), "rb") as f:
            csv[d.type] = f.read()
    if csv[dev.type] != csv["cpu"]:
        raise AssertionError("65,535-target extended CSV differs from the CPU's")
    rows = csv["cpu"].split(b"\n")[1:-1]
    won = sum(r.rsplit(b",", 4)[2] == b"%d" % (90000 + T - 1) for r in rows)
    if len(rows) != n_reads or won < n_reads // 2:  # the majority target
        raise AssertionError(f"65,535-target extended CSV: {len(rows)} rows, "
                             f"{won} assigned the majority target")
    return launches["run"]


# --------------------------------------------------------------- phase 4
def make_genomes(td: str, rng, n_genomes: int, glen: int):
    """Random genomes g{i}.fa (one sequence line each) and targets.txt
    labelling genome i with taxid 1000+i."""
    genomes = []
    with open(os.path.join(td, "targets.txt"), "w") as tf:
        for i in range(n_genomes):
            g = ACGT[rng.integers(0, 4, size=glen)]
            p = os.path.join(td, f"g{i}.fa")
            with open(p, "wb") as f:
                f.write(b">g%d\n%s\n" % (i, g.tobytes()))
            tf.write(f"{p} {1000 + i}\n")
            genomes.append(g)
    return genomes


def make_reads(rng, genomes, n_reads: int):
    """FASTA of n_reads reads of 100-250 bp, each drawn from genome
    i % len(genomes) or, with probability 1/2, random; returns
    (bytes, lengths, expected assignment per read)."""
    glen = len(genomes[0])
    lens = rng.integers(100, 251, size=n_reads)
    junk = rng.random(n_reads) < 0.5
    gid = np.arange(n_reads) % len(genomes)
    pos = rng.integers(0, glen - lens)
    offs = np.concatenate([[0], np.cumsum(lens)])
    rel = np.arange(offs[-1]) - np.repeat(offs[:-1], lens)
    seq = np.concatenate(genomes)[np.repeat(gid * glen + pos, lens) + rel]
    jmask = np.repeat(junk, lens)
    seq[jmask] = ACGT[rng.integers(0, 4, size=int(jmask.sum()))]
    seq = seq.tobytes()
    expect = [b"NA" if j else b"%d" % (1000 + g) for j, g in zip(junk, gid)]
    fa = b"".join(
        b">r%d_%s\n%s\n" % (i, b"junk" if junk[i] else b"g%d" % gid[i],
                            seq[offs[i] : offs[i + 1]])
        for i in range(n_reads)
    )
    return fa, lens, expect


def make_pairs(rng, genome, n_pairs: int):
    """R1/R2 FASTQ of n_pairs pairs of 125 bp mates 200 bp apart, drawn
    from `genome` (bench.py:361-367)."""
    pos = rng.integers(0, len(genome) - 500, size=n_pairs)
    q = b"I" * 125
    r1 = b"".join(b"@p%d/1\n%s\n+\n%s\n" % (i, genome[p : p + 125].tobytes(), q)
                  for i, p in enumerate(pos))
    r2 = b"".join(b"@p%d/2\n%s\n+\n%s\n" % (i, genome[p + 200 : p + 325].tobytes(), q)
                  for i, p in enumerate(pos))
    return r1, r2


HEADER = b"Object_ID,Gamma,Assignment,Score,Confidence"


def check_csv(path: str, expect) -> bytes:
    """Every row's assignment equals expect[i]; returns the CSV."""
    with open(path, "rb") as f:
        data = f.read()
    lines = data.split(b"\n")
    if lines[0] != HEADER:
        raise AssertionError(f"bad header {lines[0][:80]!r}")
    rows = lines[1:-1]
    if len(rows) != len(expect) or lines[-1] != b"":
        raise AssertionError(f"{len(rows)} rows for {len(expect)} reads")
    bad = [r for r, e in zip(rows, expect) if r.split(b",")[2] != e]
    if bad:
        raise AssertionError(f"{len(bad)} reads misassigned, e.g. {bad[0]!r}")
    return data


def drop_count_columns(ext: bytes, n_targets: int) -> bytes:
    """An extended CSV less its per-target count columns (fields 1..T)."""
    out = []
    for line in ext.split(b"\n"):
        if line:
            f = line.split(b",")
            line = b",".join([f[0]] + f[1 + n_targets:])
        out.append(line)
    return b"\n".join(out)


def _same_db(d1: str, d2: str, stem: str):
    for ext in (".sz", ".ky", ".lb"):
        a = np.fromfile(os.path.join(d1, stem + ext), np.uint8)
        b = np.fromfile(os.path.join(d2, stem + ext), np.uint8)
        if not np.array_equal(a, b):
            raise AssertionError(f"device- and host-built {ext} differ")


def _path(launches: dict, name: str, fn):
    """Run one main path with the launch counts reset just before it;
    record its counts under `name`; return (fn(), seconds)."""
    kernels.reset_launches()
    t = time.perf_counter()
    out = fn()
    seconds = time.perf_counter() - t
    launches[name] = dict(kernels.LAUNCHES)
    return out, seconds


def run_scale(dev, tmp: str, n_genomes: int, glen: int, n_reads: int,
              n_pairs: int = 100_000, prof: Profile = params.FULL,
              seed: int = 2):
    """Phase 4; returns (metrics, launch counts by path, classifier,
    reads, lens)."""
    k = prof.default_k
    rng = np.random.default_rng(seed)
    m, launches = {}, {}
    t = time.perf_counter()
    genomes = make_genomes(tmp, rng, n_genomes, glen)
    targets = parse_targets(os.path.join(tmp, "targets.txt"))
    m["setup_genomes_s"] = time.perf_counter() - t

    with profiling.collect() as ph:
        db, m["db_build_device_s"] = _path(
            launches, "db build",
            lambda: builder.build_database(targets, tmp, prof, k, device=dev))
    m["db_build_device_phase_s"] = dict(ph.totals)
    host_dir = os.path.join(tmp, "host_db")
    os.makedirs(host_dir)
    with profiling.collect() as ph:
        t = time.perf_counter()
        builder.build_database(targets, host_dir, prof, k)  # native aggregate
        m["db_build_host_s"] = time.perf_counter() - t
    m["db_build_host_phase_s"] = dict(ph.totals)
    _same_db(tmp, host_dir, prof.db_stem(k, n_genomes, 0, prof.default_gap))
    shutil.rmtree(host_dir)
    m["db_keys"], m["db_distinct_kmers"] = len(db.canonical), db.n_mother
    m["db_occurrences"] = n_genomes * (glen - k + 1)

    t = time.perf_counter()
    fa, lens, expect = make_reads(np.random.default_rng(seed + 1), genomes,
                                  n_reads)
    reads = os.path.join(tmp, "reads.fa")
    with open(reads, "wb") as f:
        f.write(fa)
    r1, r2 = make_pairs(np.random.default_rng(seed + 2), genomes[0], n_pairs)
    mates = os.path.join(tmp, "r1.fq"), os.path.join(tmp, "r2.fq")
    for path, data in zip(mates, (r1, r2)):
        with open(path, "wb") as f:
            f.write(data)
    m["setup_reads_s"] = time.perf_counter() - t

    t = time.perf_counter()
    clf = Classifier.load(tmp, os.path.join(tmp, "targets.txt"), prof, k,
                          device=dev)
    m["load_s"] = time.perf_counter() - t  # radix-table build + upload
    if dev.type == "cuda":  # the peak from here on includes the table
        torch.cuda.reset_peak_memory_stats(dev)
    m["table_device_bytes"] = clf.table.nbytes
    m["table_m1"], m["table_c"] = clf.table.m1, clf.table.c

    out = os.path.join(tmp, "res")
    runs = {
        "classify": lambda: clf.classify_file(reads, out),
        "extended": lambda: clf.classify_file(reads, out + "_ext",
                                              extended=True),
        "paired": lambda: clf.classify_file(mates[0], out + "_pair",
                                            paired_path=mates[1]),
    }
    for fn in runs.values():
        fn()  # warm-up: allocator, library loads
    stats = {}
    for name, fn in runs.items():
        stats[name], wall = _path(launches, name, fn)
        m[f"{name}_wall_s"] = wall
    plain = check_csv(out + ".csv", expect)
    with open(out + "_ext.csv", "rb") as f:
        if drop_count_columns(f.read(), n_genomes) != plain:
            raise AssertionError("extended CSV less its counts != plain CSV")
    check_csv(out + "_pair.csv", [b"1000"] * n_pairs)
    if (stats["classify"]["reads"], stats["paired"]["reads"]) != (n_reads,
                                                                  n_pairs):
        raise AssertionError("read counts differ from the inputs")
    m["reads"], m["pairs"] = n_reads, n_pairs
    m["reads_per_s"] = n_reads / m["classify_wall_s"]
    m["kmer_lookups_per_s"] = (
        float(np.maximum(lens - k + 1, 0).sum()) / m["classify_wall_s"])
    m["extended_reads_per_s"] = n_reads / m["extended_wall_s"]
    m["pairs_per_s"] = n_pairs / m["paired_wall_s"]  # merge included
    m["hit_stats"] = stats["extended"]["hit_stats"].report()

    m["traced_wall_s"], m["phase_s"] = {}, {}
    for name, fn in runs.items():  # separate traced runs for the breakdown
        with profiling.collect() as ph:
            t = time.perf_counter()
            fn()
            m["traced_wall_s"][name] = time.perf_counter() - t
        m["phase_s"][name] = dict(ph.totals)
    if dev.type == "cuda":
        m["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return m, launches, clf, fa, lens


# --------------------------------------------------------------- phase 5
def _ms(fn, dev, reps: int) -> float:
    fn()  # warm-up
    if dev.type != "cuda":
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def build_partition(tmp: str, n_genomes: int, k: int):
    """The first canonical-range partition of the scale run's occurrences,
    padded with the 2^64-1 sentinel to a power of two, as the partitioned
    `db build --device` hands it to the device: (canon, label, pg)."""
    canon, label = [], []
    for i in range(n_genomes):
        with open(os.path.join(tmp, f"g{i}.fa"), "rb") as f:
            c = native.extract_canonical(f.read(), k, False, 1)
        canon.append(c)
        label.append(np.full(len(c), i, np.int32))
    canon, label = np.concatenate(canon), np.concatenate(label)
    pbits = max(min(int(np.ceil(np.log2(max(len(canon) / (1 << 24), 2)))),
                    9, 2 * k - 1), 1)  # builder._build_partitioned's rule
    part = (canon >> np.uint64(2 * k - pbits)) == 0
    canon, label = canon[part], label[part]
    pad = 1 << max(int(np.ceil(np.log2(len(canon)))), 20)
    canon = np.concatenate([canon, np.full(pad - len(canon), U64_MAX)])
    label = np.concatenate([label, np.zeros(pad - len(label), np.int32)])
    targets = parse_targets(os.path.join(tmp, "targets.txt"))
    return canon, label, builder._prefix_groups(targets)


def time_kernels(dev, clf: Classifier, fa: bytes, lens, tmp: str,
                 n_genomes: int, reps: int = 20, dense_rows: int = 2048):
    """Each kernel and its twin at the shapes of the phase-4 paths.  K1-K5
    on one batch of the scale run's reads at the stride-256 tier (reads of
    193-250 bp), shaped as the planner shapes it: R = window_budget / 256
    rows, W = probe_cols windows; K5 also at 65,535 targets on a
    [dense_rows, W] grid; K6 (with the torch.sort before it) on one padded
    partition of the scale run's occurrences."""
    _, _, _, ss, se, _ = native.scan_reads(fa)
    stride = 256
    r_cap = min(clf.plan.max_reads, clf.plan.window_budget // stride)
    idx = np.nonzero((lens > 192) & (lens <= stride))[0][:r_cap]
    w, v = native.pack_batch(fa, ss[idx], se[idx], stride)
    w, v = _i64(w).to(dev), _i64(v).to(dev)
    k = clf.k
    pc = clf._probe_cols(int(lens[idx].max()), stride)
    tbl = clf.table
    q = device_pipeline.window_canonicals(w, v, k, pc)
    lab = radix_table.probe(tbl, q.view(-1))
    lab = torch.where(q.view(-1) != bits.EMPTY, lab, 0).view(q.shape)
    T = clf.n_targets
    lab_big = torch.from_numpy(np.random.default_rng(5).integers(
        0, 65536, size=(dense_rows, pc)).astype(np.int32)).to(dev)
    part = _agg_tensors(build_partition(tmp, n_genomes, k) + (True,), dev)

    def counts_plain(lab, T):
        R, W = lab.shape
        rid = torch.arange(R, device=dev).repeat_interleave(W)
        counts = score.counts_from_hits_plain(lab.view(-1), rid, R, T)
        return (counts,) + score.read_results_plain(counts)

    plain_reps = max(reps // 10, 1)
    runs = {
        "window_canonicals": (
            lambda: device_pipeline.window_canonicals(w, v, k, pc),
            lambda: device_pipeline.window_canonicals_plain(w, v, k, pc),
        ),
        "probe": (
            lambda: radix_table.probe(tbl, q.view(-1)),
            lambda: radix_table.probe_plain(tbl.slots, tbl.stash_keys,
                                            tbl.stash_labels, q.view(-1),
                                            m1=tbl.m1, lb=tbl.lb),
        ),
        "top2": (
            lambda: score.top2_from_labels(lab),
            lambda: score.top2_from_labels_plain(lab),
        ),
        "sort_top2": (
            lambda: score.sort_top2(lab),
            lambda: score.sort_top2_plain(lab),
        ),
        "counts_top2": (
            lambda: score.counts_top2(lab, T),
            lambda: counts_plain(lab, T),
        ),
        "counts_top2 T=65535": (
            lambda: score.counts_top2(lab_big, 65535),
            lambda: counts_plain(lab_big, 65535),
        ),
        "aggregate": (
            lambda: device_build._aggregate_device(*part),
            lambda: device_build.aggregate_device_plain(*part),
        ),
    }
    out = {}
    for name, (kern, plain) in runs.items():
        got, want = kern(), plain()
        err = _same(name, got if isinstance(got, tuple) else [got],
                    want if isinstance(want, tuple) else [want])
        out[name] = dict(max_abs_err=err, ms=_ms(kern, dev, reps),
                         plain_ms=_ms(plain, dev, plain_reps))
    # K6 split: the torch.sort before it, and the kernel's own pass
    keys, seq = torch.sort(part[0] ^ device_build.SIGN, stable=True)
    out["aggregate"]["sort_ms"] = _ms(
        lambda: torch.sort(part[0] ^ device_build.SIGN, stable=True), dev, reps)
    if dev.type == "cuda":
        out["aggregate"]["kernel_only_ms"] = _ms(
            lambda: kernels.aggregate(keys, seq, *part[1:]), dev, reps)
    return out, dict(rows=len(idx), stride=stride, windows=pc,
                     queries=len(idx) * pc, targets=T, dense_rows=dense_rows,
                     partition_entries=part[0].shape[0])


# ------------------------------------------------------------------ main
def _phase(phase: str, t0: float, **info):
    print(f"phase {phase}: ok {time.perf_counter() - t0:.3f}s "
          + json.dumps(info, default=str), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genomes", type=int, default=16)
    ap.add_argument("--genome-len", type=int, default=3_000_000)
    ap.add_argument("--reads", type=int, default=400_000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1

    t = time.perf_counter()
    dev = torch.device("cuda", 0)
    cc = torch.cuda.get_device_capability(dev)
    if cc != (9, 0):
        raise RuntimeError(f"needs compute capability 9.0 (Hopper), got {cc}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    _phase("0 device", t, name=torch.cuda.get_device_name(dev),
           capability=cc, torch=torch.__version__, cuda=torch.version.cuda)

    t = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as ex:  # g++ and both nvcc at once
        builds = [ex.submit(native._load), ex.submit(kernels.load_all)]
        for b in builds:
            b.result()
    _phase("1 build", t, libraries=["clark_native", *kernels.SOURCES])

    t = time.perf_counter()
    n = check_kernels(dev)
    _phase("2 kernels", t, cases=n, tolerance="exact")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t = time.perf_counter()
        n_csv = check_goldens(dev, tmp)
        n_db = check_golden_dbs(dev, tmp)
        dense = check_dense_targets(dev, tmp)
        _phase("3 goldens", t, csvs_byte_equal=n_csv, dbs_byte_equal=n_db,
               dense_65535_targets_equal_cpu=True)

        t = time.perf_counter()
        scale_dir = os.path.join(tmp, "scale")
        os.makedirs(scale_dir)
        metrics, launches, clf, fa, lens = run_scale(
            dev, scale_dir, args.genomes, args.genome_len, args.reads
        )
        launches["dense 65535 targets"] = dense
        check_launches(launches)
        _phase("4 scale", t, launches=launches, **metrics)

        t = time.perf_counter()
        timing, shape = time_kernels(dev, clf, fa, lens, scale_dir,
                                     args.genomes)
        _phase("5 timing", t, shape=shape, **timing)

    record = {"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=sum(p[name] for p in launches.values()),
             **{key: timing[name][key] for key in ("max_abs_err", "ms",
                                                   "plain_ms")})
        for name, (src, rep) in KERNELS.items()
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# the kernels each main path must launch
PATH_KERNELS = {
    "db build": {"aggregate"},
    "classify": {"window_canonicals", "probe", "top2"},
    "extended": {"window_canonicals", "probe", "sort_top2"},
    "paired": {"window_canonicals", "probe", "top2"},
    "dense 65535 targets": {"window_canonicals", "probe", "counts_top2"},
}


def check_launches(launches: dict):
    """Each path launched its kernels, and every kernel ran on some path."""
    for path, need in PATH_KERNELS.items():
        missing = sorted(n for n in need if launches[path][n] == 0)
        if missing:
            raise AssertionError(f"the {path} path never launched {missing}")
    idle = [n for n in KERNELS if not any(p[n] for p in launches.values())]
    if idle:
        raise AssertionError(f"no main path launched {idle}")


if __name__ == "__main__":
    sys.exit(main())
