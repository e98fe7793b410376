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
  2 kernels  K1-K9 on the card against their plain-PyTorch twins on the
             same inputs, exact equality (integers; tolerance 0); K1 at
             strides 64, 256 and 4,096, N on window edges, reads of exactly
             k characters, W no multiple of its run; K3 in each form that
             takes a case (small with the case's T, hash and block with
             any label): W at the hash form's tile and past it, 3 x 224
             windows, 224 distinct labels, one label, labels equal to T,
             17-bit labels and labels near 2^31 - 1, negative labels, a
             ragged R, a row of 100,000 windows; K4 in both forms (W at
             the warp form's edge and past it), one label, 224 distinct
             labels, 65,534 and 65,535, a ragged R; K5 in its
             three forms, at both sides of each form's edge; K7 across
             chunk edges, cycles 2-5 (padded last chunks), the stash on and
             off, k = 32 keys, slots whose hi half equals a missing query's,
             a chunk every query falls in and ones none does, and the u16
             label grid of the labels strategy; K8 with keys in plane 2 and
             the stash; K2 and K8 (grouped by row) with forged hi
             collisions, a row of 12,000 queries, every query on one row,
             Q = 1, Q no multiple of the tile, a bin past one tile, C = 2,
             4, 6, 16 and 128, and K8's plane 2 on both sides of its form
             edge; K2 and K8's plane 1 at 2^26 rows (C = 2, 1 GiB), where
             a tile sorts its queries by pairs of rows (kshift = 1); K6
             (its bucketed form against the stable-sort twin) at k = 9-32,
             a padded partition, a bucket over its capacity split level by
             level, a key of 100,000 occurrences mid-range, all keys
             equal and n = 1, each case raising its branch of the plan;
             K9 (the flat path's search through the index's radix
             directory, against the whole-array search's twin and the
             directory's) with keys of bit 63 set (k = 32) up to 2^64 - 2,
             queries below the first key and past the last, the pad
             query, one key, N not a power of two, an empty index, Q = 1,
             a cluster in one bucket, two clusters far apart, a padded
             block and one of pad keys alone, queries at the range's
             edges, one bucket and a shift of 64, duplicate keys, and a
             config-2-sized index of 48M keys; K5's flat form over ragged reads (of 0 and 1 queries
             too), ties, the pad queries, T + 1 at 4,096 and 4,097, 65,535
             targets, no query, a permuted batch, 1,000 queries on one
             counter, labels alternating query by query
  3 goldens  classify the reference's golden reads on the card (single-end,
             --extended, paired): the six CSVs must be byte-equal to
             tests/golden; rebuild three golden DBs with device="cuda"
             (byte-equal to tests/golden/db); an extended classify against
             a synthetic DB of 65,535 targets (the dense-count path, K5)
             must equal the same run on the CPU
  4 scale    the main paths at the shape of bench.py config 2: 16 random
             genomes x 3 Mbp, full profile (k=31).  `db build` twice (the
             default, which aggregates on the card, then device="host"; the
             DBs must be byte-equal), then, each after a warm-up run:
             400,000 reads of 100-250 bp (half drawn from the genomes, half
             random) plain and --extended, and 100,000 pairs of 125 + 125 bp
             mates 200 bp apart from genome 0.  Every genome read must be assigned its
             genome's taxid, every random read NA, every pair taxid 1000;
             the extended CSV less its 16 count columns must equal the
             plain one.  Kernel launch counts are reset just before each
             path (the device build, each timed classify, and phase 3's
             65,535-target run) and read after it
  4d mesh    the same DB and reads on meshes of the card repeated 4 times
             (parallel/mesh.py), each path after a warm-up: a db mesh of 4
             resident (plain, --extended, the pairs), the db mesh in 3
             cycles (counts, then labels), a dp mesh of 4 (plain,
             --extended) and a 2 x 2 dp x db mesh (plain, --extended); every
             CSV byte-equal to phase 4's
  4b out-of-core  the same reads against the same DB four more ways, each
             after a warm-up: 4 cycles (counts strategy) plain and
             --extended, 3 cycles (labels strategy), CLARK_TPU_DENSE=force,
             and the auto policy under two CLARK_TPU_DEVICE_MEM_BYTES
             limits (dense, then cycles); every CSV byte-equal to phase 4's
             resident one, as are two threads' concurrent runs through the
             4-cycle Classifier; a cycle-outer classify_files over four
             samples byte-equal to serial runs
  4c refseq-shape  5,000 targets x 50,000 bp (benchmarks/refseq_scale.py),
             200,000 reads of 150 bp (20% random): `db build --device`,
             then resident, 3 cycles (auto strategy: labels) and
             dense-forced, every read assigned right and the three CSVs
             byte-equal
  4e config 1  bench.py's headline shape (bench.py:281-311): 3 random
             genomes x 2 Mbp, 1,000,000 reads of 150 bp all drawn from
             them, 100,000 pairs from genome 0; phase 4's steps (the two
             builds byte-equal, warm-up, then plain, --extended and
             paired, every read and pair assigned its genome) once in the
             full flavour (k = 31, bench.py's default) and once in the
             light one at the reference's constants (HTSIZE 57,777,779,
             k = 27, gap 4: what `kent -c` and a flagless `clark-torch`
             run), on the same genomes and reads; then the CLI with no
             profile flag, `db set-targets`, `db build` and `classify` in
             processes of their own: its DB is
             db_central_k27_t3_s57777779_m0_light_4.tsk, byte-equal to
             the light run's, as is its CSV.  Prints each flavour's
             rates, build, load seconds and bytes beside the card's name
             and power limit
  5 timing   each kernel and its twin at the shapes of those paths, with
             its bound and a one-call PyTorch yardstick where one exists;
             a kernel's ms is its device time in a torch.profiler session
             checked whole (utils/profiling.cuda_session: a warm-up before,
             closing markers after; a lost session retaken up to 3 times,
             the retakes recorded; CUDA events around the wrapper calls
             beside it, as event_ms);
             K7 against each chunk of the table's 4-cycle split; K2, K7,
             K8 and K6 split by pass; K6 on a build partition as it is
             and padded to 2^25, with torch.sort of its keys as the
             library call; K3 in the main path's form (small), in its
             hash form on the same batch and at 65,535 targets, and its
             parent's block form there, with torch.mode as its library
             call, and the form a row past the hash form's tile takes;
             the miss mask between the probe and K3 by its device ops;
             K1's run plan, K4's form, and the SASS instruction counts of
             K1, K3's three forms and K4 (cuobjdump); K9 and K5's flat form
             on the flat path's first config-2 batch (2^20 queries against
             the sorted 48M-key index, loaded here with packed=False and
             kept for phase 8), torch.searchsorted plus the gather and
             torch.bincount their library calls; K9's bound the floor of
             its work (the queries, the key sector of each distinct
             lower-bound position, a label sector a hit, the labels out);
             beside it the bounds of a whole-array binary search's sectors
             and of the directory design's, and the directory's build
             seconds, bytes and bucket statistics

  6 tools    after phase 5, on phase 4's DB and Classifier: `verify --db`
             (READY, its toy batch through K1-K3 on the card); bench.py
             config 3 (20,000 reads of 150 bp, 30% random, classified, then
             `abundance -D --krona --mpa` on the toy NCBI taxonomy of taxids
             1000-1015) and config 4 (8 samples of 8,000 reads of 150 bp,
             20% random, classify_files(jobs=4), `abundance -D` each,
             `merge`, `report`): each taxid's count equal to the reads
             drawn from its genome and to the CSV's tally, the merged counts
             the samples' sums; abundance, merge and report on
             tests/golden/fixtures byte-equal to the nine goldens.  Prints
             config 3's pipeline seconds and config 4's batch seconds;
             records the device-busy share of a traced config-3 pipeline
             and the host seconds of Classifier's label-range check on
             this DB (the .lb labels, the .idx cache's table)
  7 cluster  the cluster command (cluster.py), its processes this script
             run as `chip_smoke.py cli-child`, each path's CSVs
             byte-equal to their references: sample-parallel (`cluster
             --launch` of two processes on the card through an ssh stub,
             phase 6's config-4 samples 0 and 1, one a host: the CSVs and
             abundances equal phase 6's, cluster_abundance.csv their
             merge, "Nodes processed: 2/2"); DB-sharded over two processes
             with CLARK_TPU_DIST_BACKEND=gloo (two ranks share the card),
             phase 4's reads and pairs (equal to phase 4's CSVs); one
             process over NCCL, shard_db on phase 3's golden DB and reads
             (equal to tests/golden).  A sharded run in cycles is the CPU
             tests' (tests/test_torch_cluster.py): its own 48M-key load
             would take the script past 650 s.  Prints one JSON line a path: each
             process's wall, load seconds, table bytes and all_reduce
             calls, bytes and seconds, rank 0's reads/s (pairs/s) of each
             sample from its NodeResult, and the backend
  8 host paths  the flat sorted-array path (packed=False, K9 + K5's flat
             form) on phase 4's DB and reads, without warm-up runs, each
             CSV byte-equal to phase 4's: (a) plain and --extended on the
             400,000 reads; (b) over a mesh of the card repeated 4 times;
             (c) on process meshes, its processes this script run as
             `chip_smoke.py flat-child`: (c1) two processes with
             CLARK_TPU_DIST_BACKEND=gloo (two ranks share the card), a
             mesh of the card 4 times with owners [0, 0, 1, 1] (two
             blocks a process, summed on the card, then one all_reduce a
             batch), the 400,000 reads plain and --extended, both ranks'
             CSVs phase 4's; (c2) one process over NCCL, a world of one,
             on phase 3's golden DB and reads (single-end, FASTQ,
             --extended, paired; equal to tests/golden); one JSON line a
             path: each process's reads/s, load seconds, index bytes on
             the card, all_reduce calls, bytes and seconds, launches.
             (f) a burst of 200 kernels inside a `profiling.trace` in
             this long-lived process, in a session its check finds whole
             (taken again up to 3 times), every one in its trace (and how
             many a bare torch.profiler session loses at the same age,
             at its start and at its end); `classify --trace-dir` on
             config 3's 20,000 reads through the CLI in this process (the
             kernels its trace names recorded) and in a process of its
             own, its trace naming K1's, K2's and K3's kernels, each
             session one its check finds whole (taken again up to 3
             times, the retakes recorded); both CSVs phase 6's.  One JSON line a
             path: reads/s, seconds, index bytes on the card, launches.
             Then every path's launch counts are checked

The last two lines are the kernels' JSON record and the run's contract
line {"ok": true, "device": {...}}.  With no CUDA device it exits 1 and
prints neither.  It takes no arguments; a rehearsal at a smaller scale
calls the phase functions (check_kernels, run_scale, run_out_of_core,
run_refseq, run_config1, time_kernels, run_tools, run_cluster,
run_host_paths) with
smaller sizes, as tests/test_torch_smoke.py does on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from jn_cuclark_tpu_torch import cli, database, params
from jn_cuclark_tpu_torch.db import builder, device_build
from jn_cuclark_tpu_torch.engine import (
    BatchPlan,
    Classifier,
    _check_label_range,
    flat_read_cuts,
    flat_queries,
)
from jn_cuclark_tpu_torch.io import dbformat
from jn_cuclark_tpu_torch.io.fasta import parse_reads
from jn_cuclark_tpu_torch.io.targets import parse_targets
from jn_cuclark_tpu_torch.ops import (
    bits,
    device_pipeline,
    kernels,
    lookup,
    radix_table,
    score,
)
from jn_cuclark_tpu_torch.parallel.mesh import Mesh
from jn_cuclark_tpu_torch.params import Profile
from jn_cuclark_tpu_torch.utils import memory, native, profiling

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
    "probe_chunk": (_KDIR + "classify.cu",
                    "jn_cuclark_tpu/ops/radix_table.py:411"),
    "probe_dense": (_KDIR + "classify.cu",
                    "jn_cuclark_tpu/ops/radix_table.py:602"),
    "lookup": (_KDIR + "classify.cu", "jn_cuclark_tpu/ops/lookup.py:41"),
    "counts_flat": (_KDIR + "classify.cu", "jn_cuclark_tpu/ops/score.py:17"),
}
ACGT = np.frombuffer(b"ACGT", np.uint8)
U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _i64(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


# --------------------------------------------------------------- phase 2
# Inputs that reach the kernels' edge cases; tests/test_torch_cuda.py runs
# the same cases under pytest.
def _pack(seqs, stride: int):
    """(words, vwords) int64 tensors of reads `seqs` packed at `stride`."""
    data = b"".join(b">r%d\n%s\n" % (i, s) for i, s in enumerate(seqs))
    _, _, _, ss, se, _ = native.scan_reads(data)
    return tuple(_i64(a) for a in native.pack_batch(data, ss, se, stride))


def k1_cases(seed: int = 0):
    """(label, (words, vwords, k, probe_cols)) on the CPU: reads with N
    characters, reads shorter than k, an all-T read (k = 32's all-ones
    window), the full width and probe_cols trims; then the rolled runs'
    edges (kernels.window_run): strides 64 and 4,096 (two tiles a row),
    reads of exactly k characters, N as the first and the last character
    of a window, W no multiple of the run length, k = 32 on all-T reads."""
    rng = np.random.default_rng(seed)
    seqs = [
        rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=rng.integers(1, 256),
                   p=[0.245, 0.245, 0.245, 0.245, 0.02]).tobytes()
        for _ in range(2000)
    ] + [b"ACG", b"T" * 200]
    w, v = _pack(seqs, 256)
    for k in (9, 27, 31, 32):
        for pc in (None, 96, 1):
            yield f"k={k} probe_cols={pc}", (w, v, k, pc)

    def reads(n, lo, hi, n_frac):
        return [rng.choice(np.frombuffer(b"ACGTN", np.uint8),
                           size=rng.integers(lo, hi + 1),
                           p=[(1 - n_frac) / 4] * 4 + [n_frac]).tobytes()
                for _ in range(n)]

    w, v = _pack(reads(300, 1, 64, 0.02) + [b"T" * 64, b"A" * 31, b"C" * 32],
                 64)
    for k, pc in ((31, None), (32, None), (31, 13)):
        yield f"S=64 k={k} probe_cols={pc}", (w, v, k, pc)
    w, v = _pack(reads(24, 2000, 4096, 0.01) + [b"T" * 4096], 4096)
    for k, pc in ((27, None), (32, 3001)):
        yield f"S=4096 k={k} probe_cols={pc}", (w, v, k, pc)
    # N at read positions 0, 40, 41, 100 and the last: windows that start
    # and end on each; reads of exactly 27, 31 and 32 characters
    edge = []
    for n_at in ((0,), (40, 41), (100,), (249,)):
        s = bytearray(ACGT[rng.integers(0, 4, size=250)].tobytes())
        for i in n_at:
            s[i] = ord("N")
        edge.append(bytes(s))
    edge += [ACGT[rng.integers(0, 4, size=k)].tobytes() for k in (27, 31, 32)]
    w, v = _pack(edge + reads(60, 1, 256, 0.03) + [b"T" * 256], 256)
    for k, pc in ((27, None), (31, None), (32, None), (31, 101)):
        yield f"N at window edges k={k} probe_cols={pc}", (w, v, k, pc)


def k2_cases(seed: int = 0):
    """(label, (RadixTable, q)) on the host: a forced stash (c=4 at load
    16), lb = 17 (65,535 labels) at k = 32, and an all-EMPTY stash (the
    row probe of benchmarks/experiments.py:exp_probe_pallas), queried with
    stored keys, random misses and EMPTY; then K2's grouped design at its
    edges: slots whose hi half equals a missing query's, one row carrying
    12,000 queries, every query on one row, Q = 1, a Q that is no multiple
    of the tile, a bin of several rows holding three tiles of queries, and
    rows of C = 2, 6 and 128 (C = 4 and 16 above)."""
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
    yield from _k2_group_cases(rng)


def _k2_group_cases(rng):
    """k2_cases' cases of the grouped design (see there)."""
    def table_of(n, kbits, **kw):
        keys = np.unique(rng.integers(0, (1 << kbits) - 2, size=n,
                                      dtype=np.uint64))
        labels1 = rng.integers(1, 301, size=len(keys)).astype(np.int32)
        return keys, radix_table.build(keys, labels1, **kw)

    keys, table = table_of(60_000, 54)
    miss = rng.integers(0, (1 << 64) - 2, size=20_000, dtype=np.uint64)
    # misses, and stored keys whose row then holds two matching hi words
    if min(forge_hi_collisions(table, miss),
           forge_hi_collisions(table, keys[:5_000])) < 2_000:
        raise AssertionError("K2 hi collisions: too few free slots")
    yield "hi collisions c=16", (table, _i64(np.concatenate([keys, miss])))
    keys, table = table_of(60_000, 64, c=128)
    hot = hot_row_queries(rng, keys, table.m1, 12_000)
    yield "a row of 12,000 queries k=32 c=128", (
        table, _i64(np.concatenate([keys, hot])[rng.permutation(
            len(keys) + len(hot))]))
    yield "every query on one row", (
        table, _i64(hot_row_queries(rng, keys, table.m1, 5_000)))
    yield "Q=1", (table, _i64(keys[:1]))
    keys, table = table_of(20_000, 54, c=2)
    q = np.concatenate([keys, miss])[: 3 * kernels.GROUP_TILE + 17]
    yield "Q=6,161 c=2", (table, _i64(q))
    keys, table = table_of(60_000, 54, c=6)
    yield "k=27 c=6", (table, _i64(np.concatenate([keys, miss])))
    keys, table = table_of(150_000, 54)
    shift = kernels.group_bins(1 << table.m1)[0]
    if shift < 2:
        raise AssertionError(f"K2 bins of 2^{shift} rows: want several")
    in_bin = hot_row_queries(rng, keys, table.m1, 3 * kernels.GROUP_TILE,
                             rows=np.arange(1 << shift))
    yield f"a bin of {1 << shift} rows past one tile", (
        table, _i64(np.concatenate([in_bin, keys])))


def k3_cases(seed: int = 0):
    """(label, lab [R, W] int32, T) on the CPU, T the largest label the
    case holds where the small form takes it (T+1 <= 4,096), else None:
    ties, all-zero rows, W = 1, one row of 100,000 windows, labels of 17
    bits; then the forms' edges (kernels.top2_forms): W at the hash form's
    tile and one past it, the cycled-labels width 3 x 224, rows of 224
    distinct labels (the fullest table), a row of one label, labels equal
    to T at T = 16 and 4,095, labels near 2^31 - 1, negative labels (misses
    to every form), and R no multiple of the 8 reads a block."""
    rng = np.random.default_rng(seed)
    tile = kernels.K3_TILE_W
    top = (1 << 31) - 1
    near_top = rng.integers(top - 3000, top + 1, size=(64, 224))
    near_top[::3, ::2] = 0
    near_top[0, :40] = top
    at_t = rng.choice([0, 16, 16, 3], size=(64, 224))
    at_t[1] = 16
    cases = {
        "ties": (np.array([[3, 3, 5, 5, 7, 0], [2, 2, 9, 9, 9, 1],
                           [4, 0, 4, 6, 6, 6]], np.int32), 9),
        "zero rows": (np.zeros((5, 33), np.int32), 1),
        "W=1": (np.array([[0], [5], [65535]], np.int32), None),
        "100k-window row": (rng.integers(0, 18, size=(1, 100_000)), 17),
        "17-bit labels": (rng.integers(0, 1 << 17, size=(256, 400)), None),
        "random": (rng.integers(0, 6, size=(4096, 224)), 5),
        f"W={tile}": (rng.integers(0, 300, size=(16, tile)), 299),
        f"W={tile + 1}": (rng.integers(0, 300, size=(16, tile + 1)), 299),
        "W=672 T=16": (rng.integers(0, 17, size=(256, 672)), 16),
        "W=672 T=5000": (rng.integers(0, 5001, size=(256, 672)), None),
        "224 distinct": (np.stack([rng.permutation(4095)[:224] + 1
                                   for _ in range(64)]), 4095),
        "one label": (np.full((16, 224), 7), 7),
        "labels equal to T=16": (at_t, 16),
        "labels equal to T=4095": (rng.choice([0, 4095, 1], size=(64, 224)),
                                   4095),
        "labels near 2^31-1": (near_top, None),
        "negative labels": (rng.integers(-5, 6, size=(64, 224)), 5),
        "R=13": (rng.integers(0, 17, size=(13, 224)), 16),
    }
    for label, (lab, T) in cases.items():
        yield label, torch.from_numpy(lab.astype(np.int32)), T


def top2_as(lab: torch.Tensor, n_targets, form: str):
    """K3 in `form` on a CUDA tensor; the plain twin on the CPU."""
    if lab.is_cuda:
        return kernels.top2(lab, n_targets, form=form)
    return score.top2_from_labels(lab, n_targets)


def k4_cases(seed: int = 0):
    """(label, lab [R, W] int32) on the CPU for the sorted label grid: ties,
    all-zero rows, W = 1, one row of 100,000 windows, labels up to 65,534
    (u16 values above int16's range); then the warp form's edges
    (kernels.sort_form): W at its edge and one past it (the block form), a
    row of one label, rows of 224 distinct labels, labels 65,534 and 65,535
    beside 0, and R no multiple of the 8 reads a block."""
    rng = np.random.default_rng(seed)
    edge = kernels.SORT_WARP_W
    distinct = np.stack([rng.permutation(65535)[:224] + 1 for _ in range(64)])
    cases = {
        "ties": np.array([[3, 3, 5, 5, 7, 0], [2, 2, 9, 9, 9, 1],
                          [4, 0, 4, 6, 6, 6]], np.int32),
        "zero rows": np.zeros((5, 33), np.int32),
        "W=1": np.array([[0], [5], [65534]], np.int32),
        "100k-window row": rng.integers(0, 18, size=(1, 100_000)),
        "labels up to 65,534": rng.integers(0, 65535, size=(256, 400)),
        "random": rng.integers(0, 17, size=(4096, 224)),
        f"W={edge}": rng.integers(0, 300, size=(40, edge)),
        f"W={edge + 1}": rng.integers(0, 300, size=(40, edge + 1)),
        "one label": np.full((16, 224), 7),
        "224 distinct": distinct,
        "65,534 and 65,535 beside 0": rng.choice([0, 65534, 65535],
                                                 size=(100, 224)),
        "R=13": rng.integers(0, 17, size=(13, 224)),
    }
    for label, lab in cases.items():
        yield label, torch.from_numpy(lab.astype(np.int32))


def k5_cases(seed: int = 0):
    """(label, lab [R, W] int32, T) on the CPU for the dense counts, across
    K5's three forms (kernels.counts_form): ties and all-miss rows at both
    sizes of T; T = 16, 1,000 and 65,535 (small R there: a row is 256 KiB);
    T + 1 at the small form's edge (4,096) and past it (4,097); W = 1; W at
    the large form's tile edge (4,096) and past it (4,097, the multi-pass
    form); R not a multiple of the small form's reads per block."""
    rng = np.random.default_rng(seed)
    yield "ties T=9", torch.from_numpy(np.array(
        [[3, 3, 5, 5, 7, 0], [2, 2, 9, 9, 9, 1], [0, 0, 0, 0, 0, 0]],
        np.int32)), 9
    yield "ties T=65535", torch.from_numpy(np.array(
        [[40000, 40000, 7, 7, 65535, 65535, 0], [3, 3, 3, 9, 9, 9, 1],
         [0, 0, 0, 0, 0, 0, 0], [65535, 1, 65535, 1, 2, 2, 2]],
        np.int32)), 65535
    for label, T, R, W in (
        ("T=16", 16, 4096, 224), ("T=1000", 1000, 1024, 300),
        ("T=65535", 65535, 64, 500), ("T+1=4096", 4095, 37, 300),
        ("T+1=4097", 4096, 37, 300), ("W=1 T=16", 16, 13, 1),
        ("W=1 T=65535", 65535, 13, 1), ("W=4096 T=65535", 65535, 5, 4096),
        ("W=4097 T=65535", 65535, 5, 4097), ("ragged R T=16", 16, 4093, 224),
    ):
        lab = rng.integers(0, T + 1, size=(R, W)).astype(np.int32)
        lab[::9] = 0
        yield label, torch.from_numpy(lab), T


def k5_prior_cases(seed: int = 0):
    """(label, lab [R, W] int32, prior [R, T+1] int32, T) on the CPU for
    K5's small form started from a prior (a cycled call's last pass):
    ties that only the prior makes (the lowest target wins), all-zero rows
    (NA), rows whose hits are all in the prior, T + 1 at the small form's
    edge (4,096), W = 1, and R not a multiple of the small form's reads per
    block at the cycled cell's shape (T = 16, W = 224)."""
    rng = np.random.default_rng(seed)
    yield "prior ties T=9", np.array(
        [[3, 3, 5, 0], [2, 9, 9, 1], [0, 0, 0, 0], [4, 4, 4, 4]],
        np.int32), np.array(
        [[0, 0, 0, 0, 0, 1, 0, 0, 0, 0], [0, 0, 1, 0, 0, 0, 0, 0, 0, 0],
         [0, 0, 0, 0, 0, 0, 0, 0, 0, 0], [3, 0, 0, 0, 0, 0, 4, 0, 0, 4]],
        np.int32), 9
    yield "zero rows T=5", np.zeros((5, 7), np.int32), np.zeros((5, 6),
                                                                np.int32), 5
    only = rng.integers(0, 4, size=(11, 17)).astype(np.int32)
    only[::3] = 0
    yield "prior only T=16", np.zeros((11, 50), np.int32), only, 16
    for label, T, R, W in (("T+1=4096", 4095, 19, 300), ("W=1 T=16", 16, 13, 1),
                           ("ragged R T=16", 16, 4093, 224)):
        lab = rng.integers(0, T + 1, size=(R, W)).astype(np.int32)
        lab[::9] = 0
        prior = rng.integers(0, 40, size=(R, T + 1)).astype(np.int32)
        prior[::5] = 0
        yield label, lab, prior, T


def _index(keys: np.ndarray, rng, max_label: int = 65535):
    """(keys ascending as u64, labels1 in [1, max_label]) of distinct keys."""
    keys = np.unique(np.asarray(keys, dtype=np.uint64))
    return keys, rng.integers(1, max_label + 1, size=len(keys)).astype(np.int32)


def k9_cases(seed: int = 0):
    """(label, keys [N] int64, labels1 [N] int32, q [Q] int64) on the CPU
    for the sorted-array search and its radix directory: keys with bit 63
    set (k = 32) up to 2^64 - 2, queried with stored keys, random misses,
    0, 2^64 - 2, values below the first key and past the last, and the pad
    query 2^64 - 1; one key; N not a power of two at k = 31; an empty
    index; Q = 1; every query one key; a cluster in one bucket; two
    clusters far apart (most buckets empty); a pad_index-padded block and
    a block of pad keys alone; queries at kmin - 1, kmin, kmax, kmax + 1
    and 2^64 - 2; 2^0 buckets (N <= 8) over the whole u64 range, a shift
    of 64; duplicate keys (the label of the first)."""
    rng = np.random.default_rng(seed)
    top = np.uint64((1 << 64) - 2)
    keys, labels1 = _index(np.concatenate([
        rng.integers(1 << 20, (1 << 64) - 2, size=100_000, dtype=np.uint64),
        [top]]), rng)
    edges = np.array([0, 1, keys[0] - 1, keys[0], keys[-1], top,
                      lookup.PAD_QUERY], np.uint64)
    q = np.concatenate([keys[rng.permutation(len(keys))[:50_000]],
                        rng.integers(0, 1 << 64, size=50_000, dtype=np.uint64,
                                     endpoint=False), edges,
                        np.full(100, lookup.PAD_QUERY, np.uint64)])
    yield "k=32 bit 63", keys, labels1, q[rng.permutation(len(q))]
    one = np.array([np.uint64(12345)])
    yield ("one key", one, np.array([7], np.int32),
           np.array([0, 12344, 12345, 12346, lookup.PAD_QUERY], np.uint64))
    keys, labels1 = _index(rng.integers(0, 1 << 62, size=1_000_003,
                                        dtype=np.uint64), rng, 16)
    assert len(keys) & (len(keys) - 1)  # no power of two
    q = np.concatenate([keys[::3], rng.integers(0, 1 << 62, size=300_000,
                                                dtype=np.uint64),
                        np.array([keys[-1] + 1, 1 << 62, 1 << 63,
                                  lookup.PAD_QUERY], np.uint64)])
    yield "n=1000003 k=31", keys, labels1, q
    yield ("empty index", np.zeros(0, np.uint64), np.zeros(0, np.int32),
           keys[:1000])
    yield "Q=1", keys, labels1, keys[len(keys) // 2 : len(keys) // 2 + 1]
    yield "one key queried", keys, labels1, np.full(5000, keys[777])

    def near(keys, n):  # stored keys, their neighbours, random values
        lo, hi = int(keys[0]), int(keys[-1])
        return np.concatenate([keys, keys - np.uint64(1), keys + np.uint64(1),
                               rng.integers(lo, hi, size=n, dtype=np.uint64,
                                            endpoint=True)])
    # 20,000 keys within 2^20 of 2^40, two far keys: a bucket spans 2^52
    # values, so the cluster fills one bucket
    keys, labels1 = _index(np.concatenate([
        (1 << 40) + rng.integers(0, 1 << 20, size=20_000, dtype=np.uint64),
        np.array([5, (1 << 63) + 9], np.uint64)]), rng)
    yield "cluster in one bucket", keys, labels1, near(keys, 20_000)
    keys, labels1 = _index(np.concatenate([
        rng.integers(0, 1 << 24, size=30_000, dtype=np.uint64),
        top - rng.integers(0, 1 << 24, size=30_000, dtype=np.uint64)]), rng)
    yield "two clusters far apart", keys, labels1, near(keys, 30_000)
    keys, labels1 = _index(rng.integers(1 << 30, 1 << 50, size=5_000,
                                        dtype=np.uint64), rng)
    padded = lookup.pad_index(keys, labels1, 7 * 1024)
    yield "padded block", *padded, np.concatenate([
        near(keys, 5_000), np.array([lookup.PAD_QUERY], np.uint64)])
    yield ("pad keys alone", np.full(4, lookup.PAD_QUERY),
           np.zeros(4, np.int32), np.concatenate([
               keys[:100], np.array([0, top, lookup.PAD_QUERY], np.uint64)]))
    yield "range edges", keys, labels1, np.array(
        [keys[0] - 1, keys[0], keys[-1], keys[-1] + 1, top, 0,
         lookup.PAD_QUERY], np.uint64)
    keys = np.array([3, 1 << 40, (1 << 63) + 7, top], np.uint64)
    yield "b=0 shift 64", keys, np.array([4, 5, 6, 7], np.int32), near(
        keys, 1_000)
    keys = np.sort(np.repeat(rng.integers(0, 1 << 62, size=3_000,
                                          dtype=np.uint64), 3))
    yield ("duplicate keys", keys,
           rng.integers(1, 100, size=len(keys)).astype(np.int32),
           near(keys, 3_000))


def k9_stored(keys: np.ndarray, labels1: np.ndarray) -> np.ndarray:
    """What the search of each stored key gives: the label of its first
    copy, 0 for a pad key."""
    first = np.searchsorted(keys, keys)  # unsigned, the first equal key
    return np.where(keys == lookup.PAD_QUERY, 0, labels1[first]).astype(
        np.int32)


def _k9_tensors(keys, labels1, q, dev):
    return _i64(keys).to(dev), torch.from_numpy(labels1).to(dev), _i64(q).to(dev)


def k9_index_48m(dev, n: int = 47_999_520, seed: int = 12):
    """A config-2-sized index made on `dev`: n random distinct k = 31 keys
    sorted, labels in [1, 16], and 2^20 queries, half of them keys."""
    g = torch.Generator(device=dev).manual_seed(seed)
    keys = torch.randint(0, 1 << 62, (n + n // 16,), device=dev, generator=g)
    keys = torch.unique(keys)[:n]  # sorted; below 2^62, so as u64 too
    labels1 = torch.randint(1, 17, (keys.shape[0],), device=dev, generator=g,
                            dtype=torch.int32)
    q = torch.cat([keys[torch.randint(0, keys.shape[0], (1 << 19,), device=dev,
                                      generator=g)],
                   torch.randint(0, 1 << 62, (1 << 19,), device=dev,
                                 generator=g)])
    return keys, labels1, q


def k5_flat_cases(seed: int = 0):
    """(label, labels1 [Q] int32, read_id [Q] int32, R, T) on the CPU for
    K5's flat form: ragged reads of 0 to 300 queries (reads of 0 and 1
    among them), each mostly one label, with ties on count; the pad
    queries the JAX package appends (label 0, read 0); T + 1 = 4,096 and
    4,097; T = 16 at a flat batch's R; T = 65,535; no query at all; the
    T = 16 batch permuted (no read's queries together); 1,000 queries on
    one (read, label), whole warps of them; labels alternating query by
    query within each read."""
    rng = np.random.default_rng(seed)
    yield ("ties T=9", np.array([3, 3, 5, 5, 0, 9, 2, 2, 9, 9, 1, 0], np.int32),
           np.array([0, 0, 0, 0, 0, 2, 2, 2, 2, 2, 3, 3], np.int32), 5, 9)
    for label, T, R in (("T=16", 16, 7200), ("T+1=4096", 4095, 300),
                        ("T+1=4097", 4096, 300), ("T=65535", 65535, 64)):
        sizes = rng.integers(0, 301, size=R)
        sizes[::17], sizes[1::17] = 0, 1
        rid = np.repeat(np.arange(R, dtype=np.int32), sizes)
        main = rng.integers(1, T + 1, size=R)[rid]
        lab = np.where(rng.random(len(rid)) < 0.6, main,
                       rng.integers(0, T + 1, size=len(rid))).astype(np.int32)
        pad = 1000
        lab = np.concatenate([lab, np.zeros(pad, np.int32)])
        rid = np.concatenate([rid, np.zeros(pad, np.int32)])
        yield label, lab, rid, R, T
        if T == 16:
            perm = rng.permutation(len(lab))
            yield "T=16 permuted", lab[perm], rid[perm], R, T
    yield ("no query", np.zeros(0, np.int32), np.zeros(0, np.int32), 9, 16)
    yield ("one counter", np.full(1000, 5, np.int32),
           np.full(1000, 3, np.int32), 8, 16)
    rid = np.repeat(np.arange(300, dtype=np.int32), 150)
    lab = np.where(np.arange(len(rid)) % 2, 1, 2).astype(np.int32)
    yield "alternating labels", lab, rid, 300, 16


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
    """(label, (canon, label, pg, lelement), branch) as numpy arrays for
    the build aggregate: k = 9, 27, 31, 32, lelement on and off, a
    partition padded with the 2^64-1 sentinel at k = 32, a bucket of
    40,000 distinct keys over K6's capacity (split level by level), a key
    of 100,000 occurrences in the middle of the range and 300,000
    occurrences of one key (one group over the capacity: the single-key
    reduction), and n = 1.  `branch` names the level plan's count
    (bucket_plan.run_levels' stats) that the case must raise, or None."""
    rng = np.random.default_rng(seed)
    for k in (9, 27, 31, 32):
        for lelement in (True, False):
            c, l, pg = occurrences(rng, k, 200_000)
            yield f"k={k} lelement={lelement}", (c, l, pg, lelement), None
    c, l, pg = occurrences(rng, 32, 150_000)
    pad = (1 << 18) - len(c)
    yield "padded partition k=32", (
        np.concatenate([c, np.full(pad, U64_MAX, np.uint64)]),
        np.concatenate([l, np.zeros(pad, np.int32)]), pg, True), "single"
    c, l, pg = occurrences(rng, 31, 200_000)
    mid = np.uint64(1 << 61)
    skew = mid + np.arange(40_000, dtype=np.uint64) * np.uint64(4)
    yield "skewed bucket over capacity", (
        np.concatenate([c, skew]),
        np.concatenate([l, rng.integers(0, 5, size=len(skew)).astype(
            np.int32)]), pg, True), "split"
    yield "large single key mid-range", (
        np.concatenate([c, np.full(100_000, mid, np.uint64)]),
        np.concatenate([l, (np.arange(100_000) % 5).astype(np.int32)]), pg,
        False), "single"
    yield "all keys equal", (
        np.full(300_000, mid, np.uint64),
        (np.arange(300_000) % 5).astype(np.int32), pg, True), "single"
    yield "n=1", (c[:1], l[:1], pg, True), "small"


def keys_in_rows(rng, rows, m1: int) -> np.ndarray:
    """One key bucketed into each of `rows` of a 2^m1-row table (the mix
    inverted, random quotients)."""
    low = rng.integers(0, 1 << (64 - m1), size=len(rows), dtype=np.uint64)
    mixed = (np.asarray(rows, np.uint64) << np.uint64(64 - m1)) | low
    with np.errstate(over="ignore"):
        return mixed * radix_table._MIX1_INV


def _plane(table, plane: int):
    """(slots, m, mix) of a RadixTable (plane 0) or a DenseTable's plane 1
    or 2."""
    if plane == 0:
        return table.slots, table.m1, radix_table._MIX1
    if plane == 1:
        return table.slots1, table.m1, radix_table._MIX1
    return table.slots2, table.m2, radix_table._MIX2


def forge_hi_collisions(table, q: np.ndarray, plane: int = 0) -> int:
    """For each query of q whose row has a free slot, write there a slot
    whose hi half equals the query's t_hi while its lo half differs from
    t_lo in a bit at or above lb (bit lb, or bit 31): a miss that only the
    lo word tells apart.  plane: 0 for a RadixTable, 1 or 2 for a
    DenseTable's plane.  Returns the number of slots written."""
    slots, m, mix = _plane(table, plane)
    c, lb = table.slot_width, table.lb
    with np.errstate(over="ignore"):
        mixed = q * mix
    rows = (mixed >> np.uint64(64 - m)).astype(np.int64)
    t = (mixed & np.uint64((1 << (64 - m)) - 1)) << np.uint64(lb)
    n = 0
    for i, (r, ti) in enumerate(zip(rows, t)):
        free = np.nonzero(slots[r, c:] == radix_table.EMPTY32)[0]
        if len(free):
            flip = 1 << (lb if i % 2 else 31)
            slots[r, free[0]] = np.uint32((int(ti) & 0xFFFFFFFF) ^ flip
                                          ^ (i % 7))
            slots[r, c + free[0]] = np.uint32(int(ti) >> 32)
            n += 1
    return n


def hot_row_queries(rng, keys: np.ndarray, m: int, n: int,
                    rows=None) -> np.ndarray:
    """n queries bucketed (under _MIX1, 2^m rows) into `rows` (default: the
    row of keys[0]), half of them the stored keys of those rows repeated,
    half random quotients there (misses)."""
    bucket = radix_table._mix_np(keys, m)
    rows = np.atleast_1d(bucket[0] if rows is None else rows)
    stored = keys[np.isin(bucket, rows)]
    return np.concatenate([
        stored[np.arange(n - n // 2) % len(stored)],
        keys_in_rows(rng, rows[rng.integers(0, len(rows), size=n // 2)], m),
    ])[rng.permutation(n)]


def k7_cases(seed: int = 0):
    """(label, (RadixTable, q, cycles, n_keys, labels1)) on the host for the
    chunk probe, q starting with the n_keys stored keys: a
    forced stash at cycles = 3 (2^m1 is no multiple of 3, so the last chunk
    is padded), k = 32 keys (bit 63 set on half), lb = 17 at cycles = 5
    and k = 27 keys in rows of 6 slots (no multiple of K7's 4-word loads)
    at cycles = 2.  Every chunk's first and last row holds
    a stored key; queries are the stored keys, misses and EMPTY.  Then:
    slots whose hi half equals a missing query's while the lo half has a
    bit at or above lb set (cycles = 2), and a ragged query list that falls
    wholly in chunk 0 of 4 (every query there, none in chunks 1-3)."""
    rng = np.random.default_rng(seed)
    yield from _k7_split_cases(rng)
    keys = np.unique(rng.integers(0, (1 << 64) - 2, size=60_000,
                                  dtype=np.uint64))
    labels1 = rng.integers(1, 301, size=len(keys)).astype(np.int32)
    table = radix_table.build(keys, labels1)
    miss = rng.integers(0, (1 << 64) - 2, size=20_000, dtype=np.uint64)
    if forge_hi_collisions(table, miss) < 10_000:
        raise AssertionError("K7 hi collisions: too few free slots")
    yield "hi collisions cycles=2", (table, np.concatenate([keys, miss]), 2,
                                     len(keys), labels1)
    rows_per = -(-(1 << table.m1) // 4)
    in0 = np.nonzero(radix_table._mix_np(keys, table.m1) < rows_per)[0][:2_000]
    q = np.concatenate([keys[in0], keys_in_rows(
        rng, rng.integers(0, rows_per, size=2_099), table.m1)])
    yield "all in chunk 0 of 4, Q=4,099", (table, q, 4, len(in0),
                                          labels1[in0])


def _k7_split_cases(rng):
    """k7_cases' tables split at chunk edges (see there)."""
    for label, n, maxlab, kbits, cycles, kw in (
        ("forced stash cycles=3", 20_000, 40, 64, 3, dict(c=4, load=16.0)),
        ("k=32 cycles=4", 200_000, 1000, 64, 4, {}),
        ("lb=17 cycles=5", 300_000, 65535, 64, 5, {}),
        ("k=27 c=6 cycles=2", 100_000, 300, 54, 2, dict(c=6)),
    ):
        keys = np.unique(rng.integers(0, (1 << kbits) - 2, size=n,
                                      dtype=np.uint64))
        m1 = radix_table.build(keys, np.full(len(keys), maxlab, np.int32),
                               **kw).m1
        rows_per = -(-(1 << m1) // cycles)
        edge = sorted({r for i in range(cycles)
                       for r in (i * rows_per, (i + 1) * rows_per - 1)
                       if r < 1 << m1})
        keys = np.unique(np.concatenate([keys, keys_in_rows(rng, edge, m1)]))
        labels1 = rng.integers(1, maxlab + 1, size=len(keys)).astype(np.int32)
        labels1[-1] = maxlab
        table = radix_table.build(keys, labels1, **kw)
        if table.m1 != m1:
            raise AssertionError(f"K7 {label}: m1 moved with the edge keys")
        if "stash" in label and not (table.stash_keys
                                     != radix_table.EMPTY).any():
            raise AssertionError(f"K7 {label}: the stash is empty")
        q = np.concatenate([
            keys, rng.integers(0, (1 << 64) - 2, size=20_000, dtype=np.uint64),
            np.full(64, radix_table.EMPTY, np.uint64),
        ])
        yield label, (table, q, cycles, len(keys), labels1)


def k8_cases(seed: int = 0):
    """(label, (DenseTable, q, n_keys, labels1)) on the host for the dense
    probe: narrow rows crowded into plane 2 and the stash, k = 32 keys with
    lb = 17 (65,535 labels), and 128-wide rows; queries are the stored
    keys, misses and EMPTY."""
    rng = np.random.default_rng(seed)
    for label, n, maxlab, kbits, c, spills in (
        ("plane 2 + stash c=2", 40_000, 50, 54, 2, (True, True)),
        ("k=32 lb=17 c=16", 50_000, 65535, 64, 16, (False, False)),
        ("plane 2 c=128", 58_000, 200, 54, 128, (True, False)),
    ):
        keys = np.unique(rng.integers(0, (1 << kbits) - 2, size=2 * n,
                                      dtype=np.uint64))[:n]
        labels1 = rng.integers(1, maxlab + 1, size=len(keys)).astype(np.int32)
        labels1[-1] = maxlab
        dense = radix_table.build_dense(keys, labels1, c=c)
        in_plane2 = radix_table.occupied_count(dense.slots2, c)
        in_stash = int((dense.stash_keys != radix_table.EMPTY).sum())
        if (spills[0] and not in_plane2) or (spills[1] and not in_stash):
            raise AssertionError(f"K8 {label}: {in_plane2} keys in plane 2, "
                                 f"{in_stash} in the stash")
        q = np.concatenate([
            keys, rng.integers(0, (1 << 64) - 2, size=20_000, dtype=np.uint64),
            np.full(64, radix_table.EMPTY, np.uint64),
        ])
        yield label, (dense, q[rng.permutation(len(q))], keys, labels1)
    yield from _k8_group_cases(rng)


def _k8_group_cases(rng):
    """k8_cases' cases of the grouped design: hi collisions forged in both
    planes, plane 2 at C = 128 on each side of its form edge
    (kernels.plane2_form: m2 = 6 local, m2 = 7 grouped) with a plane-1 row
    of 12,000 queries, every query on one plane-1 row, Q = 1 and a Q that
    is no multiple of the tile."""
    def dense_of(n, maxlab, c):
        keys = np.unique(rng.integers(0, (1 << 54) - 2, size=2 * n,
                                      dtype=np.uint64))[:n]
        labels1 = rng.integers(1, maxlab + 1, size=len(keys)).astype(np.int32)
        return keys, labels1, radix_table.build_dense(keys, labels1, c=c)

    miss = rng.integers(0, (1 << 64) - 2, size=20_000, dtype=np.uint64)
    keys, labels1, dense = dense_of(29_000, 200, 16)
    n1 = forge_hi_collisions(dense, miss[:10_000], plane=1)
    n2 = forge_hi_collisions(dense, miss[10_000:], plane=2)
    n3 = forge_hi_collisions(dense, keys[:3_000], plane=1)  # 2 hi matches
    if min(n1, n2) < 1000 or n3 < 100:
        raise AssertionError(f"K8 hi collisions: {n1}, {n2}, {n3} forged")
    yield "hi collisions in both planes c=16", (
        dense, np.concatenate([keys, miss]), keys, labels1)
    for maxlab, form in ((30, "local"), (62, "grouped")):
        keys, labels1, dense = dense_of(58_000, maxlab, 128)
        got = kernels.plane2_form(dense.m2, 128)
        if (dense.m2, got) != (7 if form == "grouped" else 6, form):
            raise AssertionError(f"K8 plane 2: m2 = {dense.m2}, {got} form")
        if not radix_table.occupied_count(dense.slots2, 128):
            raise AssertionError("K8 plane 2 holds no key")
        hot = hot_row_queries(rng, keys, dense.m1, 12_000)
        q = np.concatenate([keys, hot, miss])
        yield f"plane 2 {form} m2={dense.m2}, a row of 12,000 queries", (
            dense, q[rng.permutation(len(q))], keys, labels1)
    yield "every query on one row", (
        dense, hot_row_queries(rng, keys, dense.m1, 5_000), keys, labels1)
    yield "Q=1", (dense, keys[:1], keys, labels1)
    yield "Q=6,161", (dense, np.concatenate([miss, keys])[
        : 3 * kernels.GROUP_TILE + 17], keys, labels1)


# 2^26 rows: the first plane size at which kernels.group_bins gives
# kshift = 1.  ~600,000 keys at 1/64 of a key a row, in rows of C = 2:
# 1 GiB.
KSHIFT_M1 = 26


def kshift_keys(seed: int = 0):
    """(rng, keys, labels1, pairs): 600,000 random keys and one more in
    each row of 4,096 adjacent row pairs (pairs[i], pairs[i] + 1) of a
    2^KSHIFT_M1-row table, labels 1-300."""
    rng = np.random.default_rng(seed)
    pairs = rng.choice(1 << (KSHIFT_M1 - 1), size=4096, replace=False) * 2
    keys = np.unique(np.concatenate([
        rng.integers(0, (1 << 64) - 2, size=600_000, dtype=np.uint64),
        keys_in_rows(rng, np.concatenate([pairs, pairs + 1]), KSHIFT_M1)]))
    labels1 = rng.integers(1, 301, size=len(keys)).astype(np.int32)
    return rng, keys, labels1, pairs


def kshift_cases(seed: int = 0):
    """(label, (RadixTable or DenseTable, q, keys, labels1)) on the host:
    K2's standard table and K8's dense plane 1, each of 2^26 rows of C = 2
    (kshift = 1: a tile counting-sorts its queries by pairs of rows, so a
    run interleaves two rows); q holds the stored keys, misses and 12,000
    queries on one pair of rows, permuted."""
    rng, keys, labels1, pairs = kshift_keys(seed)
    hot = hot_row_queries(rng, keys, KSHIFT_M1, 12_000,
                          rows=np.array([pairs[0], pairs[0] + 1]))
    q = np.concatenate([keys, hot, rng.integers(
        0, (1 << 64) - 2, size=200_000, dtype=np.uint64)])
    q = q[rng.permutation(len(q))]
    # 1/64 of a key a row in both layouts (build_dense's load counts keys a
    # slot, hence 1/128 at C = 2): n * 64 rows, 2^26 after rounding up
    table = radix_table.build(keys, labels1, c=2, load=1 / 64)
    if table.m1 != KSHIFT_M1 or kernels.group_bins(1 << table.m1)[2] != 1:
        raise AssertionError(f"K2 kshift case: m1 = {table.m1}")
    yield "kshift=1 m1=26 c=2", (table, q, keys, labels1)
    del table
    dense = radix_table.build_dense(keys, labels1, c=2, load=1 / 128)
    if dense.m1 != KSHIFT_M1:
        raise AssertionError(f"K8 kshift case: m1 = {dense.m1}")
    yield "plane 1 kshift=1 m1=26 c=2", (dense, q, keys, labels1)


def k7_labels_case(seed: int = 0):
    """(words, vwords, RadixTable) on the host: reads of a genome whose
    k-mers carry labels 40,000-45,000 at k = 31, for the cycled steps'
    narrowed u16 grid (labels of 32,768 and up ride int16 as negatives)."""
    rng = np.random.default_rng(seed)
    genome = ACGT[rng.integers(0, 4, size=20_000)].tobytes()
    keys = np.unique(native.extract_canonical(b">g\n" + genome + b"\n", 31,
                                              False, 1))
    labels1 = rng.integers(40_000, 45_001, size=len(keys)).astype(np.int32)
    table = radix_table.build(keys, labels1, c=4, load=16.0)
    lens = rng.integers(40, 257, size=2000)
    pos = rng.integers(0, len(genome) - 256, size=2000)
    data = b"".join(
        b">r%d\n%s\n" % (i, genome[p : p + n] if i % 3 else
                         ACGT[rng.integers(0, 4, size=n)].tobytes())
        for i, (p, n) in enumerate(zip(pos, lens)))
    _, _, _, ss, se, _ = native.scan_reads(data)
    w, v = native.pack_batch(data, ss, se, 256)
    return _i64(w), _i64(v), table


def _agg_tensors(case, dev):
    c, l, pg, lelement = case
    return (_i64(c).to(dev), torch.from_numpy(l).to(dev),
            torch.from_numpy(pg).to(dev), lelement)


def check_kernels(dev, big_tables: bool = True) -> int:
    """Every phase-2 case through the kernels on `dev` against the plain
    twins on the same inputs; returns the number of cases.  big_tables
    runs the two 1 GiB cases of kshift_cases (a rehearsal on the CPU leaves
    them out)."""
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
    for label, lab, T in k3_cases():
        lab = lab.to(dev)
        want = score.top2_from_labels_plain(lab)
        # each form that takes the case: small with its T, the others
        # with any label allowed
        for form in kernels.top2_forms(T, lab.shape[1]):
            before = kernels.LAUNCHES[f"top2 {form}"]
            _same(f"K3 {label} ({form})",
                  top2_as(lab, T if form == "small" else None, form), want)
            if lab.is_cuda and kernels.LAUNCHES[f"top2 {form}"] != before + 1:
                raise AssertionError(f"K3 {label}: the {form} form did not run")
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
    for label, lab, prior, T in k5_prior_cases():
        lab, prior = torch.from_numpy(lab).to(dev), torch.from_numpy(prior).to(dev)
        R, W = lab.shape
        rid = torch.arange(R, device=dev).repeat_interleave(W)
        counts = score.counts_from_hits_plain(lab.view(-1), rid, R, T) + prior
        _same(f"K5 {label}", score.counts_top2(lab, T, prior),
              (counts,) + score.read_results_plain(counts))
        n += 1
    for label, keys, labels1, q in k9_cases():
        stored = torch.from_numpy(k9_stored(keys, labels1)).to(dev)
        keys, labels1, q = _k9_tensors(keys, labels1, q, dev)
        index = lookup.build_index(keys, labels1)
        # the whole-array search's twin against the directory's twin and
        # K9 (on the CPU the directory's twin again)
        want = lookup.lookup_labels_plain(keys, labels1, q)
        _same(f"K9 {label} directory twin",
              [lookup.lookup_labels_dir_plain(index, q)], [want])
        _same(f"K9 {label}", [lookup.lookup_labels(index, q)], [want])
        if not torch.equal(lookup.lookup_labels(index, keys), stored):
            raise AssertionError(f"K9 {label}: a stored key missed")
        n += 1
    if big_tables:
        keys, labels1, q = k9_index_48m(dev)
        _same("K9 48M keys", [lookup.lookup_labels(
            lookup.build_index(keys, labels1), q)],
              [lookup.lookup_labels_plain(keys, labels1, q)])
        del keys, labels1, q
        n += 1
    for label, lab, rid, R, T in k5_flat_cases():
        lab, rid = torch.from_numpy(lab).to(dev), torch.from_numpy(rid).to(dev)
        counts = score.counts_from_hits_plain(lab, rid, R, T)
        _same(f"K5 flat {label}", score.counts_flat(lab, rid, R, T),
              (counts,) + score.read_results_plain(counts))
        n += 1
    for label, case, branch in k6_cases():
        args = _agg_tensors(case, dev)
        stats = {}
        got = (kernels.aggregate(*args, stats=stats) if dev.type == "cuda"
               else device_build.aggregate_bucketed_plain(*args, stats=stats))
        _same(f"K6 {label}", got, device_build.aggregate_device_plain(*args))
        if branch and not stats[branch]:
            raise AssertionError(f"K6 {label}: no {branch} bucket ({stats})")
        if label.startswith("padded"):  # the pad is one trailing group
            assert got[0][-1].item() == bits.EMPTY, "K6 pad group"
        n += 1
    for label, (table, q, cycles, n_keys, labels1) in k7_cases():
        stash = radix_table.put_stash(table.stash_keys, table.stash_labels, dev)
        q = _i64(q).to(dev)
        total = torch.zeros(q.shape[0], dtype=torch.int32, device=dev)
        for ch in radix_table.chunk_table(table, cycles):
            args = (torch.from_numpy(ch["slots"].view(np.int32)).to(dev),
                    *stash, q, ch["start_row"])
            for use_stash in (True, False) if ch["use_stash"] else (False,):
                kw = dict(m1=table.m1, lb=table.lb, use_stash=use_stash)
                got = radix_table.probe_chunk(*args, **kw)
                _same(f"K7 {label} chunk@{ch['start_row']} stash={use_stash}",
                      [got], [radix_table.probe_chunk_plain(*args, **kw)])
                if use_stash == ch["use_stash"]:
                    total += got
                n += 1
        # over a pass of every chunk each stored key answers once
        if not (torch.equal(total[:n_keys].cpu(), torch.from_numpy(labels1))
                and not total[n_keys:].any()):
            raise AssertionError(f"K7 {label}: a pass of every chunk does "
                                 "not answer each stored key once")
    w, v, table = k7_labels_case()
    stash = radix_table.put_stash(table.stash_keys, table.stash_labels, "cpu")
    for ch in radix_table.chunk_table(table, 3):
        args = (torch.from_numpy(ch["slots"].view(np.int32)), *stash, w, v,
                ch["start_row"], ch["use_stash"])
        kw = dict(k=31, m1=table.m1, lb=table.lb, narrow=True)
        want = device_pipeline.classify_batch_labels_chunk(*args, **kw)
        got = device_pipeline.classify_batch_labels_chunk(
            *(a.to(dev) if torch.is_tensor(a) else a for a in args), **kw)
        _same(f"K7 u16 grid chunk@{ch['start_row']}", [got.cpu()], [want])
        if ch["use_stash"] and not (want < 0).any():
            raise AssertionError("K7 u16 grid: no label of 32,768 or more")
        n += 1
    for label, (dense, q, keys, labels1) in k8_cases():
        tbl = radix_table.to_device(dense, dev)
        q = _i64(q).to(dev)
        _same(f"K8 {label}", [radix_table.probe_dense(tbl, q)],
              [radix_table.probe_dense_plain(
                  tbl.slots1, tbl.slots2, tbl.stash_keys, tbl.stash_labels, q,
                  m1=tbl.m1, m2=tbl.m2, lb=tbl.lb)])
        hit = radix_table.probe_dense(tbl, _i64(keys).to(dev))
        if not torch.equal(hit.cpu(), torch.from_numpy(labels1)):
            raise AssertionError(f"K8 {label}: a stored key missed")
        n += 1
    for label, (table, q, keys, labels1) in (kshift_cases() if big_tables
                                             else ()):
        tbl, q = radix_table.to_device(table, dev), _i64(q).to(dev)
        del table
        if isinstance(tbl, radix_table.DeviceDenseTable):
            label, probe = "K8 " + label, radix_table.probe_dense
            want = radix_table.probe_dense_plain(
                tbl.slots1, tbl.slots2, tbl.stash_keys, tbl.stash_labels, q,
                m1=tbl.m1, m2=tbl.m2, lb=tbl.lb)
        else:
            label, probe = "K2 " + label, radix_table.probe
            want = radix_table.probe_plain(tbl.slots, tbl.stash_keys,
                                           tbl.stash_labels, q, m1=tbl.m1,
                                           lb=tbl.lb)
        _same(label, [probe(tbl, q)], [want])
        if not torch.equal(probe(tbl, _i64(keys).to(dev)).cpu(),
                           torch.from_numpy(labels1)):
            raise AssertionError(f"{label}: a stored key missed")
        del tbl, q, want
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
def make_genomes(td: str, rng, n_genomes: int, glen: int, taxid0: int = 1000):
    """Random genomes g{i}.fa (one sequence line each) and targets.txt
    labelling genome i with taxid taxid0+i."""
    genomes = []
    with open(os.path.join(td, "targets.txt"), "w") as tf:
        for i in range(n_genomes):
            g = ACGT[rng.integers(0, 4, size=glen)]
            p = os.path.join(td, f"g{i}.fa")
            with open(p, "wb") as f:
                f.write(b">g%d\n%s\n" % (i, g.tobytes()))
            tf.write(f"{p} {taxid0 + i}\n")
            genomes.append(g)
    return genomes


def make_reads(rng, genomes, n_reads: int, read_len: int | None = None,
               junk_p: float = 0.5, taxid0: int = 1000):
    """FASTA of n_reads reads of 100-250 bp (or all of read_len), each
    drawn from genome i % len(genomes) or, with probability junk_p,
    random; returns (bytes, lengths, expected assignment per read)."""
    glen = len(genomes[0])
    lens = (rng.integers(100, 251, size=n_reads) if read_len is None
            else np.full(n_reads, read_len))
    junk = rng.random(n_reads) < junk_p
    gid = np.arange(n_reads) % len(genomes)
    pos = rng.integers(0, glen - lens)
    offs = np.concatenate([[0], np.cumsum(lens)])
    rel = np.arange(offs[-1]) - np.repeat(offs[:-1], lens)
    seq = np.concatenate(genomes)[np.repeat(gid * glen + pos, lens) + rel]
    jmask = np.repeat(junk, lens)
    seq[jmask] = ACGT[rng.integers(0, 4, size=int(jmask.sum()))]
    seq = seq.tobytes()
    expect = [b"NA" if j else b"%d" % (taxid0 + g) for j, g in zip(junk, gid)]
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


def _same_db(d1: str, d2: str, stem: str,
             what: str = "device- and host-built"):
    for ext in (".sz", ".ky", ".lb"):
        a = np.fromfile(os.path.join(d1, stem + ext), np.uint8)
        b = np.fromfile(os.path.join(d2, stem + ext), np.uint8)
        if not np.array_equal(a, b):
            raise AssertionError(f"{what} {ext} differ")


def _path(launches: dict, name: str, fn):
    """Run one main path with the launch counts reset just before it;
    record its counts under `name`; return (fn(), seconds)."""
    kernels.reset_launches()
    t = time.perf_counter()
    out = fn()
    seconds = time.perf_counter() - t
    launches[name] = dict(kernels.LAUNCHES)
    return out, seconds


def genome_occurrences(prof: Profile, k: int, glen: int) -> int:
    """The k-mer occurrences the build extracts from a genome of glen
    bases on one sequence line: every window in the full flavour; in the
    light one, the non-overlapping k-mers (glen // k), one in gap of them
    (db/builder.extract_occurrences)."""
    if not prof.light:
        return max(glen - k + 1, 0)
    return -(-(glen // k) // prof.default_gap)


def run_scale(dev, tmp: str, n_genomes: int, glen: int, n_reads: int,
              n_pairs: int = 100_000, prof: Profile = params.FULL,
              seed: int = 2, read_len: int | None = None,
              junk_p: float = 0.5, name: str = ""):
    """Phase 4 (and each flavour of phase 4e): the DB built on the card
    and on the host, then the reads (of read_len bp, or 100-250; junk_p of
    them random) plain and extended and the pairs, each timed after a
    warm-up; launch counts under `name` + the path's name.  Returns
    (metrics, launch counts by path, classifier, reads, lens)."""
    k = prof.default_k
    rng = np.random.default_rng(seed)
    m, launches = {}, {}
    t = time.perf_counter()
    genomes = make_genomes(tmp, rng, n_genomes, glen)
    targets = parse_targets(os.path.join(tmp, "targets.txt"))
    m["setup_genomes_s"] = time.perf_counter() - t

    # the build's default device is cuda: on the card the default runs
    dev_kw = {} if dev.type == "cuda" else dict(device=dev)
    with profiling.collect() as ph:
        db, m["db_build_device_s"] = _path(
            launches, name + "db build",
            lambda: builder.build_database(targets, tmp, prof, k, **dev_kw))
    m["db_build_device_phase_s"] = dict(ph.totals)
    host_dir = os.path.join(tmp, "host_db")
    os.makedirs(host_dir)
    with profiling.collect() as ph:
        t = time.perf_counter()
        builder.build_database(targets, host_dir, prof, k, device="host")
        m["db_build_host_s"] = time.perf_counter() - t
    m["db_build_host_phase_s"] = dict(ph.totals)
    stem = prof.db_stem(k, n_genomes, 0, prof.default_gap)
    _same_db(tmp, host_dir, stem)
    shutil.rmtree(host_dir)
    m["db_keys"], m["db_distinct_kmers"] = len(db.canonical), db.n_mother
    m["db_occurrences"] = n_genomes * genome_occurrences(prof, k, glen)
    m["db_file_bytes"] = {ext: os.path.getsize(os.path.join(tmp, stem + ext))
                          for ext in (".sz", ".ky", ".lb")}

    t = time.perf_counter()
    fa, lens, expect = make_reads(np.random.default_rng(seed + 1), genomes,
                                  n_reads, read_len=read_len, junk_p=junk_p)
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
    for path, fn in runs.items():
        stats[path], wall = _path(launches, name + path, fn)
        m[f"{path}_wall_s"] = wall
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
    for path, fn in runs.items():  # separate traced runs for the breakdown
        with profiling.collect() as ph:
            t = time.perf_counter()
            fn()
            m["traced_wall_s"][path] = time.perf_counter() - t
        m["phase_s"][path] = dict(ph.totals)
    if dev.type == "cuda":
        m["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return m, launches, clf, fa, lens


@contextlib.contextmanager
def _env(**values):
    """Set environment variables for the block, then restore them."""
    old = {key: os.environ.get(key) for key in values}
    os.environ.update({key: str(v) for key, v in values.items()})
    try:
        yield
    finally:
        for key, v in old.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v


def _load(dev, tmp: str, prof: Profile, **kw):
    """(Classifier of the DB in tmp, seconds to load it)."""
    t = time.perf_counter()
    clf = Classifier.load(tmp, os.path.join(tmp, "targets.txt"), prof,
                          prof.default_k, device=dev, **kw)
    return clf, time.perf_counter() - t


def run_path(dev, launches: dict, name: str, clf, reads: str, out: str, lens,
             extended: bool = False):
    """One classify path: a warm-up run, then a run with the launch counts
    reset just before it and the phase timers on.  Returns (metrics, CSV
    bytes)."""
    clf.classify_file(reads, out, extended=extended)  # warm-up
    cuda = dev.type == "cuda"
    if cuda:
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with profiling.collect() as ph:
        stats, wall = _path(launches, name, lambda: clf.classify_file(
            reads, out, extended=extended))
    with open(out + ".csv", "rb") as f:
        csv = f.read()
    if clf.db_cycles > 1:
        residency = dict(cycles=clf.db_cycles,
                         strategy=clf._cycled_strategy(int(lens.max())),
                         chunk_device_bytes=clf.table_chunks[0]["slots"].nbytes)
    else:
        residency = dict(cycles=1, strategy="dense" if clf.dense_table is not None
                         else "resident", table_device_bytes=clf.table.nbytes)
    m = dict(wall_s=wall, reads_per_s=stats["reads"] / wall,
             kmer_lookups_per_s=float(np.maximum(lens - clf.k + 1, 0).sum())
             / wall, **residency,
             chunk_upload_s=ph.totals.get("chunk_upload", 0.0),
             phase_s=dict(ph.totals))
    if cuda:  # other classifiers' tables are in allocated_before
        m["allocated_before"] = before
        m["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return m, csv


def split_reads(fa: bytes, tmp: str, n: int):
    """n files of consecutive records of a two-line-per-record FASTA;
    returns classify_files items (path, None, result prefix)."""
    lines = fa.split(b"\n")[:-1]
    n_rec = len(lines) // 2
    items = []
    for i in range(n):
        part = lines[2 * (i * n_rec // n) : 2 * ((i + 1) * n_rec // n)]
        path = os.path.join(tmp, f"sample{i}.fa")
        with open(path, "wb") as f:
            f.write(b"\n".join(part) + b"\n")
        items.append((path, None, os.path.join(tmp, f"sample{i}_cyc")))
    return items


def run_out_of_core(dev, tmp: str, prof: Profile, clf, fa: bytes, lens,
                    launches: dict):
    """Phase 4b: the config-2 reads classified four more ways against the
    phase-4 DB, each CSV byte-equal to the resident run's: (a) 4 cycles,
    auto strategy (counts at 16 targets), plain and extended; (b) 3 cycles,
    labels strategy; (c) CLARK_TPU_DENSE=force; (d) the auto policy under
    two CLARK_TPU_DEVICE_MEM_BYTES limits set from the table's own bytes:
    one where only the dense layout fits (dense), one below it (cycles);
    two threads' concurrent calls through the 4-cycle Classifier, and a
    cycle-outer classify_files over four samples, byte-equal to serial
    resident runs.  Returns (metrics, the dense classifier)."""
    reads, res = os.path.join(tmp, "reads.fa"), os.path.join(tmp, "res")
    want = {}
    for ext in (False, True):
        with open(res + ("_ext" if ext else "") + ".csv", "rb") as f:
            want[ext] = f.read()
    m = {}

    def path(name, c, extended=False):
        m[name], csv = run_path(dev, launches, name, c, reads,
                                os.path.join(tmp, name.replace(" ", "_")),
                                lens, extended)
        if csv != want[extended]:
            raise AssertionError(f"{name}: the CSV differs from the resident "
                                 "run's")

    cyc, m["load_cycles4_s"] = _load(dev, tmp, prof, db_cycles=4)
    if cyc._cycled_strategy(int(lens.max())) != "counts":
        raise AssertionError("4 cycles at 16 targets did not resolve to counts")
    path("cycled counts", cyc)
    path("cycled counts extended", cyc, extended=True)
    outs = [os.path.join(tmp, f"cycled_thread{i}") for i in range(2)]
    with ThreadPoolExecutor(max_workers=2) as ex:  # one Classifier, 2 calls
        list(ex.map(lambda out: cyc.classify_file(reads, out), outs))
    for out in outs:
        with open(out + ".csv", "rb") as f:
            if f.read() != want[False]:
                raise AssertionError("a concurrent cycled call's CSV differs "
                                     "from the resident run's")

    items = split_reads(fa, tmp, 4)
    stats, wall = _path(launches, "cycle-outer files",
                        lambda: cyc.classify_files(items, jobs=4))
    if not all(s.get("aggregate") for s in stats):
        raise AssertionError("classify_files did not run cycle-outer")
    for obj, _, out in items:
        clf.classify_file(obj, out + "_serial")
        with open(out + ".csv", "rb") as a, open(out + "_serial.csv", "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"cycle-outer {obj} differs from serial")
    m["cycle-outer files"] = dict(samples=len(items), wall_s=wall,
                                  reads_per_s=len(lens) / wall)
    del cyc

    lab, m["load_cycles3_labels_s"] = _load(
        dev, tmp, prof, db_cycles=3, plan=BatchPlan(cycle_strategy="labels"))
    path("cycled labels", lab)
    del lab

    with _env(CLARK_TPU_DENSE="force"):
        dense, m["load_dense_s"] = _load(dev, tmp, prof)  # builds the cache
    if dense.dense_table is None:
        raise AssertionError("CLARK_TPU_DENSE=force did not engage dense")
    m["dense_m1_m2"] = [dense.table.m1, dense.table.m2]
    path("dense", dense)

    transient = clf._transient_bytes()
    for name, frac in (("auto dense", 0.75), ("auto cycled", 0.4)):
        limit = memory.RESERVED + transient + int(clf.table.nbytes * frac)
        with _env(CLARK_TPU_DEVICE_MEM_BYTES=limit):
            auto, m[f"load_{name.replace(' ', '_')}_s"] = _load(dev, tmp, prof)
        is_dense = auto.dense_table is not None
        if is_dense != (name == "auto dense") or (not is_dense
                                                  and auto.db_cycles < 2):
            raise AssertionError(f"{name}: the policy chose dense={is_dense}, "
                                 f"{auto.db_cycles} cycles")
        path(name, auto)
        m[name]["device_mem_limit"] = limit
        del auto
    return m, dense


def _mesh_layout(clf) -> dict:
    """A meshed classifier's shards, cycles and device bytes a shard."""
    if clf.sharded is not None:
        return dict(shards=clf.mesh.size, db_shards=clf.sharded.ndb,
                    cycles=clf.db_cycles, shard_bytes=clf.sharded.shard_bytes)
    held = next(iter(clf.shards.values()))
    return dict(shards=clf.mesh.size, db_shards=clf.mesh.shape[-1]
                if len(clf.mesh.axis_names) == 2 else 1, cycles=1,
                shard_bytes=int(held.nbytes))


def run_mesh(dev, tmp: str, prof: Profile, lens, launches: dict,
             n: int = 4):
    """Phase 4d: the phase-4 DB and reads through Classifier.load(mesh=)
    on meshes of `dev` repeated n times, each path after a warm-up run and
    its CSV byte-equal to phase 4's: (a) a db mesh of n, resident: plain,
    extended and the pairs; (b) the db mesh in 3 cycles, the counts then
    the labels strategy; (c) a dp mesh of n: plain and extended; (d) a
    2 x n/2 dp x db mesh: plain and extended.  Returns the metrics."""
    reads, res = os.path.join(tmp, "reads.fa"), os.path.join(tmp, "res")
    mates = os.path.join(tmp, "r1.fq"), os.path.join(tmp, "r2.fq")
    want = {}
    for kind, suffix in (("plain", ""), ("extended", "_ext"),
                         ("paired", "_pair")):
        with open(res + suffix + ".csv", "rb") as f:
            want[kind] = f.read()
    lookups = float(np.maximum(lens - prof.default_k + 1, 0).sum())
    m = {}

    def path(name, clf, kind="plain"):
        out = os.path.join(tmp, name.replace(" ", "_"))
        src, kw = reads, dict(extended=kind == "extended")
        if kind == "paired":
            src, kw = mates[0], dict(paired_path=mates[1])
        clf.classify_file(src, out, **kw)  # warm-up
        with profiling.collect() as ph:
            stats, wall = _path(launches, name,
                                lambda: clf.classify_file(src, out, **kw))
        with open(out + ".csv", "rb") as f:
            if f.read() != want[kind]:
                raise AssertionError(f"{name}: the CSV differs from phase 4's")
        m[name] = dict(wall_s=wall, **_mesh_layout(clf),
                       phase_s=dict(ph.totals))
        if kind == "paired":
            m[name]["pairs_per_s"] = stats["reads"] / wall
        else:
            m[name]["reads_per_s"] = stats["reads"] / wall
            m[name]["kmer_lookups_per_s"] = lookups / wall

    devs = [dev] * n
    db_mesh = Mesh(devs, ("db",))
    clf, m["load_db_s"] = _load(dev, tmp, prof, mesh=db_mesh, mesh_mode="db")
    path("mesh db", clf)
    path("mesh db extended", clf, "extended")
    path("mesh db paired", clf, "paired")
    del clf
    clf, m["load_db_cycles3_s"] = _load(
        dev, tmp, prof, mesh=db_mesh, mesh_mode="db", db_cycles=3,
        plan=BatchPlan(cycle_strategy="counts"))
    for strategy in ("counts", "labels"):
        clf.plan = dataclasses.replace(clf.plan, cycle_strategy=strategy)
        if clf._cycled_strategy(int(lens.max())) != strategy:
            raise AssertionError(f"the db mesh's cycles ran {strategy!r}?")
        path(f"mesh db cycled {strategy}", clf)
    del clf
    clf, m["load_dp_s"] = _load(dev, tmp, prof, mesh=Mesh(devs, ("dp",)))
    path("mesh dp", clf)
    path("mesh dp extended", clf, "extended")
    del clf
    clf, m["load_dp_x_db_s"] = _load(
        dev, tmp, prof, mesh=Mesh([devs[: n // 2], devs[n // 2 :]],
                                  ("dp", "db")))
    path("mesh dp x db", clf)
    path("mesh dp x db extended", clf, "extended")
    m["reads"], m["devices"] = len(lens), [str(d) for d in devs]
    return m


def run_refseq(dev, tmp: str, launches: dict, n_targets: int = 5000,
               glen: int = 50_000, n_reads: int = 200_000, seed: int = 7):
    """Phase 4c, the RefSeq shape (benchmarks/refseq_scale.py: 5,000
    targets x 50,000 bp, reads of 150 bp, 20% random, full profile
    k = 31): `db build --device`, then the reads
    classified resident, in 3 cycles (auto strategy, which must resolve to
    labels at 5,000 targets) and dense-forced.  Every genome read gets its
    taxid, every random one NA, and the three CSVs are byte-equal."""
    prof = params.FULL
    k = prof.default_k
    rng = np.random.default_rng(seed)
    m = {}
    t = time.perf_counter()
    genomes = make_genomes(tmp, rng, n_targets, glen, taxid0=100_000)
    targets = parse_targets(os.path.join(tmp, "targets.txt"))
    fa, lens, expect = make_reads(rng, genomes, n_reads, read_len=150,
                                  junk_p=0.2, taxid0=100_000)
    reads = os.path.join(tmp, "reads.fa")
    with open(reads, "wb") as f:
        f.write(fa)
    del genomes, fa
    m["setup_s"] = time.perf_counter() - t
    db, m["db_build_device_s"] = _path(
        launches, "refseq db build",
        lambda: builder.build_database(targets, tmp, prof, k, device=dev))
    m["db_keys"] = len(db.canonical)
    del db

    clf, m["load_s"] = _load(dev, tmp, prof)
    m["table_m1_lb"] = [clf.table.m1, clf.table.lb]
    m["refseq resident"], want = run_path(
        dev, launches, "refseq resident", clf, reads,
        os.path.join(tmp, "resident"), lens)
    check_csv(os.path.join(tmp, "resident.csv"), expect)
    del clf
    cyc, m["load_cycles3_s"] = _load(dev, tmp, prof, db_cycles=3)
    if cyc._cycled_strategy(int(lens.max())) != "labels":
        raise AssertionError("3 cycles at 5,000 targets did not resolve to "
                             "labels")
    m["refseq cycled"], csv = run_path(dev, launches, "refseq cycled", cyc,
                                       reads, os.path.join(tmp, "cyc"), lens)
    if csv != want:
        raise AssertionError("refseq cycled CSV differs from the resident's")
    del cyc
    with _env(CLARK_TPU_DENSE="force"):
        dense, m["load_dense_s"] = _load(dev, tmp, prof)
    m["refseq dense"], csv = run_path(dev, launches, "refseq dense", dense,
                                      reads, os.path.join(tmp, "dense"), lens)
    if dense.dense_table is None or csv != want:
        raise AssertionError("refseq dense CSV differs from the resident's")
    m["reads"], m["targets"], m["genome_len"] = n_reads, n_targets, glen
    return m


# -------------------------------------------------------------- phase 4e
CONFIG1_STEM = "db_central_k27_t3_s57777779_m0_light_4.tsk"  # the CLI's


def _clark_torch(*argv, timeout: int = 600) -> float:
    """One command of the port's CLI as a user runs it: a process of
    `python -m jn_cuclark_tpu_torch.cli` from the checkout's root.
    Returns its seconds; raises where it fails."""
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "jn_cuclark_tpu_torch.cli",
                        *map(str, argv)], cwd=ROOT, capture_output=True,
                       text=True, timeout=timeout, env=_cluster_env())
    if r.returncode:
        raise AssertionError(f"clark-torch {' '.join(map(str, argv))}: rc "
                             f"{r.returncode}\n{(r.stdout + r.stderr)[-4000:]}")
    return time.perf_counter() - t


def run_config1(dev, tmp: str, launches: dict, glen: int = 2_000_000,
                n_reads: int = 1_000_000, n_pairs: int = 100_000,
                profiles: tuple = (params.FULL, params.LIGHT)):
    """Phase 4e, bench.py's configuration 1 (bench.py:281-311): 3 genomes
    of glen bp, n_reads reads of 150 bp all drawn from them, n_pairs
    pairs from genome 0, through `run_scale` once a flavour in `profiles`
    (the full one, bench.py's default, then the light one, what `kent -c`
    and a flagless `clark-torch` run), on the same genomes and reads; the
    launch counts under "config1 <full|light> <path>".  Then the CLI as a
    user runs it, with no profile flag: `db set-targets`, `db build` and
    `classify` in processes of their own on a layout of the same genomes;
    its DB must be CONFIG1_STEM, and its files and CSV byte-equal to the
    light flavour's (which must be params.LIGHT).  Returns the metrics
    by flavour and the CLI's."""
    m = {}
    for prof in profiles:
        flavour = "light" if prof.light else "full"
        d = os.path.join(tmp, flavour)
        os.makedirs(d)
        m[flavour], paths, clf, _, _ = run_scale(
            dev, d, 3, glen, n_reads, n_pairs, prof, read_len=150,
            junk_p=0.0, name=f"config1 {flavour} ")
        launches.update(paths)
        del clf
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if not prof.light:
            shutil.rmtree(d)
    light = os.path.join(tmp, "light")

    db = os.path.join(tmp, "cli")
    cli_layout(db, light, 3)
    device = [] if dev.type == "cuda" else ["--device", dev.type]
    out = os.path.join(tmp, "cli_res")
    c = m["cli"] = {}
    c["set_targets_s"] = _clark_torch("db", "set-targets", db)
    c["db_build_s"] = _clark_torch("db", "build", db, *device)
    c["classify_s"] = _clark_torch("classify", "-D", db, "-O",
                                   os.path.join(light, "reads.fa"), "-R",
                                   out, *device)
    subdb = database.DBConfig.load(db).subdb
    c["db_files"] = sorted(f for f in os.listdir(subdb)
                           if f.endswith((".sz", ".ky", ".lb")))
    if c["db_files"] != [CONFIG1_STEM + ext for ext in (".ky", ".lb", ".sz")]:
        raise AssertionError(f"the CLI's DB files: {c['db_files']}")
    _same_db(subdb, light, CONFIG1_STEM, "the CLI's and the API's light")
    _same_file("config1 CLI", out + ".csv", os.path.join(light, "res.csv"))
    c["stem"] = CONFIG1_STEM
    return m


# --------------------------------------------------------------- phase 5
# Published rates of one NVIDIA H100 SXM at its 700 W limit: device memory,
# and float32 outside the tensor cores, taken as the rate of the integer
# compares and adds these kernels do on the CUDA cores.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
STASH = radix_table.STASH_CAP


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _distinct(rows: torch.Tensor) -> int:
    """Distinct table rows among the buckets `rows`."""
    return int(torch.unique(rows).numel())


def _probe_reads(slots: torch.Tensor, rows: torch.Tensor, qlow: torch.Tensor,
                 lb: int) -> dict:
    """What a probe of queries (bucket `rows`, quotient `qlow`) must read of
    the table: the hi half (C x 4 B) of each distinct row they touch, and
    one 32-B sector of lo words for each query whose hi half matched a
    slot's (a lo word decides only there)."""
    c = slots.shape[1] // 2
    matched = 0
    for s in range(0, rows.shape[0], 1 << 20):
        t_hi = bits.lsr(qlow[s : s + (1 << 20)] << lb, 32).to(torch.int32)
        hi = slots[rows[s : s + (1 << 20)], c:]
        matched += int((hi == t_hi[:, None]).any(dim=1).sum())
    distinct = _distinct(rows)
    return dict(queries=int(rows.shape[0]), distinct_rows=distinct,
                hi_matched=matched, bytes=distinct * c * 4 + 32 * matched)


def _search_reads(keys: torch.Tensor, q: torch.Tensor) -> dict:
    """What binary searches of q over the whole of keys read: the distinct
    32-B sectors of keys that their lower-bound steps and final compare
    visit, and a sector of labels (4 B each) per hit's; with the compares
    they make (the pad query makes none); and floor_bytes, what any search
    must read: the key sector of each distinct lower-bound position and
    the label sectors."""
    n = keys.shape[0]
    q = q[q != bits.EMPTY]
    kf, qf = keys ^ bits._SIGN, q ^ bits._SIGN
    lo, hi = torch.zeros_like(q), torch.full_like(q, n)
    seen, compares = [], 0
    while True:
        act = (lo < hi).nonzero().squeeze(1)
        if not act.numel():
            break
        mid = lo[act] + ((hi[act] - lo[act]) >> 1)
        seen.append(mid >> 2)
        compares += act.numel()
        less = kf[mid] < qf[act]
        lo[act] = torch.where(less, mid + 1, lo[act])
        hi[act] = torch.where(less, hi[act], mid)
    fin = lo[lo < n]
    seen.append(fin >> 2)
    hit = fin[keys[fin] == q[lo < n]]
    key_sectors = int(torch.unique(torch.cat(seen)).numel())
    label_sectors = int(torch.unique(hit >> 3).numel())
    return dict(queries=int(q.numel()), compares=compares + int(fin.numel()),
                hits=int(hit.numel()), key_sectors=key_sectors,
                label_sectors=label_sectors,
                bytes=32 * (key_sectors + label_sectors),
                # what no search can read less of: the key sector of each
                # distinct lower-bound position, a label sector a hit
                floor_bytes=32 * (int(torch.unique(fin >> 2).numel())
                                  + label_sectors))


def _directory_reads(d: lookup.FlatIndex, q: torch.Tensor) -> dict:
    """What K9's directory design reads of the index for queries q: the
    32-B sectors of the directory's offsets they load (dir[j] and
    dir[j + 1]) and the key sectors of the buckets they search (all of
    each, as a scan reads them), with the directory's bucket statistics:
    mean and largest keys a bucket, the share of empty buckets."""
    sizes = (d.offsets[1:] - d.offsets[:-1]).long()
    stats = dict(bits=d.bits, shift=d.shift, buckets=int(sizes.numel()),
                 mean_keys=float(sizes.double().mean()),
                 max_keys=int(sizes.max()),
                 empty_share=float((sizes == 0).double().mean()),
                 directory_bytes=_nbytes(d.offsets))
    if d.kmin > d.kmax:
        return dict(stats, dir_sectors=0, bucket_sectors=0, bytes=0)
    kmin = torch.tensor(bits.i64(d.kmin), device=q.device)
    kmax = torch.tensor(bits.i64(d.kmax), device=q.device)
    q = q[(q != bits.EMPTY) & ~bits.ult(q, kmin) & ~bits.ult(kmax, q)]
    j = torch.unique(lookup.bucket_index(q, d.kmin, d.shift))
    dir_sectors = int(torch.unique(torch.cat([j >> 3, (j + 1) >> 3])).numel())
    lo, hi = d.offsets[j].long(), d.offsets[j + 1].long()
    lo, hi = lo[hi > lo], hi[hi > lo]
    s0, s1 = lo >> 2, (hi - 1) >> 2  # ascending with j: neighbours may
    # share their boundary sector
    bucket_sectors = int((s1 - s0 + 1).sum() - (s0[1:] == s1[:-1]).sum())
    return dict(stats, dir_sectors=dir_sectors, bucket_sectors=bucket_sectors,
                bytes=32 * (dir_sectors + bucket_sectors))


def flat_batch(flat: Classifier, fa: bytes, n_records: int = 20_000):
    """The first flat-path batch of the reads `fa` as _classify_flat cuts
    it: (q [Q] int64, read ids [Q] int32, its reads) on the flat
    classifier's device, from the first n_records records' windows."""
    head = b"\n".join(fa.split(b"\n", 2 * n_records)[:-1]) + b"\n"
    qvals, rid, woff = flat_queries(parse_reads(head), flat.k)
    r0, r1 = next(flat_read_cuts(woff, flat.plan.max_queries,
                                 flat._dense_rows(flat.plan.max_reads)))
    q0, q1 = int(woff[r0]), int(woff[r1])
    return (_i64(qvals[q0:q1]).to(flat.device),
            torch.from_numpy((rid[q0:q1] - r0).astype(np.int32)).to(
                flat.device), r1 - r0)


def _bound(nbytes: int, ops: int):
    """(least milliseconds the card could take, what bounds it)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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


SPLIT_RETAKES = 3  # a timed function's profiler sessions taken again


def _device_split(fn, dev, reps: int) -> tuple[dict, int]:
    """Device milliseconds per call of each kernel (and memset) that fn
    launches: its device time in a torch.profiler session over reps calls
    (profiling.cuda_session, whose warm-up takes the first kernels a
    session drops).  A session is lost where profiling.check_session
    finds a kernel missing, or where a kernel's events are no multiple of
    reps; it is taken again, up to SPLIT_RETAKES times, and then this
    raises.  Returns (split, retakes)."""
    fn()  # warm-up
    torch.cuda.synchronize(dev)
    lost = []
    with tempfile.TemporaryDirectory() as td:
        for take in range(SPLIT_RETAKES + 1):
            with profiling.cuda_session(os.path.join(td, f"{take}.json"),
                                        dev) as rec:
                for _ in range(reps):
                    fn()
            split = session_split(rec, reps)
            if split is not None:
                return split, take
            lost.append({k: v for k, v in rec.items() if k != "events"})
    raise AssertionError(f"{SPLIT_RETAKES + 1} profiler sessions lost "
                         f"kernels: {lost}")


def session_split(rec: dict, reps: int) -> dict | None:
    """Device milliseconds per call of each kernel (and memset) in the
    block of a profiling.cuda_session record of reps calls, by name; None
    where the session is not whole or a name's events are no multiple of
    reps (each call launches the same kernels)."""
    us, count = {}, {}
    for e in profiling.block_events(rec["events"]):
        name = e["name"].split("(")[0]
        us[name] = us.get(name, 0.0) + e["dur"]
        count[name] = count.get(name, 0) + 1
    if not rec["whole"] or any(c % reps for c in count.values()):
        return None
    return {n: t / reps / 1e3 for n, t in us.items()}


SASS_KERNELS = ("window_canonicals_kernel", "sort_warp_kernel", "top2_kernel",
                "top2_small_kernel", "top2_hash_kernel")


def sass_counts(lib_path: str, names=SASS_KERNELS) -> dict:
    """Instructions (NOPs left out) in the SASS of each kernel of a built
    library whose name holds one of `names` (cuobjdump -sass): {mangled
    name: count}.  A kernel's count is static: each loop body counts once,
    so a thread's run of E windows counts E times in K1's."""
    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", lib_path],
        capture_output=True, text=True, check=True, timeout=300).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1) if any(n in m.group(1) for n in names) else None
            if cur:
                counts[cur] = 0
        elif cur and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?!NOP\b)\S", line):
            counts[cur] += 1
    return counts


def build_partition(tmp: str, n_genomes: int, k: int):
    """The first canonical-range partition of the scale run's occurrences,
    as the partitioned `db build --device` hands it to the device:
    (canon, label, pg)."""
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
    targets = parse_targets(os.path.join(tmp, "targets.txt"))
    return canon[part], label[part], builder._prefix_groups(targets)


def pad_partition(canon, label, pg):
    """A partition padded with the 2^64-1 sentinel to a power of two (at
    least 2^20), as the builder handed it to the device before K6 took
    unpadded input."""
    pad = 1 << max(int(np.ceil(np.log2(len(canon)))), 20)
    return (np.concatenate([canon, np.full(pad - len(canon), U64_MAX)]),
            np.concatenate([label, np.zeros(pad - len(label), np.int32)]),
            pg)


def time_kernels(dev, clf: Classifier, dense: Classifier, flat: Classifier,
                 fa: bytes, lens, tmp: str, n_genomes: int, reps: int = 20,
                 dense_rows: int = 2048):
    """Each kernel and its twin at the shapes of the phase-4 paths, with
    its bound and, where one PyTorch call computes the same function, that
    call's time.  K1-K5, K7 and K8 on one batch of the scale run's reads at
    the stride-256 tier (reads of 193-250 bp), shaped as the planner shapes
    it: R = window_budget / 256 rows, W = probe_cols windows; K7 against
    the first chunk of the table's 4-cycle split, K8 against the `dense`
    classifier's two-plane table; K3 (its small and hash forms, then the
    hash and block forms) and K5 also at 65,535 targets on a [dense_rows,
    W] grid; K9 and K5's flat form on the first batch of the flat path
    (`flat`, packed=False: its sorted index, the batch's queries as
    _classify_flat cuts them); K6 on the first partition of the scale run's
    occurrences, as the build hands it over and padded to a power of two
    as it was before."""
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
    hits = radix_table.probe(tbl, q.view(-1))
    lab = device_pipeline._masked(q, hits)
    T = clf.n_targets
    lab_big = torch.from_numpy(np.random.default_rng(5).integers(
        0, 65536, size=(dense_rows, pc)).astype(np.int32)).to(dev)
    part = build_partition(tmp, n_genomes, k)
    part_pad = _agg_tensors(pad_partition(*part) + (True,), dev)
    part = _agg_tensors(part + (True,), dev)
    sort_keys = {n: p[0] ^ device_build.SIGN for n, p in (
        ("aggregate", part), ("aggregate padded", part_pad))}

    def counts_plain(lab, T):
        R, W = lab.shape
        rid = torch.arange(R, device=dev).repeat_interleave(W)
        counts = score.counts_from_hits_plain(lab.view(-1), rid, R, T)
        return (counts,) + score.read_results_plain(counts)

    def flat_bins(lab, T):
        """The [R, T+1] counts' flat bin of every window, for bincount."""
        R, W = lab.shape
        rid = torch.arange(R, device=dev).repeat_interleave(W)
        return rid * (T + 1) + lab.view(-1).long(), R * (T + 1)

    qf = q.view(-1)
    # the flat path's first batch: K9's queries, then K5's flat form over
    # its labels; the yardsticks search the carriers flipped once here
    fx = flat.index
    fk, fl = fx.keys, fx.labels1
    fq, fqr, fnb = flat_batch(flat, fa)
    flab = lookup.lookup_labels(fx, fq)
    search = _search_reads(fk, fq)
    directory = _directory_reads(fx, fq)
    # the directory's build, as the flat index's load runs it
    _sync(dev)
    t = time.perf_counter()
    lookup.build_index(fk, fl)
    _sync(dev)
    directory["build_s"] = time.perf_counter() - t
    fk_flip, fq_flip = fk ^ bits._SIGN, fq ^ bits._SIGN
    fids = fqr.long() * (T + 1) + flab.long()
    stash_bytes = _nbytes(tbl.stash_keys, tbl.stash_labels)
    # the 4-cycle split of the table: K7 against each chunk (chunk 0, which
    # carries the stash, is the one recorded), on the queries bucketed there
    rows_per = tbl.slots.shape[0] // 4
    b, qlow = radix_table._mix(qf, radix_table._MIX1_I64, tbl.m1)
    reads = {"probe": _probe_reads(tbl.slots, b, qlow, tbl.lb)}
    for i in range(4):
        sel = (b >= i * rows_per) & (b < (i + 1) * rows_per)
        reads[f"probe_chunk {i}"] = _probe_reads(tbl.slots, b[sel],
                                                 qlow[sel], tbl.lb)
    # K8: the config-2 table in the dense layout
    dt = dense.table
    b1, qlow1 = radix_table._mix(qf, radix_table._MIX1_I64, dt.m1)
    b2, qlow2 = radix_table._mix(qf, radix_table._MIX2_I64, dt.m2)
    reads["probe_dense plane 1"] = _probe_reads(dt.slots1, b1, qlow1, dt.lb)
    reads["probe_dense plane 2"] = _probe_reads(dt.slots2, b2, qlow2, dt.lb)
    bins = {T: flat_bins(lab, T), 65535: flat_bins(lab_big, 65535)}
    # K3's rows: (grid, n_targets, form); the main path's is "top2"
    top2_rows = {
        "top2": (lab, T, kernels.top2_form(T, pc)),
        "top2 hash": (lab, None, kernels.top2_form(None, pc)),
        "top2 T=65535": (lab_big, 65535, kernels.top2_form(65535, pc)),
        "top2 block T=65535": (lab_big, 65535, "block"),
    }
    Q = qf.shape[0]

    def chunk_fns(i):
        args = (tbl.slots[i * rows_per : (i + 1) * rows_per], tbl.stash_keys,
                tbl.stash_labels, qf, i * rows_per)
        kw = dict(m1=tbl.m1, lb=tbl.lb, use_stash=i == 0)
        return (lambda: radix_table.probe_chunk(*args, **kw),
                lambda: radix_table.probe_chunk_plain(*args, **kw))

    plain_reps = max(reps // 10, 1)
    # name: (kernel, plain twin, bytes read, operations, one library call
    # computing the same function or None).  Bytes count each input once
    # and the outputs are added from what the kernel returns.  A probe must
    # read its queries, the stash, and of each distinct row its queries
    # touch the hi half, plus one 32-B sector of lo words for each query
    # whose hi half matched (_probe_reads).  Operations count the probes'
    # hi and stash compares, a sort's n log2 n compares and one operation
    # per input element elsewhere.
    runs = {
        "window_canonicals": (
            lambda: device_pipeline.window_canonicals(w, v, k, pc),
            lambda: device_pipeline.window_canonicals_plain(w, v, k, pc),
            _nbytes(w, v), q.numel(), None,
        ),
        "probe": (
            lambda: radix_table.probe(tbl, qf),
            lambda: radix_table.probe_plain(tbl.slots, tbl.stash_keys,
                                            tbl.stash_labels, qf,
                                            m1=tbl.m1, lb=tbl.lb),
            _nbytes(qf) + reads["probe"]["bytes"] + stash_bytes,
            Q * (tbl.c + STASH), None,
        ),
        # K3 in the form each shape takes (top2_rows), and its parent's
        # block form on the 65,535-target grid; torch.mode computes the top
        # label alone, zeros counted
        **{name: (
            lambda g=g, t=t, f=f: top2_as(g, t, f),
            lambda g=g: score.top2_from_labels_plain(g),
            _nbytes(g), g.numel(), lambda g=g: torch.mode(g, dim=1),
        ) for name, (g, t, f) in top2_rows.items()},
        "sort_top2": (
            lambda: score.sort_top2(lab),
            lambda: score.sort_top2_plain(lab),
            _nbytes(lab), lab.numel(), lambda: torch.sort(lab, dim=1),
        ),
        "counts_top2": (
            lambda: score.counts_top2(lab, T),
            lambda: counts_plain(lab, T),
            _nbytes(lab), lab.numel(),
            lambda: torch.bincount(bins[T][0], minlength=bins[T][1]),
        ),
        "counts_top2 T=65535": (
            lambda: score.counts_top2(lab_big, 65535),
            lambda: counts_plain(lab_big, 65535),
            _nbytes(lab_big), lab_big.numel(),
            lambda: torch.bincount(bins[65535][0], minlength=bins[65535][1]),
        ),
        **{name: (
            lambda p=p: device_build._aggregate_device(*p),
            lambda p=p: device_build.aggregate_device_plain(*p),
            _nbytes(*p[:3]),
            p[0].shape[0] * max(p[0].shape[0].bit_length() - 1, 1),
            lambda name=name: torch.sort(sort_keys[name], stable=True),
        ) for name, p in (("aggregate", part), ("aggregate padded", part_pad))},
        "lookup": (
            lambda: lookup.lookup_labels(fx, fq),
            lambda: lookup.lookup_labels_dir_plain(fx, fq),
            # what the search needs whatever its design: the queries in, the
            # key sector of each distinct lower-bound position and a label
            # sector a hit (the labels out are added below), a compare a
            # query
            _nbytes(fq) + search["floor_bytes"], search["queries"],
            lambda: fl[torch.searchsorted(fk_flip, fq_flip).clamp_(
                max=fk.shape[0] - 1)],
        ),
        "counts_flat": (
            lambda: score.counts_flat(flab, fqr, fnb, T),
            lambda: (lambda c: (c,) + score.read_results_plain(c))(
                score.counts_from_hits_plain(flab, fqr, fnb, T)),
            # the labels and read ids in (the [R, T+1] counts and the five
            # [R] int32 results out are added below)
            _nbytes(flab, fqr),
            flab.numel() + fnb * T,
            lambda: torch.bincount(fids, minlength=fnb * (T + 1)),
        ),
        "probe_dense": (
            lambda: radix_table.probe_dense(dt, qf),
            lambda: radix_table.probe_dense_plain(
                dt.slots1, dt.slots2, dt.stash_keys, dt.stash_labels, qf,
                m1=dt.m1, m2=dt.m2, lb=dt.lb),
            _nbytes(qf) + reads["probe_dense plane 1"]["bytes"]
            + reads["probe_dense plane 2"]["bytes"] + stash_bytes,
            Q * (2 * dt.c + STASH), None,
        ),
    }
    for i in range(4):  # the recorded "probe_chunk" is chunk 0's
        r = reads[f"probe_chunk {i}"]
        runs["probe_chunk" + (f" chunk {i}" if i else "")] = (
            *chunk_fns(i),
            _nbytes(qf) + r["bytes"] + (stash_bytes if i == 0 else 0),
            r["queries"] * tbl.c + (Q * STASH if i == 0 else 0), None)
    out = {}
    for name, (kern, plain, nbytes, ops, library) in runs.items():
        got, want = kern(), plain()
        got = got if isinstance(got, tuple) else (got,)
        err = _same(name, got, want if isinstance(want, tuple) else [want])
        moved = nbytes + _nbytes(*got)
        bound_ms, bound_by = _bound(moved, ops)
        event_ms = _ms(kern, dev, reps)
        # a kernel's time is its device time in the trace: events around
        # the calls also count the wrappers' host work, 15-60 microseconds
        # a call, which outlasts a kernel of 0.02-0.04 ms
        device, retakes = (_device_split(kern, dev, reps)
                           if dev.type == "cuda" else ({}, 0))
        ms = sum(device.values()) if device else event_ms
        out[name] = dict(max_abs_err=err, ms=ms,
                         ms_from="trace" if device else "events",
                         retakes=retakes,
                         event_ms=event_ms,
                         plain_ms=_ms(plain, dev, plain_reps),
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None if library is None
                         else _ms(library, dev, reps),
                         achieved_bytes_per_s=moved / ms * 1e3)
        if name in ("probe_chunk", "probe", "probe_dense", "aggregate",
                    "aggregate padded"):
            # the passes of K7 (count, scatter, probe) on chunk 0, of K2 and
            # of K8 (count, tiles, scatter, grouped probe; K8 per plane) and
            # of K6 (range, hist, scan, scatter, the bucket pass, the
            # single-key reduction, the row flags' scan, compact)
            out[name]["pass_ms"] = device
    # the form each K3 row launched, and the form a row past the hash
    # form's tile takes
    wide = torch.from_numpy(np.random.default_rng(6).integers(
        0, 65536, size=(8, kernels.K3_TILE_W + 1)).astype(np.int32)).to(dev)
    top2_forms = {}
    for name, (g, t, f) in {**top2_rows, "top2 past the tile": (
            wide, 65535, kernels.top2_form(65535, wide.shape[1]))}.items():
        kernels.reset_launches()
        _same(name, top2_as(g, t, f), score.top2_from_labels_plain(g))
        top2_forms[name] = dict(shape=list(g.shape), form=f, launches={
            x: kernels.LAUNCHES[f"top2 {x}"] for x in kernels.TOP2_FORMS})
    # the miss mask between the probe and K3 (device_pipeline._masked):
    # glue on every path, timed by its device ops in the trace
    mask_bytes = _nbytes(q, hits) + _nbytes(lab)
    mask_ops, mask_retakes = (
        _device_split(lambda: device_pipeline._masked(q, hits), dev, reps)
        if dev.type == "cuda" else ({}, 0))
    mask_glue = dict(
        ms=sum(mask_ops.values()) if mask_ops else None, ops=mask_ops,
        retakes=mask_retakes,
        event_ms=_ms(lambda: device_pipeline._masked(q, hits), dev, reps),
        bytes=mask_bytes, bound_ms=_bound(mask_bytes, q.numel())[0])
    # side readings beside K9's bound: the bounds of what a binary search
    # of the whole key array visits and of what the directory design reads
    search["bound_ms"] = _bound(_nbytes(fq, flab) + search["bytes"],
                                search["compares"])[0]
    directory["bound_ms"] = _bound(
        _nbytes(fq, flab) + directory["bytes"] + 32 * search["label_sectors"],
        0)[0]
    # the record's K7 error covers every chunk of the split
    out["probe_chunk"]["max_abs_err"] = max(
        out["probe_chunk" + (f" chunk {i}" if i else "")]["max_abs_err"]
        for i in range(4))
    # K6's level plan on both partitions
    for name, p in (("aggregate", part), ("aggregate padded", part_pad)):
        stats = {}
        if dev.type == "cuda":
            kernels.aggregate(*p, stats=stats)
        else:
            device_build.aggregate_bucketed_plain(*p, stats=stats)
        out[name]["plan"] = stats
    e, tr, rb, tiles = kernels.window_run(pc)
    return out, dict(rows=len(idx), stride=stride, windows=pc,
                     k1_run=dict(E=e, runs_a_row=-(-pc // e),
                                 block=[rb, tr], grid=[-(-len(idx) // rb),
                                                       tiles]),
                     sort_form=kernels.sort_form(pc),
                     top2_forms=top2_forms,
                     mask_glue=mask_glue,
                     sass=sass_counts(kernels.library_path())
                     if dev.type == "cuda" else None,
                     queries=len(idx) * pc, targets=T, dense_rows=dense_rows,
                     partition_entries=part[0].shape[0],
                     padded_partition_entries=part_pad[0].shape[0],
                     chunk_rows=rows_per,
                     chunk_bins=kernels.chunk_bins(rows_per, tbl.c),
                     counts_forms={t: kernels.counts_form(t + 1, pc)
                                   for t in (T, 65535)},
                     probe_reads=reads, dense_m1_m2=[dt.m1, dt.m2],
                     flat_batch=dict(reads=fnb, queries=int(fq.numel()),
                                     index_keys=int(fk.shape[0]),
                                     targets=T, search=search,
                                     directory=directory),
                     retakes=dict(
                         {name: t["retakes"] for name, t in out.items()},
                         mask=mask_retakes),
                     probe_bins=kernels.group_bins(1 << tbl.m1),
                     dense_bins=[kernels.group_bins(1 << dt.m1),
                                 kernels.plane2_form(dt.m2, dt.c)])


# ------------------------------------------------------------------ main
# --------------------------------------------------------------- phase 6
GOLD_FIX = os.path.join(GOLD, "fixtures")
TOOL_GOLDENS = (
    # (CLI arguments, files compared: (written, golden))
    (["abundance", "-D", "{fix}/db", "-F", "{fix}/res1.csv", "-o", "a.csv"],
     [("a.csv", "abundance_default.csv")]),
    (["abundance", "-D", "{fix}/db", "-F", "{fix}/res1.csv", "{fix}/res2.csv",
      "-o", "b.csv", "--krona", "--mpa"],
     [("b.csv", "abundance_two_files.csv"), ("results.krn", "golden.krn"),
      ("results.mpa", "golden.mpa")]),
    (["abundance", "-D", "{fix}/db", "-F", "{fix}/res1.csv", "--hc", "-o",
      "c.csv"], [("c.csv", "abundance_hc.csv")]),
    (["abundance", "-F", "{fix}/res1.csv", "-o", "d.csv"],
     [("d.csv", "abundance_notax.csv")]),
    (["abundance", "-D", "{fix}/db", "-F", "{fix}/res1.csv", "-a", "20",
      "-o", "e.csv"], [("e.csv", "abundance_minab.csv")]),
    (["merge", "{gold}/abundance_default.csv",
      "{gold}/abundance_two_files.csv", "-o", "merged.csv"],
     [("merged.csv", "merged.csv")]),
    (["report", "{gold}/merged.csv", "-o", "report.txt"],
     [("report.txt", "report.txt")]),
)


def write_toy_taxonomy(td: str, n_species: int):
    """NCBI-format nodes.dmp/names.dmp covering taxids 1000..1000+n-1 (a
    copy of bench.py's config-3 taxonomy): species i in genus 200 + i // 4,
    one family, order, class and phylum, in Bacteria."""
    tax = os.path.join(td, "taxonomy")
    os.makedirs(tax, exist_ok=True)
    nodes = [
        (1, 1, "no rank"), (2, 1, "superkingdom"), (100, 2, "phylum"),
        (110, 100, "class"), (120, 110, "order"), (130, 120, "family"),
    ]
    names = [
        (1, "root"), (2, "Bacteria"), (100, "Synthphyla"),
        (110, "Synthclassia"), (120, "Synthorder"), (130, "Synthaceae"),
    ]
    for i in range(n_species):
        genus = 200 + i // 4
        nodes.append((genus, 130, "genus"))
        names.append((genus, f"Synthgenus{i // 4}"))
    for i in range(n_species):
        nodes.append((1000 + i, 200 + i // 4, "species"))
        names.append((1000 + i, f"Synthspecies {i}"))
    with open(os.path.join(tax, "nodes.dmp"), "w") as f:
        for tid, parent, rank in dict.fromkeys(nodes):
            f.write(f"{tid}\t|\t{parent}\t|\t{rank}\t|\tXX\t|\n")
    with open(os.path.join(tax, "names.dmp"), "w") as f:
        for tid, nm in dict.fromkeys(names):
            f.write(f"{tid}\t|\t{nm}\t|\t\t|\tscientific name\t|\n")


def cli_layout(td: str, genome_dir: str, n_genomes: int):
    """A reference-layout database directory of make_genomes' genomes in
    genome_dir, as `db set-targets` reads it: Custom/ links the genomes,
    taxonomy/ holds the toy tree (genome i species 1000 + i), the other
    dumps (empty) and an accession map."""
    os.makedirs(os.path.join(td, "Custom"))
    for i in range(n_genomes):
        os.symlink(os.path.join(genome_dir, f"g{i}.fa"),
                   os.path.join(td, "Custom", f"g{i}.fa"))
    write_toy_taxonomy(td, n_genomes)
    tax = os.path.join(td, "taxonomy")
    for fn in database.TAXONOMY_FILES:
        open(os.path.join(tax, fn), "a").close()
    with open(os.path.join(tax, "nucl_accss"), "w") as f:
        f.writelines(f"g{i}\tg{i}.1\t{1000 + i}\t{i}\n"
                     for i in range(n_genomes))


def tools_layout(td: str, scale_dir: str, n_genomes: int, prof: Profile):
    """cli_layout over phase 4's genomes, and a config.json that names
    phase 4's targets file and DB directory."""
    cli_layout(td, scale_dir, n_genomes)
    database.DBConfig(
        db_dir=td, targets=os.path.join(scale_dir, "targets.txt"),
        subdb=scale_dir, rank=0, profile_name=prof.name, k=prof.default_k,
        gap=prof.default_gap, min_count_target=0, htsize=prof.htsize,
        light=prof.light).save()


def _cli(*argv) -> tuple[int, str]:
    """(exit code, stdout) of one command of the port's CLI."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    return rc, buf.getvalue()


def _abundance_counts(path: str) -> dict:
    """{TaxID: Count} of an abundance CSV with a Lineage column (the
    UNKNOWN row under "UNKNOWN")."""
    with open(path) as f:
        rows = [line.split(",") for line in f.read().splitlines()[1:]]
    return {r[1]: int(r[3]) for r in rows}


def _tally(csv_path: str) -> dict:
    """{Assignment: reads} over a classification CSV's admissible rows
    (Confidence >= 0.5, Gamma >= 0), the rows abundance counts."""
    out = {}
    with open(csv_path) as f:
        for line in f.read().splitlines()[1:]:
            _, gamma, lbl, _, conf = line.split(",")
            if lbl != "NA" and float(conf) >= 0.5 and float(gamma) >= 0:
                out[lbl] = out.get(lbl, 0) + 1
    return out


def _busy_share(fn, dev) -> float:
    """Device-busy share of one call of fn: the device time of the kernels
    and copies in torch.profiler's trace over the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t
    busy_us = sum(getattr(e, "self_device_time_total", 0)
                  for e in prof.key_averages())
    return busy_us / 1e6 / wall


def _expected_counts(expect) -> dict:
    out = {}
    for e in expect:
        if e != b"NA":
            out[e.decode()] = out.get(e.decode(), 0) + 1
    return out


def run_tools(dev, tmp: str, clf: Classifier, scale_dir: str, n_genomes: int,
              prof: Profile, launches: dict, n_c3: int = 20_000,
              c4_samples: int = 8, n_c4: int = 8_000, seed: int = 11):
    """Phase 6: the tools on phase 4's DB and Classifier.  `verify --db`;
    bench.py config 3 (n_c3 reads of 150 bp, 30% random, classified, then
    `abundance -D --krona --mpa`); bench.py config 4 (c4_samples samples of
    n_c4 reads of 150 bp, 20% random, classify_files(jobs=4), an
    `abundance -D` each, `merge`, `report`); abundance, merge and report
    on tests/golden/fixtures byte-equal to the nine goldens.  Every count
    exact.  Returns metrics."""
    m = {}
    td = os.path.join(tmp, "tools")
    tools_layout(td, scale_dir, n_genomes, prof)
    genomes = []
    for i in range(n_genomes):
        with open(os.path.join(scale_dir, f"g{i}.fa"), "rb") as f:
            genomes.append(np.frombuffer(f.read().split(b"\n")[1], np.uint8))

    # verify on the command's default device (cuda) on the card
    device = [] if dev.type == "cuda" else ["--device", dev.type]
    (rc, out), m["verify_s"] = _path(
        launches, "verify", lambda: _cli("verify", "--db", td, *device))
    lines = out.splitlines()
    if rc != 0 or lines[-1] != "STATUS: READY" or not any(
            line.startswith("  [OK]   device pipeline (K1, K2, K3 on "
                            f"{dev.type}") for line in lines) or not any(
            line.startswith("  [OK]   database files:") for line in lines):
        raise AssertionError(f"verify: rc {rc}\n{out}")
    m["verify"] = [line.strip() for line in lines[1:]]

    # bench.py config 3: classify, then abundance with Krona and MPA
    fa, _, expect = make_reads(np.random.default_rng(seed), genomes, n_c3,
                               read_len=150, junk_p=0.3)
    reads, res = os.path.join(td, "c3_reads.fa"), os.path.join(td, "c3_res")
    with open(reads, "wb") as f:
        f.write(fa)
    stats, m["c3_classify_s"] = _path(launches, "tools config 3",
                                      lambda: clf.classify_file(reads, res))
    t = time.perf_counter()
    with contextlib.chdir(td):  # results.krn and results.mpa go here
        rc, _ = _cli("abundance", "-D", td, "-F", res + ".csv", "--krona",
                     "--mpa", "-o", "c3_abundance.csv")
    m["c3_abundance_s"] = time.perf_counter() - t
    m["c3_pipeline_s"] = m["c3_classify_s"] + m["c3_abundance_s"]
    check_csv(res + ".csv", expect)
    counts = _abundance_counts(os.path.join(td, "c3_abundance.csv"))
    want = _expected_counts(expect)
    if rc or stats["reads"] != n_c3 or {
            k: v for k, v in counts.items() if k != "UNKNOWN"} != want:
        raise AssertionError(f"config 3: abundance {counts} != reads drawn "
                             f"{want}")
    if _tally(res + ".csv") != want or counts["UNKNOWN"] != n_c3 - sum(
            want.values()):
        raise AssertionError("config 3: abundance != the CSV's tally")
    for fn in ("results.krn", "results.mpa"):
        if os.path.getsize(os.path.join(td, fn)) == 0:
            raise AssertionError(f"config 3: {fn} is empty")
    m["c3_reads"], m["c3_taxa"] = n_c3, len(want)

    def pipeline():
        clf.classify_file(reads, res + "_traced")
        with contextlib.chdir(td):
            _cli("abundance", "-D", td, "-F", res + "_traced.csv", "-o",
                 "c3_traced_abundance.csv")

    if dev.type == "cuda":  # a traced run of its own
        m["c3_device_busy_share"] = _busy_share(pipeline, dev)

    # bench.py config 4: samples classified 4 at a time, an abundance
    # each, merged, reported
    items, wants = [], []
    for s in range(c4_samples):
        fa, _, expect = make_reads(np.random.default_rng(seed + 1 + s),
                                   genomes, n_c4, read_len=150, junk_p=0.2)
        path = os.path.join(td, f"c4_s{s}.fa")
        with open(path, "wb") as f:
            f.write(fa)
        items.append((path, None, os.path.join(td, f"c4_res{s}")))
        wants.append((expect, _expected_counts(expect)))
    t = time.perf_counter()
    _, m["c4_classify_s"] = _path(launches, "tools config 4",
                                  lambda: clf.classify_files(items, jobs=4))
    abs_ = []
    for _, _, res in items:
        abs_.append(res + "_abundance.csv")
        if _cli("abundance", "-D", td, "-F", res + ".csv", "-o",
                abs_[-1])[0]:
            raise AssertionError(f"config 4: abundance of {res} failed")
    merged = os.path.join(td, "c4_merged.csv")
    if _cli("merge", *abs_, "-o", merged)[0]:
        raise AssertionError("config 4: merge failed")
    m["c4_batch_s"] = time.perf_counter() - t
    report = os.path.join(td, "c4_report.txt")
    if _cli("report", merged, "-o", report)[0]:
        raise AssertionError("config 4: report failed")
    total = {}
    for (_, _, res), ab, (expect, want) in zip(items, abs_, wants):
        check_csv(res + ".csv", expect)
        counts = _abundance_counts(ab)
        if {k: v for k, v in counts.items() if k != "UNKNOWN"} != want:
            raise AssertionError(f"config 4: {ab} != reads drawn")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    if _abundance_counts(merged) != total:
        raise AssertionError("config 4: merged counts != sums over samples")
    with open(report) as f:
        rep = f.read().splitlines()
    if rep[0] != "RESULT" or len(rep) != 2 + n_genomes:
        raise AssertionError(f"config 4: report {rep[:3]}")
    m["c4_samples"], m["c4_reads"] = c4_samples, c4_samples * n_c4

    # the label-range check's host seconds on this DB (it runs in every
    # Classifier load): a min/max over the .lb labels, and the label field
    # of the table in the .idx cache (the check where labels are absent)
    stem = os.path.join(scale_dir, prof.db_stem(prof.default_k, n_genomes, 0,
                                                prof.default_gap))
    _, labels = dbformat.read_db(stem, prof, prof.default_k)
    t = time.perf_counter()
    _check_label_range(labels, None, n_genomes)
    m["label_check_lb_s"] = time.perf_counter() - t
    table = radix_table.load_cache(stem + ".idx.npz")
    t = time.perf_counter()
    _check_label_range((), table, n_genomes)
    m["label_check_cached_table_s"] = time.perf_counter() - t
    m["label_check_table_bytes"] = table.slots.nbytes
    del labels, table

    # the byte goldens through the CLI (the native scan built here)
    gd = os.path.join(td, "goldens")
    os.makedirs(gd)
    n = 0
    with contextlib.chdir(gd):
        for argv, files in TOOL_GOLDENS:
            rc, _ = _cli(*(a.format(fix=GOLD_FIX, gold=GOLD) for a in argv))
            for written, golden in files:
                with open(written, "rb") as a, open(
                        os.path.join(GOLD, golden), "rb") as b:
                    if rc or a.read() != b.read():
                        raise AssertionError(f"{golden}: not byte-equal")
                n += 1
    m["goldens_byte_equal"] = n
    return m


# --------------------------------------------------------------- phase 7
def cli_child(out_dir: str, argv: list) -> int:
    """One process of the CLI for phases 7 and 8: `clark-torch <argv>` in
    this process (argv names --device), with its kernel launches, phase
    timers (all_reduce: calls, bytes, seconds), Classifier loads (seconds,
    bytes of its table rows) and a cluster's NodeResults written to
    <out_dir>/p<process id>.json.  Run as `chip_smoke.py cli-child
    <out_dir> cluster ...` (or `classify ...`)."""
    from jn_cuclark_tpu_torch import cluster, engine
    from jn_cuclark_tpu_torch.parallel import dist

    pid = int(os.environ.get("CLARK_TPU_PROCESS_ID", "0"))
    rec = dict(pid=pid, loads=[], results=[], backend=dist.backend_for(
        argv[argv.index("--device") + 1]))
    load = engine.Classifier.load.__func__

    def timed_load(cls, *a, **kw):
        t = time.perf_counter()
        clf = load(cls, *a, **kw)
        rec["loads"].append(dict(
            seconds=time.perf_counter() - t,
            table_bytes=(clf.sharded.local_bytes if clf.sharded is not None
                         else clf.table.nbytes)))
        return clf

    def keep(fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            for r in out if isinstance(out, list) else [out]:
                rec["results"].append(dataclasses.asdict(r))
            return out
        return run

    engine.Classifier.load = classmethod(timed_load)
    cluster.run_node = keep(cluster.run_node)
    cluster.run_sharded = keep(cluster.run_sharded)
    kernels.reset_launches()
    t = time.perf_counter()
    with profiling.collect() as ph:
        rc = cli.main(argv)
    rec.update(rc=rc, wall_s=time.perf_counter() - t,
               launches=dict(kernels.LAUNCHES), phase_s=dict(ph.totals),
               phase_calls=dict(ph.counts), phase_bytes=dict(ph.nbytes))
    with open(os.path.join(out_dir, f"p{pid}.json"), "w") as f:
        json.dump(rec, f)
    return rc


CLUSTER_TIMEOUT_S = 600  # one phase-7 cluster run, its loads included


def _cluster_procs(argvs, envs) -> list:
    """Start the processes (each in a session of its own), wait for all;
    past CLUSTER_TIMEOUT_S, or on any error, kill every process they
    started.  Returns [(rc, stdout + stderr)]."""
    import signal

    procs = [subprocess.Popen(a, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              start_new_session=True)
             for a, e in zip(argvs, envs)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=CLUSTER_TIMEOUT_S)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(p.pid, signal.SIGKILL)
    return outs


def _cluster_env(**values) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith(
        ("CLARK_TPU_NUM_PROCESSES", "CLARK_TPU_PROCESS_ID",
         "CLARK_TPU_COORDINATOR", "CLARK_TPU_NODE_NAME",
         "CLARK_TPU_DIST_BACKEND"))}
    env["GLOO_SOCKET_IFNAME"] = "lo"  # a world on this host's loopback
    env.update({k: str(v) for k, v in values.items()})
    return env


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cluster_conf(work: str, database: str, reads: dict,
                  classification: str = "", extra: str = "") -> str:
    """A cluster config of master nodeA and worker nodeB on 127.0.0.1."""
    os.makedirs(work)
    port = _free_port()
    lines = "\n".join(f"{h} = {', '.join(ps)}" for h, ps in reads.items())
    conf = os.path.join(work, "cluster.conf")
    with open(conf, "w") as f:
        f.write(f"""[cluster]
master = nodeA
workers = nodeB
backend = jax_distributed
coordinator_address = 127.0.0.1:{port}
report_port = {_free_port()}
{extra}

[paths]
cuclark_dir = {work}
database = {database}
results_dir = results

[classification]
{classification}

[reads]
{lines}
""")
    return conf


def _cluster_record(name: str, work: str, launches: dict, n_procs: int,
                    rates: dict) -> dict:
    """Phase 7's record of one path from its processes' JSON files: the
    launches summed over them (under `name`), each process's wall, load
    seconds, table bytes, phase timers and all_reduce calls, bytes and
    seconds, and the rate of each node (its reads, or pairs, over the
    NodeResult seconds of the lowest process that ran it)."""
    recs = []
    for pid in range(n_procs):
        with open(os.path.join(work, "out", f"p{pid}.json")) as f:
            recs.append(json.load(f))
    launches[name] = {k: sum(r["launches"][k] for r in recs)
                      for k in kernels.LAUNCHES}
    # a node's NodeResult from the lowest process that ran it: rank 0 on
    # the sharded paths, its own process on the sample-parallel one
    nodes = {r["hostname"]: r for rec in recs[::-1] for r in rec["results"]}
    for r in nodes.values():
        if not r["success"]:
            raise AssertionError(f"{name}: {r['hostname']} failed: "
                                 f"{r['error_message']}")
    return dict(
        path=name, backend=recs[0]["backend"],
        processes=[dict(pid=r["pid"], wall_s=r["wall_s"],
                        load_s=[x["seconds"] for x in r["loads"]],
                        table_bytes=[x["table_bytes"] for x in r["loads"]],
                        all_reduce=dict(
                            calls=r["phase_calls"].get("all_reduce", 0),
                            bytes=r["phase_bytes"].get("all_reduce", 0),
                            seconds=r["phase_s"].get("all_reduce", 0.0)),
                        phase_s=r["phase_s"])
                   for r in recs],
        nodes={h: {unit: nodes[h]["reads"] / nodes[h]["elapsed_seconds"],
                   "elapsed_s": nodes[h]["elapsed_seconds"],
                   "reads": nodes[h]["reads"]}
               for h, unit in rates.items()})


def _same_file(what: str, got: str, want: str):
    with open(got, "rb") as a, open(want, "rb") as b:
        if a.read() != b.read():
            raise AssertionError(f"{what}: {got} differs from {want}")


def _nodes_ok(work: str, n: int):
    with open(os.path.join(work, "results", "cluster_report.txt")) as f:
        report = f.read()
    if f"Nodes processed: {n}/{n}" not in report:
        raise AssertionError(f"{work}: the report says\n{report}")


def run_cluster(dev, tmp: str, scale_dir: str, tools_dir: str,
                golden_dir: str, launches: dict) -> dict:
    """Phase 7: the cluster command (cluster.py) in processes of this
    script (`cli_child`) on `dev`'s kind, each path's CSVs byte-equal
    to their references: (a) sample-parallel, `cluster --launch` of two
    processes through an ssh stub, phase 6's config-4 samples 0 and 1, one
    a host, against phase 6's CSVs, abundances and their merge; (b)
    DB-sharded, two processes with CLARK_TPU_DIST_BACKEND=gloo, phase 4's
    reads and pairs against phase 4's CSVs; (c) one process, a world of
    one over the device's own backend (NCCL on the card), shard_db on
    phase 3's golden DB and reads, against tests/golden.  A DB-sharded
    run in cycles (its own 48M-key load) is left to the CPU tests
    (tests/test_torch_cluster.py), to keep the script's time.  Returns
    each path's record (_cluster_record)."""
    from jn_cuclark_tpu_torch import abundance

    device = dev.type
    me = [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
          "cli-child"]
    m = {}

    def world(name, conf, n, **env):
        work = os.path.dirname(conf)
        os.makedirs(os.path.join(work, "out"))
        outs = _cluster_procs(
            [me + [os.path.join(work, "out"), "cluster", "-c", conf,
                   "--device", device]] * n,
            [_cluster_env(CLARK_TPU_NUM_PROCESSES=n, CLARK_TPU_PROCESS_ID=i,
                          CLARK_TPU_NODE_NAME=("nodeA", "nodeB")[i], **env)
             for i in range(n)])
        for rc, out in outs:
            if rc:
                raise AssertionError(f"{name}: rc {rc}\n{out[-3000:]}")

    # (a) sample-parallel through `cluster --launch` and an ssh stub
    work = os.path.join(tmp, "cluster_a")
    stub = os.path.join(tmp, "fakessh")
    with open(stub, "w") as f:
        f.write("#!/bin/sh\nshift\nexec sh -c \"$*\"\n")
    os.chmod(stub, 0o755)
    samples = [os.path.join(tools_dir, f"c4_s{s}.fa") for s in range(2)]
    out_dir = os.path.join(work, "out")
    conf = _cluster_conf(
        work, tools_dir, {"nodeA": [samples[0]], "nodeB": [samples[1]]},
        extra=f"ssh_command = {stub}\nlaunch_command = "
              f"{' '.join(me)} {out_dir}")
    os.makedirs(out_dir)
    ((rc, out),) = _cluster_procs(
        [[sys.executable, "-m", "jn_cuclark_tpu_torch.cli", "cluster", "-c",
          conf, "--launch", "--device", device]],
        [_cluster_env(PYTHONPATH=ROOT)])
    if rc:
        raise AssertionError(f"cluster --launch: rc {rc}\n{out[-3000:]}")
    _nodes_ok(work, 2)
    res = os.path.join(work, "results")
    for s, host in enumerate(("nodeA", "nodeB")):
        _same_file("sample-parallel", os.path.join(res, f"{host}_c4_s{s}.csv"),
                   os.path.join(tools_dir, f"c4_res{s}.csv"))
        _same_file("sample-parallel",
                   os.path.join(res, f"{host}_abundance.csv"),
                   os.path.join(tools_dir, f"c4_res{s}_abundance.csv"))
    merged = os.path.join(work, "merged.csv")
    abundance.merge([os.path.join(tools_dir, f"c4_res{s}_abundance.csv")
                     for s in range(2)], merged)
    _same_file("sample-parallel", os.path.join(res, "cluster_abundance.csv"),
               merged)
    m["sample-parallel"] = _cluster_record(
        "cluster sample-parallel", work, launches, 2,
        {"nodeA": "reads_per_s", "nodeB": "reads_per_s"})

    # (b) DB-sharded, resident, over gloo
    reads = os.path.join(scale_dir, "reads.fa")
    mates = [os.path.join(scale_dir, f"r{i}.fq") for i in (1, 2)]
    work = os.path.join(tmp, "cluster_b")
    conf = _cluster_conf(work, tools_dir, {"nodeA": [reads], "nodeB": mates},
                         "shard_db = true")
    world("sharded", conf, 2, CLARK_TPU_DIST_BACKEND="gloo")
    _nodes_ok(work, 2)
    res = os.path.join(work, "results")
    _same_file("sharded", os.path.join(res, "nodeA_reads.csv"),
               os.path.join(scale_dir, "res.csv"))
    _same_file("sharded", os.path.join(res, "nodeB_r1.csv"),
               os.path.join(scale_dir, "res_pair.csv"))
    m["sharded"] = _cluster_record(
        "cluster sharded", work, launches, 2,
        {"nodeA": "reads_per_s", "nodeB": "pairs_per_s"})

    # (c) a world of one over the device's backend (NCCL on the card)
    _, _, _, prof, k, greads, _, _, golden = GOLDENS[0]
    write_toy_taxonomy(golden_dir, 4)  # the golden targets' taxids 1001-1003
    database.DBConfig(
        db_dir=golden_dir, targets=os.path.join(golden_dir, "targets.txt"),
        subdb=os.path.join(golden_dir, "db"), rank=0, profile_name=prof.name,
        k=k, gap=prof.default_gap, min_count_target=0, htsize=prof.htsize,
        light=prof.light).save()
    work = os.path.join(tmp, "cluster_d")
    conf = _cluster_conf(work, golden_dir,
                         {"nodeA": [os.path.join(GOLD, greads)]},
                         "shard_db = true")
    with open(conf) as f:
        text = f.read().replace("workers = nodeB", "workers =")
    with open(conf, "w") as f:
        f.write(text)
    world("sharded one process", conf, 1)
    _same_file("sharded one process",
               os.path.join(work, "results", "nodeA_reads.csv"),
               os.path.join(GOLD, golden))
    m["sharded one process"] = _cluster_record(
        "cluster sharded one process", work, launches, 1,
        {"nodeA": "reads_per_s"})
    return m


# --------------------------------------------------------------- phase 8
# the kernel names of K1, K2 and K3's small form that a traced classify on
# the card must show
TRACE_KERNELS = ("window_canonicals_kernel", "group_probe_kernel",
                 "top2_small_kernel")


def _device_bytes(clf: Classifier) -> int:
    """Device bytes of a flat classifier's sorted keys, labels and radix
    directory (every block's on a mesh)."""
    blocks = clf.index if isinstance(clf.index, list) else [clf.index]
    return _nbytes(*(t for ix in blocks
                     for t in (ix.keys, ix.labels1, ix.offsets)))


def flat_child(out_dir: str, spec: str) -> int:
    """One process of phase 8 (c): joins the world (parallel/dist.py, from
    the CLARK_TPU_* variables), loads the flat path (packed=False) on a
    process mesh of this process's card repeated once an entry of the
    spec's owners, classifies each of the spec's runs and writes
    <out_dir>/p<rank>.json: its load seconds, the blocks and the index
    bytes it holds on the card, and each run's reads, wall seconds, kernel
    launches and phase timers (all_reduce: calls, bytes, seconds).  Run as
    `chip_smoke.py flat-child <out_dir> <spec JSON>`; each run's CSV goes
    to its `out` with `_r<rank>` added."""
    from jn_cuclark_tpu_torch.parallel import dist

    spec = json.loads(spec)
    backend = dist.initialize(device=spec["device"])
    rank = dist.process_index()
    owners = spec["owners"]
    mesh = Mesh([dist.local_device(spec["device"])] * len(owners), ("db",),
                owners=owners)
    t = time.perf_counter()
    clf = Classifier.load(spec["db"], spec["targets"],
                          Profile(**spec["profile"]), spec["k"],
                          packed=False, mesh=mesh)
    rec = dict(pid=rank, backend=backend, load_s=time.perf_counter() - t,
               blocks=len(clf.index), device_bytes=_device_bytes(clf),
               runs=[])
    for run in spec["runs"]:
        kernels.reset_launches()
        with profiling.collect() as ph:
            t = time.perf_counter()
            stats = clf.classify_file(run["reads"], f"{run['out']}_r{rank}",
                                      paired_path=run["mate"],
                                      extended=run["extended"])
            wall = time.perf_counter() - t
        rec["runs"].append(dict(
            path=run["path"], reads=stats["reads"], wall_s=wall,
            launches=dict(kernels.LAUNCHES), phase_s=dict(ph.totals),
            phase_calls=dict(ph.counts), phase_bytes=dict(ph.nbytes)))
    dist.shutdown()
    with open(os.path.join(out_dir, f"p{rank}.json"), "w") as f:
        json.dump(rec, f)
    return 0


def run_flat_processes(dev, tmp: str, prof: Profile, launches: dict,
                       golden_dir: str) -> dict:
    """Phase 8 (c): the flat path on process meshes, in processes of this
    script (`flat_child`): (c1) two ranks over gloo, a mesh of `dev` 4
    times with owners [0, 0, 1, 1], on phase 4's DB and reads in tmp,
    plain and --extended against phase 4's CSVs; (c2) a world of one
    over the device's own backend (NCCL on the card) on phase 3's golden
    DB in golden_dir and its reads, against tests/golden.  Every rank's
    CSV must equal its reference.  Records launches under each path's
    name (summed over ranks and runs) and returns each path's record:
    each process's load seconds, blocks, index bytes on the card, and
    each run's reads/s and all_reduce calls, bytes and seconds."""
    me = [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "flat-child"]
    m = {}

    def world(name, n, spec, **env):
        work = os.path.join(tmp, name.replace(" ", "_"))
        os.makedirs(work)
        port = _free_port()
        outs = _cluster_procs(
            [me + [work, json.dumps(dict(spec, device=dev.type))]] * n,
            [_cluster_env(CLARK_TPU_NUM_PROCESSES=n, CLARK_TPU_PROCESS_ID=i,
                          CLARK_TPU_COORDINATOR=f"127.0.0.1:{port}", **env)
             for i in range(n)])
        for rc, out in outs:
            if rc:
                raise AssertionError(f"{name}: rc {rc}\n{out[-3000:]}")
        recs = []
        for pid in range(n):
            with open(os.path.join(work, f"p{pid}.json")) as f:
                recs.append(json.load(f))
        for run in spec["runs"]:
            for pid in range(n):
                _same_file(name, f"{run['out']}_r{pid}.csv", run["want"])
        for path in dict.fromkeys(run["path"] for run in spec["runs"]):
            launches[path] = {k: sum(r["launches"][k] for rec in recs
                                     for r in rec["runs"]
                                     if r["path"] == path)
                              for k in kernels.LAUNCHES}
        m[name] = dict(path=name, backend=recs[0]["backend"], processes=[
            dict(pid=rec["pid"], load_s=rec["load_s"], blocks=rec["blocks"],
                 device_bytes=rec["device_bytes"], runs=[dict(
                     path=r["path"], reads=r["reads"], wall_s=r["wall_s"],
                     reads_per_s=r["reads"] / r["wall_s"],
                     all_reduce=dict(
                         calls=r["phase_calls"].get("all_reduce", 0),
                         bytes=r["phase_bytes"].get("all_reduce", 0),
                         seconds=r["phase_s"].get("all_reduce", 0.0)),
                     batches=r["phase_calls"].get("dispatch", 0),
                     launches={k: c for k, c in r["launches"].items() if c},
                     phase_s=r["phase_s"]) for r in rec["runs"]])
            for rec in recs])
        print(json.dumps(m[name]), flush=True)

    # (c1) two ranks over gloo on the card, two blocks each
    runs = [dict(path=path, reads=os.path.join(tmp, "reads.fa"), mate=None,
                 extended=bool(suffix),
                 out=os.path.join(tmp, f"flat_proc{suffix}"),
                 want=os.path.join(tmp, f"res{suffix}.csv"))
            for path, suffix in (("host flat processes", ""),
                                 ("host flat processes extended", "_ext"))]
    world("host flat processes", 2, dict(
        owners=[0, 0, 1, 1], db=tmp, targets=os.path.join(tmp, "targets.txt"),
        profile=dataclasses.asdict(prof), k=prof.default_k, runs=runs),
        CLARK_TPU_DIST_BACKEND="gloo")
    # (c2) a world of one over the device's backend, phase 3's golden DB
    _, _, _, gprof, k, *_ = GOLDENS[0]
    runs = [dict(path="host flat one process", reads=os.path.join(GOLD, r),
                 mate=mate and os.path.join(GOLD, mate), extended=ext,
                 out=os.path.join(tmp, f"flat_one_{i}"),
                 want=os.path.join(GOLD, golden))
            for i, (db, _, _, _, _, r, mate, ext, golden) in enumerate(
                GOLDENS) if db == GOLDENS[0][0]]
    world("host flat one process", 1, dict(
        owners=[0], db=os.path.join(golden_dir, "db"),
        targets=os.path.join(golden_dir, "targets.txt"),
        profile=dataclasses.asdict(gprof), k=k, runs=runs))
    return m


def _head(path: str, n: int, out: str) -> str:
    """The first n records of a two-line-per-record FASTA, written to out."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n", 2 * n)[:-1]
    with open(out, "wb") as f:
        f.write(b"\n".join(lines) + b"\n")
    return out


def _trace_kernels(trace_dir: str) -> tuple[int, int, set]:
    """(trace files, events, kernel names) of the Chrome traces in a
    directory."""
    traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)
              if f.endswith(".json")]
    events = [e for f in traces for e in json.load(open(f))["traceEvents"]]
    return len(traces), len(events), [e["name"] for e in events
                                      if e.get("cat") == "kernel"]


TRACE_BURST = 200  # kernels launched at once inside a trace


def _trace_events(trace_dir: str) -> list:
    """The events of the Chrome traces in a directory."""
    return [e for f in os.listdir(trace_dir) if f.endswith(".json")
            for e in json.load(open(os.path.join(trace_dir, f)))[
                "traceEvents"]]


def _burst_kept(trace_dir: str, n: int = TRACE_BURST) -> dict:
    """A burst, the last n kernel launches of the Chrome traces in a
    directory: how many of its kernels were kept, and how many of its
    launches before the first kept kernel and after the last were lost
    (launch order is the runtime calls')."""
    events = _trace_events(trace_dir)
    return profiling.span_kept(profiling.launches(events)[-n:],
                               profiling.kept_kernels(events))


TRACE_RETAKES = 3  # phase 8's traced burst: sessions taken again


def trace_burst(dev, tmp: str) -> dict:
    """TRACE_BURST small kernels launched at once inside a bare
    torch.profiler session, which opens right before them and closes
    right after they finish, then inside `profiling.trace` (its warm-up
    before, its closing markers after): how many of each burst reach the
    trace, and how many were lost before the first kept and after the
    last.  The traced session is taken again, up to TRACE_RETAKES times,
    where profiling.check_session finds it not whole; a session it finds
    whole must hold the whole burst."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1024, device=dev)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_BURST):
            x.add_(1)
        torch.cuda.synchronize(dev)
    bare = os.path.join(tmp, "burst_bare")
    os.makedirs(bare, exist_ok=True)
    prof.export_chrome_trace(os.path.join(bare, "t.json"))
    b = _burst_kept(bare)
    lost = []
    for take in range(TRACE_RETAKES + 1):
        with profiling.trace(os.path.join(tmp, f"burst_trace{take}"),
                             cuda=True) as g:
            for _ in range(TRACE_BURST):
                x.add_(1)
        if g["whole"]:
            break
        lost.append(g)
    if g["whole"] and g["kept"] != TRACE_BURST:
        raise AssertionError(f"trace burst: a session checked whole kept "
                             f"{g['kept']} of {TRACE_BURST}")
    return dict(launched=TRACE_BURST, bare_kept=b["kept"],
                bare_lost_first=b["lost_first"],
                bare_lost_last=b["lost_last"], trace_kept=g["kept"],
                trace_lost_first=g["lost_first"],
                trace_lost_last=g["lost_last"], trace_retakes=len(lost),
                trace_lost_sessions=lost)


def run_host_paths(dev, tmp: str, prof: Profile, flat: Classifier,
                   launches: dict, tools_dir: str, golden_dir: str,
                   mesh_n: int = 4, sub: int | None = None):
    """Phase 8: the flat sorted-array path (packed=False; `flat`, phase
    5's classifier) on phase 4's DB and reads, each CSV byte-equal to
    phase 4's (no warm-up runs): (a) plain and extended; (b) over a mesh
    of `dev` repeated mesh_n times, on the first `sub` reads where given
    (against the first `sub` rows of phase 4's CSV); (c) on process
    meshes (`run_flat_processes`; phase 3's golden DB in golden_dir), on
    every read.  (f) on the card,
    `trace_burst`, whose `profiling.trace` must keep every kernel; then
    `classify --trace-dir` on phase 6's config-3 reads, in this process
    (the kernels named recorded) and in a process of its own, whose trace
    must name K1's, K2's and K3's kernels on the card (be non-empty on the
    CPU); on the card each is taken again, up to TRACE_RETAKES times, until
    profiling.check_session finds its session whole; each CSV equals
    phase 6's.  Prints one JSON line a path; returns
    the metrics."""
    reads, res = os.path.join(tmp, "reads.fa"), os.path.join(tmp, "res")
    want = {}
    for kind, suffix in (("plain", ""), ("extended", "_ext")):
        with open(res + suffix + ".csv", "rb") as f:
            want[kind] = f.read()
    sub_reads = reads
    if sub is not None:
        sub_reads = _head(reads, sub, os.path.join(tmp, "reads_sub.fa"))
        want["sub"] = b"\n".join(
            want["plain"].split(b"\n", sub + 1)[:-1]) + b"\n"
    m = {"subset_reads": sub}

    def path(name, clf, kind="plain"):
        out = os.path.join(tmp, name.replace(" ", "_"))
        src = sub_reads if kind == "sub" else reads
        with profiling.collect() as ph:
            stats, wall = _path(launches, name, lambda: clf.classify_file(
                src, out, extended=kind == "extended"))
        with open(out + ".csv", "rb") as f:
            if f.read() != want[kind]:
                raise AssertionError(f"{name}: the CSV differs from phase 4's")
        m[name] = dict(reads=stats["reads"], wall_s=wall,
                       reads_per_s=stats["reads"] / wall,
                       device_bytes=_device_bytes(clf), launches={
                           n: c for n, c in launches[name].items() if c},
                       phase_s=dict(ph.totals))
        print(json.dumps({"path": name, **m[name]}), flush=True)

    path("host flat", flat)
    path("host flat extended", flat, "extended")
    mesh = Mesh([dev] * mesh_n, ("db",))
    clf, m["load_flat_mesh_s"] = _load(dev, tmp, prof, packed=False,
                                       mesh=mesh)
    path("host flat mesh", clf, "plain" if sub is None else "sub")
    del clf
    m.update(run_flat_processes(dev, tmp, prof, launches, golden_dir))

    # (f) a trace's kernels at its ends (utils/profiling.py): a burst in
    # this long-lived process, where the card's stamps drift the most
    burst = trace_burst(dev, tmp) if dev.type == "cuda" else None
    if burst and burst["trace_kept"] != burst["launched"]:
        raise AssertionError(f"trace burst: {burst}")
    c3 = os.path.join(tools_dir, "c3_reads.fa")
    c3_csv = os.path.join(tools_dir, "c3_res.csv")

    def traced(run, trace_dir: str):
        """run() a traced classify into trace_dir, taken again up to
        TRACE_RETAKES times where profiling.check_session finds its
        session not whole (on the card; then this raises).  Returns
        (run()'s result, the check, the checks of the sessions lost)."""
        lost = []
        for _ in range(TRACE_RETAKES + 1):
            shutil.rmtree(trace_dir, ignore_errors=True)
            got = run()
            if dev.type != "cuda":
                return got, None, lost
            check = profiling.check_session(_trace_events(trace_dir))
            if check["whole"]:
                return got, check, lost
            lost.append(check)
        raise AssertionError(f"{trace_dir}: {len(lost)} sessions lost "
                             f"kernels: {lost}")

    # classify --trace-dir in this process, its kernels recorded
    in_dir, in_out = os.path.join(tmp, "trace_in"), os.path.join(tmp, "tr_in")

    def in_process():
        rc, _ = _cli("classify", "-D", tools_dir, "-O", c3, "-R", in_out,
                     "--trace-dir", in_dir, "--device", dev.type)
        if rc:
            raise AssertionError(f"host trace in process: rc {rc}")

    _, in_check, in_lost = traced(in_process, in_dir)
    _same_file("host trace in process", in_out + ".csv", c3_csv)
    kernel_names = _trace_kernels(in_dir)[2]
    in_names = {n: any(n in k for k in kernel_names) for n in TRACE_KERNELS}
    # then as a user runs it: the CLI in a process of its own (cli_child,
    # which records its launches), whose trace must name K1-K3
    trace_dir = os.path.join(tmp, "trace")
    out, child = os.path.join(tmp, "host_trace"), os.path.join(tmp, "child")
    os.makedirs(child, exist_ok=True)

    def in_child():
        t = time.perf_counter()
        ((rc, log),) = _cluster_procs([[
            sys.executable, os.path.join(ROOT, "chip_smoke.py"), "cli-child",
            child, "classify", "-D", tools_dir, "-O", c3, "-R", out,
            "--trace-dir", trace_dir, "--device", dev.type]],
            [_cluster_env()])
        wall = time.perf_counter() - t
        if rc:
            raise AssertionError(f"host trace: rc {rc}\n{log[-4000:]}")
        with open(os.path.join(child, "p0.json")) as f:
            return json.load(f), wall

    (rec, wall), check, lost = traced(in_child, trace_dir)
    launches["host trace"] = rec["launches"]
    _same_file("host trace", out + ".csv", c3_csv)
    with open(out + ".csv", "rb") as f:
        n_reads = f.read().count(b"\n") - 1
    n_traces, n_events, kernel_names = _trace_kernels(trace_dir)
    names = {n: any(n in k for k in kernel_names) for n in TRACE_KERNELS}
    if not n_events or (dev.type == "cuda" and not all(names.values())):
        raise AssertionError(f"host trace: {n_traces} traces, {n_events} "
                             f"events, kernels {names}: "
                             f"{sorted(set(kernel_names))}")
    # the process's wall holds its start and the table's load; the rate
    # is over the CLI's wall less the load
    load_s = sum(x["seconds"] for x in rec["loads"])
    m["host trace"] = dict(reads=n_reads, wall_s=wall, cli_s=rec["wall_s"],
                           load_s=load_s, reads_per_s=n_reads / (
                               rec["wall_s"] - load_s),
                           device_bytes=rec["loads"][0]["table_bytes"],
                           trace_files=n_traces, trace_events=n_events,
                           kernels_named=names, check=check,
                           retakes=len(lost), lost_sessions=lost,
                           kernels_named_in_process=in_names,
                           check_in_process=in_check,
                           retakes_in_process=len(in_lost),
                           lost_sessions_in_process=in_lost, burst=burst,
                           launches={n: c for n, c in
                                     launches["host trace"].items() if c})
    print(json.dumps({"path": "host trace", **m["host trace"]}), flush=True)
    return m


N_GENOMES = 16  # phase 4: bench.py config 2, 16 genomes x 3 Mbp


def _phase(phase: str, t0: float, **info):
    print(f"phase {phase}: ok {time.perf_counter() - t0:.3f}s "
          + json.dumps(info, default=str), flush=True)


def main() -> int:
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
            dev, scale_dir, N_GENOMES, 3_000_000, 400_000
        )
        launches["dense 65535 targets"] = dense
        _phase("4 scale", t, launches=launches, **metrics)

        t = time.perf_counter()
        printed = set(launches)
        metrics = run_mesh(dev, scale_dir, params.FULL, lens, launches)
        _phase("4d mesh", t, launches={
            name: n for name, n in launches.items() if name not in printed},
            **metrics)

        t = time.perf_counter()
        printed = set(launches)
        metrics, dense_clf = run_out_of_core(dev, scale_dir, params.FULL, clf,
                                             fa, lens, launches)
        _phase("4b out-of-core", t, **metrics)

        t = time.perf_counter()
        refseq_dir = os.path.join(tmp, "refseq")
        os.makedirs(refseq_dir)
        metrics = run_refseq(dev, refseq_dir, launches)
        shutil.rmtree(refseq_dir)
        _phase("4c refseq-shape", t, launches={
            name: n for name, n in launches.items() if name not in printed},
            **metrics)

        t = time.perf_counter()
        printed = set(launches)
        config1_dir = os.path.join(tmp, "config1")
        os.makedirs(config1_dir)
        metrics = run_config1(dev, config1_dir, launches)
        shutil.rmtree(config1_dir)
        for flavour in ("full", "light"):
            c = metrics[flavour]
            print(f"config 1 {flavour} ({smi}): reads/s "
                  f"{c['reads_per_s']:.0f}, k-mer lookups/s "
                  f"{c['kmer_lookups_per_s']:.0f}, extended reads/s "
                  f"{c['extended_reads_per_s']:.0f}, pairs/s "
                  f"{c['pairs_per_s']:.0f}, db build s "
                  f"{c['db_build_device_s']:.3f} (host "
                  f"{c['db_build_host_s']:.3f}), load s {c['load_s']:.3f}",
                  flush=True)
        _phase("4e config 1", t, card=smi, launches={
            name: n for name, n in launches.items() if name not in printed},
            **metrics)

        t = time.perf_counter()
        # the flat path's sorted index, kept for phase 8
        flat, load_flat_s = _load(dev, scale_dir, params.FULL, packed=False)
        timing, shape = time_kernels(dev, clf, dense_clf, flat, fa, lens,
                                     scale_dir, N_GENOMES)
        _phase("5 timing", t, load_flat_s=load_flat_s, shape=shape, **timing)

        t = time.perf_counter()
        printed = set(launches)
        tools = run_tools(dev, tmp, clf, scale_dir, N_GENOMES, params.FULL,
                          launches)
        print(f"tools: config 3 pipeline_seconds {tools['c3_pipeline_s']:.3f}"
              f", config 4 batch_seconds {tools['c4_batch_s']:.3f}",
              flush=True)
        _phase("6 tools", t, launches={
            name: n for name, n in launches.items() if name not in printed},
            **tools)

        t = time.perf_counter()
        printed = set(launches)
        del clf, dense_clf  # the card's memory for the cluster's processes
        torch.cuda.empty_cache()
        paths = run_cluster(dev, tmp, scale_dir, os.path.join(tmp, "tools"),
                            os.path.join(tmp, "golden0"), launches)
        for rec in paths.values():
            print(json.dumps(rec), flush=True)
        _phase("7 cluster", t, launches={
            name: n for name, n in launches.items() if name not in printed})

        t = time.perf_counter()
        host = run_host_paths(dev, scale_dir, params.FULL, flat, launches,
                              os.path.join(tmp, "tools"),
                              os.path.join(tmp, "golden0"))
        check_launches(launches)
        _phase("8 host paths", t, **{key: v for key, v in host.items()
                                     if not isinstance(v, dict)})

    record = {"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=sum(p[name] for p in launches.values()),
             **{key: timing[name][key] for key in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")})
        for name, (src, rep) in KERNELS.items()
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# the kernels each main path must launch, with K3's form where it runs
# K3: small at config 2's 16 targets, hash at the RefSeq shape's 5,000
_SMALL = {"top2", "top2 small"}
_HASH = {"top2", "top2 hash"}
PATH_KERNELS = {
    "db build": {"aggregate"},
    "classify": {"window_canonicals", "probe", *_SMALL},
    "extended": {"window_canonicals", "probe", "sort_top2"},
    "paired": {"window_canonicals", "probe", *_SMALL},
    "dense 65535 targets": {"window_canonicals", "probe", "counts_top2"},
    "cycled counts": {"window_canonicals", "probe_chunk", "counts_top2"},
    "cycled counts extended": {"window_canonicals", "probe_chunk",
                               "counts_top2"},
    "cycle-outer files": {"window_canonicals", "probe_chunk", "counts_top2"},
    "cycled labels": {"window_canonicals", "probe_chunk", *_SMALL},
    "dense": {"window_canonicals", "probe_dense", *_SMALL},
    "auto dense": {"window_canonicals", "probe_dense", *_SMALL},
    "auto cycled": {"window_canonicals", "probe_chunk", "counts_top2"},
    "refseq db build": {"aggregate"},
    "refseq resident": {"window_canonicals", "probe", *_HASH},
    "refseq cycled": {"window_canonicals", "probe_chunk", *_HASH},
    "refseq dense": {"window_canonicals", "probe_dense", *_HASH},
    "mesh db": {"window_canonicals", "probe_chunk", *_SMALL},
    "mesh db extended": {"window_canonicals", "probe_chunk", "sort_top2"},
    "mesh db paired": {"window_canonicals", "probe_chunk", *_SMALL},
    "mesh db cycled counts": {"window_canonicals", "probe_chunk",
                              "counts_top2"},
    "mesh db cycled labels": {"window_canonicals", "probe_chunk", *_SMALL},
    "mesh dp": {"window_canonicals", "probe", *_SMALL},
    "mesh dp extended": {"window_canonicals", "probe", "sort_top2"},
    "mesh dp x db": {"window_canonicals", "probe_chunk", *_SMALL},
    "mesh dp x db extended": {"window_canonicals", "probe_chunk",
                              "sort_top2"},
    "verify": {"window_canonicals", "probe", *_SMALL},
    "tools config 3": {"window_canonicals", "probe", *_SMALL},
    "tools config 4": {"window_canonicals", "probe", *_SMALL},
    "cluster sample-parallel": {"window_canonicals", "probe", *_SMALL},
    "cluster sharded": {"window_canonicals", "probe_chunk", *_SMALL},
    "cluster sharded one process": {"window_canonicals", "probe_chunk",
                                    "top2"},
    "host flat": {"lookup", "counts_flat"},
    "host flat extended": {"lookup", "counts_flat"},
    "host flat mesh": {"lookup", "counts_flat"},
    "host flat processes": {"lookup", "counts_flat"},
    "host flat processes extended": {"lookup", "counts_flat"},
    "host flat one process": {"lookup", "counts_flat"},
    "host trace": {"window_canonicals", "probe", *_SMALL},
    **{f"config1 {flavour} {path}": need
       for flavour in ("full", "light") for path, need in (
           ("db build", {"aggregate"}),
           ("classify", {"window_canonicals", "probe", *_SMALL}),
           ("extended", {"window_canonicals", "probe", "sort_top2"}),
           ("paired", {"window_canonicals", "probe", *_SMALL}))},
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
    if sys.argv[1:2] == ["cli-child"]:  # a process of phase 7 or 8
        sys.exit(cli_child(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["flat-child"]:  # a process of phase 8 (c)
        sys.exit(flat_child(*sys.argv[2:4]))
    sys.exit(main())
