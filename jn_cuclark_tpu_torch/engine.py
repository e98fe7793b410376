"""Classification engine: file -> batched device queries -> CSV.

Replaces the reference's CuCLARK engine hot path (CuCLARK_hh.hh:1335-1783
getObjectsDataComputeFullGPU + printExtendedResultsSynced:1946-2122) on one
torch device with the standard radix table resident:

  host (native C++): streamed record scan, 2-bit/validity packing into
                     fixed-stride [R, S] rows (utils/native.py, ops/pack.py);
  device (torch):    window extraction + canonicalization, radix-table
                     probe and per-read scoring (ops/device_pipeline.py) —
                     hand-written CUDA kernels on a CUDA device, their
                     plain-PyTorch twins on the CPU;
  host (native C++): Gamma/Confidence in doubles and C-printf `%g` CSV
                     formatting, byte-identical to the reference
                     (Gamma = sum / (len - k + 1), Confidence =
                     best/(best+s_best), CuCLARK_hh.hh:2042-2051, 2110-2118).

Paired-end input merges the mates into one read with NBN `N`s between them
(native chunked merger, file.cc:205-268); Gamma's length then excludes the
NBN.  Extended output adds one count column per target: below 65,535
targets from each read's sorted per-window label row (kernel K4, expanded
by the native formatter), at 65,535 from dense per-read counts (K5).

A table larger than the card's budget (utils/memory.py) stays resident in
the dense two-plane layout when that fits (K8), else streams from the host
in row chunks, one pass of every batch per chunk (K7), with labels or
counts accumulated on the host between passes; `classify_files` runs
several samples through each chunk upload.

Over several devices (`mesh=`, parallel/mesh.py): mesh_mode="db" shards the
table's rows over the mesh (each shard's range optionally cycled), "dp"
puts the table on every device and splits each batch's rows, and a
two-axis mesh does both.  A mesh across processes (db mode, or the flat
path) ends each batch in collectives that every process issues in one
order, so such a Classifier takes one classify call at a time.

packed=False takes the flat sorted-array path instead of the radix table:
the DB's keys sorted on the device with their radix directory
(ops/lookup.py), each batch's canonical windows computed on the host with
numpy (io/fasta.parse_reads, `flat_queries`), searched by K9 and scored by
K5's flat form (`_query_single`; over any mesh, across processes too and
whatever `mesh_mode`, parallel/mesh.shard_index), each row formatted in
Python (`_format_row`, byte-identical to the native formatter).

Every other path runs the native host runtime, and a native runtime that
fails to build raises.  The JAX package's `use_native=False` (its numpy
fallback) and `BatchPlan.sort_batches` / `sort_window_batches` (its
length-bucketed planner) are accepted and change nothing: the port plans
resident batches in file order, which wrote the same CSV faster on the
card, and needs no fallback for a runtime it always builds.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import functools
import itertools
import os
import queue
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .io import dbformat
from .io.fasta import (
    ReadSet,
    iter_merged_slabs,
    iter_record_cuts,
    iter_record_slabs,
    merge_paired,
    parse_reads,
    window_starts,
)
from .io.targets import TargetsDef, parse_targets
from .kmer import canonical_u64, window_values_le
from .ops import device_pipeline, lookup, pack, radix_table, score
from .params import NBN, Profile
from .utils import memory, native
from .utils import profiling
from .utils.profiling import maybe_phase, maybe_wait

# device bytes of one batch's dense [R, T+1] count matrix: rows per batch
# are capped to fit it wherever a batch makes one (extended output at
# 65,535 targets, the cycled "counts" strategy, an extended "labels"
# finish).  The CSV does not depend on batch shapes.
DENSE_COUNTS_BYTES = 256 << 20

# pinned host bytes of one staging slice: a cycled chunk streams to the card
# through two such slices in turn, so pinned memory does not grow with the
# chunk
STAGING_SLICE_BYTES = 64 << 20


@dataclasses.dataclass
class BatchPlan:
    """Batch shapes and pipeline depth of the device step."""

    max_queries: int = 1 << 20  # flat path: queries (windows) per batch
    max_reads: int = 1 << 16  # reads per batch
    window_budget: int = 1 << 23  # R*stride char slots per batch
    pipeline_depth: int = 6  # batches packed and dispatched ahead of the fetch
    scan_chunk_bytes: int = 8 << 20  # streamed-scan granularity: the record
    # scan runs in a background thread in chunks of this size, so the first
    # batch dispatches after ~one chunk's scan instead of the whole input's
    sort_window_batches: int = 8  # the JAX package's; unused (file order)
    cycle_strategy: str = "auto"  # out-of-core accumulation: "counts"
    # keeps dense [R, T+1] per batch on the host (small for few targets);
    # "labels" keeps each cycle's per-window labels [R, W] (target-count
    # independent) and scores the concatenated cycles once; "auto" picks
    # whichever holds fewer bytes
    sort_batches: bool = True  # the JAX package's; unused (file order)


def _stride_tiers(lengths: np.ndarray) -> np.ndarray:
    """Vectorized pack.quantized_stride over a length array (exact parity:
    multiples of 64 up to 1024, powers of two from 2048 above)."""
    ln = np.maximum(np.asarray(lengths, dtype=np.int64), 1)
    small = np.maximum((ln + 63) // 64 * 64, 64)
    big = np.full_like(ln, 2048)
    mask = big < ln
    while mask.any():
        big[mask] *= 2
        mask = big < ln
    return np.where(ln <= 1024, small, big)


def _pad_rows(nb: int, r_cap: int) -> int:
    """Row padding for a partial batch: powers of two up to 8192, multiples
    of 8192 above, capped at the tier's full row count, so each tier uses a
    bounded set of batch shapes while pad waste stays <= max(nb, 12.5%)."""
    if nb <= 8192:
        p = 2048
        while p < nb:
            p *= 2
        return min(p, r_cap)
    return min(-(-nb // 8192) * 8192, r_cap)


def _pad_batch(words, vwords, r_pad: int):
    """Zero-pad a packed batch's rows up to the planner's padded row count
    (zero rows have no valid windows, so they score as empty and the
    scatter-back ignores them)."""
    nb = len(words)
    if nb < r_pad:
        words = np.concatenate(
            [words, np.zeros((r_pad - nb, words.shape[1]), np.uint64)]
        )
        vwords = np.concatenate(
            [vwords, np.zeros((r_pad - nb, vwords.shape[1]), np.uint64)]
        )
    return words, vwords


class _ScanStream:
    """Record scan of an in-memory FASTA/FASTQ buffer, streamed from a
    background thread in record-aligned chunks (native scanner per chunk,
    offsets fixed up to be absolute) so batch planning/dispatch starts after
    the FIRST chunk instead of after the whole input.  Produces byte-for-byte
    the same per-read arrays as one whole-buffer `native.scan_reads`."""

    def __init__(self, data: bytes, chunk_bytes: int = 8 << 20):
        self._parts: list[tuple] = []  # (ns, ne, ss, se, ln) per chunk
        self._cum: list[int] = [0]  # cumulative read counts
        self._done = False
        self._err: BaseException | None = None
        self._cond = threading.Condition()

        def run():
            try:
                buf = np.frombuffer(data, np.uint8)
                if data[0:1] not in (b">", b"@"):
                    raise ValueError(
                        "failed to recognize the format of the file"
                    )
                is_fq = data[0:1] == b"@"
                cuts = iter_record_cuts(buf, is_fq, chunk_bytes)
                while True:
                    with maybe_phase("scan_cut"):
                        cut = next(cuts, None)
                    if cut is None:
                        break
                    s, e = cut
                    with maybe_phase("scan"):
                        part = native.scan_reads(
                            data, s, e, is_fasta=not is_fq
                        )[1:]
                    with self._cond:
                        self._parts.append(part)
                        self._cum.append(self._cum[-1] + len(part[4]))
                        self._cond.notify_all()
            except BaseException as e:  # re-raised by readers
                self._err = e
            finally:
                with self._cond:
                    self._done = True
                    self._cond.notify_all()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def ensure(self, n: int) -> int:
        """Block until ≥n reads are scanned (or the scan finished); return
        the scanned count so far (≥n unless the input is exhausted)."""
        with self._cond, maybe_wait("scan_wait", lambda: self._short(n)):
            while self._short(n):
                self._cond.wait()
            if self._err is not None:
                raise self._err
            return self._cum[-1]

    def _short(self, n: int) -> bool:
        """Fewer than n reads scanned and the scan still running (the
        condition's lock held)."""
        return self._cum[-1] < n and not self._done

    def total(self) -> int:
        with self._cond:
            while not self._done:
                self._cond.wait()
            if self._err is not None:
                raise self._err
            return self._cum[-1]

    def arrays(self, r0: int, r1: int):
        """(ns, ne, ss, se, ln) for reads [r0, r1) — caller must have
        ensure()d r1 first."""
        with self._cond:
            lo = bisect.bisect_right(self._cum, r0) - 1
            hi = bisect.bisect_left(self._cum, r1, lo=lo)
            pieces = self._parts[lo:hi]
            starts = self._cum[lo : hi + 1]
        if len(pieces) == 1:
            a, b = r0 - starts[0], r1 - starts[0]
            return tuple(p[a:b] for p in pieces[0])
        out = []
        for f in range(5):
            segs = []
            for pi, p in enumerate(pieces):
                a = max(r0 - starts[pi], 0)
                b = min(r1, starts[pi + 1]) - starts[pi]
                segs.append(p[f][a:b])
            out.append(np.concatenate(segs))
        return tuple(out)


class HitStats:
    """Distinct-targets-hit-per-read accumulator (extended runs only),
    mirroring the reference's nonzero_count MIN/MAX/AVG stderr report
    (CuCLARK_hh.hh:1979-1980, 2053-2067)."""

    def __init__(self, n_targets: int):
        self.min = n_targets  # m_targetsName.size()-1 initial value
        self.max = 0
        self.sum = 0
        self.n = 0

    def update_counts(self, counts: np.ndarray):
        """Dense [R, T+1] count rows -> per-read distinct target counts."""
        self._update(np.count_nonzero(counts[:, 1:], axis=1))

    def update_runs(self, runs: np.ndarray):
        """Sorted per-window label rows [R, W] (zeros-first) -> distinct
        label count per row."""
        if runs.shape[1] == 0:
            self._update(np.zeros(runs.shape[0], np.int64))
            return
        d = ((runs[:, 1:] != runs[:, :-1]) & (runs[:, 1:] > 0)).sum(axis=1)
        self._update(d + (runs[:, 0] > 0))

    def _update(self, d: np.ndarray):
        if len(d):
            self.min = min(self.min, int(d.min()))
            self.max = max(self.max, int(d.max()))
            self.sum += int(d.sum())
        self.n += len(d)

    def report(self) -> str:
        """The reference's exact stderr line: AVG in float32 like
        `(float)nonzero_sum / m_nbObjects` (CuCLARK_hh.hh:2064-2067)."""
        with np.errstate(invalid="ignore"):
            avg = np.float32(self.sum) / np.float32(self.n)
        return (
            f"MIN targets: {self.min}, MAX targets: {self.max}, "
            f"AVG targets: {'%g' % avg}"
        )


def _to_dev(a: np.ndarray, dev) -> torch.Tensor:
    """A host u64 array on `dev` as int64 bit patterns."""
    return torch.from_numpy(a.view(np.int64)).to(dev)


def _check_label_range(labels, table, n_targets: int):
    """Raise ValueError where a DB label lies outside [0, n_targets): the
    formatter indexes the target names by label, and K3's small form skips
    labels above T.  `labels` are the keys' 0-based labels; where there are
    none (the table came from the .idx cache, which is keyed on the DB
    files alone, so a targets file of fewer targets can meet it), the
    table's stored labels+1 are checked, unless its label field cannot
    hold a label past the range."""
    labels = np.asarray(labels)
    if len(labels):
        lo, hi = int(labels.min()), int(labels.max())
    elif table is not None and (1 << table.lb) - 2 > n_targets:
        lo, hi = 0, radix_table.max_label1(table) - 1
    else:
        return
    if lo < 0 or hi >= n_targets:
        raise ValueError(
            f"database label {lo if lo < 0 else hi} lies outside [0, "
            f"{n_targets}): the DB was built for other targets than the "
            f"{n_targets} of the targets definition"
        )


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} was asked for but CUDA is not available"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


class Classifier:
    """CLARK classifier: the radix table resident on one device (standard
    or dense layout) or streamed from the host in cycles, or spread over
    the devices of a mesh (parallel/mesh.py); with packed=False the flat
    sorted index instead, on one device or over a mesh."""

    dense_table = None  # the host DenseTable when the dense layout engaged
    sharded = None  # the ShardedRadixTable of a db mesh
    shards = None  # a dp or dp x db mesh's tables on its devices
    _mesh_step = None  # the batch step of a dp or dp x db mesh
    index = None  # the flat path's lookup.FlatIndex (its blocks on a mesh)

    def __init__(
        self,
        profile: Profile,
        k: int,
        target_names: list[str],
        canonical: np.ndarray,
        labels: np.ndarray,
        plan: BatchPlan | None = None,
        device="cuda",
        db_cycles: int | str = "auto",
        index_cache: str | None = None,
        index_sig=None,
        prebuilt_table: radix_table.RadixTable | None = None,
        mesh=None,
        packed: bool = True,
        mesh_mode: str = "dp",
        use_native: bool = True,
    ):
        if mesh_mode not in ("dp", "db"):
            raise ValueError(f"mesh_mode must be 'dp' or 'db', got "
                             f"{mesh_mode!r}")
        if packed and mesh is not None and mesh.collective and (
                mesh_mode != "db"):
            # each process of a dp mode would classify other reads than
            # its peers; the flat path shards its index whatever the mode
            raise ValueError("a mesh across processes runs mesh_mode='db' "
                             "(the table's rows sharded over the world)")
        self.profile = profile
        self.k = k
        self.target_names = target_names
        self.n_targets = len(target_names) - 1  # names include NA at 0
        _check_label_range(labels, prebuilt_table, self.n_targets)
        self.plan = plan or BatchPlan()
        self.mesh = mesh
        self.packed, self.use_native = packed, use_native
        if mesh is None:
            self.device = _resolve_device(device)
        else:
            # batches land on the mesh's first device of this process,
            # which gathers the results; `device` is not used
            for d in mesh.local_devices:
                _resolve_device(d)
            self.device = mesh.local_devices[0]
        auto_cycles = db_cycles in ("auto", 0, None)
        self.db_cycles = db_cycles = 1 if auto_cycles else int(db_cycles)
        if db_cycles < 1:
            raise ValueError(f"db_cycles must be positive, got {db_cycles}")
        self.names = native.NamesBuffer(self.target_names)
        # cycled chunks stream through two pinned slices (each with its
        # last copy's event) under this lock, on a side stream per device
        self._upload_lock = threading.Lock()
        self._staging = None
        self._copy_streams: dict = {}
        # a process mesh's batches end in collectives that every process
        # must issue in one order: one classify call at a time
        self._one_call = (threading.Lock() if mesh is not None
                          and mesh.collective else None)

        if not packed:
            self._load_flat(canonical, labels)
            return
        if mesh is not None and mesh_mode == "db":
            # the table's rows sharded over the mesh, each shard's range
            # optionally cycled; planned and filled from the raw keys
            from .parallel.mesh import ShardedRadixTable

            keys = np.asarray(canonical, dtype=np.uint64)
            labs1 = np.asarray(labels, dtype=np.int32) + 1
            if not len(keys) and prebuilt_table is not None:
                keys, labs1 = radix_table.recover_keys(prebuilt_table)
            self.sharded = ShardedRadixTable(
                mesh, keys, labs1, self.n_targets, k,
                db_cycles="auto" if auto_cycles else db_cycles,
                transient=self._transient_bytes())
            self.db_cycles = self.sharded.n_cycles
            self.table = None
            return

        table = prebuilt_table
        if table is None and index_cache is not None and os.path.exists(
            index_cache
        ):
            table = radix_table.load_cache(index_cache, signature=index_sig)
            # the cached table, not `labels`, is what classifies
            _check_label_range((), table, self.n_targets)
        if table is None:
            table = radix_table.build(
                np.asarray(canonical, dtype=np.uint64),
                np.asarray(labels, dtype=np.int32) + 1,
                k=k,
            )
            if index_cache is not None:
                try:
                    radix_table.save_cache(
                        index_cache, table, signature=index_sig
                    )
                except OSError:
                    pass
        budget = None
        if auto_cycles:
            # the reference derives parts x cycles from the device's memory
            # less RESERVED (CuClarkDB.cu:526-565): a table above the budget
            # cycles with no flags.  A dp x db mesh splits the table's rows
            # over db; a dp mesh holds all of it on each device
            n_shards = (mesh.shape[-1] if mesh is not None
                        and len(mesh.axis_names) == 2 else 1)
            db_cycles, budget = memory.auto_db_cycles(
                table.nbytes, self._transient_bytes(), device=self.device,
                n_shards=n_shards,
            )
            if db_cycles > 1 and mesh is not None:
                per_dev = table.nbytes // n_shards
                raise RuntimeError(
                    f"database needs {per_dev >> 20} MB per device but "
                    f"the device budget is {budget >> 20} MB, and "
                    "out-of-core cycling does not compose with this "
                    "mesh mode. Use --shard-db (DB rows sharded over "
                    "the mesh, composes with cycling) or drop the mesh "
                    "and let --db-cycles auto stream the table."
                )
            self.db_cycles = db_cycles
            if db_cycles > 1:
                print(
                    f"Database ({table.nbytes >> 20} MB) exceeds the "
                    f"device budget ({budget >> 20} MB): loading in "
                    f"{db_cycles} cycles.",
                    file=sys.stderr,
                )
        # dense two-plane residency: a table between 1x and ~2x the budget
        # stays resident (two row reads per probe) instead of re-streaming
        # every pass.  CLARK_TPU_DENSE: auto (default) / 0 (never) / force
        # (even when the standard table fits, or cycles were asked for);
        # never with a mesh
        dense_env = os.environ.get("CLARK_TPU_DENSE", "auto")
        forced = dense_env == "force"
        if mesh is None and (forced or (dense_env not in ("0", "off")
                                        and auto_cycles and db_cycles > 1)):
            if self._try_dense(canonical, labels, table, index_cache,
                               index_sig, budget, forced) is not None:
                self.db_cycles = 1
                return
        if db_cycles > 1:
            if mesh is not None:
                raise NotImplementedError(
                    "db_cycles with a dp mesh is not supported; use "
                    "mesh_mode='db' (sharded rows compose with cycling)"
                )
            # out of core: the chunks stay on the host, one uploaded per pass
            self.table = None
            self.table_meta = dict(m1=table.m1, lb=table.lb)
            self.table_chunks = radix_table.chunk_table(table, db_cycles)
            self.stash = radix_table.put_stash(
                table.stash_keys, table.stash_labels, self.device)
            return
        if mesh is not None:
            # a two-axis mesh shards the rows over db and the reads over dp;
            # a one-axis mesh shards the reads
            from .parallel.mesh import shard_reads, shard_reads_db

            place = shard_reads_db if len(mesh.axis_names) == 2 else shard_reads
            self.shards, self._mesh_step = place(mesh, table, self.n_targets, k)
            self.table = None
            return
        self.table = radix_table.to_device(table, self.device)

    def _load_flat(self, canonical, labels):
        """The flat path's sorted index (lookup.prepare_index; labels + 1)
        with its radix directory (lookup.build_index) on the device, or
        over a mesh this process's blocks, each with its directory
        (parallel/mesh.shard_index)."""
        keys, labels1 = lookup.prepare_index(canonical, labels)
        self.table = None
        self.db_cycles = 1  # the index stays resident: cycles do not apply
        if self.mesh is not None:
            from .parallel.mesh import shard_index

            self.index, self.query_fn = shard_index(
                self.mesh, keys, labels1, self.n_targets)
            return
        self.index = lookup.build_index(
            _to_dev(keys, self.device),
            torch.from_numpy(labels1).to(self.device))
        self.query_fn = functools.partial(_query_single,
                                          n_targets=self.n_targets)

    def _transient_bytes(self) -> int:
        """Device bytes of the batches in flight (utils/memory.py)."""
        counts = min(DENSE_COUNTS_BYTES,
                     4 * self.plan.max_reads * (self.n_targets + 1))
        return memory.probe_transient_bytes(
            self.plan.window_budget, self.plan.pipeline_depth, counts)

    def _try_dense(self, canonical, labels, table, index_cache, index_sig,
                   budget, forced=False):
        """Engage the dense two-plane residency: returns the DenseTable and
        puts it on the device, or None where it would not fit the budget
        either (the table then cycles).  With no budget (forced, explicit
        cycles, or the CPU) it always engages."""
        n_keys = len(canonical)
        if n_keys == 0:
            # the table came from the .idx cache (load() passes no keys
            # then): its occupancy is the exact key count
            n_keys = radix_table.occupied_count(
                table.slots, table.slot_width
            ) + int((table.stash_keys != radix_table.EMPTY).sum())
        # K8 reads plane 2's rows in place: the second plane adds no batch
        # transient (the JAX package adds a [Q, C] gather here)
        if budget is not None and radix_table.dense_nbytes(
            n_keys, self.n_targets, c=table.slot_width
        ) > budget:
            return None
        dense_cache = index_cache + ".dense" if index_cache else None
        dense = None
        if dense_cache is not None and os.path.exists(dense_cache):
            dense = radix_table.load_dense_cache(dense_cache,
                                                 signature=index_sig)
        if dense is None:
            if len(canonical):
                keys = np.asarray(canonical, dtype=np.uint64)
                labs1 = np.asarray(labels, dtype=np.int32) + 1
            else:
                # the exact key/label set of the standard table (its slot
                # layout is bijective: radix_table.recover_keys)
                keys, labs1 = radix_table.recover_keys(table)
            dense = radix_table.build_dense(keys, labs1, c=table.slot_width)
            if dense_cache is not None:
                try:
                    radix_table.save_dense_cache(dense_cache, dense,
                                                 signature=index_sig)
                except OSError:
                    pass
        if budget is not None and dense.nbytes > budget:
            return None  # the prediction was off: cycle instead
        if not forced:
            print(
                f"Database ({table.nbytes >> 20} MB standard) fits "
                f"resident in the dense two-choice layout "
                f"({dense.nbytes >> 20} MB): probing dense instead of "
                f"cycling.",
                file=sys.stderr,
            )
        self.table = radix_table.to_device(dense, self.device)
        self.dense_table = dense
        return dense

    def batch_fn(self, words, vwords, extended=False, probe_cols=None):
        """(total, ibest, best, sbest, extra) of a resident batch on
        self.device (a mesh's outputs may carry pad rows past the batch)."""
        if self.sharded is not None:
            return self.sharded.classify(words, vwords, extended, probe_cols)
        if self._mesh_step is not None:
            return self._mesh_step(words, vwords, extended=extended,
                                   probe_cols=probe_cols)
        step = (device_pipeline.classify_batch_dense
                if self.dense_table is not None
                else device_pipeline.classify_batch)
        return step(
            self.table, words, vwords, k=self.k, n_targets=self.n_targets,
            extended=extended, probe_cols=probe_cols,
        )

    # ------------------------------------------------------------------ load
    @classmethod
    def load(
        cls,
        folder: str,
        targets: TargetsDef | str,
        profile: Profile,
        k: int | None = None,
        min_count_target: int = 0,
        sampling_factor: int = 1,
        gap: int | None = None,
        plan: BatchPlan | None = None,
        device="cuda",
        db_cycles: int | str = "auto",
        mesh=None,
        packed: bool = True,
        mesh_mode: str = "dp",
        use_native: bool = True,
    ) -> "Classifier":
        if isinstance(targets, str):
            targets = parse_targets(targets)
        k = profile.default_k if k is None else k
        g = profile.default_gap if gap is None else gap
        stem = os.path.join(
            folder, profile.db_stem(k, targets.n_targets, min_count_target, g)
        )
        if not dbformat.db_exists(stem):
            # recover from per-target .ht files if present
            # (CuCLARK_hh.hh:633-684)
            from .db.recovery import recover_central_db

            if not recover_central_db(
                folder, targets, profile, k, min_count_target, gap=g
            ):
                raise FileNotFoundError(
                    f"database {stem}.(sz|ky|lb) not found, nor per-target "
                    ".ht files to recover it from"
                )
            print(
                "The database was recovered from saved targets-specific data.",
                file=sys.stderr,
            )
        # device-index cache: keyed on a content signature of the DB files;
        # valid only for unsampled loads (sampling changes the key set).  A
        # db mesh plans and fills its shards from the raw keys, and the
        # flat path sorts them
        use_cache = packed and sampling_factor == 1 and not (
            mesh is not None and mesh_mode == "db")
        cache = stem + ".idx.npz"
        table = None
        sig = radix_table.db_signature(stem) if use_cache else None
        if use_cache and os.path.exists(cache):
            table = radix_table.load_cache(cache, signature=sig)
            if table is None:
                try:
                    os.remove(cache)
                except OSError:
                    pass
        if table is not None:
            canonical = np.zeros(0, np.uint64)
            labels = np.zeros(0, np.uint16)
        else:
            canonical, labels = dbformat.read_db(stem, profile, k, sampling_factor)
        return cls(
            profile,
            k,
            targets.target_names,
            canonical,
            labels,
            plan=plan,
            device=device,
            db_cycles=db_cycles,
            index_cache=cache if use_cache else None,
            index_sig=sig,
            prebuilt_table=table,
            mesh=mesh,
            packed=packed,
            mesh_mode=mesh_mode,
            use_native=use_native,
        )

    # -------------------------------------------------------------- classify
    def classify_bytes(self, data: bytes, paired: bool = False,
                       extended: bool = False,
                       hit_stats: HitStats | None = None):
        """Classify one in-memory FASTA/FASTQ file (with paired=True, mates
        already merged, as merge_paired gives them); returns (rows,
        n_reads), rows a generator of formatted CSV body chunks (whole
        lines).  `hit_stats` (extended runs only) accumulates the
        reference's MIN/MAX/AVG distinct-targets-hit report.  On a process
        mesh the rows generator holds the Classifier's one call from its
        first row to its last.  The flat path (packed=False) parses the
        input with numpy; every other path runs the native host runtime."""
        t0 = time.perf_counter()
        if not self.packed:
            rs = parse_reads(data)
            rows = self._classify_flat(rs, paired, extended, hit_stats)
            n_reads = rs.n_reads
        elif self.db_cycles > 1:
            with maybe_phase("scan"):
                _, ns, ne, ss, se, ln = native.scan_reads(data)
            rows = self._classify_cycled_native(
                data, ns, ne, ss, se, ln, paired, extended, hit_stats)
            n_reads = len(ln)
        else:
            with maybe_phase("count_reads"):
                n_reads = native.quick_count(data)
            scan = _ScanStream(data, self.plan.scan_chunk_bytes)
            rows = self._classify_native(data, scan, t0, paired, extended,
                                         hit_stats)
        if self._one_call is None:
            return rows, n_reads
        return self._exclusive_rows(rows), n_reads

    @contextlib.contextmanager
    def _exclusive(self):
        """Hold a process mesh's one call; raise ValueError where another
        call holds it.  A no-op for other Classifiers."""
        if self._one_call is None:
            yield
            return
        if not self._one_call.acquire(blocking=False):
            raise ValueError(
                "a Classifier on a mesh across processes takes one classify "
                "call at a time: every process must issue its collectives "
                "in one order")
        try:
            yield
        finally:
            self._one_call.release()

    def _exclusive_rows(self, rows):
        with self._exclusive():
            yield from rows

    def classify_file(
        self,
        objects_path: str,
        result_path: str,
        paired_path: str | None = None,
        extended: bool = False,
        verbose: bool = False,
        slab_bytes: int = 1 << 28,
    ) -> dict:
        """Classify a file (or paired files) to `<result_path>.csv`.

        The input is memory-mapped and streamed in record-aligned slabs of
        ~slab_bytes, so inputs far larger than host RAM classify with a flat
        memory profile; paired FASTQ merges through the native chunked
        merger (file.cc:205-268).  Returns speed stats (reads, seconds,
        reads_per_min), mirroring printSpeedStats (CuCLARK_hh.hh:1932-1939),
        and for extended runs the HitStats under "hit_stats"."""
        with self._exclusive():
            return self._classify_file(objects_path, result_path,
                                       paired_path, extended, verbose,
                                       slab_bytes)

    def _classify_file(self, objects_path, result_path, paired_path,
                       extended, verbose, slab_bytes) -> dict:
        paired = paired_path is not None
        if paired:
            slabs = iter_merged_slabs(objects_path, paired_path, slab_bytes)
        else:
            slabs = iter_record_slabs(objects_path, slab_bytes)
        t0 = time.time()
        n_reads = 0
        out = result_path + ".csv"
        # pull the first slab BEFORE touching the output so a missing/
        # malformed input raises without destroying an existing results file
        first = next(slabs, None)
        # slab i+1 materializes (mmap page-in / paired merge) in a worker
        # thread while slab i classifies; the record scan itself streams
        # inside _classify_native.  The cycled path wants whole-slab
        # arrays, so slab i+1 is also scanned in that thread.
        cycled = self.packed and self.db_cycles > 1

        def stage(slab):
            if not cycled:
                return slab, None
            with maybe_phase("scan"):
                return slab, native.scan_reads(slab)

        scanned = (
            self._pipelined(itertools.chain([first], slabs), stage, depth=1)
            if first is not None else iter(())
        )
        hs = HitStats(self.n_targets) if extended else None
        with open(out, "wb") as f:
            f.write(self._header(extended))
            for slab, scn in scanned:
                scan = None
                if not self.packed:
                    rs = parse_reads(slab)
                    gen = self._classify_flat(rs, paired, extended, hs)
                    nr = rs.n_reads
                elif cycled:
                    _, ns, ne, ss, se, ln = scn
                    gen = self._classify_cycled_native(
                        slab, ns, ne, ss, se, ln, paired, extended, hs)
                    nr = len(ln)
                else:
                    t_slab = time.perf_counter()
                    scan = _ScanStream(slab, self.plan.scan_chunk_bytes)
                    gen = self._classify_native(slab, scan, t_slab, paired,
                                                extended, hs)
                for chunk in gen:
                    f.write(chunk)
                n_reads += nr if scan is None else scan.total()
        dt = time.time() - t0
        stats = {
            "reads": n_reads,
            "seconds": dt,
            "reads_per_min": int(n_reads / dt * 60.0) if dt > 0 else 0,
            "result": out,
        }
        if extended:
            stats["hit_stats"] = hs
        if extended and verbose:
            # per-run distinct-targets-hit distribution, as the reference
            # prints after its extended writer (CuCLARK_hh.hh:2064-2067)
            print(hs.report(), file=sys.stderr)
        if verbose:
            print(
                f"Done in {dt:.1f}s ({stats['reads_per_min']} reads/min, "
                f"{n_reads} reads)"
            )
        return stats

    def classify_files(self, items: list[tuple], jobs: int = 2,
                       extended: bool = False) -> list[dict]:
        """Classify several independent inputs, `jobs` at a time.

        Items are (objects_path, paired_path_or_None, result_path); the
        returned stats follow the input order.  Small samples are single
        batches, so classifying files concurrently fills each other's
        dispatch and fetch gaps (the reference runs list-mode files one
        after another, CuCLARK_hh.hh:384-507).  A cycled table instead
        runs cycle-outer: each chunk is uploaded once and every sample's
        batches probe it (`_classify_files_cycled`), unless the inputs
        total more than CLARK_TPU_CYCLE_OUTER_MAX_BYTES (default 4 GiB),
        since that path holds every sample and its packed batches in host
        memory; above the cap the samples run one after another.  A
        Classifier on a process mesh takes jobs=1 and raises ValueError for
        more."""
        if self._one_call is not None and jobs > 1:
            raise ValueError(
                f"classify_files(jobs={jobs}) on a mesh across processes: "
                "its collectives need one call at a time (jobs=1)")
        if self.db_cycles > 1 and len(items) > 1:
            total_bytes = sum(
                os.path.getsize(p)
                for o, pp, _ in items
                for p in (o, pp)
                if p is not None
            )
            cap = int(os.environ.get("CLARK_TPU_CYCLE_OUTER_MAX_BYTES",
                                     4 << 30))
            if total_bytes <= cap:
                with self._exclusive():
                    return self._classify_files_cycled(items, extended)
            print(
                f"cycle-outer scheduling skipped: inputs total "
                f"{total_bytes >> 20} MB > {cap >> 20} MB cap "
                "(CLARK_TPU_CYCLE_OUTER_MAX_BYTES); running samples "
                "serially with slab streaming.",
                file=sys.stderr,
            )
        if self.db_cycles > 1:
            # concurrent cycled runs would each hold their own chunks on
            # the device, which is what cycling exists to avoid
            jobs = 1
        if jobs <= 1 or len(items) <= 1:
            return [
                self.classify_file(o, r, paired_path=p, extended=extended)
                for o, p, r in items
            ]
        with ThreadPoolExecutor(max_workers=jobs) as ex:
            futs = [
                ex.submit(self.classify_file, o, r, paired_path=p,
                          extended=extended)
                for o, p, r in items
            ]
            return [f.result() for f in futs]

    # ------------------------------------------------------ out-of-core path
    def _classify_files_cycled(self, items, extended: bool) -> list[dict]:
        """Cycle-outer / sample-inner: table chunk j is uploaded once and
        every sample's batches probe it, so N samples stream the table once
        instead of N times; each sample then finishes on its own."""
        t0 = time.time()
        samples = []
        for objects_path, paired_path, result_path in items:
            with open(objects_path, "rb") as f:
                data = f.read()
            paired = paired_path is not None
            if paired:
                with open(paired_path, "rb") as f:
                    data = merge_paired(data, f.read())
            with maybe_phase("scan"):
                _, ns, ne, ss, se, ln = native.scan_reads(data)
            samples.append(dict(result=result_path, paired=paired,
                                lengths=ln, io=self._native_io(data, ns, ne,
                                                               ss, se)))
        strategy = self._cycled_strategy([s["lengths"] for s in samples])
        for s in samples:
            s["specs"], s["packed"], s["pcs"] = self._cycled_prepare(
                s["lengths"], s["io"][0], strategy, extended)
            s["acc"] = [None] * len(s["specs"])
        self._run_passes(strategy, [(s["packed"], s["acc"], s["pcs"])
                                    for s in samples])
        outs = []
        for s in samples:
            out = s["result"] + ".csv"
            with open(out, "wb") as f:
                f.write(self._header(extended))
                for chunk in self._cycled_finish(
                    s["specs"], s["acc"], strategy, s["lengths"],
                    s["paired"], extended, s["io"][1],
                ):
                    f.write(chunk)
            outs.append(out)
        # samples interleave inside each chunk's pass, so a sample's own
        # wall time is not separable: every sample reports the shared wall
        # and the aggregate rate, flagged as such
        dt = time.time() - t0
        n_total = sum(len(s["lengths"]) for s in samples)
        return [
            {
                "reads": len(s["lengths"]),
                "seconds": dt,
                "reads_per_min": int(n_total / dt * 60.0) if dt > 0 else 0,
                "result": out,
                "aggregate": True,
            }
            for s, out in zip(samples, outs)
        ]

    def _native_io(self, data, ns, ne, ss, se):
        """(packer, formatter) of one in-memory input for the cycled path:
        packer(idx, stride) packs reads idx; formatter(r0, r1, ...) formats
        reads [r0, r1) from their scored scalars (and dense counts)."""

        def packer(idx, stride):
            return native.pack_batch(data, ss[idx], se[idx], stride)

        def formatter(r0, r1, total, ib, b, sb, norm, counts):
            with maybe_phase("format"):
                return native.format_rows(
                    data, ns[r0:r1], ne[r0:r1], total, ib, b, sb, norm,
                    self.k, self.names, counts=counts,
                    n_targets=self.n_targets if counts is not None else 0,
                )

        return packer, formatter

    def _format_rows(self, names, total, ib, b, sb, norm, counts) -> bytes:
        """`_format_row` over a run of reads (counts: their dense [n, T+1]
        rows, or None)."""
        return b"".join(
            _format_row(name, int(total[i]), int(ib[i]), int(b[i]),
                        int(sb[i]), int(norm[i]), self.k, self.target_names,
                        None if counts is None else counts[i])
            for i, name in enumerate(names))

    def _classify_cycled_native(self, data, ns, ne, ss, se, lengths, paired,
                                extended, hit_stats=None):
        """Cycle-outer / batch-inner classification of one input: every
        batch is packed once, probed against each chunk in turn, its
        labels or counts accumulated on the host (the reference's
        swapDbParts + host-row merge, CuCLARK_hh.hh:1765-1772), then scored
        and formatted in file order."""
        packer, formatter = self._native_io(data, ns, ne, ss, se)
        strategy = self._cycled_strategy([lengths])
        specs, packed, pcs = self._cycled_prepare(lengths, packer, strategy,
                                                  extended)
        acc = [None] * len(specs)
        self._run_passes(strategy, [(packed, acc, pcs)])
        yield from self._cycled_finish(specs, acc, strategy, lengths, paired,
                                       extended, formatter, hit_stats)

    def _cycled_strategy(self, lengths_list) -> str:
        """The accumulation strategy of a cycled run over its inputs:
        labels cost 2-4 B per window per cycle, dense counts 4 (T+1) B per
        read whatever the cycles, so labels win once the target count
        passes the per-read window count (RefSeq-scale databases)."""
        strategy = self.plan.cycle_strategy
        if strategy not in ("auto", "labels", "counts"):
            raise ValueError(f"unknown cycle_strategy {strategy!r}")
        if strategy != "auto":
            return strategy
        max_stride = max((int(_stride_tiers(ln).max())
                          for ln in lengths_list if len(ln)), default=0)
        max_windows = max(max_stride - (self.k - 1), 0)
        lab_bytes = (2 if self.n_targets < 65535 else 4) * self.db_cycles
        return ("labels" if max_windows * lab_bytes < 4 * (self.n_targets + 1)
                else "counts")

    def _cycled_prepare(self, lengths, packer, strategy, extended):
        """Plan and pack one input's batches for the passes: (specs
        [(idx, stride, r_pad)], packed batches, probe_cols), the reads
        length-bucketed over the whole input.  Where a batch makes a dense
        count matrix (the counts strategy, an extended finish) its rows are
        capped to DENSE_COUNTS_BYTES."""
        max_reads = self.plan.max_reads
        if strategy == "counts" or extended:
            max_reads = self._dense_rows(max_reads)
        lengths = np.asarray(lengths)
        specs = self._window_specs(_stride_tiers(lengths), max_reads)
        packed, pcs = [], []
        for idx, stride, r_pad in specs:
            with maybe_phase("pack"):
                words, vwords = packer(idx, stride)
                packed.append(_pad_batch(words, vwords, r_pad))
            pcs.append(self._probe_cols(lengths[idx].max(initial=1), stride))
        return specs, packed, pcs

    def _dense_rows(self, max_reads: int) -> int:
        """max_reads capped so that a batch's dense [R, T+1] counts fit
        DENSE_COUNTS_BYTES."""
        return min(max_reads, max(
            DENSE_COUNTS_BYTES // (4 * (self.n_targets + 1)), 1))

    def _run_passes(self, strategy, inputs):
        """One pass per table chunk over every input's batches; inputs are
        (packed batches, accumulators, probe_cols) triples."""
        if not any(packed for packed, _, _ in inputs):
            return
        n_passes, begin_pass, end_pass = self._cycle_passes(strategy)
        for j in range(n_passes):
            pass_fn = begin_pass(j)
            try:
                for packed, acc, pcs in inputs:
                    self._cycled_accumulate(pass_fn, packed, acc, strategy,
                                            pcs)
            finally:
                end_pass()

    def _cycle_passes(self, strategy):
        """(n_passes, begin_pass(j) -> batch step, end_pass) over the
        table's chunks: the host chunks of one device, or each cycle's
        chunks of every db shard of a ShardedRadixTable.

        On a CUDA device a chunk streams to the card on a side stream
        (_upload_chunk); the compute stream waits on the copy's event, and
        record_stream keeps the caching allocator from handing the chunk's
        memory to another upload while kernels still read it.  Pass j+1's
        chunks upload in a worker thread while pass j's batches probe (the
        reference's swapDbParts overlaps its uploads the same way,
        CuClarkDB.cu:776-815), so two passes' chunks are resident at the
        peak, which auto_db_cycles budgets for; CLARK_TPU_PREFETCH_CHUNKS=0
        turns the overlap off.  Each call keeps its own chunks, so
        concurrent classify calls on one Classifier do not share them."""
        sharded = self.sharded
        n_passes = self.db_cycles
        narrow = self.n_targets < 65535

        def put(host, dev):
            host = host.view(np.int32)
            if dev.type != "cuda":
                return torch.from_numpy(host), None
            with maybe_phase("chunk_upload"):
                return self._upload_chunk(host, dev)

        def upload(j):
            """{shard: (slots, the copy's event or None)} of pass j."""
            if sharded is not None:
                return sharded.upload_cycle(j, put)
            return {None: put(self.table_chunks[j]["slots"], self.device)}

        prefetch = (n_passes > 1 and
                    os.environ.get("CLARK_TPU_PREFETCH_CHUNKS", "1") != "0")
        pre: dict = {"j": None, "thread": None, "out": None}
        # the current chunks live in this cell, not in the returned step:
        # end_pass clears it so pass j's chunks are released before
        # begin_pass(j+1) starts the upload of pass j+2's
        cur: dict = {"chunks": None}

        def begin_pass(j):
            if pre["thread"] is not None and pre["j"] == j:
                pre["thread"].join()
                status, got = pre["out"]
                pre["thread"] = pre["out"] = None
                if status == "err":
                    raise got
            else:
                got = upload(j)
            if prefetch and j + 1 < n_passes:
                def work(nj=j + 1):
                    try:
                        pre["out"] = ("ok", upload(nj))
                    except BaseException as e:  # re-raised at the join
                        pre["out"] = ("err", e)

                pre["j"] = j + 1
                pre["thread"] = threading.Thread(target=work, daemon=True)
                pre["thread"].start()
            for slots, done in got.values():
                if done is not None:
                    stream = torch.cuda.current_stream(slots.device)
                    stream.wait_event(done)
                    slots.record_stream(stream)
            cur["chunks"] = {key: slots for key, (slots, _) in got.items()}
            if sharded is not None:
                def step(words, vwords, probe_cols=None):
                    return sharded.cycle_step(cur["chunks"], j, strategy,
                                              words, vwords, probe_cols)
                return step
            sk, sl = self.stash
            chunk = self.table_chunks[j]
            start, use_stash = chunk["start_row"], chunk["use_stash"]
            kw = dict(k=self.k, **self.table_meta)

            if strategy == "labels":
                def step(words, vwords, probe_cols=None):
                    return device_pipeline.classify_batch_labels_chunk(
                        cur["chunks"][None], sk, sl, words, vwords, start,
                        use_stash, narrow=narrow, probe_cols=probe_cols, **kw,
                    )
            else:
                def step(words, vwords, probe_cols=None):
                    return device_pipeline.classify_batch_counts_chunk(
                        cur["chunks"][None], sk, sl, words, vwords, start,
                        use_stash, n_targets=self.n_targets,
                        probe_cols=probe_cols, **kw,
                    )
            return step

        def end_pass():
            cur["chunks"] = None

        return n_passes, begin_pass, end_pass

    def _upload_chunk(self, host: np.ndarray, dev: torch.device):
        """Copy one host chunk to the card `dev` on that device's side
        stream, through two pinned STAGING_SLICE_BYTES slices in turn (one
        fills while the other copies); returns (the device tensor, the
        copy's event) once the copy is done.  The lock makes concurrent
        calls on one Classifier, and the shards of a mesh, take turns with
        the slices."""
        flat = host.reshape(-1)
        with self._upload_lock:
            if self._staging is None:
                self._staging = [
                    [torch.empty(STAGING_SLICE_BYTES // 4, dtype=torch.int32,
                                 pin_memory=True), None]
                    for _ in range(2)
                ]
            stream = self._copy_streams.get(dev)
            if stream is None:
                stream = self._copy_streams[dev] = torch.cuda.Stream(dev)
            n = self._staging[0][0].numel()
            with torch.cuda.stream(stream):
                slots = torch.empty(host.shape, dtype=torch.int32, device=dev)
                dst = slots.view(-1)
                for i, off in enumerate(range(0, flat.size, n)):
                    staged = self._staging[i % 2]
                    buf, copied = staged
                    if copied is not None:
                        copied.synchronize()  # the slice's last copy drained
                    part = flat[off : off + n]
                    buf.numpy()[: part.size] = part
                    dst[off : off + part.size].copy_(buf[: part.size],
                                                     non_blocking=True)
                    # a new event each time: an event records on one device
                    staged[1] = torch.cuda.Event()
                    staged[1].record(stream)
                done = torch.cuda.Event()
                done.record(stream)
            done.synchronize()  # both slices are free for the next upload
        return slots, done

    def _cycled_accumulate(self, step, packed_batches, acc, strategy, pcs):
        """Run one pass's step over every packed batch and accumulate on
        the host: a cycle's label grids are appended (they concatenate
        along the window axis), counts add.  Dispatch runs in a worker
        thread and the fetches overlap it."""
        dev = self.device

        def dispatch(item):
            bi, (words, vwords) = item
            with maybe_phase("dispatch"):
                return bi, step(_to_dev(words, dev), _to_dev(vwords, dev),
                                probe_cols=pcs[bi])

        def fetch(item):
            bi, out = item
            with maybe_phase("device_wait"):
                return bi, out.cpu().numpy()

        entries = self._pipelined(enumerate(packed_batches), dispatch,
                                  put_wait="queue_full",
                                  get_wait="batch_wait")
        for bi, c in self._pipelined_pool(entries, fetch, workers=2, depth=2,
                                          wait="fetch_wait"):
            if strategy == "labels":
                acc[bi] = [c] if acc[bi] is None else acc[bi] + [c]
            elif acc[bi] is None:
                acc[bi] = c
            else:
                acc[bi] += c

    def _cycled_finish(self, specs, acc, strategy, lengths, paired, extended,
                       formatter, hit_stats=None):
        """Score the accumulated batches, scatter to file order and yield
        the formatted CSV chunks.  Labels: one device top-2 (K3; K5 when
        extended) over each batch's concatenated cycles.  Counts: the top-2
        over the summed [R, T+1] counts on the host, as the JAX package's
        read_results orders it (count desc, lowest target first)."""
        n_reads = len(lengths)
        norm_all = lengths - (NBN if paired else 0)
        res_g = np.zeros((4, n_reads), np.int64)  # total, ibest, best, sbest
        cnt_g = (np.zeros((n_reads, self.n_targets + 1), np.int32)
                 if extended else None)
        for (idx, _, _), got in zip(specs, acc):
            nb = len(idx)
            if strategy == "labels":
                lab = got[0] if len(got) == 1 else np.concatenate(got, axis=1)
                if lab.dtype == np.int16:  # u16 bits: widen as unsigned
                    lab = lab.view(np.uint16)
                lab = torch.from_numpy(lab.astype(np.int32)).to(self.device)
                with torch.inference_mode():
                    total, ib, b, sb, counts = (
                        device_pipeline.score_from_labels(
                            lab, n_targets=self.n_targets, extended=extended))
                res_g[:, idx] = torch.stack(
                    [total, ib, b, sb])[:, :nb].cpu().numpy()
                if extended:
                    cnt_g[idx] = counts[:nb].cpu().numpy()
                continue
            t = got[:nb, 1:]
            best = t.max(axis=1) if t.shape[1] else np.zeros(nb, np.int32)
            ib = t.argmax(axis=1) if t.shape[1] else np.zeros(nb, np.int64)
            masked = t.copy()
            if t.shape[1]:
                masked[np.arange(nb), ib] = -1
            res_g[0, idx] = t.sum(axis=1, dtype=np.int64)
            res_g[1, idx] = np.where(best > 0, ib + 1, 0)
            res_g[2, idx] = best
            res_g[3, idx] = np.maximum(masked.max(axis=1, initial=0), 0)
            if extended:
                cnt_g[idx] = got[:nb]
        if hit_stats is not None and extended:
            hit_stats.update_counts(cnt_g)
        CH = 1 << 16
        for r0 in range(0, n_reads, CH):
            r1 = min(r0 + CH, n_reads)
            yield formatter(r0, r1, *res_g[:, r0:r1], norm_all[r0:r1],
                            cnt_g[r0:r1] if extended else None)

    def _probe_cols(self, max_len, stride: int) -> int:
        """Probed-window count for a batch whose longest read is max_len at
        the given stride tier: always-invalid pad columns beyond
        (max_len - k + 1) are trimmed before the probe.  Rounded up to a
        multiple of 32 so each tier has a handful of batch shapes; capped at
        the tier's full width."""
        w_full = max(stride - self.k + 1, 1)
        w = max(int(max_len) - self.k + 1, 1)
        w = -(-w // 32) * 32
        return min(w, w_full)

    def _header(self, extended: bool = False) -> bytes:
        cols = ["Object_ID"]
        if extended:
            cols += self.target_names[1:]
        cols += ["Gamma", "Assignment", "Score", "Confidence"]
        return (",".join(cols) + "\n").encode()

    # ---------------------------------------------------- native host path
    def _classify_native(self, data, scan: _ScanStream, t0: float,
                         paired: bool = False, extended=False,
                         hit_stats: HitStats | None = None):
        """Host side fully in C++ (scan/pack/format), device step in torch.

        Batches of consecutive reads in file order (`_plan_batches_stream`,
        which waits only for the reads of the batch it emits), each at its
        longest read's stride tier; each batch formats with one native call
        as soon as it is fetched.  `t0` is the call's start
        (time.perf_counter), from which a collector measures its fill."""
        k = self.k
        dev = self.device
        nbn = NBN if paired else 0
        # extended columns from the device's sorted label grid (O(windows)
        # on the device and ~2 B per window fetched) while label+1 fits
        # u16; dense [R, T+1] counts at 65,535 targets
        ext_runs = bool(extended) and self.n_targets < 65535
        ext_mode = "sorted" if ext_runs else extended
        max_reads = self.plan.max_reads
        if extended and not ext_runs:
            max_reads = self._dense_rows(max_reads)
        n_targets = self.n_targets if extended else 0
        edges = profiling.edges(t0)

        def dispatch(spec):
            r0, r1, stride, _ = spec
            ns, ne, ss, se, ln = scan.arrays(r0, r1)
            pc = self._probe_cols(ln.max(initial=1), stride)
            with maybe_phase("pack"):
                words, vwords = native.pack_batch(data, ss, se, stride)
            with maybe_phase("dispatch"):
                total, ib, b, sb, extra = self.batch_fn(
                    _to_dev(words, dev), _to_dev(vwords, dev),
                    extended=ext_mode, probe_cols=pc)
                res = torch.stack([total, ib, b, sb])
            if edges is not None:
                edges.dispatched()
            return (ns, ne, ln), res, extra

        def fetch(entry):
            # every launch and copy goes to the device's current (default)
            # stream, so these blocking copies also wait for the kernels;
            # a mesh's batch_fn may return pad rows past the batch's own
            meta, res, extra = entry
            nb = len(meta[2])
            with maybe_phase("device_wait"):
                res = res[:, :nb].cpu().numpy()
                extra = extra[:nb].cpu().numpy() if extended else None
            if ext_runs:
                extra = extra.view(np.uint16)
            return meta, res, extra

        entries = self._pipelined(self._plan_batches_stream(scan, max_reads),
                                  dispatch, put_wait="queue_full",
                                  get_wait="batch_wait")
        for (ns, ne, ln), res, extra in self._pipelined_pool(
                entries, fetch, workers=2, depth=2, wait="fetch_wait"):
            if extended and hit_stats is not None:
                if ext_runs:
                    hit_stats.update_runs(extra)
                else:
                    hit_stats.update_counts(extra)
            with maybe_phase("format"):
                rows = native.format_rows(
                    data, ns, ne, *res, ln - nbn, k, self.names,
                    counts=extra if extended and not ext_runs else None,
                    sorted_runs=extra if ext_runs else None,
                    n_targets=n_targets,
                )
                if edges is not None:
                    edges.taken()
                with maybe_phase("rows_held"):
                    yield rows
        if edges is not None:
            edges.close()

    # ------------------------------------------------------ the flat path
    def _classify_flat(self, rs: ReadSet, paired: bool, extended: bool,
                       hit_stats=None):
        """The flat sorted-array path (packed=False): every counted
        window's canonical value on the host (numpy), then a batch at a
        time the search K9 and K5's flat form (`query_fn`), and the Python
        format.  A batch holds at most max_queries windows and max_reads
        reads (capped to DENSE_COUNTS_BYTES of counts); a read of more
        windows than max_queries raises.  A batch is one query_fn call
        (one all-reduce on a process mesh), and its cuts depend only on
        the reads and the plan, so every process issues the same calls."""
        qvals, rid, woff = flat_queries(rs, self.k)
        norm = rs.read_lengths - (NBN if paired else 0)
        names = [rs.name(i) for i in range(rs.n_reads)]
        dev = self.device
        for r0, r1 in flat_read_cuts(woff, self.plan.max_queries,
                                     self._dense_rows(self.plan.max_reads)):
            q0, q1, nb = int(woff[r0]), int(woff[r1]), r1 - r0
            with maybe_phase("dispatch"):
                total, ib, b, sb, counts = self.query_fn(
                    self.index, _to_dev(qvals[q0:q1], dev),
                    torch.from_numpy((rid[q0:q1] - r0).astype(np.int32)).to(
                        dev), n_reads=nb)
            with maybe_phase("device_wait"):
                res = torch.stack([total, ib, b, sb]).cpu().numpy()
                counts = counts.cpu().numpy() if extended else None
            if hit_stats is not None and extended:
                hit_stats.update_counts(counts)
            with maybe_phase("format"):
                yield self._format_rows(names[r0:r1], *res, norm[r0:r1],
                                        counts)

    # --------------------------------------------------- threaded pipelining
    def _pipelined_pool(self, items, fn, workers: int, depth: int,
                        wait: str | None = None):
        """Ordered map with `workers` concurrent fn calls, up to `depth`
        submitted ahead (the result-fetch stage: blocking D2H copies of
        consecutive batches overlap each other and the formatting).  Under
        a collector, the consumer's waits for an unfinished call are the
        phase `wait`, where given."""
        with ThreadPoolExecutor(max_workers=workers) as ex:
            pending: collections.deque = collections.deque()
            it = iter(items)
            try:
                while True:
                    while it is not None and len(pending) < max(depth, workers):
                        try:
                            item = next(it)
                        except StopIteration:
                            it = None
                            break
                        pending.append(ex.submit(fn, item))
                    if not pending:
                        break
                    fut = pending.popleft()
                    with maybe_wait(wait, lambda: not fut.done()):
                        out = fut.result()
                    yield out
            finally:
                for f in pending:
                    f.cancel()

    def _pipelined(self, items, fn, depth: int | None = None,
                   put_wait: str | None = None,
                   get_wait: str | None = None):
        """Yield fn(item) in order, with fn running in a worker thread.

        Moving a stage into its own thread hides it behind the downstream
        stage's waits (the native scan/pack/format calls and the CUDA copies
        release the GIL).  Calls CHAIN: wrapping one `_pipelined` around
        another builds a multi-stage pipeline (pack+dispatch / fetch /
        format+yield) with one thread and one bounded queue per stage; the
        queue bound is the stage's depth (default BatchPlan.pipeline_depth).
        Under a collector, the worker's waits for room in a full queue are
        the phase `put_wait` and the consumer's waits on an empty one the
        phase `get_wait`, where given."""
        if depth is None:
            depth = self.plan.pipeline_depth
        q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        stop = threading.Event()
        err: list[BaseException] = []
        sentinel = object()

        def put(entry):
            while not stop.is_set():
                try:
                    q.put(entry, timeout=0.1)
                    return
                except queue.Full:
                    pass

        def worker():
            try:
                for item in items:
                    if stop.is_set():
                        return
                    entry = fn(item)
                    # the worker alone puts: a queue not full takes it now
                    with maybe_wait(put_wait, q.full):
                        put(entry)
            except BaseException as e:  # re-raised by the consumer
                err.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                # the consumer alone gets: a queue not empty gives at once
                with maybe_wait(get_wait, q.empty):
                    entry = q.get()
                if entry is sentinel:
                    break
                yield entry
            if err:
                raise err[0]
        finally:
            stop.set()
            t.join()

    # ------------------------------------------------ file-order planning
    def _plan_batches_stream(self, scan: _ScanStream, max_reads: int):
        """Consecutive batches (r0, r1, stride, r_cap) in file order, the
        JAX package's `_plan_batches` decisions over a streaming scan: a
        batch's stride is the tier of its longest read, widened until its
        r_cap = min(max_reads, window_budget // stride) reads fit; it waits
        only until the batch about to be emitted is scanned."""
        budget = self.plan.window_budget
        r0 = 0
        while True:
            if scan.ensure(r0 + 1) <= r0:
                return
            (first_len,) = scan.arrays(r0, r0 + 1)[4]
            stride = pack.quantized_stride(max(int(first_len), 1))
            if stride > budget:
                raise RuntimeError(
                    f"read of length {first_len} exceeds window budget "
                    f"{budget}")
            r_cap = max(min(max_reads, budget // stride), 1)
            while True:
                r1 = min(r0 + r_cap, scan.ensure(r0 + r_cap))
                s2 = pack.quantized_stride(int(scan.arrays(r0, r1)[4].max()))
                if s2 <= stride:
                    break
                stride = s2
                r_cap = max(min(max_reads, budget // stride), 1)
            yield r0, r1, stride, r_cap
            r0 = r1

    # ------------------------------------- length-bucketed planning (cycled)
    def _window_specs(self, tiers: np.ndarray, max_reads: int):
        """Window-relative batch specs [(idx, stride, r_pad)]: reads grouped
        by stride tier (np.unique ascending; original order preserved within
        each tier, so scattered results reproduce file order exactly)."""
        budget = self.plan.window_budget
        specs = []
        for t in np.unique(tiers):
            t = int(t)
            if t > budget:
                raise RuntimeError(
                    f"read of length ~{t} exceeds window budget {budget}"
                )
            idx = np.nonzero(tiers == t)[0]
            r_cap = max(min(max_reads, budget // t), 1)
            for i in range(0, len(idx), r_cap):
                chunk = idx[i : i + r_cap]
                specs.append((chunk, t, _pad_rows(len(chunk), r_cap)))
        return specs


def flat_queries(rs: ReadSet, k: int):
    """The flat path's host front end: (qvals [n] u64, the canonical value
    of every counted window in read order; rid [n], each window's read;
    woff [R+1], read r's windows at qvals[woff[r]:woff[r+1]])."""
    starts, rid = window_starts(rs, k)
    codes = np.where(rs.codes >= 0, rs.codes, 0).astype(np.int8)
    qvals = canonical_u64(window_values_le(codes, k, starts), k)
    woff = np.concatenate([[0], np.cumsum(np.bincount(
        rid, minlength=rs.n_reads))])
    return qvals, rid, woff


def flat_read_cuts(woff: np.ndarray, max_queries: int, max_reads: int):
    """The flat path's batches (r0, r1) of consecutive reads: at most
    max_reads reads and max_queries windows each; raises RuntimeError for
    a read of more windows than max_queries."""
    n_reads = len(woff) - 1
    r0 = 0
    while r0 < n_reads:
        r1 = min(r0 + max_reads, n_reads)
        if woff[r1] - woff[r0] > max_queries:
            r1 = int(np.searchsorted(woff, woff[r0] + max_queries,
                                     side="right")) - 1
            r1 = min(max(r1, r0 + 1), n_reads)
        nq = int(woff[r1] - woff[r0])
        if nq > max_queries:
            raise RuntimeError(
                f"single read exceeds query budget ({nq} > {max_queries}); "
                "increase BatchPlan.max_queries")
        yield r0, r1
        r0 = r1


def _format_row(name: bytes, total: int, index_best: int, best: int,
                s_best: int, norm: int, k: int, target_names: list[str],
                counts_row: np.ndarray | None) -> bytes:
    """One CSV row as the native formatter writes it: Gamma and Confidence
    in doubles with C's %g, as CuCLARK_hh.hh:2042-2051 computes them."""
    denom = float(norm) - k + 1.0
    if denom == 0.0:
        # C prints 0.0/0.0 as "-nan" (glibc); match it byte-for-byte
        return _format_row_nan(name, best, target_names, counts_row)
    gamma = float(total) / denom
    delta = float(best + s_best)
    conf = 0.0 if delta < 0.001 else float(best) / delta
    ext = b""
    if counts_row is not None:
        # columns 1..T of the dense count matrix
        ext = b"".join(b",%d" % int(c) for c in counts_row[1:])
    return b"%s%s,%s,%s,%u,%s\n" % (
        name, ext, _g(gamma), target_names[index_best].encode(), best,
        _g(conf))


def _format_row_nan(name, best, target_names, counts_row) -> bytes:
    ext = b""
    if counts_row is not None:
        ext = b"".join(b",%d" % int(c) for c in counts_row[1:])
    return b"%s%s,-nan,%s,%u,0\n" % (name, ext, target_names[0].encode(), best)


def _g(x: float) -> bytes:
    """C printf %g formatting (Python's %g matches)."""
    return b"%g" % x


def _query_single(index, q, qread, *, n_targets: int, n_reads: int):
    """One flat batch on one device: the search K9 of queries q [Q] int64
    (u64 bits) in a lookup.FlatIndex, then K5's flat form over the reads
    qread [Q] int32 in [0, n_reads).  Returns (total, ibest, best, sbest,
    counts [n_reads, T+1]), as the JAX package's _query_single does."""
    with torch.inference_mode():
        lab = lookup.lookup_labels(index, q)
        counts, total, ib, b, _, sb = score.counts_flat(lab, qread, n_reads,
                                                        n_targets)
        return total, ib, b, sb, counts
