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

Modes outside this slice (out-of-core cycling, the dense table, device
meshes, concurrent files, the flat path) raise NotImplementedError naming
their ROADMAP item.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
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
from .io.fasta import iter_merged_slabs, iter_record_cuts, iter_record_slabs
from .io.targets import TargetsDef, parse_targets
from .ops import device_pipeline, radix_table
from .params import NBN, Profile
from .utils import native
from .utils.profiling import maybe_phase

RESERVED = 768 << 20  # device headroom beyond the table and batch transients
# device bytes of one batch's dense [R, T+1] count matrix (extended output
# at 65,535 targets): rows per batch are capped to fit it.  The CSV does
# not depend on batch shapes.
DENSE_COUNTS_BYTES = 256 << 20


@dataclasses.dataclass
class BatchPlan:
    """Batch shapes and pipeline depth of the device step."""

    max_reads: int = 1 << 16  # reads per batch
    window_budget: int = 1 << 23  # R*stride char slots per batch
    pipeline_depth: int = 6  # batches packed and dispatched ahead of the fetch
    scan_chunk_bytes: int = 8 << 20  # streamed-scan granularity: the record
    # scan runs in a background thread in chunks of this size, so the first
    # batch dispatches after ~one chunk's scan instead of the whole input's
    sort_window_batches: int = 8  # length-bucketed planning window in
    # batches: reads of a window are grouped by stride tier (stable within a
    # tier) so mixed-length inputs pack into dense same-stride batches; the
    # window is also the result-reorder granularity


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
                for s, e in iter_record_cuts(buf, is_fq, chunk_bytes):
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
        with self._cond:
            while self._cum[-1] < n and not self._done:
                self._cond.wait()
            if self._err is not None:
                raise self._err
            return self._cum[-1]

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


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to jn_cuclark_tpu_torch yet (ROADMAP {item})"
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
    """Single-device CLARK classifier over a resident radix table."""

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
    ):
        if mesh is not None:
            raise _not_ported("classification over a device mesh", "A9")
        if not packed:
            raise NotImplementedError(
                "the flat sorted-array path (packed=False) is not ported: "
                "ROADMAP lists it under 'Do not port'"
            )
        if db_cycles not in ("auto", 0, None, 1):
            raise _not_ported(f"out-of-core cycling (db_cycles={db_cycles})",
                              "A7")
        self.profile = profile
        self.k = k
        self.target_names = target_names
        self.n_targets = len(target_names) - 1  # names include NA at 0
        self.plan = plan or BatchPlan()
        self.device = _resolve_device(device)

        table = prebuilt_table
        if table is None and index_cache is not None and os.path.exists(
            index_cache
        ):
            table = radix_table.load_cache(index_cache, signature=index_sig)
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
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            # per batch in flight: q (8 B) + labels (4 B) + packed words per
            # char slot, rounded up to 16 B
            transient = self.plan.window_budget * 16 * (
                self.plan.pipeline_depth + 1
            )
            budget = free - RESERVED - transient
            if table.nbytes > budget:
                raise _not_ported(
                    f"a {table.nbytes >> 20} MB table above the device budget "
                    f"of {max(budget, 0) >> 20} MB (out-of-core cycling or "
                    "the dense table)",
                    "A7",
                )
        self.table = radix_table.to_device(table, self.device)
        self.names = native.NamesBuffer(self.target_names)

    def batch_fn(self, words, vwords, extended=False, probe_cols=None):
        return device_pipeline.classify_batch(
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
        # valid only for unsampled loads (sampling changes the key set)
        use_cache = sampling_factor == 1
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
        )

    # -------------------------------------------------------------- classify
    def classify_bytes(self, data: bytes, paired: bool = False,
                       extended: bool = False,
                       hit_stats: HitStats | None = None):
        """Classify one in-memory FASTA/FASTQ file (with paired=True, mates
        already merged, as merge_paired gives them); returns (rows,
        n_reads), rows a generator of formatted CSV body chunks (whole
        lines).  `hit_stats` (extended runs only) accumulates the
        reference's MIN/MAX/AVG distinct-targets-hit report."""
        n_reads = native.quick_count(data)
        scan = _ScanStream(data, self.plan.scan_chunk_bytes)
        return self._classify_native(data, scan, paired, extended,
                                     hit_stats), n_reads

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
        # inside _classify_native
        scanned = (
            self._pipelined(itertools.chain([first], slabs), lambda s: s,
                            depth=1)
            if first is not None else iter(())
        )
        hs = HitStats(self.n_targets) if extended else None
        with open(out, "wb") as f:
            f.write(self._header(extended))
            for slab in scanned:
                scan = _ScanStream(slab, self.plan.scan_chunk_bytes)
                for chunk in self._classify_native(slab, scan, paired,
                                                   extended, hs):
                    f.write(chunk)
                n_reads += scan.total()
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
    def _classify_native(self, data, scan: _ScanStream, paired: bool = False,
                         extended=False, hit_stats: HitStats | None = None):
        """Host side fully in C++ (scan/pack/format), device step in torch.

        Length-bucketed: reads of each planning window are grouped by stride
        tier into dense batches; per-read results scatter back into window
        order and each window formats with ONE native call, so the CSV is
        byte-identical to file-order planning."""
        k = self.k
        dev = self.device
        nbn = NBN if paired else 0
        # extended: one batch per planning window, so a window's extended
        # columns (a read's sorted labels or dense counts) stay one batch's
        wb = 1 if extended else self.plan.sort_window_batches
        # extended columns from the device's sorted label grid (O(windows)
        # on the device and ~2 B per window fetched) while label+1 fits
        # u16; dense [R, T+1] counts at 65,535 targets
        ext_runs = bool(extended) and self.n_targets < 65535
        ext_mode = "sorted" if ext_runs else extended
        max_reads = self.plan.max_reads
        if extended and not ext_runs:
            max_reads = min(max_reads, max(
                DENSE_COUNTS_BYTES // (4 * (self.n_targets + 1)), 1))
        n_targets = self.n_targets if extended else 0

        def flat_batches():
            wid = 0
            for item in self._plan_hybrid_stream(scan, wb, max_reads):
                if item[0] == "direct":
                    yield ("d",) + item[1:]
                    continue
                _, w0, arrs, specs = item
                lens = arrs[4]
                pcs = [
                    self._probe_cols(lens[idx].max(initial=1), stride)
                    for idx, stride, _ in specs
                ]
                max_w = max(pcs)
                for (idx, stride, r_pad), pc in zip(specs, pcs):
                    yield ("w", wid, arrs, len(specs), idx, stride, r_pad,
                           pc, max_w)
                wid += 1

        def to_dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a.view(np.int64)).to(dev)

        def dispatch(item):
            if item[0] == "d":
                _, r0, r1, stride, r_cap = item
                ns, ne, ss, se, ln = scan.arrays(r0, r1)
                pc = self._probe_cols(ln.max(initial=1), stride)
                r_pad = _pad_rows(r1 - r0, r_cap)
                meta = ("d", (ns, ne, ln), r1 - r0)
            else:
                _, wid, arrs, n_specs, idx, stride, r_pad, pc, max_w = item
                ss, se = arrs[2][idx], arrs[3][idx]
                meta = ("w", wid, arrs, n_specs, idx, max_w)
            with maybe_phase("pack"):
                words, vwords = native.pack_batch(data, ss, se, stride)
                words, vwords = _pad_batch(words, vwords, r_pad)
            with maybe_phase("dispatch"):
                total, ib, b, sb, extra = self.batch_fn(
                    to_dev(words), to_dev(vwords), extended=ext_mode,
                    probe_cols=pc,
                )
                return meta, torch.stack([total, ib, b, sb]), extra

        def fetch(entry):
            # every launch and copy goes to the device's current (default)
            # stream, so these blocking copies also wait for the kernels
            meta, res, extra = entry
            nb = meta[2] if meta[0] == "d" else len(meta[4])
            with maybe_phase("device_wait"):
                res = res[:, :nb].cpu().numpy()
                extra = extra[:nb].cpu().numpy() if extended else None
            if ext_runs:
                extra = extra.view(np.uint16)
            return meta, res, extra

        def hits(extra):
            if hit_stats is not None:
                if ext_runs:
                    hit_stats.update_runs(extra)
                else:
                    hit_stats.update_counts(extra)

        def fmt(ns, ne, ln, res, extra):
            with maybe_phase("format"):
                return native.format_rows(
                    data, ns, ne, *res, ln - nbn, k, self.names,
                    counts=extra if extended and not ext_runs else None,
                    sorted_runs=extra if ext_runs else None,
                    n_targets=n_targets,
                )

        acc: dict[int, dict] = {}
        entries = self._pipelined(flat_batches(), dispatch)
        for meta, res, extra in self._pipelined_pool(entries, fetch,
                                                     workers=2, depth=2):
            if meta[0] == "d":
                _, (ns, ne, ln), nb = meta
                if extended:
                    hits(extra)
                yield fmt(ns, ne, ln, res, extra)
                continue
            _, wid, arrs, n_specs, idx, max_w = meta
            st = acc.get(wid)
            if st is None:
                n_win = len(arrs[4])
                if ext_runs:
                    ext = np.zeros((n_win, max_w), np.uint16)
                elif extended:
                    ext = np.zeros((n_win, self.n_targets + 1), np.int32)
                else:
                    ext = None
                st = acc[wid] = dict(
                    remaining=n_specs,
                    res=np.zeros((4, n_win), np.int32),
                    extra=ext,
                )
            st["res"][:, idx] = res
            if ext_runs:
                # right-align narrower tiers: the pad zeros land BEFORE the
                # row's own (ascending, zeros-first) labels, keeping every
                # row ascending for the run expander
                st["extra"][idx, max_w - extra.shape[1]:] = extra
            elif extended:
                st["extra"][idx] = extra
            st["remaining"] -= 1
            if st["remaining"] == 0:
                del acc[wid]
                ns, ne, _, _, ln = arrs
                if extended:
                    hits(st["extra"])
                yield fmt(ns, ne, ln, st["res"], st["extra"])

    # --------------------------------------------------- threaded pipelining
    def _pipelined_pool(self, items, fn, workers: int, depth: int):
        """Ordered map with `workers` concurrent fn calls, up to `depth`
        submitted ahead (the result-fetch stage: blocking D2H copies of
        consecutive batches overlap each other and the formatting)."""
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
                    yield pending.popleft().result()
            finally:
                for f in pending:
                    f.cancel()

    def _pipelined(self, items, fn, depth: int | None = None):
        """Yield fn(item) in order, with fn running in a worker thread.

        Moving a stage into its own thread hides it behind the downstream
        stage's waits (the native scan/pack/format calls and the CUDA copies
        release the GIL).  Calls CHAIN: wrapping one `_pipelined` around
        another builds a multi-stage pipeline (pack+dispatch / fetch /
        format+yield) with one thread and one bounded queue per stage; the
        queue bound is the stage's depth (default BatchPlan.pipeline_depth)."""
        if depth is None:
            depth = self.plan.pipeline_depth
        q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        stop = threading.Event()
        err: list[BaseException] = []
        sentinel = object()

        def worker():
            try:
                for item in items:
                    if stop.is_set():
                        return
                    entry = fn(item)
                    while not stop.is_set():
                        try:
                            q.put(entry, timeout=0.1)
                            break
                        except queue.Full:
                            pass
            except BaseException as e:  # re-raised by the consumer
                err.append(e)
            finally:
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        pass

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                entry = q.get()
                if entry is sentinel:
                    break
                yield entry
            if err:
                raise err[0]
        finally:
            stop.set()
            t.join()

    # ----------------------------------------------- length-bucketed planning
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

    def _plan_hybrid_stream(self, scan: _ScanStream, window_batches: int,
                            max_reads: int):
        """Adaptive streaming planner.  While the stream is single-tier it
        yields ("direct", r0, r1, stride, r_cap) file-order contiguous
        batches, so dispatch stays scan-paced.  When a candidate batch mixes
        tiers it yields ("window", w0, arrs, specs) length-bucketed windows
        of ~window_batches' worth of padded chars, packed into dense
        same-stride batches."""
        budget = self.plan.window_budget
        wbudget = budget * max(window_batches, 1)
        CH = 1 << 14
        r0 = 0
        while True:
            if scan.ensure(r0 + 1) <= r0:
                return
            (first_len,) = scan.arrays(r0, r0 + 1)[4]
            t0 = int(_stride_tiers(np.array([first_len]))[0])
            if t0 > budget:
                raise RuntimeError(
                    f"read of length ~{first_len} exceeds window budget "
                    f"{budget}"
                )
            r_cap = max(min(max_reads, budget // t0), 1)
            avail = scan.ensure(r0 + r_cap)
            r1 = min(r0 + r_cap, avail)
            tiers = _stride_tiers(scan.arrays(r0, r1)[4])
            if np.all(tiers == t0):
                yield "direct", r0, r1, t0, r_cap
                r0 = r1
                continue
            w1, cost, parts = r0, 0, []
            while cost < wbudget:
                avail = scan.ensure(w1 + CH)
                take = min(avail, w1 + CH)
                if take == w1:
                    break
                t = _stride_tiers(scan.arrays(w1, take)[4])
                cum = np.cumsum(t, dtype=np.int64) + cost
                if cum[-1] >= wbudget:
                    cut = int(np.searchsorted(cum, wbudget, side="left")) + 1
                    cut = min(cut, len(t))
                    parts.append(t[:cut])
                    w1 += cut
                    break
                parts.append(t)
                cost = int(cum[-1])
                w1 = take
            tiers = np.concatenate(parts)
            yield ("window", r0, scan.arrays(r0, w1),
                   self._window_specs(tiers, max_reads))
            r0 = w1
