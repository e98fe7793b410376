"""ctypes bindings for the native C++ host runtime (`native/clark_native.cpp`,
with the port's own `jn_cuclark_tpu_torch/native/record_cut.cpp`).

The runtime (FASTA/FASTQ record scan and record cuts, the paired-end merge,
2-bit packing, `%g` CSV formatting, k-mer extraction, the host DB-build
aggregate, DB serialization and the abundance scan of result CSVs) is
compiled from the repository's sources at first use with
`g++ -O3 -fPIC -fopenmp -shared` (utils/build.py); the committed `native/libclark_native.so` is not loaded,
because it was built with `-march=native` on another host.  The port has
no pure-numpy fallback for these entry points: a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .build import REPO_ROOT, build_library

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U16P = ctypes.POINTER(ctypes.c_uint16)

SOURCE = os.path.join(REPO_ROOT, "native", "clark_native.cpp")
CUT_SOURCE = os.path.join(
    REPO_ROOT, "jn_cuclark_tpu_torch", "native", "record_cut.cpp"
)

_lib = None
_lock = threading.Lock()


def _compile_command(out: str) -> list[str]:
    # `g++` from PATH, not $CXX: the runtime needs OpenMP (libgomp), which
    # a wrapper compiler named by $CXX may lack
    return ["g++", "-O3", "-fPIC", "-fopenmp", "-shared", "-o", out, SOURCE,
            CUT_SOURCE]


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(
            build_library("clark_native", [SOURCE, CUT_SOURCE],
                          _compile_command)
        )
        lib.scan_fasta.restype = ctypes.c_int64
        lib.scan_fasta.argtypes = (
            [_U8P, ctypes.c_int64, ctypes.c_int64] + [_I64P] * 5
        )
        lib.scan_fastq.restype = ctypes.c_int64
        lib.scan_fastq.argtypes = lib.scan_fasta.argtypes
        lib.record_cut.restype = ctypes.c_int64
        lib.record_cut.argtypes = [
            _U8P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, _I64P,
        ]
        lib.pack_batch.restype = None
        lib.pack_batch.argtypes = [
            _U8P, ctypes.c_int64, _I64P, _I64P, ctypes.c_int64, _U64P, _U64P,
        ]
        lib.format_rows.restype = ctypes.c_int64
        lib.format_rows.argtypes = [
            _U8P, _I64P, _I64P, _I32P, _I32P, _I32P, _I32P, _I64P,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_char_p, _I64P,
            ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.format_rows_extended.restype = ctypes.c_int64
        lib.format_rows_extended.argtypes = [
            _U8P, _I64P, _I64P, _I32P, _I32P, _I32P, _I32P, _I32P, _I64P,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p,
            _I64P, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.format_rows_extended_sorted.restype = ctypes.c_int64
        lib.format_rows_extended_sorted.argtypes = [
            _U8P, _I64P, _I64P, _U16P, ctypes.c_int64, _I32P, _I32P, _I32P,
            _I32P, _I64P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_char_p, _I64P, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.merge_paired_chunk.restype = ctypes.c_int64
        lib.merge_paired_chunk.argtypes = [
            _U8P, ctypes.c_int64, _U8P, ctypes.c_int64, _I64P, _I64P,
            _U8P, ctypes.c_int64, _I32P,
        ]
        lib.saturating_group_sum.restype = None
        lib.saturating_group_sum.argtypes = [_I64P, ctypes.c_int64, _I64P,
                                             _I64P]
        lib.aggregate_occurrences.restype = ctypes.c_int64
        lib.aggregate_occurrences.argtypes = [
            _U64P, _I32P, ctypes.c_int64, _I32P, ctypes.c_int32,
            _U64P, _I32P, _I32P, _I64P, _I64P,
        ]
        lib.occ_partition_count.restype = None
        lib.occ_partition_count.argtypes = [
            _U64P, ctypes.c_int64, ctypes.c_int32, _I64P,
        ]
        lib.occ_partition_scatter.restype = None
        lib.occ_partition_scatter.argtypes = [
            _U64P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_int32, _I64P, ctypes.c_void_p,
        ]
        lib.aggregate_kv_range.restype = ctypes.c_int64
        lib.aggregate_kv_range.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, _I32P, ctypes.c_int32,
            _U64P, _I32P, _I32P, _I64P, _I64P,
        ]
        lib.extract_canonical.restype = ctypes.c_int64
        lib.extract_canonical.argtypes = [
            _U8P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, _U64P,
        ]
        lib.serialize_db.restype = ctypes.c_int32
        lib.serialize_db.argtypes = [
            _U64P, _U16P, ctypes.c_int64, ctypes.c_uint64, ctypes.c_int32,
            ctypes.c_int32, _U8P, _U8P, _U16P,
        ]
        lib.serialize_db_parts.restype = ctypes.c_int32
        lib.serialize_db_parts.argtypes = [
            _U64P, _U16P, ctypes.c_int64, ctypes.c_uint64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, _U8P, _U8P, _U16P,
        ]
        lib.abundance_scan.restype = ctypes.c_int64
        lib.abundance_scan.argtypes = [
            _U8P, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double, _U64P,
        ]
        _lib = lib
        return lib


def _u8(data) -> tuple[np.ndarray, _U8P]:
    arr = np.frombuffer(data, dtype=np.uint8)
    return arr, arr.ctypes.data_as(_U8P)


def _p(a, tp):
    return a.ctypes.data_as(tp)


def scan_reads(
    data: bytes,
    start: int = 0,
    end: int | None = None,
    is_fasta: bool | None = None,
):
    """(is_fasta, name_start, name_end, seq_start, seq_end, length).

    With start/end, scans only data[start:end] (which must begin at a record
    boundary — a '>' header line or FASTQ line-phase 0) WITHOUT copying;
    returned offsets are absolute into `data`.  Pass is_fasta when scanning
    a chunk of a larger buffer: the format belongs to the WHOLE file (its
    first byte), and a malformed header landing on a chunk boundary must not
    change how that chunk is scanned.

    The bytes are read once, by the native scan: its arrays start at one
    read a 128 bytes and, where the reads overflow them, grow twofold and
    the scan runs again."""
    lib = _load()
    arr, _ = _u8(data)
    if end is None:
        end = len(arr)
    n = end - start
    if n <= 0:
        raise ValueError("empty input file")
    seg = arr[start:end]
    dp = seg.ctypes.data_as(_U8P)
    if is_fasta is None:
        first = bytes(seg[:1])
        if first == b">":
            is_fasta = True
        elif first == b"@":
            is_fasta = False
        else:
            raise ValueError("failed to recognize the format of the file")
    fn = lib.scan_fasta if is_fasta else lib.scan_fastq
    cap = n // 128 + 16
    while True:
        ns, ne, ss, se, ln = (np.empty(cap, np.int64) for _ in range(5))
        r = fn(dp, n, cap, _p(ns, _I64P), _p(ne, _I64P), _p(ss, _I64P),
               _p(se, _I64P), _p(ln, _I64P))
        if r == -2:
            cap *= 2
            continue
        if r < 0:
            raise ValueError("scan failed")
        break
    ns, ne, ss, se, ln = ns[:r], ne[:r], ss[:r], se[:r], ln[:r]
    if start:
        for a in (ns, ne, ss, se):
            a += start
    return is_fasta, ns, ne, ss, se, ln


def record_cut(data, pos: int, want: int, is_fq: bool) -> tuple[int, int]:
    """(cut, looked): the end of the record-aligned chunk of `data` (any
    buffer: bytes, an mmap) that starts at the record boundary `pos`, for a
    window of `want` bytes, and the bytes the search read.  FASTA cuts
    before the last '>' that follows a newline in the window, searched from
    the window's end; FASTQ after the last newline whose count from pos is
    a multiple of 4; a window that reaches the end cuts there, and one with
    no cut doubles.  No view of `data` outlives the call, so an mmap can be
    closed between calls."""
    if want < 1:
        raise ValueError(f"a chunk of {want} bytes holds no record")
    lib = _load()
    arr, dp = _u8(data)
    looked = ctypes.c_int64()
    cut = lib.record_cut(dp, len(arr), pos, want, is_fq, ctypes.byref(looked))
    return cut, looked.value


def abundance_scan(
    body, idx: int, min_gamma: float, min_conf: float, offset: int = 0
):
    """(labels, counts, total) of a classification-CSV body (any
    buffer-protocol object, e.g. an mmap, starting at `offset`), or None
    where the native scan cannot replicate the Python line loop of
    abundance.estimate exactly (labels over 8 bytes or holding NUL, floats
    such as `0.7_5` that strtod and Python parse differently); the loop
    then reads the file.  Labels come in first-appearance order, as
    estimate's dict order has them."""
    lib = _load()
    arr, _ = _u8(body)
    arr = arr[offset:]
    n = len(arr)
    if n == 0:
        return [], np.zeros(0, np.int64), 0
    cap = int(np.count_nonzero(arr == ord("\n"))) + int(
        np.count_nonzero(arr == ord("\r"))
    ) + 1
    keys = np.empty(cap, np.uint64)
    total = lib.abundance_scan(
        arr.ctypes.data_as(_U8P), n, idx, float(min_gamma), float(min_conf),
        _p(keys, _U64P),
    )
    if total < 0:
        return None
    keys = keys[:total]
    uniq, first, counts = np.unique(keys, return_index=True, return_counts=True)
    order = np.argsort(first, kind="stable")
    try:
        labels = [
            int(u).to_bytes(8, "little").rstrip(b"\x00").decode()
            for u in uniq[order]
        ]
    except UnicodeDecodeError:  # a non-UTF-8 label: the Python loop decides
        return None
    return labels, counts[order], int(total)


def quick_count(data: bytes) -> int:
    """Exact record count of a FASTA/FASTQ buffer via substring counts only.

    Reproduces the scanners' record rules (scan_fasta: one record per '>' at
    line start; scan_fastq: one record per 4-line group whose sequence line
    START exists — truncated trailing header+sequence kept, lone header
    dropped) so `classify_bytes` can report n_reads before the streamed scan
    finishes."""
    if not data:
        raise ValueError("empty input file")
    first = data[0:1]
    if first == b">":
        return data.count(b"\n>") + 1
    if first == b"@":
        nl = data.count(b"\n")
        line_starts = 1 + nl - (1 if data.endswith(b"\n") else 0)
        return (line_starts + 2) // 4
    raise ValueError("failed to recognize the format of the file")


def pack_batch(data: bytes, seq_start: np.ndarray, seq_end: np.ndarray, stride: int):
    """(words [R, stride/32+1] u64, vwords [R, stride/64+1] u64) of the reads
    data[seq_start[i]:seq_end[i]] (ops/pack.py layout)."""
    lib = _load()
    arr, dp = _u8(data)
    nreads = len(seq_start)
    W = stride // 32 + 1
    WV = stride // 64 + 1
    words = np.empty((nreads, W), np.uint64)
    vwords = np.empty((nreads, WV), np.uint64)
    ss = np.ascontiguousarray(seq_start, np.int64)
    se = np.ascontiguousarray(seq_end, np.int64)
    lib.pack_batch(dp, nreads, _p(ss, _I64P), _p(se, _I64P), stride,
                   _p(words, _U64P), _p(vwords, _U64P))
    return words, vwords


class NamesBuffer:
    """Target-name table for the native formatter (NUL-joined)."""

    def __init__(self, target_names: list[str]):
        offs = []
        buf = bytearray()
        for t in target_names:
            offs.append(len(buf))
            buf += t.encode() + b"\x00"
        self.buf = bytes(buf)
        self.off = np.array(offs, dtype=np.int64)


def format_rows(
    data: bytes, name_start, name_end, total, ibest, best, sbest, norm,
    k: int, names: NamesBuffer, counts=None, n_targets: int = 0,
    sorted_runs=None,
) -> bytes:
    """CSV body rows with C `%g` (the reference's writers,
    CuCLARK_hh.hh:2042-2051 and, extended, 2110-2118).

    Extended rows carry one count column per target, from either the dense
    `counts` [nreads, n_targets+1] int32 or `sorted_runs` [nreads, width]
    uint16: each read's per-window label+1 row sorted ascending (zeros
    first), whose runs expand to the per-target counts."""
    lib = _load()
    arr, dp = _u8(data)
    nreads = len(total)
    ns = np.ascontiguousarray(name_start, np.int64)
    ne = np.ascontiguousarray(name_end, np.int64)
    tt = np.ascontiguousarray(total, np.int32)
    ib = np.ascontiguousarray(ibest, np.int32)
    bb = np.ascontiguousarray(best, np.int32)
    sb = np.ascontiguousarray(sbest, np.int32)
    nm = np.ascontiguousarray(norm, np.int64)
    names_args = (names.buf, _p(names.off, _I64P))
    if sorted_runs is not None:
        sl = np.ascontiguousarray(sorted_runs, np.uint16)
        width = sl.shape[1] if sl.ndim == 2 else 0
        cap = nreads * (192 + 12 * n_targets) + 1024
        out = ctypes.create_string_buffer(cap)
        w = lib.format_rows_extended_sorted(
            dp, _p(ns, _I64P), _p(ne, _I64P), _p(sl, _U16P), width,
            _p(tt, _I32P), _p(ib, _I32P), _p(bb, _I32P), _p(sb, _I32P),
            _p(nm, _I64P), nreads, n_targets, k, *names_args, out, cap,
        )
    elif counts is not None:
        cc = np.ascontiguousarray(counts, np.int32)
        cap = nreads * (192 + 12 * n_targets) + 1024
        out = ctypes.create_string_buffer(cap)
        w = lib.format_rows_extended(
            dp, _p(ns, _I64P), _p(ne, _I64P), _p(cc, _I32P), _p(tt, _I32P),
            _p(ib, _I32P), _p(bb, _I32P), _p(sb, _I32P), _p(nm, _I64P),
            nreads, n_targets, k, *names_args, out, cap,
        )
    else:
        cap = nreads * 192 + 1024
        out = ctypes.create_string_buffer(cap)
        w = lib.format_rows(
            dp, _p(ns, _I64P), _p(ne, _I64P), _p(tt, _I32P), _p(ib, _I32P),
            _p(bb, _I32P), _p(sb, _I32P), _p(nm, _I64P), nreads, k,
            *names_args, out, cap,
        )
    if w < 0:
        raise RuntimeError("format_rows buffer overflow")
    return out.raw[:w]


# ---------------------------------------------------------- paired-end merge
def merge_paired_stream(data1, data2, chunk_cap: int = 1 << 28):
    """Yield merged-FASTA chunks of two FASTQ buffers (file.cc:205-268
    semantics) through a bounded native buffer; data1/data2 may be mmaps, so
    a multi-GB pair merges with O(chunk_cap) memory."""
    lib = _load()
    a1, dp1 = _u8(data1)
    a2, dp2 = _u8(data2)
    try:
        n1, n2 = len(a1), len(a2)
        if a1[:1].tobytes() != b"@" or a2[:1].tobytes() != b"@":
            raise ValueError("paired-end reads must be FASTQ files")
        pos = np.zeros(2, dtype=np.int64)
        status = np.zeros(1, dtype=np.int32)
        # the merged output never exceeds the combined input (+16 framing
        # headroom), so small in-memory merges allocate small buffers
        cap = min(int(chunk_cap), n1 + n2 + 16)
        out = np.empty(cap, dtype=np.uint8)
        while True:
            w = lib.merge_paired_chunk(
                dp1, n1, dp2, n2,
                _p(pos[0:1], _I64P), _p(pos[1:2], _I64P),
                _p(out, _U8P), cap, _p(status, _I32P),
            )
            st = int(status[0])
            if st == -1:
                raise ValueError("read id does not match between files")
            if st == -2:  # a single record exceeds cap
                cap *= 2
                out = np.empty(cap, dtype=np.uint8)
                continue
            if w:
                yield out[:w].tobytes()
            if st == 0:
                return
    finally:
        # drop the buffer views before the caller's mmap close; an exception's
        # traceback keeps this frame alive, and exported views make
        # mmap.close() raise BufferError, masking the real error
        del a1, a2, dp1, dp2


# ------------------------------------------------------------- DB build ops
def extract_canonical(data: bytes, k: int, light: bool, gap: int) -> np.ndarray:
    """Rolling canonical k-mer extraction of a FASTA/FASTQ buffer."""
    lib = _load()
    arr, dp = _u8(data)
    n = len(arr)
    out = np.empty(max(n, 1), dtype=np.uint64)
    w = lib.extract_canonical(dp, n, k, 1 if light else 0, max(gap, 1),
                              _p(out, _U64P))
    if w < 0:
        raise ValueError("failed to recognize the format of the file")
    return out[:w]  # view; keeps the base buffer alive


class BucketOverflowError(ValueError):
    """A hash bucket exceeded the format's 255-entry cap
    (hashTable_hh.hh:499-507)."""


def serialize_db(canon, labels, htsize: int, rem_bits: int, key_dtype):
    """Fused bucket-major DB layout: (sizes u8[htsize], keys, labels)
    ready for .sz/.ky/.lb tofile.  Raises BucketOverflowError when a bucket
    exceeds 255 entries."""
    return _serialize(canon, labels, htsize, rem_bits, key_dtype, 0)


def serialize_db_parts(canon, labels, htsize: int, rem_bits: int, key_dtype,
                       pbits: int):
    """serialize_db with remainder-range partitioning: the stable sort's
    temp is one partition, bounding host memory at RefSeq scale.  Output
    byte-identical to serialize_db."""
    return _serialize(canon, labels, htsize, rem_bits, key_dtype, pbits)


def _serialize(canon, labels, htsize, rem_bits, key_dtype, pbits):
    lib = _load()
    canon = np.ascontiguousarray(canon, np.uint64)
    labels = np.ascontiguousarray(labels, np.uint16)
    n = len(canon)
    sizes = np.zeros(htsize, np.uint8)
    keys = np.empty(max(n, 1), key_dtype)
    labs = np.empty(max(n, 1), np.uint16)
    args = (_p(canon, _U64P), _p(labels, _U16P), n, htsize, rem_bits,
            np.dtype(key_dtype).itemsize)
    outs = (_p(sizes, _U8P), keys.ctypes.data_as(_U8P), _p(labs, _U16P))
    if pbits > 0:
        rc = lib.serialize_db_parts(*args, pbits, *outs)
    else:
        rc = lib.serialize_db(*args, *outs)
    if rc != 0:
        raise BucketOverflowError("bucket list size exceeds 255")
    return sizes, keys[:n], labs[:n]


def saturating_group_sum(bounds: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Per-group lElement.AddToCount saturating sums (dataType.hh:333-334);
    group g spans v[bounds[g]:bounds[g+1]]."""
    lib = _load()
    bounds = np.ascontiguousarray(bounds, np.int64)
    v = np.ascontiguousarray(v, np.int64)
    ngroups = len(bounds) - 1
    out = np.empty(max(ngroups, 1), np.int64)
    lib.saturating_group_sum(_p(bounds, _I64P), ngroups, _p(v, _I64P),
                             _p(out, _I64P))
    return out[:ngroups]


KV_DTYPE = np.dtype([("k", "<u8"), ("v", "<i8")])  # native KV struct layout


def occ_partition_count(canon, shift: int, counts):
    """Accumulate per-partition occurrence counts (pid = canon >> shift)."""
    lib = _load()
    canon = np.ascontiguousarray(canon, np.uint64)
    lib.occ_partition_count(_p(canon, _U64P), len(canon), shift,
                            _p(counts, _I64P))


def occ_partition_scatter(canon, label: int, base_index: int, shift: int,
                          cursors, kv_buf):
    """Scatter one file's occurrences (constant label) into the KV
    partition buffer (payload = global index << 16 | label); cursors
    advance in place."""
    lib = _load()
    canon = np.ascontiguousarray(canon, np.uint64)
    lib.occ_partition_scatter(
        _p(canon, _U64P), len(canon), label, base_index, shift,
        _p(cursors, _I64P), kv_buf.ctypes.data,
    )


def _aggregate_outputs(n: int):
    return (np.empty(max(n, 1), np.uint64), np.empty(max(n, 1), np.int32),
            np.empty(max(n, 1), np.int32), np.empty(max(n, 1), np.int64),
            np.empty(max(n, 1), np.int64))


def aggregate_kv_range(kv_buf, start: int, n: int, pg, lelement: bool):
    """Sort + aggregate one partition [start, start+n) of the KV buffer in
    place; returns (canon, L0, mult, count, first_seq) for that range."""
    lib = _load()
    pg = np.ascontiguousarray(pg, np.int32)
    outs = _aggregate_outputs(n)
    oc, ol, om, on, of = outs
    ng = lib.aggregate_kv_range(
        kv_buf.ctypes.data + start * KV_DTYPE.itemsize, n, _p(pg, _I32P),
        1 if lelement else 0,
        _p(oc, _U64P), _p(ol, _I32P), _p(om, _I32P), _p(on, _I64P),
        _p(of, _I64P),
    )
    return tuple(a[:ng].copy() for a in outs)


def aggregate_occurrences(canon, label, pg, lelement: bool):
    """(canon_u, L0, mult, count, first_seq) for unit-count occurrences in
    stream order: the host aggregate (sort by (canonical, stream index),
    then one pass applying the multiplicity/count rules)."""
    lib = _load()
    canon = np.ascontiguousarray(canon, np.uint64)
    label = np.ascontiguousarray(label, np.int32)
    pg = np.ascontiguousarray(pg, np.int32)
    n = len(canon)
    outs = _aggregate_outputs(n)
    oc, ol, om, on, of = outs
    ng = lib.aggregate_occurrences(
        _p(canon, _U64P), _p(label, _I32P), n, _p(pg, _I32P),
        1 if lelement else 0,
        _p(oc, _U64P), _p(ol, _I32P), _p(om, _I32P), _p(on, _I64P),
        _p(of, _I64P),
    )
    return tuple(a[:ng] for a in outs)  # views
