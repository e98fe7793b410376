"""Vectorized FASTA/FASTQ ingestion.

Replaces the reference's byte-at-a-time OpenMP scanners with numpy vectorized
passes over the whole (memory-mapped) file:

  * classification read scan   — reference CuCLARK_hh.hh:1340-1534
  * target-genome k-mer stream — reference CuCLARK_hh.hh:691-1329 (build)

  * paired-end merge          — reference file.cc:205-268 (native chunked
                                merger; `_merge_paired_py` is its plain
                                reference)

Semantics reproduced exactly:
  * FASTA records split on lines starting with '>'; sequence lines are
    concatenated (newlines are not part breaks).
  * FASTQ reads are the 2nd line of each 4-line record.
  * Object name = bytes from the char after '>'/'@' up to the first
    space/tab/newline, where the separator scan starts at the SECOND name
    char (the reference pre-increments: CuCLARK_hh.hh:1370), i.e. the first
    name char is always included.
  * Read length = number of sequence characters (valid or not, newlines
    excluded).
  * Counted k-mers = all length-k windows of consecutive valid (ACGTU) chars.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..kmer import CODE_LUT
from ..utils.profiling import maybe_phase

_SEP = np.zeros(256, dtype=bool)
for _c in b" \t\n":
    _SEP[_c] = True


@dataclasses.dataclass
class ReadSet:
    """Parsed reads of one input file, struct-of-arrays."""

    data: bytes  # the raw file (for name extraction)
    name_start: np.ndarray  # [R] int64, byte offset of name start
    name_end: np.ndarray  # [R] int64, byte offset of name end (exclusive)
    codes: np.ndarray  # [total_chars] int8, standard codes, -1 = invalid
    read_offsets: np.ndarray  # [R+1] int64 into codes
    is_fasta: bool

    @property
    def n_reads(self) -> int:
        return len(self.name_start)

    @property
    def read_lengths(self) -> np.ndarray:
        return self.read_offsets[1:] - self.read_offsets[:-1]

    def name(self, i: int, maxlen: int = 39) -> bytes:
        s, e = int(self.name_start[i]), int(self.name_end[i])
        if e - s > maxlen:
            e = s + maxlen
        return self.data[s:e]


def _line_index(buf: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Return (line_starts, line_ends) excluding the trailing empty line."""
    nl = np.nonzero(buf == ord("\n"))[0]
    starts = np.concatenate([[0], nl + 1])
    ends = np.concatenate([nl, [len(buf)]])
    if len(starts) > 1 and starts[-1] >= len(buf):
        starts = starts[:-1]
        ends = ends[:-1]
    return starts.astype(np.int64), ends.astype(np.int64)


def _names_from_headers(buf: np.ndarray, header_starts: np.ndarray):
    """Name token boundaries for each header line.

    header_starts points at the '>'/'@' char.  Name = [hs+1, e) where e is the
    first separator at index >= hs+2 (reference pre-increment quirk).
    """
    sep_pos = np.nonzero(_SEP[buf])[0]
    ns = header_starts + 1
    if len(sep_pos) == 0:
        return ns, np.full_like(ns, len(buf))
    idx = np.searchsorted(sep_pos, ns + 1, side="left")
    ne = np.where(idx < len(sep_pos), sep_pos[np.minimum(idx, len(sep_pos) - 1)], len(buf))
    return ns, ne


def parse_reads(data: bytes) -> ReadSet:
    """Parse a FASTA or FASTQ file into a ReadSet."""
    if len(data) == 0:
        raise ValueError("empty input file")
    buf = np.frombuffer(data, dtype=np.uint8)
    first = data[0:1]
    if first == b">":
        return _parse_fasta(data, buf)
    if first == b"@":
        return _parse_fastq(data, buf)
    raise ValueError("failed to recognize the format of the file")


def _parse_fasta(data: bytes, buf: np.ndarray) -> ReadSet:
    line_starts, line_ends = _line_index(buf)
    is_header = buf[line_starts] == ord(">")
    header_idx = np.nonzero(is_header)[0]
    if len(header_idx) == 0:
        raise ValueError("no FASTA records found")
    ns, ne = _names_from_headers(buf, line_starts[header_idx])

    # Map each sequence line to its record (count of headers at or before it).
    rec_of_line = np.cumsum(is_header) - 1
    seq_mask = (~is_header) & (rec_of_line >= 0)
    seq_lines = np.nonzero(seq_mask)[0]
    seq_lens = line_ends[seq_lines] - line_starts[seq_lines]
    rec_ids = rec_of_line[seq_lines]

    # Gather all sequence bytes (newlines dropped) in order.
    total = int(seq_lens.sum())
    # positions: for each seq line, the range [start, end)
    pos = np.repeat(line_starts[seq_lines], seq_lens) + _ranges_concat(seq_lens)
    codes = CODE_LUT[buf[pos]] if total else np.zeros(0, dtype=np.int8)

    nreads = len(header_idx)
    per_read = np.bincount(rec_ids, weights=seq_lens, minlength=nreads).astype(np.int64)
    read_offsets = np.zeros(nreads + 1, dtype=np.int64)
    np.cumsum(per_read, out=read_offsets[1:])
    return ReadSet(
        data=data,
        name_start=ns,
        name_end=ne,
        codes=codes,
        read_offsets=read_offsets,
        is_fasta=True,
    )


def _parse_fastq(data: bytes, buf: np.ndarray) -> ReadSet:
    line_starts, line_ends = _line_index(buf)
    # keep a truncated trailing record as long as its header AND sequence
    # lines exist (matches the native scan_fastq; a lone trailing header
    # line is dropped)
    n_full = (len(line_starts) + 2) // 4
    if n_full == 0:
        # lone trailing header: ZERO records, gracefully empty (the native
        # scan_fastq yields 0 reads here; the fallback must match)
        return ReadSet(
            data=data,
            name_start=np.zeros(0, np.int64),
            name_end=np.zeros(0, np.int64),
            codes=np.zeros(0, np.int8),
            read_offsets=np.zeros(1, np.int64),
            is_fasta=False,
        )
    hdr = line_starts[0::4][:n_full]
    seq_s = line_starts[1::4][:n_full]
    seq_e = line_ends[1::4][:n_full]
    ns, ne = _names_from_headers(buf, hdr)
    seq_lens = (seq_e - seq_s).astype(np.int64)
    pos = np.repeat(seq_s, seq_lens) + _ranges_concat(seq_lens)
    codes = CODE_LUT[buf[pos]] if len(pos) else np.zeros(0, dtype=np.int8)
    read_offsets = np.zeros(n_full + 1, dtype=np.int64)
    np.cumsum(seq_lens, out=read_offsets[1:])
    return ReadSet(
        data=data,
        name_start=ns,
        name_end=ne,
        codes=codes,
        read_offsets=read_offsets,
        is_fasta=False,
    )


def _ranges_concat(lens: np.ndarray) -> np.ndarray:
    """concatenate(arange(l) for l in lens), vectorized."""
    lens = np.asarray(lens, dtype=np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    seg = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
    seg_start = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return np.arange(total, dtype=np.int64) - seg_start[seg]


def window_starts(rs: ReadSet, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(starts, read_id) of every counted k-mer window.

    A window is counted iff its k codes are all valid and it does not cross a
    read boundary.
    """
    codes = rs.codes
    n = len(codes)
    if n < k:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    valid = (codes >= 0).astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(valid)])
    all_valid = (cs[k:] - cs[:-k]) == k  # [n-k+1]
    starts = np.nonzero(all_valid)[0]
    # read id of each start; window must end within the same read
    rid = np.searchsorted(rs.read_offsets, starts, side="right") - 1
    ok = starts + k <= rs.read_offsets[rid + 1]
    return starts[ok], rid[ok]


def iter_record_cuts(data, is_fq: bool, chunk_bytes: int):
    """Yield (start, end, looked) record-aligned chunk bounds of an
    in-memory FASTA/FASTQ buffer (bytes, an mmap): FASTA before a '>'
    header line, FASTQ at line-phase 0, a chunk widened past a record longer
    than it, so each chunk can be scanned independently with identical
    results.  Each cut is the native `record_cut`'s, which reads about one
    record of a FASTA chunk, from its end; `looked` is the bytes it read."""
    from ..utils import native

    n = len(data)
    pos = 0
    while pos < n:
        cut, looked = native.record_cut(data, pos, chunk_bytes, is_fq)
        yield pos, cut, looked
        pos = cut


def iter_record_slabs(path: str, slab_bytes: int = 1 << 28):
    """Yield record-aligned byte slabs of a FASTA/FASTQ file.

    Streams a memory-mapped file in ~slab_bytes pieces cut at record
    boundaries (iter_record_cuts), so classification of arbitrarily large
    inputs runs in O(slab) host memory — the bounded-memory counterpart of
    the reference's whole-file mmap scan (CuCLARK_hh.hh:522-539).  A single
    record larger than slab_bytes widens that slab only.
    """
    import mmap

    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size == 0:
            raise ValueError("empty input file")
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            first = mm[0:1]
            if first not in (b">", b"@"):
                raise ValueError("failed to recognize the format of the file")
            cuts = iter_record_cuts(mm, first == b"@", slab_bytes)
            for pos, cut, _ in cuts:
                yield bytes(mm[pos:cut])


def iter_merged_slabs(path1: str, path2: str, slab_bytes: int = 1 << 28):
    """Yield merged-FASTA slabs of two paired FASTQ files (file.cc:205-268
    semantics) in O(slab) memory via the native chunked merger."""
    import mmap

    from ..utils import native

    with open(path1, "rb") as f1, open(path2, "rb") as f2:
        for p in (path1, path2):
            if os.path.getsize(p) == 0:
                raise ValueError("empty input file")
        with mmap.mmap(f1.fileno(), 0, access=mmap.ACCESS_READ) as m1, \
                mmap.mmap(f2.fileno(), 0, access=mmap.ACCESS_READ) as m2:
            yield from _merged(native.merge_paired_stream(m1, m2,
                                                          slab_bytes))


def merge_paired(data1: bytes, data2: bytes) -> bytes:
    """Interleave two FASTQ files into one in-memory FASTA with mates joined
    by 'N' (reference file.cc:205-268).  Name = first token of the header
    split on space, '/', tab or '@'."""
    if not data1.startswith(b"@") or not data2.startswith(b"@"):
        raise ValueError("paired-end reads must be FASTQ files")
    from ..utils import native

    return b"".join(_merged(native.merge_paired_stream(data1, data2)))


def _merged(chunks):
    """The merger's chunks, each made inside the `merge` phase.  Closing
    this closes the merger, which lets go of its input's buffers (an mmap
    with views still exported cannot close)."""
    try:
        while True:
            with maybe_phase("merge"):
                chunk = next(chunks, None)
            if chunk is None:
                return
            yield chunk
    finally:
        chunks.close()


def _merge_paired_py(data1: bytes, data2: bytes) -> bytes:
    """Pure-Python reference merge (slow, whole-buffer); the native chunked
    merger is byte-parity-tested against it."""
    lines1 = data1.split(b"\n")
    lines2 = data2.split(b"\n")
    out = []
    n = min(len(lines1), len(lines2))
    i = 0
    seps = b" /\t@"

    def first_token(line: bytes) -> bytes:
        # emulate getElementsFromLine: skip leading separators, take run of
        # non-separator chars
        j = 0
        while j < len(line) and line[j] in seps:
            j += 1
        e = j
        while e < len(line) and line[e] not in seps:
            e += 1
        return line[j:e]

    while i + 1 < n:
        l1, l2 = lines1[i], lines2[i]
        if l1[:1] == b"@" and l2[:1] == b"@":
            t1 = first_token(l1)
            t2 = first_token(l2)
            if t1 != t2:
                raise ValueError("read id does not match between files")
            out.append(b">" + t1 + b"\n")
            out.append(lines1[i + 1] + b"N" + lines2[i + 1] + b"\n")
            i += 4
        else:
            i += 1
    return b"".join(out)
