"""The port's host front end against the JAX package: the record cut of
each scan chunk (native `record_cut`, searched from the chunk's end), the
native scan with arrays that grow past their first capacity, the streamed
scan, and the `scan_cut` phase's count of the bytes its search read."""

import os

import numpy as np
import pytest

from jn_cuclark_tpu.io import fasta as jfasta
from jn_cuclark_tpu.utils import native as jnative
from jn_cuclark_tpu_torch.engine import BatchPlan, Classifier, _ScanStream
from jn_cuclark_tpu_torch.io import fasta
from jn_cuclark_tpu_torch.utils import native, profiling

from .test_torch_engine import GOLD, GOLDENS, golden_setup

CHUNKS = [64, 100, 1000, 4096, 65536, 1 << 20]
FORMATS = ["fa", "fq"]


def _seq(rng, n: int) -> bytes:
    return rng.choice(np.frombuffer(b"ACGTN", np.uint8), n).tobytes()


def make_records(fmt: str, n: int, seed: int = 0,
                 longest: int = 5000) -> bytes:
    """n random records of 1 to `longest` bp: FASTA with multi-line
    sequences and '>' inside its headers, FASTQ with '@', '>' and '+' in
    its quality lines."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        seq = _seq(rng, int(rng.integers(1, longest + 1)))
        if fmt == "fa":
            out.append(b">r%d x>y\n" % i)
            width = int(rng.integers(1, 120))
            out += [seq[j:j + width] + b"\n" for j in range(0, len(seq), width)]
        else:
            qual = rng.choice(np.frombuffer(b"@>+!I#", np.uint8),
                              len(seq)).tobytes()
            out.append(b"@r%d\n%s\n+\n%s\n" % (i, seq, qual))
    return b"".join(out)


def buffers(fmt: str) -> dict:
    """Each buffer a case runs: many records, the same without its last
    newline, one record, and one record without its last newline."""
    many, one = make_records(fmt, 60), make_records(fmt, 1, seed=1)
    return {"many": many, "many_no_nl": many[:-1], "one": one,
            "one_no_nl": one[:-1]}


def same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_record_cuts_equal_jax(fmt, chunk):
    """The native cut yields the JAX package's cuts: the widening past a
    record longer than the chunk (64 B) and the last chunk ending at the
    buffer's end included."""
    for name, data in buffers(fmt).items():
        buf = np.frombuffer(data, np.uint8)
        want = list(jfasta.iter_record_cuts(buf, fmt == "fq", chunk))
        got = list(fasta.iter_record_cuts(data, fmt == "fq", chunk))
        assert [(s, e) for s, e, _ in got] == want
        assert want[-1][1] == len(data), name


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_scan_stream_equals_whole_scan(fmt, chunk):
    """The streamed scan's arrays are one whole-buffer scan's, and both are
    the JAX package's native scan's."""
    for data in buffers(fmt).values():
        whole = native.scan_reads(data)
        same_arrays(whole[1:], jnative.scan_reads(data)[1:])
        scan = _ScanStream(data, chunk_bytes=chunk)
        n = scan.total()
        assert n == len(whole[5]) == native.quick_count(data)
        same_arrays(scan.arrays(0, n), whole[1:])


class _Counting:
    """The native library with its scan calls and their results kept."""

    def __init__(self, lib):
        self.lib, self.results = lib, []

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def scan_fasta(self, *args):
        self.results.append(self.lib.scan_fasta(*args))
        return self.results[-1]

    def scan_fastq(self, *args):
        self.results.append(self.lib.scan_fastq(*args))
        return self.results[-1]


@pytest.mark.parametrize("longest", [1, 20, 50])
@pytest.mark.parametrize("fmt", FORMATS)
def test_scan_reads_grows_past_its_first_capacity(fmt, longest, monkeypatch):
    """Reads far shorter than the first capacity's 128 bytes a read
    overflow it: the scan answers -2, runs again into arrays twice the
    size, and gives the JAX package's arrays (it counts the records
    first), whole and for a chunk in the middle of the buffer."""
    data = make_records(fmt, 3000, seed=2, longest=longest)
    counting = _Counting(native._load())
    monkeypatch.setattr(native, "_load", lambda: counting)
    same_arrays(native.scan_reads(data)[1:], jnative.scan_reads(data)[1:])
    assert counting.results[0] == -2 and counting.results[-1] == 3000
    cuts = list(fasta.iter_record_cuts(data, fmt == "fq", 20000))
    s, e, _ = cuts[len(cuts) // 2]
    is_fa = fmt == "fa"
    counting.results.clear()
    same_arrays(native.scan_reads(data, s, e, is_fasta=is_fa)[1:],
                jnative.scan_reads(data, s, e, is_fasta=is_fa)[1:])
    assert counting.results[0] == -2


@pytest.mark.parametrize("slab", [64, 1000, 1 << 20])
@pytest.mark.parametrize("fmt", FORMATS)
def test_record_slabs_equal_jax(fmt, slab, tmp_path):
    """classify_file's slabs of a memory-mapped file are the JAX package's,
    and a reader that stops early leaves the file closable."""
    path = str(tmp_path / f"reads.{fmt}")
    with open(path, "wb") as f:
        f.write(make_records(fmt, 30, seed=4))
    assert (list(fasta.iter_record_slabs(path, slab))
            == list(jfasta.iter_record_slabs(path, slab)))
    slabs = fasta.iter_record_slabs(path, slab)
    next(slabs)
    slabs.close()  # the mmap closes with no view of it left open


def test_record_cut_refuses_an_empty_chunk():
    with pytest.raises(ValueError):
        native.record_cut(b">a\nAC\n>b\nGT\n", 0, 0, False)


def _longest_record(data: bytes) -> int:
    starts = [0] + [i + 1 for i in range(len(data) - 1)
                    if data[i:i + 2] == b"\n>"] + [len(data)]
    return max(b - a for a, b in zip(starts, starts[1:]))


@pytest.mark.parametrize("chunk", [512, 1024, 4096])
def test_scan_cut_reads_about_a_record_a_chunk(chunk, tmp_path):
    """Under a collector, a classify call over a FASTA of N chunks records
    `scan_cut` N times, and its search reads at most a record and two
    bytes of each chunk, far less than the buffer."""
    db, targets = golden_setup("fa", tmp_path)
    _, _, _, prof, k, reads, golden = GOLDENS["fa"]
    data = open(os.path.join(GOLD, reads), "rb").read()
    cuts = list(fasta.iter_record_cuts(data, False, chunk))
    n_chunks = len(cuts)
    assert n_chunks > 3
    clf = Classifier.load(db, targets, prof, k, device="cpu",
                          plan=BatchPlan(max_reads=16,
                                         scan_chunk_bytes=chunk))
    with profiling.collect() as ph:
        rows, _ = clf.classify_bytes(data)
        body = b"".join(rows)
    with open(os.path.join(GOLD, golden), "rb") as f:
        assert body == f.read().split(b"\n", 1)[1]
    assert ph.counts["scan_cut"] == ph.counts["scan"] == n_chunks
    looked = ph.nbytes["scan_cut"]
    assert looked == sum(lk for _, _, lk in cuts)
    assert 0 < looked <= n_chunks * (_longest_record(data) + 2)
    assert looked < len(data) // 2
