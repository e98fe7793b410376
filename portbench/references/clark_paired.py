"""Plain reference of CLARK's paired-end classification, as CuCLARK
defines it, on top of clark.py's single-end rules (imported, not changed).
It shares no code with the program.

  Pairs    two FASTQ files of four-line records; record i of one is the
           mate of record i of the other.  A pair is named by its
           header's first token: the bytes after any leading separators
           (space, '/', tab, '@') up to the next one.  Both mates must
           give the same name.
  Object   mate 1's sequence, NBN = 1 'N', mate 2's sequence
           (parameters.hh:41, file.cc:205-268): the N is an invalid base,
           so no k-mer spans the join.
  Its row  clark.py's, with Gamma's length the object's less NBN.
"""

from __future__ import annotations

import re
import types

from portbench.references import clark

NBN = 1
_TOKEN = re.compile(rb"[ /\t@]*([^ /\t@]*)")  # separators, then the name


def first_token(header: bytes) -> bytes:
    """A FASTQ header's name: its first run of non-separator bytes."""
    return _TOKEN.match(header).group(1)


def merge(fq1: bytes, fq2: bytes) -> bytes:
    """The pairs of two FASTQ buffers as one FASTA buffer, an object a
    pair (see the module's docstring)."""
    l1, l2 = fq1.split(b"\n"), fq2.split(b"\n")
    n = min(len(l1), len(l2)) // 4
    out = []
    for h1, s1, h2, s2 in zip(l1[0:4 * n:4], l1[1:4 * n:4],
                              l2[0:4 * n:4], l2[1:4 * n:4]):
        if h1[:1] != b"@" or h2[:1] != b"@":
            raise ValueError("not a four-line FASTQ record")
        name = first_token(h1)
        if first_token(h2) != name:
            raise ValueError(f"mates named {name!r} and "
                             f"{first_token(h2)!r}")
        out.append(b">%s\n%s%s%s\n" % (name, s1, b"N" * NBN, s2))
    return b"".join(out)


def expected(sample: tuple, targets_file: str, cfg: dict, device,
             key_bits: int = 64, count_queried: bool = False):
    """(every pair's row, joined; the work counted, as clark.expected
    counts it over the merged objects) of a sample of two FASTQ
    buffers."""
    with open(targets_file) as f:
        files, labels = zip(*(ln.split()[:2] for ln in f if ln.strip()))
    recs = clark.Records(merge(*sample), device)
    keys, labs = clark.database(list(files), cfg["k"], cfg["light"],
                                cfg["gap"], device)
    sc = clark.scores(recs, keys, labs, cfg["k"], len(files), device,
                      key_bits=key_bits, count_queried=count_queried)
    objects = types.SimpleNamespace(names=recs.names,
                                    lengths=recs.lengths - NBN)
    want = b"".join(clark.rows(objects, sc, cfg["k"], ["NA", *labels]))
    return want, dict(bases=int(recs.offsets[-1]), reads=len(recs.names),
                      keys=len(keys), queried=sc.get("queried", 0))
