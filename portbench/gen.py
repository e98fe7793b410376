"""The seeded inputs of a cell, and the default generator of its traffic.

The configuration's file gives the genomes (how many, how long, their
taxids, the FASTA line width); the traffic mix's file
(portbench/traffic/<mix>.json) gives the sample.  A generator is a module
with three functions, and this one is the default:

  make_sample(traffic, genomes, seed, device) -> (sample, warm-up sample)
  run_pass(clf, sample) -> the CSV row chunks of one pass over the sample
  expected(sample, targets_file, cfg, device, key_bits=64,
           count_queried=False) -> (the plain reference's rows, the work
           the roofline counts: bases, reads, keys, queried)

A mix whose file names `"generator": "<module>"` uses
portbench/traffic/<module>.py instead, so a mix of another shape (pairs,
FASTQ, extended output, several files) is added as files alone.  This one
reads a mix's keys:

  reads         reads in the sample
  length_min    shortest read, bp
  length_max    longest read, bp (lengths are spread evenly over the range)
  random_share  share of reads of random sequence (they hit no target);
                the others are substrings of a genome, the genomes taken in
                turn, each at a seeded position

The sample is FASTA, a line of sequence a record.  Set-up classifies its
first WARMUP_SHARE once before the window; the window runs
Classifier.classify_bytes over it.

Every seed gives the same multiset of read lengths and the same number of
random reads, in another order, so seeds change no amount of work.  Bases
are drawn with torch generators on the device the run uses, in blocks of
reads, and only bytes reach the host.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from portbench.references import clark

TRAFFIC_KEYS = {"reads", "length_min", "length_max", "random_share"}
WARMUP_SHARE = 0.25  # of the sample, warmed up once in set-up
BLOCK_READS = 1 << 18  # reads built on the device at a time
_ACGT = list(b"ACGT")


def check_traffic(traffic: dict):
    """Raise ValueError where a traffic mix has a key this generator does
    not read, or lacks one."""
    if set(traffic) != TRAFFIC_KEYS:
        raise ValueError(f"traffic keys {sorted(traffic)} differ from "
                         f"{sorted(TRAFFIC_KEYS)}")
    if not 0 < traffic["length_min"] <= traffic["length_max"]:
        raise ValueError("read lengths must satisfy 0 < min <= max")


def seeds(seed: int) -> tuple[int, int]:
    """Two independent 64-bit seeds (genomes, reads) from any whole
    number."""
    g, r = np.random.SeedSequence(abs(int(seed))).generate_state(2, np.uint64)
    return int(g), int(r)


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def make_genomes(cfg: dict, seed: int, device) -> torch.Tensor:
    """[targets, genome_length] uint8 base codes (0-3 for A, C, G, T)."""
    g = _generator(seeds(seed)[0], device)
    return torch.randint(0, 4, (cfg["targets"], cfg["genome_length"]),
                         generator=g, device=device, dtype=torch.uint8)


def write_genomes(genomes: torch.Tensor, cfg: dict, folder: str) -> str:
    """One FASTA file a genome (`>g<i>`, lines of cfg's line width) and a
    targets file naming each with its taxid; returns the targets file."""
    acgt = torch.tensor(_ACGT, dtype=torch.uint8, device=genomes.device)
    width = cfg["fasta_line_width"]
    lines = []
    for i in range(genomes.shape[0]):
        chars = acgt[genomes[i].long()]
        n_full = len(chars) // width
        body = torch.cat([chars[:n_full * width].view(n_full, width),
                          torch.full((n_full, 1), 10, dtype=torch.uint8,
                                     device=chars.device)], dim=1)
        tail = chars[n_full * width:]
        path = os.path.join(folder, f"g{i}.fa")
        with open(path, "wb") as f:
            f.write(b">g%d\n" % i)
            f.write(body.cpu().numpy().tobytes())
            if len(tail):
                f.write(tail.cpu().numpy().tobytes() + b"\n")
        lines.append(f"{path} {cfg['first_taxid'] + i}\n")
    targets = os.path.join(folder, "targets.txt")
    with open(targets, "w") as f:
        f.writelines(lines)
    return targets


def make_sample(traffic: dict, genomes: torch.Tensor, seed: int,
                device) -> tuple[bytes, bytes]:
    """(the sample as one FASTA buffer, its first WARMUP_SHARE of the
    reads, cut at a record boundary).  Read i is named `r<i>`, zero-padded
    to one width."""
    check_traffic(traffic)
    g = _generator(seeds(seed)[1], device)
    n = traffic["reads"]
    lo, hi = traffic["length_min"], traffic["length_max"]
    lengths = lo + torch.arange(n, device=device) % (hi - lo + 1)
    lengths = lengths[torch.randperm(n, generator=g, device=device)]
    is_random = torch.arange(n, device=device) < round(
        n * traffic["random_share"])
    is_random = is_random[torch.randperm(n, generator=g, device=device)]
    n_genomes, glen = genomes.shape
    if hi > glen:
        raise ValueError("reads longer than the genomes")
    # the genomic reads take the genomes in turn, each at a seeded position
    genome = (torch.cumsum(~is_random, 0) - 1) % n_genomes
    start = (torch.rand(n, generator=g, device=device, dtype=torch.float64)
             * (glen - lengths + 1)).long()
    flat = genomes.reshape(-1)
    width = len(str(max(n - 1, 0)))
    warm_read = int(n * WARMUP_SHARE)
    parts, size, warm_cut = [], 0, None
    for r0 in range(0, n, BLOCK_READS):
        r1 = min(r0 + BLOCK_READS, n)
        block, offs = _records(
            torch.arange(r0, r1, device=device), lengths[r0:r1],
            is_random[r0:r1], genome[r0:r1] * glen + start[r0:r1], flat,
            width, g)
        if r0 <= warm_read < r1:
            warm_cut = size + int(offs[warm_read - r0])
        parts.append(block)
        size += len(block)
    sample = b"".join(parts)
    return sample, sample[:size if warm_cut is None else warm_cut]


def run_pass(clf, sample: bytes):
    """One pass of the window: the Classifier's rows of the sample."""
    return clf.classify_bytes(sample)[0]


def expected(sample: bytes, targets_file: str, cfg: dict, device,
             key_bits: int = 64, count_queried: bool = False):
    """The plain reference's rows of a FASTA sample, and the work it
    counted."""
    return clark.expected(sample, targets_file, cfg, device,
                          key_bits=key_bits, count_queried=count_queried)


def _records(ridx, lengths, is_random, gstart, flat, width, g):
    """The records of reads ridx as bytes, and each record's offset."""
    dev = ridx.device
    nb = len(ridx)
    h = width + 3  # '>', 'r', the digits, '\n'
    rec_len = h + lengths + 1
    rec_off = torch.cumsum(rec_len, 0) - rec_len
    out = torch.empty(int(rec_len.sum()), dtype=torch.uint8, device=dev)
    # headers
    pow10 = 10 ** torch.arange(width - 1, -1, -1, device=dev)
    head = torch.empty((nb, h), dtype=torch.uint8, device=dev)
    head[:, 0] = ord(">")
    head[:, 1] = ord("r")
    head[:, 2:h - 1] = (ridx[:, None] // pow10[None, :] % 10 + 48).to(
        torch.uint8)
    head[:, h - 1] = 10
    out[(rec_off[:, None] + torch.arange(h, device=dev)).reshape(-1)] = (
        head.reshape(-1))
    # sequences: random codes, then the genomic reads' bases over them
    read_of = torch.repeat_interleave(torch.arange(nb, device=dev), lengths)
    within = torch.arange(len(read_of), device=dev) - (
        torch.cumsum(lengths, 0) - lengths)[read_of]
    codes = torch.randint(0, 4, (len(read_of),), generator=g, device=dev,
                          dtype=torch.uint8)
    genomic = ~is_random[read_of]
    codes[genomic] = flat[gstart[read_of][genomic] + within[genomic]]
    acgt = torch.tensor(_ACGT, dtype=torch.uint8, device=dev)
    out[rec_off[read_of] + h + within] = acgt[codes.long()]
    out[rec_off + h + lengths] = 10
    return out.cpu().numpy().tobytes(), rec_off.cpu().numpy()
