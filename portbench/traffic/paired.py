"""Paired-end FASTQ traffic: a generator (see portbench/gen.py) whose
sample is two FASTQ buffers, mate 1 and mate 2 of each pair.  It reads a
mix's keys:

  reads          pairs in the sample (a CSV row each)
  read_length    each mate's length, bp
  fragment_mean  the fragments' mean length, bp; lengths are normal,
  fragment_sd    rounded, and held to [read_length, the genome's length]
  random_share   share of pairs of random sequence, both mates (they hit
                 no target); the others are fragments of a genome, the
                 genomes taken in turn, each at a seeded position: mate 1
                 the fragment's first read_length bases, mate 2 the reverse
                 complement of its last
  quality        the one quality character of every base
  assumed        what the mix assumes, for its reader (no code reads it)

Pair i's mates are named `p<i>/1` and `p<i>/2`, i zero-padded to one
width, so the merge's first-token rule names the pair `p<i>`.  A pass
merges the mates (`io.fasta.merge_paired`) and classifies the merged
objects (`classify_bytes(paired=True)`), both inside the window; the
plain reference is portbench/references/clark_paired.py.  Every seed gives
the same number of pairs, of bases and of random pairs; bases are drawn
on the device the run uses, in blocks of pairs.
"""

from __future__ import annotations

import torch

from portbench import gen
from portbench.references import clark_paired

TRAFFIC_KEYS = {"reads", "read_length", "fragment_mean", "fragment_sd",
                "random_share", "quality", "assumed"}


def check_traffic(traffic: dict):
    """Raise ValueError where a mix has a key this generator does not
    read, or lacks one."""
    if set(traffic) != TRAFFIC_KEYS:
        raise ValueError(f"traffic keys {sorted(traffic)} differ from "
                         f"{sorted(TRAFFIC_KEYS)}")
    if traffic["read_length"] < 1 or len(traffic["quality"]) != 1:
        raise ValueError("a mate has one base or more, and the quality is "
                         "one character")


def make_sample(traffic: dict, genomes: torch.Tensor, seed: int,
                device) -> tuple[tuple[bytes, bytes], tuple[bytes, bytes]]:
    """((mate 1's FASTQ, mate 2's), the same of the first
    gen.WARMUP_SHARE of the pairs)."""
    check_traffic(traffic)
    g = gen._generator(gen.seeds(seed)[1], device)
    n, length = traffic["reads"], traffic["read_length"]
    n_genomes, glen = genomes.shape
    if length > glen:
        raise ValueError("mates longer than the genomes")
    is_random = torch.arange(n, device=device) < round(
        n * traffic["random_share"])
    is_random = is_random[torch.randperm(n, generator=g, device=device)]
    frag = (traffic["fragment_mean"] + traffic["fragment_sd"] * torch.randn(
        n, generator=g, device=device, dtype=torch.float64)).round().long()
    frag = frag.clamp(length, glen)
    genome = (torch.cumsum(~is_random, 0) - 1) % n_genomes
    start = (torch.rand(n, generator=g, device=device, dtype=torch.float64)
             * (glen - frag + 1)).long()
    first = genome * glen + start
    last = first + frag - length
    flat = genomes.reshape(-1)
    width = len(str(max(n - 1, 0)))
    quality = ord(traffic["quality"])
    mates = ([], [])
    cols = torch.arange(length, device=device)
    for r0 in range(0, n, gen.BLOCK_READS):
        r1 = min(r0 + gen.BLOCK_READS, n)
        m1 = flat[first[r0:r1, None] + cols]
        m2 = 3 - flat[last[r0:r1, None] + cols].flip(1)
        rnd = is_random[r0:r1, None]
        for mate, codes in enumerate((m1, m2)):
            codes = torch.where(rnd, torch.randint(
                0, 4, codes.shape, generator=g, device=device,
                dtype=torch.uint8), codes)
            mates[mate].append(_records(torch.arange(r0, r1, device=device),
                                        codes, mate + 1, width, quality))
    fq = tuple(b"".join(m) for m in mates)
    per_pair = len(fq[0]) // max(n, 1)  # every record has one size
    warm = max(int(n * gen.WARMUP_SHARE), 1) * per_pair
    return fq, (fq[0][:warm], fq[1][:warm])


def run_pass(clf, sample: tuple[bytes, bytes]):
    """One pass of the window: the mates merged, then the Classifier's
    rows of the merged objects."""
    from jn_cuclark_tpu_torch.io.fasta import merge_paired

    return clf.classify_bytes(merge_paired(*sample), paired=True)[0]


def expected(sample: tuple[bytes, bytes], targets_file: str, cfg: dict,
             device, key_bits: int = 64, count_queried: bool = False):
    """The plain reference's rows of the pairs, and the work it counted."""
    return clark_paired.expected(sample, targets_file, cfg, device,
                                 key_bits=key_bits,
                                 count_queried=count_queried)


def _records(ridx, codes, mate: int, width: int, quality: int) -> bytes:
    """Mate `mate`'s FASTQ records of pairs ridx, bases `codes` [n, L]."""
    dev = codes.device
    nb, length = codes.shape
    h = width + 5  # '@', 'p', the digits, '/', the mate, '\n'
    out = torch.empty((nb, h + 2 * length + 4), dtype=torch.uint8,
                      device=dev)
    out[:, 0] = ord("@")
    out[:, 1] = ord("p")
    pow10 = 10 ** torch.arange(width - 1, -1, -1, device=dev)
    out[:, 2:h - 3] = (ridx[:, None] // pow10[None, :] % 10 + 48).to(
        torch.uint8)
    out[:, h - 3] = ord("/")
    out[:, h - 2] = ord("0") + mate
    out[:, h - 1] = 10
    acgt = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)
    out[:, h:h + length] = acgt[codes.long()]
    out[:, h + length] = 10
    out[:, h + length + 1] = ord("+")
    out[:, h + length + 2] = 10
    out[:, h + length + 3:-1] = quality
    out[:, -1] = 10
    return out.cpu().numpy().tobytes()
