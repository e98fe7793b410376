"""The cells at sizes a CPU test run holds: each configuration with 4
genomes of 200,000 bp and a table of 1,048,573 buckets, 3,000 reads."""

from portbench import spec

CELLS = ["full16x3M-se-mixed", "light16x3M-se-hits"]


def cell(name: str, reads: int = 3000, targets: int = 4,
         genome_length: int = 200_000) -> spec.Cell:
    c = spec.cell(spec.load(), name)
    c.config.update(htsize=1048573, targets=targets,
                    genome_length=genome_length)
    c.traffic.update(reads=reads)
    return c
