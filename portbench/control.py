"""The control of the comparison that decides `correct`, at a cell's size.

    python3 -m portbench.control --workload <name> --seeds 11 12 13

For each seed it makes the cell's genomes and sample as a run does, works
out every read's row with the control (the generator's plain reference with
its table telling k-mers apart by their low 32 bits alone, the nearest
precision below the exact 64-bit key, as a compact hash table would), and
hands those rows to the run's own comparison (`run.judge`) in place of a
timed pass: a line of JSON a seed with the numbers compared.  A sound
control fails `rows_wrong`'s limit of 0 on every seed.  It runs no part of
the program.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

from portbench import gen, run, spec


KEY_BITS = 32  # the control's key width: the step below exact 64-bit keys


def readings(cell: spec.Cell, seed: int, device) -> dict:
    """The run's numbers compared for the control's rows, with the reads,
    the database's keys and the seconds the control and the comparison
    took."""
    work = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        genomes = gen.make_genomes(cell.config, seed, device)
        targets_file = gen.write_genomes(genomes, cell.config, work)
        sample, _ = cell.generator.make_sample(cell.traffic, genomes, seed,
                                               device)
        del genomes
        t = time.perf_counter()
        rows, _ = cell.generator.expected(sample, targets_file, cell.config,
                                          device, key_bits=KEY_BITS)
        checks, done = run.judge(cell, sample, targets_file, rows, 1, 0,
                                 device)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return dict(seed=seed, key_bits=KEY_BITS, reads=done["reads"],
                keys=done["keys"], **checks,
                limits=run.LIMITS, seconds=time.perf_counter() - t)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(spec.load(), args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, torch.device("cuda"))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
