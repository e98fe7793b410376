"""Reads/s of the port's resident classify path at bench.py's config 2 on
one CUDA card, for comparing two trees of the repo in one call.

    python3 chip_rate.py [TREE] [--rounds N]

TREE is a checkout of this repo (default: the directory of this script);
its own `chip_smoke.run_scale` builds the config-2 DB (16 genomes x
3,000,000 bp, k = 31) and 400,000 reads and 100,000 pairs, and times one
warmed run of each; then N more rounds (default 3) time plain, --extended
and paired runs of its Classifier.  Prints the card's name and power limit,
then one JSON line with every wall and the median rates.  To compare two
trees, run parent, change, change, parent on one card, one after another.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?",
                    default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("chip_rate: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="chip_rate_") as td:
        m, _, clf, _, _ = chip_smoke.run_scale(dev, td, 16, 3_000_000,
                                               400_000)
        reads = os.path.join(td, "reads.fa")
        mates = os.path.join(td, "r1.fq"), os.path.join(td, "r2.fq")
        out = os.path.join(td, "rate")
        runs = {
            "plain": (400_000, lambda: clf.classify_file(reads, out)),
            "extended": (400_000, lambda: clf.classify_file(
                reads, out, extended=True)),
            "paired": (100_000, lambda: clf.classify_file(
                mates[0], out, paired_path=mates[1])),
        }
        walls = {name: [] for name in runs}
        for _ in range(args.rounds):
            for name, (_, fn) in runs.items():
                t = time.perf_counter()
                fn()
                walls[name].append(time.perf_counter() - t)
    median = {name: n / sorted(walls[name])[len(walls[name]) // 2]
              for name, (n, _) in runs.items()}
    print(json.dumps({"tree": tree, "run_scale": {
        key: m[key] for key in ("reads_per_s", "extended_reads_per_s",
                                "pairs_per_s")},
        "walls_s": walls, "median_per_s": median}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
