"""Device times of the flat path's kernels, K9 (the search) and K5's flat
form, in this tree and another tree of the repo, on one CUDA card, by one
method and on one batch.

    python3 chip_flat_ab.py OTHER [--rounds N] [--reps N]

OTHER is a checkout of another commit of this repo.  The script builds
bench.py's config-2 DB (16 genomes x 3,000,000 bp, k = 31) and 400,000
reads with this tree's chip_smoke, loads the flat index (packed=False) and
cuts phase 5's flat batch (the windows of the first 20,000 reads).  It
imports OTHER's port under another name beside this tree's, builds both
trees' kernels, holds each tree's K9 and K5's flat form against the plain
twins on the batch, then times them by this tree's method: device time in
a profiler session that `profiling.check_session` finds whole
(chip_smoke._device_split, retaken where a session lost kernels), with
CUDA events beside.  Each round times OTHER, this tree, this tree, OTHER.
Prints the card's name and power limit, then one JSON line: each tree's
times by round, the retakes, K9's and K5-flat's bounds (phase 5's) and
each time's share of its bound; the same line goes to
chiprun_out/flat_ab.json.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import threading

ROOT = os.path.dirname(os.path.abspath(__file__))


def import_tree(tree: str, name: str):
    """(kernels, lookup) of the port in `tree`, imported as package `name`
    (its modules import one another relatively)."""
    pkg = os.path.join(tree, "jn_cuclark_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(name + ".ops.kernels"),
            importlib.import_module(name + ".ops.lookup"))


def k9_call(kernels, lookup, keys, labels1, q):
    """A tree's K9 on the batch: through its FlatIndex where its lookup
    module builds one, else its whole-array form (keys, labels1, q)."""
    if hasattr(lookup, "build_index"):
        index = lookup.build_index(keys, labels1)
        return lambda: kernels.lookup(index, q)
    return lambda: kernels.lookup(keys, labels1, q)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_flat_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from jn_cuclark_tpu_torch import params
    from jn_cuclark_tpu_torch.db import builder
    from jn_cuclark_tpu_torch.io.targets import parse_targets
    from jn_cuclark_tpu_torch.ops import kernels, lookup, score

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    trees = {"other": import_tree(os.path.abspath(args.other),
                                  "_other_port"),
             "this": (kernels, lookup)}
    # the trees' nvcc builds at once
    builds = [threading.Thread(target=f) for f in (trees["other"][0].load,
                                                     kernels.load_all)]
    for b in builds:
        b.start()
    prof = params.FULL
    with tempfile.TemporaryDirectory(prefix="chip_flat_ab_") as td:
        rng = np.random.default_rng(2)  # chip_smoke.run_scale's seed
        genomes = chip_smoke.make_genomes(td, rng, 16, 3_000_000)
        builder.build_database(parse_targets(os.path.join(td, "targets.txt")),
                               td, prof, prof.default_k)
        fa = chip_smoke.make_reads(np.random.default_rng(3), genomes,
                                   400_000)[0]
        flat, load_s = chip_smoke._load(dev, td, prof, packed=False)
    for b in builds:
        b.join()
    fk, fl = flat.index.keys, flat.index.labels1
    fq, fqr, fnb = chip_smoke.flat_batch(flat, fa)
    T = flat.n_targets
    want_lab = lookup.lookup_labels_plain(fk, fl, fq)
    counts = score.counts_from_hits_plain(want_lab, fqr, fnb, T)
    want_flat = (counts,) + score.read_results_plain(counts)
    fns = {}
    for tree, (k, lk) in trees.items():
        fns[tree] = {
            "lookup": k9_call(k, lk, fk, fl, fq),
            "counts_flat": lambda k=k: k.counts_flat(want_lab, fqr, fnb, T)}
        chip_smoke._same(f"{tree} lookup", [fns[tree]["lookup"]()],
                         [want_lab])
        chip_smoke._same(f"{tree} counts_flat", fns[tree]["counts_flat"](),
                         want_flat)
    search = chip_smoke._search_reads(fk, fq)
    nb = chip_smoke._nbytes
    bound = {
        "lookup": chip_smoke._bound(nb(fq, want_lab) + search["floor_bytes"],
                                    search["queries"])[0],
        "counts_flat": chip_smoke._bound(nb(want_lab, fqr, *want_flat),
                                         want_lab.numel() + fnb * T)[0]}
    runs = []
    for r in range(args.rounds):
        for tree in ("other", "this", "this", "other"):
            for name, fn in fns[tree].items():
                split, retakes = chip_smoke._device_split(fn, dev, args.reps)
                ms = sum(split.values())
                runs.append(dict(round=r, tree=tree, kernel=name, ms=ms,
                                 split=split, retakes=retakes,
                                 event_ms=chip_smoke._ms(fn, dev, args.reps),
                                 share=bound[name] / ms))
    rec = dict(card=card, other=os.path.abspath(args.other),
               batch=dict(reads=fnb, queries=int(fq.numel()),
                          index_keys=int(fk.shape[0]), targets=T),
               load_flat_s=load_s, bound_ms=bound,
               whole_array_search=search, runs=runs, median_ms={})
    for tree in fns:
        for name in fns[tree]:
            ms = sorted(x["ms"] for x in runs
                        if (x["tree"], x["kernel"]) == (tree, name))
            rec["median_ms"][f"{tree} {name}"] = ms[len(ms) // 2]
    line = json.dumps(rec)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "flat_ab.json"), "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
