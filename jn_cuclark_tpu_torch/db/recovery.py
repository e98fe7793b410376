"""Central-DB recovery from per-target .ht files.

Reference behavior (CuCLARK_hh.hh:598-685 loadSpecificTargetSets +
HashTableStorage_hh.hh:513-552 Load): when the central .sz/.ky/.lb files are
missing but per-target `<label>_k{k}.ht` text files exist, rebuild the
central DB from them (k-mers with count > minT, label taken from the file's
target), write it, and signal the caller to restart cleanly (the reference
exits -1; we just return the rebuilt arrays so the load can continue).
"""

from __future__ import annotations

import os

import numpy as np

from ..io import dbformat
from ..io.targets import TargetsDef
from ..params import Profile


def ht_file_name(folder: str, label: str, k: int, light: bool = False) -> str:
    if light:
        return os.path.join(folder, f"{label}_k{k}_light.ht")
    return os.path.join(folder, f"{label}_k{k}.ht")


def load_ht_file(path: str, min_count: int = 0) -> np.ndarray:
    """Canonical k-mer values from one .ht text file (lines:
    `<kmerIndex>\\t<count>\\t<kmer-string>`; '#' header lines skipped by the
    reference's first-element parse)."""
    vals = []
    with open(path, "rb") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2 or parts[0].startswith(b"#"):
                continue
            try:
                v = int(parts[0])
                c = int(parts[1])
            except ValueError:
                continue
            if c > min_count:
                vals.append(v)
    return np.array(vals, dtype=np.uint64)


def recover_central_db(
    folder: str,
    targets: TargetsDef,
    profile: Profile,
    k: int,
    min_count_target: int = 0,
    gap: int | None = None,
) -> bool:
    """Rebuild the central DB from .ht files if they exist.  Returns True if
    a DB was written."""
    lidx = targets.label_index
    canon_all = []
    label_all = []
    found = 0
    for label in targets.labels + targets.labels_c:
        path = ht_file_name(folder, label, k, profile.light)
        if not os.path.exists(path):
            continue
        found += 1
        vals = load_ht_file(path, min_count_target)
        canon_all.append(vals)
        label_all.append(np.full(len(vals), lidx[label], dtype=np.uint16))
    if not found:
        return False
    canon = np.concatenate(canon_all) if canon_all else np.zeros(0, np.uint64)
    labels = np.concatenate(label_all) if label_all else np.zeros(0, np.uint16)
    # the reference inserts blindly (duplicates across files would duplicate
    # bucket entries); .ht files are per-target-specific so values are unique
    stem = os.path.join(
        folder,
        profile.db_stem(
            k, targets.n_targets, min_count_target,
            profile.default_gap if gap is None else gap,
        ),
    )
    dbformat.write_db(stem, profile, k, canon, labels)
    return True
