"""NCBI taxonomy utilities: accession->taxid joins, lineage walks, targets
definition.

Replaces the reference helper binaries:
  * getAccssnTaxID.cc   — accession extraction from FASTA headers, join with
                          the accession2taxid table + merged.dmp remaps
  * getfilesToTaxNodes.cc — 6-rank (species..phylum) lineage per taxid
  * getAbundance.cc getNodes/getLineage — 8-rank lineage incl. superkingdom
  * getTargetsDef.cc    — project lineage to the requested rank

Rank numbering matches the reference: 0=species 1=genus 2=family 3=order
4=class 5=phylum (+6=superkingdom 7=root for abundance).
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np

RANKS6 = ["species", "genus", "family", "order", "class", "phylum"]
RANKS8 = RANKS6 + ["superkingdom", "root"]
RANK_INDEX = {name: i for i, name in enumerate(RANKS8)}


@dataclasses.dataclass
class TaxTree:
    """parent/rank arrays indexed by taxid (getfilesToTaxNodes.cc:40-66)."""

    parent: np.ndarray  # uint32, 0 = unknown taxid
    rank: np.ndarray  # uint8, 255 = unranked / not one of RANKS8

    def lineage6(self, taxid: int) -> list[int]:
        """getSGFOCP: ranks species..phylum, 0 = UNKNOWN.  Walks parents until
        the root; ranks assigned on first encounter."""
        out = [0] * 6
        it = taxid
        if it <= 0 or it >= len(self.parent):
            return out
        while True:
            if it == 1 or self.parent[it] == 1:
                break
            r = self.rank[it]
            if r < 6 and out[r] == 0:
                out[r] = it
            nxt = int(self.parent[it])
            if nxt == 0 or nxt == it:
                break
            it = nxt
        return out

    def lineage8(self, taxid: int) -> list[int] | None:
        """getAbundance.cc getLineage: ranks species..superkingdom + root
        marker; species backfilled with the last node below root when absent.
        Returns None for unknown taxids."""
        it = int(taxid)
        if it <= 0 or it >= len(self.parent) or self.parent[it] == 0:
            return None
        out = [0] * 8
        while True:
            if self.parent[it] == 1:
                out[7] = 1
                if out[6] == 0:
                    out[6] = it
                break
            r = self.rank[it]
            if r < 8 and out[r] == 0:
                out[r] = it
            nxt = int(self.parent[it])
            if nxt == 0 or nxt == it:
                break
            it = nxt
        return out


def load_nodes(path: str, max_taxid: int | None = None) -> TaxTree:
    """Parse nodes.dmp.  A rank name counts only if its first token is one of
    RANKS8 and the next token does not contain "group" (getAbundance.cc:134,
    getfilesToTaxNodes.cc:115 — 'species group' etc. are excluded)."""
    ids = []
    parents = []
    ranks = []
    with open(path, "rb") as f:
        for line in f:
            parts = line.split(b"\t|\t")
            if len(parts) < 3:
                continue
            ids.append(int(parts[0]))
            parents.append(int(parts[1]))
            rtoks = parts[2].split()
            r = 255
            if rtoks:
                name = rtoks[0].decode()
                if name in RANK_INDEX and not (
                    len(rtoks) > 1 and b"group" in rtoks[1]
                ):
                    r = RANK_INDEX[name]
            ranks.append(r)
    ids_a = np.array(ids, dtype=np.int64)
    n = int(ids_a.max()) + 1 if len(ids_a) else 1
    if max_taxid is not None:
        n = max(n, max_taxid + 1)
    parent = np.zeros(n, dtype=np.uint32)
    rank = np.full(n, 255, dtype=np.uint8)
    parent[ids_a] = np.array(parents, dtype=np.uint32)
    rank[ids_a] = np.array(ranks, dtype=np.uint8)
    return TaxTree(parent=parent, rank=rank)


def load_merged(path: str) -> dict[int, int]:
    """merged.dmp: old taxid -> new taxid."""
    out: dict[int, int] = {}
    with open(path, "rb") as f:
        for line in f:
            parts = [p for p in re.split(rb"[\s|]+", line) if p]
            if len(parts) >= 2:
                old = int(parts[0])
                if old not in out:
                    out[old] = int(parts[1])
    return out


def load_names(path: str, wanted: set[int]) -> dict[int, str]:
    """names.dmp scientific names for the given taxids."""
    out: dict[int, str] = {}
    with open(path, "rb") as f:
        for line in f:
            if b"scientific name" not in line:
                continue
            parts = line.split(b"\t|\t")
            if len(parts) < 2:
                continue
            tid = int(parts[0])
            if tid in wanted and tid not in out:
                out[tid] = parts[1].decode().strip()
    return out


def accession_of_header(line: bytes) -> str | None:
    """First header token split on ' \\t:' then on '|.>'; the accession is the
    second-to-last piece (getAccssnTaxID.cc:100-110): handles both
    '>NC_004061.1 desc' and '>gi|123|ref|NC_004061.1|'."""
    if not line.startswith(b">"):
        return None
    tok = re.split(rb"[ \t:]", line)[0]
    pieces = [p for p in re.split(rb"[|.>]", tok) if p != b""]
    # reference keeps empty strings out via its tokenizer; index len-2 if >1
    if not pieces:
        return None
    acc = pieces[-2] if len(pieces) > 1 else pieces[0]
    return acc.decode()


def map_files_to_taxids(
    files: list[str], accession2taxid: str, merged: dict[int, int]
) -> list[tuple[str, str, int]]:
    """getAccssnTaxID: per sequence file -> (file, accession, taxid|-1)."""
    acc_of_file: list[tuple[str, str]] = []
    want: dict[str, int] = {}
    for path in files:
        try:
            with open(path, "rb") as f:
                first = f.readline().rstrip(b"\n")
        except OSError:
            continue
        acc = accession_of_header(first)
        if acc is None:
            continue
        acc_of_file.append((path, acc))
        want.setdefault(acc, -1)
    with open(accession2taxid, "rb") as f:
        remaining = sum(1 for v in want.values() if v == -1)
        for line in f:
            if remaining == 0:
                break
            parts = line.split()
            if len(parts) < 3:
                continue
            acc = parts[0].decode()
            if acc in want and want[acc] == -1:
                tid = int(parts[2])
                want[acc] = merged.get(tid, tid)
                remaining -= 1
    return [(path, acc, want[acc]) for path, acc in acc_of_file]


def targets_definition(
    file_taxids: list[tuple[str, str, int]],
    tree: TaxTree,
    rank: int = 0,
) -> tuple[list[tuple[str, int]], list[str]]:
    """getfilesToTaxNodes + getTargetsDef: (file, taxid-at-rank) pairs plus
    the excluded-files list (unmapped accession or UNKNOWN at rank)."""
    out: list[tuple[str, int]] = []
    excluded: list[str] = []
    for path, acc, tid in file_taxids:
        if tid == -1:
            excluded.append(path)
            continue
        lin = tree.lineage6(tid)
        at_rank = lin[rank]
        if at_rank == 0:
            continue  # UNKNOWN at requested rank — silently dropped (getTargetsDef.cc:77-81)
        out.append((path, at_rank))
    return out, excluded


def write_targets_file(path: str, pairs: list[tuple[str, int]]):
    with open(path, "w") as f:
        for p, tid in pairs:
            f.write(f"{p}\t{tid}\n")
