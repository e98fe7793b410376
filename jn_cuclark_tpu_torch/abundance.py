"""Abundance estimation, merge, and report.

Re-implements:
  * getAbundance.cc       — estimate() : classification CSVs -> abundance CSV
                            (+ Krona `results.krn` / MetaPhlAn `results.mpa`)
  * app/kent.cpp:605-726  — merge()    : sum abundance CSVs by taxid
  * app/kent.cpp:728-819  — report()   : human-readable pathogen summary

Output formatting matches the reference byte-for-byte: proportions print with
C++ default ostream precision (== printf %g) in estimate(), and with
fixed-2-decimals in merge()/report() (kent.cpp format_percentage).
Bug-compatible details preserved: the double comma in the no-taxonomy header
("Name,TargetID,,Count,..."), and the names.dmp scan that stops once every
directly-assigned label has a name (getAbundance.cc:421).
"""

from __future__ import annotations

import dataclasses
import os

from .taxonomy import TaxTree, load_nodes
from .utils import native as _native


def _g(x: float) -> str:
    return "%g" % x


def _pct2(x: float) -> str:
    return "%.2f" % x


@dataclasses.dataclass
class AbundanceResult:
    header: str
    rows: list[str]

    def text(self) -> str:
        return "\n".join([self.header] + self.rows) + "\n"


def estimate(
    csv_files: list[str],
    db_dir: str | None = None,
    min_confidence: float = 0.5,
    min_gamma: float = 0.0,
    min_abundance: float = 0.0,
    high_confidence: bool = False,
    krona_path: str | None = None,
    mpa_path: str | None = None,
) -> AbundanceResult:
    """getAbundance.cc main flow."""
    if high_confidence:
        min_confidence, min_gamma = 0.75, 0.03

    label_index: dict[str, int] = {}
    labels: list[str] = []
    counts: list[int] = []
    total = 0
    first = True

    def tally(lbl: str, c: int):
        i = label_index.get(lbl)
        if i is None:
            label_index[lbl] = len(labels)
            labels.append(lbl)
            counts.append(c)
        else:
            counts[i] += c

    for path in csv_files:
        if os.path.getsize(path) > 0:
            # native one-pass scan (~10x the line loop on multi-M-read CSVs)
            # over the mmap'd file — resident pages are reclaimable, so
            # memory stays flat on multi-GB CSVs; returns None on anything
            # it cannot replicate exactly (the line loop then re-reads)
            import mmap as _mmap

            with open(path, "rb") as fb, _mmap.mmap(
                fb.fileno(), 0, access=_mmap.ACCESS_READ
            ) as mm:
                nlpos = mm.find(b"\n")
                hdr = None
                if nlpos >= 0:
                    try:
                        hdr = mm[: nlpos + 1].decode()
                    except UnicodeDecodeError:
                        pass
                if hdr is not None:
                    if first:
                        ncols = len([e for e in _split_csv(hdr) if e])
                        idx = 2 if ncols == 3 else ncols - 3
                        first = False
                    res = _native.abundance_scan(
                        mm, idx, min_gamma, min_confidence,
                        offset=nlpos + 1,
                    )
                    if res is not None:
                        lbls, cnts, tot = res
                        total += tot
                        for lbl, c in zip(lbls, cnts):
                            tally(lbl, int(c))
                        continue
        with open(path) as f:
            header = f.readline()
            if first:
                ncols = len([e for e in _split_csv(header) if e])
                idx = 2 if ncols == 3 else ncols - 3
                first = False
            for line in f:
                ele = [e for e in _split_csv(line) if e]
                if not ele:
                    continue
                total += 1
                lbl = ele[idx] if idx < len(ele) else "NA"
                if len(ele) > 3:
                    try:
                        admissible = (
                            float(ele[idx - 1]) >= min_gamma
                            and float(ele[idx + 2]) >= min_confidence
                        )
                    except (ValueError, IndexError):
                        admissible = False
                    if not admissible:
                        lbl = "NA"
                tally(lbl, 1)

    names = list(labels)
    lineages: list[list] = [[] for _ in labels]
    id_to_name: dict[int, str] = {}
    have_tax = db_dir is not None
    if have_tax:
        tree = load_nodes(os.path.join(db_dir, "taxonomy", "nodes.dmp"))
        for i, lbl in enumerate(labels):
            if lbl == "NA":
                continue
            lin = tree.lineage8(_atoi(lbl))
            if lin is None:
                labels[i] = "NA"
                names[i] = "NA"
                continue
            # entries 0..6 (species..superkingdom); rank==0 marker == assigned
            lineages[i] = [(lin[t], lin[t] != 0) for t in range(7)]
            for tid, assigned in lineages[i]:
                if assigned:
                    id_to_name.setdefault(tid, "")
        _scan_names(
            os.path.join(db_dir, "taxonomy", "names.dmp"),
            label_index,
            labels,
            names,
            id_to_name,
        )

    rows_data = []
    for i in range(len(labels)):
        rows_data.append((names[i], labels[i], counts[i], lineages[i]))
    rows_data.sort(key=lambda r: r[0])

    unk = sum(c for (n, l, c, _x) in rows_data if n == "NA")
    out_rows = []
    for name, taxid, cnt, lin in rows_data:
        if name == "NA":
            continue
        a = 100.0 * cnt / total if total else 0.0
        a2 = 100.0 * cnt / (total - unk) if (total - unk) else float("inf")
        if a < min_abundance:
            continue
        if lin:
            lin_names = [id_to_name.get(lin[6][0], "")]
            for u in range(5, 0, -1):
                lin_names.append(id_to_name.get(lin[u][0], ""))
            out_rows.append(
                f"{name},{taxid},{';'.join(lin_names)},{cnt},{_g(a)},{_g(a2)}"
            )
        else:
            out_rows.append(f"{name},{taxid},{cnt},{_g(a)},{_g(a2)}")
    a = 100.0 * unk / total if total else 0.0
    if a >= min_abundance:
        if have_tax:
            out_rows.append(f"UNKNOWN,UNKNOWN,UNKNOWN,{unk},{_g(a)},-")
        else:
            out_rows.append(f"UNKNOWN,UNKNOWN,{unk},{_g(a)},-")

    if have_tax:
        header = "Name,TaxID,Lineage,Count,Proportion_All(%),Proportion_Classified(%)"
    else:
        # reference prints "Name,TargetID," then ",Count,..." (double comma)
        header = "Name,TargetID,,Count,Proportion_All(%),Proportion_Classified(%)"

    if krona_path:
        with open(krona_path, "w") as f:
            for name, taxid, cnt, _lin in rows_data:
                if name != "NA":
                    f.write(f"{taxid} \t {taxid} \t {cnt}\n")
    if mpa_path:
        _write_mpa(mpa_path, rows_data, id_to_name)
    return AbundanceResult(header=header, rows=out_rows)


def _split_csv(line: str) -> list[str]:
    out = []
    cur = []
    for ch in line:
        if ch in ",\t\r\n":
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out


def _atoi(s: str) -> int:
    """C atoi: leading int prefix, 0 on failure."""
    i = 0
    neg = False
    if i < len(s) and s[i] in "+-":
        neg = s[i] == "-"
        i += 1
    num = 0
    seen = False
    while i < len(s) and s[i].isdigit():
        num = num * 10 + int(s[i])
        i += 1
        seen = True
    if not seen:
        return 0
    return -num if neg else num


def _scan_names(path, label_index, labels, names, id_to_name):
    """names.dmp scan, stopping once all direct labels are named
    (bug-compatible with getAbundance.cc:419-443)."""
    n_labels = len(labels)
    cpt = 0
    try:
        f = open(path, "rb")
    except OSError:
        return
    with f:
        for raw in f:
            if cpt >= n_labels:
                break
            parts = raw.split(b"\t|\t")
            if len(parts) < 4:
                continue
            key = parts[0].split(b"\t")[0].decode()
            sci = b"scientific name" in parts[3]
            i = label_index.get(key)
            if i is not None and sci:
                cpt += 1
                names[i] = parts[1].split(b"\t")[0].decode()
            if sci:
                tid = _atoi(key)
                if tid in id_to_name:
                    id_to_name[tid] = parts[1].split(b"\t")[0].decode()


_MPA_RANKS = ["s__", "g__", "f__", "o__", "c__", "p__", "d__"]


def _mpa_name(s: str) -> str:
    return s.replace(" ", "_")


def _write_mpa(path, rows_data, id_to_name):
    """MetaPhlAn export (getAbundance.cc:523-577)."""
    with open(path, "w") as f:
        taken: set[int] = set()
        for t in range(7, 0, -1):
            for r, (name, taxid, cnt, lin) in enumerate(rows_data):
                # skip if lineage too short or rank unassigned at level t
                if len(lin) <= t or not lin[t][1]:
                    continue
                c_rank = lin[t][0]
                if c_rank in taken:
                    continue
                taken.add(c_rank)
                c_count = cnt
                ln = len(lin)  # == 7
                parts = [_MPA_RANKS[ln - 1] + _mpa_name(id_to_name.get(lin[ln - 1][0], ""))]
                for v in range(ln - 2, t - 1, -1):
                    nm = id_to_name.get(lin[v][0], "")
                    if nm != "":
                        parts.append(_MPA_RANKS[v] + _mpa_name(nm))
                for s, (name2, taxid2, cnt2, lin2) in enumerate(rows_data):
                    if s == r or len(lin2) <= t:
                        continue
                    if lin2[t][0] == c_rank:
                        c_count += cnt2
                f.write("|".join(parts) + f"\t{c_count}\n")
        for name, taxid, cnt, lin in rows_data:
            if name == "NA":
                continue
            ln = len(lin)
            if ln == 0:
                continue
            parts = [_MPA_RANKS[ln - 1] + _mpa_name(id_to_name.get(lin[ln - 1][0], ""))]
            for v in range(ln - 2, 0, -1):
                nm = id_to_name.get(lin[v][0], "")
                if nm != "":
                    parts.append(_MPA_RANKS[v] + _mpa_name(nm))
            parts.append(_MPA_RANKS[0] + _mpa_name(name))
            f.write("|".join(parts) + f"\t{cnt}\n")


# --------------------------------------------------------------------- merge
def merge(input_files: list[str], output_file: str) -> dict:
    """kent -m: sum abundance CSVs by taxid; recompute proportions
    (kent.cpp:605-726)."""
    merged: dict[str, dict] = {}
    order: list[str] = []
    any_lineage = False
    for path in input_files:
        with open(path) as f:
            header = f.readline()
            has_lineage = "Lineage" in header
            any_lineage = any_lineage or has_lineage
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                parts = line.split(",")
                if has_lineage:
                    if len(parts) < 6:
                        continue
                    name, taxid, lineage, cnt = parts[0], parts[1], parts[2], parts[3]
                else:
                    if len(parts) < 5:
                        continue
                    name, taxid, lineage, cnt = parts[0], parts[1], "", parts[2]
                count = _atoi(cnt)
                e = merged.get(taxid)
                if e is None:
                    merged[taxid] = {
                        "name": name,
                        "taxid": taxid,
                        "lineage": lineage,
                        "count": count,
                    }
                    order.append(taxid)
                else:
                    e["count"] += count
                    if not e["name"] and name:
                        e["name"] = name
                    if not e["lineage"] and lineage:
                        e["lineage"] = lineage
    if not merged:
        raise ValueError("No entries found in any input file.")

    grand_total = sum(e["count"] for e in merged.values())
    unknown = None
    for e in merged.values():
        if e["taxid"] == "UNKNOWN" or e["name"] == "UNKNOWN":
            unknown = e
    unknown_count = unknown["count"] if unknown else 0
    classified = grand_total - unknown_count

    rows = [
        e
        for e in merged.values()
        if e["taxid"] != "UNKNOWN" and e["name"] != "UNKNOWN"
    ]
    rows.sort(key=lambda e: e["name"])

    with open(output_file, "w") as out:
        if any_lineage:
            out.write(
                "Name,TaxID,Lineage,Count,Proportion_All(%),Proportion_Classified(%)\n"
            )
        else:
            out.write("Name,TaxID,Count,Proportion_All(%),Proportion_Classified(%)\n")
        for e in rows:
            pa = 100.0 * e["count"] / grand_total if grand_total > 0 else 0.0
            pc = 100.0 * e["count"] / classified if classified > 0 else 0.0
            line = f"{e['name']},{e['taxid']}"
            if any_lineage:
                line += f",{e['lineage']}"
            out.write(f"{line},{e['count']},{_pct2(pa)},{_pct2(pc)}\n")
        if unknown is not None:
            pa = 100.0 * unknown_count / grand_total if grand_total > 0 else 0.0
            line = f"{unknown['name']},{unknown['taxid']}"
            if any_lineage:
                line += f",{unknown['lineage']}"
            out.write(f"{line},{unknown_count},{_pct2(pa)},-\n")
    return {"files": len(input_files), "total": grand_total, "output": output_file}


# -------------------------------------------------------------------- report
def report(abundance_file: str, output_file: str) -> dict:
    """kent -r: pathogen summary sorted by %classified (kent.cpp:728-819)."""
    entries = []
    with open(abundance_file) as f:
        header = f.readline()
        if not header:
            raise ValueError("Abundance result file is empty.")
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split(",")
            if len(parts) < 6 or parts[0] == "UNKNOWN":
                continue
            try:
                pa = float(parts[4])
                pc = float(parts[5])
            except ValueError:
                continue
            entries.append((parts[0], pa, pc))
    with open(output_file, "w") as out:
        out.write("RESULT\n")
        if not entries:
            out.write(f"No classified pathogens found in {abundance_file}.\n")
            return {"entries": 0, "output": output_file}
        entries.sort(key=lambda e: (-e[2], e[0]))
        out.write(
            "Your read contains these pathogens, the percentage of all input "
            "reads (including unclassified) that hit this taxon and the "
            "percentage among only the reads that got classified that hit "
            "this taxon.\n"
        )
        for name, pa, pc in entries:
            out.write(
                f"- {name}: {_pct2(pa)}% among all, {_pct2(pc)}% among classified\n"
            )
    return {"entries": len(entries), "output": output_file}
