"""Plain reference of CLARK's classification, as CuCLARK defines it.

Written from the published rules in plain NumPy and PyTorch, on whatever
device it is given; it shares no code with the program.

  Bases        A=0 C=1 G=2 T/U=3 (either case); any other byte is invalid.
  k-mer value  enc(S) = sum_i code(s_i) * 4**i, the first base lowest;
               canonical(S) = min(enc(S), enc(revcomp(S))).
  Database     each target file's k-mers: every window of k valid bases
               inside one record (full mode), or, in light mode, the
               non-overlapping k-mers of each run of valid bases (runs end
               at an invalid byte or a record's end), of which one in `gap`
               by a counter over the whole file.  A canonical k-mer is
               discriminative where every occurrence is of one target's
               label; it then maps to that label.  (Labels of the targets
               file are distinct here: no centromere pairs.)
  A read       every window of k valid bases looked up; per target the
               windows that hit it.  total = hits, best = the largest
               count (the lowest target index on a tie), s_best = the
               largest count of the other targets.
  Its row      name,Gamma,Assignment,Score,Confidence with
               Gamma = total / (length - k + 1), Confidence =
               best / (best + s_best) (0 where that sum is 0), both doubles
               printed with C's %g; Assignment the best target's label, or
               NA where nothing hit; Score = best.  A read of k - 1 bases
               prints Gamma as -nan.  Rows come in input order.

`key_bits` below 64 is the control: the table then tells k-mers apart by
their low `key_bits` bits alone, a compact-hash shortcut that breaks the
guarantee of exact k-mer matching.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

NAME_MAX = 39  # longest read name this reference vouches for
BLOCK = 1 << 25  # windows computed at a time

CODE = np.full(256, -1, dtype=np.int8)
for _chars, _v in (("Aa", 0), ("Cc", 1), ("Gg", 2), ("TtUu", 3)):
    for _c in _chars:
        CODE[ord(_c)] = _v


class Records:
    """Records of a FASTA buffer, parsed on `device`: names (on
    the host), the sequences' bytes concatenated (`seq`, uint8 on the
    device) and offsets [R + 1] into them (on the host).  Every byte of a
    sequence line but its newline is sequence, a CR too (an invalid base,
    as any other byte)."""

    def __init__(self, data: bytes, device="cpu"):
        if data[:1] != b">":
            raise ValueError("not FASTA")
        with warnings.catch_warnings():  # read only: nothing writes to it
            warnings.simplefilter("ignore", UserWarning)
            buf = torch.frombuffer(data, dtype=torch.uint8).to(device)
        n = len(buf)
        ends = torch.nonzero(buf == 10).squeeze(1)
        if not len(ends) or int(ends[-1]) != n - 1:
            ends = torch.cat([ends, torch.tensor([n], device=device)])
        starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                            ends[:-1] + 1])
        head = (ends > starts) & (buf[starts.clamp(max=n - 1)] == 62)
        seq_line = ~head
        mark = torch.zeros(n + 1, dtype=torch.int32, device=device)
        mark[starts[seq_line]] += 1
        mark[ends[seq_line]] -= 1
        self.seq = buf[torch.cumsum(mark[:-1], 0, dtype=torch.int32) > 0]
        rec = torch.cumsum(head, 0) - 1
        lengths = torch.zeros(int(head.sum()), dtype=torch.int64,
                              device=device).index_add_(
            0, rec[seq_line], (ends - starts)[seq_line])
        self.offsets = np.concatenate([[0], torch.cumsum(
            lengths, 0).cpu().numpy()]).astype(np.int64)
        # a name ends at the header's first space or tab
        hs, he = starts[head] + 1, ends[head]
        ws = torch.nonzero((buf == 32) | (buf == 9)).squeeze(1)
        if len(ws):
            nxt = ws[torch.searchsorted(ws, hs).clamp(max=len(ws) - 1)]
            he = torch.where(nxt >= hs, torch.minimum(he, nxt), he)
        self.names = [data[a:b] for a, b in zip(hs.tolist(), he.tolist())]
        longest = max(map(len, self.names), default=0)
        if longest > NAME_MAX:
            raise ValueError(f"a read name of {longest} bytes: this "
                             f"reference vouches for {NAME_MAX} at most")

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)


def canonicals(codes: torch.Tensor, starts: torch.Tensor, k: int):
    """(canonical value, valid) of the k-mers at `starts` of the code array
    `codes` (int64, -1 invalid): valid where all k bases are."""
    fwd = torch.zeros(len(starts), dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    bad = torch.zeros(len(starts), dtype=torch.bool, device=codes.device)
    for j in range(k):
        c = codes[starts + j]
        bad |= c < 0
        c = c.clamp(min=0)
        fwd |= c << (2 * j)
        rc |= (3 - c) << (2 * (k - 1 - j))
    return torch.minimum(fwd, rc), ~bad


def _codes(seq: torch.Tensor) -> torch.Tensor:
    """int64 base codes (-1 invalid) of sequence bytes, on their device."""
    return torch.from_numpy(CODE.astype(np.int64)).to(seq.device)[
        seq.long()]


def _all_starts(offsets: np.ndarray, k: int, device):
    """Every window start of each record, and its record's index."""
    counts = np.maximum(np.diff(offsets) - k + 1, 0)
    rec = torch.repeat_interleave(
        torch.arange(len(counts), device=device),
        torch.from_numpy(counts).to(device))
    first = torch.from_numpy(offsets[:-1] - np.concatenate(
        [[0], np.cumsum(counts)[:-1]])).to(device)
    return torch.arange(len(rec), device=device) + first[rec], rec


def _light_starts(codes: np.ndarray, offsets: np.ndarray, k: int, gap: int):
    """Light mode's k-mer starts in one file: the non-overlapping k-mers of
    each run of valid bases, then one in `gap` by a counter over the
    file."""
    pos = np.flatnonzero(codes >= 0)
    rec_start = np.zeros(len(codes) + 1, dtype=bool)
    rec_start[offsets[:-1]] = True
    new = np.ones(len(pos), dtype=bool)
    new[1:] = (pos[1:] != pos[:-1] + 1) | rec_start[pos[1:]]
    first = np.flatnonzero(new)
    n_k = np.diff(np.append(first, len(pos))) // k
    j = np.arange(n_k.sum()) - np.repeat(np.cumsum(n_k) - n_k, n_k)
    idx = np.repeat(first, n_k) + j * k
    return pos[idx[np.arange(len(idx)) % gap == 0]]


def database(genome_files: list[str], k: int, light: bool, gap: int,
             device) -> tuple[torch.Tensor, torch.Tensor]:
    """(keys, label indices): the discriminative canonical k-mers of the
    target files (file i is target i), sorted, each with its target."""
    keys, labels = [], []
    for i, path in enumerate(genome_files):
        with open(path, "rb") as f:
            recs = Records(f.read(), device)
        dev_codes = _codes(recs.seq)
        if light:
            starts = torch.from_numpy(_light_starts(
                dev_codes.cpu().numpy(), recs.offsets, k, gap)).to(device)
        else:
            starts = _all_starts(recs.offsets, k, device)[0]
        for b in range(0, len(starts), BLOCK):
            canon, ok = canonicals(dev_codes, starts[b:b + BLOCK], k)
            keys.append(canon[ok])
            labels.append(torch.full((int(ok.sum()),), i, device=device))
    keys, labels = torch.cat(keys), torch.cat(labels)
    keys, order = torch.sort(keys, stable=True)
    labels = labels[order]
    first = torch.ones(len(keys), dtype=torch.bool, device=device)
    first[1:] = keys[1:] != keys[:-1]
    group = torch.cumsum(first, 0) - 1
    n = int(first.sum())
    lo = torch.full((n,), len(genome_files), device=device).scatter_reduce(
        0, group, labels, "amin")
    hi = torch.full((n,), -1, device=device).scatter_reduce(
        0, group, labels, "amax")
    keep = lo == hi
    return keys[first][keep], lo[keep]


def _table(keys, labels, key_bits: int):
    if key_bits >= 64:
        return keys, labels
    # the control: keys told apart by their low bits; of keys that share
    # them, the first (smallest) keeps its label
    short = keys & ((1 << key_bits) - 1)
    short, order = torch.sort(short, stable=True)
    labels = labels[order]
    first = torch.ones(len(short), dtype=torch.bool, device=short.device)
    first[1:] = short[1:] != short[:-1]
    return short[first], labels[first]


def scores(recs: Records, keys, labels, k: int, n_targets: int, device,
           key_bits: int = 64, count_queried: bool = False,
           reads_per_block: int = 1 << 18) -> dict:
    """total, ibest (the best target's index + 1, 0 where nothing hit),
    best and sbest, each [R] int64 on the host; with count_queried also
    `queried`, the distinct canonical k-mers the reads look up."""
    tkeys, tlabels = _table(keys, labels, key_bits)
    mask = (1 << key_bits) - 1 if key_bits < 64 else -1
    out = {f: [] for f in ("total", "ibest", "best", "sbest")}
    queried = []
    t1 = n_targets + 1
    idx = torch.arange(n_targets, device=device)
    n = len(recs.names)
    for r0 in range(0, n, reads_per_block):
        r1 = min(r0 + reads_per_block, n)
        offs = recs.offsets[r0:r1 + 1]
        codes = _codes(recs.seq[offs[0]:offs[-1]])
        starts, rid = _all_starts(offs - offs[0], k, device)
        hits = torch.zeros(len(starts), dtype=torch.int64, device=device)
        for b in range(0, len(starts), BLOCK):
            canon, ok = canonicals(codes, starts[b:b + BLOCK], k)
            if count_queried:
                queried.append(torch.unique(canon[ok]))
            if not len(tkeys):
                continue
            q = canon & mask
            at = torch.searchsorted(tkeys, q).clamp(max=len(tkeys) - 1)
            hits[b:b + BLOCK] = torch.where(ok & (tkeys[at] == q),
                                            tlabels[at] + 1, 0)
        counts = torch.bincount(rid * t1 + hits, minlength=(r1 - r0) * t1)
        counts = counts.view(r1 - r0, t1)[:, 1:]
        best = counts.amax(dim=1)
        ibest = torch.where(counts == best[:, None], idx,
                            n_targets).amin(dim=1)
        sbest = torch.where(idx == ibest[:, None], -1, counts).amax(dim=1)
        out["total"].append(counts.sum(dim=1))
        out["ibest"].append(torch.where(best > 0, ibest + 1, 0))
        out["best"].append(best)
        out["sbest"].append(sbest.clamp(min=0))
    res = {f: torch.cat(v).cpu().numpy() for f, v in out.items()}
    if count_queried:
        res["queried"] = int(torch.unique(torch.cat(queried)).numel()
                             if queried else 0)
    return res


def rows(recs: Records, sc: dict, k: int, target_names: list[str]) -> list:
    """Each read's CSV row (bytes with its newline), in input order."""
    names = [t.encode() for t in target_names]
    out = []
    for name, total, ib, best, sb, ln in zip(
            recs.names, sc["total"].tolist(), sc["ibest"].tolist(),
            sc["best"].tolist(), sc["sbest"].tolist(),
            recs.lengths.tolist()):
        denom = float(ln) - k + 1.0
        if denom == 0.0:  # C prints 0.0 / 0.0 as -nan
            out.append(b"%s,-nan,%s,%d,0\n" % (name, names[0], best))
            continue
        delta = float(best + sb)
        conf = 0.0 if delta < 0.001 else best / delta
        out.append(b"%s,%s,%s,%d,%s\n" % (name, b"%g" % (total / denom),
                                          names[ib], best, b"%g" % conf))
    return out


def expected(sample: bytes, targets_file: str, cfg: dict, device,
             key_bits: int = 64, count_queried: bool = False):
    """(every read's row of a FASTA sample, joined; the work counted: the
    bases, the reads, the database's keys and, with count_queried, the
    distinct canonical k-mers queried), worked out from the genome files
    that the targets file names (`<file> <label>` a line) and from the
    configuration's k, light flag and gap."""
    with open(targets_file) as f:
        files, labels = zip(*(ln.split()[:2] for ln in f if ln.strip()))
    recs = Records(sample, device)
    keys, labs = database(list(files), cfg["k"], cfg["light"], cfg["gap"],
                          device)
    sc = scores(recs, keys, labs, cfg["k"], len(files), device,
                key_bits=key_bits, count_queried=count_queried)
    want = b"".join(rows(recs, sc, cfg["k"], ["NA", *labels]))
    return want, dict(bases=int(recs.offsets[-1]), reads=len(recs.names),
                      keys=len(keys), queried=sc.get("queried", 0))
