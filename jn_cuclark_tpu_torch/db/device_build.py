"""DB-build aggregate on a torch device (`db build --device`).

The build's hot loop groups the canonical k-mer occurrences and applies the
multiplicity rules.  On a CUDA device that is the hand-written kernel K6
(ops/kernels/aggregate.cu): a bucket sort fused with the group pass, whose
level plan is ops/bucket_plan.py.  On the CPU the same plan runs with each
kernel's plain-PyTorch twin (`aggregate_bucketed_plain`).  Both are held
against `aggregate_device_plain`, which follows the JAX package's
`_aggregate_device` (jn_cuclark_tpu/db/device_build.py) with a stable
torch.sort.

u64 keys ride as int64 bit patterns, which torch orders as signed: a key
with bit 63 set (possible at k = 32) would sort first.  The plain twin
sorts `canonical ^ 2^63`, whose signed order is the canonicals' unsigned
order; the bucketed forms compare unsigned.  Nothing here falls back to
the host aggregate: a failure raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bits, bucket_plan

SIGN = bits.i64(1 << 63)  # int64 bit pattern of 2^63
_LOW32 = 0xFFFFFFFF
IDX = bucket_plan.IDX_BITS
_U64_MASK = (1 << 64) - 1
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def _aggregate_device(canon: torch.Tensor, label: torch.Tensor,
                      pg: torch.Tensor, lelement: bool):
    """Tensor form of the aggregate on the device of `canon`: canon [n]
    int64 (u64 bit patterns, stream order), label [n] int32, pg [L] int32
    -> (canon [G] int64 bits ascending as u64, L0 [G] int32, mult [G]
    int32, count [G] int64, first_seq [G] int64)."""
    if canon.device.type == "cuda":
        from ..ops import kernels

        return kernels.aggregate(canon, label, pg, lelement)
    if canon.device.type != "cpu":
        raise ValueError(f"unsupported device {canon.device}")
    return aggregate_bucketed_plain(canon, label, pg, lelement)


def _empty_rows(dev):
    return (torch.empty(0, dtype=torch.int64, device=dev),
            torch.empty(0, dtype=torch.int32, device=dev),
            torch.empty(0, dtype=torch.int32, device=dev),
            torch.empty(0, dtype=torch.int64, device=dev),
            torch.empty(0, dtype=torch.int64, device=dev))


def aggregate_bucketed_plain(canon: torch.Tensor, label: torch.Tensor,
                             pg: torch.Tensor, lelement: bool,
                             cap: int = bucket_plan.CAP, stats=None):
    """Plain-PyTorch twin of K6's bucketed form (any device): the level
    plan of ops/bucket_plan.run_levels with each kernel's twin, at bucket
    capacity `cap` (a small cap drives every branch of the plan at a small
    size).  `stats`, a dict, receives the plan's branch counts."""
    if not 1 <= cap <= bucket_plan.CAP:
        raise ValueError(f"bucket capacity {cap} is not in [1, "
                         f"{bucket_plan.CAP}]: a bucket's places fit "
                         f"{bucket_plan.IDX_BITS} bits")
    n = canon.shape[0]
    if n == 0:
        return _empty_rows(canon.device)
    steps = _TwinSteps(canon, label, pg, lelement)
    out = bucket_plan.run_levels(steps, n, cap)
    if stats is not None:
        stats.update(steps.stats)
    return out


def _bitonic(x: torch.Tensor):
    """Sort each row of x [B, S] (S a power of two) ascending as u64, in
    place, by the bitonic network of K6's bucket pass: stage (k, j)
    compares i with i + j for each i whose bit j is clear, ascending where
    bit k of i is clear."""
    S = x.shape[1]
    col = torch.arange(S, device=x.device)
    k = 2
    while k <= S:
        j = k // 2
        while j >= 1:
            lo = col[(col & j) == 0]
            a, b = x[:, lo], x[:, lo + j]
            swap = bits.ult(b, a) == ((lo & k) == 0)
            x[:, lo] = torch.where(swap, b, a)
            x[:, lo + j] = torch.where(swap, a, b)
            j //= 2
        k *= 2


def _umin(x: torch.Tensor) -> torch.Tensor:
    return (x ^ SIGN).min() ^ SIGN


class _TwinSteps:
    """The twin of each launch of K6 (ops/kernels/aggregate.cu) on the
    buffers of bucket_plan.run_levels: bufs [2, capacity, 2] int64 of
    entries (key, seq << 32 | label) and staged rows, rowflag [capacity]
    uint8 (1 + the buffer of a row's first half where one is staged, 0
    elsewhere)."""

    def __init__(self, canon, label, pg, lelement):
        dev = canon.device
        cap_n = bucket_plan.capacity(canon.shape[0])
        self.canon, self.label, self.pg = canon, label, pg
        self.lelement = lelement
        self.bufs = torch.empty((2, cap_n, 2), dtype=torch.int64, device=dev)
        self.rowflag = torch.empty(cap_n, dtype=torch.uint8, device=dev)
        self.stats = bucket_plan.new_stats()

    def range(self):
        k = self.canon ^ SIGN
        return ((int(k.min()) ^ SIGN) & _U64_MASK,
                (int(k.max()) ^ SIGN) & _U64_MASK)

    def _entries(self, src, s, c):
        if src < 0:
            seq = torch.arange(s, s + c, dtype=torch.int64,
                               device=self.canon.device)
            lab = self.label[s : s + c].to(torch.int64) & _LOW32
            return self.canon[s : s + c], (seq << 32) | lab
        return self.bufs[src, s : s + c, 0], self.bufs[src, s : s + c, 1]

    def partition(self, src, dst, table):
        """hist, scan and scatter of each range of a level's table."""
        dev = self.bufs.device
        nb_all = int((1 << table[:, 3]).sum())
        plan = torch.empty((3, nb_all), dtype=torch.int64, device=dev)
        starts = torch.empty(nb_all, dtype=torch.int64, device=dev)
        for s, c, shift, nbits, boff in table.tolist():
            keys, vals = self._entries(src, s, c)
            nb = 1 << nbits
            d = bits.lsr(keys, shift) & (nb - 1)
            kf = keys ^ SIGN
            p = plan[:, boff : boff + nb]
            p[0] = torch.bincount(d, minlength=nb)
            p[1] = torch.full_like(p[1], _I64_MAX).scatter_reduce(
                0, d, kf, "amin") ^ SIGN
            p[2] = torch.full_like(p[2], _I64_MIN).scatter_reduce(
                0, d, kf, "amax") ^ SIGN
            starts[boff : boff + nb] = s + torch.cumsum(p[0], 0) - p[0]
            # the kernel's order inside a bucket is free; the twin's stable
            order = torch.argsort(d, stable=True)
            self.bufs[dst, s : s + c, 0] = keys[order]
            self.bufs[dst, s : s + c, 1] = vals[order]
        return plan, starts

    def bucket_pass(self, dst, plan, starts, S):
        """The level's buckets of sort length S: each sorts one u64 an
        entry, (key - the bucket's min) << IDX_BITS | the entry's place; a
        group's min val gives L0."""
        bufs, dev = self.bufs, self.bufs.device
        m_all = plan[0]
        b = torch.nonzero((m_all > 0) & (m_all <= S) & (
            (m_all > S // 2) | (S == bucket_plan.MIN_SORT))).view(-1)
        m, bmin, st = plan[0][b], plan[1][b], starts[b]
        col = torch.arange(S, device=dev)
        valid = col[None, :] < m[:, None]
        pos = (st[:, None] + col[None, :]).clamp(max=bufs.shape[1] - 1)
        comp = torch.where(
            valid, ((bufs[dst, pos, 0] - bmin[:, None]) << IDX) | col,
            bits.EMPTY)
        vals = bufs[dst, pos, 1]
        _bitonic(comp)
        rel, idx = bits.lsr(comp, IDX), comp & ((1 << IDX) - 1)
        start = valid.clone()
        start[:, 1:] &= rel[:, 1:] != rel[:, :-1]
        gid = (torch.cumsum(start, 1) - 1).clamp(min=0)
        flat = gid + S * torch.arange(len(b), device=dev)[:, None]
        v = torch.where(valid, vals.gather(1, idx.clamp(max=S - 1)), 0)
        gmin = torch.full((len(b) * S,), _I64_MAX, device=dev).scatter_reduce(
            0, flat[valid], v[valid] ^ SIGN, "amin") ^ SIGN
        lab = torch.where(valid, v & _LOW32, 0)
        l0 = (gmin & _LOW32)[flat]
        d = ((lab != l0).to(torch.int64) + (self.pg[lab] != self.pg[l0]))
        dsum = torch.zeros(len(b) * S, dtype=torch.int64, device=dev
                           ).index_add_(0, flat[valid], d[valid])
        r, a = torch.nonzero(start, as_tuple=True)
        end = torch.where(torch.cat([r[1:] == r[:-1],
                                     torch.zeros(1, dtype=torch.bool,
                                                 device=dev)]),
                          torch.cat([a[1:], a[:1]]), m[r])
        g = gid[r, a]
        count = end - a
        if self.lelement:
            count = count.clamp(max=254)
        p = st[r] + g
        bufs[dst, p, 0] = bmin[r] + bits.lsr(comp[r, a], IDX)
        bufs[dst, p, 1] = gmin[flat[r, a]]
        bufs[1 - dst, p, 0] = count
        bufs[1 - dst, p, 1] = (1 + dsum[flat[r, a]]).clamp(max=255)
        ng = start.sum(1)
        self.rowflag[pos[valid]] = torch.where(
            col[None, :] < ng[:, None], 1 + dst, 0).to(torch.uint8)[valid]

    def single(self, dst, lstart, lcount):
        bufs = self.bufs
        for s, c in zip(lstart.tolist(), lcount.tolist()):
            vals = bufs[dst, s : s + c, 1]
            vmin = _umin(vals)
            lab, l0 = vals & _LOW32, vmin & _LOW32
            dsum = int(((lab != l0).to(torch.int64)
                        + (self.pg[lab] != self.pg[l0])).sum())
            bufs[dst, s, 1] = vmin
            bufs[1 - dst, s, 0] = min(c, 254) if self.lelement else c
            bufs[1 - dst, s, 1] = min(1 + dsum, 255)
            self.rowflag[s : s + c] = 0
            self.rowflag[s] = 1 + dst

    def compact(self):
        bufs = self.bufs
        n = self.canon.shape[0]
        p = torch.nonzero(self.rowflag[:n]).view(-1)
        cb = self.rowflag[p].to(torch.int64) - 1
        a, b = bufs[cb, p], bufs[1 - cb, p]
        return (a[:, 0], (a[:, 1] & _LOW32).to(torch.int32),
                b[:, 1].to(torch.int32), b[:, 0], bits.lsr(a[:, 1], 32))


def aggregate_device_plain(canon: torch.Tensor, label: torch.Tensor,
                           pg: torch.Tensor, lelement: bool):
    """Plain-PyTorch version of K6 (any device), independent of its
    bucketed form: the JAX package's _aggregate_device (a stable sort of
    the keys, then segment sums), then the compaction to one row per group
    that its host wrapper does."""
    keys, seq = torch.sort(canon ^ SIGN, stable=True)
    n = keys.shape[0]
    start = torch.ones(n, dtype=torch.bool, device=keys.device)
    start[1:] = keys[1:] != keys[:-1]
    gid = torch.cumsum(start, 0) - 1
    first = torch.nonzero(start).squeeze(1)
    lab = label[seq]
    l0 = lab[first]
    l0_of = l0[gid]
    # zero at each group start, where lab == l0_of
    d = (lab != l0_of).to(torch.int64) + (pg[lab] != pg[l0_of]).to(torch.int64)
    ng = first.shape[0]
    mult = torch.zeros(ng, dtype=torch.int64, device=keys.device)
    mult.index_add_(0, gid, d)
    mult = torch.clamp(mult + 1, max=255).to(torch.int32)
    gsize = torch.bincount(gid, minlength=ng)
    count = torch.clamp(gsize, max=254) if lelement else gsize
    return keys[first] ^ SIGN, l0, mult, count, seq[first]


def aggregate_device(canon, label, pg, lelement: bool, device):
    """Same contract as native.aggregate_occurrences (unit counts), on the
    torch `device`: numpy in, numpy out."""
    from ..engine import _resolve_device

    dev = _resolve_device(device)
    canon = np.ascontiguousarray(canon, np.uint64)
    out = _aggregate_device(
        torch.from_numpy(canon.view(np.int64)).to(dev),
        torch.from_numpy(np.ascontiguousarray(label, np.int32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(pg, np.int32)).to(dev),
        lelement,
    )
    c, l0, mult, count, first = (t.cpu().numpy() for t in out)
    return c.view(np.uint64), l0, mult, count, first
