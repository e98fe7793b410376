"""Fixed-slot radix hash table — the hot-path index — and its device probe.

Host side (numpy, identical to the JAX package's ops/radix_table.py so that
either package builds the same table and loads the other's `.idx.npz`
cache, format version 5):

  * single level: [n1, C] 64-bit slots stored as u32 contiguous halves
    (row i is [lo_0..lo_{C-1}, hi_0..hi_{C-1}]); bucket = top m1 bits of an
    odd-multiplier Fibonacci mix of the canonical value
  * quotient storage: the mix is a bijection mod 2^64, so a slot keeps only
    the mixed value's low 64-m1 bits (the bucket supplies the rest), and
    the freed bits hold the label: slot = (mixed_lo << lb) | (label+1)
  * stash: build-time bucket overflow goes to a 64-entry stash checked by
    direct compare; if it would overflow, the table grows one bit

Empty slots are all-ones.  No false hits: lb < m1 makes EMPTY >> lb wider
than any 64-m1-bit quotient, the all-ones label field is reserved, and an
invalid query (EMPTY, never a real canonical value) cannot match a stored
key, so misses resolve to label 0 ("NA").

Device side: `to_device` moves a built table into torch tensors (u32 halves
as int32 bit patterns, u64 stash keys as int64 bit patterns) and `probe`
answers label+1 per query with ONE row read: the CUDA kernel K2
(ops/kernels/classify.cu) for CUDA tensors, `probe_plain` for CPU tensors.
The on-disk format stays the reference's .sz/.ky/.lb (io/dbformat.py).

A table larger than the card's budget is kept either in the dense
two-plane layout (`build_dense`; probed by K8 `probe_dense`) or on the host
in row chunks streamed one per pass (`chunk_table`; probed by K7
`probe_chunk`).  The dense cache (`.idx.npz.dense`, version 2) is shared
with the JAX package like the standard one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import bits

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)
EMPTY32 = np.uint32(0xFFFFFFFF)  # both u32 halves of an EMPTY slot
_MIX1 = np.uint64(0x9E3779B97F4A7C15)  # 2^64 / golden ratio, odd
_MIX2 = np.uint64(0xC2B2AE3D27D4EB4F)  # xxhash64 prime_2, odd -> bijective
STASH_CAP = 64

# Slot storage is uint32 in CONTIGUOUS-HALVES layout: row i is
# [lo_0..lo_{C-1}, hi_0..hi_{C-1}], the two u32 halves of the C logical
# u64 slots (the JAX package's layout, kept so caches interchange; on the
# GPU each half-row is a contiguous, coalesced read).
#
# The hit test splits exactly: slot == (qlow << lb) | lab  <=>
# (x_hi == 0) & (x_lo < 2^lb) where x_* = slot_* ^ target_*, because
# lb <= 17 < 32 keeps the label field entirely in the low half.


def _mix_np(q: np.ndarray, mbits: int, mult: np.uint64 = _MIX1) -> np.ndarray:
    with np.errstate(over="ignore"):
        return ((q * mult) >> np.uint64(64 - mbits)).astype(np.int64)


@dataclasses.dataclass
class RadixTable:
    """Host-side build result; `to_device` moves it to a torch device."""

    slots: np.ndarray  # [n1, 2C] uint32 halves of (key << lb) | (label+1)
    #                    (lo half then hi half per row; EMPTY32 if free)
    labels: np.ndarray  # [n1*C] uint32 label+1 (only when lb == 0), else [0]
    stash_keys: np.ndarray  # [STASH_CAP] uint64 (EMPTY padded)
    stash_labels: np.ndarray  # [STASH_CAP] int32 label+1
    m1: int  # log2(n1)
    lb: int  # label bits packed into slots (0 = separate label array)
    slot_width: int

    @property
    def nbytes(self) -> int:
        return self.slots.nbytes + self.labels.nbytes

    @property
    def meta(self) -> dict:
        return dict(m1=self.m1, lb=self.lb, c=self.slot_width)


@dataclasses.dataclass
class TablePlan:
    """Deterministic global layout of a radix table, computed WITHOUT
    materializing the slot array — every process of a multi-host run derives
    the identical plan from the (identical) key set and then fills only its
    own row range with `fill_rows`."""

    m1: int  # log2(row count)
    lb: int  # label bits packed into slots (0 = separate label array)
    c: int  # slots per row
    stash_keys: np.ndarray  # [STASH_CAP] uint64 (EMPTY padded)
    stash_labels: np.ndarray  # [STASH_CAP] int32 label+1
    bucket: np.ndarray  # [n] int64 row of each key
    rank: np.ndarray  # [n] int64 slot rank of each key within its row

    @property
    def n_rows(self) -> int:
        return 1 << self.m1

    @property
    def meta(self) -> dict:
        return dict(m1=self.m1, lb=self.lb, c=self.c)


def _bucket_ranks(keys: np.ndarray, mbits: int, mult: np.uint64 = _MIX1):
    """Per-key (bucket, within-bucket rank) in original key order; rank
    follows the stable sort by bucket, so overflow selection is
    deterministic."""
    b = _mix_np(keys, mbits, mult)
    order = np.argsort(b, kind="stable")
    bs = b[order]
    start_of_run = np.concatenate([[True], bs[1:] != bs[:-1]])
    run_id = np.cumsum(start_of_run) - 1
    run_first = np.nonzero(start_of_run)[0]
    rank_sorted = np.arange(len(bs), dtype=np.int64) - run_first[run_id]
    rank = np.empty(len(bs), dtype=np.int64)
    rank[order] = rank_sorted
    return b, rank


def plan_table(
    keys: np.ndarray,
    labels1: np.ndarray,
    k: int | None = None,
    c: int | None = None,
    load: float | None = None,
) -> TablePlan:
    """Choose (m1, lb, c) and the overflow stash for a key set.

    Pure function of its inputs: independent processes planning the same DB
    agree bit-for-bit (required for multi-host sharding).  `k` is accepted
    for API stability but unused: quotient storage packs the label for every
    key width (see module docstring)."""
    del k
    keys = np.asarray(keys, dtype=np.uint64)
    labels1 = np.asarray(labels1, dtype=np.int32)
    n = max(len(keys), 1)
    if c is None:
        c = 128 if n >= 500_000 else 16
    if load is None:
        # mean keys/bucket lands in (load/2, load]; 0.69*c keeps the
        # binomial overflow tail within the stash at any n (the JAX
        # package's choice; identical tables are what lets caches
        # interchange)
        load = c * 0.69
    maxlab = int(labels1.max()) if len(labels1) else 1
    # label bits: the all-ones field is reserved so a valid slot never equals
    # EMPTY, hence maxlab + 2 values must fit
    lb = max(int(np.ceil(np.log2(maxlab + 2))), 2)
    m1 = max(int(np.ceil(np.log2(max(n / load, 1.0)))), 1)
    # lb < m1 keeps slot bits within 64 AND makes EMPTY >> lb wider than any
    # (64 - m1)-bit quotient, so EMPTY slots can never satisfy the compare
    m1 = max(m1, lb + 1)
    while True:
        b, rank = _bucket_ranks(keys, m1)
        ovf = rank >= c
        n_ovf = int(ovf.sum())
        if n_ovf <= STASH_CAP:
            break
        m1 += 1
    sk = np.full(STASH_CAP, EMPTY, dtype=np.uint64)
    sl = np.zeros(STASH_CAP, dtype=np.int32)
    if n_ovf:
        sk[:n_ovf] = keys[ovf]
        sl[:n_ovf] = labels1[ovf]
    return TablePlan(
        m1=m1, lb=lb, c=c, stash_keys=sk, stash_labels=sl, bucket=b, rank=rank
    )


def fill_rows(
    keys: np.ndarray,
    labels1: np.ndarray,
    plan: TablePlan,
    row_start: int,
    row_end: int,
):
    """Materialize rows [row_start, row_end) of the planned table.

    Slot = (mixed_lo << lb) | (label+1) where mixed_lo is the low 64-m1 bits
    of the bijective mix (the bucket row supplies the top m1 bits).  The
    returned labels array is always empty (kept for API stability with the
    callers' (slots, labels) plumbing).  row_end may exceed plan.n_rows
    (padding rows for even device splits stay EMPTY)."""
    keys = np.asarray(keys, dtype=np.uint64)
    labels1 = np.asarray(labels1, dtype=np.int32)
    c, lb = plan.c, plan.lb
    rows = row_end - row_start
    sel = (plan.bucket >= row_start) & (plan.bucket < row_end) & (plan.rank < c)
    bb = plan.bucket[sel] - row_start
    rr = plan.rank[sel]
    with np.errstate(over="ignore"):
        mixed = keys[sel] * _MIX1
    qlow = mixed & np.uint64((1 << (64 - plan.m1)) - 1)
    lo = labels1[sel].astype(np.uint64)
    val = (qlow << np.uint64(lb)) | lo
    slots = np.full((rows, 2 * c), EMPTY32, dtype=np.uint32)
    slots[bb, rr] = (val & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    slots[bb, c + rr] = (val >> np.uint64(32)).astype(np.uint32)
    return slots, np.zeros(0, dtype=np.uint32)


def build(
    keys: np.ndarray,
    labels1: np.ndarray,
    k: int | None = None,
    c: int | None = None,
    load: float | None = None,
) -> RadixTable:
    """Build from unique uint64 canonical keys and int32 labels(+1).

    `k` is accepted for signature parity and unused.  c/load default by DB
    size: wide 128-slot buckets (~20B/key) for real DBs, narrow 16-slot
    buckets for tiny ones (cheaper on CPU and for toy tables).
    """
    keys = np.asarray(keys, dtype=np.uint64)
    labels1 = np.asarray(labels1, dtype=np.int32)
    plan = plan_table(keys, labels1, k=k, c=c, load=load)
    slots, labels = fill_rows(keys, labels1, plan, 0, plan.n_rows)
    return RadixTable(
        slots=slots,
        labels=labels,
        stash_keys=plan.stash_keys,
        stash_labels=plan.stash_labels,
        m1=plan.m1,
        lb=plan.lb,
        slot_width=plan.c,
    )


_CACHE_VERSION = 5  # v5: u32 contiguous-halves slots (v4: load 0.69)


def db_signature(stem: str) -> np.ndarray:
    """Cheap content signature of the DB files backing a cached index:
    (.ky size, .sz size, crc32 of .ky head+tail).  Guards against a DB
    rebuilt within mtime granularity or copied with `cp -p` (which round 1's
    mtime-only check missed)."""
    import os
    import zlib

    ky, sz = stem + ".ky", stem + ".sz"
    n_ky = os.path.getsize(ky)
    n_sz = os.path.getsize(sz)
    crc = 0
    with open(ky, "rb") as f:
        crc = zlib.crc32(f.read(1 << 16), crc)
        if n_ky > (1 << 16):
            f.seek(-min(1 << 16, n_ky - (1 << 16)), os.SEEK_END)
            crc = zlib.crc32(f.read(), crc)
    return np.array([n_ky, n_sz, crc], dtype=np.int64)


def save_cache(path: str, table: RadixTable, signature: np.ndarray | None = None):
    """Persist the built table so repeat loads skip the ~1s/M-key build.
    Written atomically (tmp + rename) so concurrent processes never observe a
    truncated file."""
    import os
    import tempfile

    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                version=_CACHE_VERSION,
                slots=table.slots,
                labels=table.labels,
                stash_keys=table.stash_keys,
                stash_labels=table.stash_labels,
                meta=np.array([table.m1, table.lb, table.slot_width]),
                signature=(
                    signature
                    if signature is not None
                    else np.zeros(3, dtype=np.int64)
                ),
            )
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def load_cache(path: str, signature: np.ndarray | None = None) -> RadixTable | None:
    try:
        z = np.load(path)
        if int(z["version"]) != _CACHE_VERSION:
            return None
        if signature is not None and not np.array_equal(
            np.asarray(z["signature"]), signature
        ):
            return None
        m1, lb, c = (int(x) for x in z["meta"])
        return RadixTable(
            slots=z["slots"],
            labels=z["labels"],
            stash_keys=z["stash_keys"],
            stash_labels=z["stash_labels"],
            m1=m1,
            lb=lb,
            slot_width=c,
        )
    except Exception:  # corrupt/partial cache -> rebuild from the DB files
        return None


# --------------------------------------------------------------- dense table
#
# Two-choice dense layout for tables between 1x and ~2x the device budget
# (the JAX package's ops/radix_table.py block comment): plane 1 is filled
# to load ~0.9 (one m1 bit fewer than the standard table), and the ~0.5% of
# keys its buckets cannot hold spill into a small second plane keyed by an
# independent bijective mix (_MIX2), with its own overflow in the stash.
# Each plane keeps the quotient trick, a key lives in exactly one plane or
# the stash, so max(lab1, lab2, stash) is the unique answer.


@dataclasses.dataclass
class DenseTable:
    """Two-plane dense build result; `to_device` moves it to a device."""

    slots1: np.ndarray  # [2^m1, 2C] uint32 halves, plane 1 (load ~0.9)
    slots2: np.ndarray  # [2^m2, 2C] uint32 halves, plane 2 (plane-1 overflow)
    stash_keys: np.ndarray  # [STASH_CAP] uint64 (EMPTY padded)
    stash_labels: np.ndarray  # [STASH_CAP] int32 label+1
    m1: int
    m2: int
    lb: int
    slot_width: int

    @property
    def nbytes(self) -> int:
        return self.slots1.nbytes + self.slots2.nbytes

    @property
    def meta(self) -> dict:
        return dict(m1=self.m1, m2=self.m2, lb=self.lb, c=self.slot_width)


_MIX1_INV = np.uint64(pow(int(_MIX1), -1, 1 << 64))  # mix is odd -> invertible


def occupied_count(slots: np.ndarray, c: int) -> int:
    """Number of stored keys in a u32-halves slot array (a slot is EMPTY
    iff its hi half is all-ones -- see recover_keys)."""
    return int((slots[:, c:] != EMPTY32).sum())


def max_label1(table: RadixTable, rows_per_step: int = 1 << 20) -> int:
    """The largest label+1 a built standard table holds (slots and stash;
    0 for an empty table): the label field of each occupied slot, read a
    block of rows at a time as int32 halves (EMPTY32 reads as -1)."""
    c = table.slot_width
    top = int(table.stash_labels.max(initial=0))
    field = (1 << table.lb) - 1
    halves = torch.from_numpy(table.slots.view(np.int32))
    for r0 in range(0, len(halves), rows_per_step):
        blk = halves[r0 : r0 + rows_per_step]
        lab = torch.where(blk[:, c:] != -1, blk[:, :c] & field, 0)
        top = max(top, int(lab.max()) if lab.numel() else 0)
    return top


def recover_keys(table: RadixTable):
    """(keys, labels1) recovered exactly from a built standard table: slot =
    (qlow << lb) | label1 with qlow the low 64-m1 bits of key * _MIX1 and
    the row the top m1 bits, and the odd multiplier is invertible mod
    2^64, so a table loaded from the .idx cache seeds a dense build
    without the DB files."""
    c = table.slot_width
    lo_h, hi_h = table.slots[:, :c], table.slots[:, c:]
    # a stored slot's hi half is (val >> 32) < 2^31 (val < 2^63), so the
    # all-ones hi half identifies EMPTY exactly
    mask = hi_h != EMPTY32
    rows, _ = np.nonzero(mask)
    vals = lo_h[mask].astype(np.uint64) | (
        hi_h[mask].astype(np.uint64) << np.uint64(32)
    )
    lab = (vals & np.uint64((1 << table.lb) - 1)).astype(np.int32)
    qlow = vals >> np.uint64(table.lb)
    mixed = (rows.astype(np.uint64) << np.uint64(64 - table.m1)) | qlow
    with np.errstate(over="ignore"):
        keys = mixed * _MIX1_INV
    smask = table.stash_keys != EMPTY
    keys = np.concatenate([keys, table.stash_keys[smask]])
    lab = np.concatenate([lab, table.stash_labels[smask].astype(np.int32)])
    return keys, lab


def _fill_plane(keys, labels1, bucket, rank, m, c, lb, mult):
    """[2^m, 2c] slot plane for the keys with rank < c (quotient = low 64-m
    bits of this plane's mix)."""
    sel = rank < c
    bb = bucket[sel]
    rr = rank[sel]
    with np.errstate(over="ignore"):
        mixed = keys[sel] * mult
    qlow = mixed & np.uint64((1 << (64 - m)) - 1)
    lo = labels1[sel].astype(np.uint64)
    val = (qlow << np.uint64(lb)) | lo
    slots = np.full((1 << m, 2 * c), EMPTY32, dtype=np.uint32)
    slots[bb, rr] = (val & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    slots[bb, c + rr] = (val >> np.uint64(32)).astype(np.uint32)
    return slots


def build_dense(
    keys: np.ndarray,
    labels1: np.ndarray,
    c: int | None = None,
    load: float = 0.90,
) -> DenseTable:
    """Build the two-plane dense table (see the block comment above)."""
    keys = np.asarray(keys, dtype=np.uint64)
    labels1 = np.asarray(labels1, dtype=np.int32)
    n = max(len(keys), 1)
    if c is None:
        c = 128 if n >= 500_000 else 16
    maxlab = int(labels1.max()) if len(labels1) else 1
    lb = max(int(np.ceil(np.log2(maxlab + 2))), 2)
    m1 = max(int(np.ceil(np.log2(max(n / (load * c), 1.0)))), 1, lb + 1)
    b1, r1 = _bucket_ranks(keys, m1, _MIX1)
    slots1 = _fill_plane(keys, labels1, b1, r1, m1, c, lb, _MIX1)
    ovf = r1 >= c
    k2, l2 = keys[ovf], labels1[ovf]
    n2 = max(len(k2), 1)
    m2 = max(int(np.ceil(np.log2(max(n2 / (0.69 * c), 1.0)))), 1, lb + 1)
    while True:
        b2, r2 = _bucket_ranks(k2, m2, _MIX2)
        n_ovf2 = int((r2 >= c).sum())
        if n_ovf2 <= STASH_CAP:
            break
        m2 += 1
    slots2 = _fill_plane(k2, l2, b2, r2, m2, c, lb, _MIX2)
    sk = np.full(STASH_CAP, EMPTY, dtype=np.uint64)
    sl = np.zeros(STASH_CAP, dtype=np.int32)
    if n_ovf2:
        sel = r2 >= c
        sk[:n_ovf2] = k2[sel]
        sl[:n_ovf2] = l2[sel]
    return DenseTable(
        slots1=slots1, slots2=slots2, stash_keys=sk, stash_labels=sl,
        m1=m1, m2=m2, lb=lb, slot_width=c,
    )


def dense_nbytes(n_keys: int, n_targets: int, c: int = 128,
                 load: float = 0.90) -> int:
    """Predicted dense-table bytes without building it (plane 1 exactly;
    plane 2 from the Poisson spill at `load` with a 2x safety factor, then
    power-of-two rounding), so the residency policy decides dense or
    cycling before paying for a build."""
    import math

    n = max(n_keys, 1)
    lb = max(int(np.ceil(np.log2(n_targets + 2))), 2)
    m1 = max(int(np.ceil(np.log2(max(n / (load * c), 1.0)))), 1, lb + 1)
    # mean a = n / 2^m1 per bucket, sigma = sqrt(a);
    # E[(X - c)+] ~ sigma * (phi(z) - z * (1 - Phi(z))), z = (c - a) / sigma
    a = n / (1 << m1)
    sig = max(math.sqrt(a), 1.0)
    z = (c - a) / sig
    phi = math.exp(-z * z / 2) / math.sqrt(2 * math.pi)
    bigphi = 0.5 * (1 + math.erf(z / math.sqrt(2)))
    spill = max(sig * (phi - z * (1 - bigphi)) * (1 << m1) * 2, 1.0)
    m2 = max(int(np.ceil(np.log2(max(spill / (0.69 * c), 1.0)))), 1, lb + 1)
    return ((1 << m1) + (1 << m2)) * c * 8


_DENSE_CACHE_VERSION = 2  # v2: u32 contiguous-halves planes


def save_dense_cache(path: str, table: DenseTable,
                     signature: np.ndarray | None = None):
    """Atomic persist of a dense build (same contract as save_cache)."""
    import os
    import tempfile

    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                version=_DENSE_CACHE_VERSION,
                slots1=table.slots1,
                slots2=table.slots2,
                stash_keys=table.stash_keys,
                stash_labels=table.stash_labels,
                meta=np.array([table.m1, table.m2, table.lb,
                               table.slot_width]),
                signature=(
                    signature
                    if signature is not None
                    else np.zeros(3, dtype=np.int64)
                ),
            )
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def load_dense_cache(path: str,
                     signature: np.ndarray | None = None) -> DenseTable | None:
    try:
        z = np.load(path)
        if int(z["version"]) != _DENSE_CACHE_VERSION:
            return None
        if signature is not None and not np.array_equal(
            np.asarray(z["signature"]), signature
        ):
            return None
        m1, m2, lb, c = (int(x) for x in z["meta"])
        return DenseTable(
            slots1=z["slots1"], slots2=z["slots2"],
            stash_keys=z["stash_keys"], stash_labels=z["stash_labels"],
            m1=m1, m2=m2, lb=lb, slot_width=c,
        )
    except Exception:  # corrupt/partial cache -> rebuild
        return None


def chunk_table(table: RadixTable, n_chunks: int):
    """Split the rows into n_chunks contiguous chunks for out-of-core
    cycling (the reference's DB parts/cycles, CuClarkDB.cu:526-565): every
    key lives in exactly one chunk and the stash rides with chunk 0, so
    per-chunk hits add across cycles.  When 2^m1 is not a multiple of
    n_chunks the last chunk is padded with EMPTY rows (a copy of that
    chunk alone; the others are views of the table)."""
    c = table.slot_width
    slots = table.slots
    rows_per = -(-slots.shape[0] // n_chunks)
    chunks = []
    for i in range(n_chunks):
        part = slots[i * rows_per : (i + 1) * rows_per]
        if len(part) < rows_per:
            part = np.concatenate([part, np.full(
                (rows_per - len(part), 2 * c), EMPTY32, dtype=np.uint32)])
        chunks.append(dict(slots=part, start_row=i * rows_per,
                           use_stash=(i == 0)))
    return chunks


@dataclasses.dataclass
class DeviceTable:
    """A RadixTable's arrays as torch tensors on one device."""

    slots: torch.Tensor  # [n1, 2C] int32 bit patterns of the u32 halves
    stash_keys: torch.Tensor  # [STASH_CAP] int64 bit patterns of u64 keys
    stash_labels: torch.Tensor  # [STASH_CAP] int32 label+1
    m1: int
    lb: int
    c: int

    @property
    def nbytes(self) -> int:
        return sum(
            t.numel() * t.element_size()
            for t in (self.slots, self.stash_keys, self.stash_labels)
        )


@dataclasses.dataclass
class DeviceDenseTable:
    """A DenseTable's arrays as torch tensors on one device."""

    slots1: torch.Tensor  # [2^m1, 2C] int32 bit patterns, plane 1
    slots2: torch.Tensor  # [2^m2, 2C] int32 bit patterns, plane 2
    stash_keys: torch.Tensor  # [STASH_CAP] int64 bit patterns of u64 keys
    stash_labels: torch.Tensor  # [STASH_CAP] int32 label+1
    m1: int
    m2: int
    lb: int
    c: int

    @property
    def nbytes(self) -> int:
        return sum(
            t.numel() * t.element_size()
            for t in (self.slots1, self.slots2, self.stash_keys,
                      self.stash_labels)
        )


def _put(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(dtype)).to(device)


def put_stash(stash_keys: np.ndarray, stash_labels: np.ndarray, device):
    """(keys int64, labels int32) stash tensors on `device`."""
    return (_put(stash_keys, np.int64, device),
            _put(stash_labels.astype(np.int32), np.int32, device))


def to_device(table: RadixTable | DenseTable, device):
    """Copy a host table to `device` (a DeviceTable, or a DeviceDenseTable
    for a DenseTable), reinterpreting u32 slots as int32 and u64 stash keys
    as int64 (same bits)."""
    if hasattr(table, "slots2"):  # a DenseTable (of either package)
        return DeviceDenseTable(
            _put(table.slots1, np.int32, device),
            _put(table.slots2, np.int32, device),
            *put_stash(table.stash_keys, table.stash_labels, device),
            m1=table.m1, m2=table.m2, lb=table.lb, c=table.slot_width,
        )
    if table.lb == 0:
        raise NotImplementedError(
            "tables with a separate label array (lb == 0) are not built by "
            "this version; rebuild the .idx cache"
        )
    return DeviceTable(
        _put(table.slots, np.int32, device),
        *put_stash(table.stash_keys, table.stash_labels, device),
        m1=table.m1, lb=table.lb, c=table.slot_width,
    )


_MIX1_I64 = bits.i64(int(_MIX1))
_MIX2_I64 = bits.i64(int(_MIX2))
# queries per chunk of the plain probes: bounds their [chunk, 2C] row-gather
# temporaries (the kernels need none)
_PLAIN_CHUNK = 1 << 20


def _mix(q, mult: int, m: int):
    """(bucket, quotient) of queries q under one plane's mix: the top m
    bits and the low 64-m bits of q * mult mod 2^64."""
    mixed = q * mult  # wraps mod 2^64
    return bits.lsr(mixed, 64 - m), mixed & ((1 << (64 - m)) - 1)


def _probe_rows(slots, qlow, b, lb):
    """label+1 per query (0 = miss) from its gathered row: with
    x = slot ^ (qlow << lb) split into u32 halves, a hit is x_hi == 0 and
    x_lo < 2^lb, and the label is x_lo.  On int32 carriers x_lo < 2^lb
    would pass for a negative x_lo (bit 31 set), so the test is that no bit
    at or above lb is set."""
    rows = slots[b]  # [Q, 2C]: lo half then hi half
    c = rows.shape[1] // 2
    ql = qlow << lb
    t_lo = (ql & 0xFFFFFFFF).to(torch.int32)  # wraps to the u32 bit pattern
    t_hi = bits.lsr(ql, 32).to(torch.int32)
    x_lo = rows[:, :c] ^ t_lo[:, None]
    x_hi = rows[:, c:] ^ t_hi[:, None]
    hit = (x_hi == 0) & ((x_lo & ~((1 << lb) - 1)) == 0)
    return torch.where(hit, x_lo, 0).amax(dim=1)


def _stash_lookup(stash_keys, stash_labels, q):
    """Broadcast compare against the 64-entry stash."""
    eq = q[:, None] == stash_keys[None, :]  # [Q, STASH_CAP]
    return torch.where(eq, stash_labels[None, :], 0).amax(dim=1)


def probe_plain(slots, stash_keys, stash_labels, q, *, m1: int, lb: int):
    """Plain-PyTorch twin of kernel K2 (any device): label+1 per query,
    0 on miss, following the JAX package's probe step by step."""
    out = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
    for s in range(0, q.shape[0], _PLAIN_CHUNK):
        qq = q[s : s + _PLAIN_CHUNK]
        b, qlow = _mix(qq, _MIX1_I64, m1)
        lab = _probe_rows(slots, qlow, b, lb)
        slab = _stash_lookup(stash_keys, stash_labels, qq)
        out[s : s + _PLAIN_CHUNK] = torch.maximum(lab, slab)
    return out


def probe_chunk_plain(slots_blk, stash_keys, stash_labels, q, start_row: int,
                      *, m1: int, lb: int, use_stash: bool):
    """Plain-PyTorch twin of kernel K7 (any device), following the JAX
    package's probe_chunk: label+1 per query whose bucket lies in the chunk
    [start_row, start_row + rows_per) of a 2^m1-row table, 0 elsewhere;
    the stash counts only where use_stash is set."""
    rows_per = slots_blk.shape[0]
    out = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
    for s in range(0, q.shape[0], _PLAIN_CHUNK):
        qq = q[s : s + _PLAIN_CHUNK]
        b, qlow = _mix(qq, _MIX1_I64, m1)
        lrow = b - start_row  # b < 2^63: signed arithmetic is exact
        inrange = (lrow >= 0) & (lrow < rows_per)
        lab = _probe_rows(slots_blk, qlow, lrow.clamp(0, rows_per - 1), lb)
        lab = torch.where(inrange, lab, 0)
        if use_stash:
            lab = torch.maximum(lab, _stash_lookup(stash_keys, stash_labels, qq))
        out[s : s + _PLAIN_CHUNK] = lab
    return out


def probe_dense_plain(slots1, slots2, stash_keys, stash_labels, q, *,
                      m1: int, m2: int, lb: int):
    """Plain-PyTorch twin of kernel K8 (any device), following the JAX
    package's probe_dense: max of the plane-1 probe (_MIX1, m1), the plane-2
    probe (_MIX2, m2) and the stash."""
    out = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
    for s in range(0, q.shape[0], _PLAIN_CHUNK):
        qq = q[s : s + _PLAIN_CHUNK]
        b1, qlow1 = _mix(qq, _MIX1_I64, m1)
        b2, qlow2 = _mix(qq, _MIX2_I64, m2)
        lab = torch.maximum(_probe_rows(slots1, qlow1, b1, lb),
                            _probe_rows(slots2, qlow2, b2, lb))
        slab = _stash_lookup(stash_keys, stash_labels, qq)
        out[s : s + _PLAIN_CHUNK] = torch.maximum(lab, slab)
    return out


def probe(table: DeviceTable, q: torch.Tensor) -> torch.Tensor:
    """label+1 per query q [Q] int64 (0 = miss): kernel K2 for CUDA tensors,
    the plain twin for CPU tensors."""
    if q.device.type == "cuda":
        from . import kernels

        return kernels.probe(
            table.slots, table.stash_keys, table.stash_labels, q,
            table.m1, table.lb,
        )
    _check_cpu(q)
    return probe_plain(
        table.slots, table.stash_keys, table.stash_labels, q,
        m1=table.m1, lb=table.lb,
    )


def _check_cpu(q: torch.Tensor):
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")


def probe_chunk(slots_blk, stash_keys, stash_labels, q, start_row: int, *,
                m1: int, lb: int, use_stash: bool) -> torch.Tensor:
    """label+1 per query q [Q] int64 against one row chunk slots_blk
    [rows_per, 2C] int32 (rows start_row.. of a 2^m1-row table); queries
    bucketed outside the chunk miss (0) and the stash counts only where
    use_stash is set.  Kernel K7 for CUDA tensors, the plain twin for CPU
    tensors."""
    if q.device.type == "cuda":
        from . import kernels

        return kernels.probe_chunk(slots_blk, stash_keys, stash_labels, q,
                                   start_row, m1, lb, use_stash)
    _check_cpu(q)
    return probe_chunk_plain(slots_blk, stash_keys, stash_labels, q,
                             start_row, m1=m1, lb=lb, use_stash=use_stash)


def probe_dense(table: DeviceDenseTable, q: torch.Tensor) -> torch.Tensor:
    """label+1 per query q [Q] int64 (0 = miss) against the two-plane dense
    table: kernel K8 for CUDA tensors, the plain twin for CPU tensors."""
    if q.device.type == "cuda":
        from . import kernels

        return kernels.probe_dense(
            table.slots1, table.slots2, table.stash_keys, table.stash_labels,
            q, table.m1, table.m2, table.lb,
        )
    _check_cpu(q)
    return probe_dense_plain(
        table.slots1, table.slots2, table.stash_keys, table.stash_labels, q,
        m1=table.m1, m2=table.m2, lb=table.lb,
    )
