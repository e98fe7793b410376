"""K6's level plan: the host side of the DB-build aggregate's bucket sort.

The aggregate (db/device_build.py) turns canonical k-mer occurrences in
stream order into one row per distinct canonical, ascending.  None of a
row's fields depends on the order inside a group once the group's smallest
stream index is known, so keys need ordering only between groups, and a
bucket sort whose buckets each fit one warp's registers is enough:

  range    the keys' min and max (read back: the level-1 digit)
  hist     per bucket of the level's digit: count, min and max key
  scan     bucket starts (exclusive scan of the counts, on the device)
  scatter  each occurrence to its bucket as a 16-B entry
           (key, seq << 32 | label), order inside a bucket free
  plan     the counts read back (and the min and max of the buckets
           over `cap`); a bucket is then empty, small (at most `cap`
           entries: one warp sorts it and writes its groups' rows), single
           (over `cap`, one key: a grid-wide reduction) or split (over
           `cap`, several keys: the same steps again on its own key range,
           one level down)
  compact  the rows gathered in place order (which is key order) by a
           scan of the row flags, one a place

The digit of a level is the `nbits` bits just below the common prefix of
its range's min and max, so keys of any k (9-32, bit 63 included) and any
skew need no hint.  A range whose buckets need more than MAX_BITS bits
splits them evenly over as many levels as that takes: a level of few
buckets scatters in long runs, where 2^13 buckets would leave one 16-B
store per bucket and block.  Each level scatters within its range's own positions,
alternating between two entry buffers, so the leaves, ordered by start,
and their places, are in key order.  A leaf writes its rows at its own
start: (canon, first << 32 | L0) in the buffer that held its entries and
(count, mult) in the other, whose places there are dead by then, and
flags each of its places: 1 + that buffer where a row is staged, 0
elsewhere.

`run_levels` drives the steps through an object with one method per step
(hist, scan and scatter of a level's ranges are one, `partition`):
the CUDA wrapper (ops/kernels.aggregate) and the plain-PyTorch twin
(db/device_build.aggregate_bucketed_plain) run the same plan.
"""

from __future__ import annotations

import numpy as np
import torch

CAP = 256  # entries one warp sorts in registers (8 a lane)
IDX_BITS = 8  # an entry's place in its bucket, below its key in the sort
KEY_BITS = 64 - IDX_BITS  # the most a bucket's keys may differ in
MAX_BITS = 13  # a level's digit: 8,192 buckets (their histogram: 160 KB)
MIN_SORT = 64  # the smallest sort length of the bucket pass (2 a lane)


def digit_plan(lo: int, hi: int, count: int, cap: int) -> tuple[int, int]:
    """(shift, nbits) of the digit of a range of `count` keys in [lo, hi]
    (u64): the bits just below the common prefix of lo and hi.  The range
    needs B bits to put about cap/2 keys in a bucket; over MAX_BITS, the
    levels split B evenly.  At least as many bits as leave KEY_BITS below
    the digit (a bucket's keys then differ from its min in their low
    KEY_BITS bits, which the bucket pass packs with an entry's place into
    one u64), at most the differing bits.  One key (lo == hi) gives (0,
    0): a single bucket."""
    top = (lo ^ hi).bit_length()
    if top == 0:
        return 0, 0
    # ceil(log2(count / target)) = bit length of ceil(count / target) - 1
    need = max((-(-count // max(cap // 2, 1)) - 1).bit_length(), 1)
    levels = -(-need // MAX_BITS)
    nbits = min(max(-(-need // levels), top - KEY_BITS), top)
    return top - nbits, nbits


def sort_lens(counts: np.ndarray, cap: int) -> list[int]:
    """The bucket pass's sort lengths that buckets of `counts` (1..cap
    entries each) need: S takes the buckets of S/2 + 1 to S entries (of 1
    to MIN_SORT for S = MIN_SORT), S a power of two from MIN_SORT to the
    one at or above cap."""
    lens, S = [], MIN_SORT
    while True:
        lo = 0 if S == MIN_SORT else S // 2
        if np.any((counts > lo) & (counts <= S)):
            lens.append(S)
        if S >= cap:
            return lens
        S *= 2


def capacity(n: int) -> int:
    """Entries of the scratch buffers for n occurrences: a power of two, so
    that partitions of one build reuse the caching allocator's blocks."""
    return 1 << max(int(n - 1).bit_length(), 10)


def read_plan(plan: torch.Tensor, cap: int):
    """A level's plan [3, NB] (counts, min keys, max keys) on the host:
    (counts, over, mins, maxs), the min and max keys (u64) read back only
    for the buckets `over` cap entries, which split or, of one key, reduce;
    the others are empty or small."""
    counts = plan[0].cpu().numpy()
    over = np.flatnonzero(counts > cap)
    if not len(over):
        return counts, over, over.astype(np.uint64), over.astype(np.uint64)
    mm = plan[1:, torch.from_numpy(over).to(plan.device)].cpu().numpy()
    mins, maxs = mm.view(np.uint64)
    return counts, over, mins, maxs


def level_table(ranges, cap: int) -> np.ndarray:
    """A level's ranges [(start, count, min, max)] -> [R, 5] int64 rows
    (start, count, shift, nbits, offset of the range's first bucket in the
    level's bucket arrays)."""
    rows, boff = [], 0
    for s, c, lo, hi in ranges:
        shift, nbits = digit_plan(lo, hi, c, cap)
        rows.append((s, c, shift, nbits, boff))
        boff += 1 << nbits
    return np.array(rows, np.int64).reshape(-1, 5)


def block_table(table: np.ndarray, n_blocks: int) -> np.ndarray:
    """[G, 3] int64 rows (range, first position, end) of a level's hist and
    scatter blocks: chunks of one size, about n_blocks in all (at least
    4,096 entries, a multiple of 32), none across two ranges.  A block
    counts its chunk in shared memory before one global atomic per bucket,
    so a chunk is many times the level's buckets."""
    s, c = table[:, 0], table[:, 1]
    chunk = max(-(-int(c.sum()) // max(n_blocks, 1)), 4096)
    chunk = -(-chunk // 32) * 32
    nblk = -(-c // chunk)
    rid = np.repeat(np.arange(len(table)), nblk)
    j = np.arange(len(rid)) - np.repeat(np.cumsum(nblk) - nblk, nblk)
    b0 = s[rid] + j * chunk
    return np.stack([rid, b0, np.minimum(b0 + chunk, s[rid] + c[rid])], 1)


def run_levels(steps, n: int, cap: int):
    """Drive the bucket sort over n occurrences; returns steps.compact's
    rows.  `steps` (the CUDA launches or their torch twins) holds the
    inputs, the two entry buffers and a row flag per place; its `stats`
    records the plan's branches (levels, ranges, split, single and small
    leaves).  A level partitions all of its ranges at once
    (steps.partition: hist, scan, scatter) and reads its plan back once."""
    lo, hi = steps.range()
    ranges = [(0, n, lo, hi)]
    src, depth = -1, 0  # the level's source buffer: -1 for the inputs
    stats = steps.stats
    while ranges:
        dst = depth % 2
        table = level_table(ranges, cap)
        plan, starts = steps.partition(src, dst, table)
        counts, over, mins, maxs = read_plan(plan, cap)
        small = counts[(counts > 0) & (counts <= cap)]
        for S in sort_lens(small, cap):
            steps.bucket_pass(dst, plan, starts, S)
        # the starts of the buckets over cap: their range's start plus the
        # counts of the range's buckets before them
        cum = np.cumsum(counts) - counts
        r = np.searchsorted(table[:, 4], over, side="right") - 1
        ostart = table[r, 0] + cum[over] - cum[table[r, 4]]
        one = mins == maxs
        if one.any():
            steps.single(dst, ostart[one], counts[over[one]])
        split = np.flatnonzero(~one)
        ranges = [(int(ostart[i]), int(counts[over[i]]), int(mins[i]),
                   int(maxs[i])) for i in split]
        stats["levels"] += 1
        stats["ranges"] += len(table)
        stats["small"] += len(small)
        stats["single"] += int(one.sum())
        stats["split"] += len(split)
        src, depth = dst, depth + 1
    return steps.compact()


def new_stats() -> dict:
    return dict(levels=0, ranges=0, small=0, single=0, split=0)
