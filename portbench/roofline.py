"""The least work a pass over the sample needs, and the chips' peaks.

A pass's floor bytes are counted from the inputs alone, so they are the
same for every implementation of the classification, however it batches
or fuses its kernels:

  - the reads' bases, at 2 bits a base;
  - each read's result, written once: total, best target, best and second
    best count, 4 bytes each;
  - the database, read at most once: the smaller of its discriminative keys
    and labels (8 + 2 bytes a key) and one 32-byte sector for each distinct
    canonical k-mer the pass looks up.

The least time is the floor bytes over the chip's memory bandwidth; no
operation count bounds this work (a probe is a compare or two a window).
"""

from __future__ import annotations

# published peaks (NVIDIA H100 SXM data sheet, at its 700 W limit)
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bytes_per_s=3.35e12),
}
RESULT_BYTES = 16  # total, best target, best, second best: int32 each
KEY_BYTES = 10  # a u64 canonical key and its u16 label
SECTOR_BYTES = 32


def floor_bytes(bases: int, reads: int, keys: int, queried: int) -> int:
    """Floor bytes of one pass (see the module's docstring)."""
    return (bases // 4 + RESULT_BYTES * reads
            + min(KEY_BYTES * keys, SECTOR_BYTES * queried))


def share_pct(floor: float, seconds: float, kind: str) -> float | None:
    """Floor bytes over `kind`'s bandwidth, as a share of `seconds` in
    percent; None for a chip with no entry or no time."""
    peak = PEAKS.get(kind)
    if peak is None or seconds <= 0:
        return None
    return 100.0 * floor / peak["bytes_per_s"] / seconds
