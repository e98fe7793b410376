"""Device-side k-mer lookup of the flat path: sorted-array exact match.

The port of the JAX package's ops/lookup.py.  The index is the DB's
canonical k-mer values sorted ascending (as u64) with a parallel array of
their labels + 1 (0 = miss/NA, the reference's "NA at index 0",
CuClarkDB.cu:1390); a query is a search of the sorted keys.

The port keeps the index with its radix directory, a `FlatIndex`
(`build_index`, made once when the index is loaded): the key range
[kmin, kmax] cut into 2^bits buckets of 2^shift values, and for each
bucket the index of its first key.  A query finds its bucket with one
subtraction and one shift, then searches only that bucket's keys (4-8
on average, 11.4 at config 2's 48M keys, where the 2^22 cap binds): its
loads fall in the bucket's one or two 128-B lines, where a binary search
of 48M keys makes 26 loads across the array.  On a CUDA tensor
`lookup_labels` launches kernel K9 (ops/kernels/classify.cu); on a CPU
tensor it runs the plain twin that follows the kernel's steps,
`lookup_labels_dir_plain`.  `lookup_labels_plain`, a searchsorted of the
whole index, is the second twin the checks hold both against.  u64 values
ride int64 carriers, as everywhere in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from typing import NamedTuple

from .bits import _SIGN, EMPTY, i64, lsr, ult

PAD_QUERY = np.uint64(0xFFFFFFFFFFFFFFFF)  # padding sentinel; never a k-mer
# below k = 32, and a miss at any k (the hit test excludes it)


def prepare_index(canonical: np.ndarray, labels: np.ndarray):
    """(keys [N] u64 ascending, labels1 [N] int32 = label + 1): the host
    index, sorted by a stable argsort."""
    canonical = np.asarray(canonical, dtype=np.uint64)
    order = np.argsort(canonical, kind="stable")
    return canonical[order], np.asarray(labels)[order].astype(np.int32) + 1


def pad_index(keys: np.ndarray, labels1: np.ndarray, multiple: int):
    """Pad to a multiple of `multiple` (even mesh shards) with PAD_QUERY
    keys and 0 labels."""
    m = (-len(keys)) % multiple
    if m:
        keys = np.concatenate([keys, np.full(m, PAD_QUERY, dtype=np.uint64)])
        labels1 = np.concatenate([labels1, np.zeros(m, dtype=np.int32)])
    return keys, labels1


DIR_MAX_BITS = 22  # at most 2^22 + 1 int32 offsets: 16 MiB, held in L2
_U64_MASK = (1 << 64) - 1


class FlatIndex(NamedTuple):
    """A sorted key array on one device with its labels and radix
    directory (u64 values as Python ints): bucket j holds the keys in
    [kmin + j * 2^shift, kmin + (j + 1) * 2^shift), and keys[offsets[j] :
    offsets[j + 1]] are its keys.  The pad keys PAD_QUERY at a mesh
    block's tail lie past offsets[-1]; an index of no other key has
    kmin > kmax, and every query misses."""

    keys: torch.Tensor  # [N] int64, u64 bits ascending as u64
    labels1: torch.Tensor  # [N] int32, label + 1
    offsets: torch.Tensor  # [2^bits + 1] int32
    kmin: int  # the first key
    kmax: int  # the last key below PAD_QUERY
    shift: int  # 0-64: a bucket spans 2^shift values

    @property
    def bits(self) -> int:
        """0-DIR_MAX_BITS: the index has 2^bits buckets."""
        return (self.offsets.shape[0] - 1).bit_length() - 1


def build_index(keys: torch.Tensor, labels1: torch.Tensor) -> FlatIndex:
    """The FlatIndex of keys [N] int64 (u64 bits, ascending as u64, any
    PAD_QUERY keys last) and labels1 [N] int32, its directory built with
    torch ops on the keys' device: 2^bits buckets, bits = clamp(ceil(log2
    n) - 3, 0, DIR_MAX_BITS) for the n keys below PAD_QUERY (4-8 keys a
    bucket on average, more where the cap binds: 11.4 at 48M keys), and
    the least shift that fits kmax - kmin into them."""
    n = keys.shape[0] - int((keys == EMPTY).sum())
    if n == 0:
        return FlatIndex(keys, labels1, torch.zeros(
            2, dtype=torch.int32, device=keys.device), kmin=1, kmax=0,
            shift=0)
    kmin = int(keys[0]) & _U64_MASK
    kmax = int(keys[n - 1]) & _U64_MASK
    bits = min(max((n - 1).bit_length() - 3, 0), DIR_MAX_BITS)
    shift = max((kmax - kmin).bit_length() - bits, 0)
    offsets = torch.zeros((1 << bits) + 1, dtype=torch.int32,
                          device=keys.device)
    offsets[1:] = torch.bincount(bucket_index(keys[:n], kmin, shift),
                                 minlength=1 << bits).cumsum(0)
    return FlatIndex(keys, labels1, offsets, kmin, kmax, shift)


def bucket_index(x: torch.Tensor, kmin: int, shift: int) -> torch.Tensor:
    """The directory bucket of each x >= kmin: (x - kmin) >> shift in u64
    arithmetic on int64 carriers (0 for a shift of 64)."""
    if shift >= 64:
        return torch.zeros_like(x)
    return lsr(x - i64(kmin), shift)


def lookup_labels(index: FlatIndex, q: torch.Tensor) -> torch.Tensor:
    """For each query q [Q] int64 (u64 bits) the label + 1 of the first
    key equal to it in the index, or 0 on a miss; PAD_QUERY always
    misses.  Returns [Q] int32: K9 on a CUDA device, its twin
    lookup_labels_dir_plain on the CPU."""
    if q.device.type == "cuda":
        from . import kernels

        return kernels.lookup(index, q)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return lookup_labels_dir_plain(index, q)


def lookup_labels_dir_plain(index: FlatIndex, q: torch.Tensor
                            ) -> torch.Tensor:
    """Plain-PyTorch twin of kernel K9 that takes its steps (any device):
    a query outside [kmin, kmax] or equal to PAD_QUERY misses; else its
    bucket j = (q - kmin) >> shift, then a lower-bound binary search of
    keys[offsets[j] : offsets[j + 1]], a hit where the key there equals q.
    Unsigned compares on the carriers (bits.ult)."""
    keys, n = index.keys, index.keys.shape[0]
    if n == 0 or index.kmin > index.kmax:
        return torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    kmin = torch.tensor(i64(index.kmin), device=q.device)
    kmax = torch.tensor(i64(index.kmax), device=q.device)
    inr = (q != EMPTY) & ~ult(q, kmin) & ~ult(kmax, q)
    j = torch.where(inr, bucket_index(q, index.kmin, index.shift), 0)
    offsets = index.offsets.long()
    lo, end = offsets[j], offsets[j + 1]
    hi = end.clone()
    while True:
        step = lo < hi
        if not step.any():
            break
        mid = lo + ((hi - lo) >> 1)
        less = ult(keys[mid.clamp(max=n - 1)], q)
        lo = torch.where(step & less, mid + 1, lo)
        hi = torch.where(step & ~less, mid, hi)
    pc = lo.clamp(max=n - 1)
    hit = inr & (lo < end) & (keys[pc] == q)
    return torch.where(hit, index.labels1[pc], 0).to(torch.int32)


def lookup_labels_plain(keys: torch.Tensor, labels1: torch.Tensor,
                        q: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch twin of kernel K9 (any device).  torch has no unsigned
    searchsorted, so both sides are searched as int64 with bit 63 flipped,
    which orders them as u64: keys with bit 63 set (k = 32) and PAD_QUERY
    (-1 on the carrier) sort last, as they do unsigned."""
    n = keys.shape[0]
    if n == 0:
        return torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    idx = torch.searchsorted(keys ^ _SIGN, q ^ _SIGN).clamp_(max=n - 1)
    hit = (keys[idx] == q) & (q != EMPTY)
    return torch.where(hit, labels1[idx], 0).to(torch.int32)
