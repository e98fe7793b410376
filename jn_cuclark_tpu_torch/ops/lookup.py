"""Device-side k-mer lookup of the flat path: sorted-array exact match.

The port of the JAX package's ops/lookup.py.  The index is the DB's
canonical k-mer values sorted ascending (as u64) with a parallel array of
their labels + 1 (0 = miss/NA, the reference's "NA at index 0",
CuClarkDB.cu:1390); a query is a binary search.  On a CUDA tensor
`lookup_labels` launches kernel K9 (ops/kernels/classify.cu); on a CPU
tensor it runs the plain twin `lookup_labels_plain`.  u64 values ride
int64 carriers, as everywhere in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from .bits import _SIGN, EMPTY

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


def lookup_labels(keys: torch.Tensor, labels1: torch.Tensor,
                  q: torch.Tensor) -> torch.Tensor:
    """For each query q [Q] int64 (u64 bits) the label + 1 of the equal key
    of keys [N] int64 (u64 bits, ascending as u64), labels1 [N] int32, or 0
    on a miss; PAD_QUERY always misses.  Returns [Q] int32."""
    if q.device.type == "cuda":
        from . import kernels

        return kernels.lookup(keys, labels1, q)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return lookup_labels_plain(keys, labels1, q)


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
