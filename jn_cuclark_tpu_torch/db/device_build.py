"""DB-build aggregate on a torch device (`db build --device`).

The build's hot loop groups the canonical k-mer occurrences and applies the
multiplicity rules: a device-wide stable sort plus a segmented pass.  On a
CUDA device the sort is torch.sort and the segmented pass is the
hand-written kernel K6 (ops/kernels/aggregate.cu); on the CPU the whole
step runs as its plain-PyTorch twin `aggregate_device_plain`, which follows
the JAX package's `_aggregate_device` (jn_cuclark_tpu/db/device_build.py).

u64 keys ride as int64 bit patterns, which torch.sort orders as signed: a
key with bit 63 set (possible at k = 32) would sort first.  Both paths sort
`canonical ^ 2^63`, whose signed order is the canonicals' unsigned order,
and flip the bit back on output.  Nothing here falls back to the host
aggregate: a failure raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bits

SIGN = bits.i64(1 << 63)  # int64 bit pattern of 2^63


def _aggregate_device(canon: torch.Tensor, label: torch.Tensor,
                      pg: torch.Tensor, lelement: bool):
    """Tensor form of the aggregate on the device of `canon`: canon [n]
    int64 (u64 bit patterns, stream order), label [n] int32, pg [L] int32
    -> (canon [G] int64 bits ascending as u64, L0 [G] int32, mult [G]
    int32, count [G] int64, first_seq [G] int64)."""
    if canon.device.type == "cuda":
        from ..ops import kernels

        keys, seq = torch.sort(canon ^ SIGN, stable=True)
        return kernels.aggregate(keys, seq, label, pg, lelement)
    if canon.device.type != "cpu":
        raise ValueError(f"unsupported device {canon.device}")
    return aggregate_device_plain(canon, label, pg, lelement)


def aggregate_device_plain(canon: torch.Tensor, label: torch.Tensor,
                           pg: torch.Tensor, lelement: bool):
    """Plain-PyTorch twin of the sort + kernel K6 (any device): the JAX
    package's _aggregate_device, then the compaction to one row per group
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
