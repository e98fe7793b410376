"""Per-read scoring: per-window labels -> (sum, best, second-best) with exact
reference tie-breaking.

Replaces the reference's mergeKernel/resultKernel (CuClarkDB.cu:1261-1411).
The resultKernel scans sparse (target, count) pairs in ascending-target order
with strict '>' updates, which makes (best, second best) exactly the top-2
under the ordering (count desc, target index asc).  `indexBest` is the target
index + 1 so 0 means "NA" (CuClarkDB.cu:1390).

Four forms, each a CUDA kernel (ops/kernels/classify.cu) on CUDA tensors
and its plain twin on CPU tensors:

  top2_from_labels  K3  per-window labels -> the five top-2 scalars
  sort_top2         K4  the same, plus each read's labels sorted ascending
                        as a u16 grid (extended output below 65,535
                        targets: the native formatter expands its runs)
  counts_top2       K5  dense per-read counts [R, T+1] and the top-2 over
                        them (extended output at 65,535 targets);
                        twins counts_from_hits_plain + read_results_plain
  counts_flat       K5's flat form: the same over flat per-query labels
                        and read ids (the flat path, engine._query_single);
                        the same twins
"""

from __future__ import annotations

import torch


def top2_from_labels(lab: torch.Tensor, n_targets: int | None = None):
    """(total, index_best, best, index_sbest, s_best), each [R] int32, from
    per-window (label+1) values lab [R, W] int32 (0 = miss/padding).
    n_targets = T promises labels in [0, T] and lets K3 take its small
    form (kernels.top2_form), which skips any label above T; None takes
    any label."""
    from . import kernels

    if lab.device.type == "cuda":
        return kernels.top2(lab, n_targets)
    _check_device(lab)
    if n_targets is not None:
        kernels.check_targets(n_targets)
    return top2_from_labels_plain(lab)


def _check_device(t: torch.Tensor):
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")


def sort_top2(lab: torch.Tensor):
    """(sorted, total, index_best, best, index_sbest, s_best): sorted is
    each read's labels ascending (zeros first) as an int16 grid [R, W]
    carrying u16 bit patterns; labels must be below 65,536.  The scalars
    are top2_from_labels'."""
    if lab.device.type == "cuda":
        from . import kernels

        return kernels.sort_top2(lab)
    _check_device(lab)
    return sort_top2_plain(lab)


def sort_top2_plain(lab: torch.Tensor):
    """Plain-PyTorch twin of kernel K4: the JAX package's "sorted" form
    (lax.sort along the window axis, then top2_from_sorted)."""
    s = torch.sort(lab, dim=1).values
    return (u16_bits(s),) + top2_from_sorted(s)


def u16_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 values in [0, 65536) -> int16 tensor of their u16 bit
    patterns (torch has few uint16 ops; the host views it as uint16)."""
    return torch.where(x >= 32768, x - 65536, x).to(torch.int16)


def counts_top2(lab: torch.Tensor, n_targets: int,
                prior: torch.Tensor | None = None):
    """(counts, total, index_best, best, index_sbest, s_best): counts
    [R, n_targets+1] int32 of each read's per-window label+1 values
    (column 0 collects misses), added to `prior` [R, n_targets+1] int32
    where one is given (K5's small form alone takes it), then read_results
    over it."""
    from . import kernels

    if lab.device.type == "cuda":
        return kernels.counts_top2(lab, n_targets, prior)
    _check_device(lab)
    R, W = lab.shape
    kernels.check_prior(prior, R, n_targets, W)
    rid = torch.arange(R, dtype=torch.int64, device=lab.device)
    counts = counts_from_hits_plain(
        lab.reshape(-1), rid.repeat_interleave(W), R, n_targets
    )
    if prior is not None:
        counts = counts + prior
    return (counts,) + read_results_plain(counts)


def counts_flat(labels1: torch.Tensor, read_id: torch.Tensor, n_reads: int,
                n_targets: int):
    """counts_top2 over flat per-query labels1 [Q] int32 (label+1 in
    [0, T]; 0 = miss) and their read ids [Q] int32 in [0, n_reads): the
    flat path's scoring (K5's flat form on a CUDA tensor)."""
    if labels1.device.type == "cuda":
        from . import kernels

        return kernels.counts_flat(labels1, read_id, n_reads, n_targets)
    _check_device(labels1)
    counts = counts_from_hits_plain(labels1, read_id, n_reads, n_targets)
    return (counts,) + read_results_plain(counts)


def counts_from_hits_plain(labels1: torch.Tensor, read_id: torch.Tensor,
                           n_reads: int, n_targets: int) -> torch.Tensor:
    """Dense per-read count matrix [n_reads, n_targets+1] int32 from
    per-query (label+1) values (0 = miss, accumulated in column 0): the
    JAX package's counts_from_hits as one bincount."""
    ids = read_id.to(torch.int64) * (n_targets + 1) + labels1.to(torch.int64)
    flat = torch.bincount(ids, minlength=n_reads * (n_targets + 1))
    return flat.to(torch.int32).reshape(n_reads, n_targets + 1)


def read_results_plain(counts: torch.Tensor):
    """counts[:, 1:] -> (total, index_best, best, index_sbest, s_best),
    each [R] int32.  Ties on count resolve to the LOWEST target index
    (torch.argmax returns the first maximum); index 0 means NA."""
    t = counts[:, 1:]
    total = t.sum(dim=1, dtype=torch.int32)
    tidx = torch.arange(t.shape[1], device=t.device)
    best = t.amax(dim=1)
    ibest = t.argmax(dim=1)
    masked = torch.where(tidx[None, :] == ibest[:, None], -1, t)
    sbest = masked.amax(dim=1)
    isbest = masked.argmax(dim=1)
    sbest = torch.clamp(sbest, min=0)
    zero = torch.zeros_like(ibest)
    index_best = torch.where(best > 0, ibest + 1, zero).to(torch.int32)
    index_sbest = torch.where(sbest > 0, isbest + 1, zero).to(torch.int32)
    return (total, index_best, best.to(torch.int32), index_sbest,
            sbest.to(torch.int32))


def top2_from_labels_plain(lab: torch.Tensor):
    """Plain-PyTorch twin of kernel K3 (any device): sort each read's labels,
    then score runs as the JAX package's top2_from_sorted does."""
    return top2_from_sorted(torch.sort(lab, dim=1).values)


def top2_from_sorted(s: torch.Tensor):
    """top2_from_labels on an already-sorted [R, W] int32 label grid: run
    lengths from cummax/cummin arithmetic, then count desc / label asc."""
    R, S = s.shape
    j = torch.arange(S, dtype=torch.int32, device=s.device)[None, :]
    diff = s[:, 1:] != s[:, :-1]
    ones = torch.ones((R, 1), dtype=torch.bool, device=s.device)
    is_start = torch.cat([ones, diff], dim=1)
    is_end = torch.cat([diff, ones], dim=1)
    minus1 = torch.full_like(j, -1)
    startpos = torch.cummax(torch.where(is_start, j, minus1), dim=1).values
    # torch has no reverse cummin: run it over the flipped rows
    endpos = torch.where(is_end, j, torch.full_like(j, S))
    endpos = torch.cummin(endpos.flip(1), dim=1).values.flip(1)
    runlen = endpos - startpos + 1
    # score each run once (at its start); label 0 is miss/padding
    zero = torch.zeros_like(runlen)
    runlen = torch.where(is_start & (s > 0), runlen, zero)

    total = (s > 0).sum(dim=1, dtype=torch.int32)
    big = torch.full_like(s, 2**31 - 1)
    best = runlen.amax(dim=1)
    ibest1 = torch.where(runlen == best[:, None], s, big).amin(dim=1)
    ibest1 = torch.where(best > 0, ibest1, 0)
    masked = torch.where(s == ibest1[:, None], zero, runlen)
    sbest = masked.amax(dim=1)
    isbest1 = torch.where(
        (masked == sbest[:, None]) & (masked > 0), s, big
    ).amin(dim=1)
    isbest1 = torch.where(sbest > 0, isbest1, 0)
    return total, ibest1, best, isbest1, sbest
