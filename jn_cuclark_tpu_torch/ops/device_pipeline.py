"""Device classification step.

windows-from-packed-words + Jellyfish canonicalization (K1) -> radix-table
probe (K2; K8 against the dense two-plane table, K7 against one row chunk
when the table is streamed in cycles) -> per-read scoring (K3 top-2;
extended output: K4 sorted label grid + top-2, or K5 dense counts + top-2),
reproducing exactly the k-mer set the reference counts (all length-k
windows of valid chars within a read, CuClarkDB.cu:1042-1117).  On CUDA tensors each step is a hand-written
kernel (ops/kernels/classify.cu); on CPU tensors each runs its plain-PyTorch
twin.  The glue between them (the miss mask, reshapes) is plain torch.
"""

from __future__ import annotations

import torch

from . import bits, radix_table, score

_M3 = bits.i64(0x3333333333333333)
_M0F = bits.i64(0x0F0F0F0F0F0F0F0F)
_M00FF = bits.i64(0x00FF00FF00FF00FF)
_M16 = bits.i64(0x0000FFFF0000FFFF)


def n_windows(stride: int, k: int, probe_cols: int | None) -> int:
    """Probed windows per row: W = min(probe_cols, S-k+1), at least 1.

    Only the first S-k+1 columns can ever be valid (a window starting in the
    last k-1 positions runs off the row), and the caller may trim further
    with `probe_cols` when it knows the batch's longest read: trimmed
    columns fail the validity mask by construction."""
    w = max(stride - (k - 1), 1)
    if probe_cols is not None:
        w = max(min(w, probe_cols), 1)
    return w


def window_canonicals(words, vwords, k: int, probe_cols: int | None = None):
    """q [R, W] int64: the canonical value of each window of packed rows
    (words [R, S/32+1], vwords [R, S/64+1], int64 bit patterns of the u64
    words of ops/pack.py), EMPTY where the window is invalid.  Kernel K1 on
    CUDA tensors, the plain twin on CPU tensors."""
    w = n_windows((words.shape[1] - 1) * 32, k, probe_cols)
    if words.device.type == "cuda":
        from . import kernels

        return kernels.window_canonicals(words, vwords, k, w)
    if words.device.type != "cpu":
        raise ValueError(f"unsupported device {words.device}")
    return window_canonicals_plain(words, vwords, k, probe_cols)


def window_canonicals_plain(words, vwords, k: int, probe_cols: int | None = None):
    """Plain-PyTorch twin of kernel K1 (any device), following the JAX
    package's window_canonicals on int64 carriers: every right shift is a
    logical one (bits.lsr), and the funnel shift's `<< (64 - off)` is
    masked out where off == 0."""
    R, nw = words.shape
    S = (nw - 1) * 32
    W = nw - 1
    w0 = torch.repeat_interleave(words[:, :W], 32, dim=1)  # word holding char p
    w1 = torch.repeat_interleave(words[:, 1:], 32, dim=1)  # next word
    off = ((torch.arange(S, device=words.device) & 31) * 2)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=words.device)
    lo = bits.lsr(w0, off)
    hi = torch.where(off == 0, zero, w1 << (64 - off))
    val = lo | hi
    if k < 32:
        val = val & ((1 << (2 * k)) - 1)

    Wv = vwords.shape[1] - 1
    v0 = torch.repeat_interleave(vwords[:, :Wv], 64, dim=1)
    v1 = torch.repeat_interleave(vwords[:, 1:], 64, dim=1)
    voff = (torch.arange(S, device=words.device) & 63)[None, :]
    vbits = bits.lsr(v0, voff) | torch.where(voff == 0, zero, v1 << (64 - voff))
    kmask = (1 << k) - 1
    valid = (vbits & kmask) == kmask

    canon = bits.umin(val, _revcomp(val, k))
    q = torch.where(valid, canon, torch.full_like(canon, bits.EMPTY))
    return q[:, : n_windows(S, k, probe_cols)].contiguous()


def _revcomp(v, k: int):
    """Jellyfish bit-twiddle (kmersConversion.cc:39-47) on int64 carriers;
    the masks clear the sign-filled bits of the small shifts."""
    x = v
    x = ((x >> 2) & _M3) | ((x & _M3) << 2)
    x = ((x >> 4) & _M0F) | ((x & _M0F) << 4)
    x = ((x >> 8) & _M00FF) | ((x & _M00FF) << 8)
    x = ((x >> 16) & _M16) | ((x & _M16) << 16)
    x = bits.lsr(x, 32) | (x << 32)
    return bits.lsr(~x, 64 - 2 * k)


def score_from_labels(lab, *, n_targets: int, extended=False):
    """Per-read scoring of per-window labels lab [R, W] int32 (label+1,
    0 = miss): (total, ibest, best, sbest, extra), the scalars [R] int32.

    extended=False -> K3 top-2 (its form follows n_targets and W,
    kernels.top2_form), extra an empty [R, 0] placeholder;
    "sorted" -> K4: extra is the sorted label grid [R, W] (int16 carrying
    u16; labels must be below 65,536), which the native formatter expands
    to the per-target columns; True -> K5: extra is the dense [R, T+1]
    count matrix."""
    if not extended:
        total, ib, b, isb, sb = score.top2_from_labels(lab, n_targets)
        extra = torch.zeros((lab.shape[0], 0), dtype=torch.int32,
                            device=lab.device)
    elif extended == "sorted":
        extra, total, ib, b, isb, sb = score.sort_top2(lab)
    else:
        extra, total, ib, b, isb, sb = score.counts_top2(lab, n_targets)
    return total, ib, b, sb, extra


def _masked(q, lab):
    """lab [R*W] -> [R, W] with the invalid windows' labels zeroed: the
    EMPTY stash padding "matches" an invalid window with label 0, and a
    valid canonical value is never EMPTY (see window_canonicals), so the
    miss mask is recomputed from q."""
    R, W = q.shape
    return torch.where(q.view(-1) != bits.EMPTY, lab, 0).view(R, W)


def classify_batch(
    table: radix_table.DeviceTable, words, vwords, *, k: int, n_targets: int,
    extended=False, probe_cols: int | None = None,
):
    """Full single-device batch step on packed rows: returns (total, ibest,
    best, sbest, extra) as score_from_labels does.  Runs on the device of
    `words`, which must be the table's."""
    with torch.inference_mode():
        q = window_canonicals(words, vwords, k, probe_cols)
        lab = _masked(q, radix_table.probe(table, q.view(-1)))
        return score_from_labels(lab, n_targets=n_targets, extended=extended)


def classify_batch_dense(
    table: radix_table.DeviceDenseTable, words, vwords, *, k: int,
    n_targets: int, extended=False, probe_cols: int | None = None,
):
    """classify_batch against the dense two-plane table (K1 -> K8 -> miss
    mask -> score_from_labels): identical results, used where the standard
    table exceeds the device budget but the dense one fits."""
    with torch.inference_mode():
        q = window_canonicals(words, vwords, k, probe_cols)
        lab = _masked(q, radix_table.probe_dense(table, q.view(-1)))
        return score_from_labels(lab, n_targets=n_targets, extended=extended)


def _chunk_labels(slots_blk, stash_keys, stash_labels, words, vwords,
                  start_row, use_stash, k, m1, lb, probe_cols):
    q = window_canonicals(words, vwords, k, probe_cols)
    lab = radix_table.probe_chunk(slots_blk, stash_keys, stash_labels,
                                  q.view(-1), start_row, m1=m1, lb=lb,
                                  use_stash=use_stash)
    return _masked(q, lab)


def classify_batch_counts_chunk(
    slots_blk, stash_keys, stash_labels, words, vwords, start_row: int,
    use_stash: bool, *, k: int, m1: int, lb: int, n_targets: int,
    probe_cols: int | None = None, prior=None, scores: bool = False,
):
    """Out-of-core cycle step: per-read counts [R, T+1] int32 against ONE
    table chunk (K1 -> K7 -> miss mask -> K5's counts; its top-2 is not
    used).  Chunks hold disjoint rows, so counts add across cycles (the
    reference's swapDbParts + host-row merge, CuClarkDB.cu:776-815,
    931-948).

    The last cycle passes the earlier cycles' sum as `prior` [R, T+1]
    with `scores`: K5 starts from it, and the step returns (the reads'
    final scalars [R, 4] int32: total, ibest, best, sbest; the final
    counts [R, T+1])."""
    with torch.inference_mode():
        lab = _chunk_labels(slots_blk, stash_keys, stash_labels, words,
                            vwords, start_row, use_stash, k, m1, lb,
                            probe_cols)
        counts, total, ib, b, _, sb = score.counts_top2(lab, n_targets, prior)
        if not scores:
            return counts
        return torch.stack([total, ib, b, sb], dim=1), counts


def classify_batch_labels_chunk(
    slots_blk, stash_keys, stash_labels, words, vwords, start_row: int,
    use_stash: bool, *, k: int, m1: int, lb: int, narrow: bool,
    probe_cols: int | None = None,
):
    """Out-of-core cycle step returning the per-window labels [R, W]
    (label+1, 0 = miss) against ONE table chunk (K1 -> K7 -> miss mask).
    A window matches in at most one chunk, so the cycles' grids
    concatenate along the window axis and one top-2 over [R, cycles*W]
    scores them.  With `narrow` (n_targets < 65,535) the grid is u16 on an
    int16 carrier: widen it as unsigned."""
    with torch.inference_mode():
        lab = _chunk_labels(slots_blk, stash_keys, stash_labels, words,
                            vwords, start_row, use_stash, k, m1, lb,
                            probe_cols)
        return score.u16_bits(lab) if narrow else lab
