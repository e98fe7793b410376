"""Build, load and launch the port's hand-written CUDA kernels.

`classify.cu` (K1-K5, K7-K9, the classify paths) and `aggregate.cu` (K6, the DB
build) are each compiled by `nvcc` for `sm_90a` into a shared library with
a plain C interface at first use (utils/build.py) and bound with ctypes:
pointers come from `tensor.data_ptr()` and the stream from torch's current
stream, so each kernel runs in order with the torch work around it.  Nothing
here is imported from or compiled at module import: the CPU tests import
this module on machines with no `nvcc`.

Each wrapper validates device, dtype, shape and contiguity, allocates its
outputs with `torch.empty`, launches, raises if the launch was refused, and
adds one to its entry of `LAUNCHES`, which shows that a run went through the
kernel.  Nothing falls back to the plain-PyTorch twins: those live beside
the public functions (device_pipeline.window_canonicals_plain,
radix_table.probe_plain, probe_chunk_plain, probe_dense_plain,
score.top2_from_labels_plain, score.sort_top2_plain,
score.counts_from_hits_plain + read_results_plain (K5, grid and flat
forms), lookup.lookup_labels_dir_plain (K9's steps) and
lookup_labels_plain,
db.device_build.aggregate_bucketed_plain, which runs K6's level plan,
ops/bucket_plan.py, with each launch's twin) and run only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ...utils.build import build_library
from .. import bucket_plan
from ..radix_table import STASH_CAP

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = {
    "classify": os.path.join(_HERE, "classify.cu"),
    "aggregate": os.path.join(_HERE, "aggregate.cu"),
}
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]

# K7's and K2/K8's bin plans and K5's forms: the constants of classify.cu's
# launchers, which refuse a plan or a form that does not fit them.
L2_SHARE_BYTES = 16 << 20  # a bin's row hi halves: a third of the 50 MB L2
K7_MAX_BINS = 4096  # K2/K8's bins too: their partition's shared histograms
GROUP_TILE = 2048  # queries a K2/K8 block sorts by row at once
GROUP_KEY_BITS = 13  # a tile's counting-sort keys: 2^13 counters
GROUP_LOCAL_BYTES = 32 << 10  # plane-2 hi halves up to this: the local form
SMEM_BYTES = 232_448  # shared memory one H100 block may use
K5_SMALL_T1 = 4096  # small form: T+1 histogram columns per read, at most
K5_TILE_W = 4096  # large form: windows per read, at most
K5_FORMS = ("small", "large", "wide")
K3_TILE_W = 4096  # K3's hash form: windows per read, at most
TOP2_FORMS = ("small", "hash", "block")
K1_THREADS = 256  # threads of a K1 block, one run of E windows each
SORT_WARP_W = 1024  # K4's warp form: windows per read, at most
SORT_FORMS = ("warp", "block")
_U64_MASK = (1 << 64) - 1
AGG_TILE = 4096  # K6's compaction: places a tile (aggregate.cu's TILE)

# a launch of K3 also counts under "top2 <form>", the form it took
LAUNCHES = {"window_canonicals": 0, "probe": 0, "top2": 0, "sort_top2": 0,
            "counts_top2": 0, "aggregate": 0, "probe_chunk": 0,
            "probe_dense": 0, "lookup": 0, "counts_flat": 0,
            **{f"top2 {f}": 0 for f in TOP2_FORMS}}
_count_lock = threading.Lock()
_libs: dict = {}
_load_lock = threading.Lock()


def reset_launches():
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _counted(name: str):
    with _count_lock:
        LAUNCHES[name] += 1


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "cannot build the CUDA kernels: no CUDA toolkit found "
            "(set CUDA_HOME or put nvcc on PATH)"
        )
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _build(name: str) -> str:
    src = SOURCES[name]

    def command(out: str) -> list[str]:
        return [
            _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-o", out, src,
        ]

    return build_library(f"{name}_kernels", [src], command)


def _bind(name: str, lib):
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    u64 = ctypes.c_ulonglong
    lib.clark_cuda_error_string.restype = ctypes.c_char_p
    lib.clark_cuda_error_string.argtypes = [i32]
    sigs = {
        "classify": {
            "launch_window_canonicals": [p, p, p, i64, i32, i32, i32, i32,
                                         i32, i32, i32, i32, p],
            "launch_probe": [p, p, p, p, p, i64, i32, i32, i32, i32, i32,
                             i32, i32, p, p, p, p, p],
            "launch_probe_chunk": [p, p, p, p, p, i64, i32, i32, i32, i64,
                                   i64, i32, i32, i32, p, p, p],
            "launch_probe_dense": [p, p, p, p, p, p, i64, i32, i32, i32, i32,
                                   i32, i32, i32, i32, i32, i32, i32, i32,
                                   p, p, p, p, p],
            "launch_top2": [p, i64, i64, i32, i32, p, p, p, p, p, p],
            "launch_sort_top2": [p, i64, i64, i32, p, p, p, p, p, p, p],
            "launch_counts_top2": [p, p, i64, i64, i32, i32, p, p, p, p, p,
                                   p, p],
            "launch_lookup": [p, p, p, u64, u64, i32, p, p, i64, p],
            "launch_counts_flat": [p, p, i64, i64, i32, p, p, p, p, p, p, p],
        },
        "aggregate": {
            "launch_agg_range": [p, i64, p, p],
            "launch_agg_partition": [p, p, p, i32, p, i64, p, i64, i64, i32,
                                     p, p, p, p, p],
            "launch_agg_bucket": [p, p, p, i64, p, i32, p, i32, i32, p, p],
            "launch_agg_single": [p, p, p, p, i32, i64, p, p, i32, i32, p,
                                  p],
            "launch_agg_count_rows": [p, i64, p, p, p, p],
            "launch_agg_compact": [p, p, p, i64, p, p, p, p, p, p, p],
        },
    }[name]
    for fn, argtypes in sigs.items():
        getattr(lib, fn).restype = i32
        getattr(lib, fn).argtypes = argtypes
    return lib


def load(name: str = "classify"):
    """Build (once per source hash) and load one kernel library."""
    with _load_lock:
        if name not in _libs:
            _libs[name] = _bind(name, ctypes.CDLL(_build(name)))
        return _libs[name]


def library_path(name: str = "classify") -> str:
    """Path of the built kernel library `name` (built first if need be)."""
    return _build(name)


def load_all():
    """Build every kernel library, one `nvcc` per source, all at once."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as ex:
        list(ex.map(_build, SOURCES))
    return [load(name) for name in SOURCES]


def _check(name: str, t: torch.Tensor, dtype, ndim: int, device):
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(lib, fn, name: str, device, *args, count: bool = True):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        msg = lib.clark_cuda_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg}")
    if count:
        _counted(name)


def window_canonicals(words: torch.Tensor, vwords: torch.Tensor, k: int,
                      w: int) -> torch.Tensor:
    """K1: q [R, w] int64, the canonical value of each window (EMPTY where
    invalid) of packed rows words [R, S/32+1], vwords [R, S/64+1]."""
    dev = words.device
    _check("words", words, torch.int64, 2, dev)
    _check("vwords", vwords, torch.int64, 2, dev)
    R, nw = words.shape
    S = (nw - 1) * 32
    if S <= 0 or S % 64 or vwords.shape != (R, S // 64 + 1):
        raise ValueError(
            f"packed shapes {tuple(words.shape)}/{tuple(vwords.shape)} are "
            "not [R, S/32+1]/[R, S/64+1] with S a positive multiple of 64"
        )
    if not (1 <= k <= 32 and 1 <= w <= S):
        raise ValueError(f"bad k={k} or window count {w} for stride {S}")
    lib = load()
    q = torch.empty((R, w), dtype=torch.int64, device=dev)
    _launch(lib, lib.launch_window_canonicals, "window_canonicals", dev,
            words.data_ptr(), vwords.data_ptr(), q.data_ptr(), R, nw,
            S // 64 + 1, w, k, *window_run(w))
    return q


def window_run(w: int) -> tuple[int, int, int, int]:
    """K1's launch plan for rows of w windows: (E, tr, rb, tiles).  A
    thread rolls a run of E consecutive windows (8, or 4 below 64 windows,
    where a run of 8 would leave most of a short row's threads idle); a
    block of K1_THREADS threads holds tr runs of each of rb whole rows
    where a row's runs fit it, else tr = K1_THREADS runs of one row, and
    `tiles` blocks cover a row."""
    e = 8 if w >= 64 else 4
    runs = -(-w // e)
    tr = min(runs, K1_THREADS)
    return e, tr, K1_THREADS // tr, -(-runs // tr)


def probe(slots: torch.Tensor, stash_keys: torch.Tensor,
          stash_labels: torch.Tensor, q: torch.Tensor, m1: int,
          lb: int) -> torch.Tensor:
    """K2: label+1 per query q [Q] int64 (0 = miss) against the radix table
    slots [2^m1, 2C] int32 (u32 halves) and its 64-entry stash."""
    dev = q.device
    _check_rows("slots", slots, m1, lb, dev)
    _check_stash(stash_keys, stash_labels, dev)
    _check("q", q, torch.int64, 1, dev)
    if slots.shape[0] != 1 << m1:
        raise ValueError(f"slots shape {tuple(slots.shape)} does not match m1={m1}")
    Q = _check_group_queries(q)
    plan = group_bins(1 << m1)
    lib = load()
    out = torch.empty(Q, dtype=torch.int32, device=dev)
    grid, *scratch = _group_scratch(Q, plan[1], dev)
    # the partition's launches (count, offsets, tiles, scatter; twice past
    # 64 bins) and the probe count as one
    _launch(lib, lib.launch_probe, "probe", dev,
            slots.data_ptr(), stash_keys.data_ptr(), stash_labels.data_ptr(),
            q.data_ptr(), out.data_ptr(), Q, slots.shape[1] // 2, m1, lb,
            *plan, grid, *(t.data_ptr() for t in scratch))
    return out


def group_bins(n_rows: int) -> tuple[int, int, int]:
    """K2's and K8's bin plan for a plane of n_rows rows: (shift, n_bins,
    kshift).  bin = row >> shift, as fine as the partition passes allow
    (K7_MAX_BINS bins: a batch of 7.3M queries puts ~1,800 in a bin, one
    GROUP_TILE tile); a tile counting-sorts its queries by local row >>
    kshift, which is 0 unless a bin holds more than 2^GROUP_KEY_BITS rows
    (a plane of over 2^25 rows)."""
    shift = max((n_rows - 1).bit_length() - K7_MAX_BINS.bit_length() + 1, 0)
    return (shift, ((n_rows - 1) >> shift) + 1,
            max(shift - GROUP_KEY_BITS, 0))


def group_smem_bytes(shift: int, kshift: int) -> int:
    """Shared memory of one K2/K8 tile: per query its t (8 B), index and
    local row (4 B each), rank and sorted position (2 B each), then the
    counting sort's counters."""
    return 20 * GROUP_TILE + (4 << (shift - kshift))


def plane2_form(m2: int, c: int) -> str:
    """K8's form for plane 2 (2^m2 rows of 2c words): "local" (every block
    stages the plane's occupied slots in shared memory, a thread per query)
    where the plane's hi halves fit GROUP_LOCAL_BYTES, else "grouped"
    (partitioned as plane 1)."""
    return "local" if (4 * c) << m2 <= GROUP_LOCAL_BYTES else "grouped"


def plane2_smem_bytes(m2: int, c: int) -> int:
    """Shared memory of K8's local form: the plane's occupied hi and lo
    words in rows of c + 1 (an odd pitch keeps the rows on distinct banks)
    and a count per row."""
    return (8 * (c + 1) + 4) << m2


def _check_group_queries(q: torch.Tensor) -> int:
    Q = q.shape[0]
    if Q >= 1 << 31:
        raise ValueError(f"{Q} queries: the probe indexes them in int32")
    return Q


def _group_scratch(Q: int, n_bins: int, dev):
    """(G, list, keys, cnt, ctr): the G blocks that partition the queries
    (two a streaming multiprocessor) and the grouped probes' scratch, none
    of it zeroed: the query indices and their mixed keys bin by bin, for
    each of the partition's two levels [2, Q]; each block's count then
    offset in each bin [n_bins, G]; the bins' totals, starts and first
    tiles [3 n_bins + 1]."""
    grid = 2 * torch.cuda.get_device_properties(dev).multi_processor_count
    return (grid,
            torch.empty(2 * Q, dtype=torch.int32, device=dev),
            torch.empty(2 * Q, dtype=torch.int64, device=dev),
            torch.empty(n_bins * grid, dtype=torch.int32, device=dev),
            torch.empty(3 * n_bins + 1, dtype=torch.int32, device=dev))


def _check_stash(stash_keys, stash_labels, dev):
    _check("stash_keys", stash_keys, torch.int64, 1, dev)
    _check("stash_labels", stash_labels, torch.int32, 1, dev)
    if stash_keys.shape != (STASH_CAP,) or stash_labels.shape != (STASH_CAP,):
        raise ValueError(f"the stash must hold {STASH_CAP} entries")


def _check_rows(name: str, slots: torch.Tensor, m: int, lb: int, dev):
    _check(name, slots, torch.int32, 2, dev)
    if not (1 <= m <= 63 and slots.shape[1] % 2 == 0 and slots.shape[1] > 0):
        raise ValueError(f"{name} shape {tuple(slots.shape)} does not match "
                         f"m={m}")
    if not 0 <= lb < min(m, 32):
        raise ValueError(f"label bits lb={lb} must be below min({m}, 32)")


def chunk_bins(rows_per: int, c: int) -> tuple[int, int]:
    """K7's bin plan for a chunk of rows_per rows of 2c u32 words:
    (shift, n_bins), bin = local row >> shift.  A bin's rows are the most
    whose hi halves (c x 4 B each) fit L2_SHARE_BYTES, a power of two,
    unless that would take more than K7_MAX_BINS bins (a chunk of over
    K7_MAX_BINS x 2 x L2_SHARE_BYTES, beyond the card's memory)."""
    shift = max((L2_SHARE_BYTES // (4 * c)).bit_length() - 1, 0)
    while (rows_per - 1) >> shift >= K7_MAX_BINS:
        shift += 1
    return shift, ((rows_per - 1) >> shift) + 1


def probe_chunk(slots: torch.Tensor, stash_keys: torch.Tensor,
                stash_labels: torch.Tensor, q: torch.Tensor, start_row: int,
                m1: int, lb: int, use_stash: bool) -> torch.Tensor:
    """K7: label+1 per query q [Q] int64 against one row chunk slots
    [rows_per, 2C] int32 holding rows start_row.. of a 2^m1-row table; a
    query bucketed outside the chunk gets 0, and the 64-entry stash counts
    only where use_stash is set.  The chunk may run past the table's last
    row, or start past it (a db shard of a mesh beyond a small table): no
    query falls there."""
    dev = q.device
    _check_rows("slots", slots, m1, lb, dev)
    _check_stash(stash_keys, stash_labels, dev)
    _check("q", q, torch.int64, 1, dev)
    rows_per = slots.shape[0]
    if not (rows_per >= 1 and 0 <= start_row < 1 << 62):
        raise ValueError(f"chunk of {rows_per} rows at {start_row}: want at "
                         "least one row at a start in [0, 2^62)")
    Q, c = q.shape[0], slots.shape[1] // 2
    if Q >= 1 << 31:
        raise ValueError(f"{Q} queries: the chunk probe indexes them in int32")
    shift, n_bins = chunk_bins(rows_per, c)
    lib = load()
    out = torch.empty(Q, dtype=torch.int32, device=dev)
    # scratch: the in-chunk query indices, bin by bin, and per bin its count
    # and cursor, then the finished-block ticket and the in-chunk total
    index = torch.empty(Q, dtype=torch.int32, device=dev)
    ctr = torch.zeros(2 * n_bins + 2, dtype=torch.int32, device=dev)
    # three launches (count, scatter, probe) count as one K7 launch
    _launch(lib, lib.launch_probe_chunk, "probe_chunk", dev,
            slots.data_ptr(), stash_keys.data_ptr(), stash_labels.data_ptr(),
            q.data_ptr(), out.data_ptr(), Q, c, m1, lb, start_row, rows_per,
            1 if use_stash else 0, shift, n_bins, index.data_ptr(),
            ctr.data_ptr())
    return out


def probe_dense(slots1: torch.Tensor, slots2: torch.Tensor,
                stash_keys: torch.Tensor, stash_labels: torch.Tensor,
                q: torch.Tensor, m1: int, m2: int, lb: int) -> torch.Tensor:
    """K8: label+1 per query q [Q] int64 (0 = miss) against the dense
    two-plane table: slots1 [2^m1, 2C] and slots2 [2^m2, 2C] int32 (u32
    halves) and its 64-entry stash."""
    dev = q.device
    _check_rows("slots1", slots1, m1, lb, dev)
    _check_rows("slots2", slots2, m2, lb, dev)
    _check_stash(stash_keys, stash_labels, dev)
    _check("q", q, torch.int64, 1, dev)
    if (slots1.shape[0] != 1 << m1 or slots2.shape[0] != 1 << m2
            or slots1.shape[1] != slots2.shape[1]):
        raise ValueError(f"planes {tuple(slots1.shape)}/{tuple(slots2.shape)} "
                         f"do not match m1={m1}, m2={m2}")
    Q, c = _check_group_queries(q), slots1.shape[1] // 2
    plan1 = group_bins(1 << m1)
    local2 = plane2_form(m2, c) == "local"
    plan2 = (m2, 1, 0) if local2 else group_bins(1 << m2)
    lib = load()
    out = torch.empty(Q, dtype=torch.int32, device=dev)
    grid, *scratch = _group_scratch(Q, max(plan1[1], plan2[1]), dev)
    # plane 1's launches and plane 2's count as one
    _launch(lib, lib.launch_probe_dense, "probe_dense", dev,
            slots1.data_ptr(), slots2.data_ptr(), stash_keys.data_ptr(),
            stash_labels.data_ptr(), q.data_ptr(), out.data_ptr(), Q, c, m1,
            m2, lb, *plan1, 1 if local2 else 0, *plan2, grid,
            *(t.data_ptr() for t in scratch))
    return out


def top2(lab: torch.Tensor, n_targets: int | None = None,
         form: str | None = None):
    """K3: (total, ibest, best, isbest, sbest), each [R] int32, of the
    per-window labels lab [R, W] int32 (0 = miss).  With n_targets = T
    the labels must lie in [0, T] (the small form skips any other); with
    None any label counts, and labels <= 0 are misses.  `form` forces one
    of top2_forms(n_targets, W); by default top2_form picks it."""
    dev = lab.device
    _check("lab", lab, torch.int32, 2, dev)
    R, W = lab.shape
    forms = top2_forms(n_targets, W)
    form = form or forms[0]
    if form not in forms:
        raise ValueError(f"K3's {form!r} form does not take rows of {W} "
                         f"windows at n_targets={n_targets}: {forms}")
    lib = load()
    outs = torch.empty((5, R), dtype=torch.int32, device=dev)
    total, ibest, best, isbest, sbest = outs
    _launch(lib, lib.launch_top2, "top2", dev,
            lab.data_ptr(), R, W, n_targets + 1 if form == "small" else 0,
            TOP2_FORMS.index(form), total.data_ptr(), ibest.data_ptr(),
            best.data_ptr(), isbest.data_ptr(), sbest.data_ptr())
    _counted(f"top2 {form}")
    return total, ibest, best, isbest, sbest


def check_targets(n_targets: int):
    """Raise unless n_targets is a target count the scoring kernels take."""
    if not 1 <= n_targets < (1 << 31) - 1:
        raise ValueError(f"bad target count {n_targets}")


def top2_forms(n_targets: int | None, w: int) -> tuple[str, ...]:
    """K3's forms that take rows of w windows with labels in [0, n_targets]
    (None: any label), in the order top2_form prefers them: "small" (a warp
    per read, a histogram of T+1 columns in shared memory) where T is
    known and T+1 <= K5_SMALL_T1; "hash" (a warp per read, a shared-memory
    hash of its labels) where w <= K3_TILE_W; "block" (a block per read,
    histograms over chunks of the label range) at any shape."""
    if n_targets is not None:
        check_targets(n_targets)
    small = n_targets is not None and n_targets + 1 <= K5_SMALL_T1
    return (("small",) if small else ()) + (
        ("hash",) if w <= K3_TILE_W else ()) + ("block",)


def top2_form(n_targets: int | None, w: int) -> str:
    """K3's form for rows of w windows over labels in [0, n_targets]: the
    first of top2_forms (small, else hash, else block)."""
    return top2_forms(n_targets, w)[0]


def sort_top2(lab: torch.Tensor):
    """K4: (sorted, total, ibest, best, isbest, sbest): sorted [R, W] int16
    holds each row's labels ascending (zeros first) as u16 bit patterns;
    the scalars are K3's.  Labels must lie in [0, 65,536)."""
    dev = lab.device
    _check("lab", lab, torch.int32, 2, dev)
    R, W = lab.shape
    form = SORT_FORMS.index(sort_form(W))
    lib = load()
    srt = torch.empty((R, W), dtype=torch.int16, device=dev)
    outs = torch.empty((5, R), dtype=torch.int32, device=dev)
    total, ibest, best, isbest, sbest = outs
    _launch(lib, lib.launch_sort_top2, "sort_top2", dev,
            lab.data_ptr(), R, W, form, srt.data_ptr(), total.data_ptr(),
            ibest.data_ptr(), best.data_ptr(), isbest.data_ptr(),
            sbest.data_ptr())
    return srt, total, ibest, best, isbest, sbest


def sort_form(w: int) -> str:
    """K4's form for rows of w windows: "warp" (a warp sorts each read in
    registers, 8 reads a block) up to SORT_WARP_W windows, the classify
    batches' widths; "block" (a block per read, a counting sort over
    chunks of the label range) past it, for reads of over 1,024 windows."""
    return "warp" if w <= SORT_WARP_W else "block"


def counts_form(t1: int, w: int) -> str:
    """K5's form for rows of w windows over t1 = T+1 count columns: "small"
    (a warp per read, its histogram in shared memory) where t1 <=
    K5_SMALL_T1, else "large" (a shared-memory hash of the read's labels)
    where w <= K5_TILE_W, else "wide" (the multi-pass form)."""
    if t1 <= K5_SMALL_T1:
        return "small"
    return "large" if w <= K5_TILE_W else "wide"


def counts_top2(lab: torch.Tensor, n_targets: int,
                prior: torch.Tensor | None = None):
    """K5: (counts, total, ibest, best, isbest, sbest): counts [R, T+1]
    int32 of the per-window labels lab [R, W] (label+1 in [0, T]; column 0
    collects misses) and read_results' top two over columns 1..T.  With
    `prior` [R, T+1] int32 the counts start from it (the small form only,
    check_prior)."""
    dev = lab.device
    _check("lab", lab, torch.int32, 2, dev)
    check_targets(n_targets)
    R, W = lab.shape
    check_prior(prior, R, n_targets, W)
    if prior is not None:
        _check("prior", prior, torch.int32, 2, dev)
    form = K5_FORMS.index(counts_form(n_targets + 1, W))
    lib = load()
    counts = torch.empty((R, n_targets + 1), dtype=torch.int32, device=dev)
    outs = torch.empty((5, R), dtype=torch.int32, device=dev)
    total, ibest, best, isbest, sbest = outs
    _launch(lib, lib.launch_counts_top2, "counts_top2", dev,
            lab.data_ptr(), None if prior is None else prior.data_ptr(), R,
            W, n_targets + 1, form, counts.data_ptr(), total.data_ptr(),
            ibest.data_ptr(), best.data_ptr(), isbest.data_ptr(),
            sbest.data_ptr())
    return counts, total, ibest, best, isbest, sbest


def check_prior(prior: torch.Tensor | None, R: int, n_targets: int, w: int):
    """Refuse a K5 `prior` of another shape than [R, T+1], or one at a
    shape that does not take K5's small form (the other forms never scan
    the T columns, so they have no histogram to start from)."""
    if prior is None:
        return
    if tuple(prior.shape) != (R, n_targets + 1):
        raise ValueError(f"prior must be [{R}, {n_targets + 1}], got "
                         f"{tuple(prior.shape)}")
    if counts_form(n_targets + 1, w) != "small":
        raise ValueError("a prior needs K5's small form: T+1 <= "
                         f"{K5_SMALL_T1}, got {n_targets + 1}")


def lookup(index, q: torch.Tensor) -> torch.Tensor:
    """K9: [Q] int32, the label + 1 of the first key equal to each query
    q [Q] int64 (u64 bits) in a lookup.FlatIndex (keys [N] int64, u64
    bits ascending as u64, labels1 [N] int32), searched through its radix
    directory; 0 on a miss or for the pad query 2^64 - 1."""
    dev = q.device
    keys, labels1, offsets = index.keys, index.labels1, index.offsets
    _check("keys", keys, torch.int64, 1, dev)
    _check("labels1", labels1, torch.int32, 1, dev)
    _check("q", q, torch.int64, 1, dev)
    _check("directory offsets", offsets, torch.int32, 1, dev)
    if labels1.shape != keys.shape:
        raise ValueError(f"keys {tuple(keys.shape)} and labels1 "
                         f"{tuple(labels1.shape)} must have one length")
    # 2^bits buckets that cover [kmin, kmax]: no query reads past them
    nb = offsets.shape[0] - 1
    if (keys.shape[0] >= 1 << 31 or nb < 1 or nb & (nb - 1)
            or (index.kmin <= index.kmax
                and (index.kmax - index.kmin) >> index.shift >= nb)):
        raise ValueError(f"{offsets.shape[0]} directory offsets (2^bits + "
                         f"1, covering the key range) for {keys.shape[0]} "
                         f"keys (below 2^31)")
    lib = load()
    out = torch.empty(q.shape[0], dtype=torch.int32, device=dev)
    _launch(lib, lib.launch_lookup, "lookup", dev, keys.data_ptr(),
            labels1.data_ptr(), offsets.data_ptr(), index.kmin, index.kmax,
            index.shift, q.data_ptr(), out.data_ptr(), q.shape[0])
    return out


def counts_flat(labels1: torch.Tensor, read_id: torch.Tensor, n_reads: int,
                n_targets: int):
    """K5's flat form: (counts, total, ibest, best, isbest, sbest) of flat
    per-query labels1 [Q] int32 (label + 1 in [0, T]; 0 = miss) and
    read_id [Q] int32 in [0, n_reads): counts [n_reads, T+1] int32 (column
    0 the misses) and read_results' top two over columns 1..T, each
    [n_reads] int32."""
    dev = labels1.device
    _check("labels1", labels1, torch.int32, 1, dev)
    _check("read_id", read_id, torch.int32, 1, dev)
    check_targets(n_targets)
    if read_id.shape != labels1.shape or n_reads < 0:
        raise ValueError(f"labels1 {tuple(labels1.shape)}, read_id "
                         f"{tuple(read_id.shape)} and {n_reads} reads do not "
                         "fit")
    lib = load()
    counts = torch.empty((n_reads, n_targets + 1), dtype=torch.int32,
                         device=dev)
    outs = torch.empty((5, n_reads), dtype=torch.int32, device=dev)
    total, ibest, best, isbest, sbest = outs
    # the zeroing, the warp-aggregated scatter and the top-2 count as one
    # launch
    _launch(lib, lib.launch_counts_flat, "counts_flat", dev,
            labels1.data_ptr(), read_id.data_ptr(), labels1.shape[0],
            n_reads, n_targets + 1, counts.data_ptr(), total.data_ptr(),
            ibest.data_ptr(), best.data_ptr(), isbest.data_ptr(),
            sbest.data_ptr())
    return counts, total, ibest, best, isbest, sbest


def aggregate(canon: torch.Tensor, label: torch.Tensor, pg: torch.Tensor,
              lelement: bool, stats: dict | None = None):
    """K6: the DB-build aggregate of occurrences canon [n] int64 (u64 bit
    patterns, stream order), label [n] int32 (in [0, len(pg))) and pg [L]
    int32 (prefix group of each label): one row per distinct canonical,
    ascending as u64 -- (canon [G] int64 bits, L0 [G] int32, mult [G]
    int32, count [G] int64, first_seq [G] int64).  A bucket sort fused with
    the group pass, driven by ops/bucket_plan.run_levels; it synchronises
    to read back the key range, each level's plan and G.  `stats`, a dict,
    receives the plan's branch counts."""
    dev = canon.device
    _check("canon", canon, torch.int64, 1, dev)
    _check("label", label, torch.int32, 1, dev)
    _check("pg", pg, torch.int32, 1, dev)
    n = canon.shape[0]
    if label.shape[0] != n:
        raise ValueError("canon and label must have one length")
    if n >= 1 << 32:
        raise ValueError(f"{n} occurrences: the stream index of an entry is "
                         "u32, so a call takes fewer than 2^32")
    if n == 0:
        return (canon.new_empty(0), label.new_empty(0), label.new_empty(0),
                canon.new_empty(0), canon.new_empty(0))
    steps = _AggregateSteps(load("aggregate"), canon, label, pg, lelement)
    out = bucket_plan.run_levels(steps, n, bucket_plan.CAP)
    _counted("aggregate")  # the plan's launches count as one K6 launch
    if stats is not None:
        stats.update(steps.stats)
    return out


class _AggregateSteps:
    """K6's launches (aggregate.cu) for bucket_plan.run_levels: entry
    buffers bufs [2, capacity, 2] int64, a row flag per place (uint8)."""

    def __init__(self, lib, canon, label, pg, lelement):
        self.lib, self.dev = lib, canon.device
        self.canon, self.label, self.pg = canon, label, pg
        self.lelement = 1 if lelement else 0
        cap_n = bucket_plan.capacity(canon.shape[0])
        self.bufs = torch.empty((2, cap_n, 2), dtype=torch.int64,
                                device=self.dev)
        self.rowflag = torch.empty(cap_n, dtype=torch.uint8, device=self.dev)
        self.sms = torch.cuda.get_device_properties(
            self.dev).multi_processor_count
        self.stats = bucket_plan.new_stats()

    def _go(self, fn, *args):
        _launch(self.lib, fn, "aggregate", self.dev, *args, count=False)

    def _buf(self, i: int) -> int:
        return self.bufs[i].data_ptr() if i >= 0 else 0

    def _i64(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(self.dev)

    def range(self):
        out = torch.empty(2, dtype=torch.int64, device=self.dev)
        self._go(self.lib.launch_agg_range, self.canon.data_ptr(),
                 self.canon.shape[0], out.data_ptr())
        lo, hi = out.tolist()
        return lo & _U64_MASK, hi & _U64_MASK

    def partition(self, src, dst, table):
        """hist, scan and scatter of every range of a level's table."""
        nbs = 1 << table[:, 3]
        nb_all = int(nbs.sum())
        plan = torch.empty((3, nb_all), dtype=torch.int64, device=self.dev)
        starts = torch.empty(nb_all, dtype=torch.int64, device=self.dev)
        cursor = torch.empty(nb_all, dtype=torch.int64, device=self.dev)
        # one block of 1,024 threads an SM for hist and the scatter
        blocks = bucket_plan.block_table(table, self.sms)
        tab, blk = self._i64(table), self._i64(blocks)
        self._go(self.lib.launch_agg_partition, self.canon.data_ptr(),
                 self.label.data_ptr(), self._buf(src), int(src < 0),
                 tab.data_ptr(), len(table), blk.data_ptr(), len(blocks),
                 nb_all, int(nbs.max()), plan.data_ptr(), starts.data_ptr(),
                 cursor.data_ptr(), self._buf(dst))
        return plan, starts

    def bucket_pass(self, dst, plan, starts, S):
        self._go(self.lib.launch_agg_bucket, self._buf(dst),
                 self._buf(1 - dst), plan.data_ptr(), plan.shape[1],
                 starts.data_ptr(), S, self.pg.data_ptr(), self.lelement,
                 1 + dst, self.rowflag.data_ptr())

    def single(self, dst, lstart, lcount):
        for i in range(0, len(lstart), 65535):  # a grid's y extent
            ls, lc = (self._i64(a[i : i + 65535]) for a in (lstart, lcount))
            slot = torch.empty(2 * ls.shape[0], dtype=torch.int64,
                               device=self.dev)
            self._go(self.lib.launch_agg_single, self._buf(dst),
                     self._buf(1 - dst), ls.data_ptr(), lc.data_ptr(),
                     ls.shape[0], int(lcount[i : i + 65535].max()),
                     slot.data_ptr(), self.pg.data_ptr(), self.lelement,
                     1 + dst, self.rowflag.data_ptr())

    def compact(self):
        n = self.canon.shape[0]
        nt = -(-n // AGG_TILE)
        tcount = torch.empty(nt, dtype=torch.int32, device=self.dev)
        tbase = torch.empty(nt, dtype=torch.int64, device=self.dev)
        total = torch.empty(1, dtype=torch.int64, device=self.dev)
        self._go(self.lib.launch_agg_count_rows, self.rowflag.data_ptr(), n,
                 tcount.data_ptr(), tbase.data_ptr(), total.data_ptr())
        g = int(total.item())  # synchronises: G is known
        out = (torch.empty(g, dtype=torch.int64, device=self.dev),
               torch.empty(g, dtype=torch.int32, device=self.dev),
               torch.empty(g, dtype=torch.int32, device=self.dev),
               torch.empty(g, dtype=torch.int64, device=self.dev),
               torch.empty(g, dtype=torch.int64, device=self.dev))
        self._go(self.lib.launch_agg_compact, self._buf(0), self._buf(1),
                 self.rowflag.data_ptr(), n, tbase.data_ptr(),
                 *(t.data_ptr() for t in out))
        return out
