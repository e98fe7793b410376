"""Device-memory budget for the table's residency.

The reference sizes DB parts x cycles from the device's free memory minus a
RESERVED headroom and refuses to run below a 200 MB floor
(CuClarkDB.cu:526-565, 178-181; parameters.hh:45).  Here the budget for the
table is the card's memory limit less RESERVED and less what the batches in
flight hold on the card (`probe_transient_bytes`); a table larger than the
budget is streamed in chunks (`auto_db_cycles`) or, when it fits the
budget in the dense two-plane layout, kept resident in that layout
(engine.Classifier).
"""

from __future__ import annotations

import os

import torch

RESERVED = 768 << 20  # headroom: the CUDA context, the kernel libraries,
# the caching allocator's rounding (reference: 200 MB on Jetson-class cards)
HARD_FLOOR = 200 << 20  # reference parity: refuse to run below this


def device_memory_limit(device=None) -> int | None:
    """The card's memory in bytes, or None on the CPU (host memory is the
    OS's business: no cycling is chosen there).

    CLARK_TPU_DEVICE_MEM_BYTES overrides it (also the tests' hook).  On a
    CUDA device it is the total memory: torch.cuda.mem_get_info's free
    count misses blocks that torch's own allocator caches, so a run that
    allocated before would see a smaller budget than a fresh one."""
    env = os.environ.get("CLARK_TPU_DEVICE_MEM_BYTES")
    if env:
        return int(env)
    if device is None:
        return None
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(dev).total_memory)


def probe_transient_bytes(window_budget: int, pipeline_depth: int,
                          counts_bytes: int) -> int:
    """Device bytes the batches in flight hold beside the table.

    One batch at a time is inside the device step, which holds per window
    slot (window_budget slots at most): its canonical value q (8 B), the
    probe's labels (4 B), the probe's scratch (K2 and K8: each query's index
    and mixed key for each of the partition's two levels, 24 B, K8's two
    planes reusing it in turn; K7 at other times: its 4-B list of in-chunk
    indices), the miss mask (1 B) and the masked labels (4 B) -- 41 B.  Up
    to pipeline_depth + 3 batches are in flight (the
    dispatch queue, the one being dispatched, two in the fetch pool), each
    holding its packed rows (3 bits per slot, rounded up to 3/8 B), its
    per-window output grid (the sorted u16 grid or a cycle's u16 labels,
    2 B per slot) and, where the run counts per target, its count matrix
    of at most `counts_bytes`:

        41 * window_budget
        + (pipeline_depth + 3) * (window_budget * 19 // 8 + counts_bytes)

    The JAX package counts a [Q, C] row gather here instead; the kernels
    read rows in place and materialize none.  K2's and K8's per-block bin
    counts (4,096 x 2 ints per streaming multiprocessor, ~4.3 MB on an
    H100) fit inside RESERVED."""
    per_batch = window_budget * 19 // 8 + counts_bytes
    return 41 * window_budget + (pipeline_depth + 3) * per_batch


def auto_db_cycles(table_bytes: int, transient: int, device=None, *,
                   n_shards: int = 1) -> tuple[int, int | None]:
    """(db_cycles, per-device budget_bytes) so each resident table chunk
    fits the card: cycles = ceil(per-shard table bytes / budget), a shard
    holding ceil(table bytes / n_shards) (the table's rows split over the
    db axis of a mesh).

    Returns (1, None) where the device memory is unknowable (CPU).  Raises
    with guidance when the budget is below the reference's 200 MB floor."""
    limit = device_memory_limit(device)
    if limit is None:
        return 1, None
    budget = limit - RESERVED - transient
    if budget < HARD_FLOOR:
        raise RuntimeError(
            f"device memory budget for the database is "
            f"{max(budget, 0) >> 20} MB (< {HARD_FLOOR >> 20} MB floor): "
            f"device limit {limit >> 20} MB minus reserved "
            f"{RESERVED >> 20} MB minus batch transients {transient >> 20} MB. "
            "Shard the DB over more devices (--shard-db / -d), lower "
            "BatchPlan.window_budget or pipeline_depth, or set "
            "CLARK_TPU_DEVICE_MEM_BYTES if the device limit was misdetected."
        )
    per_shard = -(-table_bytes // max(n_shards, 1))
    cycles = max(-(-per_shard // budget), 1)
    if cycles > 1 and os.environ.get("CLARK_TPU_PREFETCH_CHUNKS", "1") != "0":
        # the next chunk uploads while this one is probed
        # (engine._cycle_passes), so two chunks are resident at the peak and
        # each must fit half the budget
        cycles = max(-(-per_shard // (budget // 2)), 2)
    return cycles, budget
