"""Phase timers for the engine hot path.

`Phases` accumulates wall seconds per named phase (scan / pack / dispatch /
device_wait / format; all_reduce, a multi-process mesh's label sum, with
the bytes it reduced), printed by `classify --profile` and read by
`chip_smoke.py`.  Timers are host clocks: `dispatch` measures the enqueue
of a batch's H2D copies and kernel launches, and `device_wait` the blocking
D2H fetch of its results, which is where device time shows on the host.
`all_reduce` is the host time of the call: the whole reduce under gloo
(CUDA tensors staged through the host), the enqueue under NCCL.

`trace(trace_dir)` captures a run with `torch.profiler` (`classify
--trace-dir DIR`) and writes it to DIR as a Chrome trace
(`<host>_<pid>.<ms>.pt.trace.json`): the host's operator calls and, on a
CUDA device, every kernel with its device time.  In a process that has
run on the card for a while, a profiler session mostly drops its first
kernels, a count that grows with the process's age (on an H100 about
one kernel for each 13 s of age: 41 after nine minutes) and does not
shrink when the device idles after the window opens or between the
first kernel and the rest; a second burst in the same session is kept
(chip_trace_probe.py, PERF.md §6).  So on CUDA `trace` first runs
TRACE_WARMUP small kernels of its own, waits for them and idles
TRACE_LEAD_S before the block: the dropped kernels are the warm-up's,
which the trace shows as `add_` kernels ahead of the run's.  A limit
remains: now and then a session loses all of its kernels, or a span at
its end, while every launch call is recorded (cause not found, PERF.md
§7).  Trace from a fresh process, as `classify --trace-dir` does.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

TRACE_WARMUP = 512  # kernels a CUDA trace runs before its block: more
# than a session drops in a process two hours old
TRACE_LEAD_S = 0.05  # the wait between the warm-up and the block


class Phases:
    """Accumulating phase timers; updated from the engine's pipeline
    threads (dispatch worker, fetch pool), so accumulation is locked."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.nbytes: dict[str, int] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str, nbytes: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0, nbytes)

    def add(self, name: str, seconds: float, nbytes: int = 0):
        with self._lock:
            self.totals[name] = self.totals.get(name, 0.0) + seconds
            self.counts[name] = self.counts.get(name, 0) + 1
            if nbytes:
                self.nbytes[name] = self.nbytes.get(name, 0) + nbytes

    def summary(self) -> str:
        lines = ["phase            total_s   calls   avg_ms"]
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<16} {tot:8.3f} {n:7d} {1000*tot/n:8.2f}")
        return "\n".join(lines)


# engine-global collector; re-assigned per run when profiling is enabled
current: Phases | None = None


@contextlib.contextmanager
def collect():
    global current
    prev = current
    current = Phases()
    try:
        yield current
    finally:
        current = prev


@contextlib.contextmanager
def maybe_phase(name: str, nbytes: int = 0):
    if current is None:
        yield
    else:
        with current.phase(name, nbytes):
            yield


@contextlib.contextmanager
def trace(trace_dir: str | None, cuda: bool = False):
    """Trace the block with torch.profiler into trace_dir (created where
    missing): CPU activity, plus CUDA activity where `cuda` is set, with
    TRACE_WARMUP kernels on the current device and TRACE_LEAD_S of idle
    before the block, and the device synchronized after it.  A no-op
    where trace_dir is empty."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(trace_dir)):
        if cuda:
            w = torch.zeros(1, device="cuda")
            for _ in range(TRACE_WARMUP):
                w.add_(1)
            torch.cuda.synchronize()
            time.sleep(TRACE_LEAD_S)
        yield
        if cuda:
            torch.cuda.synchronize()
