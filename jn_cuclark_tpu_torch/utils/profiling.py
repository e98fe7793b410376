"""Phase timers for the engine hot path.

`Phases` accumulates wall seconds per named phase (scan / pack / dispatch /
device_wait / format; all_reduce, a multi-process mesh's label sum, with
the bytes it reduced), printed by `classify --profile` and read by
`chip_smoke.py`.  Timers are host clocks: `dispatch` measures the enqueue
of a batch's H2D copies and kernel launches, and `device_wait` the blocking
D2H fetch of its results, which is where device time shows on the host.
`all_reduce` is the host time of the call: the whole reduce under gloo
(CUDA tensors staged through the host), the enqueue under NCCL.
"""

from __future__ import annotations

import contextlib
import threading
import time


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
