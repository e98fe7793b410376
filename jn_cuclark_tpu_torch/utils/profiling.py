"""Phase timers and profiler spans for the engine hot path.

`Phases` accumulates wall seconds per named phase, printed by `classify
--profile` and read by `chip_smoke.py` and the benchmark.  Timers are host
clocks: `dispatch` measures the enqueue of a batch's H2D copies and kernel
launches, and `device_wait` the blocking D2H fetch of its results, which
is where device time shows on the host.  `all_reduce` is the host time of
the call: the whole reduce under gloo (CUDA tensors staged through the
host), the enqueue under NCCL.

While a collector is active (`collect()`, `current` set), every phase is
also a `torch.profiler.record_function` span named `clark.<phase>`, from
whichever engine thread runs it, so a trace lines each span up with the
device's events on one clock.  With no collector nothing is recorded and
no torch call is made.  The phases of a classify call, by thread:

- scan thread (`engine._ScanStream`): `scan_cut`, the record-cut search
  of a chunk; `scan`, its native record scan.
- dispatch worker (`engine._pipelined`): `scan_wait`, the planner waiting
  for the scan (starved); `pack`; `dispatch`; `queue_full`, a dispatched
  batch waiting for room in the bounded queue (blocked).
- fetch workers (`engine._pipelined_pool`): `device_wait`.
- the caller: `count_reads`, `classify_bytes`'s serial read count;
  `batch_wait`, waiting for a dispatched batch; `fetch_wait`, waiting for
  a fetch; `format`, the native format and the caller's own time with
  the rows; `rows_held`, inside `format`, from each yield of a row chunk
  until the caller asks for the next.
- `fill` and `drain` (`Edges`), totals with no span, as they cross
  threads: a call's start until its first batch is dispatched, and its
  last batch's dispatch until its last row chunk is taken.

`trace(trace_dir)` captures a run with `torch.profiler` (`classify
--trace-dir DIR`) and writes it to DIR as a Chrome trace
(`<host>_<pid>.<ms>.pt.trace.json`): the host's operator calls and the
`clark.*` spans of every thread (it opens a collector where none is
active) and, on a CUDA device, every kernel with its device time.

A profiler session on the card can lose kernels, in torch.profiler's own
stack: a session of torch alone loses them too (chip_trace_probe.py
--repro, PERF.md §6).  A session mostly drops its first kernels, by
count, a count that grows with the seconds since the process's first
profiler session (on an H100 about one kernel for each 13 s: 43 at nine
minutes), not with the process's age, the kernels it launched before or
the sessions it opened before; idle after the window opens does not
shield them, and a second burst in the same session is kept.  The lost
kernels are absent from the trace, not there under another correlation
id (`check_session`'s kernel_events and unmatched).  Now and then a
session loses all of its kernels, or a span at its end, while every
launch call is recorded.  So every CUDA session of the port goes
through `cuda_session`: it runs TRACE_WARMUP small kernels of its own,
waits for them and idles TRACE_LEAD_S before the block (the dropped
first kernels are the warm-up's, which a trace shows as `add_` kernels
ahead of the run's), and after the block TRACE_MARKERS closing markers,
the same `add_`.  Once the session ends `check_session` matches each
launch call to its kernel by correlation id: a session is whole where
the last warm-up kernel, every kernel of the block and every closing
marker are there.  `trace` writes a partial trace all the same and says
on stderr how many kernels it lost; chip_smoke.py's kernel times retake a
session that is not whole.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import sys
import threading
import time

TRACE_WARMUP = 512  # kernels a CUDA trace runs before its block: more
# than a session drops 1.8 hours after the process's first session
TRACE_LEAD_S = 0.05  # the wait between the warm-up and the block
TRACE_MARKERS = 32  # closing marker kernels a CUDA session runs after it
# the host calls that launch a kernel, by the prefix of their trace name
_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")


class Phases:
    """Accumulating phase timers; updated from the engine's pipeline
    threads (scan thread, dispatch worker, fetch pool), so accumulation is
    locked."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.nbytes: dict[str, int] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str, nbytes: int = 0):
        """Time the block as `name`, inside a `clark.<name>` span."""
        from torch.profiler import record_function

        with record_function("clark." + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.add(name, time.perf_counter() - t0, nbytes)

    def watch(self, name: str):
        """Record `name` as watched, at 0 s and 0 calls where it has no
        total yet: a wait that never happened reads 0, not missing."""
        with self._lock:
            self.totals.setdefault(name, 0.0)
            self.counts.setdefault(name, 0)

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
            lines.append(f"{name:<16} {tot:8.3f} {n:7d} "
                         f"{1000 * tot / max(n, 1):8.2f}")
        return "\n".join(lines)


class Edges:
    """A classify call's fill and drain, added to `phases` as totals:
    `fill` from the call's start `t0` until its first batch's dispatch
    returns, `drain` from its last batch's dispatch returning until its
    last row chunk is taken.  `dispatched` runs in the dispatch worker,
    `taken` and `close` in the caller, after the worker is joined."""

    def __init__(self, phases: Phases, t0: float):
        self.phases, self.t0 = phases, t0
        self.last_dispatch = self.last_taken = None

    def dispatched(self):
        t = time.perf_counter()
        if self.last_dispatch is None:
            self.phases.add("fill", t - self.t0)
        self.last_dispatch = t

    def taken(self):
        self.last_taken = time.perf_counter()

    def close(self):
        if self.last_dispatch is not None:  # then a chunk was taken too
            self.phases.add("drain", self.last_taken - self.last_dispatch)


# engine-global collector; re-assigned per run when profiling is enabled
current: Phases | None = None
_NO_SPAN = contextlib.nullcontext()  # reusable: it keeps no state


@contextlib.contextmanager
def collect():
    global current
    prev = current
    current = Phases()
    try:
        yield current
    finally:
        current = prev


def maybe_phase(name: str, nbytes: int = 0):
    """The active collector's phase `name`, else a context that does
    nothing."""
    return _NO_SPAN if current is None else current.phase(name, nbytes)


def maybe_wait(name: str | None, waits):
    """maybe_phase(name) for a wait, where a collector is active and `name`
    is given (else nothing is recorded and `waits` is not called): the
    block is phase `name` where `waits()` says it is about to wait, and a
    wait that does not happen adds no span and no seconds (Phases.watch)."""
    if current is None or name is None:
        return _NO_SPAN
    if not waits():
        current.watch(name)
        return _NO_SPAN
    return current.phase(name)


def edges(t0: float) -> Edges | None:
    """An Edges on the active collector for a call started at `t0`
    (time.perf_counter), or None with no collector."""
    return None if current is None else Edges(current, t0)


def _launch_calls(events: list) -> list:
    """A Chrome trace's kernel launch calls, in host order."""
    return sorted((e for e in events if e.get("cat") == "cuda_runtime"
                   and e.get("name", "").startswith(_LAUNCH_CALLS)),
                  key=lambda e: e["ts"])


def launches(events: list) -> list:
    """The correlation ids of a Chrome trace's kernel launch calls, in
    host order."""
    return [e["args"]["correlation"] for e in _launch_calls(events)]


def kept_kernels(events: list) -> set:
    """The correlation ids of a Chrome trace's kernel events."""
    return {e["args"].get("correlation") for e in events
            if e.get("cat") == "kernel"}


def kernel_names(events: list) -> dict:
    """{kernel name: its kernel events} of a Chrome trace: the kernels
    counted by name, whatever their correlation ids."""
    out: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def unmatched_kernels(events: list) -> int:
    """A Chrome trace's kernel events whose correlation id is no launch
    call's: kernels that reached the trace under a wrong id."""
    ids = set(launches(events))
    return sum(e["args"].get("correlation") not in ids for e in events
               if e.get("cat") == "kernel")


def span_kept(launched: list, kept: set) -> dict:
    """Of the kernels of the launches `launched` (correlation ids in host
    order): how many reached the trace (`kept`), and how many launches
    before the first kept one and after the last were lost."""
    at = [i for i, c in enumerate(launched) if c in kept]
    return dict(kept=len(at), lost_first=at[0] if at else len(launched),
                lost_last=len(launched) - 1 - at[-1] if at else 0)


def check_session(events: list, warmup: int = TRACE_WARMUP,
                  markers: int = TRACE_MARKERS) -> dict:
    """Whether a `cuda_session`'s Chrome trace events are whole: its
    launches are `warmup` warm-up kernels, the block's, then `markers`
    closing markers.  Returns whole (the last warm-up kernel, every kernel
    of the block and every marker kept), warmup_kept (the last warm-up
    kernel's), markers_lost, and of the block: launched, kept, lost_first
    and lost_last (span_kept); and of the whole session, kernels counted
    by name against its launch calls: kernel_events (every kernel event)
    and unmatched (those whose correlation id is no launch's).  A kernel
    lost by its id alone shows as unmatched; one that never reached the
    trace, as fewer kernel_events than launch calls."""
    ids = launches(events)
    kept = kept_kernels(events)
    tally = dict(kernel_events=sum(kernel_names(events).values()),
                 unmatched=unmatched_kernels(events))
    if len(ids) < warmup + markers:  # launch calls missing: nothing holds
        return dict(whole=False, warmup_kept=False, markers_lost=markers,
                    launched=0, kept=0, lost_first=0, lost_last=0, **tally)
    block = ids[warmup:len(ids) - markers]
    span = span_kept(block, kept)
    warmup_kept = warmup == 0 or ids[warmup - 1] in kept
    markers_lost = sum(c not in kept for c in ids[len(ids) - markers:])
    return dict(whole=warmup_kept and not markers_lost
                and span["kept"] == len(block),
                warmup_kept=warmup_kept, markers_lost=markers_lost,
                launched=len(block), **span, **tally)


def block_events(events: list, warmup: int = TRACE_WARMUP,
                 markers: int = TRACE_MARKERS) -> list:
    """The device events (kernels, memsets, copies) of a `cuda_session`'s
    block: those of the host calls made between its last warm-up launch
    and its first closing marker."""
    calls = _launch_calls(events)
    if len(calls) < warmup + markers:
        return []
    t0 = calls[warmup - 1]["ts"] if warmup else float("-inf")
    t1 = calls[len(calls) - markers]["ts"] if markers else float("inf")
    ids = {e["args"].get("correlation") for e in events
           if e.get("cat") == "cuda_runtime" and t0 < e["ts"] < t1}
    return [e for e in events if e.get("cat") in (
        "kernel", "gpu_memset", "gpu_memcpy")
        and e["args"].get("correlation") in ids]


@contextlib.contextmanager
def cuda_session(path: str, device=None):
    """Profile the block on a CUDA device with torch.profiler (CPU and
    CUDA activity, every thread's host events) and write its Chrome trace
    to `path`: TRACE_WARMUP `add_` kernels and TRACE_LEAD_S of idle before
    the block, the device synchronised after it, then TRACE_MARKERS closing
    markers.  Yields a dict that, once the block and the session end, holds
    check_session's verdict and the trace's `events`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rec: dict = {}
    # made before the session opens, on the current device by default
    w = torch.zeros(1, device="cuda" if device is None else device)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=_all_threads()) as prof:
        for _ in range(TRACE_WARMUP):
            w.add_(1)
        torch.cuda.synchronize(device)
        time.sleep(TRACE_LEAD_S)
        yield rec
        torch.cuda.synchronize(device)
        for _ in range(TRACE_MARKERS):
            w.add_(1)
        torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    rec.update(check_session(events), events=events)


def _all_threads():
    """The profiler's option that records host events (CPU ops and
    `record_function` spans) from every thread, not only the one that
    opened the session."""
    from torch.profiler import _ExperimentalConfig

    return _ExperimentalConfig(profile_all_threads=True)


@contextlib.contextmanager
def trace(trace_dir: str | None, cuda: bool = False):
    """Trace the block with torch.profiler into trace_dir (created where
    missing) as `<host>_<pid>.<ms>.pt.trace.json`: every thread's CPU
    activity and `clark.*` spans (under a collector of its own where none
    is active), or through `cuda_session` where `cuda` is set, on the
    current device.  Yields a dict, filled on a CUDA session's end with
    check_session's verdict; a session that is not whole still writes its
    trace and says on stderr what it lost.  A no-op where trace_dir is
    empty."""
    rec: dict = {}
    if not trace_dir:
        yield rec
        return
    if current is None:
        with collect(), trace(trace_dir, cuda) as rec:
            yield rec
        return
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{socket.gethostname()}_{os.getpid()}."
                        f"{int(time.time() * 1000)}.pt.trace.json")
    if cuda:
        with cuda_session(path) as rec:
            yield rec
        if not rec["whole"]:
            print(f"trace: the profiler lost kernels ({rec['kept']} of the "
                  f"run's {rec['launched']} kept, {rec['markers_lost']} of "
                  f"{TRACE_MARKERS} closing markers lost, the last warm-up "
                  f"kernel {'kept' if rec['warmup_kept'] else 'lost'}, "
                  f"{rec['unmatched']} kernels under no launch's id): "
                  f"{path} is partial", file=sys.stderr)
        rec.pop("events")
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_all_threads()) as prof:
        yield rec
    prof.export_chrome_trace(path)
