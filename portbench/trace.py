"""The device trace of a run's window, and what is read from it.

A CUDA profiler session can lose the first kernels it should record, more
of them the longer after the process's first session it opens, and now and
then its last ones.  So the window is traced as the program's own sessions
are: WARMUP small kernels and LEAD_S of idle before it, the device
synchronised after it, then MARKERS closing kernels; `check` then matches
every kernel launch call to its kernel by correlation id.  The session is
whole where the last warm-up kernel, every kernel of the window and every
closing marker are in the trace.

From the window's device events (kernels, copies, memsets, clipped to the
window's span) come the busy time as the union of their intervals (streams
that overlap count once), the kernels' summed device time, the device
operations that took most time, and the longest idle gaps, each named by
the host events the profiler recorded across it.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np

WARMUP = 512  # warm-up kernels before the window
LEAD_S = 0.05  # idle between the warm-up and the window
MARKERS = 32  # closing marker kernels after it
WINDOW_SPAN = "portbench.window"  # the harness's own span around the window
_LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel")
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
         "python_function")


@contextlib.contextmanager
def session(path: str, device):
    """Profile the block on `device` and write its Chrome trace to `path`;
    yields a dict that, once the block ends, holds `events` and check's
    verdict."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rec: dict = {}
    w = torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(WARMUP):
            w.add_(1)
        torch.cuda.synchronize(device)
        time.sleep(LEAD_S)
        yield rec
        torch.cuda.synchronize(device)
        for _ in range(MARKERS):
            w.add_(1)
        torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    rec.update(check(events), events=events)


def check(events: list, warmup: int = WARMUP, markers: int = MARKERS) -> dict:
    """whole, launched, kept, lost_first, lost_last, markers_lost and
    warmup_kept of a session's events (see the module's docstring)."""
    calls = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                    and e.get("name", "").startswith(_LAUNCH)),
                   key=lambda e: e["ts"])
    ids = [e["args"]["correlation"] for e in calls]
    kept = {e["args"].get("correlation") for e in events
            if e.get("cat") == "kernel"}
    if len(ids) < warmup + markers:
        return dict(whole=False, launched=0, kept=0, lost_first=0,
                    lost_last=0, markers_lost=markers, warmup_kept=False)
    block = ids[warmup:len(ids) - markers]
    at = [i for i, c in enumerate(block) if c in kept]
    warmup_kept = warmup == 0 or ids[warmup - 1] in kept
    markers_lost = sum(c not in kept for c in ids[len(ids) - markers:])
    return dict(whole=warmup_kept and not markers_lost
                and len(at) == len(block),
                launched=len(block), kept=len(at),
                lost_first=at[0] if at else len(block),
                lost_last=len(block) - 1 - at[-1] if at else 0,
                markers_lost=markers_lost, warmup_kept=warmup_kept)


def window_span(events: list) -> tuple[float, float]:
    """(start, end) in microseconds of the harness's window span."""
    for e in events:
        if e.get("name") == WINDOW_SPAN and e.get("ph") == "X":
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    raise ValueError(f"no {WINDOW_SPAN} span in the trace")


def union(intervals: np.ndarray) -> np.ndarray:
    """Merged [start, end] intervals of an [n, 2] array, in order."""
    if not len(intervals):
        return np.zeros((0, 2))
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    end = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > end[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, len(iv) - 1)
    return np.stack([iv[first, 0], end[last]], axis=1)


def gaps(busy: np.ndarray, t0: float, t1: float) -> np.ndarray:
    """The idle [start, end] intervals of [t0, t1] between merged busy
    intervals."""
    edges = np.concatenate([[t0], busy.reshape(-1), [t1]]).reshape(-1, 2)
    return edges[edges[:, 1] > edges[:, 0]]


def summary(events: list, top: int = 10) -> dict:
    """What the window's trace gives: window_s, busy_s (the union of device
    intervals), kernel_s (kernels' summed device time), kernels (their
    count), device_ops and idle_gaps (the breakdown's lists)."""
    t0, t1 = window_span(events)
    dev = [e for e in events if e.get("cat") in _DEVICE
           and e.get("ph") == "X"]
    iv = np.array([[float(e["ts"]), float(e["ts"]) + float(e["dur"])]
                   for e in dev]).reshape(-1, 2)
    iv = np.clip(iv, t0, t1)
    inside = iv[:, 1] > iv[:, 0]
    busy = union(iv[inside])
    by_name: dict = {}
    kernel_us, kernels = 0.0, 0
    for e, (a, b), ok in zip(dev, iv, inside):
        if not ok:
            continue
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a)
        if e["cat"] == "kernel":
            kernel_us += b - a
            kernels += 1
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = gaps(busy, t0, t1)
    idle = idle[np.argsort(idle[:, 0] - idle[:, 1], kind="stable")][:top]
    return dict(window_s=(t1 - t0) / 1e6,
                busy_s=float((busy[:, 1] - busy[:, 0]).sum()) / 1e6,
                kernel_s=kernel_us / 1e6, kernels=kernels,
                device_ops=[[n, s / 1e6] for n, s in ops],
                idle_gaps=[[gap_name(events, a, b), (b - a) / 1e6]
                           for a, b in idle])


def gap_name(events: list, a: float, b: float, most: int = 3) -> str:
    """The names of the host events with the most overlap with [a, b],
    joined by ' + ', or 'no host event'."""
    over: dict = {}
    for e in events:
        if e.get("cat") not in _HOST or e.get("ph") != "X" or e.get(
                "name", "").startswith("portbench."):
            continue
        lap = min(b, e["ts"] + e["dur"]) - max(a, e["ts"])
        if lap > 0:
            over[e["name"]] = over.get(e["name"], 0.0) + lap
    names = sorted(over, key=lambda n: -over[n])[:most]
    return " + ".join(names) if names else "no host event"
