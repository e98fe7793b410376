"""Where a torch.profiler session on the card loses kernels, and what the
loss follows.  Run from the repo root on a machine with a CUDA device:

    python3 chip_trace_probe.py [GAP_S] [SESSIONS] [--idle S] [--launch N]
    python3 chip_trace_probe.py [GAP_S] [SESSIONS] --repro [--idle S] [--launch N]

Every GAP_S seconds (default 28) for SESSIONS sessions (default 20) it
traces a burst of 200 small kernels five ways: a bare session ("bare"),
one that idles 50 ms after its window opens ("lead"), one with a first
burst, 50 ms of idle, then the burst ("two"), one with a single kernel
and 50 ms of idle first ("warm1"), and `profiling.trace` with its
warm-up and closing markers ("trace").  Before the first session it
idles S seconds (--idle) or launches N small kernels outside any
profiler session (--launch), so that a process's age, the profiler
sessions it opened before and the kernels it launched before can be
varied apart.  Prints one JSON line of set-up, then one a session: the
process's age in seconds from its first kernel ("s"), the seconds since
its first session opened ("since_first") and, for each way, [kernels kept,
launches lost before the first kept, launches lost after the last] of the
burst matched by correlation id, then the session's kernel events counted
by name (every kernel of these sessions is the same `add_`) and those
whose correlation id is no launch call's (for "two" the burst's entries
are the second burst's, "two_both" both bursts'; "trace" has a fourth
entry, whether profiling.check_session found the session whole, and
"trace_check", its closing markers lost, whether its last warm-up kernel
was kept, its kernel events and unmatched ones).  A kernel that reached
the trace under a wrong id counts among the kernel events but not among
the kept; one that never reached it, in neither.

--repro runs `repro`, the bare way alone in code that imports nothing but
torch and the standard library: the fault's reproducer.  Its rows: age,
launch calls, kernel events, those matched to a launch, launches lost
before the first matched.  Exits 1 without a CUDA device."""

import argparse
import json
import os
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

WAYS = ("bare", "lead", "two", "warm1", "trace")
BURST = 200  # kernels a session's burst launches (chip_smoke.TRACE_BURST)


def repro(gap: float, n: int, idle: float, launch: int):
    """A bare torch.profiler session around 200 `add_` kernels every gap
    seconds, n times, after `idle` seconds or `launch` kernels."""
    x = torch.zeros(1024, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(launch):
        x.add_(1)
    torch.cuda.synchronize()
    time.sleep(idle)
    with tempfile.TemporaryDirectory() as td:
        for i in range(n):
            age = time.time() - t0
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as p:
                for _ in range(BURST):
                    x.add_(1)
                torch.cuda.synchronize()
            p.export_chrome_trace(os.path.join(td, f"{i}.json"))
            with open(os.path.join(td, f"{i}.json")) as f:
                ev = json.load(f)["traceEvents"]
            calls = sorted((e for e in ev if e.get("cat") == "cuda_runtime"
                            and e["name"].startswith("cudaLaunchKernel")),
                           key=lambda e: e["ts"])
            ids = [e["args"]["correlation"] for e in calls]
            kern = {e["args"].get("correlation") for e in ev
                    if e.get("cat") == "kernel"}
            n_kern = sum(e.get("cat") == "kernel" for e in ev)
            hit = [j for j, c in enumerate(ids) if c in kern]
            print(json.dumps(dict(
                s=round(age, 1), launches=len(ids), kernels=n_kern,
                matched=len(hit), lost_first=hit[0] if hit else len(ids))),
                flush=True)
            time.sleep(gap)


def session(x, way: str, out: str) -> dict | None:
    """One session of `way` into the directory out; profiling.trace's
    check for "trace"."""
    from jn_cuclark_tpu_torch.utils import profiling

    def burst():
        for _ in range(BURST):
            x.add_(1)

    if way == "trace":
        with profiling.trace(out, cuda=True) as rec:
            burst()
        return rec
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        if way == "warm1":
            x[:1].add_(1)
        if way == "two":
            burst()
        if way in ("lead", "two", "warm1"):
            torch.cuda.synchronize()
            time.sleep(profiling.TRACE_LEAD_S)
        burst()
        torch.cuda.synchronize()
    p.export_chrome_trace(os.path.join(out, "t.json"))


def probe(gap: float, n: int, idle: float, launch: int):
    """The five ways every gap seconds, n times, after `idle` seconds or
    `launch` kernels; one JSON line a session."""
    from chip_smoke import _burst_kept, _trace_events
    from jn_cuclark_tpu_torch.utils import profiling

    x = torch.zeros(1024, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(launch):
        x.add_(1)
    torch.cuda.synchronize()
    print(json.dumps(dict(gap_s=gap, sessions=n, idle_s=idle,
                          launched_before=launch,
                          setup_s=round(time.time() - t0, 1))), flush=True)
    time.sleep(idle)
    first = None
    with tempfile.TemporaryDirectory() as td:
        for i in range(n):
            now = time.time()
            first = now if first is None else first
            row = {"s": round(now - t0, 1),
                   "since_first": round(now - first, 1)}
            for way in WAYS:
                out = os.path.join(td, f"{i}_{way}")
                os.makedirs(out)
                rec = session(x, way, out)
                if way == "trace":  # the burst lies before the markers
                    row[way] = [rec["kept"], rec["lost_first"],
                                rec["lost_last"], rec["whole"]]
                    row["trace_check"] = [rec["markers_lost"],
                                          rec["warmup_kept"],
                                          rec["kernel_events"],
                                          rec["unmatched"]]
                    continue
                events = _trace_events(out)
                named = [sum(profiling.kernel_names(events).values()),
                         profiling.unmatched_kernels(events)]
                k = _burst_kept(out, BURST)
                row[way] = [k["kept"], k["lost_first"], k["lost_last"],
                            *named]
                if way == "two":
                    k = _burst_kept(out, 2 * BURST)
                    row["two_both"] = [k["kept"], k["lost_first"],
                                       k["lost_last"], *named]
                if i == 0 and way == "bare":
                    row["names"] = profiling.kernel_names(events)
            print(json.dumps(row), flush=True)
            time.sleep(gap)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("gap", nargs="?", type=float, default=28.0,
                    help="seconds between sessions")
    ap.add_argument("sessions", nargs="?", type=int, default=20)
    ap.add_argument("--idle", type=float, default=0.0,
                    help="seconds idled before the first session")
    ap.add_argument("--launch", type=int, default=0,
                    help="small kernels launched, outside any profiler "
                    "session, before the first session")
    ap.add_argument("--repro", action="store_true",
                    help="the torch-only reproducer (bare sessions)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_trace_probe: no CUDA device", file=sys.stderr)
        return 1
    (repro if a.repro else probe)(a.gap, a.sessions, a.idle, a.launch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
