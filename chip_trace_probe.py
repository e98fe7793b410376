"""Where a torch.profiler session on the card loses kernels as a process
ages.  Run from the repo root on a machine with a CUDA device:

    python3 chip_trace_probe.py [GAP_S] [SESSIONS]

Every GAP_S seconds (default 28) for SESSIONS sessions (default 20) it
traces a burst of 200 small kernels five ways: a bare session ("bare"),
one that idles 50 ms after its window opens ("lead"), one with a first
burst, 50 ms of idle, then the burst ("two"), one with a single kernel
and 50 ms of idle first ("warm1"), and `profiling.trace` with its
warm-up and closing markers ("trace").  Prints one JSON line a session:
the process's age in seconds and, for each way, [kernels kept, launches
lost before the first kept, launches lost after the last] of the burst
(for "two" also of both bursts together, "two_both"; for "trace" a
fourth entry, whether profiling.check_session found the session whole,
and "trace_check", its closing markers lost and whether its last warm-up
kernel was kept).  Exits 1 without a CUDA device."""

import json
import os
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import TRACE_BURST, _burst_kept
from jn_cuclark_tpu_torch.utils import profiling

WAYS = ("bare", "lead", "two", "warm1", "trace")


def session(x, way: str, out: str) -> dict | None:
    """One session of `way` into the directory out; profiling.trace's
    check for "trace"."""
    def burst():
        for _ in range(TRACE_BURST):
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_trace_probe: no CUDA device", file=sys.stderr)
        return 1
    gap = float(sys.argv[1]) if len(sys.argv) > 1 else 28.0
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    x = torch.zeros(1024, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as td:
        for i in range(n):
            row = {"s": round(time.time() - t0, 1)}
            for way in WAYS:
                out = os.path.join(td, f"{i}_{way}")
                os.makedirs(out)
                rec = session(x, way, out)
                if way == "trace":  # the burst lies before the markers
                    row[way] = [rec["kept"], rec["lost_first"],
                                rec["lost_last"], rec["whole"]]
                    row["trace_check"] = [rec["markers_lost"],
                                          rec["warmup_kept"]]
                    continue
                k = _burst_kept(out)
                row[way] = [k["kept"], k["lost_first"], k["lost_last"]]
                if way == "two":
                    k = _burst_kept(out, 2 * TRACE_BURST)
                    row["two_both"] = [k["kept"], k["lost_first"],
                                       k["lost_last"]]
            print(json.dumps(row), flush=True)
            time.sleep(gap)
    return 0


if __name__ == "__main__":
    sys.exit(main())
