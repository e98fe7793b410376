"""The completeness check of a CUDA profiler session (utils/profiling.py:
`check_session`, `block_events`; chip_smoke.session_split, which times
phase 5's kernels from a session) on synthetic Chrome trace events: a
session is whole, loses only warm-up kernels (whole), loses its first
kernels past the warm-up, loses a span at its end, loses every kernel, or
lacks launch calls.  No device is needed: the events are made here, as
torch.profiler writes them (a `cuda_runtime` launch call and a `kernel`
event sharing a correlation id)."""

import pytest

import chip_smoke
from jn_cuclark_tpu_torch.utils import profiling

W, M = 8, 4  # warm-up kernels and closing markers of the synthetic sessions


def events(n_block: int, lost=(), warmup: int = W, markers: int = M,
           memset_at=None, relabelled=()):
    """A session's events: warmup + n_block + markers launches in host
    order (correlation ids 1, 2, ...), each with its kernel but those whose
    launch index is in `lost`; the kernels of the launch indices in
    `relabelled` under a correlation id no launch has; a memset call and
    its device event after block launch `memset_at`."""
    out = []
    names = (["warm"] * warmup + [f"k{i % 3}" for i in range(n_block)]
             + ["mark"] * markers)
    for i, name in enumerate(names):
        out.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                    "ts": 10 * i, "args": {"correlation": i + 1}})
        if i not in lost:
            c = i + 1 + (10_000 if i in relabelled else 0)
            out.append({"cat": "kernel", "name": f"{name}(int)",
                        "ts": 10 * i + 5, "dur": 2.0,
                        "args": {"correlation": c}})
        if memset_at is not None and i == warmup + memset_at:
            c = 1000 + i
            out.append({"cat": "cuda_runtime", "name": "cudaMemsetAsync",
                        "ts": 10 * i + 1, "args": {"correlation": c}})
            out.append({"cat": "gpu_memset", "name": "Memset (Device)",
                        "ts": 10 * i + 6, "dur": 1.0,
                        "args": {"correlation": c}})
    return out


N = 12  # block launches: 4 calls of 3 kernels
CASES = {
    # case: (launch indices lost, whole, warmup_kept, markers_lost, kept,
    # lost_first, lost_last)
    "whole": ((), True, True, 0, N, 0, 0),
    "warm-up kernels lost": (range(5), True, True, 0, N, 0, 0),
    "first kernels lost": (range(W + 2), False, False, 0, N - 2, 2, 0),
    "end span lost": (range(W + N - 3, W + N + M), False, True, M, N - 3, 0,
                      3),
    "a closing marker lost": ((W + N + 1,), False, True, 1, N, 0, 0),
    "all lost": (range(W + N + M), False, False, M, 0, N, 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_check_session(case):
    """Each case's verdict; its lost kernels never reached the trace, so
    the kernels counted by name are the launches less the lost, none
    under a wrong id."""
    lost, whole, warm, markers_lost, kept, first, last = CASES[case]
    got = profiling.check_session(events(N, set(lost)), warmup=W, markers=M)
    assert got == dict(whole=whole, warmup_kept=warm,
                       markers_lost=markers_lost, launched=N, kept=kept,
                       lost_first=first, lost_last=last,
                       kernel_events=W + N + M - len(set(lost)), unmatched=0)


@pytest.mark.parametrize("case", ["first kernels", "end span", "all"])
def test_check_session_tells_mislabelled_from_absent(case):
    """Kernels in the trace under a correlation id no launch has: lost by
    id as absent ones are (the same verdict, kept and spans), but counted
    by name: kernel_events holds every launch, unmatched the relabelled."""
    lost = {"first kernels": range(W + 2),
            "end span": range(W + N - 3, W + N + M),
            "all": range(W + N + M)}[case]
    absent = profiling.check_session(events(N, set(lost)), warmup=W,
                                     markers=M)
    got = profiling.check_session(events(N, relabelled=set(lost)),
                                  warmup=W, markers=M)
    assert {key: v for key, v in got.items() if key not in (
        "kernel_events", "unmatched")} == {
        key: v for key, v in absent.items() if key not in (
            "kernel_events", "unmatched")}
    assert (got["kernel_events"], got["unmatched"]) == (W + N + M, len(lost))
    assert absent["kernel_events"] + len(lost) == W + N + M


def test_kernel_names_and_unmatched():
    """kernel_names counts the kernel events of each name; unmatched_kernels
    those whose id is no launch call's."""
    ev = events(N, lost={0}, relabelled={W, W + 1})
    assert profiling.kernel_names(ev) == {
        "warm(int)": W - 1, "k0(int)": 4, "k1(int)": 4, "k2(int)": 4,
        "mark(int)": M}
    assert profiling.unmatched_kernels(ev) == 2
    assert profiling.kernel_names([]) == {}


def test_check_session_at_the_defaults():
    ev = events(5, warmup=profiling.TRACE_WARMUP,
                markers=profiling.TRACE_MARKERS)
    assert profiling.check_session(ev)["whole"]
    ev = events(5, {profiling.TRACE_WARMUP - 1},
                warmup=profiling.TRACE_WARMUP, markers=profiling.TRACE_MARKERS)
    assert not profiling.check_session(ev)["whole"]


def test_check_session_without_its_launch_calls():
    """A session whose launch calls are fewer than its warm-up and markers
    is not whole (nothing of it can be matched)."""
    ev = [e for e in events(N) if e["cat"] == "kernel"]
    got = profiling.check_session(ev, warmup=W, markers=M)
    assert got["whole"] is False and got["launched"] == 0


def test_block_events_and_session_split():
    """block_events keeps the block's kernels and memsets, not the warm-up
    or the markers; session_split gives each name's device ms a call, and
    None where the session is not whole or a name's events are no multiple
    of the calls."""
    ev = events(N, memset_at=4)
    blk = profiling.block_events(ev, warmup=W, markers=M)
    assert sorted({e["name"] for e in blk}) == [
        "Memset (Device)", "k0(int)", "k1(int)", "k2(int)"]
    assert len(blk) == N + 1
    # session_split reads a session at the defaults
    dw = dict(warmup=profiling.TRACE_WARMUP, markers=profiling.TRACE_MARKERS)

    def rec(*a, **kw):
        ev = events(N, *a, **dw, **kw)
        return dict(events=ev, **profiling.check_session(ev))

    assert chip_smoke.session_split(rec(), 4) == {
        "k0": 0.002, "k1": 0.002, "k2": 0.002}
    # a memset once in 4 calls: no multiple of the calls
    assert chip_smoke.session_split(rec(memset_at=4), 4) is None
    assert chip_smoke.session_split(rec(memset_at=4), 1) is not None
    # the block's last kernel lost
    assert chip_smoke.session_split(rec({dw["warmup"] + N - 1}), 4) is None


def test_trace_on_the_cpu_yields_a_record(tmp_path):
    """profiling.trace without CUDA writes one Chrome trace named as
    torch's tensorboard handler names it and yields an empty record; with
    no directory it traces nothing."""
    import torch

    with profiling.trace(str(tmp_path / "t"), cuda=False) as rec:
        torch.ones(8).sum()
    assert rec == {}
    (f,) = list((tmp_path / "t").iterdir())
    assert f.name.endswith(".pt.trace.json") and f.stat().st_size > 0
    with profiling.trace(None) as rec:
        pass
    assert rec == {}
