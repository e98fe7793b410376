"""The whole-pass rate, the roofline floor, the trace's arithmetic and the
readers, on hand-made inputs and on a small trace recorded on the card."""

import gzip
import json
import os
import time
import types

import numpy as np
import pytest

from portbench import roofline, run, spec
from portbench import trace as tracing

DATA = os.path.join(os.path.dirname(__file__), "data")


class _Clf:
    """Yields `rows` rows a pass, each pass taking `pass_s`."""

    def __init__(self, rows, pass_s):
        self.rows, self.pass_s, self.calls = rows, pass_s, 0

    def classify_bytes(self, data):
        self.calls += 1

        def gen():
            time.sleep(self.pass_s)
            yield b"r,0,NA,0,0\n" * self.rows
        return gen(), self.rows


def test_the_window_runs_whole_passes():
    clf = _Clf(rows=1000, pass_s=0.04)
    win = run.window(clf, b">r\nA\n", 0.1, False)
    assert win.passes == clf.calls == 3  # the third pass crosses 0.1 s
    assert win.first.count(b"\n") == 1000 and win.phases is None
    assert win.unlike == []
    assert 0.12 <= win.seconds < 0.5
    ctx = types.SimpleNamespace(rows=3000, window_s=win.seconds)
    assert spec.reader("reads_per_s")(ctx) == pytest.approx(
        3000 / win.seconds)


def test_a_pass_is_compared_with_the_first_as_it_comes():
    first = [b"a,1\nb,2\n", b"c,3\n", b""]
    assert run.drain(iter(first), first) is None
    # the same bytes in other chunks
    assert run.drain(iter([b"a,1\n", b"b,2\nc", b",3\n"]), first) is None
    assert run.drain(iter([b"a,1\nb,2\nc,3\n"]), first) is None
    # unlike: each pass's own rows are counted
    assert run.drain(iter([b"a,1\nb,9\n", b"c,3\n"]), first) == 3
    assert run.drain(iter([b"a,1\nb,2\n"]), first) == 2  # ended short
    assert run.drain(iter([b"a,1\nb,2\n", b"c,3\nd,4\n"]), first) == 4
    assert run.drain(iter([]), first) == 0


def test_floor_bytes_and_share():
    # 2-bit bases, 16 B a read, the keys (10 B each) where fewer than the
    # 32-B sectors of the distinct k-mers queried
    assert roofline.floor_bytes(bases=400, reads=10, keys=7, queried=100) \
        == 100 + 160 + 70
    assert roofline.floor_bytes(bases=400, reads=10, keys=70, queried=2) \
        == 100 + 160 + 64
    kind = "NVIDIA H100 80GB HBM3"
    assert roofline.share_pct(3.35e9, 0.01, kind) == pytest.approx(10.0)
    assert roofline.share_pct(1.0, 1.0, "another card") is None
    assert roofline.share_pct(1.0, 0.0, kind) is None


def test_union_counts_overlapping_streams_once():
    iv = np.array([[5, 7], [0, 2], [1, 3], [6, 6.5], [10, 11]], float)
    u = tracing.union(iv)
    assert u.tolist() == [[0, 3], [5, 7], [10, 11]]
    assert tracing.gaps(u, 0, 12).tolist() == [[3, 5], [7, 10], [11, 12]]
    assert tracing.gaps(tracing.union(np.zeros((0, 2))), 0, 1).tolist() \
        == [[0, 1]]


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def _session(block_kernels, lose=()):
    """A cuda session's events: 3 warm-up kernels, the window span over
    the block, 2 markers; each launch call and its kernel correlated."""
    ev, c, t = [], 0, 0.0
    launched = [("add_", 1.0)] * 3 + block_kernels + [("add_", 1.0)] * 2
    for i, (name, dur) in enumerate(launched):
        c += 1
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", t, 1, correlation=c))
        if i not in lose:
            ev.append(_x("kernel", name, t + 2, dur, correlation=c))
        t += 10
    ev.append(_x("user_annotation", tracing.WINDOW_SPAN, 25, 10 *
                 len(block_kernels)))
    return ev


def test_check_finds_a_lost_kernel():
    ev = _session([("k1", 3.0), ("k2", 4.0)])
    assert tracing.check(ev, warmup=3, markers=2)["whole"]
    lost = tracing.check(_session([("k1", 3.0), ("k2", 4.0)], lose={3}),
                         warmup=3, markers=2)
    assert not lost["whole"] and lost["lost_first"] == 1
    marker = tracing.check(_session([("k1", 3.0)], lose={4}), warmup=3,
                           markers=2)
    assert not marker["whole"] and marker["markers_lost"] == 1


def test_summary_of_a_hand_made_trace():
    ev = [_x("user_annotation", tracing.WINDOW_SPAN, 0, 100),
          _x("kernel", "probe", 10, 20),
          _x("kernel", "top2", 25, 10),  # overlaps probe on another stream
          _x("gpu_memcpy", "Memcpy HtoD", 50, 5),
          _x("kernel", "probe", 95, 10),  # runs past the window's end
          _x("cpu_op", "aten::copy_", 60, 30),
          _x("cuda_runtime", "cudaStreamSynchronize", 62, 20)]
    s = tracing.summary(ev)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((25 + 5 + 5) * 1e-6)
    assert s["kernel_s"] == pytest.approx((20 + 10 + 5) * 1e-6)
    assert s["kernels"] == 3
    assert s["device_ops"][0] == ["probe", pytest.approx(25e-6)]
    gaps = s["idle_gaps"]
    assert [g[1] for g in gaps] == pytest.approx([40e-6, 15e-6, 10e-6])
    assert gaps[0][0] == "aten::copy_ + cudaStreamSynchronize"
    assert gaps[1][0] == "no host event"


def test_a_small_trace_recorded_on_the_card():
    with gzip.open(os.path.join(DATA, "small_trace.json.gz"), "rt") as f:
        rec = json.load(f)
    s = tracing.summary(rec["traceEvents"])
    want = rec["summary"]
    assert tracing.check(rec["traceEvents"]) == rec["check"]
    assert rec["check"]["whole"]
    for key in ("window_s", "busy_s", "kernel_s", "kernels"):
        assert s[key] == pytest.approx(want[key])
    assert 0 < s["busy_s"] < s["window_s"] and s["kernels"] > 0
    assert s["device_ops"] == [[n, pytest.approx(v)]
                               for n, v in want["device_ops"]]
    assert len(s["idle_gaps"]) == 10


def test_readers_read_what_is_there_and_nothing_else():
    ctx = types.SimpleNamespace(
        rows=2_000_000, passes=2, window_s=4.0, peak_bytes=3 * 2**29,
        setup={"setup_s": 40.0, "db_build_s": 5.0, "load_s": 26.0},
        phases={"scan": 0.5, "pack": 0.4, "device_wait": 0.1,
                "format": 1.0},
        trace={"window_s": 4.0, "busy_s": 0.2, "kernel_s": 0.06,
               "kernels": 900},
        kind="NVIDIA H100 80GB HBM3", floor_bytes=3.35e8)
    want = {"reads_per_s": 500_000.0, "setup_s": 40.0,
            "device_peak_gib": 1.5, "db_build_s": 5.0, "load_s": 26.0,
            "scan_s_per_mread": 0.25, "pack_s_per_mread": 0.2,
            "device_wait_s_per_mread": 0.05, "format_s_per_mread": 0.5,
            "kernel_ms_per_mread": 30.0, "device_idle_pct": 95.0,
            "kernels_roofline": 100 * 2 * 1e-4 / 0.06}
    bench = spec.load()
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert sorted(names) == sorted(want)
    for name, value in want.items():
        assert spec.reader(name)(ctx) == pytest.approx(value), name
    empty = types.SimpleNamespace(
        rows=0, passes=0, window_s=0.0, peak_bytes=None, setup={},
        phases=None, trace=None, kind="cpu", floor_bytes=None)
    for name in names:
        if name not in ("setup_s", "db_build_s", "load_s"):
            assert spec.reader(name)(empty) is None, name

