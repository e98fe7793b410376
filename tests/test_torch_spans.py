"""The engine's phase spans (utils/profiling.py) on the CPU: the waits
between the pipeline's threads, each call's fill and drain, the spans'
threads in a profiler trace, and that no collector means nothing recorded.

The pipeline's stages are held back here so that each wait happens on
every run, however loaded the machine: the first scanned chunk arrives late
(the planner and the caller wait for it), and the first fetches' copies to
the host wait until the dispatch worker holds a batch with the queue full
(the caller waits for a fetch, the worker for room)."""

import json
import os
import threading
import time

import pytest
import torch

from jn_cuclark_tpu_torch.engine import BatchPlan, Classifier
from jn_cuclark_tpu_torch.utils import native, profiling

from .test_torch_engine import GOLD, GOLDENS, golden_setup
from .test_torch_profiling import events as session_events

READS = os.path.join(GOLD, GOLDENS["fa"][5])  # 202 FASTA reads
WAITS = ("scan_wait", "queue_full", "batch_wait", "fetch_wait")
NEW = ("count_reads", "scan_cut", *WAITS, "rows_held", "fill", "drain")
CALLER = ("count_reads", "batch_wait", "fetch_wait", "format")  # disjoint;
# rows_held lies inside format, whose span holds the yield (as it always has)
FIRST_CHUNK_S = 0.05  # the first scanned chunk's delay
FULL = 4  # batches dispatched when the queue (1) and the fetches (2) are
# full and the worker holds the fourth
FULL_S = 0.2  # then the fetches wait this long more: the worker's put waits
HOLD_S = 0.005  # the caller's time with each row chunk


@pytest.fixture(scope="module")
def clf(tmp_path_factory):
    db, targets = golden_setup("fa", tmp_path_factory.mktemp("spans"))
    _, _, _, prof, k, _, _ = GOLDENS["fa"]
    # 16 reads a batch, ~1 KB scan chunks: 13 batches and 20 chunks
    c = Classifier.load(db, targets, prof, k, device="cpu",
                        plan=BatchPlan(max_reads=16, pipeline_depth=1,
                                       scan_chunk_bytes=1024))
    run_bytes(c, open(READS, "rb").read())  # the first call is slower
    return c


@pytest.fixture
def paced(clf, monkeypatch):
    """Hold the stages back (see the module's docstring)."""
    scan, cpu, batch_fn = native.scan_reads, torch.Tensor.cpu, clf.batch_fn
    first, dispatched = threading.Event(), []

    def late_scan(*a, **kw):
        if not first.is_set():
            first.set()
            time.sleep(FIRST_CHUNK_S)
        return scan(*a, **kw)

    def counted(*a, **kw):
        dispatched.append(1)
        return batch_fn(*a, **kw)

    def late_cpu(self, *a, **kw):
        limit = time.monotonic() + 30
        while len(dispatched) < FULL and time.monotonic() < limit:
            time.sleep(0.005)
        if len(dispatched) == FULL:
            time.sleep(FULL_S)
        return cpu(self, *a, **kw)

    monkeypatch.setattr(native, "scan_reads", late_scan)
    monkeypatch.setattr(clf, "batch_fn", counted)
    monkeypatch.setattr(torch.Tensor, "cpu", late_cpu)


def run_bytes(clf, data, hold_s=0.0):
    """classify_bytes run to its end, the caller holding each row chunk
    hold_s; returns (CSV body, row chunks, the call's seconds)."""
    t = time.perf_counter()
    rows, _ = clf.classify_bytes(data)
    out = []
    for chunk in rows:
        out.append(chunk)
        time.sleep(hold_s)
    return b"".join(out), len(out), time.perf_counter() - t


def test_every_new_phase_is_recorded(clf, paced):
    data = open(READS, "rb").read()
    with profiling.collect() as ph:
        body, chunks, wall = run_bytes(clf, data, HOLD_S)
    assert body.count(b"\n") == 202 and chunks == 13
    for name in NEW:
        assert ph.totals.get(name, 0.0) > 0.0, name
    assert ph.counts["fill"] == ph.counts["drain"] == 1
    assert ph.counts["rows_held"] == ph.counts["format"] == chunks
    assert ph.counts["count_reads"] == 1
    assert ph.totals["fill"] >= FIRST_CHUNK_S  # the first batch's chunk
    assert ph.totals["fill"] <= wall and ph.totals["drain"] <= wall
    assert ph.totals["rows_held"] <= ph.totals["format"]
    assert sum(ph.totals[n] for n in CALLER) <= wall


@pytest.mark.parametrize("hold_s", [0.0, 0.02])
def test_rows_held_counts_the_callers_time(clf, hold_s):
    data = open(READS, "rb").read()
    with profiling.collect() as ph:
        _, chunks, wall = run_bytes(clf, data, hold_s)
    assert ph.counts["rows_held"] == chunks == 13
    assert hold_s * chunks <= ph.totals["rows_held"] <= wall


def _run(clf, mode, tmp_path):
    """One call of `mode`: its CSV's bytes."""
    if mode == "bytes":
        return run_bytes(clf, open(READS, "rb").read())[0]
    out = str(tmp_path / mode)
    clf.classify_file(READS, out, slab_bytes=4096)  # five slabs
    return open(out + ".csv", "rb").read()


@pytest.mark.parametrize("mode,cycles", [("bytes", 1), ("file", 1),
                                         ("bytes", 2), ("file", 2)])
def test_no_collector_no_span(tmp_path, monkeypatch, mode, cycles):
    db, targets = golden_setup("fa", tmp_path)
    _, _, _, prof, k, _, _ = GOLDENS["fa"]
    clf = Classifier.load(db, targets, prof, k, device="cpu",
                          db_cycles=cycles, plan=BatchPlan(max_reads=16))
    real = torch.profiler.record_function

    def refuse(*a, **kw):
        raise AssertionError("a span with no collector")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.current is None
    bare = _run(clf, mode, tmp_path)
    with profiling.collect() as ph, pytest.raises(AssertionError):
        _run(clf, mode, tmp_path)  # the collector's spans reach it
    monkeypatch.setattr(torch.profiler, "record_function", real)
    with profiling.collect() as ph:
        assert _run(clf, mode, tmp_path) == bare
    assert ph.counts["format" if cycles == 1 else "dispatch"] > 0


def test_trace_records_every_threads_spans(clf, tmp_path):
    assert profiling.current is None
    with profiling.trace(str(tmp_path / "trace")):
        assert profiling.current is not None  # its own collector
        run_bytes(clf, open(READS, "rb").read())
    assert profiling.current is None
    (name,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / name) as f:
        evs = json.load(f)["traceEvents"]
    tids: dict = {}
    for e in evs:
        if e.get("cat") == "user_annotation" and e["name"].startswith(
                "clark."):
            tids.setdefault(e["name"][len("clark."):], set()).add(e["tid"])
    for span in ("scan", "scan_cut", "pack", "dispatch", "format",
                 "device_wait", "count_reads", "rows_held"):
        assert span in tids, span
    # one scan thread, one dispatch worker, the caller: three threads
    assert len(tids["scan"]) == len(tids["pack"]) == len(tids["format"]) == 1
    assert tids["scan_cut"] == tids["scan"]
    assert tids["dispatch"] == tids["pack"]
    assert tids["count_reads"] == tids["format"] == tids["rows_held"]
    assert len(tids["scan"] | tids["pack"] | tids["format"]) == 3
    assert not tids["device_wait"] & (tids["scan"] | tids["pack"]
                                      | tids["format"])


@pytest.mark.parametrize("collecting,name,waits,want", [
    (False, "w", True, None), (True, None, True, None),
    (True, "w", False, (0.0, 0)), (True, "w", True, (0.01, 1))])
def test_a_wait_is_recorded_where_it_happens(collecting, name, waits, want):
    """A watched wait that does not happen reads 0 s over 0 calls; with no
    collector or no name nothing is recorded and `waits` is not asked."""
    asked = []

    def about_to_wait():
        asked.append(1)
        return waits

    with (profiling.collect() if collecting else
          profiling.maybe_phase("unused")) as ph:
        with profiling.maybe_wait(name, about_to_wait):
            time.sleep(0.01)
    assert bool(asked) == (want is not None)
    if want is None:
        assert ph is None or ph.totals == {}
        return
    assert ph.totals["w"] >= want[0] and ph.counts["w"] == want[1]
    assert "w " in ph.summary()


@pytest.mark.parametrize("lost", [(), (9,)])
def test_spans_are_not_launch_calls(lost):
    """check_session's verdict on a session is the same with clark. spans
    from several threads among its events."""
    evs = session_events(4, set(lost))
    spans = [{"cat": "user_annotation", "name": f"clark.{n}", "ph": "X",
              "ts": 3 * i, "dur": 2.0, "tid": i % 3, "args": {}}
             for i, n in enumerate(("scan", "pack", "format", "fetch_wait"))]
    assert profiling.check_session(evs + spans, warmup=8, markers=4) == \
        profiling.check_session(evs, warmup=8, markers=4)
