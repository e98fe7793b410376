"""The readers of the program's pipeline spans (the waits between its
threads, rows_held, fill and drain) on hand-made inputs, and their entries
in BENCHMARK.json."""

import types

import pytest

from portbench import spec

CELLS = ["full16x3M-se-mixed", "light16x3M-se-hits"]
# metric: (its phase, value read from CTX, layer)
SPANS = {
    "scan_cut_s_per_mread": ("scan_cut", 0.1, "host front end"),
    "scan_wait_s_per_mread": ("scan_wait", 0.02, "planner and pack"),
    "queue_full_s_per_mread": ("queue_full", 0.3, "dispatch and fetch"),
    "batch_wait_s_per_mread": ("batch_wait", 0.05, "CSV format"),
    "fetch_wait_s_per_mread": ("fetch_wait", 0.04, "dispatch and fetch"),
    "rows_held_s_per_mread": ("rows_held", 0.01, "CSV format"),
    "fill_ms_per_pass": ("fill", 150.0, "pipeline edges"),
    "drain_ms_per_pass": ("drain", 75.0, "pipeline edges"),
}
CTX = types.SimpleNamespace(
    rows=4_000_000, passes=2, window_s=4.0,
    phases={"scan": 0.5, "format": 1.0, "scan_cut": 0.4, "scan_wait": 0.08,
            "queue_full": 1.2, "batch_wait": 0.2, "fetch_wait": 0.16,
            "rows_held": 0.04, "fill": 0.3, "drain": 0.15})


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_reader(name):
    phase, want, _ = SPANS[name]
    assert spec.reader(name)(CTX) == pytest.approx(want)
    # the parent of these spans records none of them: nothing to read
    parent = types.SimpleNamespace(**vars(CTX))
    parent.phases = {k: v for k, v in CTX.phases.items() if k != phase}
    empty = types.SimpleNamespace(rows=0, passes=0, window_s=0.0,
                                  phases=None, trace=None)
    for ctx in (parent, empty):
        assert spec.reader(name)(ctx) is None


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_entries(name):
    (entry,) = [m for m in spec.load()["per_layer"] if m["name"] == name]
    assert entry == {
        "name": name, "unit": "ms/pass" if name.endswith("_ms_per_pass")
        else "s/Mread", "better": "lower", "source": "program_span",
        "layer": SPANS[name][2], "moves": "reads_per_s", "workloads": CELLS}
    for cell in CELLS:
        assert entry in spec.cell(spec.load(), cell).per_layer
