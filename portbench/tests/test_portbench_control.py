"""The comparison that decides `correct` fails its control and each fault
a cell can have, at a size a test run holds."""

import pytest

from jn_cuclark_tpu_torch.engine import Classifier
from portbench import control, run
from portbench.tests import tiny


def test_the_control_fails_rows_wrong():
    # the reference with 32-bit keys: at 800,000 keys about 2e-4 false
    # hits a window, so a random read of 175 windows misses its NA row
    # one time in 30
    got = control.readings(tiny.cell("full16x3M-se-mixed"), 21, "cpu")
    assert got["keys"] == 4 * (200_000 - 30)
    assert got["rows_wrong"] > run.LIMITS["rows_wrong"]


def _half(rows):  # half of the batch left out
    for chunk in rows:
        lines = chunk.split(b"\n")[:-1]
        yield b"".join(ln + b"\n" for ln in lines[::2])


def _altered(rows):  # one answer altered where it is produced
    first = True
    for chunk in rows:
        if first and chunk:
            chunk = chunk.replace(b",NA,", b",1000,", 1)
            first = False
        yield chunk


FAULTS = {"half the rows left out": _half, "an answer altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    real = Classifier.classify_bytes

    def broken(self, data, *a, **kw):
        rows, n = real(self, data, *a, **kw)
        return FAULTS[fault](rows), n
    monkeypatch.setattr(Classifier, "classify_bytes", broken)
    out = run.run_cell(tiny.cell("full16x3M-se-mixed"), 3, 0.3, False,
                       device="cpu")
    assert not out["correct"] and out["failed"] > 0
    assert out["checks"]["rows_wrong"]["value"] > 0


def test_a_step_that_returns_stale_rows_is_not_correct(monkeypatch):
    """Every pass after the first returns the first call's rows (the
    warm-up's): the state left unchanged."""
    real = Classifier.classify_bytes
    kept = {}

    def stale(self, data, *a, **kw):
        if "rows" not in kept:
            kept["rows"] = b"".join(real(self, data, *a, **kw)[0])
        return iter([kept["rows"]]), 0
    monkeypatch.setattr(Classifier, "classify_bytes", stale)
    out = run.run_cell(tiny.cell("light16x3M-se-hits"), 4, 0.3, False,
                       device="cpu")
    assert not out["correct"]
    assert out["checks"]["rows_wrong"]["value"] >= 2250


def test_a_pass_unlike_the_checked_one_is_not_correct(monkeypatch):
    real = Classifier.classify_bytes
    calls = []

    def flaky(self, data, *a, **kw):
        calls.append(1)
        rows, n = real(self, data, *a, **kw)
        # the warm-up and the first timed pass are sound, the rest not
        return (_altered(rows) if len(calls) > 2 else rows), n
    monkeypatch.setattr(Classifier, "classify_bytes", flaky)
    out = run.run_cell(tiny.cell("full16x3M-se-mixed"), 6, 2.0, False,
                       device="cpu")
    passes = out["attempted"] // 3000
    assert passes >= 2
    assert out["checks"]["rows_wrong"]["value"] == 3000 * (passes - 1)
    assert not out["correct"] and out["failed"] == 3000 * (passes - 1)
