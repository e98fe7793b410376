"""A cell at a small size on the card, untraced and traced."""

import pytest

from portbench import run
from portbench.tests import tiny


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", tiny.CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_a_small_cell_on_the_card(card, name, traced):
    cell = tiny.cell(name, reads=20_000)
    out = run.run_cell(cell, 9, 0.5, traced, device=card)
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["device"]["memory_peak_bytes"] > 0
    want = cell.per_layer if traced else cell.end_to_end
    assert set(out["metrics"]) == {m["name"] for m in want}
    if traced:
        assert 0 < out["device"]["busy_s"] < out["device"]["window_s"]
        assert 0 < out["metrics"]["kernels_roofline"]["value"] < 100
        assert out["breakdown"]["device_ops"]
