"""The port's hand-written CUDA kernels on the card: each against its
plain-PyTorch twin on the same inputs (exact equality), and the goldens
classified through them.  The cases are chip_smoke.py's phases 2 and 3.

Marked `cuda`: every test skips where torch.cuda.is_available() is false.
On a GPU machine without jax (which tests/conftest.py imports), run
`python -m pytest --noconftest tests/test_torch_cuda.py`."""

import pytest
import torch

import chip_smoke
from jn_cuclark_tpu_torch.ops import kernels, score

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def test_kernels_equal_their_twins(dev):
    kernels.reset_launches()
    assert chip_smoke.check_kernels(dev) == 12 + 3 + 6 + 6 + 4 + 9
    assert kernels.LAUNCHES == {"window_canonicals": 12, "probe": 3, "top2": 6,
                                "sort_top2": 6, "counts_top2": 4,
                                "aggregate": 9}


def test_goldens_through_the_kernels(dev, tmp_path):
    assert chip_smoke.check_goldens(dev, str(tmp_path)) == 6
    assert chip_smoke.check_golden_dbs(dev, str(tmp_path)) == 3


def test_dense_targets_through_the_counts_kernel(dev, tmp_path):
    launches = chip_smoke.check_dense_targets(dev, str(tmp_path))
    assert launches["counts_top2"] > 0 and launches["sort_top2"] == 0


def test_new_wrappers_reject_bad_input(dev):
    kernels.reset_launches()
    lab = torch.ones((2, 3), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        kernels.sort_top2(lab.to(torch.int64))
    with pytest.raises(ValueError):
        kernels.counts_top2(lab, 0)
    keys = torch.zeros(4, dtype=torch.int64, device=dev)
    label = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # seq of another length
        kernels.aggregate(keys, keys[:3], label, label[:1], True)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_wrapper_rejects_bad_input(dev):
    kernels.reset_launches()
    with pytest.raises(TypeError):
        kernels.top2(torch.ones((2, 3), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError):
        kernels.top2(torch.ones((3, 2), dtype=torch.int32, device=dev).t())
    with pytest.raises(ValueError):
        kernels.top2(torch.ones((2, 3), dtype=torch.int32))  # on the CPU
    assert kernels.LAUNCHES["top2"] == 0
    score.top2_from_labels(torch.ones((2, 3), dtype=torch.int32, device=dev))
    assert kernels.LAUNCHES["top2"] == 1
