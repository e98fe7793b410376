"""Extended scoring of the PyTorch port against the JAX package, on the CPU:
score_from_labels in its three forms (K3 top-2, K4 sorted u16 grid + top-2,
K5 dense counts + top-2, here their plain twins), and the dense-count twins
counts_from_hits_plain / read_results_plain, all held to exact equality,
on shapes at both sides of K5's form edges; and K5's form rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jn_cuclark_tpu.ops import device_pipeline as jdp
from jn_cuclark_tpu.ops import score as jscore
from jn_cuclark_tpu_torch.ops import device_pipeline, kernels, score

T_MAX = 65535


def _case(name):
    """(lab [R, W] int32 label+1, n_targets) from a numpy seed."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "ties":
        # count ties resolve to the lowest label, for best and second best
        return np.array([[3, 3, 5, 5, 7, 0], [2, 2, 9, 9, 9, 1],
                         [4, 0, 4, 6, 6, 6], [1, 2, 3, 4, 5, 6]],
                        np.int32), 9
    if name == "zero rows":
        return np.zeros((4, 7), np.int32), 5
    if name == "W=1":
        return np.array([[0], [5], [1], [16]], np.int32), 16
    if name == "T=65535":
        lab = rng.integers(0, T_MAX + 1, size=(3, 200)).astype(np.int32)
        lab[0, :50] = T_MAX  # the top label wins row 0
        lab[1] = 0
        return lab, T_MAX
    if name == "one target":
        return rng.integers(0, 2, size=(6, 40)).astype(np.int32), 1
    # K5's small form holds T+1 <= 4,096 columns a read; 13 reads are no
    # multiple of its 8 reads a block
    T, R = {"T+1=4096": (4095, 9), "T+1=4097": (4096, 9),
            "ragged R": (16, 13)}.get(name, (16, 64))
    lab = rng.integers(0, T + 1, size=(R, 150)).astype(np.int32)
    lab[::7] = 0
    return lab, T


CASES = ["ties", "zero rows", "W=1", "T=65535", "one target", "random",
         "T+1=4096", "T+1=4097", "ragged R"]


@pytest.mark.parametrize("extended", [False, "sorted", True],
                         ids=["top2", "sorted", "dense"])
@pytest.mark.parametrize("case", CASES)
def test_score_from_labels_equals_jax(case, extended):
    lab, T = _case(case)
    want = [np.asarray(a) for a in jdp.score_from_labels(
        jnp.asarray(lab), n_targets=T, extended=extended)]
    got = device_pipeline.score_from_labels(
        torch.from_numpy(lab), n_targets=T, extended=extended)
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), w)
    extra = got[4].numpy()
    if extended == "sorted":
        assert got[4].dtype == torch.int16
        extra = extra.view(np.uint16)
    assert extra.shape == want[4].shape
    assert np.array_equal(extra, want[4].astype(extra.dtype))


@pytest.mark.parametrize("case", CASES)
def test_counts_from_hits_and_read_results_equal_jax(case):
    lab, T = _case(case)
    R, W = lab.shape
    rid = np.repeat(np.arange(R, dtype=np.int32), W)
    want = np.asarray(jscore.counts_from_hits(
        jnp.asarray(lab.ravel()), jnp.asarray(rid), R, T))
    got = score.counts_from_hits_plain(
        torch.from_numpy(lab.ravel()), torch.from_numpy(rid), R, T)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    for g, w in zip(score.read_results_plain(got),
                    jscore.read_results(jnp.asarray(want))):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("t1, w, form", [
    (2, 1, "small"), (17, 224, "small"), (4096, 5000, "small"),
    (4097, 1, "large"), (65536, 4096, "large"), (4097, 4097, "wide"),
    (65536, 100_000, "wide"),
])
def test_counts_form_by_shape(t1, w, form):
    """K5's form follows the shape alone, at both sides of each edge."""
    assert kernels.counts_form(t1, w) == form


def test_sorted_grid_carries_labels_above_int16():
    """Labels of 32,768 and up ride the int16 grid as u16 bit patterns."""
    lab = np.array([[65534, 0, 32768, 32767, 65534]], np.int32)
    s, total, ib, b, isb, sb = score.sort_top2(torch.from_numpy(lab))
    assert s.numpy().view(np.uint16).tolist() == [[0, 32767, 32768, 65534,
                                                   65534]]
    assert (total.item(), ib.item(), b.item(), isb.item(), sb.item()) == (
        4, 65534, 2, 32767, 1)


def test_scoring_rejects_a_device_it_does_not_know():
    lab = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    for fn in (score.top2_from_labels, score.sort_top2,
               lambda t: score.counts_top2(t, 4)):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(lab)
