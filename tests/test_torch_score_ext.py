"""Extended scoring of the PyTorch port against the JAX package, on the CPU:
score_from_labels in its three forms (K3 top-2, K4 sorted u16 grid + top-2,
K5 dense counts + top-2, here their plain twins; K5 started from a
prior), and the dense-count twins counts_from_hits_plain /
read_results_plain, all held to exact equality,
on shapes at both sides of K5's and K4's form edges; and the forms' (K3's,
K4's, K5's) and K1's launch plan's rules."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

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


@pytest.mark.parametrize("n_targets, w, form", [
    (1, 1, "small"), (16, 224, "small"), (4095, 100_000, "small"),
    (4096, 224, "hash"), (65535, 4096, "hash"), (None, 0, "hash"),
    (None, 672, "hash"), (None, 4096, "hash"), (4096, 4097, "block"),
    (None, 4097, "block"), (65535, 100_000, "block"),
])
def test_top2_form_by_shape(n_targets, w, form):
    """K3's form follows the shape alone, at both sides of each edge; the
    block form takes every shape, the small form needs T."""
    assert kernels.top2_form(n_targets, w) == form
    forms = kernels.top2_forms(n_targets, w)
    assert forms[0] == form and forms[-1] == "block"
    assert ("small" in forms) == (n_targets is not None
                                  and n_targets + 1 <= kernels.K5_SMALL_T1)
    assert ("hash" in forms) == (w <= kernels.K3_TILE_W)


@pytest.mark.parametrize("T", [1, 16, 4095, 4096, 65535])
def test_top2_scores_do_not_depend_on_n_targets(T):
    """score_from_labels(extended=False) gives the JAX package's five
    arrays whatever form n_targets picks for K3."""
    rng = np.random.default_rng(T)
    lab = rng.integers(0, min(T, 40) + 1, size=(21, 224)).astype(np.int32)
    lab[::4] = lab[::4, :1]
    want = [np.asarray(a) for a in jdp.score_from_labels(
        jnp.asarray(lab), n_targets=T, extended=False)]
    got = device_pipeline.score_from_labels(
        torch.from_numpy(lab), n_targets=T, extended=False)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == w.shape
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("n_targets", [0, -1, (1 << 31) - 1])
def test_top2_rejects_a_bad_target_count(n_targets):
    lab = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="bad target count"):
        score.top2_from_labels(lab, n_targets)
    with pytest.raises(ValueError, match="bad target count"):
        kernels.top2_forms(n_targets, 3)


def _sorted_case(name):
    """lab [R, W] int32 (labels in [0, 65,536)) at K4's warp-form edges."""
    rng = np.random.default_rng(SORTED_CASES.index(name))
    edge = kernels.SORT_WARP_W
    w = {"W=1": 1, "edge-1": edge - 1, "edge": edge, "edge+1": edge + 1}
    if name in w:
        lab = rng.integers(0, 300, size=(5, w[name]))
        lab[1] = 0
        return lab.astype(np.int32)
    if name == "all equal":
        return np.full((3, 224), 11, np.int32)
    # all distinct, 65,535 and 65,534 among them
    lab = np.stack([rng.permutation(65536)[:224] for _ in range(4)])
    lab[0, :2] = (65535, 65534)
    return lab.astype(np.int32)


SORTED_CASES = ["W=1", "edge-1", "edge", "edge+1", "all equal",
                "all distinct"]


@pytest.mark.parametrize("case", SORTED_CASES)
def test_sort_top2_plain_equals_jax_at_form_edges(case):
    """K4's twin against the JAX package's "sorted" scoring at the shapes
    where the kernel changes form or its runs meet their edges."""
    lab = _sorted_case(case)
    want = [np.asarray(a) for a in jdp.score_from_labels(
        jnp.asarray(lab), n_targets=65535, extended="sorted")]
    srt, total, ib, b, isb, sb = score.sort_top2_plain(torch.from_numpy(lab))
    assert np.array_equal(srt.numpy().view(np.uint16), want[4])
    for g, w in zip((total, ib, b, sb), want[:4]):
        assert np.array_equal(g.numpy(), w)
    assert isb.dtype == torch.int32 and (isb.numpy() >= 0).all()


@pytest.mark.parametrize("w, form", [
    (0, "warp"), (1, "warp"), (224, "warp"), (1024, "warp"), (1025, "block"),
    (100_000, "block"),
])
def test_sort_form_by_shape(w, form):
    """K4's form follows the row width alone, at both sides of its edge."""
    assert kernels.sort_form(w) == form


@pytest.mark.parametrize("w, plan", [
    (1, (4, 1, 256, 1)), (63, (4, 16, 16, 1)), (64, (8, 8, 32, 1)),
    (224, (8, 28, 9, 1)), (2048, (8, 256, 1, 1)), (2049, (8, 256, 1, 2)),
    (4066, (8, 256, 1, 2)),
])
def test_window_run_by_shape(w, plan):
    """K1's plan (E, runs a block row, rows a block, blocks a row) follows
    the row width alone; a block's runs never exceed its threads."""
    assert kernels.window_run(w) == plan
    e, tr, rb, tiles = plan
    assert tr * rb <= kernels.K1_THREADS and (tiles - 1) * tr * e < w <= tiles * tr * e


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


PRIOR_CASES = [c[0] for c in chip_smoke.k5_prior_cases()]


@pytest.mark.parametrize("case", PRIOR_CASES)
def test_counts_top2_from_a_prior_equals_jax(case):
    """K5's twin started from a prior (a cycled call's last pass) gives
    the JAX package's counts_from_hits + read_results over prior +
    counts: ties only the prior makes, all-zero rows, hits in the prior
    alone, T + 1 at the small form's edge, R not a multiple of K5's reads
    a block."""
    lab, prior, T = next(c[1:] for c in chip_smoke.k5_prior_cases()
                         if c[0] == case)
    R, W = lab.shape
    rid = np.repeat(np.arange(R, dtype=np.int32), W)
    want = prior + np.asarray(jscore.counts_from_hits(
        jnp.asarray(lab.ravel()), jnp.asarray(rid), R, T))
    got = score.counts_top2(torch.from_numpy(lab), T, torch.from_numpy(prior))
    assert got[0].dtype == torch.int32
    assert np.array_equal(got[0].numpy(), want)
    for g, w in zip(got[1:], jscore.read_results(jnp.asarray(want))):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", CASES)
def test_counts_top2_without_a_prior_is_unchanged(case):
    """prior=None gives counts_top2's outputs as before, and an all-zero
    prior the same."""
    lab, T = _case(case)
    lab = torch.from_numpy(lab)
    R, W = lab.shape
    rid = torch.arange(R, dtype=torch.int64).repeat_interleave(W)
    counts = score.counts_from_hits_plain(lab.reshape(-1), rid, R, T)
    want = (counts,) + score.read_results_plain(counts)
    runs = [score.counts_top2(lab, T), score.counts_top2(lab, T, None)]
    if kernels.counts_form(T + 1, W) == "small":
        runs.append(score.counts_top2(lab, T, torch.zeros_like(counts)))
    for got in runs:
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("T, shape, match", [
    (4096, (3, 4097), "small form"), (65535, (3, 65536), "small form"),
    (16, (3, 16), r"prior must be \[3, 17\]"), (16, (2, 17), "prior must"),
])
def test_counts_top2_refuses_a_prior_it_cannot_take(T, shape, match):
    """A prior needs K5's small form (T + 1 <= 4,096) and the [R, T+1]
    shape, on the CPU as on the card."""
    lab = torch.ones((3, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        score.counts_top2(lab, T, torch.zeros(shape, dtype=torch.int32))
