"""The benchmark's out-of-core cell (`full16x3M-cycles3-se-mixed`) and
paired cell (`full16x3M-pe150-mixed`) on the CPU: both run through the
harness at a tiny size against the plain reference; the port's cycled
rows against portbench/references/clark.py; the paired reference
(clark_paired.py) against the port's merge and paired classification;
and the readers of the six metrics the two cells add."""

import types

import numpy as np
import pytest

from jn_cuclark_tpu_torch.db.builder import build_database
from jn_cuclark_tpu_torch.engine import BatchPlan, Classifier
from jn_cuclark_tpu_torch.io import fasta
from jn_cuclark_tpu_torch.io.targets import parse_targets
from portbench import control, gen, roofline, run, spec
from portbench.references import clark, clark_paired
from portbench.tests import tiny
from portbench.traffic import paired

CYCLED = "full16x3M-cycles3-se-mixed"
PAIRED = "full16x3M-pe150-mixed"
CFG = dict(htsize=1048573, light=False, k=31, gap=0, maxhits=15,
           min_count_target=0, targets=3, genome_length=60_000,
           first_taxid=500, fasta_line_width=60)
PAIRS = dict(reads=600, read_length=150, fragment_mean=270, fragment_sd=27,
             random_share=0.5, quality="I", assumed="")


@pytest.mark.parametrize("name", [CYCLED, PAIRED])
def test_tiny_cell_is_correct(name):
    """The harness's run over the cell at 4 genomes of 200,000 bp and 3,000
    reads (or pairs) on the CPU: one pass, every row the reference's."""
    cell = tiny.cell(name)
    assert cell.config["load"] == (
        {"db_cycles": 3} if name == CYCLED else {"db_cycles": "auto"})
    out = run.run_cell(cell, 2**33 + 21, 0.0, False, device="cpu")
    assert out["correct"] and out["checks"]["rows_wrong"]["value"] == 0
    assert out["attempted"] == 3000 and out["failed"] == 0
    assert set(out["metrics"]) == {"reads_per_s", "setup_s"}


@pytest.mark.parametrize("name", [CYCLED, PAIRED])
def test_the_control_is_not_correct(name):
    """The reference with 32-bit keys (a compact hash's shortcut) fails the
    cell's comparison: rows_wrong's limit of 0 can catch a wrong row."""
    got = control.readings(tiny.cell(name), 2**33 + 3, "cpu")
    assert got["reads"] == 3000
    assert got["rows_wrong"] > run.LIMITS["rows_wrong"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(Classifier.load's arguments, the targets file, the genomes) of a
    seeded database of 3 random genomes of 60,000 bp at k = 31."""
    work = tmp_path_factory.mktemp("cycles3")
    genomes = gen.make_genomes(CFG, 2**31 + 77, "cpu")
    targets_file = gen.write_genomes(genomes, CFG, str(work))
    db = work / "db"
    db.mkdir()
    prof, targets = run._profile(CFG), parse_targets(targets_file)
    build_database(targets, str(db), prof, CFG["k"], device="cpu")
    return (str(db), targets, prof, CFG["k"]), targets_file, genomes


def _rows(args, data, paired_input=False, **load):
    clf = Classifier.load(*args, device="cpu", **load)
    return b"".join(clf.classify_bytes(data, paired=paired_input)[0])


@pytest.mark.parametrize("cycles", [2, 3])
@pytest.mark.parametrize("strategy", ["counts", "labels"])
def test_cycled_rows_equal_the_reference(world, cycles, strategy):
    args, targets_file, genomes = world
    traffic = dict(reads=900, length_min=100, length_max=250,
                   random_share=0.5)
    sample, _ = gen.make_sample(traffic, genomes, 2**32 + cycles, "cpu")
    want, work = clark.expected(sample, targets_file, CFG, "cpu")
    assert work["reads"] == 900
    got = _rows(args, sample, db_cycles=cycles,
                plan=BatchPlan(max_reads=128, cycle_strategy=strategy))
    assert got == want
    assert b",NA," in want and b",500," in want


def _with_random_mates(fq2: bytes, n: int, every: int, seed: int) -> bytes:
    """fq2 with mate 2 of every `every`-th pair made random sequence, so
    that genomic pairs among them span a random mate."""
    recs = np.frombuffer(fq2, dtype=np.uint8).reshape(n, -1).copy()
    head = recs.shape[1] - 2 * PAIRS["read_length"] - 4
    rng = np.random.default_rng(seed)
    seq = recs[::every, head:head + PAIRS["read_length"]]
    recs[::every, head:head + PAIRS["read_length"]] = np.frombuffer(
        b"ACGT", dtype=np.uint8)[rng.integers(0, 4, size=seq.shape)]
    return recs.tobytes()


@pytest.mark.parametrize("cycles", [1, 2])
def test_paired_reference_agrees_with_the_port(world, cycles):
    args, targets_file, genomes = world
    (fq1, fq2), (w1, w2) = paired.make_sample(PAIRS, genomes, 2**31 + 5,
                                              "cpu")
    assert fq1[:1] == fq2[:1] == b"@" and fq1.startswith(w1)
    assert len(w1) == len(w2) == len(fq1) // 4
    fq2 = _with_random_mates(fq2, PAIRS["reads"], 3, cycles)
    merged = fasta.merge_paired(fq1, fq2)
    assert clark_paired.merge(fq1, fq2) == merged == \
        fasta._merge_paired_py(fq1, fq2)
    assert merged.count(b"\n>") == PAIRS["reads"] - 1
    want, work = clark_paired.expected((fq1, fq2), targets_file, CFG, "cpu")
    assert work["reads"] == PAIRS["reads"]
    assert work["bases"] == PAIRS["reads"] * (2 * PAIRS["read_length"] + 1)
    assert _rows(args, merged, True, db_cycles=cycles,
                 plan=BatchPlan(max_reads=128)) == want
    assert b",NA," in want and b",501," in want


def test_paired_mates_are_a_fragments_ends(world):
    """Mate 1 of a genomic pair is its fragment's start, mate 2 the
    reverse complement of its end, 150 to 390 bp apart in one genome."""
    _, _, genomes = world
    traffic = dict(PAIRS, random_share=0.0, reads=40)
    (fq1, fq2), _ = paired.make_sample(traffic, genomes, 9, "cpu")
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    text = [acgt[g.numpy()].tobytes() for g in genomes]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    for s1, s2 in zip(fq1.split(b"\n")[1::4], fq2.split(b"\n")[1::4]):
        (g,) = [t for t in text if s1 in t]
        m2 = s2.translate(comp)[::-1]
        frag = g.find(m2, g.find(s1)) + len(m2) - g.find(s1)
        assert 150 <= frag <= 390


# metric: (its phase or None for a device-trace metric, its cell, layer)
METRICS = {
    "chunk_upload_s_per_mread": ("chunk_upload", CYCLED, "table cycling"),
    "cycle_accumulate_s_per_mread": ("cycle_accumulate", CYCLED,
                                     "table cycling"),
    "cycle_finish_s_per_mread": ("cycle_finish", CYCLED, "table cycling"),
    "chunk_probe_ms_per_mread": (None, CYCLED, "kernels"),
    "chunk_probe_roofline": (None, CYCLED, "kernels"),
    "merge_s_per_mread": ("merge", PAIRED, "host front end"),
}
K7 = [["chunk_probe_kernel(unsigned int const*, unsigned long long "
       "const*, int const*, int const*, int, int*, int, int, int, long "
       "long, int, int)", 0.03],
      ["chunk_scatter_kernel(unsigned long long const*, long long)", 0.02],
      ["chunk_count_kernel(unsigned long long const*, long long, int)",
       0.01]]
CTX = types.SimpleNamespace(
    rows=2_000_000, passes=2, window_s=4.0,
    phases={"chunk_upload": 0.2, "cycle_accumulate": 0.08,
            "cycle_finish": 0.3, "merge": 0.5, "format": 1.0},
    trace={"window_s": 4.0, "busy_s": 0.6, "kernel_s": 0.2,
           "kernels": 900,
           "device_ops": [["Memcpy HtoD (Pinned -> Device)", 0.4], *K7,
                          ["void window_canonicals_kernel<8>(int)",
                           0.005]]},
    kind="NVIDIA H100 80GB HBM3", floor_bytes=3.35e8)
WANT = {"chunk_upload_s_per_mread": 0.1,
        "cycle_accumulate_s_per_mread": 0.04,
        "cycle_finish_s_per_mread": 0.15, "merge_s_per_mread": 0.25,
        "chunk_probe_ms_per_mread": 30.0,
        "chunk_probe_roofline": 100 * 2 * 1e-4 / 0.06}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_reader(name):
    read = spec.reader(name)
    assert read(CTX) == pytest.approx(WANT[name])
    phase = METRICS[name][0]
    missing = types.SimpleNamespace(**vars(CTX))
    if phase is None:  # a K7 kernel outside the trace's longest ops
        missing.trace = dict(CTX.trace, device_ops=[
            op for op in CTX.trace["device_ops"] if op[0] != K7[2][0]])
    else:
        missing.phases = {k: v for k, v in CTX.phases.items() if k != phase}
    empty = types.SimpleNamespace(rows=0, passes=0, window_s=0.0,
                                  phases=None, trace=None, kind="cpu",
                                  floor_bytes=None)
    for ctx in (missing, empty):
        assert read(ctx) is None


def test_chunk_probe_roofline_is_share_pct_of_k7():
    ctx = types.SimpleNamespace(**vars(CTX))
    ctx.floor_bytes = 1_234_567_890
    got = spec.reader("chunk_probe_roofline")(ctx)
    assert got == roofline.share_pct(1_234_567_890 * 2, 0.06, CTX.kind)
    assert spec.reader("chunk_probe_ms_per_mread")(ctx) == pytest.approx(
        1e3 * 0.06 / 2)
    ctx.kind = "cpu"  # no peak to share
    assert spec.reader("chunk_probe_roofline")(ctx) is None


@pytest.mark.parametrize("name", sorted(METRICS))
def test_entry_names_its_new_cell_alone(name):
    _, cell, layer = METRICS[name]
    bench = spec.load()
    (entry,) = [m for m in bench["per_layer"] if m["name"] == name]
    assert entry["workloads"] == [cell] and entry["layer"] == layer
    assert entry["moves"] == "reads_per_s"
    for w in bench["workloads"]:
        reported = entry in spec.cell(bench, w["name"]).per_layer
        assert reported == (w["name"] == cell)
