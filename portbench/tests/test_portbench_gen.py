import numpy as np
import pytest
import torch

from portbench import gen
from portbench.references import clark
from portbench.tests import tiny


def _sample(name, seed):
    c = tiny.cell(name)
    genomes = gen.make_genomes(c.config, seed, "cpu")
    return genomes, gen.make_sample(c.traffic, genomes, seed, "cpu")


@pytest.mark.parametrize("name", tiny.CELLS)
def test_the_same_seed_gives_the_same_inputs(name):
    g1, s1 = _sample(name, 2**40 + 3)
    g2, s2 = _sample(name, 2**40 + 3)
    assert torch.equal(g1, g2) and s1 == s2


@pytest.mark.parametrize("name", tiny.CELLS)
def test_seeds_change_the_order_not_the_work(name):
    _, (a, _) = _sample(name, 11)
    _, (b, _) = _sample(name, 12)
    ra, rb = clark.Records(a), clark.Records(b)
    assert a != b and len(a) == len(b)
    assert sorted(ra.lengths) == sorted(rb.lengths)
    assert len(ra.names) == len(rb.names) == 3000


def test_reads_are_genomic_or_random_in_the_traffic_share():
    genomes, (data, _) = _sample("full16x3M-se-mixed", 5)
    recs = clark.Records(data)
    text = [bytes(np.array(list(b"ACGT"), np.uint8)[g.numpy()])
            for g in genomes]
    lengths = recs.lengths
    assert lengths.min() >= 100 and lengths.max() <= 250
    genomic = []
    for r in range(len(recs.names)):
        seq = recs.seq[recs.offsets[r]:recs.offsets[r + 1]].numpy().tobytes()
        genomic.append(any(seq in t for t in text))
    assert sum(genomic) == 1500  # random_share 0.5 of 3,000 reads


def test_the_warm_up_ends_at_a_record_boundary():
    _, (data, warm) = _sample("full16x3M-se-mixed", 4)
    cut = len(warm)
    assert data.startswith(warm) and data[cut:cut + 1] == b">"
    assert warm.endswith(b"\n")
    assert len(clark.Records(warm).names) == 750


def test_a_traffic_mix_with_an_unknown_key_is_refused():
    c = tiny.cell("full16x3M-se-mixed")
    with pytest.raises(ValueError):
        gen.check_traffic({**c.traffic, "paired": True})


def test_genome_files_and_targets(tmp_path):
    c = tiny.cell("light16x3M-se-hits")
    genomes = gen.make_genomes(c.config, 1, "cpu")
    targets = gen.write_genomes(genomes, c.config, str(tmp_path))
    lines = open(targets).read().split("\n")[:-1]
    assert [ln.split()[1] for ln in lines] == ["1000", "1001", "1002", "1003"]
    with open(lines[0].split()[0], "rb") as f:
        recs = clark.Records(f.read())
    assert recs.names == [b"g0"] and recs.offsets[-1] == 200_000
    assert np.array_equal(clark.CODE[recs.seq.numpy()], genomes[0].numpy())
