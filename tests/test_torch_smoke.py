"""chip_smoke.py's phases at a tiny scale on the CPU (the kernels' plain
twins stand in for the kernels), so the script's data generation, checks
and records are exercised before any GPU run.  The script itself refuses
to run without a CUDA device."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from jn_cuclark_tpu_torch import params
from jn_cuclark_tpu_torch.ops import kernels, radix_table
from jn_cuclark_tpu_torch.params import Profile
from jn_cuclark_tpu_torch.utils import memory, native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phases_on_cpu(tmp_path, monkeypatch):
    dev = torch.device("cpu")
    # + 13 + 9 + 6: K9's, K5's flat form's and K5's prior cases
    assert chip_smoke.check_kernels(dev, big_tables=False) == (
        21 + 10 + 45 + 12 + 12 + 13 + 29 + 9 + 13 + 9 + 6)
    assert chip_smoke.check_goldens(dev, str(tmp_path)) == 6
    assert chip_smoke.check_golden_dbs(dev, str(tmp_path)) == 3
    dense = chip_smoke.check_dense_targets(dev, str(tmp_path), n_reads=40)
    scale = tmp_path / "scale"
    scale.mkdir()
    prof = Profile(name="t", htsize=1048573, light=False, default_k=31)
    # ~48k keys: the dense layout (2^12 rows) is smaller than the standard
    # one (2^13), as at the config-2 shape
    m, launches, clf, fa, lens = chip_smoke.run_scale(
        dev, str(scale), 3, 16_000, 1500, n_pairs=300, prof=prof
    )
    assert m["reads"] == 1500 and m["pairs"] == 300
    assert m["db_keys"] > 45_000 and m["db_distinct_kmers"] >= m["db_keys"]
    # two shards: the plain probes run every query against every shard
    mesh = chip_smoke.run_mesh(dev, str(scale), prof, lens, launches, n=2)
    assert (mesh["mesh db"]["shards"], mesh["mesh db cycled labels"]["cycles"],
            mesh["mesh dp x db"]["db_shards"]) == (2, 3, 1)
    assert mesh["mesh db"]["shard_bytes"] * 2 == clf.table.slots.nbytes
    # the auto-policy runs of phase 4b set limits of a few MB here
    monkeypatch.setattr(memory, "HARD_FLOOR", 0)
    ooc, dense_clf = chip_smoke.run_out_of_core(dev, str(scale), prof, clf,
                                                fa, lens, launches)
    assert (ooc["cycled counts"]["cycles"], ooc["cycled labels"]["strategy"],
            ooc["dense"]["strategy"], ooc["auto dense"]["strategy"]) == (
                4, "labels", "dense", "dense")
    assert ooc["auto cycled"]["cycles"] >= 2
    assert ooc["cycle-outer files"]["samples"] == 4
    refseq = tmp_path / "refseq"
    refseq.mkdir()
    rs = chip_smoke.run_refseq(dev, str(refseq), launches, n_targets=400,
                               glen=2000, n_reads=2000)
    assert rs["refseq cycled"]["strategy"] == "labels"
    assert rs["refseq dense"]["strategy"] == "dense"
    # phase 4e: config 1's shape in both flavours, the light one at the
    # reference's constants, then the CLI with no profile flag
    c1 = tmp_path / "config1"
    c1.mkdir()
    full = Profile(name="f", htsize=1048573, light=False, default_k=31)
    cfg1 = chip_smoke.run_config1(dev, str(c1), launches, glen=20_000,
                                  n_reads=2000, n_pairs=200,
                                  profiles=(full, params.LIGHT))
    # light: 740 non-overlapping 27-mers a genome, one in 4 taken
    assert cfg1["light"]["db_occurrences"] == cfg1["light"]["db_keys"] == 555
    assert cfg1["full"]["db_occurrences"] == cfg1["full"]["db_keys"] == (
        3 * (20_000 - 30))
    assert cfg1["light"]["db_file_bytes"] == {
        ".sz": params.LIGHT_HTSIZE, ".ky": 4 * 555, ".lb": 2 * 555}
    assert (cfg1["light"]["reads"], cfg1["light"]["pairs"]) == (2000, 200)
    assert cfg1["cli"]["stem"] == chip_smoke.CONFIG1_STEM
    # phase 6 on the phase-4 DB, verify's toy batch on the CPU here
    tools = chip_smoke.run_tools(dev, str(tmp_path), clf, str(scale), 3, prof,
                                 launches, n_c3=600, c4_samples=3, n_c4=200)
    assert tools["verify"][-1] == "STATUS: READY"
    assert "[OK]   device pipeline (K1, K2, K3 on cpu)" in tools["verify"]
    assert (tools["c3_reads"], tools["c3_taxa"], tools["c4_reads"]) == (
        600, 3, 600)
    assert tools["goldens_byte_equal"] == 9
    assert tools["c3_pipeline_s"] > tools["c3_classify_s"] > 0
    assert tools["label_check_table_bytes"] == clf.table.slots.nbytes
    # phase 7: the cluster's three paths in processes of the script, on
    # the CPU over gloo (the world of one too)
    cl = chip_smoke.run_cluster(dev, str(tmp_path), str(scale),
                                str(tmp_path / "tools"),
                                str(tmp_path / "golden0"), launches)
    assert {p: r["backend"] for p, r in cl.items()} == dict.fromkeys(
        ("sample-parallel", "sharded", "sharded one process"), "gloo")
    sharded = cl["sharded"]["processes"]
    assert [p["table_bytes"] for p in sharded] == [
        [clf.table.slots.nbytes // 2]] * 2
    for p in sharded:  # one reduce a batch, of int32 labels
        assert p["all_reduce"]["calls"] > 0
        assert p["all_reduce"]["bytes"] % (4 * p["all_reduce"]["calls"]) == 0
    assert cl["sharded"]["nodes"]["nodeB"]["reads"] == 300
    assert cl["sharded one process"]["processes"][0]["all_reduce"]["calls"] > 0
    assert cl["sample-parallel"]["processes"][1]["all_reduce"]["calls"] == 0
    # phase 8: the host paths on the phase-4 DB, the flat mesh of two
    flat, _ = chip_smoke._load(dev, str(scale), prof, packed=False)
    host = chip_smoke.run_host_paths(dev, str(scale), prof, flat, launches,
                                     str(tmp_path / "tools"),
                                     str(tmp_path / "golden0"), mesh_n=2,
                                     sub=700)
    assert host["host flat"]["reads"] == 1500
    # (c) the flat path on process meshes: two gloo ranks of two blocks
    # each (half the padded index, a directory a block), then a world of
    # one on the golden DB; one all_reduce a batch, of int32 labels
    procs = host["host flat processes"]["processes"]
    assert [p["blocks"] for p in procs] == [2, 2]
    assert procs[0]["device_bytes"] == procs[1]["device_bytes"]
    quarter = -(-m["db_keys"] // 4)
    assert sum(p["device_bytes"] for p in procs) == 12 * 4 * quarter + 4 * (
        3 * (2 ** ((quarter - 1).bit_length() - 3) + 1)
        + 2 ** ((m["db_keys"] - 3 * quarter - 1).bit_length() - 3) + 1)
    for p in procs + host["host flat one process"]["processes"]:
        for r in p["runs"]:
            assert r["all_reduce"]["calls"] == r["batches"] > 0
            assert r["all_reduce"]["bytes"] % 4 == 0 < r["all_reduce"]["bytes"]
    assert [[r["reads"] for r in p["runs"]] for p in procs] == [[1500] * 2] * 2
    assert host["host flat processes"]["backend"] == "gloo"
    one = host["host flat one process"]["processes"]
    assert len(one) == 1 and one[0]["blocks"] == 1 and len(one[0]["runs"]) == 4
    assert host["host flat mesh"]["reads"] == host["subset_reads"] == 700
    assert host["host flat extended"]["reads"] == 1500
    # keys and labels (padded to the mesh's 2 blocks) and each directory's
    # 2^bits + 1 offsets, bits = ceil(log2 n) - 3 for n keys
    bits = (m["db_keys"] - 1).bit_length() - 3
    half = -(-m["db_keys"] // 2)
    assert host["host flat mesh"]["device_bytes"] == 12 * 2 * half + 4 * (
        2 ** ((half - 1).bit_length() - 3) + 1) + 4 * (
        2 ** ((m["db_keys"] - half - 1).bit_length() - 3) + 1)
    assert host["host flat"]["device_bytes"] == 12 * m["db_keys"] + 4 * (
        2 ** bits + 1)
    assert host["host trace"]["trace_files"] == 1
    assert host["host trace"]["trace_events"] > 0
    assert host["host trace"]["reads"] == 600
    assert host["host trace"]["device_bytes"] == clf.table.nbytes
    # the card's checks
    assert host["host trace"]["burst"] is None
    assert host["host trace"]["check"] is None
    assert host["host trace"]["check_in_process"] is None
    assert host["host trace"]["retakes"] == 0
    assert host["host trace"]["retakes_in_process"] == 0
    for path in ("classify", "extended", "paired"):
        assert set(m["phase_s"][path]) >= {"scan", "pack", "dispatch",
                                           "device_wait", "format"}
    assert m["hit_stats"].startswith("MIN targets: 0, MAX targets: 1")
    for side in ("device", "host"):  # the build's stage timers
        assert set(m[f"db_build_{side}_phase_s"]) == {
            "extract", "aggregate", "filter", "write"}
    launches["dense 65535 targets"] = dense
    assert set(launches) == set(chip_smoke.PATH_KERNELS)
    assert all(c == 0 for p in launches.values() for c in p.values())
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.check_launches(launches)  # the CPU runs the twins
    timing, shape = chip_smoke.time_kernels(dev, clf, dense_clf, flat, fa,
                                            lens, str(scale), 3, reps=1,
                                            dense_rows=8)
    assert shape["stride"] == 256 and shape["windows"] == 224
    assert shape["k1_run"]["E"] == 8 and shape["k1_run"]["block"] == [9, 28]
    assert shape["sort_form"] == "warp" and shape["sass"] is None
    # the partition as the build hands it over, and padded as it was
    assert shape["padded_partition_entries"] == 1 << 20
    assert 0 < shape["partition_entries"] < 1 << 20
    assert set(timing) == set(chip_smoke.KERNELS) | {
        "counts_top2 T=65535", "probe_chunk chunk 1", "probe_chunk chunk 2",
        "probe_chunk chunk 3", "aggregate padded", "top2 hash",
        "top2 T=65535", "top2 block T=65535"}
    # K3's forms by shape: the main path's 3 targets take the small form
    assert {n: f["form"] for n, f in shape["top2_forms"].items()} == {
        "top2": "small", "top2 hash": "hash", "top2 T=65535": "hash",
        "top2 block T=65535": "block", "top2 past the tile": "block"}
    # the miss mask reads q (8 B) and the probe's labels, writes labels
    assert shape["mask_glue"]["bytes"] == 16 * shape["queries"]
    assert shape["mask_glue"]["bound_ms"] > 0
    assert timing["aggregate"]["plan"]["levels"] == 1
    assert timing["aggregate padded"]["plan"]["single"] == 1
    assert sum(shape["probe_reads"][f"probe_chunk {i}"]["queries"]
               for i in range(4)) == shape["queries"]
    assert shape["counts_forms"] == {3: "small", 65535: "large"}
    assert all(t["max_abs_err"] == 0.0 for t in timing.values())
    assert all(t["bound_ms"] > 0 and t["bound_by"] in ("bytes", "operations")
               for t in timing.values())
    assert {n for n, t in timing.items() if t["library_ms"] is not None} == {
        "sort_top2", "counts_top2", "counts_top2 T=65535", "aggregate",
        "aggregate padded", "top2", "top2 hash", "top2 T=65535",
        "top2 block T=65535", "lookup", "counts_flat"}
    # the flat path's first batch: every read of the rehearsal (each of at
    # most 220 windows: far below 2^20 queries), its searches' reads
    fb = shape["flat_batch"]
    assert fb["reads"] == 1500 and fb["index_keys"] == m["db_keys"]
    assert 0 < fb["search"]["hits"] <= fb["search"]["queries"] == fb["queries"]
    assert fb["search"]["compares"] >= fb["queries"]
    assert 0 < fb["search"]["floor_bytes"] <= fb["search"]["bytes"]
    # the directory: 4-8 keys a bucket on average, its sectors and bounds
    fd = fb["directory"]
    assert (fd["bits"], fd["buckets"]) == (bits, 2 ** bits)
    assert fd["mean_keys"] == pytest.approx(m["db_keys"] / 2 ** bits)
    assert 4 < fd["mean_keys"] <= 8
    assert fd["max_keys"] >= fd["mean_keys"] and 0 <= fd["empty_share"] < 1
    assert fd["directory_bytes"] == 4 * (2 ** bits + 1)
    assert fd["dir_sectors"] > 0 and fd["bucket_sectors"] > 0
    # K9's bound is the floor of its work: no more than a whole-array
    # search's (equal here, where the searches visit every key sector)
    assert 0 < timing["lookup"]["bound_ms"] <= fb["search"]["bound_ms"]
    assert fd["bound_ms"] > 0 and fd["build_s"] > 0
    # no session on the CPU: nothing retaken
    assert set(shape["retakes"]) == set(timing) | {"mask"}
    assert not any(shape["retakes"].values())


@pytest.mark.parametrize("light", [False, True], ids=["full", "light"])
@pytest.mark.parametrize("glen", [26, 31, 108, 1_000, 20_011])
def test_genome_occurrences_are_the_builds(tmp_path, light, glen):
    """run_scale's count of occurrences (genome_occurrences) is what the
    build's extraction takes from make_genomes' files, in each flavour at
    its own constants: every window, or one in gap of the non-overlapping
    k-mers."""
    prof = params.LIGHT if light else params.FULL
    chip_smoke.make_genomes(str(tmp_path), np.random.default_rng(glen), 2,
                            glen)
    for i in range(2):
        data = (tmp_path / f"g{i}.fa").read_bytes()
        got = native.extract_canonical(data, prof.default_k, prof.light,
                                       prof.default_gap)
        assert len(got) == chip_smoke.genome_occurrences(
            prof, prof.default_k, glen)


def test_kshift_case_plans_kshift_1():
    """Phase 2's 1 GiB K2/K8 case: its keys plan to 2^26 rows of C = 2, the
    size at which a tile sorts by pairs of rows (planned only: the fill is
    the card's)."""
    _, keys, labels1, pairs = chip_smoke.kshift_keys()
    plan = radix_table.plan_table(keys, labels1, c=2, load=1 / 64)
    assert plan.m1 == chip_smoke.KSHIFT_M1 == 26
    assert kernels.group_bins(1 << plan.m1) == (14, 4096, 1)
    rows = np.concatenate([pairs, pairs + 1])
    assert np.isin(rows, plan.bucket).all()  # each pair's rows hold keys


def test_extended_csv_less_counts_is_the_plain_csv():
    ext = (b"Object_ID,1000,1001,Gamma,Assignment,Score,Confidence\n"
           b"r0,5,0,0.5,1000,5,1\nr1,0,0,0,NA,0,0\n")
    assert chip_smoke.drop_count_columns(ext, 2) == (
        b"Object_ID,Gamma,Assignment,Score,Confidence\n"
        b"r0,0.5,1000,5,1\nr1,0,NA,0,0\n")


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_refuses_without_cuda_or_without_the_repo(tmp_path, where):
    """No result and a non-zero exit: without a CUDA device, and (on any
    machine) from a directory holding chip_smoke.py and nothing else."""
    if where == "checkout" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    cwd = ROOT
    if where == "alone":
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout


def test_misassigned_read_fails_the_check(tmp_path):
    p = tmp_path / "r.csv"
    p.write_bytes(b"Object_ID,Gamma,Assignment,Score,Confidence\n"
                  b"r0_g0,1,1000,70,1\nr1_junk,0,NA,0,0\n")
    chip_smoke.check_csv(str(p), [b"1000", b"NA"])
    try:
        chip_smoke.check_csv(str(p), [b"1001", b"NA"])
    except AssertionError as e:
        assert "misassigned" in str(e)
    else:
        raise AssertionError("a wrong assignment passed the check")
