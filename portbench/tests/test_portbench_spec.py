"""BENCHMARK.json against its schema, and a configuration, a traffic mix
(of a new shape too) and metrics added as new files and entries alone."""

import json
import os
import re
import shutil
import subprocess
import sys

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_its_schema():
    b = spec.load()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    cells = [w["name"] for w in b["workloads"]]
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in b["workloads"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(
            spec.HERE, "traffic", w["traffic"] + ".json"))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(
            spec.HERE, "metrics", m["name"].replace(".", "_") + ".py"))
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert spec.cell(b, cell).end_to_end.count(e2e[m["moves"]])
    for cell in cells:
        c = spec.cell(b, cell)
        assert "setup_s" in [m["name"] for m in c.end_to_end]
        assert len(c.end_to_end) >= 2 and c.per_layer
    assert len(json.dumps(b)) < 64 * 1024


FASTQ = '''"""FASTQ reads: the default generator's sample with a quality line a
record; the reference reads them back as FASTA."""

from portbench import gen


def _fastq(fasta):
    lines = fasta.split(b"\\n")[:-1]
    return b"".join(b"@%s\\n%s\\n+\\n%s\\n" % (h[1:], s, b"I" * len(s))
                    for h, s in zip(lines[::2], lines[1::2]))


def _fasta(fastq):
    lines = fastq.split(b"\\n")[:-1]
    return b"".join(b">%s\\n%s\\n" % (h[1:], s)
                    for h, s in zip(lines[::4], lines[1::4]))


def make_sample(traffic, genomes, seed, device):
    return tuple(map(_fastq, gen.make_sample(traffic, genomes, seed,
                                             device)))


run_pass = gen.run_pass


def expected(sample, *args, **kw):
    return gen.expected(_fasta(sample), *args, **kw)
'''

RUN = """
import json, sys
from jn_cuclark_tpu_torch.engine import Classifier
from portbench import run, spec
loads, real = [], Classifier.load.__func__
Classifier.load = classmethod(
    lambda cls, *a, **kw: loads.append(kw) or real(cls, *a, **kw))
out = run.run_cell(spec.cell(spec.load(), sys.argv[1]), 8, 0.2, False,
                   device="cpu")
out["db_cycles"] = [kw.get("db_cycles") for kw in loads]
out["per_layer"] = {m["name"]: spec.reader(m["name"]).__code__.co_filename
                    for m in spec.cell(spec.load(), sys.argv[1]).per_layer}
print(json.dumps(out))
"""


def _copy_with(tmp_path, files: dict, entries: dict) -> str:
    """A copy of BENCHMARK.json and portbench/ under tmp_path, with `files`
    (path: text) added and `entries` appended to BENCHMARK.json's lists."""
    root = str(tmp_path)
    shutil.copytree(spec.HERE, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for path, text in files.items():
        with open(os.path.join(root, path), "w") as f:
            f.write(text)
    b = spec.load()
    for key, added in entries.items():
        b[key] += added
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    return root


def _run(root: str, cell: str) -> dict:
    """One CPU run of `cell` in a process started in the copy `root`."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, spec.ROOT] + os.environ.get("PYTHONPATH", "").split(
            os.pathsep)))
    p = subprocess.run([sys.executable, "-c", RUN, cell], cwd=root, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().split("\n")[-1])


def _tiny_config(name: str, **changes) -> str:
    with open(os.path.join(spec.HERE, "configs",
                           "clark-light-16x3M.json")) as f:
        cfg = json.load(f)
    cfg.update(name=name, targets=2, genome_length=150_000, htsize=1048573,
               **changes)
    return json.dumps(cfg)


def _entries(config: str, traffic: str, cell: str) -> dict:
    return {"configs": [{"name": config, "source": "x", "reduced": [],
                         "file": f"portbench/configs/{config}.json",
                         "why": "a test"}],
            "workloads": [{"name": cell, "config": config,
                           "traffic": traffic, "chips": 1, "why": "a test"}]}


def test_added_files_are_found_by_name(tmp_path):
    """A configuration (with a load option), a traffic mix, an end-to-end
    and a per-layer metric, each a new file and a new entry."""
    entries = _entries("clark-light-2x150k", "short", "light2-short")
    entries["end_to_end"] = [{"name": "passes.run", "unit": "passes",
                              "better": "higher", "bound": 0.1,
                              "source": "host_clock",
                              "workloads": ["light2-short"]}]
    entries["per_layer"] = [{"name": "rows_per_pass", "unit": "rows",
                             "better": "higher", "source": "host_clock",
                             "layer": "CSV format", "moves": "passes.run",
                             "workloads": ["light2-short"]}]
    root = _copy_with(tmp_path, {
        "portbench/configs/clark-light-2x150k.json": _tiny_config(
            "clark-light-2x150k", load={"db_cycles": 2}),
        "portbench/traffic/short.json": json.dumps(
            {"reads": 500, "length_min": 60, "length_max": 80,
             "random_share": 0.2}),
        "portbench/metrics/passes_run.py":
            "def read(ctx):\n    return ctx.passes\n",
        "portbench/metrics/rows_per_pass.py":
            "def read(ctx):\n    return ctx.rows / ctx.passes\n"}, entries)
    out = _run(root, "light2-short")
    assert out["correct"] and out["db_cycles"] == [2]
    assert list(out["metrics"]) == ["reads_per_s", "setup_s", "passes.run"]
    assert out["metrics"]["passes.run"]["value"] * 500 == out["attempted"]
    assert list(out["per_layer"])[-1] == "rows_per_pass"
    assert out["per_layer"]["rows_per_pass"] == os.path.join(
        root, "portbench", "metrics", "rows_per_pass.py")


def test_a_traffic_mix_of_a_new_shape_is_added_by_files_alone(tmp_path):
    """FASTQ reads, which the default generator and the reference do not
    read: a generator module and a mix that names it."""
    root = _copy_with(tmp_path, {
        "portbench/configs/clark-light-2x150k.json": _tiny_config(
            "clark-light-2x150k"),
        "portbench/traffic/fastq.py": FASTQ,
        "portbench/traffic/fq-short.json": json.dumps(
            {"generator": "fastq", "reads": 400, "length_min": 60,
             "length_max": 90, "random_share": 0.5})},
        _entries("clark-light-2x150k", "fq-short", "light2-fq"))
    out = _run(root, "light2-fq")
    assert out["correct"] and out["attempted"] % 400 == 0
    assert out["db_cycles"] == ["auto"]
    # the run compared what the program made of FASTQ with the reference
    assert out["checks"] == {"rows_wrong": {"value": 0, "limit": 0}}
