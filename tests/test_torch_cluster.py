"""The port's cluster (cluster.py, parallel/dist.py, a mesh across
processes) on the CPU: processes of the port's CLI joined over gloo on
127.0.0.1, against the JAX package.

Held to the JAX package exactly: ClusterConfig.load, validate's and
preflight's messages, generate_report (but its Generated: line), a
local-backend run's outputs, and every CSV of a multi-process run, which
equals the JAX package's single-process Classifier CSV of the same input
(sample-parallel, DB-sharded resident and cycled, 2-D dp x db).  The port's
own guarantees: one agreed cycle count, one classify call at a time on a
process mesh, no silent fallback, contained and reported failures, and no
jax in the spawned processes.  Everything exact."""

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from jn_cuclark_tpu import cluster as jcluster
from jn_cuclark_tpu import params as jparams
from jn_cuclark_tpu.database import DBConfig as JDBConfig
from jn_cuclark_tpu.engine import Classifier as JClassifier
from jn_cuclark_tpu.utils.logging import ClusterLogger as JClusterLogger
from jn_cuclark_tpu_torch import cli, cluster, params
from jn_cuclark_tpu_torch.database import DBConfig
from jn_cuclark_tpu_torch.db import builder
from jn_cuclark_tpu_torch.io.targets import parse_targets
from jn_cuclark_tpu_torch.parallel import dist
from jn_cuclark_tpu_torch.utils.logging import ClusterLogger

from .test_builder import rand_seq, write_fasta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, HTSIZE = 9, 2039
TAXIDS = (800, 801, 802)
TIMEOUT = 240  # seconds a spawned process may take

# A process of the port's CLI that fails where it imported jax, the JAX
# package or __graft_entry__.
CHILD = """\
import sys
from jn_cuclark_tpu_torch import cli
rc = cli.main(sys.argv[1:])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jn_cuclark_tpu", "__graft_entry__"))
if bad:
    print("imported", bad, file=sys.stderr)
    sys.exit(99)
sys.exit(rc)
"""

# A process of a world over gloo that drives the port's Classifier on a
# process mesh as its JSON spec says, then prints a JSON line of results.
WORKER = """\
import json, os, sys
import numpy as np
from jn_cuclark_tpu_torch import params
from jn_cuclark_tpu_torch.engine import BatchPlan, Classifier
from jn_cuclark_tpu_torch.io.targets import parse_targets
from jn_cuclark_tpu_torch.parallel import dist
from jn_cuclark_tpu_torch.parallel.mesh import Mesh, make_mesh, make_mesh2d
from jn_cuclark_tpu_torch.utils import memory, profiling

spec = json.loads(sys.argv[1])
dist.initialize(device="cpu")
rank = dist.process_index()
prof = params.tiny(htsize=spec["htsize"], k=spec["k"])
plan = dict(max_reads=8, window_budget=1 << 14)
out = {"rank": rank, "world": dist.process_count()}


def load(mesh, **kw):
    return Classifier.load(spec["db"], spec["targets"], prof, spec["k"],
                           device="cpu", mesh=mesh, mesh_mode="db", **kw)


def classify(clf, tag, inputs):
    for name, reads, mate, extended in inputs:
        clf.classify_file(reads, os.path.join(spec["out"],
                                              f"{tag}{name}_r{rank}"),
                          paired_path=mate, extended=extended)


for run in spec.get("runs", ()):
    shape = run["mesh"]
    mesh = (make_mesh(shape[0], device="cpu", across_processes=True)
            if len(shape) == 1
            else make_mesh2d(*shape, device="cpu", across_processes=True))
    clf = load(mesh, db_cycles=run["cycles"],
               plan=BatchPlan(cycle_strategy=run["strategy"], **plan))
    out.setdefault("local_bytes", []).append(clf.sharded.local_bytes)
    classify(clf, run["tag"], spec["inputs"])

def flat_mesh(run):
    if run.get("owners"):
        return Mesh(["cpu"] * len(run["owners"]), ("db",),
                    owners=run["owners"])
    if len(run["mesh"]) == 1:
        return make_mesh(run["mesh"][0], device="cpu", across_processes=True)
    return make_mesh2d(*run["mesh"], device="cpu", across_processes=True)


# classify_files(jobs=2), and a second call while classify_bytes's rows
# hold the Classifier: the refusals seen; the held call's rows written out
def refusals(clf, reads, tag):
    refused = []
    try:
        clf.classify_files([(reads, None, os.path.join(spec["out"], "x"))],
                           jobs=2)
    except ValueError:
        refused.append("jobs=2")
    with open(reads, "rb") as f:
        rows, _ = clf.classify_bytes(f.read())
    body = [next(rows)]  # the call holds the Classifier until drained
    try:
        clf.classify_file(reads, os.path.join(spec["out"], "y"))
    except ValueError:
        refused.append("a second call")
    body.extend(rows)
    with open(os.path.join(spec["out"], f"{tag}rows_r{rank}"), "wb") as f:
        f.write(b"".join(body))
    return refused


# the flat path (packed=False) on process meshes: what each process holds,
# and each input's phase calls and bytes
for run in spec.get("flat", ()):
    mesh = flat_mesh(run)
    fplan = BatchPlan(max_queries=run["max_queries"], max_reads=64)
    if run.get("keys"):
        z = np.load(run["keys"])
        clf = Classifier(prof, spec["k"],
                         parse_targets(spec["targets"]).target_names,
                         z["keys"], z["labels"], plan=fplan, device="cpu",
                         mesh=mesh, packed=False)
    else:
        clf = Classifier.load(spec["db"], spec["targets"], prof, spec["k"],
                              device="cpu", mesh=mesh, packed=False,
                              mesh_mode=run["mode"], plan=fplan)
    ts = [t for ix in clf.index for t in (ix.keys, ix.labels1)]
    rec = dict(blocks=len(clf.index), bytes=sum(t.nbytes for t in ts),
               storage=sum(t.untyped_storage().nbytes() for t in ts),
               devices=[str(ix.keys.device) for ix in clf.index], phases={})
    for name, reads, mate, extended in spec["inputs"][:run.get("n_inputs")]:
        with profiling.collect() as ph:
            classify(clf, run["tag"], [(name, reads, mate, extended)])
        rec["phases"][name] = dict(calls=ph.counts, bytes=ph.nbytes)
    if run.get("refuse"):
        rec["refused"] = refusals(clf, spec["inputs"][0][1], run["tag"])
    out.setdefault("flat", {})[run["tag"]] = rec

if spec.get("agree"):
    memory.HARD_FLOOR = memory.RESERVED = 0
    clf = load(make_mesh(None, device="cpu", across_processes=True),
               db_cycles="auto",
               plan=BatchPlan(**plan))
    sh = clf.sharded
    out["local_cycles"] = memory.auto_db_cycles(
        (1 << sh.m1) * sh.c * 8, clf._transient_bytes(), device="cpu",
        n_shards=sh.ndb)[0]
    out["cycles"] = clf.db_cycles
    classify(clf, "agree_", spec["inputs"][:1])
    reads = spec["inputs"][0][1]
    refused = []
    try:
        clf.classify_files([(reads, None, "x")], jobs=2)
    except ValueError:
        refused.append("jobs=2")
    with open(reads, "rb") as f:
        rows, _ = clf.classify_bytes(f.read())
    next(rows)  # this call holds the Classifier until its rows are drained
    try:
        clf.classify_file(reads, "y")
    except ValueError:
        refused.append("a second call")
    for _ in rows:
        pass
    try:
        Classifier.load(spec["db"], spec["targets"], prof, spec["k"],
                        device="cpu",
                        mesh=make_mesh(2, device="cpu", across_processes=True))
    except ValueError:
        refused.append("mesh_mode dp")
    out["refused"] = refused

if spec.get("gather"):
    payload = (b"x" * (1 << 17) + b"END") if rank == 0 else b"r%d" % rank
    out["gathered"] = [len(p) for p in dist.allgather_bytes(payload)]
    out["ends"] = [p[-3:].decode() for p in dist.allgather_bytes(payload)]
    out["max"] = dist.agree_max(10 + rank)
    # inside a world a mesh still crosses processes only where asked
    out["plain_collective"] = (make_mesh(2, device="cpu").collective
                               or make_mesh2d(1, 2, device="cpu").collective)

dist.shutdown()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jn_cuclark_tpu", "__graft_entry__"))
out["bad_imports"] = bad
print(json.dumps(out))
"""


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reads(path, genomes, rng, n, length, tag):
    with open(path, "w") as f:
        for i in range(n):
            g = genomes[i % len(genomes)]
            pos = rng.integers(0, len(g) - length)
            f.write(f">{tag}_{i}\n{g[pos:pos + length]}\n")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A DB built by the port's builder (3 genomes x 600 bp, k = 9, a toy
    taxonomy), its copy under the JAX package's config, the samples, and
    the JAX package's single-process CSVs of each."""
    tmp = tmp_path_factory.mktemp("tcluster")
    rng = np.random.default_rng(77)
    db = tmp / "db"
    (db / "sub").mkdir(parents=True)
    genomes = [rand_seq(rng, 600) for _ in TAXIDS]
    with open(db / "targets.txt", "w") as tf:
        for i, (g, t) in enumerate(zip(genomes, TAXIDS)):
            p = tmp / f"g{i}.fa"
            write_fasta(p, [(f"g{i}", g)])
            tf.write(f"{p} {t}\n")
    tax = db / "taxonomy"
    tax.mkdir()
    with open(tax / "nodes.dmp", "w") as f:
        f.write("1\t|\t1\t|\tno rank\t|\tX\t|\n")
        for t in TAXIDS:
            f.write(f"{t}\t|\t1\t|\tspecies\t|\tX\t|\n")
    with open(tax / "names.dmp", "w") as f:
        for t in TAXIDS:
            f.write(f"{t}\t|\tSpecies {t}\t|\t\t|\tscientific name\t|\n")
    prof = params.tiny(htsize=HTSIZE, k=K)
    builder.build_database(parse_targets(str(db / "targets.txt")),
                           str(db / "sub"), prof, K, device="cpu")
    jdb = tmp / "jdb"
    shutil.copytree(db, jdb)
    for cls, d in ((DBConfig, db), (JDBConfig, jdb)):
        cls(db_dir=str(d), targets=str(d / "targets.txt"),
            subdb=str(d / "sub"), rank=0, profile_name=prof.name, k=K,
            gap=prof.default_gap, min_count_target=0, htsize=prof.htsize,
            light=prof.light).save()
    _reads(tmp / "nodeA.fa", genomes, rng, 30, 70, "nodeA")
    _reads(tmp / "nodeB.fa", genomes, rng, 30, 70, "nodeB")
    _reads(tmp / "sample.fa", genomes, rng, 40, 90, "s")
    pairs = []
    for i in range(20):
        g = genomes[i % 3]
        pos = rng.integers(0, len(g) - 120)
        pairs.append((f"p{i}", g[pos:pos + 120]))
    for mate, part in (("r1.fq", slice(0, 50)), ("r2.fq", slice(70, 120))):
        (tmp / mate).write_text("".join(
            f"@{n}/x\n{s[part]}\n+\n{'I' * 50}\n" for n, s in pairs))
    jclf = JClassifier.load(str(jdb / "sub"), str(jdb / "targets.txt"),
                            jparams.tiny(htsize=HTSIZE, k=K), K)
    want = {}
    for name, src, kw in (
            ("nodeA", "nodeA.fa", {}), ("nodeB", "nodeB.fa", {}),
            ("sample", "sample.fa", {}),
            ("extended", "sample.fa", dict(extended=True)),
            ("paired", "r1.fq", dict(paired_path=str(tmp / "r2.fq")))):
        jclf.classify_file(str(tmp / src), str(tmp / f"want_{name}"), **kw)
        want[name] = (tmp / f"want_{name}.csv").read_bytes()
    (tmp / "child.py").write_text(CHILD)
    (tmp / "worker.py").write_text(WORKER)
    return tmp, want


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env["GLOO_SOCKET_IFNAME"] = "lo"
    for key in ("CLARK_TPU_NUM_PROCESSES", "CLARK_TPU_PROCESS_ID",
                "CLARK_TPU_COORDINATOR", "CLARK_TPU_NODE_NAME",
                "CLARK_TPU_DIST_BACKEND", "WORLD_SIZE", "RANK",
                "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _spawn(argvs, envs):
    """Start one process per argv with its env; wait for all (each within
    TIMEOUT seconds, killed past it); returns [(rc, stdout, stderr)]."""
    procs = [subprocess.Popen(a, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for a, e in zip(argvs, envs)]
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                pytest.fail(f"a process hung:\n{err[-2000:]}")
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def _cluster_world(tmp, conf, n=2, nodes=("nodeA", "nodeB"), env_of=None):
    """n processes of `clark-torch cluster -c conf --device cpu`, as a
    world of n with process ids and node names preset."""
    argvs, envs = [], []
    for pid in range(n):
        extra = dict(CLARK_TPU_NUM_PROCESSES=n, CLARK_TPU_PROCESS_ID=pid,
                     CLARK_TPU_NODE_NAME=nodes[pid])
        extra.update((env_of or {}).get(pid, {}))
        argvs.append([sys.executable, str(tmp / "child.py"), "cluster",
                      "-c", str(conf), "--device", "cpu"])
        envs.append(_env(**extra))
    return _spawn(argvs, envs)


def _workers(tmp, spec, env_of=None):
    """Two WORKER processes over gloo on 127.0.0.1; their JSON results."""
    port = free_port()
    outs = _spawn(
        [[sys.executable, str(tmp / "worker.py"), json.dumps(spec)]] * 2,
        [_env(CLARK_TPU_NUM_PROCESSES=2, CLARK_TPU_PROCESS_ID=r,
              CLARK_TPU_COORDINATOR=f"127.0.0.1:{port}",
              **(env_of or {}).get(r, {})) for r in range(2)])
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    res = [json.loads(out.splitlines()[-1]) for _, out, _ in outs]
    assert [r["rank"] for r in res] == [0, 1]
    assert all(r["bad_imports"] == [] for r in res)
    return res


def _conf(tmp, name, reads, backend="jax_distributed", classification="",
          extra_cluster="", workers="nodeB", master="nodeA", db="db"):
    conf = tmp / f"{name}.conf"
    lines = "\n".join(f"{h} = {', '.join(str(tmp / p) for p in ps)}"
                      for h, ps in reads.items())
    conf.write_text(f"""[cluster]
master = {master}
workers = {workers}
backend = {backend}
coordinator_address = 127.0.0.1:{free_port()}
report_port = {free_port()}
{extra_cluster}

[paths]
cuclark_dir = {tmp / name}
database = {tmp / db}
results_dir = results

[classification]
{classification}

[reads]
{lines}

[logging]
level = info
file = cluster_run.log
""")
    return conf


def _report(tmp, name):
    return (tmp / name / "results" / "cluster_report.txt").read_text()


def _result(tmp, name, file):
    return (tmp / name / "results" / file).read_bytes()


# ------------------------------------------------ held to the JAX package
EVERY_KEY = """[cluster]
master = hostM
workers = hostA, hostB
backend = jax_distributed
coordinator_address = 10.0.0.1:4000
ssh_command = ssh -p 22
launch_command = python -m some.cli
report_port = 4100
report_timeout = 33.5

[paths]
cuclark_dir = /srv/clark
database = /srv/db
results_dir = out

[reads]
hostM = /data/m.fq
hostA = /data/a1.fq, /data/a2.fq  # paired
hostB =

[classification]
batch_size = 16
kmer_size = 27
min_freq_target = 2
num_devices = 4
gap_iteration = 3
sampling_factor = 2.0
extended = yes
gzipped = on
shard_db = true
db_cycles = 3
dp = 2

[options]
master_processes_reads = false
keep_local_results = 0

[logging]
level = debug
file = /var/log/c.log
"""


@pytest.mark.parametrize("text", [EVERY_KEY, "[cluster]\n"],
                         ids=["every key", "no key"])
def test_config_load_equals_jax(tmp_path, text):
    conf = tmp_path / "c.conf"
    conf.write_text(text)
    got = dataclasses.asdict(cluster.ClusterConfig.load(str(conf)))
    want = dataclasses.asdict(jcluster.ClusterConfig.load(str(conf)))
    if "launch_command" not in text:  # each package's own entry point
        assert (got.pop("launch_command"), want.pop("launch_command")) == (
            "clark-torch", "clark-tpu")
    assert got == want


def _messages(path) -> list[str]:
    """The logged lines less their timestamps."""
    return [line.split("] ", 1)[1] for line in path.read_text().splitlines()]


@pytest.mark.parametrize("kind", ["good", "bad", "sharded"])
def test_validate_and_preflight_equal_jax(world, tmp_path, kind):
    tmp, _ = world
    if kind == "good":
        conf = _conf(tmp_path, "c", {"nodeA": [tmp / "nodeA.fa"],
                                     "nodeB": [tmp / "nowhere.fa"]},
                     workers="nodeB, nodeC")
        conf.write_text(conf.read_text().replace("coordinator_address", "#"))
    elif kind == "bad":
        conf = _conf(tmp_path, "c", {"nodeA": [tmp / "nodeA.fa"],
                                     "nodeX": ["a", "b", "c"]},
                     db="missing_db")
        conf.write_text(conf.read_text() + "[options]\n"
                        "master_processes_reads = false\n")
    else:
        conf = _conf(tmp_path, "c", {"nodeA": [tmp / "nowhere.fa"]},
                     classification="shard_db = true")
    got, want = [], []
    for mod, logger, out in ((cluster, ClusterLogger, got),
                             (jcluster, JClusterLogger, want)):
        cfg = mod.ClusterConfig.load(str(conf))
        cfg.database = cfg.database.replace(str(tmp_path), str(tmp))
        log_path = tmp_path / f"{mod.__name__}.log"
        log = logger(level="debug", logfile=str(log_path), color=False)
        out.append(cfg.validate())
        out.append(mod.preflight(cfg, log))
        log.close()
        out.append(_messages(log_path))
    assert got == want
    assert got[1] == (kind == "good")


def test_generate_report_equals_jax(tmp_path):
    conf = tmp_path / "c.conf"
    conf.write_text(EVERY_KEY)
    out = {}
    for mod in (cluster, jcluster):
        cfg = mod.ClusterConfig.load(str(conf))
        results = [
            mod.NodeResult("hostM", True, 12.25, 100, "/r/m.csv", "/r/m_ab.csv"),
            mod.NodeResult("hostA", True, 3.0, 7, "/r/a.csv", ""),
            mod.NodeResult("hostB", False, 0.0, error_message="no report"),
        ]
        path = tmp_path / f"{mod.__name__}.txt"
        mod.generate_report(cfg, results, "/r/merged.csv", str(path))
        out[mod] = [line for line in path.read_text().splitlines(True)
                    if "Generated:" not in line]
    assert out[cluster] == out[jcluster]
    assert "  Nodes processed: 2/3\n" in out[cluster]


def test_local_backend_equals_jax(world, tmp_path, monkeypatch):
    """Backend local, two samples on this host: the per-node CSVs, their
    abundances and cluster_abundance.csv byte-equal to the JAX package's
    local-backend run of the same config."""
    tmp, want = world
    host = socket.gethostname()
    reads = {host: [tmp / "nodeA.fa"], "nodeB": [tmp / "r1.fq", tmp / "r2.fq"]}
    monkeypatch.delenv("CLARK_TPU_NODE_NAME", raising=False)
    pconf = _conf(tmp_path, "p", reads, backend="local", master=host)
    jconf = _conf(tmp_path, "j", reads, backend="local", master=host,
                  db="jdb")
    for c in (pconf, jconf):
        c.write_text(c.read_text().replace(str(tmp_path / "db"), str(tmp / "db"))
                     .replace(str(tmp_path / "jdb"), str(tmp / "jdb")))
    assert cli.main(["cluster", "-c", str(pconf), "-p", "--device", "cpu"]) == 0
    assert cli.main(["cluster", "-c", str(pconf), "--device", "cpu"]) == 0
    assert jcluster.main(type("A", (), dict(config=str(jconf), preflight=False,
                                            launch=False))()) == 0
    for f in (f"{host}_nodeA.csv", f"{host}_abundance.csv", "nodeB_r1.csv",
              "nodeB_abundance.csv", "cluster_abundance.csv"):
        assert _result(tmp_path, "p", f) == _result(tmp_path, "j", f), f
    assert _result(tmp_path, "p", f"{host}_nodeA.csv") == want["nodeA"]
    assert _result(tmp_path, "p", "nodeB_r1.csv") == want["paired"]
    assert "Nodes processed: 2/2" in _report(tmp_path, "p")
    assert "[INFO]" in (tmp_path / "p" / "logs" / "cluster_run.log").read_text()


# ------------------------------------------------------ several processes
def test_two_process_sample_parallel(world):
    """Each process classifies its own host's sample (nodeB's a pair of
    FASTQ files); results reach process 0 over the report socket."""
    tmp, want = world
    conf = _conf(tmp, "sp", {"nodeA": ["nodeA.fa"],
                             "nodeB": ["r1.fq", "r2.fq"]})
    for rc, _, err in _cluster_world(tmp, conf):
        assert rc == 0, err[-2000:]
    report = _report(tmp, "sp")
    assert "Nodes processed: 2/2" in report
    assert "nodeA" in report and "nodeB" in report
    assert _result(tmp, "sp", "nodeA_nodeA.csv") == want["nodeA"]
    assert _result(tmp, "sp", "nodeB_r1.csv") == want["paired"]
    assert (tmp / "sp" / "results" / "cluster_abundance.csv").exists()


def test_allgather_bytes(world):
    """128 KiB + 3 B from process 0 and 2 B from process 1 come back whole,
    in process order, on both; agree_max takes the largest; a mesh made
    inside the world crosses processes only where asked; a world of one
    gets its own payload back."""
    tmp, _ = world
    res = _workers(tmp, {"gather": True, "htsize": HTSIZE, "k": K})
    for r in res:
        assert r["gathered"] == [(1 << 17) + 3, 2]
        assert r["ends"] == ["END", "r1"]
        assert r["max"] == 11
        assert r["plain_collective"] is False
    payload = b"x" * (1 << 17) + b"END"
    assert cluster.allgather_bytes(payload) == [payload]


def test_two_process_db_sharded_cli(world):
    """shard_db over two processes in 2 cycles: nodeA's reads and nodeB's
    pairs, each CSV byte-equal to the JAX package's single-process one."""
    tmp, want = world
    conf = _conf(tmp, "sh", {"nodeA": ["nodeA.fa"], "nodeB": ["r1.fq", "r2.fq"]},
                 classification="shard_db = true\ndb_cycles = 2")
    for rc, _, err in _cluster_world(tmp, conf):
        assert rc == 0, err[-2000:]
    assert "Nodes processed: 2/2" in _report(tmp, "sh")
    assert _result(tmp, "sh", "nodeA_nodeA.csv") == want["nodeA"]
    assert _result(tmp, "sh", "nodeB_r1.csv") == want["paired"]
    assert (tmp / "sh" / "results" / "cluster_abundance.csv").exists()
    log = (tmp / "sh" / "logs" / "cluster_run.log").read_text()
    assert "shard_db: 2 devices across 2 processes" in log


def test_two_process_2d_dp_db_cli(world):
    """dp = 2 of num_devices = 4 over two processes: each process's two CPU
    shards split the reads, the table's rows split over the processes."""
    tmp, want = world
    conf = _conf(tmp, "dd", {"nodeA": ["sample.fa"]},
                 classification="shard_db = true\ndp = 2\nnum_devices = 4\n"
                 "extended = true")
    for rc, _, err in _cluster_world(tmp, conf):
        assert rc == 0, err[-2000:]
    assert _result(tmp, "dd", "nodeA_sample.csv") == want["extended"]
    log = (tmp / "dd" / "logs" / "cluster_run.log").read_text()
    assert "shard_db: 4 devices across 2 processes" in log


def test_sharded_meshes_equal_jax(world, tmp_path):
    """A process mesh through the Classifier, batches of 8 reads: db 2
    resident (plain, extended, paired), db 2 in 3 cycles under each
    strategy, and 2 x 2 dp x db; both processes' CSVs byte-equal to the
    JAX package's single-process CSVs; each holds half the rows."""
    tmp, want = world
    inputs = [("plain", str(tmp / "sample.fa"), None, False),
              ("extended", str(tmp / "sample.fa"), None, True),
              ("paired", str(tmp / "r1.fq"), str(tmp / "r2.fq"), False)]
    runs = [dict(tag="res_", mesh=[2], cycles=1, strategy="auto"),
            dict(tag="cnt_", mesh=[2], cycles=3, strategy="counts"),
            dict(tag="lab_", mesh=[2], cycles=3, strategy="labels"),
            dict(tag="2d_", mesh=[1, 2], cycles=1, strategy="auto")]
    res = _workers(tmp, dict(db=str(tmp / "db" / "sub"),
                             targets=str(tmp / "db" / "targets.txt"),
                             htsize=HTSIZE, k=K, out=str(tmp_path),
                             inputs=inputs, runs=runs))
    table = {"sample": want["sample"], "extended": want["extended"],
             "paired": want["paired"]}
    for run in runs:
        for name, _, _, _ in inputs:
            key = "sample" if name == "plain" else name
            for rank in range(2):
                got = (tmp_path / f"{run['tag']}{name}_r{rank}.csv").read_bytes()
                assert got == table[key], (run["tag"], name, rank)
    assert res[0]["local_bytes"] == res[1]["local_bytes"]


def test_cycles_agreed_and_one_call_at_a_time(world, tmp_path):
    """db_cycles auto under two CLARK_TPU_DEVICE_MEM_BYTES limits: each
    process's own count differs, both run the larger; the CSV equals the
    JAX package's.  A process-mesh Classifier refuses classify_files(jobs=2)
    and a second call while one holds it; a dp mesh across processes is
    refused."""
    tmp, want = world
    from jn_cuclark_tpu_torch.engine import BatchPlan, Classifier
    from jn_cuclark_tpu_torch.ops import radix_table
    from jn_cuclark_tpu_torch.io import dbformat

    prof = params.tiny(htsize=HTSIZE, k=K)
    stem = str(tmp / "db" / "sub" / prof.db_stem(K, 3, 0, prof.default_gap))
    keys, labels = dbformat.read_db(stem, prof, K, 1)
    plan = radix_table.plan_table(keys, labels.astype(np.int32) + 1, k=K)
    clf = Classifier(prof, K, ["NA", "800", "801", "802"], keys, labels,
                     plan=BatchPlan(max_reads=8, window_budget=1 << 14),
                     device="cpu")
    per_shard = plan.n_rows * plan.c * 8 // 2
    limit = clf._transient_bytes() + per_shard // 2  # 2 cycles or more
    res = _workers(tmp, dict(db=str(tmp / "db" / "sub"),
                             targets=str(tmp / "db" / "targets.txt"),
                             htsize=HTSIZE, k=K, out=str(tmp_path),
                             inputs=[("plain", str(tmp / "sample.fa"), None,
                                      False)], agree=True),
                   env_of={0: dict(CLARK_TPU_DEVICE_MEM_BYTES=1 << 40),
                           1: dict(CLARK_TPU_DEVICE_MEM_BYTES=limit)})
    assert res[0]["local_cycles"] == 1 < res[1]["local_cycles"]
    assert res[0]["cycles"] == res[1]["cycles"] == res[1]["local_cycles"]
    for rank in range(2):
        assert (tmp_path / f"agree_plain_r{rank}.csv").read_bytes() == \
            want["sample"]
        assert res[rank]["refused"] == ["jobs=2", "a second call",
                                        "mesh_mode dp"]


def test_cluster_self_launch(world):
    """ONE command starts the two-process run: `cluster --launch` spawns
    each worker through an ssh stub with its process id preset and passes
    --device on; the spawned processes import no jax."""
    tmp, want = world
    stub = tmp / "fakessh"
    stub.write_text("#!/bin/sh\nshift\nexec sh -c \"$*\"\n")
    stub.chmod(0o755)
    conf = _conf(tmp, "ln", {"nodeA": ["nodeA.fa"], "nodeB": ["nodeB.fa"]},
                 extra_cluster=f"ssh_command = {stub}\nlaunch_command = "
                 f"{sys.executable} {tmp / 'child.py'}")
    r = subprocess.run(
        [sys.executable, str(tmp / "child.py"), "cluster", "-c", str(conf),
         "--launch", "--device", "cpu"],
        env=_env(), capture_output=True, text=True, timeout=TIMEOUT)
    combined = r.stdout + r.stderr
    assert r.returncode == 0, combined[-3000:]
    assert "[nodeB] SSH preflight OK" in combined
    assert "spawned as process 0/2" in combined
    assert "imported" not in combined
    assert "Nodes processed: 2/2" in _report(tmp, "ln")
    assert _result(tmp, "ln", "nodeA_nodeA.csv") == want["nodeA"]
    assert _result(tmp, "ln", "nodeB_nodeB.csv") == want["nodeB"]


def test_launch_duplicate_workers_rejected(tmp_path):
    conf = tmp_path / "c.conf"
    conf.write_text(
        "[cluster]\nmaster = hostA\nworkers = hostB, hostB\n"
        "backend = jax_distributed\n"
        f"[paths]\ncuclark_dir = {tmp_path}\ndatabase_dir = {tmp_path}\n"
        f"results_dir = {tmp_path}\n[reads]\nhostA = {tmp_path}/r.fa\n"
    )
    cfg = cluster.ClusterConfig.load(str(conf))
    log = ClusterLogger(level="ERROR", logfile=str(tmp_path / "l.log"))
    assert cluster.launch(cfg, log, str(conf)) == 1
    log.close()
    assert "duplicate host" in (tmp_path / "l.log").read_text()


def test_launch_from_another_host_warns(tmp_path):
    """The JAX package's launch calls a log.warning its logger lacks; the
    port warns, then fails the (stubbed, failing) SSH preflight with 1."""
    conf = tmp_path / "c.conf"
    conf.write_text(
        "[cluster]\nmaster = not-this-host\nworkers = hostB\n"
        "backend = jax_distributed\nssh_command = false\n"
        f"[paths]\ncuclark_dir = {tmp_path}\n"
        f"[reads]\nhostB = {tmp_path}/r.fa\n")
    cfg = cluster.ClusterConfig.load(str(conf))
    log = ClusterLogger(level="info", logfile=str(tmp_path / "l.log"))
    assert cluster.launch(cfg, log, str(conf), "cpu") == 1
    log.close()
    text = (tmp_path / "l.log").read_text()
    assert "[WARN] launching from" in text
    assert "[hostB] SSH preflight failed (rc=1)" in text
    jcfg = jcluster.ClusterConfig.load(str(conf))
    jlog = JClusterLogger(level="info", logfile=str(tmp_path / "j.log"))
    with pytest.raises(AttributeError, match="warning"):
        jcluster.launch(jcfg, jlog, str(conf))
    jlog.close()


def test_worker_death_contained(world):
    """Sample-parallel: process 1 dies after classifying, before it
    reports; process 0 neither hangs nor crashes, reports its node FAILED
    and exits 1 with its own sample done."""
    tmp, want = world
    conf = _conf(tmp, "wd", {"nodeA": ["nodeA.fa"], "nodeB": ["nodeB.fa"]},
                 extra_cluster="report_timeout = 20")
    outs = _cluster_world(
        tmp, conf, env_of={1: dict(CLARK_TPU_FAULT_DIE_BEFORE_REPORT=1)})
    assert outs[1][0] == 3
    assert outs[0][0] == 1, outs[0][2][-2000:]
    report = _report(tmp, "wd")
    assert "Nodes processed: 1/2" in report
    assert "no report from process 1" in report
    assert _result(tmp, "wd", "nodeA_nodeA.csv") == want["nodeA"]
    nb = report.split("nodeB:")[1]
    assert "FAILED" in nb.split("\n\n")[0]


def test_sharded_peer_death_fails_with_report(world):
    """shard_db: process 1 dies after loading its shard; process 0's
    all-reduce fails, and it exits 1 with the failure report, never 0."""
    tmp, _ = world
    conf = _conf(tmp, "sd", {"nodeA": ["nodeA.fa"]},
                 classification="shard_db = true")
    outs = _cluster_world(
        tmp, conf, env_of={1: dict(CLARK_TPU_FAULT_DIE_BEFORE_REPORT=1)})
    assert outs[1][0] == 3
    assert outs[0][0] == 1, outs[0][2][-2000:]
    report = _report(tmp, "sd")
    assert "Nodes processed: 0/1" in report
    assert "shard-db collective aborted" in report


def test_cuda_without_a_card_exits_1(world, tmp_path, monkeypatch):
    """--device cuda (the default) on a machine without a CUDA device: rc
    1 and a message, never a run on the CPU."""
    import torch

    tmp, _ = world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = _conf(tmp_path, "nc", {socket.gethostname(): [tmp / "nodeA.fa"]},
                 backend="local", master=socket.gethostname())
    conf.write_text(conf.read_text().replace(str(tmp_path / "db"),
                                             str(tmp / "db")))
    assert cli.main(["cluster", "-c", str(conf)]) == 1
    log = (tmp_path / "nc" / "logs" / "cluster_run.log").read_text()
    assert "no CUDA device" in log
    assert not (tmp_path / "nc" / "results").exists()


@pytest.mark.parametrize("device, env, want", [
    ("cuda", None, "nccl"), ("cpu", None, "gloo"), ("cuda:1", "gloo", "gloo"),
    ("cpu", "nccl", ValueError), ("cuda", "mpi", ValueError)])
def test_backend_for(monkeypatch, device, env, want):
    """NCCL for CUDA devices, gloo for the CPU, CLARK_TPU_DIST_BACKEND's
    choice where it is set; no backend the device cannot run."""
    if env is None:
        monkeypatch.delenv("CLARK_TPU_DIST_BACKEND", raising=False)
    else:
        monkeypatch.setenv("CLARK_TPU_DIST_BACKEND", env)
    if want is ValueError:
        with pytest.raises(ValueError):
            dist.backend_for(device)
    else:
        assert dist.backend_for(device) == want


def test_world_from_env(monkeypatch):
    for key in ("CLARK_TPU_NUM_PROCESSES", "CLARK_TPU_PROCESS_ID",
                "CLARK_TPU_COORDINATOR", "WORLD_SIZE", "RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    coord, n, rank = dist.world_from_env()
    assert (n, rank) == (1, 0) and coord.startswith("127.0.0.1:")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    with pytest.raises(ValueError, match="coordinator"):
        dist.world_from_env()
    monkeypatch.setenv("MASTER_ADDR", "h")
    monkeypatch.setenv("MASTER_PORT", "9")
    assert dist.world_from_env() == ("h:9", 4, 3)
    monkeypatch.setenv("CLARK_TPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("CLARK_TPU_PROCESS_ID", "1")
    monkeypatch.setenv("CLARK_TPU_COORDINATOR", "c:1")
    assert dist.world_from_env() == ("c:1", 2, 1)
    with pytest.raises(ValueError, match="outside"):
        dist.world_from_env(process_id=2)


def test_process_mesh_is_asked_for():
    """make_mesh and make_mesh2d give a process mesh only where the caller
    asks for one (across_processes=True), and that needs a world."""
    from jn_cuclark_tpu_torch.parallel.mesh import make_mesh, make_mesh2d

    assert not make_mesh(2, device="cpu").collective
    assert not make_mesh2d(1, 2, device="cpu").collective
    with pytest.raises(ValueError, match="world"):
        make_mesh(2, device="cpu", across_processes=True)
    with pytest.raises(ValueError, match="world"):
        make_mesh2d(1, 2, device="cpu", across_processes=True)


def test_torchrun_local_rank(monkeypatch):
    """Under torchrun (LOCAL_RANK set) a process drives cuda:LOCAL_RANK
    alone, its current device and its mesh's only card; a share of more
    than one card, or a LOCAL_RANK past the host's cards, raises.
    Without LOCAL_RANK a process takes every card it sees."""
    from jn_cuclark_tpu_torch.parallel.mesh import process_devices

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert dist.local_device("cuda") == cards[0]
    assert process_devices(None, "cuda") == cards
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert dist.local_device("cuda") == cards[2]
    assert dist.local_device("cuda:1") == cards[1]
    assert dist.local_device("cpu") == torch.device("cpu")
    assert process_devices(None, "cuda") == [cards[2]]
    assert process_devices(1, "cuda") == [cards[2]]
    assert process_devices(None, "cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="one card"):
        process_devices(2, "cuda")
    monkeypatch.setenv("LOCAL_RANK", "4")
    with pytest.raises(ValueError, match="LOCAL_RANK=4"):
        process_devices(None, "cuda")
