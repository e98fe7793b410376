"""Run one cell of the port's benchmark on the machine it is started on.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Set-up, timed from this module's first line:
the cell's genomes and sample made from the seed on the card, the database
built with `build_database` into a directory under TMPDIR, loaded with
`Classifier.load(device="cuda")` (the default BatchPlan, the
configuration's "load" options: db_cycles "auto" in both of today's
configurations), and one warm-up pass over the sample's first share.  The
window then runs passes over the sample (the cell's generator's run_pass:
`Classifier.classify_bytes(sample)` by default) until --seconds have
passed.  It keeps the first pass's rows; every later pass is compared with
them chunk by chunk as it arrives and dropped.  After the window the peak
device memory is read, the Classifier freed, and the generator's plain
reference works out every read's row from the genomes and the sample; the
first timed pass must match it row for row and every later pass the first
byte for byte.

With --trace 0 the result holds the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, read from the program's phase timers and
a profiler trace of the window (portbench/trace.py).  The result is the
last line of standard output; the numbers compared, each with its limit,
come last on standard error and last in the result.  Without a CUDA card,
with fewer cards than the cell asks for, or with jax, jaxlib, flax or
jn_cuclark_tpu loaded once the window closes, the run prints no result and
exits with a code other than 0.
"""

import time

T0 = time.perf_counter()  # set-up counts from here, torch's import included

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402

from portbench import gen, roofline, spec  # noqa: E402
from portbench import trace as tracing  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "jn_cuclark_tpu"}
LIMITS = {"rows_wrong": 0}  # an exact comparison


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _profile(cfg: dict):
    from jn_cuclark_tpu_torch.params import Profile

    return Profile(name="light" if cfg["light"] else "full",
                   htsize=cfg["htsize"], light=cfg["light"],
                   default_k=cfg["k"], default_gap=cfg["gap"],
                   maxhits=cfg["maxhits"])


def set_up(cell: spec.Cell, seed: int, device, work: str, t0: float):
    """Inputs, build, load and warm-up; returns (classifier, sample,
    targets file, set-up parts in seconds)."""
    import torch

    from jn_cuclark_tpu_torch.db.builder import build_database
    from jn_cuclark_tpu_torch.engine import Classifier
    from jn_cuclark_tpu_torch.io.targets import parse_targets

    cfg = cell.config
    parts = {"start_s": time.perf_counter() - t0}
    t = time.perf_counter()
    torch.zeros(1, device=device)  # the device's context
    parts["context_s"] = time.perf_counter() - t
    t = time.perf_counter()
    genomes = gen.make_genomes(cfg, seed, device)
    targets_file = gen.write_genomes(genomes, cfg, work)
    sample, warm = cell.generator.make_sample(cell.traffic, genomes, seed,
                                              device)
    del genomes
    parts["inputs_s"] = time.perf_counter() - t
    if torch.device(device).type == "cuda":
        # the peak covers what the program allocates, not the generator
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    profile, targets = _profile(cfg), parse_targets(targets_file)
    db = os.path.join(work, "db")
    os.makedirs(db)
    t = time.perf_counter()
    build_database(targets, db, profile, cfg["k"],
                   min_count_target=cfg["min_count_target"], device=device)
    parts["db_build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    clf = Classifier.load(db, targets, profile, cfg["k"],
                          min_count_target=cfg["min_count_target"],
                          device=device, **cfg.get("load", {}))
    parts["load_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for _ in cell.generator.run_pass(clf, warm):
        pass
    parts["warmup_s"] = time.perf_counter() - t
    return clf, sample, targets_file, parts


def _cpu_s() -> float:
    """This process's CPU seconds, all its threads."""
    use = resource.getrusage(resource.RUSAGE_SELF)
    return use.ru_utime + use.ru_stime


def drain(chunks, first: list):
    """Run a pass's row chunks to their end, comparing each as it comes
    with the first pass's chunks `first` and dropping it.  Returns None
    where the pass joins to the first's bytes, else the pass's rows."""
    want, buf, done, rows = iter(first), b"", 0, None
    for c in chunks:
        if rows is None:
            while len(buf) < len(c) and (nxt := next(want, None)) is not None:
                buf += nxt  # no copy where the chunks fall alike
            if buf[:len(c)] == c:
                buf, done = buf[len(c):], done + len(c)
                continue
            rows = b"".join(first)[:done].count(b"\n")
        rows += c.count(b"\n")
    if rows is None and (buf or any(want)):  # the pass ended short
        rows = b"".join(first)[:done].count(b"\n")
    return rows


def window(clf, sample, seconds: float, traced: bool, run_pass=gen.run_pass):
    """Whole passes until `seconds` have passed.  Returns the first pass's
    rows, the passes, the rows of each pass unlike the first, the window's
    seconds and the program's phase totals (None untraced)."""
    import torch

    from jn_cuclark_tpu_torch.utils import profiling

    first, ends, unlike = None, [], []
    timers = profiling.collect() if traced else contextlib.nullcontext()
    with timers as phases, torch.profiler.record_function(
            tracing.WINDOW_SPAN):
        t = time.perf_counter()
        while True:
            if first is None:
                first = list(run_pass(clf, sample))
            elif (rows := drain(run_pass(clf, sample), first)) is not None:
                unlike.append(rows)
            ends.append(time.perf_counter() - t)
            if ends[-1] >= seconds:
                break
    print("pass seconds: " + json.dumps(np.diff([0.0] + ends).tolist()),
          file=sys.stderr)
    return types.SimpleNamespace(
        first=b"".join(first), passes=len(ends), unlike=unlike,
        seconds=ends[-1], phases=dict(phases.totals) if traced else None)


def judge(cell: spec.Cell, sample, targets_file: str, first: bytes,
          passes: int, unlike: int, device, count_queried: bool = False):
    """Compare a run's rows with the plain reference's: (checks
    {name: value}, the reference's work for the roofline).  rows_wrong
    counts, over `passes` passes, the rows unlike the reference's row of
    their read: the first pass's (`first`) row by row, and all of a pass
    for each of the `unlike` passes not byte-equal to the first."""
    want, work = cell.generator.expected(sample, targets_file, cell.config,
                                         device, count_queried=count_queried)
    wrong = 0
    if first != want:
        g, w = first.split(b"\n"), want.split(b"\n")
        wrong = sum(a != b for a, b in zip(g, w)) + abs(len(g) - len(w))
    print(f"passes {passes}, unlike the first {unlike}; rows unlike the "
          f"reference in the first {wrong}", file=sys.stderr)
    return {"rows_wrong": wrong * (passes - unlike)
            + work["reads"] * unlike}, work


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device="cuda", t0: float = T0) -> dict:
    """One run of a cell; returns the result's object."""
    import torch

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    work = tempfile.mkdtemp(prefix="portbench-")
    try:
        clf, sample, targets_file, parts = set_up(cell, seed, dev, work, t0)
        parts["setup_s"] = time.perf_counter() - t0
        print("setup parts: " + json.dumps(parts), file=sys.stderr)
        with (tracing.session(os.path.join(work, "window.json"), dev)
              if traced else contextlib.nullcontext()) as rec:
            cpu = _cpu_s()
            win = window(clf, sample, seconds, traced,
                         cell.generator.run_pass)
            print(f"process CPU over the window: {_cpu_s() - cpu:.2f} s",
                  file=sys.stderr)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        print("host peak rss: %d KiB" % resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss, file=sys.stderr)
        del clf
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t = time.perf_counter()
        checks, work_done = judge(cell, sample, targets_file, win.first,
                                  win.passes, len(win.unlike), dev, traced)
        print(f"reference: {time.perf_counter() - t:.3f} s", file=sys.stderr)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    ctx = types.SimpleNamespace(
        rows=(win.first.count(b"\n") * (win.passes - len(win.unlike))
              + sum(win.unlike)),
        passes=win.passes, window_s=win.seconds, setup=parts,
        peak_bytes=peak, phases=win.phases, trace=None, kind=kind,
        floor_bytes=roofline.floor_bytes(**work_done) if traced else None)
    device_out = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                  "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": all(v <= LIMITS[k] for k, v in checks.items()),
           "attempted": win.passes * work_done["reads"],
           "failed": checks["rows_wrong"]}
    if traced:
        ctx.trace = tracing.summary(rec["events"])
        session = {k: v for k, v in rec.items() if k != "events"}
        print("trace session: " + json.dumps(session), file=sys.stderr)
        device_out.update(busy_s=ctx.trace["busy_s"],
                          window_s=ctx.trace["window_s"])
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out.update(metrics=metrics, device=device_out)
    if traced:
        out["breakdown"] = {"device_ops": ctx.trace["device_ops"],
                            "idle_gaps": ctx.trace["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": LIMITS[k]}
                     for k, v in checks.items()}
    return out


def host_facts() -> dict:
    """CPUs, affinity and the card's name and power limit."""
    facts = {"cpu_count": os.cpu_count(),
             "affinity": len(os.sched_getaffinity(0))}
    try:
        facts["gpu"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        facts["gpu"] = f"nvidia-smi: {e}"
    return facts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(spec.load(), args.workload)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); {found} "
              "found", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    print("host: " + json.dumps(host_facts()), file=sys.stderr)
    loaded = forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
