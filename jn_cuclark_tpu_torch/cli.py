"""clark-torch — command line of the PyTorch/CUDA port.

Subcommands (reference equivalents):
    db build         kent -d build step / cuCLARK DB construction
    classify         kent -c / classify_metagenome.sh / cuCLARK[-l]

Classification (single-end, paired-end, --extended, list mode with
--jobs) runs on one device, the table resident or streamed in
--db-cycles chunks, or over several devices of one process: `-d N` splits
the reads over N devices, `-d N --shard-db` splits the table's rows (which
composes with --db-cycles), and `--dp M` with --shard-db does both on an
M x N/M mesh.  `--device` picks cuda (the first N cards; N more than the
machine has raises) or cpu (N CPU shards).  The other `db` workflows
(set-targets, update-taxonomy, download-*, clean) and the other
subcommands of `jn_cuclark_tpu.cli` (abundance, merge, report, verify,
cluster) wait for ROADMAP A9-A10; the `db` ones are listed and raise.

Run `python -m jn_cuclark_tpu_torch.cli classify --help` for flags.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import os
import sys
import tempfile
import time


def _profile_from_args(args, cfg=None):
    from .params import FULL, LIGHT, Profile

    if getattr(args, "light", False):
        prof = LIGHT
    elif getattr(args, "full", False):
        prof = FULL
    elif cfg is not None:
        prof = cfg.profile
    else:
        prof = LIGHT
    if getattr(args, "htsize", None):
        prof = Profile(
            name=f"custom{args.htsize}",
            htsize=args.htsize,
            light=prof.light,
            default_k=args.k or prof.default_k,
            default_gap=getattr(args, "gap", None) or prof.default_gap,
        )
    return prof


def _mesh_from_args(args):
    """(mesh or None, mesh_mode) from -d/--dp/--shard-db, read as the JAX
    package's CLI reads them, over --device's devices."""
    from .parallel.mesh import make_mesh, make_mesh2d

    mesh_mode = "db" if args.shard_db else "dp"
    if args.dp and not args.shard_db:
        raise SystemExit(
            "--dp selects the data-parallel width of a 2-D dp x db mesh and "
            "requires --shard-db (for pure read sharding use -d N)"
        )
    try:
        if args.dp and args.dp > 1:
            # 2-D composition: reads over 'dp' x table over 'db'
            import torch

            total = args.devices or (torch.cuda.device_count()
                                     if args.device.startswith("cuda") else 1)
            if total % args.dp:
                raise SystemExit(
                    f"--dp {args.dp} must divide the device count {total}")
            return make_mesh2d(args.dp, total // args.dp,
                               device=args.device), "dp"
        if args.devices and args.devices > 1:
            return make_mesh(args.devices, device=args.device), mesh_mode
    except ValueError as e:  # fewer devices than asked for
        raise SystemExit(str(e)) from e
    return None, mesh_mode


def _parse_cycles(v) -> int | str:
    if isinstance(v, str) and v != "auto":
        try:
            return int(v)
        except ValueError:
            raise SystemExit(
                f"--db-cycles must be an integer or 'auto', got {v!r}")
    return v


def _load_classifier(args):
    from . import database
    from .engine import Classifier

    try:
        cfg = database.DBConfig.load(args.db)
    except FileNotFoundError:
        raise SystemExit(
            f"{args.db}: not a clark database directory (no config.json)"
        )
    prof = _profile_from_args(args, cfg)
    mesh, mesh_mode = _mesh_from_args(args)
    return Classifier.load(
        cfg.subdb,
        args.targets or cfg.targets,
        prof,
        k=args.k if args.k is not None else cfg.k,
        min_count_target=(
            args.min_freq_target
            if args.min_freq_target is not None
            else cfg.min_count_target
        ),
        sampling_factor=args.sampling_factor,
        gap=args.gap if args.gap is not None else cfg.gap,
        device=args.device,
        db_cycles=_parse_cycles(args.db_cycles),
        mesh=mesh,
        mesh_mode=mesh_mode,
    )


def _maybe_gunzip(path: str, tmpdir: str) -> str:
    if not path.endswith(".gz"):
        return path
    out = os.path.join(tmpdir, os.path.basename(path)[:-3])
    with gzip.open(path, "rb") as f, open(out, "wb") as g:
        g.write(f.read())
    return out


def cmd_classify(args):
    import torch

    try:
        return _cmd_classify(args)
    except torch.OutOfMemoryError as e:  # actionable OOM guidance (CUMEMERR
        # parity: the reference prints "increase -b" advice, CuClarkDB.cu:45-73)
        raise SystemExit(
            "Device out of memory during classification.\n"
            f"  {str(e).splitlines()[0][:200]}\n"
            "Try: --db-cycles N (stream the DB in N chunks) or --shard-db "
            "(split the DB index over devices).  --db-cycles auto (the "
            "default) budgets the DB from the card's memory; if the limit "
            "was misdetected, set CLARK_TPU_DEVICE_MEM_BYTES."
        ) from e


def _cmd_classify(args):
    if args.threads:
        os.environ["OMP_NUM_THREADS"] = str(args.threads)
    clf = _load_classifier(args)

    objects, paired, results = args.objects, args.paired, args.results
    with tempfile.TemporaryDirectory() as td:
        if args.gzipped:
            if objects:
                objects = _maybe_gunzip(objects, td)
            if paired:
                paired = [_maybe_gunzip(p, td) for p in paired]
        # multi-file list mode: an objects file (or, paired, an R1 file)
        # whose first byte is not a record start lists input files,
        # line-aligned with a list of result names (CuCLARK_hh.hh:384-429,
        # 483-502)
        jobs = []
        if paired:
            with open(paired[0], "rb") as f:
                first = f.read(1)
            if first == b"@":
                jobs.append((paired[0], paired[1], results))
            else:
                with open(paired[0]) as f1, open(paired[1]) as f2, open(
                    results
                ) as fr:
                    for l1, l2, lr in zip(f1, f2, fr):
                        l1, l2, lr = l1.strip(), l2.strip(), lr.strip()
                        if l1 and l2 and lr:
                            jobs.append((l1, l2, lr))
        else:
            with open(objects, "rb") as f:
                first = f.read(1)
            if first in (b">", b"@"):
                jobs.append((objects, None, results))
            else:
                with open(objects) as fo, open(results) as fr:
                    for oline, rline in zip(fo, fr):
                        oline, rline = oline.strip(), rline.strip()
                        if oline and rline:
                            jobs.append((oline, None, rline))

        from .utils import profiling

        if args.jobs > 1 and len(jobs) > 1 and not args.profile:
            # concurrent list mode (cycle-outer when the table is cycled)
            for (obj, _, _), stats in zip(jobs, clf.classify_files(
                    jobs, jobs=args.jobs, extended=args.extended)):
                # cycle-outer runs interleave the samples in each table
                # pass: seconds and rate are the whole batch's
                agg = " [whole batch]" if stats.get("aggregate") else ""
                print(
                    f"{obj}: done in {stats['seconds']:.1f}s{agg} "
                    f"({stats['reads_per_min']} reads/min, "
                    f"{stats['reads']} reads) -> {stats['result']}",
                    file=sys.stderr,
                )
            return 0
        for obj, mate, res in jobs:
            print(f"Classifying: {obj}", file=sys.stderr)
            ctx = profiling.collect() if args.profile else contextlib.nullcontext()
            with ctx as phases:
                stats = clf.classify_file(obj, res, paired_path=mate,
                                          extended=args.extended)
            if args.verbose and stats.get("hit_stats") is not None:
                # distinct-targets-hit distribution, as the reference prints
                # after its extended writer (CuCLARK_hh.hh:2064-2067)
                print(stats["hit_stats"].report(), file=sys.stderr)
            print(
                f"Done in {stats['seconds']:.1f}s "
                f"({stats['reads_per_min']} reads/min, {stats['reads']} reads)",
                file=sys.stderr,
            )
            print(f"Results: {stats['result']}", file=sys.stderr)
            if phases is not None:
                print(phases.summary(), file=sys.stderr)
    return 0


def cmd_db_build(args):
    from . import database

    cfg = database.DBConfig.load(args.db)
    prof = _profile_from_args(args, cfg)
    t0 = time.time()
    db = database.build(
        cfg,
        profile=prof,
        k=args.k,
        gap=args.gap,
        min_count_target=args.min_freq_target,
        tsk=args.tsk,
        device=args.device,
    )
    print(
        f"Database built: {len(db.canonical)} discriminative k-mers "
        f"({db.n_mother} distinct) in {time.time() - t0:.1f}s"
    )
    return 0


def cmd_db_not_ported(args):
    from .engine import _not_ported

    raise _not_ported(f"db {args.dbcmd}", "A10")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="clark-torch",
        description="CLARK metagenomic classifier on PyTorch/CUDA",
    )
    from . import __version__

    p.add_argument("--version", action="version",
                   version=f"clark-torch {__version__}")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_profile_flags(sp):
        sp.add_argument("-k", type=int, default=None, help="k-mer length")
        sp.add_argument("--light", action="store_true",
                        help="light profile (cuCLARK-l)")
        sp.add_argument("--full", action="store_true",
                        help="full profile (cuCLARK)")
        sp.add_argument("--htsize", type=int, default=None,
                        help="custom hash-table size")
        sp.add_argument("-g", "--gap", type=int, default=None,
                        help="light-mode k-mer gap")
        sp.add_argument("-t", "--min-freq-target", type=int, default=None,
                        help="minimum k-mer frequency in targets")

    pd = sub.add_parser("db", help="database workflows")
    dsub = pd.add_subparsers(dest="dbcmd", required=True)
    pb = dsub.add_parser("build", help="build the discriminative k-mer database")
    pb.add_argument("db", help="database directory (with config.json)")
    add_profile_flags(pb)
    pb.add_argument("--tsk", action="store_true",
                    help="write per-target .ht files")
    pb.add_argument("--device", nargs="?", const="cuda", default="cuda",
                    help="where k-mers aggregate: cuda (the default: "
                    "the hand-written K6 kernel; raises without a CUDA "
                    "device), cpu (its plain-PyTorch twin) "
                    "or host (the native C++ aggregate); --tsk builds and "
                    "spectrum inputs always aggregate on the host")
    pb.set_defaults(fn=cmd_db_build)
    for name in ("set-targets", "update-taxonomy", "download-taxonomy",
                 "download-genomes", "clean"):
        pn = dsub.add_parser(name, help="not ported yet (ROADMAP A10)")
        pn.add_argument("rest", nargs="*", help=argparse.SUPPRESS)
        pn.set_defaults(fn=cmd_db_not_ported)

    pc = sub.add_parser("classify", help="classify reads against a database")
    pc.add_argument("-D", "--db", required=True, help="database directory")
    pc.add_argument("-O", "--objects", help="reads file (or list of files)")
    pc.add_argument("-T", "--targets", default=None,
                    help="targets definition file (default: the one recorded "
                    "in config.json)")
    pc.add_argument("-P", "--paired", nargs=2, metavar=("R1", "R2"),
                    help="paired-end FASTQ files (or two line-aligned lists "
                    "of them)")
    pc.add_argument("-R", "--results", required=True,
                    help="results path (.csv appended)")
    add_profile_flags(pc)
    pc.add_argument("-s", "--sampling-factor", type=int, default=1)
    pc.add_argument("-n", "--threads", type=int, default=None,
                    help="host threads for the native runtime (default: all)")
    pc.add_argument("--jobs", type=int, default=1,
                    help="list mode: files classified concurrently (with a "
                    "cycled table, every file runs through each chunk "
                    "upload)")
    pc.add_argument("-b", "--batches", type=int, default=None,
                    help="accepted for cuCLARK compatibility; batching is "
                    "automatic")
    pc.add_argument("--extended", action="store_true",
                    help="per-target score columns")
    pc.add_argument("--verbose", action="store_true",
                    help="with --extended, print the distinct-targets-hit "
                    "report (MIN/MAX/AVG) to stderr")
    pc.add_argument("--gzipped", action="store_true", help="inputs are gzipped")
    pc.add_argument("-d", "--devices", type=int, default=None,
                    help="devices to shard over: the reads, or with "
                    "--shard-db the DB index (the first N of --device's "
                    "kind; N CPU shards with --device cpu)")
    pc.add_argument("--dp", type=int, default=None,
                    help="with --shard-db: data-parallel width of a 2-D "
                    "dp x db mesh (reads sharded over dp, table rows over "
                    "db = devices/dp)")
    pc.add_argument("--shard-db", action="store_true",
                    help="shard the DB index over devices (for DBs larger "
                    "than one device's memory) instead of sharding reads")
    pc.add_argument("--db-cycles", default="auto",
                    help="stream the DB index in N chunks; auto (default) "
                    "streams only a table above the device budget, or keeps "
                    "it resident in the dense layout where that fits")
    pc.add_argument("--device", default="cuda",
                    help="torch device: cuda (default, hand-written kernels) "
                    "or cpu (plain-PyTorch twins); with -d, the kind of the "
                    "mesh's devices")
    pc.add_argument("--profile", action="store_true",
                    help="print phase timing summary")
    pc.set_defaults(fn=cmd_classify)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "classify" and not args.objects and not args.paired:
        print("classify: provide -O <reads> or -P <r1> <r2>", file=sys.stderr)
        return 1
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
