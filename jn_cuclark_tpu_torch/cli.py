"""clark-torch — command line of the PyTorch/CUDA port.

Subcommands (reference equivalents):
    db set-targets   kent -d / set_targets.sh + make_metadata.sh
    db build         kent -d build step / cuCLARK DB construction
    db update-taxonomy, download-taxonomy, download-genomes, clean
                     updateTaxonomy.sh, scripts/download/*.sh, clean.sh
    classify         kent -c / classify_metagenome.sh / cuCLARK[-l]
    abundance        kent -a / estimate_abundance.sh / getAbundance
    merge            kent -m
    report           kent -r
    verify           kent --verify
    cluster          kent-mpi (-p preflight, --launch self-launch)

Classification (single-end, paired-end, --extended, list mode with
--jobs) runs on one device, the table resident or streamed in
--db-cycles chunks, or over several devices of one process: `-d N` splits
the reads over N devices, `-d N --shard-db` splits the table's rows (which
composes with --db-cycles), and `--dp M` with --shard-db does both on an
M x N/M mesh.  `--device` picks cuda (the first N cards; N more than the
machine has raises) or cpu (N CPU shards); `--trace-dir DIR` writes a
torch.profiler trace of the run to DIR.  abundance, merge and report
run on the host; verify runs a toy batch through K1-K3 on `--device`.
`cluster -c CONF` runs a cluster config: its samples one after another
(backend local), or one process per host over torch.distributed (backend
jax_distributed), each classifying its own samples
or, with shard_db, holding 1/P of the table while all classify every
sample together (cluster.py).

Run `python -m jn_cuclark_tpu_torch.cli <cmd> --help` for flags.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
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

        traced = functools.partial(profiling.trace, args.trace_dir,
                                   cuda=clf.device.type == "cuda")
        if args.jobs > 1 and len(jobs) > 1 and not args.profile:
            # concurrent list mode (cycle-outer when the table is cycled)
            with traced():
                stats_list = clf.classify_files(jobs, jobs=args.jobs,
                                                extended=args.extended)
            for (obj, _, _), stats in zip(jobs, stats_list):
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
        with traced():
            for obj, mate, res in jobs:
                print(f"Classifying: {obj}", file=sys.stderr)
                ctx = (profiling.collect() if args.profile
                       else contextlib.nullcontext())
                with ctx as phases:
                    stats = clf.classify_file(obj, res, paired_path=mate,
                                              extended=args.extended)
                if args.verbose and stats.get("hit_stats") is not None:
                    # distinct-targets-hit distribution, as the reference
                    # prints after its extended writer
                    # (CuCLARK_hh.hh:2064-2067)
                    print(stats["hit_stats"].report(), file=sys.stderr)
                print(
                    f"Done in {stats['seconds']:.1f}s "
                    f"({stats['reads_per_min']} reads/min, "
                    f"{stats['reads']} reads)",
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


def cmd_db_set_targets(args):
    from . import database

    prof = _profile_from_args(args)
    cfg = database.set_targets(args.db, rank=args.rank, profile=prof)
    n = sum(1 for _ in open(cfg.targets))
    print(f"Targets definition written: {cfg.targets} ({n} targets)")
    print(f"Database sub-directory: {cfg.subdb}")
    return 0


def _taxonomy_files() -> list[str]:
    from . import database

    return database.TAXONOMY_FILES + ["nucl_accss"]


def cmd_db_update_taxonomy(args):
    """scripts/updateTaxonomy.sh equivalent, minus the wget: with --from,
    install taxonomy data from an already-downloaded directory or
    taxdump.tar.gz (extract *.dmp, concatenate nucl_gb + nucl_wgs
    accession2taxid into nucl_accss, touch <db>/.taxondata); without
    --from, print what to fetch and validate what is present.  The fetch
    itself is `clark-torch db download-taxonomy` where egress exists."""
    from . import download

    tax = os.path.join(args.db, "taxonomy")
    if args.src is not None:
        try:
            download.install_taxonomy(args.src, tax)
        except download.DownloadError as e:
            print(e)
            return 1
    else:
        print(
            "No --from given.  With network egress, run:"
            "\n  clark-torch db download-taxonomy " + args.db +
            "\nor fetch from ftp://ftp.ncbi.nih.gov/pub/taxonomy/:"
            "\n  taxdump.tar.gz"
            "\n  accession2taxid/nucl_gb.accession2taxid.gz"
            "\n  accession2taxid/nucl_wgs.accession2taxid.gz"
            "\nthen: clark-torch db update-taxonomy " + args.db
            + " --from <download-dir>"
        )
    missing = [
        f for f in _taxonomy_files() if not os.path.exists(os.path.join(tax, f))
    ]
    if missing:
        print("\nCurrently missing: " + ", ".join(missing))
        return 1
    # the reference marks completion with <db>/.taxondata
    # (updateTaxonomy.sh: `touch ../.taxondata`; checked by kent.cpp:178-265)
    open(os.path.join(args.db, ".taxondata"), "a").close()
    print("\nAll taxonomy files present.")
    return 0


def cmd_db_download_taxonomy(args):
    """scripts/updateTaxonomy.sh + download/download_taxondata.sh: fetch
    the NCBI taxonomy payload into <db>/taxonomy and install it."""
    from . import download

    try:
        download.download_taxonomy(
            os.path.join(args.db, "taxonomy"), base_url=args.base_url
        )
    except download.DownloadError as e:
        print(e)
        return 1
    missing = [
        f for f in _taxonomy_files()
        if not os.path.exists(os.path.join(args.db, "taxonomy", f))
    ]
    if missing:
        print("Missing after download: " + ", ".join(missing))
        return 1
    print("All taxonomy files present.")
    return 0


def cmd_db_download_genomes(args):
    """The reference's three genome-download flows
    (scripts/download/download_data{_newest,_release,}.sh), selected by
    --flow: newest (assembly_summary latest Complete Genome, the default),
    release (dated RefSeq release volumes split per sequence), archive
    (legacy old_refseq tarballs / per-chromosome human)."""
    from . import download

    try:
        if args.flow == "release":
            base = args.base_url or download.NCBI_RELEASE_BASE
            manifest = download.download_genomes_release(
                args.dir, args.group, base_url=base, limit=args.limit
            )
        elif args.flow == "archive":
            base = args.base_url or download.NCBI_GENOMES_BASE
            manifest = download.download_genomes_archive(
                args.dir, args.group, base_url=base
            )
        else:
            base = args.base_url or download.NCBI_REFSEQ_BASE
            manifest = download.download_genomes(
                args.dir, args.group, base_url=base, limit=args.limit
            )
    except download.DownloadError as e:
        print(f"Error: {e}")
        return 1
    n = sum(1 for ln in open(manifest) if not ln.startswith("#"))
    print(f"Manifest: {manifest} ({n} sequences)")
    return 0


def cmd_db_clean(args):
    """Reset DB products: targets.txt, custom_* sub-DBs, metadata dotfiles
    (scripts/clean.sh --reset semantics; Custom/ and taxonomy/ are kept)."""
    import glob
    import shutil

    db = args.db
    if not os.path.isdir(db):
        print(f"database directory not found: {db}", file=sys.stderr)
        return 1
    victims = (
        [os.path.join(db, "targets.txt"), os.path.join(db, "files_excluded.txt"),
         os.path.join(db, "config.json")]
        + glob.glob(os.path.join(db, ".custom*"))
        + glob.glob(os.path.join(db, "custom_*"))
    )
    victims = [v for v in victims if os.path.exists(v)]
    if not victims:
        print("nothing to clean")
        return 0
    if not args.yes:
        print("Will remove:")
        for v in victims:
            print(f"  {v}")
        ans = input("Are you sure you want to reset the database? (yes/no) ")
        if ans.strip().lower() not in ("y", "yes"):
            print("Aborting database reset.")
            return 1
    for v in victims:
        if os.path.isdir(v):
            shutil.rmtree(v)
        else:
            os.remove(v)
    print("Database reset complete.")
    return 0


def cmd_abundance(args):
    from . import abundance

    res = abundance.estimate(
        args.files,
        db_dir=args.db,
        min_confidence=args.min_confidence,
        min_gamma=args.min_gamma,
        min_abundance=args.min_abundance,
        high_confidence=args.highconfidence,
        krona_path="results.krn" if args.krona else None,
        mpa_path="results.mpa" if args.mpa else None,
    )
    out = sys.stdout
    if args.output:
        out = open(args.output, "w")
    out.write(res.text())
    if args.output:
        out.close()
        print(f"Abundance written to {args.output}", file=sys.stderr)
    return 0


def cmd_merge(args):
    from . import abundance

    stats = abundance.merge(args.files, args.output)
    print(
        f"Merged {stats['files']} abundance files ({stats['total']} total "
        f"reads) -> {stats['output']}"
    )
    return 0


def cmd_report(args):
    from . import abundance

    stats = abundance.report(args.file, args.output)
    print(f"Report written to {stats['output']}")
    return 0


def cmd_verify(args):
    """Installation + database health check (kent --verify)."""
    ok = True

    def check(name, fn):
        nonlocal ok
        try:
            detail = fn()
            print(f"  [OK]   {name}" + (f" ({detail})" if detail else ""))
        except Exception as e:  # noqa: BLE001
            print(f"  [FAIL] {name}: {e}")
            ok = False

    print("clark-torch installation check:")
    check("python package",
          lambda: __import__("jn_cuclark_tpu_torch").__version__)
    devices = _cuda_devices()
    if devices:
        print(f"  [OK]   cuda devices ({devices})")
    else:
        print("  [WARN] cuda devices: none (torch.cuda.is_available() is "
              "false)")
    # the port has no numpy fallback: a runtime that does not build fails
    check("native runtime (clark_native)", _check_native)
    check("device pipeline", lambda: _check_pipeline(args.device))
    if args.db:
        from . import database

        problems = database.check_layout(args.db)
        for p in problems:
            print(f"  [FAIL] db layout: {p}")
        ok = ok and not problems
        if not problems:
            print(f"  [OK]   db layout: {args.db}")
        try:
            cfg = database.DBConfig.load(args.db)
            stem = os.path.join(
                cfg.subdb,
                cfg.profile.db_stem(cfg.k, _count_targets(cfg),
                                    cfg.min_count_target, cfg.gap),
            )
            from .io import dbformat

            if dbformat.db_exists(stem):
                print(f"  [OK]   database files: {stem}.(sz|ky|lb)")
            else:
                print(f"  [WARN] database not built yet (expected {stem}.*)")
        except FileNotFoundError:
            print(f"  [WARN] no config.json in {args.db} (run db set-targets)")
    print("STATUS: " + ("READY" if ok else "INCOMPLETE"))
    return 0 if ok else 1


def _cuda_devices() -> str:
    """The CUDA devices with their names and compute capabilities."""
    import torch

    if not torch.cuda.is_available():
        return ""
    out = []
    for i in range(torch.cuda.device_count()):
        major, minor = torch.cuda.get_device_capability(i)
        out.append(f"cuda:{i} {torch.cuda.get_device_name(i)} "
                   f"sm_{major}{minor}")
    return ", ".join(out)


def _check_native():
    from .utils import native

    native._load()
    return None


def toy_step(device):
    """A single classification step on a toy input: 4,096 random keys of 16
    targets in a radix table, 64 random reads of 100 bp packed at stride
    128, k = 27, through K1, K2 and K3 (`device_pipeline.classify_batch`)
    on `device`; returns (total, ibest, best, sbest).  The inputs are those
    of `__graft_entry__.entry`, made from the same seeds."""
    import numpy as np
    import torch

    from .engine import _resolve_device
    from .io.fasta import parse_reads
    from .ops import device_pipeline, pack, radix_table

    dev = _resolve_device(device)
    n_keys, n_targets, n_reads, stride, k = 4096, 16, 64, 128, 27
    rng = np.random.default_rng(0)
    keys = np.unique(
        rng.integers(1, 1 << 53, size=2 * n_keys, dtype=np.uint64))[:n_keys]
    labels1 = rng.integers(1, n_targets + 1, size=n_keys).astype(np.int32)
    table = radix_table.to_device(radix_table.build(keys, labels1), dev)
    rng = np.random.default_rng(1)
    fa = "".join(
        f">r{i}\n{''.join(rng.choice(list('ACGT'), size=100))}\n"
        for i in range(n_reads)
    ).encode()
    words, vwords = pack.pack_batch(parse_reads(fa), 0, n_reads, stride)
    words, vwords = (torch.from_numpy(w.view(np.int64)).to(dev)
                     for w in (words, vwords))
    return device_pipeline.classify_batch(
        table, words, vwords, k=k, n_targets=n_targets)[:4]


def _check_pipeline(device):
    total, ibest, best, sbest = toy_step(device)
    if total.shape != (64,) or int(total.min()) < 0:
        raise RuntimeError(f"toy step gave totals of shape {total.shape}")
    return f"K1, K2, K3 on {total.device}"


def cmd_cluster(args):
    from . import cluster

    return cluster.main(args)


def _count_targets(cfg):
    from .io.targets import parse_targets

    return parse_targets(cfg.targets).n_targets


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="clark-torch",
        description="CLARK metagenomic classifier on PyTorch/CUDA",
    )
    from . import __version__, database

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
    pst = dsub.add_parser("set-targets",
                          help="build targets.txt from Custom/ + taxonomy/")
    pst.add_argument("db", help="database directory")
    pst.add_argument("--rank", default="species",
                     choices=list(database.RANK_NAMES),
                     help="taxonomy rank for target labels")
    add_profile_flags(pst)
    pst.set_defaults(fn=cmd_db_set_targets)

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

    put = dsub.add_parser(
        "update-taxonomy",
        help="install/validate NCBI taxonomy data from a local download "
        "(scripts/updateTaxonomy.sh equivalent; the fetch itself is manual "
        "in this zero-egress environment)",
    )
    put.add_argument("db", help="database directory")
    put.add_argument(
        "--from", dest="src", default=None, metavar="DIR_OR_TGZ",
        help="directory (or taxdump.tar.gz) holding the downloaded "
        "taxdump + nucl_*.accession2taxid[.gz] files",
    )
    put.set_defaults(fn=cmd_db_update_taxonomy)

    from .download import NCBI_TAXONOMY_BASE

    pdt = dsub.add_parser(
        "download-taxonomy",
        help="fetch + install NCBI taxonomy data into <db>/taxonomy "
        "(scripts/updateTaxonomy.sh; needs network egress)",
    )
    pdt.add_argument("db", help="database directory")
    pdt.add_argument(
        "--base-url", default=NCBI_TAXONOMY_BASE,
        help="taxonomy mirror root (default: NCBI)",
    )
    pdt.set_defaults(fn=cmd_db_download_taxonomy)

    pdg = dsub.add_parser(
        "download-genomes",
        help="fetch latest RefSeq Complete Genome assemblies for a group "
        "(scripts/download/download_data_newest.sh; needs network egress)",
    )
    pdg.add_argument("dir", help="destination directory for the sequences")
    pdg.add_argument("group", help="RefSeq group: bacteria, viruses, archaea, fungi, ...")
    pdg.add_argument(
        "--flow", choices=("newest", "release", "archive"), default="newest",
        help="newest = latest assemblies (download_data_newest.sh); "
        "release = dated RefSeq release volumes (download_data_release.sh); "
        "archive = legacy old_refseq tarballs (download_data.sh)",
    )
    pdg.add_argument(
        "--base-url", default=None,
        help="mirror root (default: the NCBI root for the chosen flow)",
    )
    pdg.add_argument("--limit", type=int, default=None,
                     help="cap the number of assemblies/volumes (smoke tests)")
    pdg.set_defaults(fn=cmd_db_download_genomes)

    pcln = dsub.add_parser("clean", help="remove built DB artifacts (scripts/clean.sh --reset)")
    pcln.add_argument("db", help="database directory")
    pcln.add_argument("--yes", action="store_true", help="skip confirmation")
    pcln.set_defaults(fn=cmd_db_clean)

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
    pc.add_argument("--trace-dir", default=None,
                    help="capture a torch.profiler trace (a Chrome trace "
                    "of the host's ops and, on cuda, the kernels) into DIR")
    pc.set_defaults(fn=cmd_classify)

    pa = sub.add_parser("abundance", help="abundance estimation from result CSVs")
    pa.add_argument("-D", "--db", default=None, help="database directory (for taxonomy)")
    pa.add_argument("-F", "--files", nargs="+", required=True, help="classification CSVs")
    pa.add_argument("-c", "--min-confidence", type=float, default=0.5)
    pa.add_argument("-g", "--min-gamma", type=float, default=0.0)
    pa.add_argument("-a", "--min-abundance", type=float, default=0.0)
    pa.add_argument("--highconfidence", "--hc", action="store_true")
    pa.add_argument("--krona", action="store_true", help="write results.krn")
    pa.add_argument("--mpa", action="store_true", help="write results.mpa")
    pa.add_argument("-o", "--output", default=None)
    pa.set_defaults(fn=cmd_abundance)

    pm = sub.add_parser("merge", help="merge abundance CSVs by taxid")
    pm.add_argument("files", nargs="+")
    pm.add_argument("-o", "--output", required=True)
    pm.set_defaults(fn=cmd_merge)

    pr = sub.add_parser("report", help="human-readable pathogen report")
    pr.add_argument("file", help="abundance CSV")
    pr.add_argument("-o", "--output", default="results/report.txt")
    pr.set_defaults(fn=cmd_report)

    pv = sub.add_parser("verify", help="installation / database health check")
    pv.add_argument("--db", default=None, help="database directory to check")
    pv.add_argument("--device", default="cuda",
                    help="torch device of the toy classification step: "
                    "cuda (default, hand-written kernels; fails without a "
                    "CUDA device) or cpu (plain-PyTorch twins)")
    pv.set_defaults(fn=cmd_verify)

    pcl = sub.add_parser("cluster", help="multi-host / multi-sample coordinator")
    pcl.add_argument("-c", "--config", required=True, help="cluster config (INI)")
    pcl.add_argument("-p", "--preflight", action="store_true", help="check config and hosts only")
    pcl.add_argument("--launch", action="store_true",
                     help="self-launch the whole cluster: SSH-spawn one "
                          "worker per host with process ids preset "
                          "(kent-mpi launcher mode)")
    pcl.add_argument("--device", default="cuda",
                     help="torch device of every process: cuda (default; "
                     "the labels' all-reduce over NCCL, or gloo with "
                     "CLARK_TPU_DIST_BACKEND=gloo; a process without a CUDA "
                     "device exits 1) or cpu (gloo); --launch passes it on")
    pcl.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    pcl.set_defaults(fn=cmd_cluster)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "classify" and not args.objects and not args.paired:
        print("classify: provide -O <reads> or -P <r1> <r2>", file=sys.stderr)
        return 1
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
