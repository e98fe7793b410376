"""Database directory workflow (`<db>/config.json`, the kent -d /
set_targets.sh / make_metadata.sh layout):

    <db>/Custom/*.f*          reference genome FASTA files
    <db>/taxonomy/            NCBI dump: nodes.dmp names.dmp merged.dmp ...
                              + nucl_accss (accession2taxid)
    <db>/targets.txt          "<file>\t<taxid-at-rank>" per genome
    <db>/files_excluded.txt   genomes without taxonomy mapping
    <db>/custom_<rank>_canonical/   discriminative k-mer DB (.sz/.ky/.lb)
    <db>/config.json          replaces scripts/.settings + .DBDirectory

`db set-targets` writes `targets.txt` and `config.json` from Custom/ and
the taxonomy, with the shell pipeline's intermediate dotfiles (.custom,
.custom.fileToAccssnTaxID, .custom.fileToTaxIDs) so existing tooling can
inspect them; `classify -D <db>` reads the targets file, the
sub-directory holding the `.tsk` files and the profile from
`config.json`; `db build` (re)builds the DB it names.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os

from . import taxonomy
from .db import builder
from .io.targets import parse_targets
from .params import FULL, LIGHT, Profile

TAXONOMY_FILES = [
    "citations.dmp",
    "delnodes.dmp",
    "division.dmp",
    "gc.prt",
    "gencode.dmp",
    "images.dmp",
    "merged.dmp",
    "names.dmp",
    "nodes.dmp",
]
RANK_NAMES = {
    "species": 0,
    "genus": 1,
    "family": 2,
    "order": 3,
    "class": 4,
    "phylum": 5,
}


@dataclasses.dataclass
class DBConfig:
    db_dir: str
    targets: str  # path to targets.txt
    subdb: str  # directory holding the .tsk files
    rank: int
    profile_name: str  # "full" | "light" | custom
    k: int
    gap: int
    min_count_target: int
    htsize: int = LIGHT.htsize
    light: bool = True

    @property
    def profile(self) -> Profile:
        if self.profile_name == "light":
            return LIGHT
        if self.profile_name == "full":
            return FULL
        return Profile(
            name=self.profile_name,
            htsize=self.htsize,
            light=self.light,
            default_k=self.k,
            default_gap=self.gap,
        )

    def save(self):
        with open(os.path.join(self.db_dir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def load(cls, db_dir: str) -> "DBConfig":
        with open(os.path.join(db_dir, "config.json")) as f:
            return cls(**json.load(f))


def check_layout(db_dir: str, require_accession_map: bool = True) -> list[str]:
    """Validate the database directory; returns a list of problems (empty =
    OK).  Mirrors kent.cpp check_database."""
    problems = []
    if not os.path.isdir(db_dir):
        return [f"database directory not found: {db_dir}"]
    custom = os.path.join(db_dir, "Custom")
    if not os.path.isdir(custom):
        problems.append(f"missing {custom}/")
    elif not find_sequence_files(db_dir):
        problems.append(f"no sequence files (*.f*) in {custom}/")
    taxdir = os.path.join(db_dir, "taxonomy")
    if not os.path.isdir(taxdir):
        problems.append(f"missing {taxdir}/")
    else:
        for fn in TAXONOMY_FILES:
            if not os.path.exists(os.path.join(taxdir, fn)):
                problems.append(f"missing taxonomy/{fn}")
        if require_accession_map and not os.path.exists(
            os.path.join(taxdir, "nucl_accss")
        ):
            problems.append("missing taxonomy/nucl_accss (accession2taxid)")
    return problems


def find_sequence_files(db_dir: str) -> list[str]:
    """`find Custom/ -name '*.f*'` (make_metadata.sh:88)."""
    pat = os.path.join(db_dir, "Custom", "**", "*.f*")
    return sorted(glob.glob(pat, recursive=True))


def set_targets(db_dir: str, rank: int | str = 0, profile: Profile = LIGHT) -> DBConfig:
    """Build targets.txt from Custom/ + taxonomy/ (set_targets.sh custom).

    Requires taxonomy files; writes intermediate dotfiles and config.json.
    """
    if isinstance(rank, str):
        rank = RANK_NAMES[rank]
    taxdir = os.path.join(db_dir, "taxonomy")
    problems = [
        p
        for p in check_layout(db_dir)
        if "nodes.dmp" in p or "merged.dmp" in p or "nucl_accss" in p
        or "Custom" in p or "directory" in p
    ]
    if problems:
        raise RuntimeError("; ".join(problems))
    files = find_sequence_files(db_dir)
    with open(os.path.join(db_dir, ".custom"), "w") as f:
        f.write("\n".join(files) + "\n")

    merged = taxonomy.load_merged(os.path.join(taxdir, "merged.dmp"))
    mapped = taxonomy.map_files_to_taxids(
        files, os.path.join(taxdir, "nucl_accss"), merged
    )
    with open(os.path.join(db_dir, ".custom.fileToAccssnTaxID"), "w") as f:
        for path, acc, tid in mapped:
            f.write(f"{path}\t{acc}\t{tid}\n")

    tree = taxonomy.load_nodes(os.path.join(taxdir, "nodes.dmp"))
    with open(os.path.join(db_dir, ".custom.fileToTaxIDs"), "w") as f:
        for path, acc, tid in mapped:
            lin = tree.lineage6(tid) if tid > 0 else [0] * 6
            cols = [str(x) if x else "UNKNOWN" for x in lin]
            f.write(f"{path}\t{tid}\t" + "\t".join(cols) + "\n")

    pairs, excluded = taxonomy.targets_definition(mapped, tree, rank)
    taxonomy.write_targets_file(os.path.join(db_dir, "targets.txt"), pairs)
    if excluded:
        with open(os.path.join(db_dir, "files_excluded.txt"), "w") as f:
            f.write(
                "The following files have been excluded from the targets "
                "definition\n"
            )
            f.write("\n".join(excluded) + "\n")

    subdb = os.path.join(db_dir, f"custom_{rank}_canonical")
    os.makedirs(subdb, exist_ok=True)
    cfg = DBConfig(
        db_dir=db_dir,
        targets=os.path.join(db_dir, "targets.txt"),
        subdb=subdb,
        rank=rank,
        profile_name=profile.name,
        k=profile.default_k,
        gap=profile.default_gap,
        min_count_target=0,
        htsize=profile.htsize,
        light=profile.light,
    )
    cfg.save()
    # marker used by kent --verify (kent.cpp:241)
    with open(os.path.join(db_dir, ".taxondata"), "w") as f:
        f.write("ok\n")
    return cfg


def build(
    cfg: DBConfig,
    profile: Profile | None = None,
    k: int | None = None,
    gap: int | None = None,
    min_count_target: int | None = None,
    tsk: bool = False,
    device="cuda",
):
    """Build (or rebuild) the discriminative k-mer DB for a configured
    database directory; `device` as in builder.build_database ("cuda" by
    default, "host" for the native host aggregate)."""
    profile = profile or cfg.profile
    k = k if k is not None else (cfg.k or profile.default_k)
    gap = gap if gap is not None else cfg.gap
    minT = min_count_target if min_count_target is not None else cfg.min_count_target
    targets = parse_targets(cfg.targets)
    db = builder.build_database(
        targets, cfg.subdb, profile, k, min_count_target=minT, gap=gap,
        tsk=tsk, device=device,
    )
    cfg.profile_name = profile.name
    cfg.htsize = profile.htsize
    cfg.light = profile.light
    cfg.k = k
    cfg.gap = gap
    cfg.min_count_target = minT
    cfg.save()
    return db
