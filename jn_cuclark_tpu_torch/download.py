"""NCBI data downloaders — equivalents of the reference's download tower:

* ``download_taxonomy``  = ``scripts/download/download_taxondata.sh:36-64``
  and ``scripts/updateTaxonomy.sh:25-57`` (taxdump + accession2taxid →
  extracted ``*.dmp`` + concatenated ``nucl_accss`` + ``.taxondata`` marker).
* ``download_genomes``   = ``scripts/download/download_data_newest.sh``
  (RefSeq ``assembly_summary.txt`` → latest Complete Genome ``*.fna``).
* ``download_genomes_release`` = ``scripts/download/download_data_release.sh``
  (dated RefSeq release: RELEASE_NUMBER + ``<group>.N.genomic.fna.gz``
  multi-FASTA volumes, split into one ``.fna`` per sequence).
* ``download_genomes_archive`` = ``scripts/download/download_data.sh``
  (legacy old_refseq tarballs for bacteria/viruses + per-chromosome
  human assemblies).
* ``install_taxonomy``   = the unpack/concatenate half of the above, shared
  with ``clark-torch db update-taxonomy --from`` for pre-downloaded data.

Transport is plain ``urllib`` with retries and byte-range resume; NCBI's
``ftp://`` URLs are rewritten to ``https://`` (the same hosts serve both,
and HTTPS survives the proxies that FTP does not).  Every entry point takes
a ``base_url`` so tests exercise the full flows against a localhost fixture
server; the defaults point at NCBI and are only reachable from machines
with network egress.
"""

from __future__ import annotations

import gzip
import os
import re
import shutil
import tarfile
import time
import urllib.error
import urllib.request

NCBI_TAXONOMY_BASE = "https://ftp.ncbi.nih.gov/pub/taxonomy"
NCBI_REFSEQ_BASE = "https://ftp.ncbi.nih.gov/genomes/refseq"
NCBI_RELEASE_BASE = "https://ftp.ncbi.nih.gov/refseq/release"
NCBI_GENOMES_BASE = "https://ftp.ncbi.nih.gov/genomes"

#: taxonomy/ payload expected by kent.cpp:178-265 (see cli._TAXONOMY_FILES)
TAXDUMP_MEMBERS = [
    "citations.dmp", "delnodes.dmp", "division.dmp", "gc.prt",
    "gencode.dmp", "images.dmp", "merged.dmp", "names.dmp", "nodes.dmp",
]


class DownloadError(RuntimeError):
    """A fetch failed after retries, or the payload was incomplete."""


def rewrite_ftp(url: str) -> str:
    """NCBI publishes ftp:// URLs (updateTaxonomy.sh, assembly_summary
    column 20); the same paths are served over HTTPS."""
    if url.startswith("ftp://"):
        return "https://" + url[len("ftp://"):]
    return url


def fetch(url: str, dest: str, *, retries: int = 3, timeout: float = 60.0,
          resume: bool = True, log=print) -> str:
    """Download ``url`` to ``dest`` atomically (via ``dest + '.part'``).

    Already-complete files are kept (wget -nc semantics,
    download_data_newest.sh:40).  A leftover ``.part`` is resumed with a
    Range request when the server honors it, else restarted.
    """
    url = rewrite_ftp(url)
    if os.path.exists(dest) and os.path.getsize(dest) > 0:
        return dest
    part = dest + ".part"
    err: Exception | None = None
    for attempt in range(retries):
        if attempt:
            time.sleep(min(2.0 ** attempt, 10.0))
        offset = os.path.getsize(part) if resume and os.path.exists(part) else 0
        req = urllib.request.Request(url)
        if offset:
            req.add_header("Range", f"bytes={offset}-")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                status = getattr(resp, "status", 200)
                mode = "ab" if (offset and status == 206) else "wb"
                with open(part, mode) as out:
                    shutil.copyfileobj(resp, out, 1 << 20)
            os.replace(part, dest)
            return dest
        except (urllib.error.URLError, OSError, ValueError) as e:
            err = e
            log(f"  retrying {url} ({e})")
    raise DownloadError(f"failed to download {url}: {err}")


def _gunzip(src: str, dest: str) -> None:
    with gzip.open(src, "rb") as f, open(dest, "wb") as g:
        shutil.copyfileobj(f, g, 1 << 20)


def extract_taxdump(tar_path: str, tax: str) -> None:
    """Extract the ``*.dmp`` + ``gc.prt`` members of taxdump.tar.gz flat
    into ``tax`` (``tar -zxf taxdump.tar.gz``, download_taxondata.sh:55)."""
    with tarfile.open(tar_path, "r:gz") as t:
        for m in t.getmembers():
            base = os.path.basename(m.name)
            if m.isfile() and (base.endswith(".dmp") or base == "gc.prt"):
                with t.extractfile(m) as f, open(os.path.join(tax, base), "wb") as g:
                    shutil.copyfileobj(f, g)


def install_taxonomy(src: str, tax: str, *, log=print) -> None:
    """Install taxonomy data that already sits in ``src`` (a directory, or
    a taxdump.tar.gz path) into the ``tax`` directory: extract the dump,
    copy loose files, and concatenate ``nucl_gb`` then ``nucl_wgs``
    accession2taxid (gunzipping as needed) into ``nucl_accss`` —
    updateTaxonomy.sh:44-50's ``cat`` order."""
    os.makedirs(tax, exist_ok=True)
    if os.path.isfile(src) and (src.endswith(".tar.gz") or src.endswith(".tgz")):
        log(f"Extracting {src} ...")
        extract_taxdump(src, tax)
        src = os.path.dirname(os.path.abspath(src))
    elif os.path.isdir(src):
        tb = os.path.join(src, "taxdump.tar.gz")
        if os.path.exists(tb):
            log(f"Extracting {tb} ...")
            extract_taxdump(tb, tax)
        for f in TAXDUMP_MEMBERS + ["nucl_accss"]:
            p = os.path.join(src, f)
            if os.path.exists(p) and not os.path.samefile(src, tax):
                shutil.copyfile(p, os.path.join(tax, f))
    else:
        raise DownloadError(f"{src}: not a directory or .tar.gz")
    parts = []
    for stem in ("nucl_gb.accession2taxid", "nucl_wgs.accession2taxid"):
        for cand in (os.path.join(src, stem), os.path.join(src, stem + ".gz")):
            if os.path.exists(cand):
                parts.append(cand)
                break
    if parts:
        log("Writing nucl_accss from: " + ", ".join(parts))
        with open(os.path.join(tax, "nucl_accss"), "wb") as out:
            for p in parts:
                op = gzip.open if p.endswith(".gz") else open
                with op(p, "rb") as f:
                    shutil.copyfileobj(f, out)


def download_taxonomy(tax: str, *, base_url: str = NCBI_TAXONOMY_BASE,
                      log=print) -> None:
    """Fetch + install the NCBI taxonomy payload into directory ``tax``
    (download_taxondata.sh:42-62 / updateTaxonomy.sh:32-50)."""
    os.makedirs(tax, exist_ok=True)
    base = base_url.rstrip("/")
    log("Downloading... ")
    try:
        for rel in ("accession2taxid/nucl_gb.accession2taxid.gz",
                    "accession2taxid/nucl_wgs.accession2taxid.gz",
                    "taxdump.tar.gz"):
            fetch(f"{base}/{rel}", os.path.join(tax, os.path.basename(rel)),
                  log=log)
    except DownloadError as e:
        raise DownloadError(f"Failed to download taxonomy data! ({e})") from e
    log("Uncompressing files... ")
    install_taxonomy(tax, tax, log=log)
    for required in ("nucl_accss", "nodes.dmp"):
        p = os.path.join(tax, required)
        if not (os.path.exists(p) and os.path.getsize(p) > 0):
            raise DownloadError("Failed to uncompress taxonomy data.")
    # the completion marker lives next to taxonomy/ (touch ../.taxondata)
    open(os.path.join(os.path.dirname(os.path.abspath(tax)), ".taxondata"),
         "a").close()


def parse_assembly_summary(text: str) -> list[str]:
    """RefSeq assembly_summary.txt → genomic.fna.gz URLs.

    Replicates download_data_newest.sh:36-37's awk exactly: keep rows with
    column 12 == "Complete Genome" and column 11 == "latest" (1-indexed,
    tab-separated); column 20 is the assembly's FTP directory, and the file
    is ``<basename(dir)>_genomic.fna.gz``."""
    urls = []
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        cols = line.split("\t")
        if len(cols) >= 20 and cols[11] == "Complete Genome" and cols[10] == "latest":
            ftpdir = cols[19].rstrip("/")
            if ftpdir and ftpdir != "na":
                urls.append(f"{ftpdir}/{ftpdir.rsplit('/', 1)[-1]}_genomic.fna.gz")
    return urls


def _fetch_text(url: str, *, timeout: float = 60.0) -> str:
    """Small helper for index/metadata files fetched straight to memory."""
    url = rewrite_ftp(url)
    with urllib.request.urlopen(
        urllib.request.Request(url), timeout=timeout
    ) as resp:
        return resp.read().decode("utf-8", errors="replace")


def _list_dir(url: str, pattern: str) -> list[str]:
    """Filenames matching ``pattern`` (a regex) in an HTTP directory
    listing — the wget-wildcard equivalent (``wget <dir>/<glob>``) for the
    HTTPS mirrors, which serve an HTML index with one href per file."""
    import re

    html = _fetch_text(url.rstrip("/") + "/")
    names = set(re.findall(r'href="([^"/?]+)"', html))
    rx = re.compile(pattern)
    return sorted(n for n in names if rx.fullmatch(n))


def split_genomic_fna(src: str, outdir: str) -> list[str]:
    """Split a RefSeq release multi-FASTA volume into one ``<accession>.fna``
    per sequence — download_data_release.sh:41-43's sed+awk exactly:

    * sed strips a leading ``gi|<digits>|ref|<acc>|`` from each header to
      ``<acc>`` (first occurrence per line);
    * awk writes each record to ``<first-header-token>.fna`` (appending
      when the same name repeats).
    """
    import re

    gi = re.compile(r"gi\|[0-9]*\|ref\|(\S*)\|")
    written: list[str] = []
    seen: set[str] = set()
    out = None
    try:
        with open(src, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                if line.startswith(">"):
                    hdr = gi.sub(r"\1", line, count=1)
                    name = hdr[1:].split()[0] if len(hdr) > 1 else ""
                    path = os.path.join(outdir, f"{name}.fna")
                    if out is not None:
                        out.close()
                    mode = "a" if name in seen else "w"
                    out = open(path, mode)
                    if name not in seen:
                        seen.add(name)
                        written.append(os.path.abspath(path))
                    out.write(hdr)
                elif out is not None:
                    out.write(line)
    finally:
        if out is not None:
            out.close()
    return written


def download_genomes_release(
    dest: str, group: str, *, base_url: str = NCBI_RELEASE_BASE, log=print,
    limit: int | None = None,
) -> str:
    """Fetch a dated RefSeq RELEASE for ``group`` into ``dest/<Group>/``
    and write the ``dest/.<group>`` manifest
    (download_data_release.sh end-to-end): reads RELEASE_NUMBER, downloads
    every ``<group>.N.genomic.fna.gz`` volume, gunzips, splits each volume
    into one ``.fna`` per sequence.  Returns the manifest path."""
    manifest = os.path.join(dest, f".{group}")
    if os.path.exists(manifest) and os.path.getsize(manifest) > 0:
        log(f"'{group}' sequences already in {dest}.")
        return manifest
    gdir = os.path.join(dest, _GROUP_DIRS.get(group, group))
    os.makedirs(gdir, exist_ok=True)
    base = base_url.rstrip("/")
    rel_group = _GROUP_REFSEQ.get(group, group)
    try:
        relnum = _fetch_text(f"{base}/RELEASE_NUMBER").strip()
        log(f"RefSeq release {relnum} found.")
    except (urllib.error.URLError, OSError) as e:
        raise DownloadError(f"failed to read RELEASE_NUMBER: {e}") from e
    log(f"Downloading now '{group}' genomes:")
    try:
        vols = _list_dir(
            f"{base}/{rel_group}",
            rf"{re.escape(rel_group)}\.\d+\.genomic\.fna\.gz",
        )
    except (urllib.error.URLError, OSError) as e:
        raise DownloadError(
            f"Failed to download '{group}' sequences. Are you sure "
            f"'{group}' database exists in RefSeq? ({e})") from e
    if not vols:
        raise DownloadError(
            f"Failed to download '{group}' sequences. Are you sure "
            f"'{group}' database exists in RefSeq?")
    vols.sort(key=lambda v: int(v.split(".")[1]))
    if limit is not None:
        vols = vols[:limit]
    fnas: list[str] = []
    for vol in vols:
        gz = os.path.join(gdir, vol)
        fna = gz[: -len(".gz")]
        fetch(f"{base}/{rel_group}/{vol}", gz, log=log)
        log("Downloading done. Uncompressing files... ")
        _gunzip(gz, fna)
        os.remove(gz)
        log("Creating single file for each genome... ")
        fnas.extend(split_genomic_fna(fna, gdir))
        os.remove(fna)
    if not fnas:
        raise DownloadError(f"Failed to download '{group}' sequences. ")
    with open(manifest, "w") as out:
        out.write("".join(p + "\n" for p in sorted(fnas)))
        out.write(f"# refseq_release: {relnum}\n")
    log(f"'{group}' sequences downloaded!")
    return manifest


#: human chromosome directory names, download_data.sh:88-103
_HUMAN_CHRS = [f"CHR_0{n}" for n in range(1, 10)] + [
    f"CHR_{n}" for n in range(10, 23)
] + ["CHR_X", "CHR_Y", "CHR_MT", "CHR_Un"]


def download_genomes_archive(
    dest: str, group: str, *, base_url: str = NCBI_GENOMES_BASE, log=print,
) -> str:
    """Legacy NCBI genome archive flow (download_data.sh end-to-end):

    * bacteria — ``archive/old_refseq/Bacteria/all.fna.tar.gz``, untarred;
    * viruses  — ``Viruses/all.fna.tar.gz`` + ``all.ffn.tar.gz``;
    * human    — per-chromosome ``hs_ref_GRC*chr*.fa.gz``, gunzipped.

    Writes the same ``dest/.<group>`` manifest of absolute sequence paths.
    """
    if group not in ("bacteria", "viruses", "human"):
        raise DownloadError(
            f"Failed to recognize parameter: {group}. Please choose "
            "between: bacteria, viruses, human.")
    manifest = os.path.join(dest, f".{group}")
    if os.path.exists(manifest) and os.path.getsize(manifest) > 0:
        log(f"{group.capitalize()} sequences already in {dest}.")
        return manifest
    gdir = os.path.join(dest, _GROUP_DIRS.get(group, group.capitalize()))
    os.makedirs(gdir, exist_ok=True)
    base = base_url.rstrip("/")
    paths: list[str] = []
    if group == "bacteria":
        log("Downloading now Bacteria genomes:")
        tar = os.path.join(gdir, "all.fna.tar.gz")
        fetch(f"{base}/archive/old_refseq/Bacteria/all.fna.tar.gz", tar,
              log=log)
        log("Downloading done. Uncompressing files... ")
        paths += _untar_seqs(tar, gdir, ".fna")
        os.remove(tar)
    elif group == "viruses":
        log("Downloading now Viruses genomes:")
        for name in ("all.fna.tar.gz", "all.ffn.tar.gz"):
            tar = os.path.join(gdir, name)
            fetch(f"{base}/Viruses/{name}", tar, log=log)
            log("Downloading done. Uncompressing files... ")
            paths += _untar_seqs(tar, gdir, ".fna", ".ffn")
            os.remove(tar)
    else:
        log("Downloading now latest Human genome:")
        for chrdir in _HUMAN_CHRS:
            try:
                names = _list_dir(
                    f"{base}/H_sapiens/{chrdir}",
                    r"hs_ref_GRC.*chr[0-9XYMTUn]+\.fa\.gz",
                )
            except (urllib.error.URLError, OSError) as e:
                raise DownloadError(
                    f"Failed to download human sequences. ({e})") from e
            for name in names:
                gz = os.path.join(gdir, name)
                fa = gz[: -len(".gz")]
                fetch(f"{base}/H_sapiens/{chrdir}/{name}", gz, log=log)
                _gunzip(gz, fa)
                os.remove(gz)
                paths.append(os.path.abspath(fa))
        log("Downloading done. Uncompressing files... ")
    if not paths:
        raise DownloadError(f"Failed to download {group} sequences. ")
    with open(manifest, "w") as out:
        out.write("".join(p + "\n" for p in sorted(paths)))
    log(f"{group.capitalize()} sequences downloaded!")
    return manifest


def _untar_seqs(tar_path: str, outdir: str, *exts: str) -> list[str]:
    """Extract sequence members (by extension) preserving the tar's
    relative layout; returns absolute extracted paths (the scripts'
    ``find `pwd` -name '*.fna'``)."""
    out: list[str] = []
    with tarfile.open(tar_path, "r:gz") as t:
        for m in t.getmembers():
            if not m.isfile() or not m.name.endswith(exts):
                continue
            rel = os.path.normpath(m.name).lstrip("/")
            if rel.startswith(".."):
                continue  # refuse path traversal
            p = os.path.join(outdir, rel)
            os.makedirs(os.path.dirname(p), exist_ok=True)
            with t.extractfile(m) as f, open(p, "wb") as g:
                shutil.copyfileobj(f, g)
            out.append(os.path.abspath(p))
    return out


#: reference directory names for the two named groups
#: (download_data_newest.sh:31/66: Bacteria/, Viruses/; generic groups
#: keep their RefSeq name).  "viruses" maps to RefSeq's "viral" path.
_GROUP_DIRS = {"bacteria": "Bacteria", "viruses": "Viruses"}
_GROUP_REFSEQ = {"viruses": "viral"}


def download_genomes(dest: str, group: str, *, base_url: str = NCBI_REFSEQ_BASE,
                     limit: int | None = None, log=print) -> str:
    """Fetch the latest RefSeq "Complete Genome" assemblies for ``group``
    (e.g. bacteria, viruses, archaea, fungi) into ``dest/<Group>/`` and
    write the ``dest/.<group>`` manifest of absolute ``*.fna`` paths
    (download_data_newest.sh end-to-end).  Returns the manifest path.

    ``limit`` caps the number of assemblies (for smoke tests / partial
    mirrors); the manifest then marks the truncation in a trailing comment
    so a later full run is not mistaken for complete.
    """
    manifest = os.path.join(dest, f".{group}")
    if os.path.exists(manifest) and os.path.getsize(manifest) > 0:
        log(f"{group.capitalize()} sequences already in {dest}.")
        return manifest
    gdir = os.path.join(dest, _GROUP_DIRS.get(group, group))
    os.makedirs(gdir, exist_ok=True)
    summary_url = (f"{base_url.rstrip('/')}/"
                   f"{_GROUP_REFSEQ.get(group, group)}/assembly_summary.txt")
    log(f"Downloading now {group} genomes:")
    summary = os.path.join(gdir, "assembly_summary.txt")
    try:
        fetch(summary_url, summary, log=log)
    except DownloadError as e:
        raise DownloadError(
            f"Couldn't find assembly_summary text file! Are you sure "
            f"'{group}' database exists in RefSeq? ({e})") from e
    with open(summary, encoding="utf-8", errors="replace") as f:
        urls = parse_assembly_summary(f.read())
    if not urls:
        raise DownloadError(f"assembly_summary for '{group}' lists no "
                            "latest Complete Genome assemblies")
    truncated = limit is not None and limit < len(urls)
    if truncated:
        urls = urls[:limit]
    log(f"  {len(urls)} assemblies")
    fnas = []
    for url in urls:
        gz = os.path.join(gdir, url.rsplit("/", 1)[-1])
        fna = gz[:-len(".gz")]
        if not os.path.exists(fna):
            fetch(url, gz, log=log)
            _gunzip(gz, fna)
            os.remove(gz)
        fnas.append(os.path.abspath(fna))
    log("Downloading done. Uncompressing files... ")
    with open(manifest, "w") as out:
        out.write("".join(p + "\n" for p in sorted(fnas)))
        if truncated:
            out.write(f"# truncated: --limit {limit}\n")
    log(f"{group.capitalize()} sequences downloaded!")
    return manifest
