"""Downloader tests of the PyTorch port (scripts/download/*.sh +
updateTaxonomy.sh parity), the JAX package's tests run against
`jn_cuclark_tpu_torch.download` and its CLI.

All network I/O runs against a localhost fixture HTTP server — the flows
are identical to production except `base_url`; nothing leaves the machine.
"""

import gzip
import io
import os
import tarfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from jn_cuclark_tpu_torch import download
from jn_cuclark_tpu_torch.download import (
    DownloadError,
    fetch,
    parse_assembly_summary,
    rewrite_ftp,
)

DMP_NAMES = download.TAXDUMP_MEMBERS


class _Handler(BaseHTTPRequestHandler):
    """Serves `server.docroot` (a dict path → bytes); honors Range
    requests when `server.support_range`; counts Range hits."""

    def do_GET(self):  # noqa: N802
        data = self.server.docroot.get(self.path.lstrip("/"))
        if data is None:
            self.send_error(404)
            return
        rng = self.headers.get("Range")
        if rng and self.server.support_range:
            start = int(rng.split("=")[1].rstrip("-").split("-")[0])
            self.server.range_hits += 1
            body = data[start:]
            self.send_response(206)
            self.send_header(
                "Content-Range", f"bytes {start}-{len(data) - 1}/{len(data)}"
            )
        else:
            body = data
            self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):  # silence
        pass


@pytest.fixture
def server():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    srv.docroot = {}
    srv.support_range = True
    srv.range_hits = 0
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    srv.base = f"http://127.0.0.1:{srv.server_address[1]}"
    yield srv
    srv.shutdown()
    t.join()


def _taxdump_bytes():
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as t:
        for n in DMP_NAMES:
            data = f"content of {n}\n".encode()
            info = tarfile.TarInfo(n)
            info.size = len(data)
            t.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def _stock_taxonomy(srv):
    srv.docroot["tax/taxdump.tar.gz"] = _taxdump_bytes()
    srv.docroot["tax/accession2taxid/nucl_gb.accession2taxid.gz"] = (
        gzip.compress(b"A1\t1\tgb\n")
    )
    srv.docroot["tax/accession2taxid/nucl_wgs.accession2taxid.gz"] = (
        gzip.compress(b"A2\t2\twgs\n")
    )


def test_fetch_basic_and_nc(server, tmp_path):
    server.docroot["f.txt"] = b"hello"
    dest = str(tmp_path / "f.txt")
    assert fetch(f"{server.base}/f.txt", dest) == dest
    assert open(dest, "rb").read() == b"hello"
    # wget -nc semantics: an existing complete file is not re-fetched
    server.docroot["f.txt"] = b"changed"
    fetch(f"{server.base}/f.txt", dest)
    assert open(dest, "rb").read() == b"hello"


def test_fetch_resume_range(server, tmp_path):
    server.docroot["big.bin"] = bytes(range(256)) * 64
    dest = str(tmp_path / "big.bin")
    with open(dest + ".part", "wb") as f:
        f.write(server.docroot["big.bin"][:1000])
    fetch(f"{server.base}/big.bin", dest)
    assert open(dest, "rb").read() == server.docroot["big.bin"]
    assert server.range_hits == 1


def test_fetch_restart_without_range_support(server, tmp_path):
    server.support_range = False
    server.docroot["big.bin"] = b"x" * 4096
    dest = str(tmp_path / "big.bin")
    with open(dest + ".part", "wb") as f:
        f.write(b"GARBAGE")
    fetch(f"{server.base}/big.bin", dest)
    assert open(dest, "rb").read() == server.docroot["big.bin"]


def test_fetch_404_raises(server, tmp_path):
    with pytest.raises(DownloadError):
        fetch(f"{server.base}/absent", str(tmp_path / "x"), retries=2)


def test_rewrite_ftp():
    assert (
        rewrite_ftp("ftp://ftp.ncbi.nih.gov/pub/taxonomy/taxdump.tar.gz")
        == "https://ftp.ncbi.nih.gov/pub/taxonomy/taxdump.tar.gz"
    )
    assert rewrite_ftp("http://x/y") == "http://x/y"


def test_download_taxonomy_end_to_end(server, tmp_path):
    """download_taxondata.sh:42-62: fetch, extract, concatenate gb-then-wgs
    into nucl_accss, touch ../.taxondata."""
    _stock_taxonomy(server)
    db = tmp_path / "db"
    tax = db / "taxonomy"
    download.download_taxonomy(str(tax), base_url=f"{server.base}/tax", log=lambda *a: None)
    for n in DMP_NAMES:
        assert (tax / n).read_text() == f"content of {n}\n"
    assert (tax / "nucl_accss").read_text() == "A1\t1\tgb\nA2\t2\twgs\n"
    assert (db / ".taxondata").exists()


def test_cli_download_taxonomy(server, tmp_path, capsys):
    from jn_cuclark_tpu_torch import cli

    _stock_taxonomy(server)
    db = tmp_path / "db"
    db.mkdir()
    rc = cli.main([
        "db", "download-taxonomy", str(db), "--base-url", f"{server.base}/tax"
    ])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "All taxonomy files present." in out
    assert (db / "taxonomy" / "nucl_accss").exists()

    # unreachable payload → reference's failure message, exit 1
    db2 = tmp_path / "db2"
    db2.mkdir()
    rc = cli.main([
        "db", "download-taxonomy", str(db2), "--base-url", f"{server.base}/nope"
    ])
    out = capsys.readouterr().out
    assert rc == 1 and "Failed to download taxonomy data!" in out


SUMMARY = (
    "#   See ftp://ftp.ncbi.nlm.nih.gov/genomes/README_assembly_summary.txt\n"
    "# assembly_accession\tbioproject\tbiosample\twgs_master\trefseq_category"
    "\ttaxid\tspecies_taxid\torganism_name\tinfraspecific_name\tisolate"
    "\tversion_status\tassembly_level\trelease_type\tgenome_rep\tseq_rel_date"
    "\tasm_name\tsubmitter\tgbrs_paired_asm\tpaired_asm_comp\tftp_path\n"
)


def _summary_row(acc, status, level, ftp):
    cols = [acc, "", "", "", "", "7", "7", f"org {acc}", "", "",
            status, level, "Major", "Full", "2024/01/01", f"asm_{acc}",
            "lab", "", "", ftp]
    return "\t".join(cols) + "\n"


def test_parse_assembly_summary():
    """awk '$12=="Complete Genome" && $11=="latest"{print $20}' parity."""
    text = (
        SUMMARY
        + _summary_row("GCF_1.1", "latest", "Complete Genome", "ftp://h/g/GCF_1.1_a")
        + _summary_row("GCF_2.1", "latest", "Contig", "ftp://h/g/GCF_2.1_a")
        + _summary_row("GCF_3.1", "replaced", "Complete Genome", "ftp://h/g/GCF_3.1_a")
        + _summary_row("GCF_4.1", "latest", "Complete Genome", "na")
    )
    assert parse_assembly_summary(text) == [
        "ftp://h/g/GCF_1.1_a/GCF_1.1_a_genomic.fna.gz"
    ]


def test_download_genomes_end_to_end(server, tmp_path, capsys):
    """download_data_newest.sh: assembly_summary filter → fetch each
    *_genomic.fna.gz → gunzip → .{group} manifest; idempotent re-run."""
    fna1 = b">chr1 Escherichia\nACGTACGT\n"
    fna2 = b">chr1 Salmonella\nGGGGCCCC\n"
    rows = []
    for i, fna in ((1, fna1), (2, fna2)):
        asm = f"GCF_{i}.1_asm"
        server.docroot[f"all/{asm}/{asm}_genomic.fna.gz"] = gzip.compress(fna)
        rows.append(_summary_row(
            f"GCF_{i}.1", "latest", "Complete Genome",
            f"{server.base}/all/{asm}",
        ))
    rows.append(_summary_row("GCF_9.1", "latest", "Scaffold",
                             f"{server.base}/all/GCF_9.1_asm"))
    server.docroot["refseq/bacteria/assembly_summary.txt"] = (
        SUMMARY + "".join(rows)
    ).encode()

    dest = tmp_path / "seqs"
    dest.mkdir()
    manifest = download.download_genomes(
        str(dest), "bacteria", base_url=f"{server.base}/refseq",
        log=lambda *a: None,
    )
    paths = [ln.strip() for ln in open(manifest) if not ln.startswith("#")]
    assert len(paths) == 2
    assert all(p.startswith(str(dest / "Bacteria")) for p in paths)
    contents = sorted(open(p, "rb").read() for p in paths)
    assert contents == sorted([fna1, fna2])
    assert not any(f.endswith(".gz") for f in os.listdir(dest / "Bacteria")
                   if f.startswith("GCF"))

    # second run: "already in" skip (download_data_newest.sh:66)
    server.docroot.clear()
    again = download.download_genomes(
        str(dest), "bacteria", base_url=f"{server.base}/refseq",
        log=lambda *a: None,
    )
    assert again == manifest


def test_download_genomes_limit_and_errors(server, tmp_path):
    asm = "GCF_1.1_asm"
    server.docroot[f"all/{asm}/{asm}_genomic.fna.gz"] = gzip.compress(b">c\nAC\n")
    server.docroot["refseq/viral/assembly_summary.txt"] = (
        SUMMARY
        + _summary_row("GCF_1.1", "latest", "Complete Genome",
                       f"{server.base}/all/{asm}")
        + _summary_row("GCF_2.1", "latest", "Complete Genome",
                       f"{server.base}/all/GCF_2.1_asm")
    ).encode()
    dest = tmp_path / "seqs"
    dest.mkdir()
    # "viruses" maps to RefSeq's viral/ path and a Viruses/ directory
    manifest = download.download_genomes(
        str(dest), "viruses", base_url=f"{server.base}/refseq", limit=1,
        log=lambda *a: None,
    )
    lines = open(manifest).read().splitlines()
    assert len([ln for ln in lines if not ln.startswith("#")]) == 1
    assert any("truncated" in ln for ln in lines)
    assert (dest / "Viruses").is_dir()

    with pytest.raises(DownloadError, match="exists in RefSeq"):
        download.download_genomes(
            str(tmp_path / "other"), "nosuchgroup",
            base_url=f"{server.base}/refseq", log=lambda *a: None,
        )


# ---------------------------------------------------------------- release


def _index_html(names):
    return ("<html><body>" + "".join(
        f'<a href="{n}">{n}</a>\n' for n in names
    ) + "</body></html>").encode()


def test_split_genomic_fna(tmp_path):
    """download_data_release.sh:41-43 sed+awk parity: gi|..|ref|ACC| headers
    collapse to ACC; one file per first-header-token; repeats append."""
    src = tmp_path / "vol.fna"
    src.write_text(
        ">gi|123|ref|NC_1.1| Escherichia coli\nACGT\nACGT\n"
        ">NC_2.2 plain header\nGGGG\n"
        ">gi|9|ref|NC_1.1| again\nTTTT\n"
    )
    out = tmp_path / "out"
    out.mkdir()
    paths = download.split_genomic_fna(str(src), str(out))
    assert sorted(os.path.basename(p) for p in paths) == [
        "NC_1.1.fna", "NC_2.2.fna"
    ]
    assert (out / "NC_1.1.fna").read_text() == (
        ">NC_1.1 Escherichia coli\nACGT\nACGT\n>NC_1.1 again\nTTTT\n"
    )
    assert (out / "NC_2.2.fna").read_text() == ">NC_2.2 plain header\nGGGG\n"


def test_download_genomes_release_end_to_end(server, tmp_path):
    """download_data_release.sh: RELEASE_NUMBER + every <group>.N volume →
    gunzip → split per sequence → .<group> manifest; idempotent."""
    server.docroot["release/RELEASE_NUMBER"] = b"230\n"
    vol1 = b">gi|1|ref|NC_A.1| one\nAAAA\n>NC_B.1 two\nCCCC\n"
    vol2 = b">NC_C.9 three\nGGGG\n"
    server.docroot["release/bacteria/bacteria.1.genomic.fna.gz"] = (
        gzip.compress(vol1)
    )
    server.docroot["release/bacteria/bacteria.2.genomic.fna.gz"] = (
        gzip.compress(vol2)
    )
    server.docroot["release/bacteria/"] = _index_html([
        "bacteria.1.genomic.fna.gz", "bacteria.2.genomic.fna.gz",
        "RELEASE_NUMBER", "notes.txt",
    ])
    dest = tmp_path / "seqs"
    dest.mkdir()
    manifest = download.download_genomes_release(
        str(dest), "bacteria", base_url=f"{server.base}/release",
        log=lambda *a: None,
    )
    lines = open(manifest).read().splitlines()
    paths = [ln for ln in lines if not ln.startswith("#")]
    assert sorted(os.path.basename(p) for p in paths) == [
        "NC_A.1.fna", "NC_B.1.fna", "NC_C.9.fna"
    ]
    assert any("refseq_release: 230" in ln for ln in lines)
    assert (dest / "Bacteria" / "NC_A.1.fna").read_text() == (
        ">NC_A.1 one\nAAAA\n"
    )
    # volumes removed after splitting
    assert not any(
        f.endswith((".gz", ".genomic.fna"))
        for f in os.listdir(dest / "Bacteria")
    )
    # idempotent re-run
    server.docroot.clear()
    assert download.download_genomes_release(
        str(dest), "bacteria", base_url=f"{server.base}/release",
        log=lambda *a: None,
    ) == manifest


def test_download_genomes_release_unknown_group(server, tmp_path):
    server.docroot["release/RELEASE_NUMBER"] = b"230\n"
    with pytest.raises(DownloadError, match="exists in RefSeq"):
        download.download_genomes_release(
            str(tmp_path), "nosuch", base_url=f"{server.base}/release",
            log=lambda *a: None,
        )


# ---------------------------------------------------------------- archive


def _tar_gz(members):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as t:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            t.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def test_download_genomes_archive_bacteria(server, tmp_path):
    """download_data.sh bacteria: old_refseq all.fna.tar.gz untarred,
    manifest from the extracted *.fna set."""
    server.docroot["genomes/archive/old_refseq/Bacteria/all.fna.tar.gz"] = (
        _tar_gz({
            "Escherichia_coli/NC_1.fna": b">NC_1\nACGT\n",
            "Salmonella/NC_2.fna": b">NC_2\nGGGG\n",
            "Salmonella/readme.txt": b"not a genome",
        })
    )
    dest = tmp_path / "seqs"
    dest.mkdir()
    manifest = download.download_genomes_archive(
        str(dest), "bacteria", base_url=f"{server.base}/genomes",
        log=lambda *a: None,
    )
    paths = open(manifest).read().split()
    assert sorted(os.path.basename(p) for p in paths) == [
        "NC_1.fna", "NC_2.fna"
    ]
    assert (dest / "Bacteria" / "Escherichia_coli" / "NC_1.fna").exists()
    assert not (dest / "Bacteria" / "Salmonella" / "readme.txt").exists()


def test_download_genomes_archive_viruses_and_human(server, tmp_path):
    server.docroot["genomes/Viruses/all.fna.tar.gz"] = _tar_gz(
        {"V1/NC_9.fna": b">NC_9\nAC\n"}
    )
    server.docroot["genomes/Viruses/all.ffn.tar.gz"] = _tar_gz(
        {"V1/NC_9.ffn": b">NC_9 cds\nAC\n"}
    )
    dest = tmp_path / "v"
    dest.mkdir()
    manifest = download.download_genomes_archive(
        str(dest), "viruses", base_url=f"{server.base}/genomes",
        log=lambda *a: None,
    )
    names = sorted(
        os.path.basename(p) for p in open(manifest).read().split()
    )
    assert names == ["NC_9.ffn", "NC_9.fna"]

    # human: per-chromosome listing + gunzip
    for chrdir, chrom in (("CHR_01", "1"), ("CHR_X", "X")):
        name = f"hs_ref_GRCh38_chr{chrom}.fa.gz"
        server.docroot[f"genomes/H_sapiens/{chrdir}/"] = _index_html(
            [name, "README"]
        )
        server.docroot[f"genomes/H_sapiens/{chrdir}/{name}"] = (
            gzip.compress(f">chr{chrom}\nACGT\n".encode())
        )
    for chrdir in download._HUMAN_CHRS:
        server.docroot.setdefault(
            f"genomes/H_sapiens/{chrdir}/", _index_html([])
        )
    dest2 = tmp_path / "h"
    dest2.mkdir()
    manifest = download.download_genomes_archive(
        str(dest2), "human", base_url=f"{server.base}/genomes",
        log=lambda *a: None,
    )
    names = sorted(
        os.path.basename(p) for p in open(manifest).read().split()
    )
    assert names == [
        "hs_ref_GRCh38_chr1.fa", "hs_ref_GRCh38_chrX.fa"
    ]
    assert (dest2 / "Human" / "hs_ref_GRCh38_chr1.fa").read_text() == (
        ">chr1\nACGT\n"
    )


def test_download_genomes_archive_bad_group(tmp_path):
    with pytest.raises(DownloadError, match="choose between"):
        download.download_genomes_archive(
            str(tmp_path), "plants", log=lambda *a: None
        )


def test_cli_download_genomes_flows(server, tmp_path, capsys):
    from jn_cuclark_tpu_torch import cli

    server.docroot["release/RELEASE_NUMBER"] = b"230\n"
    server.docroot["release/viral/viral.1.genomic.fna.gz"] = gzip.compress(
        b">NC_V.1 virus\nACGT\n"
    )
    server.docroot["release/viral/"] = _index_html(
        ["viral.1.genomic.fna.gz"]
    )
    dest = tmp_path / "seqs"
    dest.mkdir()
    rc = cli.main([
        "db", "download-genomes", str(dest), "viruses",
        "--flow", "release", "--base-url", f"{server.base}/release",
    ])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "(1 sequences)" in out
    assert (dest / "Viruses" / "NC_V.1.fna").exists()
