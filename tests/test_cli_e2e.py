"""End-to-end CLI regression tests against committed oracle SAMs.

Drives the actual product surface — ``python -m hisat2_tpu align`` — on a
200-read subset of the reference's bundled example corpus (HISAT2's
example/reads, every 5th read) and requires byte-equal SAM bodies vs
oracle outputs committed in tests/data/ (produced by the reference
hisat2-align-s; see tests/make_corpora.py).  The example genome is not
in this repo: set HISAT2_SRC to a HISAT2 source checkout to run these;
without it they skip.

These exist so a snapshot commit can never silently break the CLI again
(round-1 regression: unpaired path crashed at pipeline.py:1199 while all
unit tests stayed green).  Reference behavior: hisat2.cpp:3581 driver()
end-to-end flow.
"""

import gzip
import os
import subprocess
import sys

import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")
EX_REF = os.path.join(os.environ.get("HISAT2_SRC", ""), "example",
                      "reference")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cli(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # single-device CPU is fastest for the CLI
    r = subprocess.run([sys.executable, "-m", "hisat2_tpu"] + args,
                       cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, f"CLI failed: {r.stderr[-2000:]}"
    return r


def _sam_body(path, opener=open):
    with opener(path, "rt") as f:
        return [l for l in f if not l.startswith("@")]


@pytest.fixture(scope="module")
def idx(tmp_path_factory):
    fa = f"{EX_REF}/22_20-21M.fa"
    snp = f"{EX_REF}/22_20-21M.snp"
    if not os.path.exists(fa):
        pytest.skip("the example genome (HISAT2 example/reference/"
                    "22_20-21M.fa) is absent: set HISAT2_SRC to a HISAT2 "
                    "source checkout")
    d = tmp_path_factory.mktemp("cli_idx")
    _run_cli(["build", fa, "lin"], cwd=str(d))
    _run_cli(["build", fa, "snp", "--snp", snp], cwd=str(d))
    return d


@pytest.mark.parametrize("name,args", [
    ("ref_cli_unp_lin", ["align", "-x", "lin", "-f",
                         "-U", f"{DATA}/sub_reads_1.fa",
                         "--no-spliced-alignment"]),
    ("ref_cli_unp_snp", ["align", "-x", "snp", "-f",
                         "-U", f"{DATA}/sub_reads_1.fa",
                         "--no-spliced-alignment"]),
    ("ref_cli_pe_lin", ["align", "-x", "lin", "-f",
                        "-1", f"{DATA}/sub_reads_1.fa",
                        "-2", f"{DATA}/sub_reads_2.fa",
                        "--no-mixed", "--no-spliced-alignment"]),
])
def test_cli_oracle_parity(idx, name, args):
    out = str(idx / f"{name}.sam")
    _run_cli(args + ["-S", out], cwd=str(idx))
    got = _sam_body(out)
    want = _sam_body(f"{DATA}/{name}.sam.gz", opener=gzip.open)
    assert len(got) == len(want)
    mism = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    assert not mism, (
        f"{len(mism)} records differ from oracle, first at body line "
        f"{mism[0]}:\n got: {got[mism[0]]}want: {want[mism[0]]}")
