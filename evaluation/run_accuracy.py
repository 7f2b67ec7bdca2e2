#!/usr/bin/env python3
"""Repeatable accuracy report for BASELINE configs 2-4.

End-to-end through the CLI: build the config's index, simulate reads
with a ground-truth SAM (`simulate-reads`, the in-repo port of
hisat2_simulate_reads.py), align, and score with calculate_read_cost's
read/pair/junction classification — the same protocol the reference
drives with evaluation/simulation/calculate_read_cost.py.

  python evaluation/run_accuracy.py [--config 2 3 4] [--n 20000]

Configs (BASELINE.md):
  2: synthetic 40 Mbp linear genome, single-end 100 bp DNA (+0.2% errors)
  3: chr22 1 Mbp slice + dbSNP .snp graph index, paired-end DNA with
     catalog variants planted in the reads
  4: chr22 slice + synthetic transcriptome (48 multi-exon transcripts),
     spliced RNA with novel-junction discovery

Results are recorded in BENCH_EXTRA.md.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
sys.path.insert(0, HERE)

from calculate_read_cost import parse_sam, report, score  # noqa: E402

EXAMPLE_FA = "/root/reference/example/reference/22_20-21M.fa"
EXAMPLE_SNP = "/root/reference/example/reference/22_20-21M.snp"
ACGT = np.array(list("ACGT"))


def sh(args, **kw):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.pop("XLA_FLAGS", None)          # no virtual CPU mesh in the CLI
    r = subprocess.run([sys.executable, "-m", "hisat2_tpu"] + args,
                       env=env, capture_output=True, text=True, **kw)
    if r.returncode != 0:
        raise SystemExit(f"CLI failed: {' '.join(args)}\n{r.stderr[-2000:]}")
    return r


def write_fa(path, name, codes):
    with open(path, "w") as f:
        f.write(f">{name}\n")
        s = "".join(ACGT[np.asarray(codes)])
        for i in range(0, len(s), 60):
            f.write(s[i:i + 60] + "\n")


def make_gtf(path, genome, rng, n_tran=48, chrom="22:20000001-21000000"):
    """Synthetic multi-exon transcripts over the slice (3-6 exons,
    100-700 bp exons, 100-5000 bp introns).  95% of introns get GT..AG
    donors/acceptors planted in `genome` (real transcriptomes are ~98%
    canonical; the remainder exercises the non-canonical path)."""
    glen = len(genome)
    GT = np.array([2, 3], np.uint8)
    AG = np.array([0, 2], np.uint8)
    with open(path, "w") as f:
        for t in range(n_tran):
            pos = int(rng.integers(1000, glen - 40000))
            nex = int(rng.integers(3, 7))
            strand = "+-"[int(rng.integers(2))]
            for e in range(nex):
                elen = int(rng.integers(100, 700))
                f.write(f"{chrom}\tsim\texon\t{pos + 1}\t{pos + elen}\t."
                        f"\t{strand}\t.\tgene_id \"g{t}\"; "
                        f"transcript_id \"t{t}\";\n")
                ilen = int(rng.integers(100, 5000))
                if e + 1 < nex and rng.random() < 0.95:
                    i0 = pos + elen        # first intronic base
                    if strand == "+":
                        genome[i0:i0 + 2] = GT
                        genome[i0 + ilen - 2:i0 + ilen] = AG
                    else:
                        # minus strand: CT..AC on the plus text
                        genome[i0:i0 + 2] = np.array([1, 3], np.uint8)
                        genome[i0 + ilen - 2:i0 + ilen] = \
                            np.array([0, 1], np.uint8)
                pos += elen + ilen
    return path


def run_config(cfg: int, n: int, d: str):
    rng = np.random.default_rng(11)
    os.makedirs(d, exist_ok=True)
    sim = [f"{d}/sim"]
    if cfg == 2:
        g = rng.integers(0, 4, 40_000_000).astype(np.uint8)
        fa = f"{d}/g40.fa"
        write_fa(fa, "c2", g)
        sh(["build", fa, f"{d}/idx"])
        sh(["simulate-reads", fa, sim[0], "-d", "--single-end",
            "-n", str(n), "--error-rate", "0.002"])
        align = ["align", "-x", f"{d}/idx", "-f",
                 "-U", f"{sim[0]}_1.fa", "--no-spliced-alignment"]
    elif cfg == 3:
        sh(["build", EXAMPLE_FA, f"{d}/idx", "--snp", EXAMPLE_SNP])
        sh(["simulate-reads", EXAMPLE_FA, sim[0], "-d",
            "--snp", EXAMPLE_SNP, "-n", str(n), "--error-rate", "0.002"])
        align = ["align", "-x", f"{d}/idx", "-f",
                 "-1", f"{sim[0]}_1.fa", "-2", f"{sim[0]}_2.fa",
                 "--no-spliced-alignment"]
    elif cfg == 4:
        code = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 0}
        seq = "".join(l.strip() for l in open(EXAMPLE_FA)
                      if not l.startswith(">"))
        genome = np.array([code[c] for c in seq.upper()], np.uint8)
        gtf = make_gtf(f"{d}/sim.gtf", genome, rng)
        fa = f"{d}/g4.fa"
        write_fa(fa, "22:20000001-21000000", genome)
        sh(["build", fa, f"{d}/idx"])
        sh(["simulate-reads", fa, sim[0], "--gtf", gtf,
            "--single-end", "-n", str(n)])
        align = ["align", "-x", f"{d}/idx", "-f",
                 "-U", f"{sim[0]}_1.fa"]
    else:
        raise SystemExit(f"unknown config {cfg}")
    out = f"{d}/out.sam"
    t0 = time.time()
    sh(align + ["-S", out])
    dt = time.time() - t0
    truth = parse_sam(f"{sim[0]}.sam")
    s = score(truth, parse_sam(out), slack=5)
    print(f"== config {cfg} ({len(truth)} mates, align wall "
          f"{dt:.1f}s incl. startup)")
    report(out, s)
    return s


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, nargs="+", default=[2, 3, 4])
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--workdir", default="/tmp/hisat2_tpu_accuracy")
    args = ap.parse_args()
    for cfg in args.config:
        run_config(cfg, args.n, os.path.join(args.workdir, f"c{cfg}"))


if __name__ == "__main__":
    main()
