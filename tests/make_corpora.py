#!/usr/bin/env python3
"""Regenerate the parity corpora this repo is byte-verified against.

This script rebuilds every fixture genome/read set, builds both our
indexes and the reference's, and runs the reference oracle (HISAT2
v2.1.0's hisat2-align-s / hisat2-build-s) to produce the ref_*.sam ground
truths.  It needs two things from outside the repo, named by environment
variables:

  HISAT2_BIN  directory holding the oracle binaries built from the HISAT2
              source (make hisat2-align-s hisat2-build-s hisat2-inspect-s)
  HISAT2_SRC  the HISAT2 source checkout (its example/ corpus: the 1 Mbp
              chr22 slice, its reads and its .snp file)

Usage:  HISAT2_BIN=... HISAT2_SRC=... \
        python tests/make_corpora.py [--only spltest,dnaparity,...]

Corpora produced (matching PARITY.md), each in a directory under
$CORPORA_DIR (default: ./corpora):
  dnaparity  example chr22 slice: linear + SNP-graph indexes,
             1500-read variant fuzz, known-indel reads, edge reads
  spltest    planted-intron RNA genome: spliced corpus, _tran index,
             known-splice-site runs, simulated RNA pairs
  mjtest     two-intron (multi-junction) corpus
  petest     mate-rescue paired corpus (repeat locus)
  rngtest    duplicated-locus multimap corpora (tie-break RNG)
  shardtest  two-chromosome genome for sharded-index equivalence
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

REF = os.environ.get("HISAT2_BIN", "")
EX = os.path.join(os.environ.get("HISAT2_SRC", ""), "example")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.environ.get("CORPORA_DIR", "corpora")
ACGT = np.array(list("ACGT"))


def sh(cmd, **kw):
    print("+", cmd)
    subprocess.run(cmd, shell=True, check=True, **kw)


def write_fa(path, seqs):
    with open(path, "w") as f:
        for nm, codes in seqs:
            f.write(f">{nm}\n")
            s = "".join(ACGT[np.asarray(codes)])
            for i in range(0, len(s), 60):
                f.write(s[i:i + 60] + "\n")


def oracle_build(fa, base, extra=""):
    sh(f"cd {os.path.dirname(fa) or '.'} && "
       f"{REF}/hisat2-build-s {extra} {os.path.basename(fa)} {base} "
       f">/dev/null 2>&1")


def oracle_align(d, idx, args, out):
    sh(f"cd {d} && {REF}/hisat2-align-s -x {idx} {args} -S {out} "
       f"2>/dev/null")


def our_build(d, fa, base, extra=""):
    sh(f"cd {d} && PYTHONPATH={REPO} JAX_PLATFORMS=cpu "
       f"python -m hisat2_tpu build {fa} {base} {extra} >/dev/null 2>&1")


def mk_dnaparity():
    d = os.path.join(OUT, "dnaparity")
    os.makedirs(d, exist_ok=True)
    sh(f"cp {EX}/reference/22_20-21M.fa {d}/22_20-21M.fa")
    oracle_build(f"{d}/22_20-21M.fa", "lin")
    sh(f"cd {d} && {REF}/hisat2-build-s --snp {EX}/reference/22_20-21M.snp "
       f"22_20-21M.fa snp >/dev/null 2>&1")
    our_build(d, "22_20-21M.fa", "our_lin")
    our_build(d, "22_20-21M.fa", "our_snp",
              f"--snp {EX}/reference/22_20-21M.snp")
    # variant fuzz: 1500 reads with SNVs/dels/ins + errors, both strands
    gs = [l.strip() for l in open(f"{d}/22_20-21M.fa") if l[0] != ">"]
    g = np.frombuffer("".join(gs).upper().encode(), np.uint8).copy()
    code = np.zeros(len(g), np.uint8)
    for c, v in zip(b"ACGT", range(4)):
        code[g == c] = v
    # parse .snp for applied variants
    snps = []
    for l in open(f"{EX}/reference/22_20-21M.snp"):
        p = l.split()
        snps.append((p[0], p[1], int(p[3]), p[4]))
    rng = np.random.default_rng(20240501)
    comp = np.array([3, 2, 1, 0, 4], np.uint8)
    with open(f"{d}/fuzz.fa", "w") as f:
        for i in range(1500):
            kind = ["S", "Sr", "D", "Dr", "I", "Ir"][int(rng.integers(6))]
            o = int(rng.integers(1000, len(code) - 1200))
            r = code[o:o + 112].copy()
            if kind.startswith("S"):
                p = int(rng.integers(5, 95))
                r[p] = (r[p] + 1 + int(rng.integers(3))) % 4
                r = r[:100]
            elif kind.startswith("D"):
                dl = int(rng.integers(1, 6))
                p = int(rng.integers(5, 95))
                r = np.concatenate([r[:p], r[p + dl:]])[:100]
            else:
                il = int(rng.integers(1, 6))
                p = int(rng.integers(5, 95))
                ins = rng.integers(0, 4, il).astype(np.uint8)
                r = np.concatenate([r[:p], ins, r[p:]])[:100]
            if kind.endswith("r"):
                r = comp[r][::-1]
            f.write(f">fz{i}_{kind}_{o + 1}\n"
                    + "".join(ACGT[r]) + "\n")
    oracle_align(d, "snp", "--no-spliced-alignment -f -U fuzz.fa",
                 "ref_fz.sam")
    oracle_align(d, "lin",
                 "--no-spliced-alignment -f -U fuzz.fa --omit-sec-seq",
                 "r_oss.sam")
    oracle_align(d, "snp",
                 f"-f -U {EX}/reads/reads_1.fa --no-spliced-alignment",
                 "ref_snp.sam")
    oracle_align(d, "lin",
                 f"-f -U {EX}/reads/reads_1.fa --no-spliced-alignment",
                 "ref_lin.sam")
    oracle_align(d, "lin",
                 f"-f -1 {EX}/reads/reads_1.fa -2 {EX}/reads/reads_2.fa "
                 "--no-spliced-alignment", "ref_pe.sam")


def mk_spltest():
    d = os.path.join(OUT, "spltest")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(7)
    n = 200000
    g = rng.integers(0, 4, n).astype(np.uint8)
    introns = [(30000, 200), (60000, 1000), (90000, 5000),
               (120000, 80), (150000, 20000), (180000, 500)]
    for s0, ln in introns:
        g[s0], g[s0 + 1] = 2, 3
        g[s0 + ln - 2], g[s0 + ln - 1] = 0, 2
    write_fa(f"{d}/g.fa", [("chrT", g)])
    # spliced reads: per intron, left anchors 10..70 in steps + RC copies
    with open(f"{d}/reads.fa", "w") as f:
        i = 0
        comp = np.array([3, 2, 1, 0], np.uint8)
        for s0, ln in introns:
            for a in (10, 20, 30, 40, 50, 70):
                read = np.concatenate([g[s0 - a:s0], g[s0 + ln:s0 + ln
                                                       + 100 - a]])
                f.write(f">spl_{s0}_{ln}_a{a}\n"
                        + "".join(ACGT[read]) + "\n")
                i += 1
                if a in (30, 50):
                    rc = comp[read][::-1]
                    f.write(f">spl_{s0}_{ln}_a{a}_rc\n"
                            + "".join(ACGT[rc]) + "\n")
    oracle_build(f"{d}/g.fa", "spl")
    our_build(d, "g.fa", "our_idx")
    oracle_align(d, "spl", "-f -U reads.fa", "ref.sam")
    # known splice sites + transcript index
    with open(f"{d}/known.ss", "w") as f:
        for s0, ln in introns:
            f.write(f"chrT\t{s0 - 1}\t{s0 + ln}\t+\n")
    sh(f"cd {d} && {REF}/hisat2-build-s --ss known.ss g.fa tran "
       f">/dev/null 2>&1")
    our_build(d, "g.fa", "our_tran", "--ss known.ss")
    oracle_align(d, "tran", "-f -U reads.fa", "ref_tran.sam")
    oracle_align(d, "spl", "-f -U reads.fa --known-splicesite-infile "
                 "known.ss", "ref_ksi.sam")
    # simulated RNA pairs via our simulator (1500 pairs); transcripts
    # from a small GTF whose introns are the planted ones
    with open(f"{d}/g.gtf", "w") as f:
        for t, (s0, ln) in enumerate(introns):
            lo, hi = s0 - 3000, s0 + ln + 3000
            attr = (f'gene_id "G{t}"; transcript_id "T{t}";')
            f.write(f"chrT\tsim\texon\t{lo + 1}\t{s0}\t.\t+\t.\t{attr}\n")
            f.write(f"chrT\tsim\texon\t{s0 + ln + 1}\t{hi}\t.\t+\t.\t"
                    f"{attr}\n")
    sh(f"cd {d} && PYTHONPATH={REPO} JAX_PLATFORMS=cpu "
       f"python -m hisat2_tpu simulate-reads g.fa sim -n 1500 -r 100 "
       f"--gtf g.gtf >/dev/null 2>&1")
    oracle_align(d, "spl", "-f -1 sim_1.fa -2 sim_2.fa", "ref_rna_pe.sam")


def mk_rnafuzz():
    """RNA fuzz corpus (the spliced analog of mk_dnaparity's 1500-read
    variant fuzz): a 600 kbp genome with 30 planted introns (20 GT..AG,
    4 GC..AG, 3 AT..AC, 3 motif-less), 1500 100 bp reads — junction
    reads with anchors 8..92 (some with an extra mismatch), plain
    mismatch reads, both strands — oracle-aligned in default spliced
    mode."""
    d = os.path.join(OUT, "rnafuzz")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(20260820)
    n = 600000
    g = rng.integers(0, 4, n).astype(np.uint8)
    kinds = ["can"] * 20 + ["gc"] * 4 + ["atac"] * 3 + ["none"] * 3
    rng.shuffle(kinds)
    ilens = rng.integers(80, 12000, len(kinds))
    introns = []
    pos = 15000
    for kind, ln in zip(kinds, ilens):
        ln = int(ln)
        s0 = pos
        if kind == "can":
            dn, ac = (2, 3), (0, 2)       # GT..AG
        elif kind == "gc":
            dn, ac = (2, 1), (0, 2)       # GC..AG
        elif kind == "atac":
            dn, ac = (0, 3), (0, 1)       # AT..AC
        else:
            dn = ac = None
        if dn is not None:
            g[s0], g[s0 + 1] = dn
            g[s0 + ln - 2], g[s0 + ln - 1] = ac
        introns.append((s0, ln, kind))
        pos += ln + 4000
        if pos > n - 20000:
            break
    write_fa(f"{d}/g.fa", [("chrR", g)])
    comp = np.array([3, 2, 1, 0, 4], np.uint8)
    with open(f"{d}/fuzz.fa", "w") as f:
        for i in range(1500):
            r = rng.random()
            if r < 0.65:
                s0, ln, kind = introns[int(rng.integers(len(introns)))]
                a = int(rng.integers(8, 93))
                read = np.concatenate(
                    [g[s0 - a:s0], g[s0 + ln:s0 + ln + 100 - a]])
                tag = f"j{kind}_a{a}_{s0}"
                if rng.random() < 0.25:
                    p = int(rng.integers(0, 100))
                    read = read.copy()
                    read[p] = (read[p] + 1 + int(rng.integers(3))) % 4
                    tag += f"_mm{p}"
            else:
                o = int(rng.integers(1000, n - 1200))
                read = g[o:o + 100].copy()
                tag = f"p_{o + 1}"
                for _ in range(int(rng.integers(0, 3))):
                    p = int(rng.integers(0, 100))
                    read[p] = (read[p] + 1 + int(rng.integers(3))) % 4
                    tag += f"_mm{p}"
            if rng.random() < 0.3:
                read = comp[read][::-1]
                tag += "_rc"
            f.write(f">rf{i}_{tag}\n" + "".join(ACGT[read]) + "\n")
    oracle_build(f"{d}/g.fa", "rf")
    our_build(d, "g.fa", "ours")
    oracle_align(d, "rf", "-f -U fuzz.fa", "ref.sam")


def mk_mjtest():
    d = os.path.join(OUT, "mjtest")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(21)
    g = rng.integers(0, 4, 150000).astype(np.uint8)
    for s0, ln in ((40000, 400), (40440, 600)):
        g[s0], g[s0 + 1] = 2, 3
        g[s0 + ln - 2], g[s0 + ln - 1] = 0, 2
    write_fa(f"{d}/g.fa", [("chrM", g)])
    with open(f"{d}/r.fa", "w") as f:
        for a in (10, 20, 30, 40, 50):
            read = np.concatenate([g[40000 - a:40000],
                                   g[40400:40440],
                                   g[41040:41040 + 60 - a]])
            f.write(f">mj_l{a}\n" + "".join(ACGT[read]) + "\n")
    oracle_build(f"{d}/g.fa", "mj")
    our_build(d, "g.fa", "ours")
    oracle_align(d, "mj", "-f -U r.fa", "ref.sam")


def mk_petest():
    # mate-RESCUE corpus: mate2 sits in a block repeated 30x genome-wide
    # (global search gives up: every anchor too wide), so only the
    # window-anchored rescue (alignMate) can place it
    d = os.path.join(OUT, "petest")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(17)
    g = rng.integers(0, 4, 120000).astype(np.uint8)
    block = g[60000:60150].copy()
    for t in range(30):
        o = 2000 + t * 3800
        if abs(o - 60000) > 400:
            g[o:o + 150] = block
    write_fa(f"{d}/g.fa", [("chrP", g)])
    comp = np.array([3, 2, 1, 0], np.uint8)
    with open(f"{d}/p1.fa", "w") as f1, open(f"{d}/p2.fa", "w") as f2:
        for i in range(8):
            o = 60000 - 220 + i * 4
            m1 = g[o:o + 100]                       # unique anchor mate
            m2 = comp[g[o + 250:o + 350]][::-1]     # inside the repeat
            f1.write(f">p{i}\n" + "".join(ACGT[m1]) + "\n")
            f2.write(f">p{i}\n" + "".join(ACGT[m2]) + "\n")
    oracle_build(f"{d}/g.fa", "rep")
    our_build(d, "g.fa", "rep_ours")
    oracle_align(d, "rep", "-f -1 p1.fa -2 p2.fa", "ref.sam")


def mk_rngtest():
    d = os.path.join(OUT, "rngtest")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(99)
    g = rng.integers(0, 4, 300000).astype(np.uint8)
    g[150000:153000] = g[50000:53000]
    write_fa(f"{d}/g.fa", [("chrR", g)])
    offs = rng.integers(50000, 52900, 200)
    with open(f"{d}/r.fa", "w") as f:
        for i, o in enumerate(offs):
            f.write(f">mm{i}\n" + "".join(ACGT[g[o:o + 100]]) + "\n")
    oracle_build(f"{d}/g.fa", "mm")
    our_build(d, "g.fa", "our_mm")
    oracle_align(d, "mm", "--no-spliced-alignment -f -U r.fa", "ref.sam")
    # 3-copy variant
    g3 = rng.integers(0, 4, 400000).astype(np.uint8)
    g3[150000:153000] = g3[50000:53000]
    g3[250000:253000] = g3[50000:53000]
    write_fa(f"{d}/g3.fa", [("chr3", g3)])
    with open(f"{d}/r3.fa", "w") as f:
        for i, o in enumerate(rng.integers(50000, 52900, 150)):
            f.write(f">t{i}\n" + "".join(ACGT[g3[o:o + 100]]) + "\n")
    oracle_build(f"{d}/g3.fa", "mm3")
    our_build(d, "g3.fa", "our_mm3")
    oracle_align(d, "mm3", "--no-spliced-alignment -f -U r3.fa", "ref3.sam")


def mk_shardtest():
    d = os.path.join(OUT, "shardtest")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(31)
    write_fa(f"{d}/g.fa", [("chrA", rng.integers(0, 4, 400000)),
                           ("chrB", rng.integers(0, 4, 400000))])
    our_build(d, "g.fa", "single")
    our_build(d, "g.fa", "sharded", "--shard-bp 450000")


ALL = {"dnaparity": mk_dnaparity, "rnafuzz": mk_rnafuzz,
       "spltest": mk_spltest,
       "mjtest": mk_mjtest, "petest": mk_petest,
       "rngtest": mk_rngtest, "shardtest": mk_shardtest}


def main():
    only = None
    if len(sys.argv) > 2 and sys.argv[1] == "--only":
        only = set(sys.argv[2].split(","))
    if not os.path.exists(f"{REF}/hisat2-align-s"):
        print("set HISAT2_BIN to the oracle binaries' directory (see the "
              "module docstring)", file=sys.stderr)
        return 1
    for name, fn in ALL.items():
        if only and name not in only:
            continue
        print(f"== {name}")
        fn()
    return 0


if __name__ == "__main__":
    sys.exit(main())
