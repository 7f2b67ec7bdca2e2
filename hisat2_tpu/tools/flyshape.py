"""Synthetic genome shaped like HISAT2's documented bdgp6_tran index.

scripts/make_bdgp6_tran.sh builds D. melanogaster BDGP6 (dm6) with its
Ensembl GTF.  No FASTA can be downloaded here, so this writes a seeded
stand-in with the same shape:

  genome.fa     the seven dm6 sequences at their published lengths
                (2L 2R 3L 3R 4 X Y, 137,547,960 bp), uniform random bases
  genes.gtf     ~14,000 genes, one transcript each, 2-8 exons (~4 introns
                per gene); 98% of introns get a canonical GT..AG motif
                planted on their strand (CT..AC on the plus text for '-')
  variants.snp  ~1 small variant per kbp in dbSNP's 90/5/5 SNV /
                deletion / insertion mix (as evaluation/make_northstar.py),
                1-5 bp indels, no two variants within 10 bp

`scale` shrinks every sequence, the gene count and the variant count by
the same factor (tests use it; the shapes stay the same).

Limit: the bases are uniform random, with no repeat families or
duplicated loci (dm6 is ~20% transposons), so nearly every read has one
locus.  Multi-hit reporting, the resolve loop and rescue inside repeats
barely run on this genome; a cell that should exercise them needs seeded
repeat families (copies a few percent divergent) planted first.

  python -m hisat2_tpu.tools.flyshape OUTDIR [--scale S] [--seed N]
"""

from __future__ import annotations

import os

import numpy as np

DM6_CHROMS = (("2L", 23_513_712), ("2R", 25_286_936), ("3L", 28_110_227),
              ("3R", 32_079_331), ("4", 1_348_131), ("X", 23_542_271),
              ("Y", 3_667_352))
N_GENES = 14_000
VARIANTS_PER_BP = 1e-3
CANONICAL_SHARE = 0.98
_ACGT = np.frombuffer(b"ACGT", np.uint8)


def _write_fasta(f, name: str, codes: np.ndarray, width: int = 60):
    f.write(f">{name}\n".encode())
    seq = _ACGT[codes]
    n_full = len(seq) // width
    body = np.empty((n_full, width + 1), np.uint8)
    body[:, :width] = seq[:n_full * width].reshape(n_full, width)
    body[:, width] = ord("\n")
    f.write(body.tobytes())
    if len(seq) % width:
        f.write(seq[n_full * width:].tobytes() + b"\n")


def _genes(rng, name: str, codes: np.ndarray, n_genes: int, first: int):
    """(GTF lines, genes written) for up to n_genes non-overlapping genes
    on one sequence, one per equal slot; plants the splice motifs into
    `codes` in place."""
    lines = []
    written = 0
    slot = len(codes) // max(n_genes, 1)
    for g in range(n_genes):
        n_ex = int(rng.integers(2, 9))                 # 1-7 introns, mean 4
        ex = rng.integers(80, 400, n_ex)
        # fly introns: mostly short, a long tail (log-uniform 60 bp-3 kbp)
        intr = np.exp(rng.uniform(np.log(60), np.log(3000),
                                  n_ex - 1)).astype(np.int64)
        span = int(ex.sum() + intr.sum())
        if span + 200 > slot:
            continue
        pos = g * slot + int(rng.integers(100, slot - span - 100 + 1))
        strand = "+-"[int(rng.integers(2))]
        gid = f"FSG{first + written:06d}"
        written += 1
        for e in range(n_ex):
            lines.append(f"{name}\tflyshape\texon\t{pos + 1}\t"
                         f"{pos + int(ex[e])}\t.\t{strand}\t.\t"
                         f'gene_id "{gid}"; transcript_id "{gid}-RA";\n')
            pos += int(ex[e])
            if e + 1 < n_ex:
                il = int(intr[e])
                if rng.random() < CANONICAL_SHARE:
                    if strand == "+":
                        codes[pos:pos + 2] = (2, 3)            # GT
                        codes[pos + il - 2:pos + il] = (0, 2)  # AG
                    else:
                        codes[pos:pos + 2] = (1, 3)            # CT
                        codes[pos + il - 2:pos + il] = (0, 1)  # AC
                pos += il
    return lines, written


def _variants(rng, name: str, codes: np.ndarray, first: int):
    n = len(codes)
    k = int(round(n * VARIANTS_PER_BP))
    if k == 0 or n < 200:
        return []
    pos = np.sort(rng.choice(np.arange(20, n - 20), k, replace=False))
    pos = pos[np.concatenate([[True], np.diff(pos) >= 10])]
    kind = rng.random(len(pos))
    lines = []
    for i, (p, kr) in enumerate(zip(pos.tolist(), kind.tolist())):
        vid = f"rs{first + i}"
        if kr < 0.90:
            alt = "ACGT"[(int(codes[p]) + 1 + int(rng.integers(3))) % 4]
            lines.append(f"{vid}\tsingle\t{name}\t{p}\t{alt}\n")
        elif kr < 0.95:
            lines.append(f"{vid}\tdeletion\t{name}\t{p}\t"
                         f"{int(rng.integers(1, 6))}\n")
        else:
            ins = "".join("ACGT"[x] for x in
                          rng.integers(0, 4, int(rng.integers(1, 6))))
            lines.append(f"{vid}\tinsertion\t{name}\t{p}\t{ins}\n")
    return lines


def write_fly_shape(outdir: str, seed: int = 0, scale: float = 1.0) -> dict:
    """Write genome.fa, genes.gtf and variants.snp into outdir; returns
    {"fasta", "gtf", "snp": path, "bp": total length, "genes": n}."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    chroms = [(n, max(int(ln * scale), 20_000)) for n, ln in DM6_CHROMS]
    total = sum(ln for _, ln in chroms)
    paths = {k: os.path.join(outdir, f) for k, f in
             (("fasta", "genome.fa"), ("gtf", "genes.gtf"),
              ("snp", "variants.snp"))}
    n_genes = n_vars = 0
    with open(paths["fasta"], "wb") as fa, open(paths["gtf"], "w") as gtf, \
            open(paths["snp"], "w") as snp:
        for name, ln in chroms:
            codes = rng.integers(0, 4, ln, dtype=np.uint8)
            lines, g = _genes(rng, name, codes,
                              int(round(N_GENES * scale * ln / total)),
                              n_genes)
            gtf.writelines(lines)
            n_genes += g
            # variants after the motifs, so every SNV differs from the
            # planted reference base
            vl = _variants(rng, name, codes, n_vars)
            snp.writelines(vl)
            n_vars += len(vl)
            _write_fasta(fa, name, codes)
    return dict(paths, bp=total, genes=n_genes, variants=n_vars)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(prog="flyshape", description=__doc__
                                 .split("\n")[0])
    ap.add_argument("outdir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0)
    a = ap.parse_args(argv)
    info = write_fly_shape(a.outdir, a.seed, a.scale)
    print(f"[flyshape] {info['bp']} bp, {info['genes']} genes, "
          f"{info['variants']} variants -> {a.outdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
