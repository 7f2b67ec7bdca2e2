#!/bin/sh
# grcm38_snp: download + build recipe (counterpart of
# HISAT2's scripts/make_grcm38_snp.sh — same data sources, our builder).
# Requires network access; run in an empty working directory.
set -e
fetch() {
    f=$(basename "$1")
    [ -f "$f" ] || wget -O "$f" "$1" || curl -o "$f" "$1"
}

fetch "ftp://ftp.ensembl.org/pub/release-84/fasta/mus_musculus/dna/Mus_musculus.GRCm38.dna.primary_assembly.fa.gz"
fetch "http://hgdownload.cse.ucsc.edu/goldenPath/mm10/database/snp142Common.txt.gz"

rm -f genome.fa
gzip -cd Mus_musculus.GRCm38.dna.primary_assembly.fa.gz >> genome.fa
gzip -cd snp142Common.txt.gz > snp142Common.txt
python -m hisat2_tpu extract-snps-haplotypes-ucsc genome.fa snp142Common.txt genome
python -m hisat2_tpu build genome.fa genome_snp --snp genome.snp --haplotype genome.haplotype
echo "genome_snp index built"
