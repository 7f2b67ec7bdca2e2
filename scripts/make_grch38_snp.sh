#!/bin/sh
# grch38_snp: download + build recipe (counterpart of
# HISAT2's scripts/make_grch38_snp.sh — same data sources, our builder).
# Requires network access; run in an empty working directory.
set -e
fetch() {
    f=$(basename "$1")
    [ -f "$f" ] || wget -O "$f" "$1" || curl -o "$f" "$1"
}

fetch "ftp://ftp.ensembl.org/pub/release-84/fasta/homo_sapiens/dna/Homo_sapiens.GRCh38.dna.primary_assembly.fa.gz"
fetch "http://hgdownload.cse.ucsc.edu/goldenPath/hg38/database/snp144Common.txt.gz"

rm -f genome.fa
gzip -cd Homo_sapiens.GRCh38.dna.primary_assembly.fa.gz >> genome.fa
gzip -cd snp144Common.txt.gz > snp144Common.txt
python -m hisat2_tpu extract-snps-haplotypes-ucsc genome.fa snp144Common.txt genome
python -m hisat2_tpu build genome.fa genome_snp --snp genome.snp --haplotype genome.haplotype
echo "genome_snp index built"
