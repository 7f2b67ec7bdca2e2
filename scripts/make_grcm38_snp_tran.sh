#!/bin/sh
# grcm38_snp_tran: download + build recipe (counterpart of
# HISAT2's scripts/make_grcm38_snp_tran.sh — same data sources, our builder).
# Requires network access; run in an empty working directory.
set -e
fetch() {
    f=$(basename "$1")
    [ -f "$f" ] || wget -O "$f" "$1" || curl -o "$f" "$1"
}

fetch "ftp://ftp.ensembl.org/pub/release-84/fasta/mus_musculus/dna/Mus_musculus.GRCm38.dna.primary_assembly.fa.gz"
fetch "http://hgdownload.cse.ucsc.edu/goldenPath/mm10/database/snp142Common.txt.gz"
fetch "ftp://ftp.ensembl.org/pub/release-84/gtf/mus_musculus/Mus_musculus.GRCm38.84.gtf.gz"

rm -f genome.fa
gzip -cd Mus_musculus.GRCm38.dna.primary_assembly.fa.gz >> genome.fa
gzip -cd Mus_musculus.GRCm38.84.gtf.gz > genome.gtf
python -m hisat2_tpu extract-splice-sites genome.gtf > genome.ss
python -m hisat2_tpu extract-exons genome.gtf > genome.exon
gzip -cd snp142Common.txt.gz > snp142Common.txt
python -m hisat2_tpu extract-snps-haplotypes-ucsc genome.fa snp142Common.txt genome
python -m hisat2_tpu build genome.fa genome_snp_tran --ss genome.ss --exon genome.exon --snp genome.snp --haplotype genome.haplotype
echo "genome_snp_tran index built"
