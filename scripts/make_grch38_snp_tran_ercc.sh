#!/bin/sh
# grch38_snp_tran_ercc: download + build recipe (counterpart of
# HISAT2's scripts/make_grch38_snp_tran_ercc.sh — same data sources, our builder).
# Requires network access; run in an empty working directory.
set -e
fetch() {
    f=$(basename "$1")
    [ -f "$f" ] || wget -O "$f" "$1" || curl -o "$f" "$1"
}

fetch "ftp://ftp.ensembl.org/pub/release-84/fasta/homo_sapiens/dna/Homo_sapiens.GRCh38.dna.primary_assembly.fa.gz"
fetch "https://tools.thermofisher.com/content/sfs/manuals/ERCC92.zip"
fetch "ftp://ftp.ensembl.org/pub/release-84/gtf/homo_sapiens/Homo_sapiens.GRCh38.84.gtf.gz"
fetch "http://hgdownload.cse.ucsc.edu/goldenPath/hg19/database/snp144Common.txt.gz"

rm -f genome.fa
gzip -cd Homo_sapiens.GRCh38.dna.primary_assembly.fa.gz >> genome.fa
unzip -o ERCC92.zip 2>/dev/null || true
cat ERCC92.fa >> genome.fa 2>/dev/null || true
gzip -cd Homo_sapiens.GRCh38.84.gtf.gz > genome.gtf
python -m hisat2_tpu extract-splice-sites genome.gtf > genome.ss
python -m hisat2_tpu extract-exons genome.gtf > genome.exon
gzip -cd snp144Common.txt.gz > snp144Common.txt
python -m hisat2_tpu extract-snps-haplotypes-ucsc genome.fa snp144Common.txt genome
python -m hisat2_tpu build genome.fa genome_snp_tran --ss genome.ss --exon genome.exon --snp genome.snp --haplotype genome.haplotype
echo "genome_snp_tran index built"
