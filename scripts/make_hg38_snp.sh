#!/bin/sh
# hg38_snp: download + build recipe (counterpart of
# HISAT2's scripts/make_hg38_snp.sh — same data sources, our builder).
# Requires network access; run in an empty working directory.
set -e
fetch() {
    f=$(basename "$1")
    [ -f "$f" ] || wget -O "$f" "$1" || curl -o "$f" "$1"
}

fetch "http://hgdownload.cse.ucsc.edu/goldenPath/hg38/bigZips/hg38.chromFa.tar.gz"
fetch "http://hgdownload.cse.ucsc.edu/goldenPath/hg38/database/snp144Common.txt.gz"

rm -f genome.fa
tar xzf hg38.chromFa.tar.gz 2>/dev/null || unzip -o hg38.chromFa.tar.gz
cat *.fa >> genome.fa 2>/dev/null || cat */*.fa >> genome.fa
gzip -cd snp144Common.txt.gz > snp144Common.txt
python -m hisat2_tpu extract-snps-haplotypes-ucsc genome.fa snp144Common.txt genome
python -m hisat2_tpu build genome.fa genome_snp --snp genome.snp --haplotype genome.haplotype
echo "genome_snp index built"
