#!/bin/sh
# hg38_snp_tran: download + build recipe (counterpart of
# HISAT2's scripts/make_hg38_snp_tran.sh — same data sources, our builder).
# Requires network access; run in an empty working directory.
set -e
fetch() {
    f=$(basename "$1")
    [ -f "$f" ] || wget -O "$f" "$1" || curl -o "$f" "$1"
}

fetch "http://hgdownload.cse.ucsc.edu/goldenPath/hg38/bigZips/hg38.chromFa.tar.gz"

rm -f genome.fa
tar xzf hg38.chromFa.tar.gz 2>/dev/null || unzip -o hg38.chromFa.tar.gz
cat *.fa >> genome.fa 2>/dev/null || cat */*.fa >> genome.fa
python -m hisat2_tpu build genome.fa genome 
echo "genome index built"
