#!/bin/sh
# sc3: download + build recipe (counterpart of
# HISAT2's scripts/make_sc3.sh — same data sources, our builder).
# Requires network access; run in an empty working directory.
set -e
fetch() {
    f=$(basename "$1")
    [ -f "$f" ] || wget -O "$f" "$1" || curl -o "$f" "$1"
}

fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/sacCer3/bigZips/chromFa.tar.gz"

rm -f genome.fa
tar xzf chromFa.tar.gz 2>/dev/null || unzip -o chromFa.tar.gz
cat *.fa >> genome.fa 2>/dev/null || cat */*.fa >> genome.fa
python -m hisat2_tpu build genome.fa genome 
echo "genome index built"
