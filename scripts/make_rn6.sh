#!/bin/sh
# rn6: download + build recipe (counterpart of
# HISAT2's scripts/make_rn6.sh — same data sources, our builder).
# Requires network access; run in an empty working directory.
set -e
fetch() {
    f=$(basename "$1")
    [ -f "$f" ] || wget -O "$f" "$1" || curl -o "$f" "$1"
}

fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/rn6/bigZips/rn6.fa.gz"

rm -f genome.fa
gzip -cd rn6.fa.gz >> genome.fa
python -m hisat2_tpu build genome.fa genome 
echo "genome index built"
