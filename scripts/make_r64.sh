#!/bin/sh
# r64: download + build recipe (counterpart of
# HISAT2's scripts/make_r64.sh — same data sources, our builder).
# Requires network access; run in an empty working directory.
set -e
fetch() {
    f=$(basename "$1")
    [ -f "$f" ] || wget -O "$f" "$1" || curl -o "$f" "$1"
}

fetch "ftp://ftp.ensembl.org/pub/release-84/fasta/saccharomyces_cerevisiae/dna/Saccharomyces_cerevisiae.R64-1-1.dna.toplevel.fa.gz"

rm -f genome.fa
gzip -cd Saccharomyces_cerevisiae.R64-1-1.dna.toplevel.fa.gz >> genome.fa
python -m hisat2_tpu build genome.fa genome 
echo "genome index built"
