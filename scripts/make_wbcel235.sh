#!/bin/sh
# wbcel235: download + build recipe (counterpart of
# HISAT2's scripts/make_wbcel235.sh — same data sources, our builder).
# Requires network access; run in an empty working directory.
set -e
fetch() {
    f=$(basename "$1")
    [ -f "$f" ] || wget -O "$f" "$1" || curl -o "$f" "$1"
}

fetch "ftp://ftp.ensembl.org/pub/release-84/fasta/caenorhabditis_elegans/dna/Caenorhabditis_elegans.WBcel235.dna.toplevel.fa.gz"

rm -f genome.fa
gzip -cd Caenorhabditis_elegans.WBcel235.dna.toplevel.fa.gz >> genome.fa
python -m hisat2_tpu build genome.fa genome 
echo "genome index built"
