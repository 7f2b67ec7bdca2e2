#!/bin/sh
# grcm38: download + build recipe (counterpart of
# HISAT2's scripts/make_grcm38.sh — same data sources, our builder).
# Requires network access; run in an empty working directory.
set -e
fetch() {
    f=$(basename "$1")
    [ -f "$f" ] || wget -O "$f" "$1" || curl -o "$f" "$1"
}

fetch "ftp://ftp.ensembl.org/pub/release-84/fasta/mus_musculus/dna/Mus_musculus.GRCm38.dna.primary_assembly.fa.gz"

rm -f genome.fa
gzip -cd Mus_musculus.GRCm38.dna.primary_assembly.fa.gz >> genome.fa
python -m hisat2_tpu build genome.fa genome 
echo "genome index built"
