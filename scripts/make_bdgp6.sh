#!/bin/sh
# bdgp6: download + build recipe (counterpart of
# HISAT2's scripts/make_bdgp6.sh — same data sources, our builder).
# Requires network access; run in an empty working directory.
set -e
fetch() {
    f=$(basename "$1")
    [ -f "$f" ] || wget -O "$f" "$1" || curl -o "$f" "$1"
}

fetch "ftp://ftp.ensembl.org/pub/release-84/fasta/drosophila_melanogaster/dna/Drosophila_melanogaster.BDGP6.dna.toplevel.fa.gz"

rm -f genome.fa
gzip -cd Drosophila_melanogaster.BDGP6.dna.toplevel.fa.gz >> genome.fa
python -m hisat2_tpu build genome.fa genome 
echo "genome index built"
