#!/bin/sh
# rnor6: download + build recipe (counterpart of
# HISAT2's scripts/make_rnor6.sh — same data sources, our builder).
# Requires network access; run in an empty working directory.
set -e
fetch() {
    f=$(basename "$1")
    [ -f "$f" ] || wget -O "$f" "$1" || curl -o "$f" "$1"
}

fetch "ftp://ftp.ensembl.org/pub/release-84/fasta/rattus_norvegicus/dna/Rattus_norvegicus.Rnor_6.0.dna.toplevel.fa.gz"

rm -f genome.fa
gzip -cd Rattus_norvegicus.Rnor_6.0.dna.toplevel.fa.gz >> genome.fa
python -m hisat2_tpu build genome.fa genome 
echo "genome index built"
