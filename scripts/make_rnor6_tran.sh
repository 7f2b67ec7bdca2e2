#!/bin/sh
# rnor6_tran: download + build recipe (counterpart of
# HISAT2's scripts/make_rnor6_tran.sh — same data sources, our builder).
# Requires network access; run in an empty working directory.
set -e
fetch() {
    f=$(basename "$1")
    [ -f "$f" ] || wget -O "$f" "$1" || curl -o "$f" "$1"
}

fetch "ftp://ftp.ensembl.org/pub/release-84/fasta/rattus_norvegicus/dna/Rattus_norvegicus.Rnor_6.0.dna.toplevel.fa.gz"
fetch "ftp://ftp.ensembl.org/pub/release-84/gtf/rattus_norvegicus/Rattus_norvegicus.Rnor_6.0.84.gtf.gz"

rm -f genome.fa
gzip -cd Rattus_norvegicus.Rnor_6.0.dna.toplevel.fa.gz >> genome.fa
gzip -cd Rattus_norvegicus.Rnor_6.0.84.gtf.gz > genome.gtf
python -m hisat2_tpu extract-splice-sites genome.gtf > genome.ss
python -m hisat2_tpu extract-exons genome.gtf > genome.exon
python -m hisat2_tpu build genome.fa genome_tran --ss genome.ss --exon genome.exon
echo "genome_tran index built"
