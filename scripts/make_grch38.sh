#!/bin/sh
# Downloads GRCh38 (Ensembl release 84) and builds a linear index
# (counterpart of HISAT2's scripts/make_grch38.sh).
ENSEMBL_RELEASE=84
BASE=ftp://ftp.ensembl.org/pub/release-${ENSEMBL_RELEASE}/fasta/homo_sapiens/dna
F=genome.fa
if [ ! -f "$F" ]; then
    (wget -O ${F}.gz ${BASE}/Homo_sapiens.GRCh38.dna.primary_assembly.fa.gz \
        || curl -o ${F}.gz ${BASE}/Homo_sapiens.GRCh38.dna.primary_assembly.fa.gz) \
        && gunzip ${F}.gz
fi
[ -f "$F" ] || { echo "Error: could not fetch $F"; exit 1; }
python -m hisat2_tpu build "$F" genome
