#!/bin/sh
# Downloads E. coli K-12 MG1655 and builds a linear hisat2-tpu index
# (counterpart of HISAT2's scripts/make_e_coli.sh).
GENOME_URL=ftp://ftp.ncbi.nlm.nih.gov/genomes/all/GCA/000/005/845/GCA_000005845.2_ASM584v2/GCA_000005845.2_ASM584v2_genomic.fna.gz
F=e_coli.fa
if [ ! -f "$F" ]; then
    (wget -O ${F}.gz "$GENOME_URL" || curl -o ${F}.gz "$GENOME_URL") \
        && gunzip ${F}.gz
fi
[ -f "$F" ] || { echo "Error: could not fetch $F"; exit 1; }
python -m hisat2_tpu build "$F" e_coli
