#!/bin/sh
# GRCh38 + dbSNP (common) + Ensembl GTF -> SNP/transcript graph index
# (counterpart of HISAT2's scripts/make_grch38_snp_tran.sh).
ENSEMBL_RELEASE=84
BASE=ftp://ftp.ensembl.org/pub/release-${ENSEMBL_RELEASE}
UCSC=http://hgdownload.soe.ucsc.edu/goldenPath/hg38/database
set -e
[ -f genome.fa ] || { (wget -O genome.fa.gz \
    ${BASE}/fasta/homo_sapiens/dna/Homo_sapiens.GRCh38.dna.primary_assembly.fa.gz \
    || curl -o genome.fa.gz \
    ${BASE}/fasta/homo_sapiens/dna/Homo_sapiens.GRCh38.dna.primary_assembly.fa.gz) \
    && gunzip genome.fa.gz; }
[ -f genome.gtf ] || { (wget -O genome.gtf.gz \
    ${BASE}/gtf/homo_sapiens/Homo_sapiens.GRCh38.${ENSEMBL_RELEASE}.gtf.gz \
    || curl -o genome.gtf.gz \
    ${BASE}/gtf/homo_sapiens/Homo_sapiens.GRCh38.${ENSEMBL_RELEASE}.gtf.gz) \
    && gunzip genome.gtf.gz; }
[ -f snp144Common.txt ] || { (wget -O snp144Common.txt.gz \
    ${UCSC}/snp144Common.txt.gz \
    || curl -o snp144Common.txt.gz ${UCSC}/snp144Common.txt.gz) \
    && gunzip snp144Common.txt.gz; }
python -m hisat2_tpu extract-splice-sites genome.gtf > genome.ss
python -m hisat2_tpu extract-exons genome.gtf > genome.exon
python -m hisat2_tpu extract-snps-haplotypes-ucsc genome.fa \
    snp144Common.txt genome
python -m hisat2_tpu build genome.fa genome_snp_tran \
    --snp genome.snp --haplotype genome.haplotype \
    --ss genome.ss --exon genome.exon
