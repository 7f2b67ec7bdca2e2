#!/bin/sh
# zm3_snp_tran_ercc: download + build recipe (counterpart of
# HISAT2's scripts/make_zm3_snp_tran_ercc.sh — same data sources, our builder).
# Requires network access; run in an empty working directory.
set -e
fetch() {
    f=$(basename "$1")
    [ -f "$f" ] || wget -O "$f" "$1" || curl -o "$f" "$1"
}

fetch "ftp://ftp.ensemblgenomes.org/pub/plants/release-31/fasta/zea_mays/dna//Zea_mays.AGPv3.31.dna.genome.fa.gz"
fetch "https://tools.thermofisher.com/content/sfs/manuals/ERCC92.zip"
fetch "ftp://ftp.ensemblgenomes.org/pub/plants/release-31/gtf/zea_mays//Zea_mays.AGPv3.31.gtf.gz"
fetch "ftp://ftp.ensemblgenomes.org/pub/plants/release-31/vcf/zea_mays//zea_mays.vcf.gz"

rm -f genome.fa
gzip -cd Zea_mays.AGPv3.31.dna.genome.fa.gz >> genome.fa
gzip -cd zea_mays.vcf.gz >> genome.fa
unzip -o ERCC92.zip 2>/dev/null || true
cat ERCC92.fa >> genome.fa 2>/dev/null || true
gzip -cd Zea_mays.AGPv3.31.gtf.gz > genome.gtf
python -m hisat2_tpu extract-splice-sites genome.gtf > genome.ss
python -m hisat2_tpu extract-exons genome.gtf > genome.exon
python -m hisat2_tpu build genome.fa genome_tran --ss genome.ss --exon genome.exon
echo "genome_tran index built"
