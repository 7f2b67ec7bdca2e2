#!/bin/sh
# canFam2: download + build recipe (counterpart of
# HISAT2's scripts/make_canFam2.sh — same data sources, our builder).
# Requires network access; run in an empty working directory.
set -e
fetch() {
    f=$(basename "$1")
    [ -f "$f" ] || wget -O "$f" "$1" || curl -o "$f" "$1"
}

fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr1.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr2.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr3.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr4.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr5.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr6.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr7.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr8.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr9.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr10.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr11.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr12.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr13.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr14.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr15.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr16.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr17.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr18.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr19.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr20.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr21.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr22.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr23.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr24.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr25.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr26.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr27.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr28.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr29.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr30.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr31.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr32.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr33.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr34.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr35.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr36.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr37.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chr38.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chrX.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chrM.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/canFam2/chromosomes/chrUn.fa.gz"

rm -f genome.fa
gzip -cd chr1.fa.gz >> genome.fa
gzip -cd chr2.fa.gz >> genome.fa
gzip -cd chr3.fa.gz >> genome.fa
gzip -cd chr4.fa.gz >> genome.fa
gzip -cd chr5.fa.gz >> genome.fa
gzip -cd chr6.fa.gz >> genome.fa
gzip -cd chr7.fa.gz >> genome.fa
gzip -cd chr8.fa.gz >> genome.fa
gzip -cd chr9.fa.gz >> genome.fa
gzip -cd chr10.fa.gz >> genome.fa
gzip -cd chr11.fa.gz >> genome.fa
gzip -cd chr12.fa.gz >> genome.fa
gzip -cd chr13.fa.gz >> genome.fa
gzip -cd chr14.fa.gz >> genome.fa
gzip -cd chr15.fa.gz >> genome.fa
gzip -cd chr16.fa.gz >> genome.fa
gzip -cd chr17.fa.gz >> genome.fa
gzip -cd chr18.fa.gz >> genome.fa
gzip -cd chr19.fa.gz >> genome.fa
gzip -cd chr20.fa.gz >> genome.fa
gzip -cd chr21.fa.gz >> genome.fa
gzip -cd chr22.fa.gz >> genome.fa
gzip -cd chr23.fa.gz >> genome.fa
gzip -cd chr24.fa.gz >> genome.fa
gzip -cd chr25.fa.gz >> genome.fa
gzip -cd chr26.fa.gz >> genome.fa
gzip -cd chr27.fa.gz >> genome.fa
gzip -cd chr28.fa.gz >> genome.fa
gzip -cd chr29.fa.gz >> genome.fa
gzip -cd chr30.fa.gz >> genome.fa
gzip -cd chr31.fa.gz >> genome.fa
gzip -cd chr32.fa.gz >> genome.fa
gzip -cd chr33.fa.gz >> genome.fa
gzip -cd chr34.fa.gz >> genome.fa
gzip -cd chr35.fa.gz >> genome.fa
gzip -cd chr36.fa.gz >> genome.fa
gzip -cd chr37.fa.gz >> genome.fa
gzip -cd chr38.fa.gz >> genome.fa
gzip -cd chrX.fa.gz >> genome.fa
gzip -cd chrM.fa.gz >> genome.fa
gzip -cd chrUn.fa.gz >> genome.fa
python -m hisat2_tpu build genome.fa genome 
echo "genome index built"
