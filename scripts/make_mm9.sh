#!/bin/sh
# mm9: download + build recipe (counterpart of
# HISAT2's scripts/make_mm9.sh — same data sources, our builder).
# Requires network access; run in an empty working directory.
set -e
fetch() {
    f=$(basename "$1")
    [ -f "$f" ] || wget -O "$f" "$1" || curl -o "$f" "$1"
}

fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/mm9/chromosomes/chr1.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/mm9/chromosomes/chr2.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/mm9/chromosomes/chr3.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/mm9/chromosomes/chr4.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/mm9/chromosomes/chr5.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/mm9/chromosomes/chr6.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/mm9/chromosomes/chr7.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/mm9/chromosomes/chr8.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/mm9/chromosomes/chr9.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/mm9/chromosomes/chr10.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/mm9/chromosomes/chr11.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/mm9/chromosomes/chr12.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/mm9/chromosomes/chr13.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/mm9/chromosomes/chr14.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/mm9/chromosomes/chr15.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/mm9/chromosomes/chr16.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/mm9/chromosomes/chr17.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/mm9/chromosomes/chr18.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/mm9/chromosomes/chr19.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/mm9/chromosomes/chrX.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/mm9/chromosomes/chrY.fa.gz"
fetch "ftp://hgdownload.cse.ucsc.edu/goldenPath/mm9/chromosomes/chrM.fa.gz"

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
gzip -cd chrX.fa.gz >> genome.fa
gzip -cd chrY.fa.gz >> genome.fa
gzip -cd chrM.fa.gz >> genome.fa
python -m hisat2_tpu build genome.fa genome 
echo "genome index built"
