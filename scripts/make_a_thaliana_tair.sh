#!/bin/sh
# a_thaliana_tair: download + build recipe (counterpart of
# HISAT2's scripts/make_a_thaliana_tair.sh — same data sources, our builder).
# Requires network access; run in an empty working directory.
set -e
fetch() {
    f=$(basename "$1")
    [ -f "$f" ] || wget -O "$f" "$1" || curl -o "$f" "$1"
}

fetch "ftp://ftp.arabidopsis.org/home/tair/Sequences/whole_chromosomes/TAIR10_chr1.fas"
fetch "ftp://ftp.arabidopsis.org/home/tair/Sequences/whole_chromosomes/TAIR10_chr2.fas"
fetch "ftp://ftp.arabidopsis.org/home/tair/Sequences/whole_chromosomes/TAIR10_chr3.fas"
fetch "ftp://ftp.arabidopsis.org/home/tair/Sequences/whole_chromosomes/TAIR10_chr4.fas"
fetch "ftp://ftp.arabidopsis.org/home/tair/Sequences/whole_chromosomes/TAIR10_chr5.fas"
fetch "ftp://ftp.arabidopsis.org/home/tair/Sequences/whole_chromosomes/TAIR10_chrM.fas"
fetch "ftp://ftp.arabidopsis.org/home/tair/Sequences/whole_chromosomes/TAIR10_chrC.fas"

rm -f genome.fa
cat TAIR10_chr1.fas >> genome.fa
cat TAIR10_chr2.fas >> genome.fa
cat TAIR10_chr3.fas >> genome.fa
cat TAIR10_chr4.fas >> genome.fa
cat TAIR10_chr5.fas >> genome.fa
cat TAIR10_chrM.fas >> genome.fa
cat TAIR10_chrC.fas >> genome.fa
python -m hisat2_tpu build genome.fa genome 
echo "genome index built"
