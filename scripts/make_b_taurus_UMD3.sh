#!/bin/sh
# b_taurus_UMD3: download + build recipe (counterpart of
# HISAT2's scripts/make_b_taurus_UMD3.sh — same data sources, our builder).
# Requires network access; run in an empty working directory.
set -e
fetch() {
    f=$(basename "$1")
    [ -f "$f" ] || wget -O "$f" "$1" || curl -o "$f" "$1"
}

fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr1.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr2.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr3.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr4.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr5.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr6.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr7.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr8.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr9.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr10.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr11.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr12.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr13.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr14.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr15.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr16.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr17.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr18.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr19.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr20.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr21.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr22.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr23.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr24.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr25.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr26.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr27.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr28.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/Chr29.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/ChrX.fa.gz"
fetch "ftp://ftp.cbcb.umd.edu/pub/data/Bos_taurus/Bos_taurus_UMD_3.0/ChrU.fa.gz"

rm -f genome.fa
gzip -cd Chr1.fa.gz >> genome.fa
gzip -cd Chr2.fa.gz >> genome.fa
gzip -cd Chr3.fa.gz >> genome.fa
gzip -cd Chr4.fa.gz >> genome.fa
gzip -cd Chr5.fa.gz >> genome.fa
gzip -cd Chr6.fa.gz >> genome.fa
gzip -cd Chr7.fa.gz >> genome.fa
gzip -cd Chr8.fa.gz >> genome.fa
gzip -cd Chr9.fa.gz >> genome.fa
gzip -cd Chr10.fa.gz >> genome.fa
gzip -cd Chr11.fa.gz >> genome.fa
gzip -cd Chr12.fa.gz >> genome.fa
gzip -cd Chr13.fa.gz >> genome.fa
gzip -cd Chr14.fa.gz >> genome.fa
gzip -cd Chr15.fa.gz >> genome.fa
gzip -cd Chr16.fa.gz >> genome.fa
gzip -cd Chr17.fa.gz >> genome.fa
gzip -cd Chr18.fa.gz >> genome.fa
gzip -cd Chr19.fa.gz >> genome.fa
gzip -cd Chr20.fa.gz >> genome.fa
gzip -cd Chr21.fa.gz >> genome.fa
gzip -cd Chr22.fa.gz >> genome.fa
gzip -cd Chr23.fa.gz >> genome.fa
gzip -cd Chr24.fa.gz >> genome.fa
gzip -cd Chr25.fa.gz >> genome.fa
gzip -cd Chr26.fa.gz >> genome.fa
gzip -cd Chr27.fa.gz >> genome.fa
gzip -cd Chr28.fa.gz >> genome.fa
gzip -cd Chr29.fa.gz >> genome.fa
gzip -cd ChrX.fa.gz >> genome.fa
gzip -cd ChrU.fa.gz >> genome.fa
python -m hisat2_tpu build genome.fa genome 
echo "genome index built"
