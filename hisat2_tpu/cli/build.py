"""hisat2-tpu-build: index construction CLI.

Mirrors the essential surface of hisat2-build
(/root/reference/hisat2_build.cpp:146-244): FASTA in, index out, with
--offrate / --ftabchars geometry knobs.  (SNP/splice-site/exon inputs are
consumed by the graph layer; see index/graph.py.)
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="hisat2-tpu-build",
        description="Build an FM index from FASTA")
    p.add_argument("fasta", help="comma-separated FASTA file(s)")
    p.add_argument("base", help="output index basename (.npz)")
    p.add_argument("-o", "--offrate", type=int, default=None,
                   help="SA sample rate: mark every 2^<int> text positions")
    p.add_argument("-t", "--ftabchars", type=int, default=10,
                   help="# chars consumed by the ftab jumpstart")
    p.add_argument("--snp", default=None, help="SNP file (hisat2 .snp format)")
    p.add_argument("--haplotype", default=None, help="haplotype file")
    p.add_argument("--ss", default=None, help="splice-site file (.ss)")
    p.add_argument("--exon", default=None, help="exon file (.exon)")
    p.add_argument("-p", "--threads", type=int, default=1,
                   help="accepted for CLI compatibility (build is vectorized)")
    p.add_argument("--shard-bp", type=int, default=None,
                   help="max joined bp per sub-index shard "
                        "(default 1.9G, the int32 bound)")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--passMemExc", dest="pass_mem_exc",
                   action="store_true",
                   help="on out-of-memory, retry with smaller shards "
                        "(gfm.h:1890-1996 --passMemExc semantics)")
    p.add_argument("--export-ht2", action="store_true",
                   help="ALSO write <base>.{1..8}.ht2 byte-compatible "
                        "with hisat2-build-s (linear/no-ALT only), so "
                        "the reference aligner can use this build")
    args = p.parse_args(argv)

    from ..index.builder import build_fm_index
    from ..io.fasta import iter_fasta

    t0 = time.time()
    seqs = []
    for path in args.fasta.split(","):
        seqs.extend(iter_fasta(path))
    if not args.quiet:
        tot = sum(len(c) for _, c in seqs)
        print(f"[build] {len(seqs)} sequence(s), {tot} bp", file=sys.stderr)
    shard_bp = args.shard_bp
    while True:
        try:
            idx = build_fm_index(seqs, off_rate=args.offrate,
                                 ftab_k=args.ftabchars,
                                 shard_bp=shard_bp)
            break
        except MemoryError:
            # --passMemExc: the reference auto-retries its blockwise SA
            # with a smaller memory budget (gfm.h:1890-1996); here the
            # budget knob is the shard size
            if not args.pass_mem_exc:
                raise
            from ..index.builder import SHARD_LIMIT_BP
            shard_bp = (shard_bp or SHARD_LIMIT_BP) // 2
            if shard_bp < 1_000_000:
                raise
            print(f"[build] out of memory; retrying with "
                  f"{shard_bp} bp shards (--passMemExc)",
                  file=sys.stderr)
    if args.snp or args.ss or args.exon or args.haplotype:
        from ..index.variants import attach_variants
        idx = attach_variants(idx, snp_file=args.snp,
                              haplotype_file=args.haplotype,
                              ss_file=args.ss, exon_file=args.exon)
        idx._variants.save(args.base)
    idx.save(args.base)
    if args.export_ht2:
        if args.snp or args.ss or args.exon or args.haplotype:
            # graph export: GBWT construction (index/gbwt.py) + graph
            # side serialization, byte-compatible with
            # `hisat2-build-s --snp/--ss/--exon/--haplotype`
            from ..index.ht2_write import (export_ht2_graph,
                                           parse_alt_files)
            alts, altnames, haps = parse_alt_files(
                seqs, snp_file=args.snp, ss_file=args.ss,
                exon_file=args.exon, haplotype_file=args.haplotype)
            export_ht2_graph(seqs, alts, altnames, haps, args.base)
        else:
            from ..index.ht2_write import export_ht2
            export_ht2(seqs, args.base)
            if not args.quiet:
                print(f"[build] wrote {args.base}.1-8.ht2 "
                      f"(hisat2-build-s byte-compatible)", file=sys.stderr)
    if not args.quiet:
        print(f"[build] wrote {args.base}.npz in {time.time() - t0:.1f}s",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
