#!/usr/bin/env python3
"""Accuracy + speed harness (equivalent of HISAT2's
evaluation/{simulation,real}/calculate_read_cost.py).

Given a truth SAM (from `python -m hisat2_tpu simulate-reads`) and one or
more aligner outputs, reports per-aligner:
  - wall time (with --run),
  - read-level accuracy, split by read class like the reference harness
    (reference: extract_single/extract_pair + is_junction_read,
    calculate_read_cost.py:173-709): ungapped (M-only CIGAR), junction
    (CIGAR contains N), gapped (I/D, no N),
  - pair-level accuracy (both mates of a pair correct — the reference's
    paired classification),
  - junction-level precision/recall vs the truth SAM's junction set
    (get_junctions over CIGARs, reference :173-217).

A read is CORRECT when its primary alignment's (ref, pos) matches the
truth within --slack bases; a junction matches exactly (chr, left,
right), like to_junction_str equality in the reference.

Usage:
  calculate_read_cost.py --truth truth.sam out1.sam [out2.sam ...]
  calculate_read_cost.py --run "-x idx -f -U reads.fa" --truth truth.sam
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time

_CIG = re.compile(r"(\d+)([MIDNSHP=X])")


def cigar_junctions(chrom, pos, cigar):
    """(chr, last-exonic-left, first-exonic-right) per N op — the
    reference's get_junctions (calculate_read_cost.py:173-217)."""
    out = []
    right = pos
    for n, op in _CIG.findall(cigar):
        n = int(n)
        if op in "M=XD":
            right += n
        elif op == "N":
            out.append((chrom, right - 1, right + n))
            right += n
    return out


def read_class(cigar):
    ops = {op for _, op in _CIG.findall(cigar)}
    if "N" in ops:
        return "junction"
    if ops & {"I", "D"}:
        return "gapped"
    return "ungapped"


def parse_sam(path):
    """{(name, mate): (chr, pos, cigar)} for primary alignments; None for
    unaligned records."""
    pos = {}
    for line in open(path):
        if line.startswith("@"):
            continue
        f = line.rstrip("\n").split("\t")
        flag = int(f[1])
        mate = 2 if (flag & 0xC0) == 0x80 else 1
        if flag & 0x104:        # secondary or unmapped
            if flag & 0x4:
                pos.setdefault((f[0], mate), None)
            continue
        pos[(f[0], mate)] = (f[2], int(f[3]), f[5])
    return pos


def score(truth, got, slack):
    classes = {}
    pair_ok = {}
    junc_true = set()
    junc_got = set()
    n = aligned = correct = 0
    for k, tp in truth.items():
        if tp is None:
            continue
        n += 1
        cls = read_class(tp[2])
        cstat = classes.setdefault(cls, [0, 0, 0])   # n, aligned, correct
        cstat[0] += 1
        junc_true.update(cigar_junctions(*tp))
        gp = got.get(k)
        name, mate = k
        if gp is None:
            pair_ok.setdefault(name, True)
            pair_ok[name] = False
            continue
        aligned += 1
        cstat[1] += 1
        junc_got.update(cigar_junctions(*gp))
        ok = gp[0] == tp[0] and abs(gp[1] - tp[1]) <= slack
        correct += int(ok)
        cstat[2] += int(ok)
        pair_ok.setdefault(name, True)
        pair_ok[name] &= ok
    jt, jg = len(junc_true), len(junc_got)
    jtp = len(junc_true & junc_got)
    pairs = [v for v in pair_ok.values()]
    return dict(n=n, aligned=aligned, correct=correct, classes=classes,
                pairs=len(pairs), pairs_ok=sum(pairs),
                junc_truth=jt, junc_found=jg, junc_tp=jtp)


def report(sam, s):
    pct = lambda a, b: f"{100.0 * a / max(b, 1):.2f}%"  # noqa: E731
    print(f"{sam}:")
    print(f"  reads {s['n']}, aligned {s['aligned']} "
          f"({pct(s['aligned'], s['n'])}), correct {s['correct']} "
          f"({pct(s['correct'], s['n'])} of all, "
          f"{pct(s['correct'], s['aligned'])} of aligned)")
    for cls in ("ungapped", "gapped", "junction"):
        if cls not in s["classes"]:
            continue
        cn, ca, cc = s["classes"][cls]
        print(f"  {cls:9s}: {cn} reads, aligned {ca} ({pct(ca, cn)}), "
              f"correct {cc} ({pct(cc, cn)})")
    if s["pairs"] and s["pairs"] != s["n"]:
        print(f"  pairs    : {s['pairs']}, both-mates-correct "
              f"{s['pairs_ok']} ({pct(s['pairs_ok'], s['pairs'])})")
    if s["junc_truth"]:
        prec = pct(s["junc_tp"], s["junc_found"])
        rec = pct(s["junc_tp"], s["junc_truth"])
        print(f"  junctions: truth {s['junc_truth']}, found "
              f"{s['junc_found']}, TP {s['junc_tp']} "
              f"(precision {prec}, recall {rec})")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--truth", required=True, help="ground-truth SAM")
    ap.add_argument("--slack", type=int, default=5,
                    help="positional tolerance (bp)")
    ap.add_argument("--run", default=None,
                    help="hisat2-tpu align args to run and time first")
    ap.add_argument("sams", nargs="*", help="aligner SAM outputs to score")
    ap.add_argument("--ref-protocol", action="store_true",
                    help="score with the reference harness's exact "
                         "comparison semantics and column format")
    ap.add_argument("--genome", default=None,
                    help="genome FASTA (--ref-protocol canonical check)")
    ap.add_argument("--ss", default=None,
                    help="known splice sites (--ref-protocol GTF set)")
    args = ap.parse_args()
    if args.ref_protocol:
        return rp_main(args)
    truth = parse_sam(args.truth)
    sams = list(args.sams)
    if args.run:
        out = "eval_run.sam"
        t0 = time.time()
        subprocess.run([sys.executable, "-m", "hisat2_tpu", "align"]
                       + args.run.split() + ["-S", out], check=True)
        print(f"[run] {time.time() - t0:.1f}s -> {out}")
        sams.append(out)
    for sam in sams:
        report(sam, score(truth, parse_sam(sam), args.slack))





# ---------------------------------------------------------------------------
# Reference-protocol scoring: exact re-implementation of the reference
# harness's comparison semantics and output columns
# (/root/reference/evaluation/simulation/calculate_read_cost.py:
# get_junctions:173-217, find_in_gtf_junctions:714-756,
# compare_single_sam:757-948, compare_paired_sam:950-1162, stdout
# header :1879).  Invoked with --ref-protocol; the default mode above
# keeps this repo's per-class breakdown.

def _rp_junctions(chrom, pos, cigar, read_len=100):
    """get_junctions: N ops -> [chr, left, right] with the I/D
    neighbor-shift quirks replicated."""
    cigs = [(int(n), op) for n, op in _CIG.findall(cigar)]
    out = []
    right_pos = pos
    for i, (length, op) in enumerate(cigs):
        if op == "N":
            left, right = right_pos - 1, right_pos + length
            if i > 0 and cigs[i - 1][1] in "ID":
                if cigs[i - 1][1] == "I":
                    left += cigs[i - 1][0]
                else:
                    left -= cigs[i - 1][0]
            if i + 1 < len(cigs) and cigs[i + 1][1] in "ID":
                if cigs[i + 1][1] == "I":
                    right -= cigs[i + 1][0]
                else:
                    right += cigs[i + 1][0]
            out.append((chrom, left, right))
        if op in "MND":
            right_pos += length
    return out


def _rp_right(pos, cigar):
    r = pos
    for n, op in _CIG.findall(cigar):
        if op in "MDN":
            r += int(n)
    return r


def _rp_ops(cigar):
    return "".join(op for _n, op in _CIG.findall(cigar))


def _rp_canonical(chr_dic, junc):
    chrom, left, right = junc
    seq = chr_dic.get(chrom)
    if seq is None:
        return False
    donor = seq[left:left + 2]
    acceptor = seq[right - 3:right - 1]
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    rc = lambda s: "".join(comp.get(c, "N") for c in reversed(s))  # noqa
    return (donor == "GT" and acceptor == "AG") or \
        (rc(acceptor) == "GT" and rc(donor) == "AG")


def _rp_find_gtf(chr_dic, gtf_junctions, junc, relax=5):
    """find_in_gtf_junctions: bsearch + relax window with the
    canonical-exactness rule."""
    import bisect
    chrom, left, right = junc
    lo = bisect.bisect_left(gtf_junctions,
                            (chrom, left - relax, right - relax))
    i = lo
    while i < len(gtf_junctions):
        c2, l2, r2 = gtf_junctions[i]
        if c2 > chrom or l2 - left > relax or r2 - right > relax:
            break
        if abs(left - l2) <= relax and left - l2 == right - r2:
            if _rp_canonical(chr_dic, gtf_junctions[i]):
                return i if left == l2 else -1
            return i
        i += 1
    return -1


def _rp_temp_junctions(db_junctions, chr_dic, gtf_junctions,
                       gtf_set, min_support=0):
    """The aligner-reported junction set with GTF snapping and the
    <=10 bp shifted-novel dedup (compare_*_sam mid-section)."""
    temp, temp_gtf = set(), set()
    support = {}
    for _read, juncs in db_junctions.items():
        for junc in juncs:
            support[junc] = support.get(junc, 0) + 1
    for _read, juncs in db_junctions.items():
        for junc in juncs:
            if min_support and support.get(junc, 0) <= min_support:
                continue
            found = junc if junc in gtf_set else None
            if found is None:
                gi = _rp_find_gtf(chr_dic, gtf_junctions, junc)
                if gi >= 0:
                    found = gtf_junctions[gi]
            if found is not None:
                temp_gtf.add(found)
                temp.add(found)
            else:
                temp.add(junc)
    orderd = sorted(temp)
    dedup = []
    for j in orderd:
        if dedup:
            c, l, r = dedup[-1]
            c2, l2, r2 = j
            if c == c2 and abs(l - l2) == abs(r - r2) \
                    and abs(l - l2) <= 10 and j not in temp_gtf:
                continue
        dedup.append(j)
    return set(dedup), temp_gtf


def rp_compare_single(aligner_recs, truth_recs, chr_dic,
                      gtf_junctions, gtf_set):
    """compare_single_sam semantics.  aligner_recs: {read: [(chr, pos,
    cigar)]} (all reported alignments incl. secondary); truth_recs:
    {read: [(chr, pos, cigar)]}.  Returns (mapped, unique_mapped,
    unmapped, aligned, multi_aligned, n_temp_junctions,
    n_temp_gtf_junctions, mapping_point)."""
    db = {}
    db_j = {}
    aligned = multi = 0
    for read, recs in aligner_recs.items():
        for chrom, pos, cigar in recs:
            multi += 1
            if read not in db:
                db[read] = []
                aligned += 1
            db[read].append((chrom, pos, _rp_right(pos, cigar), cigar))
            js = _rp_junctions(chrom, pos, cigar)
            if js:
                db_j.setdefault(read, []).extend(js)
    temp, temp_gtf = _rp_temp_junctions(db_j, chr_dic, gtf_junctions,
                                        gtf_set)
    mapped = unique = unmapped = 0
    point = 0.0
    for read, recs in truth_recs.items():
        for chrom, pos, cigar in recs:
            maps = db.get(read)
            if not maps:
                unmapped += 1
                continue
            pr = _rp_right(pos, cigar)
            found = (chrom, pos, pr, cigar) in maps
            if not found:
                for mc, mp, mpr, mcig in maps:
                    if chrom == mc and pos == mp and pr == mpr \
                            and _rp_ops(cigar) == _rp_ops(mcig):
                        js = _rp_junctions(mc, mp, mcig)
                        found = all(
                            _rp_find_gtf(chr_dic, gtf_junctions, j) >= 0
                            for j in js)
                        break
            if found:
                mapped += 1
                if len(maps) == 1:
                    unique += 1
                point += 1.0 / len(maps)
            else:
                unmapped += 1
    return (mapped, unique, unmapped, aligned, multi, len(temp),
            len(temp_gtf), point)


def rp_compare_paired(aligner_recs, truth_recs, chr_dic,
                      gtf_junctions, gtf_set):
    """compare_paired_sam semantics: records are ((chr, pos, cigar),
    (pos2, cigar2)) mate pairs; junction support <= 5 pairs filtered
    (reference :1022-1024)."""
    db = {}
    db_j = {}
    aligned = multi = 0
    for read, recs in aligner_recs.items():
        for (chrom, pos, cigar, pos2, cigar2) in recs:
            multi += 1
            if read not in db:
                db[read] = []
                aligned += 1
            db[read].append((chrom, pos, _rp_right(pos, cigar), cigar,
                             pos2, _rp_right(pos2, cigar2), cigar2))
            js = _rp_junctions(chrom, pos, cigar) \
                + _rp_junctions(chrom, pos2, cigar2)
            if js:
                db_j.setdefault(read, []).extend(js)
    temp, temp_gtf = _rp_temp_junctions(db_j, chr_dic, gtf_junctions,
                                        gtf_set, min_support=5)
    mapped = unique = unmapped = 0
    point = 0.0
    for read, recs in truth_recs.items():
        for (chrom, pos, cigar, pos2, cigar2) in recs:
            maps = db.get(read)
            if not maps:
                unmapped += 1
                continue
            pr, pr2 = _rp_right(pos, cigar), _rp_right(pos2, cigar2)
            key = (chrom, pos, pr, cigar, pos2, pr2, cigar2)
            found = key in maps
            if not found:
                for m in maps:
                    if chrom == m[0] and pos == m[1] and pr == m[2] \
                            and _rp_ops(cigar) == _rp_ops(m[3]) \
                            and pos2 == m[4] and pr2 == m[5] \
                            and _rp_ops(cigar2) == _rp_ops(m[6]):
                        js = _rp_junctions(m[0], m[1], m[3]) \
                            + _rp_junctions(m[0], m[4], m[6])
                        found = all(
                            _rp_find_gtf(chr_dic, gtf_junctions, j) >= 0
                            for j in js)
                        break
            if found:
                mapped += 1
                if len(maps) == 1:
                    unique += 1
                point += 1.0 / len(maps)
            else:
                unmapped += 1
    return (mapped, unique, unmapped, aligned, multi, len(temp),
            len(temp_gtf), point)


def rp_header():
    """The reference harness's stdout column header (line 1879)."""
    return "\t".join(["type", "aligner", "all", "all_time", "mapped",
                      "unique_mapped", "unmapped", "mapping point",
                      "true_gtf_junctions", "temp_junctions",
                      "temp_gtf_junctions"])


def _rp_load_sam_single(path):
    """SAM -> {read: [(chr, pos, cigar)]}, mapped records only
    (primary + secondary), read names normalized like extract_single."""
    recs = {}
    for line in open(path):
        if line.startswith("@"):
            continue
        f = line.rstrip("\n").split("\t")
        flag = int(f[1])
        if flag & 0x4:
            continue
        name = f[0]
        if name.startswith("seq."):
            name = name[4:]
        if len(name) > 2 and name[-2] == "/":
            name = name[:-2]
        recs.setdefault(name, []).append((f[2], int(f[3]), f[5]))
    return recs


def rp_main(args):
    chr_dic = {}
    if args.genome:
        name = None
        for line in open(args.genome):
            if line.startswith(">"):
                name = line[1:].split()[0]
                chr_dic[name] = []
            else:
                chr_dic[name].append(line.strip())
        chr_dic = {k: "".join(v) for k, v in chr_dic.items()}
    gtf_junctions = []
    if args.ss:
        for line in open(args.ss):
            c, l, r, _s = line.split()
            # .ss uses exonic bounds; the protocol's junctions are
            # (last-exonic-left, first-exonic-right) 1-based
            gtf_junctions.append((c, int(l) + 1, int(r) + 1))
    gtf_junctions.sort()
    gtf_set = set(gtf_junctions)
    truth = _rp_load_sam_single(args.truth)
    print(rp_header())
    for sam in args.sams:
        got = _rp_load_sam_single(sam)
        (mapped, unique, unmapped, _aligned, _multi, temp, temp_gtf,
         point) = rp_compare_single(got, truth, chr_dic, gtf_junctions,
                                    gtf_set)
        n = sum(len(v) for v in truth.values())
        print("\t".join(str(x) for x in (
            "all", sam, n, f"{getattr(args, 'time', 0.0):.1f}",
            mapped, unique, unmapped, f"{point:.2f}",
            len(gtf_junctions), temp, temp_gtf)))


if __name__ == "__main__":
    main()
