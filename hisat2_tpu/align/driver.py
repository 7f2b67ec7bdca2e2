"""Host alignment driver: stream read batches through the device aligner and
emit SAM (reference: driver() + multiseedSearch(), hisat2.cpp:3581-3984,
reshaped batch-synchronous).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np

from ..index.format import FMIndex
from ..io import demux
from ..io.fasta import (batch_stream, iter_cmdline, iter_tabbed,
                        read_batches)
from ..io.sam import SamWriter
from . import mapq as mapq_mod
from . import rng as rng_mod
from . import pipeline as pipeline_mod
from .paired import PairPolicy, best_pairs
from .pipeline import TPUAligner
from .scoring import Scoring, SimpleFunc


def make_scoring(args) -> Scoring:
    mp_max, mp_min = (int(x) for x in args.mp.split(","))
    sp_max, sp_min = (int(x) for x in args.sp.split(","))
    rdg_o, rdg_e = (int(x) for x in args.rdg.split(","))
    rfg_o, rfg_e = (int(x) for x in args.rfg.split(","))
    dta = getattr(args, "dta", False)
    canlen = getattr(args, "pen_canintronlen", None)
    nclen = getattr(args, "pen_noncanintronlen", None)
    return Scoring(mm_max=mp_max, mm_min=mp_min, n_pen=args.npen,
                   sp_max=sp_max, sp_min=sp_min,
                   rd_gap_open=rdg_o, rd_gap_ext=rdg_e,
                   rf_gap_open=rfg_o, rf_gap_ext=rfg_e,
                   no_softclip=args.no_softclip,
                   score_min=SimpleFunc.parse(args.score_min),
                   n_ceil=SimpleFunc.parse(args.n_ceil),
                   ignore_quals=args.ignore_quals,
                   pen_can_splice=args.pen_cansplice,
                   pen_noncan_splice=args.pen_noncansplice,
                   pen_conflict_splice=getattr(args, "pen_conflictsplice",
                                               1_000_000),
                   pen_can_intron_len=(SimpleFunc.parse(canlen)
                                       if canlen else
                                       SimpleFunc("G", -8.0, 1.0)),
                   pen_noncan_intron_len=(
                       SimpleFunc.parse(nclen) if nclen else
                       SimpleFunc("G", -8.0, 2.0) if dta else
                       SimpleFunc("G", -8.0, 1.0)),
                   min_intron_len=args.min_intronlen,
                   max_intron_len=args.max_intronlen,
                   min_anchor=15 if dta else 7,
                   min_anchor_noncan=20 if dta else 14)


def make_aligner(args, index, scoring, variants) -> TPUAligner:
    """The TPUAligner `align` runs for parsed CLI args (sets the -k
    default on args)."""
    if args.khits is None:
        # -k default: 5 on linear, 10 on graph indexes (hisat2.cpp:3701)
        args.khits = 10 if (variants is not None
                            and variants.n_snps) else 5
    return TPUAligner(index, scoring, k=args.khits,
                      no_fw=args.nofw, no_rc=args.norc,
                      variants=variants,
                      spliced=not args.no_spliced_alignment,
                      lane_meta=True,
                      max_seeds=getattr(args, "max_seeds", 0),
                      all_hits=getattr(args, "all_hits", False),
                      tmo=getattr(args, "tmo", False),
                      require_xs=getattr(args, "dta_cufflinks", False),
                      anchor_stop=not getattr(args, "no_anchorstop",
                                              False))


def run_align(args) -> int:
    t0 = time.time()
    if getattr(args, "sra_acc", None):
        print("error: --sra-acc needs NCBI SRA network access, which "
              "this offline build does not have; download FASTQ with "
              "prefetch/fasterq-dump and pass it via -U/-1/-2",
              file=sys.stderr)
        return 1
    if getattr(args, "tab5", None) or getattr(args, "tab6", None):
        # tab5/tab6 are fixed-arity flavors of the --12 tabbed reader
        args.tab12 = args.tab5 or args.tab6
    if getattr(args, "dta_cufflinks", False):
        args.dta = True
    if getattr(args, "non_deterministic", False):
        # the reference reseeds from the clock per read
        # (hisat2.cpp:1046); one clock draw per RUN gives the same
        # user-visible property (output varies run to run)
        args.seed = int(time.time() * 1e6) & 0x7FFFFFFF
    if getattr(args, "local_mode", False):
        print("error: this build implements end-to-end alignment only "
              "(HI_Aligner local mode is not ported); remove --local",
              file=sys.stderr)
        return 1
    if getattr(args, "ma", 0) > 0:
        # hisat2.cpp:3714 — same warning, bonus forced to 0
        print("Warning: Match bonus always = 0 in --end-to-end mode; "
              "ignoring user setting", file=sys.stderr)
        args.ma = 0
    index_base = args.index
    if not os.path.exists(index_base + ".npz"):
        from ..index.ht2 import convert_ht2, is_ht2
        if is_ht2(index_base):
            index_base = convert_ht2(index_base)
    index = FMIndex.load(index_base)
    scoring = make_scoring(args)
    variants = None
    if os.path.exists(index_base + ".var.npz"):
        from ..index.variants import VariantDB
        variants = VariantDB.load(index_base)
    aligner = make_aligner(args, index, scoring, variants)
    if aligner.splice_db is not None:
        if args.known_splicesite_infile:
            aligner.splice_db.add_from_file(args.known_splicesite_infile)
        if args.novel_splicesite_infile:
            aligner.splice_db.add_from_file(args.novel_splicesite_infile)
        # --no-temp-splicesite is accepted for compatibility: with a single
        # worker the reference's mindist is 0 either way (hisat2.cpp:3559),
        # so temp-site usage is identical
    world = getattr(args, "n_hosts", 1) or 1
    rank = getattr(args, "host_rank", 0) or 0
    shard = None
    if world > 1:
        from ..parallel import multihost
        if getattr(args, "coordinator", None):
            multihost.init_distributed(args.coordinator, world, rank)
        if not args.sam:
            print("error: multi-host runs require -S <out.sam>",
                  file=sys.stderr)
            return 1
        shard = multihost.ShardSamWriter(args.sam, rank)
        out = shard
    else:
        out = open(args.sam, "w") if args.sam else sys.stdout
    # --remove-chrname/--add-chrname rewrite @SQ + RNAME (hisat2.cpp:3750)
    disp_names = list(index.meta.ref_names)
    if getattr(args, "remove_chrname", False):
        disp_names = [n[3:] if n.startswith("chr") else n
                      for n in disp_names]
    elif getattr(args, "add_chrname", False):
        disp_names = ["chr" + n if not n.startswith("chr") else n
                      for n in disp_names]
    seed_map = {}
    if getattr(args, "show_rand_seed", False):
        out = _SeedTagOut(out, seed_map)
    writer = SamWriter(out, disp_names, index.meta.ref_lens,
                       cmdline=" ".join(sys.argv[1:]),
                       no_head=args.no_hd or shard is not None,
                       no_sq=getattr(args, "no_sq", False),
                       no_unal=args.no_unal,
                       rg_id=args.rg_id, rg=args.rg,
                       annotator=(aligner.annotate_snps
                                  if variants is not None else None),
                       rna_strandness=args.rna_strandness,
                       omit_sec_seq=getattr(args, "omit_sec_seq", False))
    ref_fn = lambda pos, span: aligner.ref_codes[pos:pos + span]  # noqa: E731
    met = None
    if getattr(args, "met_file", None) or getattr(args, "met_stderr", False) \
            or getattr(args, "met_read", False):
        from .metrics import MetricsSink
        met = MetricsSink(getattr(args, "met_file", None),
                          getattr(args, "met_stderr", False),
                          getattr(args, "met", 1.0),
                          per_read=getattr(args, "met_read", False))
    n_bases = 0

    fmt = ("fastq" if args.fastq else "fasta" if args.fasta else
           "raw" if getattr(args, "raw", False) else
           "qseq" if getattr(args, "qseq", False) else "auto")
    qmode = getattr(args, "qual_mode", "phred33")
    trim5, trim3 = getattr(args, "trim5", 0), getattr(args, "trim3", 0)

    def _first_path():
        src = args.unpaired or args.m1 or getattr(args, "tab12", None)
        return src.split(",")[0] if src else None

    def _fastq_out() -> bool:
        if fmt in ("fastq", "qseq"):
            return True
        if fmt != "auto":
            return False
        p = _first_path()
        if p is None or getattr(args, "cmdline_reads", False):
            return False
        from ..io.fasta import _open
        with _open(p) as f:
            return f.read(1) == b"@"

    def _sink(plain, gz, paired):
        path = plain or (gz if gz is None or gz.endswith(".gz")
                         else gz + ".gz")
        if path is None:
            return None
        cls = demux.PairSink if paired else demux.ReadSink
        return cls(path, _fastq_out())

    sink_un = _sink(getattr(args, "un", None),
                    getattr(args, "un_gz", None), False)
    sink_al = _sink(getattr(args, "al", None),
                    getattr(args, "al_gz", None), False)
    sink_un_conc = _sink(getattr(args, "un_conc", None),
                         getattr(args, "un_conc_gz", None), True)
    sink_al_conc = _sink(getattr(args, "al_conc", None),
                         getattr(args, "al_conc_gz", None), True)

    n_batches = 0
    rdid0 = 0  # global read ids (pat.h rdid assignment; gates temp
    #            splice-site visibility across batches)
    tab12 = getattr(args, "tab12", None)
    tab_paired = False
    if tab12:
        from ..io.fasta import _open
        with _open(tab12.split(",")[0]) as f:
            tab_paired = len(f.readline().rstrip(b"\n").split(b"\t")) >= 5

    def unpaired_batches():
        bs, sk, up = args.batch_size, args.skip, args.upto
        if tab12:
            for path in tab12.split(","):
                yield from batch_stream(iter_tabbed(path, qmode), bs,
                                        skip=sk, limit=up,
                                        trim5=trim5, trim3=trim3)
            return
        if getattr(args, "cmdline_reads", False):
            yield from batch_stream(iter_cmdline(args.unpaired), bs,
                                    skip=sk, limit=up,
                                    trim5=trim5, trim3=trim3)
            return
        for path in args.unpaired.split(","):
            yield from read_batches(path, bs, skip=sk, limit=up, fmt=fmt,
                                    qc_filter=getattr(args, "qc_filter",
                                                      False),
                                    qual_mode=qmode, trim5=trim5,
                                    trim3=trim3)

    def paired_batches():
        from ..io.fasta import ReadBatch
        bs, sk, up = args.batch_size, args.skip, args.upto
        if tab12:
            for path in tab12.split(","):
                n1, c1, q1, n2, c2, q2 = [], [], [], [], [], []
                seen = 0
                for rec in iter_tabbed(path, qmode):
                    if len(rec) < 5:
                        continue
                    if seen < sk:
                        seen += 1
                        continue
                    if up is not None and seen - sk >= up:
                        break
                    seen += 1
                    n1.append(rec[0])
                    c1.append(rec[1])
                    q1.append(rec[2])
                    c2.append(rec[3])
                    q2.append(rec[4])
                    if len(n1) == bs:
                        yield (ReadBatch(n1, c1, q1),
                               ReadBatch(list(n1), c2, q2))
                        n1, c1, q1, c2, q2 = [], [], [], [], []
                if n1:
                    yield (ReadBatch(n1, c1, q1),
                           ReadBatch(list(n1), c2, q2))
            return
        if getattr(args, "cmdline_reads", False):
            it1 = batch_stream(iter_cmdline(args.m1), bs, skip=sk, limit=up,
                               trim5=trim5, trim3=trim3)
            it2 = batch_stream(iter_cmdline(args.m2), bs, skip=sk, limit=up,
                               trim5=trim5, trim3=trim3)
            yield from zip(it1, it2)
            return
        for p1, p2 in zip(args.m1.split(","), args.m2.split(",")):
            it1 = read_batches(p1, bs, skip=sk, limit=up, fmt=fmt,
                               qual_mode=qmode, trim5=trim5, trim3=trim3)
            it2 = read_batches(p2, bs, skip=sk, limit=up, fmt=fmt,
                               qual_mode=qmode, trim5=trim5, trim3=trim3)
            yield from zip(it1, it2)

    paired_mode = (args.m1 and args.m2) or (tab12 and tab_paired)
    if not paired_mode and (args.unpaired or tab12):
        def emit(pend):
            nonlocal n_bases
            res = aligner.collect(pend[0])
            b = pend[1]
            b_rdids = pend[2]
            n_bases += int(b.lens.sum())
            seeds = rng_mod.gen_rand_seeds(b.codes, b.lens, b.quals,
                                           b.names,
                                           seed=getattr(args, "seed", 0))
            if getattr(args, "show_rand_seed", False):
                seed_map.update(zip(b.names, (int(x) for x in seeds)))
            ranks = _replay_unpaired_giveup(aligner, res, b.lens)
            inlen = (np.arange(b.codes.shape[1])[None, :]
                     < b.lens[:, None])
            ncnt = ((b.codes > 3) & inlen).sum(axis=1)
            maxn = np.array([aligner.scoring.max_n(int(l))
                             for l in b.lens])
            # 0 = pass, 1 = YF:Z:NS (N ceiling), 2 = YF:Z:QC (--qc-filter)
            nfv = (ncnt > maxn).astype(np.int8)
            qcf = getattr(b, "qc_fail", None)
            if qcf is not None and qcf.any():
                nfv = np.where(qcf, np.int8(2), nfv)

            k_rep = 10 ** 9 if getattr(args, "all_hits", False) \
                else args.khits

            # per-read hybridSearch replay for search-path-sensitive
            # reads (novel gaps / clips / multimaps / unaligned): their
            # report sets come out finalized in true submission order
            from . import hybrid as hybrid_mod
            overrides = hybrid_mod.substitute_batch(
                aligner, res, b.codes, b.quals, b.lens, seeds,
                secondary=getattr(args, "secondary", False),
                exact=getattr(args, "exact_replay", False),
                rdids=b_rdids)

            def finalize(i, raw=res.raw):
                if i in overrides:
                    return overrides[i]
                return rng_mod.finalize_unpaired(
                    pipeline_mod.read_alignments(raw, i), int(seeds[i]),
                    k_rep, aligner.ref_codes,
                    orient_rank=ranks[i] if ranks else None,
                    secondary=getattr(args, "secondary", False))

            writer.write_batch_raw(b.names, b.codes, b.quals, b.lens,
                                   res.raw, aligner.ref_codes,
                                   n_filtered=nfv, finalize=finalize)
            if sink_al is not None or sink_un is not None:
                has = np.zeros(len(b.names), bool)
                if res.raw is not None and len(res.raw["cols"][0]):
                    has[np.asarray(res.raw["cols"][0])] = True
                for i, name in enumerate(b.names):
                    L = int(b.lens[i])
                    sink = sink_al if has[i] else sink_un
                    if sink is not None:
                        sink.write(name, b.codes[i, :L], b.quals[i, :L])
            if met is not None:
                met.maybe_report(writer, n_bases)

        # 3-deep dispatch pipeline: the device crunches batches i+1..i+3
        # while the host renders batch i's SAM (one-deep leaves the loop
        # latency-bound; the depth on the H100 is ROADMAP A7)
        from collections import deque
        pend = deque()
        for b in unpaired_batches():
            rdids = rdid0 + np.arange(len(b.names), dtype=np.int64)
            rdid0 += len(b.names)
            owned = (n_batches % world) == rank
            n_batches += 1
            if not owned:
                continue        # block-cyclic read sharding (SURVEY 2.6)
            pend.append((aligner.dispatch(b.codes, b.quals, b.lens,
                                          rdids), b, rdids))
            if len(pend) >= 2:
                # advance the mid-queue two-pass handle: its pass-2
                # bucket dispatches NOW and overlaps the newer batches'
                # pass-1 compute (no-op for single-pass aligners)
                h, bb, rr = pend[-2]
                pend[-2] = (aligner.advance(h), bb, rr)
            if len(pend) >= 3:
                emit(pend.popleft())
                if shard is not None:
                    shard.end_batch()
        while pend:
            emit(pend.popleft())
            if shard is not None:
                shard.end_batch()
    elif paired_mode:
        policy = PairPolicy(minins=args.minins, maxins=args.maxins,
                            orient=args.orient, no_mixed=args.no_mixed,
                            no_discordant=args.no_discordant,
                            tlen_adjust=not getattr(
                                args, "no_templatelen_adjustment", False),
                            spliced=not args.no_spliced_alignment,
                            max_intron=args.max_intronlen,
                            dovetail_ok=getattr(args, "dovetail", False),
                            contain_ok=not getattr(args, "no_contain",
                                                   False),
                            overlap_ok=not getattr(args, "no_overlap",
                                                   False))
        from collections import deque
        pend = deque()

        def _finish_pair(item):
            nonlocal n_bases
            b1, b2, rdids, handle = item
            _align_pair_batch(aligner, writer, policy, scoring,
                              args.khits, b1, b2, ref_fn, rdids,
                              sink_un_conc=sink_un_conc,
                              sink_al_conc=sink_al_conc, handle=handle)
            n_bases += int(b1.lens.sum()) + int(b2.lens.sum())
            if met is not None:
                met.maybe_report(writer, n_bases)
            if shard is not None:
                shard.end_batch()

        # 3-deep dispatch pipeline (fused 2B-lane batches are heavy;
        # batches in flight hide device latency behind pairing, and
        # the mid-queue advance() overlaps pass-2 buckets with pass-1)
        for b1, b2 in paired_batches():
            rdids = rdid0 + np.arange(len(b1.names), dtype=np.int64)
            rdid0 += len(b1.names)
            owned = (n_batches % world) == rank
            if not owned:
                n_batches += 1
                continue
            pend.append((b1, b2, rdids,
                         _dispatch_pair_batch(aligner, b1, b2, rdids)))
            if len(pend) >= 2:
                # advance the older handle so its pass-2 bucket overlaps
                # the newest batch's pass-1 device step
                p1, p2, pr, (ph, plens) = pend[-2]
                pend[-2] = (p1, p2, pr,
                            (aligner.advance(ph, paired=True), plens))
            if len(pend) >= 3:
                _finish_pair(pend.popleft())
            n_batches += 1
        while pend:
            _finish_pair(pend.popleft())
    else:
        print("error: provide -U, -1/-2, or --12", file=sys.stderr)
        return 1
    for s in (sink_un, sink_al, sink_un_conc, sink_al_conc):
        if s is not None:
            s.close()
    if met is not None:
        met.close(writer, n_bases)

    if aligner.splice_db is not None and args.novel_splicesite_outfile:
        aligner.splice_db.write_novel(args.novel_splicesite_outfile)
    if shard is not None:
        from ..parallel import multihost
        fields = ("n_reads", "n_unal", "n_uniq", "n_multi", "n_pairs",
                  "n_conc_uniq", "n_conc_multi", "n_disc", "n_mate_unal",
                  "n_mate_uniq", "n_mate_multi")
        shard.finish({k: getattr(writer, k) for k in fields})
        if rank != 0:
            return 0
        import io as _io
        hdr_sink = _io.StringIO()
        SamWriter(hdr_sink, disp_names, index.meta.ref_lens,
                  cmdline=" ".join(sys.argv[1:]), no_head=args.no_hd,
                  rg_id=args.rg_id, rg=args.rg)
        total = multihost.merge_shards(args.sam, world,
                                       header=hdr_sink.getvalue())
        for k, v in total.items():
            setattr(writer, k, v)
        multihost.cleanup_shards(args.sam, world)
    summ = writer.summary(new=getattr(args, "new_summary", False))
    if not args.quiet:
        sys.stderr.write(summ)
    if args.summary_file:
        with open(args.summary_file, "w") as f:
            f.write(summ)
    if args.time:
        sys.stderr.write(f"Time: {time.time() - t0:.2f}s "
                         f"({n_batches} device batches)\n")
    if args.sam:
        writer.close()
    return 0


def _replay_unpaired_giveup(aligner, res, lens):
    """Unpaired interleave replay now runs INSIDE the host phase
    (TPUAligner._eval_order_suppress): lane drops and sink best gating
    happen before ZS/NH are computed there.  This shim only surfaces the
    orientation report ranks the host phase recorded."""
    if res.orient_ranks is None:
        return None
    return [list(r) for r in res.orient_ranks]


class _SeedTagOut:
    """--show-rand-seed: append ZS:i:<seed> (the read's pseudo-random
    seed, sam.h:683) to every record, independent of render path."""

    def __init__(self, out, seed_map):
        self._out = out
        self._seeds = seed_map
        self._buf = ""

    def write(self, s):
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            if line and not line.startswith("@"):
                sd = self._seeds.get(line.split("\t", 1)[0])
                if sd is not None:
                    # the reference emits it right after MD:Z (sam.h:683)
                    fields = line.split("\t")
                    at = len(fields)
                    for t, f in enumerate(fields):
                        if f.startswith("MD:Z:"):
                            at = t + 1
                            break
                        if f.startswith("YT:Z:"):
                            at = t
                            break
                    fields.insert(at, f"ZS:i:{sd}")
                    line = "\t".join(fields)
            self._out.write(line + "\n")

    def __getattr__(self, nm):
        return getattr(self._out, nm)


def _padL(c, L):
    if c.shape[1] >= L:
        return c[:, :L]
    out = np.full((c.shape[0], L), 4, c.dtype)
    out[:, :c.shape[1]] = c
    return out


def _replay_pair_giveup(aligner, res, policy, B, lens, codes=None):
    """Replay the reference's interleaved paired search (align/replay.py)
    and drop alignments from lanes the reference never completed.

    The device's event-stream round logs carry rare one-off segment-
    length deltas; on pairs where the replay decision is consequential
    (an alignment would be dropped, or a mate has none), the logs are
    re-derived exactly with the host emulator's partialSearch
    (align/hybrid.partial_rounds) before deciding."""
    from . import replay as replay_mod
    lm = res.lanes
    if lm is None or aligner.graph is not None:
        return                  # see _replay_unpaired_giveup
    Bt = 2 * B                  # total reads (mate1 block + mate2 block)
    minw_cap = 2 * max(2 * aligner.k, 10)       # kseeds * 2
    hy = None
    for i in range(B):
        lane_ids = [i, i + Bt, B + i, B + i + Bt]
        metas = []
        for l in lane_ids:
            rounds = replay_mod.decode_rounds(lm["h_rounds"][l],
                                              lm["h_rn"][l])
            verdict = bool(lm["h_alignable"][l]) \
                and int(lm["h_minw"][l]) <= minw_cap
            metas.append((rounds, verdict, int(lm["best"][l])))
        sensitive = (codes is not None and not aligner.spliced
                     and len(aligner.shards) == 1
                     and (not res.alignments[i]
                          or not res.alignments[B + i]))
        if sensitive:
            if hy is None:
                from . import hybrid as hybrid_mod
                hy = getattr(aligner, "_hybrid", None)
                if hy is None:
                    hy = hybrid_mod.HybridAligner(
                        aligner.shards[0], variants=aligner.variants,
                        scoring=aligner.scoring, k=aligner.k,
                        anchor_stop=aligner.anchor_stop)
                    aligner._hybrid = hy
            from .hybrid import partial_rounds
            for t, rd in enumerate((i, B + i)):
                L = int(lens[rd])
                cf = np.asarray(codes[rd, :L], np.int8)
                cr = np.where(cf < 4, 3 - cf, cf)[::-1].copy()
                for o, seq in enumerate((cf, cr)):
                    li = 2 * t + o
                    metas[li] = (partial_rounds(hy, seq),
                                 metas[li][1], metas[li][2])
        minsc = (aligner.scoring.min_score(int(lens[i])),
                 aligner.scoring.min_score(int(lens[B + i])))
        a1, a2 = res.alignments[i], res.alignments[B + i]
        spl = (1 if any(a.junc_kind == 1 for a in a1) else 0,
               1 if any(a.junc_kind == 1 for a in a2) else 0)

        def has_concord(completed, _a1=a1, _a2=a2, _i=i):
            # mate alignments usable if their lane completed
            l1 = {0: False, 1: False}
            l2 = {0: False, 1: False}
            for c in completed:
                if c == 0:
                    l1[0] = True
                elif c == 1:
                    l1[1] = True
                elif c == 2:
                    l2[0] = True
                else:
                    l2[1] = True
            for x in _a1:
                if not l1[1 if x.rc else 0]:
                    continue
                for y in _a2:
                    if not l2[1 if y.rc else 0]:
                        continue
                    if policy.concordant(x, y, int(lens[_i]),
                                         int(lens[B + _i]))[0]:
                        return True
            return False

        completed = replay_mod.replay_pair(
            metas, minsc, aligner.scoring.mm_max, aligner.min_k,
            has_concord, paired=True, spliced=spl)
        cs = set(completed)
        keep1 = [(0 in cs), (1 in cs)]
        keep2 = [(2 in cs), (3 in cs)]

        def filt(alns, keep):
            out = [a for a in alns if keep[1 if a.rc else 0]]
            if len(out) != len(alns) and out:
                out = [dataclasses.replace(a, nh=len(out), secondary=t > 0)
                       for t, a in enumerate(out)]
            return out

        res.alignments[i] = filt(a1, keep1)
        res.alignments[B + i] = filt(a2, keep2)


def _dispatch_pair_batch(aligner, b1, b2, rdids):
    """Enqueue both mates as one fused device batch (lanes 0..B-1 =
    mate 1, B..2B-1 = mate 2); pair with _align_pair_batch(handle=...)
    to overlap device compute with host pairing of the previous batch."""
    B = len(b1.names)
    assert len(b2.names) == B, "mate files out of sync"
    L = max(b1.codes.shape[1], b2.codes.shape[1])

    def padto(c, q, L):
        if c.shape[1] == L:
            return c, q
        pc = np.full((c.shape[0], L), 4, c.dtype)
        pq = np.zeros((q.shape[0], L), q.dtype)
        pc[:, :c.shape[1]] = c
        pq[:, :q.shape[1]] = q
        return pc, pq

    c1, q1 = padto(b1.codes, b1.quals, L)
    c2, q2 = padto(b2.codes, b2.quals, L)
    codes = np.concatenate([c1, c2])
    quals = np.concatenate([q1, q2])
    lens = np.concatenate([b1.lens, b2.lens])
    if rdids is None:
        rdids = np.arange(B, dtype=np.int64)
    return aligner.dispatch(codes, quals, lens,
                            np.concatenate([rdids, rdids])), lens


def _align_pair_batch(aligner, writer, policy, scoring, k, b1, b2, ref_fn,
                      rdids=None, sink_un_conc=None, sink_al_conc=None,
                      handle=None):
    """Align both mates in one device batch, then pair on host."""
    B = len(b1.names)
    if rdids is None:
        rdids = np.arange(B, dtype=np.int64)
    if handle is None:
        handle = _dispatch_pair_batch(aligner, b1, b2, rdids)
    h, lens = handle
    seeds1 = rng_mod.gen_rand_seeds(b1.codes, b1.lens, b1.quals, b1.names)
    seeds2 = rng_mod.gen_rand_seeds(b2.codes, b2.lens, b2.quals, b2.names)
    pair_seeds = (seeds1 ^ seeds2).astype(np.uint32)
    res = aligner.collect(h, paired=True)
    codes12 = np.concatenate(
        [_padL(b1.codes, int(max(lens))), _padL(b2.codes, int(max(lens)))])
    _replay_pair_giveup(aligner, res, policy, B, lens, codes12)

    # mate rescue (HI_Aligner::go, hi_aligner.h:3912-3952): when no
    # concordant pair exists but one mate aligned, search the other mate in
    # a window anchored at the aligned mate's position (batched)
    jobs = []        # (pair idx, rescued mate# (0/1), anchor, rc expected)
    all_pairs = []
    intron_fn = (aligner.splice_db.max_intron_in
                 if aligner.splice_db is not None
                 and policy.tlen_adjust else None)
    for i in range(B):
        alns1 = res.alignments[i]
        alns2 = res.alignments[B + i]
        pairs = best_pairs(alns1, alns2, int(b1.lens[i]), int(b2.lens[i]),
                           policy, k, intron_fn, int(rdids[i]))
        all_pairs.append(pairs)
        if pairs or (not alns1 and not alns2):
            continue
        for m, (anch, other) in enumerate(((alns1, alns2),
                                           (alns2, alns1))):
            if not anch:
                continue
            for a in anch[:2]:
                # --fr: the other mate sits on the opposite strand
                exp_rc = not a.rc if policy.orient == "fr" else a.rc
                jobs.append((i, 1 - m, a.joined_pos, exp_rc))
    if jobs:
        R = len(jobs)
        Lr = max(b1.codes.shape[1], b2.codes.shape[1])
        jc = np.full((R, Lr), 4, np.uint8)
        jq = np.zeros((R, Lr), np.uint8)
        jl = np.zeros(R, np.int32)
        ja = np.zeros(R, np.int64)
        jrc = np.zeros(R, bool)
        for t, (i, m, anch, exp_rc) in enumerate(jobs):
            bm = b1 if m == 0 else b2
            Lm = int(bm.lens[i])
            jc[t, :Lm] = bm.codes[i, :Lm]
            jq[t, :Lm] = bm.quals[i, :Lm]
            jl[t] = Lm
            ja[t] = anch
            jrc[t] = exp_rc
        rescued = aligner.rescue_mates(jc, jq, jl, ja, jrc, policy.maxins)
        for t, (i, m, anch, exp_rc) in enumerate(jobs):
            if not rescued[t]:
                continue
            lst = res.alignments[i if m == 0 else B + i]
            have = {(a.joined_pos, a.rc) for a in lst}
            for a in rescued[t]:
                if (a.joined_pos, a.rc) not in have:
                    lst.append(dataclasses.replace(
                        a, read_idx=i if m == 0 else B + i))
            # re-pair with the rescued candidates
            all_pairs[i] = best_pairs(
                res.alignments[i], res.alignments[B + i],
                int(b1.lens[i]), int(b2.lens[i]), policy, k,
                intron_fn, int(rdids[i]))

    for i in range(B):
        name = b1.names[i]
        l1, l2 = int(b1.lens[i]), int(b2.lens[i])
        alns1 = res.alignments[i]
        alns2 = res.alignments[B + i]
        pairs = rng_mod.finalize_pairs(all_pairs[i], int(pair_seeds[i]),
                                        k, aligner.ref_codes)
        sink = sink_al_conc if pairs else sink_un_conc
        if sink is not None:
            sink.write(name, b1.codes[i, :l1], b1.quals[i, :l1],
                       b2.codes[i, :l2], b2.quals[i, :l2])
        if pairs:
            # pair-level NH / MAPQ (AlnSinkWrap::finishRead paired summary)
            best = pairs[0][0].score + pairs[0][1].score
            sec = (pairs[1][0].score + pairs[1][1].score
                   if len(pairs) > 1 else 0)
            minsc = scoring.min_score(l1) + scoring.min_score(l2)
            perf = scoring.perfect_score(l1) + scoring.perfect_score(l2)
            mq = int(mapq_mod.mapq_selected(
                np.array([best]), np.array([sec]),
                np.array([len(pairs) > 1]), np.array([perf]),
                np.array([minsc]), paired=True)[0])
            nh = len(pairs)
            fixed = []
            for j, (a1, a2, tl, tl2) in enumerate(pairs):
                fixed.append((
                    dataclasses.replace(a1, nh=nh, mapq=mq, secondary=j > 0),
                    dataclasses.replace(a2, nh=nh, mapq=mq, secondary=j > 0),
                    tl, tl2))
            writer.write_pair(name, b1.codes[i, :l1], b1.quals[i, :l1],
                              b2.codes[i, :l2], b2.quals[i, :l2],
                              fixed, alns1, alns2, ref_fn)
            continue
        # discordant: both mates unique, constraints violated
        if (not policy.no_discordant and len(alns1) >= 1 and len(alns2) >= 1
                and alns1[0].nh == 1 and alns2[0].nh == 1
                and alns1[0].ref_id == alns2[0].ref_id):
            a1, a2 = alns1[0], alns2[0]
            p1, p2 = a1.aln_start, a2.aln_start
            frag = max(p1 + a1.aln_span, p2 + a2.aln_span) - min(p1, p2)
            tl = frag if p1 <= p2 else -frag
            writer.write_pair(name, b1.codes[i, :l1], b1.quals[i, :l1],
                              b2.codes[i, :l2], b2.quals[i, :l2],
                              [(a1, a2, tl, -tl)], alns1, alns2, ref_fn,
                              discordant=True)
            continue
        if policy.no_mixed:
            writer.write_pair(name, b1.codes[i, :l1], b1.quals[i, :l1],
                              b2.codes[i, :l2], b2.quals[i, :l2],
                              [], [], [], ref_fn)
        else:
            writer.write_pair(name, b1.codes[i, :l1], b1.quals[i, :l1],
                              b2.codes[i, :l2], b2.quals[i, :l2],
                              [], alns1, alns2, ref_fn)
