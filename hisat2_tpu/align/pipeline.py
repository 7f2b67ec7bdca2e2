"""End-to-end batched alignment pipeline (driver + device step).

This is the batched equivalent of the reference's per-thread worker loop
(multiseedSearchWorker_hisat2, hisat2.cpp:3051-3520) and
HI_Aligner::go (hi_aligner.h:3874): instead of one read per thread iterating
search->resolve->extend with data-dependent control flow, a whole batch of
reads (x2 orientations) runs each stage as one fused device computation:

  encode batch -> [device] partial_search (wavefront LF)
               -> [device] resolve rows -> joined offsets
               -> [device] ungapped extension scoring
               -> [host]   dedup / select<=k / MAPQ / SAM fields

Selection semantics follow AlnSinkWrap::finishRead (aln_sink.h:1054-1360):
up to k alignments sorted by score (deterministic tie-break by coordinate),
NH = number reported, secondary flag on all but the first, MAPQ from
best/secbest via mapq.mapq_v2.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..index.format import FMIndex
from ..ops import compact as compact_ops
from ..ops import extend as extend_ops
from ..ops import rank as rk
from ..ops import resolve as resolve_ops
from ..ops import search as search_ops
from ..ops import splice as splice_ops
from ..utils import bitops
from ..utils.trace import section_timer
from . import mapq as mapq_mod
from .scoring import Scoring, SimpleFunc


class SpillOverflow(Exception):
    """A spill-layout batch had more valid non-head slots than its S=2B
    spill rows (multimap-saturated input); callers re-run full_out."""


@dataclasses.dataclass
class Alignment:
    """One reported alignment (AlnRes equivalent, aligner_result.h).

    Junction fields describe at most one splice/indel join (combineWith
    product, hi_aligner.h:1286): the read splits at `junc_x` (first read
    base of the right segment); `junc_len` is the reference skip (intron or
    deletion length; negative = insertion length); `spl_dir` is the
    SPL_FW/RC/SEMI_* classification driving the XS:A tag."""
    read_idx: int
    rc: bool              # reverse-complement orientation
    ref_id: int
    ref_pos: int          # 0-based ref position of the first ALIGNED base
    joined_pos: int       # joined position of the (unclipped) read start
    clip_l: int           # soft-clipped bases at alignment start (trim5)
    clip_r: int           # soft-clipped bases at alignment end (trim3)
    aln_span: int         # aligned reference span (incl. intron/del skip)
    score: int
    n_mm: int
    n_n: int
    mapq: int
    nh: int
    secondary: bool
    zs: Optional[int] = None   # secbest score (SAM ZS:i), when one exists
    junc_kind: int = 0         # 0 none, 1 splice (N), 2 deletion, 3 insertion
    junc_x: int = 0            # read pos of the right segment's first base
    junc_len: int = 0          # REFERENCE-space skip (>0 N/D; <0 insertion;
                               #   may exceed the joined gap across N runs)
    junc_d2: int = 0           # joined diagonal of the right segment
    spl_dir: int = 0           # splice_ops.SPL_*
    junc_known: bool = False   # known splice site / known ALT indel
    junc_snp: int = -1         # VariantDB snp index of a known ALT indel
    # optional SECOND junction (multi-exon reads): read splits at
    # junc_x < junc2_x into three segments on diagonals
    # (joined_pos, junc_d2, junc2_d3)
    junc2_kind: int = 0
    junc2_x: int = 0
    junc2_len: int = 0
    junc2_d3: int = 0
    junc2_dir: int = 0
    # optional THIRD junction (4 exons in one read; the reference's
    # hybridSearch_recur recurses arbitrarily, spliced_aligner.h:183-214 —
    # depth 3 covers every read a 2-pass left+right composite can reach)
    junc3_kind: int = 0
    junc3_x: int = 0
    junc3_len: int = 0
    junc3_d4: int = 0
    junc3_dir: int = 0

    def segments(self, read_len: int):
        """[(read_lo, read_hi, joined_diag)] aligned segments plus the
        junction list [(x, kind, ref_len, dir)] — the generic shape SAM
        rendering and site collection iterate over."""
        cl, cr = self.clip_l, self.clip_r
        if self.junc_kind == 0:
            return ([(cl, read_len - cr, self.joined_pos)], [])
        ins1 = max(-self.junc_len, 0) if self.junc_kind == 3 else 0
        segs = [(cl, self.junc_x, self.joined_pos)]
        juncs = [(self.junc_x, self.junc_kind, self.junc_len,
                  self.spl_dir)]
        if self.junc2_kind == 0:
            segs.append((self.junc_x + ins1, read_len - cr, self.junc_d2))
            return segs, juncs
        ins2 = max(-self.junc2_len, 0) if self.junc2_kind == 3 else 0
        segs.append((self.junc_x + ins1, self.junc2_x, self.junc_d2))
        juncs.append((self.junc2_x, self.junc2_kind, self.junc2_len,
                      self.junc2_dir))
        if self.junc3_kind == 0:
            segs.append((self.junc2_x + ins2, read_len - cr,
                         self.junc2_d3))
            return segs, juncs
        segs.append((self.junc2_x + ins2, self.junc3_x, self.junc2_d3))
        segs.append((self.junc3_x, read_len - cr, self.junc3_d4))
        juncs.append((self.junc3_x, self.junc3_kind, self.junc3_len,
                      self.junc3_dir))
        return segs, juncs

    @property
    def aln_start(self) -> int:
        """Joined position of the first aligned base."""
        return self.joined_pos + self.clip_l


# column order of BatchResult.raw["cols"] (one entry per kept alignment,
# rows sorted by read then report rank) — matches the Alignment fields
# materialized in _materialize_alignments
RAW_COLS = ("read", "rc", "ref_id", "ref_pos", "joined_pos", "clip_l",
            "clip_r", "aln_span", "score", "n_mm", "n_n", "mapq", "nh",
            "secondary", "has_sec", "zs", "junc_kind", "junc_x",
            "junc_len", "junc_d2", "spl_dir", "junc_known", "junc_snp",
            "junc2_kind", "junc2_x", "junc2_len", "junc2_d3", "junc2_dir",
            "junc3_kind", "junc3_x", "junc3_len", "junc3_d4", "junc3_dir")


def _materialize_alignments(raw, n_reads):
    """Build per-read Alignment object lists from the raw column arrays
    (the slow path — array-native consumers read raw directly)."""
    per_read = [[] for _ in range(n_reads)]
    if raw is None or not len(raw["cols"][0]):
        return per_read
    cols = [c.tolist() for c in raw["cols"]]
    for t in range(len(cols[0])):
        (rd, rc_t, rid, rpos, jp, cl, cr, span, sct, nmm, nnn, mqt,
         nrep, sec2, hs, zs2, jk, jx, jl, jd2, sd, jkn, jsnp,
         j2k, j2x, j2l, j2d3, j2d,
         j3k, j3x, j3l, j3d4, j3d) = (c[t] for c in cols)
        per_read[rd].append(Alignment(
            read_idx=rd, rc=bool(rc_t), ref_id=rid,
            ref_pos=rpos, joined_pos=jp,
            clip_l=cl, clip_r=cr, aln_span=span,
            score=sct, n_mm=nmm, n_n=nnn,
            mapq=mqt, nh=nrep,
            secondary=bool(sec2),
            zs=(zs2 if hs else None),
            junc_kind=jk, junc_x=jx, junc_len=jl,
            junc_d2=jd2, spl_dir=sd,
            junc_known=bool(jkn), junc_snp=jsnp,
            junc2_kind=j2k, junc2_x=j2x,
            junc2_len=j2l, junc2_d3=j2d3,
            junc2_dir=j2d,
            junc3_kind=j3k, junc3_x=j3x,
            junc3_len=j3l, junc3_d4=j3d4,
            junc3_dir=j3d))
    return per_read


def read_alignments(raw, i):
    """Alignment objects for ONE read from the raw columns (rows are
    sorted by read, so a binary search bounds the slice)."""
    if raw is None:
        return []
    rd = raw["cols"][0]
    lo = int(np.searchsorted(rd, i))
    hi = int(np.searchsorted(rd, i + 1))
    if lo == hi:
        return []
    sub = {"cols": [c[lo:hi] for c in raw["cols"]]}
    return _materialize_alignments(sub, i + 1)[i]


@dataclasses.dataclass
class BatchResult:
    n_reads: int
    # per-lane search metadata (lane = read for fw, read + n_reads for rc)
    # for the paired give-up replay: round log words, round counts,
    # align() verdict, per-lane best reported score
    lanes: Optional[dict] = None
    # unpaired orientation report ranks [B, 2] from the eval-order replay
    orient_ranks: Optional[np.ndarray] = None
    # array-native result: {"cols": [arrays in RAW_COLS order]} — rows are
    # kept alignments sorted by read then report rank.  The vectorized SAM
    # renderer consumes this directly; Alignment objects materialize only
    # on first .alignments access (pair/splice/genotype consumers).
    raw: Optional[dict] = None
    _alignments: Optional[list] = None

    @property
    def alignments(self):
        if self._alignments is None:
            self._alignments = _materialize_alignments(self.raw,
                                                       self.n_reads)
        return self._alignments

    @property
    def n_aligned(self):
        return sum(1 for a in self.alignments if a)

    @property
    def n_unique(self):
        return sum(1 for a in self.alignments if a and a[0].nh == 1)

    @property
    def n_multi(self):
        return sum(1 for a in self.alignments if a and a[0].nh > 1)


class TPUAligner:
    """Holds the device-resident index + jitted batch step."""

    def __init__(self, index: FMIndex, scoring: Optional[Scoring] = None,
                 k: int = 5, max_hits: int = 4, min_hit_len: int = 16,
                 cand_per_hit: int = 4, no_fw: bool = False,
                 no_rc: bool = False, variants=None, spliced: bool = False,
                 max_pairs: int = 4, splice_db=None, ss_slots: int = 2,
                 lane_meta: bool = False, shard_devices=None,
                 max_seeds: int = 0, all_hits: bool = False,
                 tmo: bool = False, require_xs: bool = False,
                 anchor_stop: bool = True, lite: bool = False,
                 inject_ss: bool = False,
                 _devs=None, _ref_codes=None, _graph_bundle=None):
        self.meta = index.meta
        self.scoring = scoring or Scoring()
        # lite: the tier-A fast path of the two-pass pipeline — ungapped
        # extension (+ optional known-splice-site injection) with small
        # slot counts and none of the sweep/injection machinery.  Reads
        # whose exact answer could involve the skipped machinery are
        # routed to the full aligner by _collect_two_pass (imperfect
        # score, slot saturation via h_sat, known-indel overlap); the
        # reference has the same structure (extension first, hybridSearch
        # recursion only on unfinished reads, spliced_aligner.h:113-214).
        self.lite = lite
        self.inject_ss = inject_ss
        self.use_ss = spliced or inject_ss
        # --tmo: only known-splice-site junctions are reportable and no
        # temp sites are collected; --dta-cufflinks: spliced alignments
        # must carry a resolvable XS (classified direction) or be known
        self.tmo = tmo
        self.require_xs = require_xs
        self.anchor_stop = anchor_stop
        self.k = k
        # --max-seeds defaults to max(5, 2k) (hisat2.cpp:3073); -a lifts
        # both limits — bounded here by a static device cap of 64
        # placements per read (documented divergence for >64-copy repeats)
        self.all_hits = all_hits
        self.max_seeds = max_seeds if max_seeds else max(5, 2 * k)
        if all_hits:
            self.k = 10 ** 9
            self.max_seeds = 10 ** 9
        # device slot sizing must cover every placement the reference's
        # sink can select from: up to max(khits, maxSeeds) rows resolve
        # per hit (getAnchorHits, hi_aligner.h:4341-4351) and ALL of them
        # enter the RNG streak shuffle (selectByScore, aln_sink.h:2504)
        self.msize = min(max(self.k, self.max_seeds), 64)
        self.max_hits = max_hits
        # _minK (hi_aligner.h:3807-3813): #base-4 digits of the genome length
        n = index.meta.n
        self.min_k = 0
        while n > 0:
            n >>= 2
            self.min_k += 1
        min_hit_len2 = min_hit_len
        del min_hit_len
        if spliced:
            # short boundary anchors feed the junction pair sweep (the
            # reference's local-search flank floor is ~8 original chars:
            # extoff >= minAnchorLen=7 and the search excludes the char
            # the global walk consumed past the junction, which our
            # mismatch-skip restart also drops - hence 7 recorded chars),
            # with +8 candidate slots for their diagonals
            self.min_hit_len = 7
            # core slots get the full plane/sweep treatment; extra
            # multimap slots (up to msize+1 total) get ungapped
            # extension only (see _align_device)
            self.core_cands = max(k + 1, 6) + 8
            self.max_cands = max(self.core_cands, self.msize + 1)
            # short flanks resolve like the reference's LOCAL search: the
            # segment may occur many times genome-wide yet uniquely within
            # the 57kb window - resolve up to 16 rows and keep only those
            # near an align-capable candidate (see the proximity filter)
            self.short_rows = 16
        else:
            # DNA mode: sub-FM-anchor indel flanks need no candidate slot,
            # the self-gap sweep covers them from the long side alone (the
            # reference's local-search equivalent), so the candidate pool
            # stays small
            self.min_hit_len = min_hit_len2
            self.core_cands = max(k + 1, 6)
            self.max_cands = max(self.core_cands, self.msize + 1)
            self.short_rows = 5
            if lite:
                # tier-A caps: up to lite_cap equal-best placements are
                # fully representable; wider hits / fuller pools set the
                # per-lane h_sat flag and route the read to the full pass
                self.lite_cap = 8
                self.msize = min(self.msize, self.lite_cap)
                self.max_cands = self.core_cands
        # up to 6 rows resolve per hit in spliced mode (the reference
        # resolves short-segment ranges only when nelt <= 5,
        # spliced_aligner.h:951)
        self.cand_per_hit = max(cand_per_hit, 6) if spliced \
            else cand_per_hit
        self.no_fw = no_fw
        self.no_rc = no_rc
        self.spliced = spliced
        self.max_pairs = max_pairs
        self.lane_meta = lane_meta
        # whole-genome scale: a ShardedFMIndex runs one device pass per
        # sub-index; candidates rebase into global joined coordinates at
        # merge time (collect)
        from ..index.format import ShardedFMIndex
        if isinstance(index, ShardedFMIndex):
            self.shards = index.shards
            self.shard_bases = list(index.shard_bases)
            self.ref_codes = (_ref_codes if _ref_codes is not None
                              else index.global_ref_codes())
            if lane_meta and len(self.shards) > 1:
                # the paired give-up replay models ONE interleaved search;
                # per-shard round logs don't merge faithfully
                self.lane_meta = False
        else:
            self.shards = [index]
            self.shard_bases = [0]
            self.ref_codes = bitops.unpack_2bit(
                np.asarray(index.ref_words), index.meta.n)
        if _devs is not None:
            # shared device bundles (the spliced aligner's fast pass
            # reuses the same HBM-resident index arrays)
            self.devs = _devs
        elif shard_devices is not None:
            # one chip per index shard (MPMD): each shard's device pass
            # runs where its arrays live; the batch is broadcast
            self.devs = [sh.to_device(shard_devices[i % len(shard_devices)])
                         for i, sh in enumerate(self.shards)]
        else:
            self.devs = [sh.to_device() for sh in self.shards]
        self.dev = self.devs[0]
        self.frag_joined = np.asarray(index.frag_joined)
        self.frag_ref = np.asarray(index.frag_ref)
        self.frag_off = np.asarray(index.frag_off)
        # replicated small parameter arrays: jit ARGUMENTS, never closures
        # (see ops/rank.py perf rule)
        self.params = {
            "mm_pen": jnp.asarray(self.scoring.mm_pen_table()),
            "clip_pen": jnp.asarray(self.scoring.clip_pen_table()),
        }
        # variant (ALT) database -> per-shard device planes + a host-side
        # global view for Zs annotation (multi-gigabase graphs shard like
        # linear ones; each shard carries its in-range variants rebased to
        # local coordinates)
        self.variants = variants
        self.has_indels = False
        self.shard_params = [dict() for _ in self.shards]
        self.shard_row_db = [None] * len(self.shards)
        if _graph_bundle is not None:
            # share the parent's DEVICE graph tables (SNV planes, indel
            # tables) — the two-tier twin otherwise re-uploads multi-GB
            # planes per shard and exhausts HBM on genome-scale indexes
            (self.graph, self.has_indels, shard_dev,
             self.shard_row_db) = _graph_bundle
            self.shard_params = [dict(d) for d in shard_dev]
        elif variants is not None and variants.n_snps:
            from ..index.graph import (build_graph_arrays,
                                       indel_device_tables,
                                       shard_graph_arrays)
            if len(self.shards) == 1:
                shard_graphs = [build_graph_arrays(index, variants)]
                self.graph = shard_graphs[0]
            else:
                # host-only global view (planes are per-shard)
                self.graph = build_graph_arrays(
                    index, variants, ref_codes=self.ref_codes,
                    with_planes=False)
                shard_graphs = [
                    shard_graph_arrays(sh, variants, b)
                    for sh, b in zip(self.shards, self.shard_bases)]
            self.has_indels = any(len(g.indel_pos) for g in shard_graphs)
            for i, g in enumerate(shard_graphs):
                sp_i = self.shard_params[i]
                sp_i["snv1"] = jnp.asarray(g.snv_delta1)
                sp_i["snv2"] = jnp.asarray(g.snv_delta2)
                if self.has_indels:
                    tabs = indel_device_tables(g)
                    self.shard_row_db[i] = tabs.pop("_row_db")
                    sp_i.update({k2: jnp.asarray(v)
                                 for k2, v in tabs.items()})
        else:
            self.graph = None
            for sp_i in self.shard_params:
                sp_i["snv1"] = jnp.zeros(1, jnp.uint32)
                sp_i["snv2"] = jnp.zeros(1, jnp.uint32)
        # snapshot (pre-fold) for two-tier twins to share device tables
        self._graph_bundle = (self.graph, self.has_indels,
                              [dict(d) for d in self.shard_params],
                              self.shard_row_db)
        if len(self.shards) == 1:
            # single-shard (the common case): fold into the main param
            # dict so mesh/rescue/dryrun consumers see one bundle
            self.params.update(self.shard_params[0])
            self.shard_params[0] = {}
        self.splice_params = splice_ops.SpliceParams(
            min_intron=self.scoring.min_intron_len,
            max_intron=self.scoring.max_intron_len,
            pen_can=self.scoring.pen_can_splice,
            pen_noncan=self.scoring.pen_noncan_splice,
            lenpen_const=self.scoring.pen_can_intron_len.const,
            lenpen_coef=self.scoring.pen_can_intron_len.coef,
            lenpen_nc_const=self.scoring.pen_noncan_intron_len.const,
            lenpen_nc_coef=self.scoring.pen_noncan_intron_len.coef,
            min_anchor=self.scoring.min_anchor,
            min_anchor_noncan=self.scoring.min_anchor_noncan,
            rd_gap_open=self.scoring.rd_gap_open,
            rd_gap_ext=self.scoring.rd_gap_ext,
            rf_gap_open=self.scoring.rf_gap_open,
            rf_gap_ext=self.scoring.rf_gap_ext,
            allow_spliced=spliced)
        # the junction sweep always runs: --no-spliced-alignment still
        # discovers novel indels (combineWith's ins/del branch is not gated
        # by no_spliced_alignment, hi_aligner.h:1344-1367)
        td, ta1, ta2 = splice_ops.junction_prob_tables()
        self.params["tab_donor"] = jnp.asarray(td)
        self.params["tab_acc1"] = jnp.asarray(ta1)
        self.params["tab_acc2"] = jnp.asarray(ta2)
        if spliced:
            from .splice_db import SpliceSiteDB
            self.splice_db = (splice_db if splice_db is not None
                              else SpliceSiteDB(index))
            if variants is not None and len(variants.ss_ref):
                self.splice_db.add_from_variants(variants)
        elif inject_ss:
            # lite fast pass of a spliced aligner: shares the parent's
            # site DB so pass-1 known/temp-site injection sees the same
            # table the full pass would
            self.splice_db = splice_db
        else:
            self.splice_db = None
        self.ss_slots = ss_slots
        self._rescue_jits = {}
        # the device step returns ONE packed int32 buffer (floats
        # bit-cast) fetched in a single transfer instead of 20+ small D2H
        # copies; the layout is kept pending measurement on the H100
        # (ROADMAP A7)
        self._out_specs = {}
        self._spill_meta = {}
        self._device_step = jax.jit(
            self._align_device_packed,
            static_argnames=("uniform", "h2d", "full_out"))
        # two-pass spliced pipeline: a DNA-mode twin handles the fast
        # common case (ungapped / known-indel); the full junction
        # machinery runs only on the subset of reads whose best pass-1
        # score is imperfect (the reference's own structure: hybridSearch
        # recursion only runs when extension leaves the read unfinished,
        # spliced_aligner.h:113-214)
        self._fast = None
        if spliced:
            self._fast = TPUAligner(
                index, scoring=self.scoring, k=k, max_hits=max_hits,
                cand_per_hit=cand_per_hit, no_fw=no_fw, no_rc=no_rc,
                variants=variants, spliced=False, lane_meta=lane_meta,
                max_seeds=max_seeds, all_hits=all_hits, tmo=tmo,
                require_xs=require_xs, anchor_stop=anchor_stop,
                lite=not all_hits, inject_ss=not all_hits,
                splice_db=self.splice_db,
                _devs=self.devs, _ref_codes=self.ref_codes,
                _graph_bundle=self._graph_bundle)
        elif (not lite and not all_hits and variants is not None
              and variants.n_snps):
            # DNA mode on a graph index: the same two-pass structure —
            # a lite tier-A pass finishes perfect/near-perfect reads,
            # the full machinery (indel injection, self-gap sweep, wide
            # multimap slots) runs only on the routed subset
            self._fast = TPUAligner(
                index, scoring=self.scoring, k=k, max_hits=max_hits,
                cand_per_hit=cand_per_hit, no_fw=no_fw, no_rc=no_rc,
                variants=variants, spliced=False, lane_meta=lane_meta,
                max_seeds=max_seeds, tmo=tmo,
                require_xs=require_xs, anchor_stop=anchor_stop,
                lite=True, _devs=self.devs, _ref_codes=self.ref_codes,
                _graph_bundle=self._graph_bundle)
        # host-side routing table for the DNA two-pass: reads overlapping
        # a known ALT indel could carry an equal-or-better free ALT form
        # the lite pass cannot represent — route them to the full pass
        self._indel_bounds = None
        if (self._fast is not None and self._fast.lite
                and self.graph is not None
                and len(self.graph.indel_pos)):
            ip = np.asarray(self.graph.indel_pos, np.int64)
            il = np.maximum(np.asarray(self.graph.indel_len, np.int64), 0)
            self._indel_bounds = np.unique(
                np.concatenate([ip - 1, ip + il + 1]))

    def _align_device_packed(self, d, params, reads, quals, lens, minsc,
                             rdids=None, ss=None, uniform=False, h2d=None,
                             full_out=False):
        # the hot path (dispatch/_run_batch) uploads 2-bit code words + an
        # N bitmask (h2d=(L, const_q)), ~6x smaller than uint8 codes+quals;
        # tests may still pass uint8 [B, L] (h2d=None).  Unpacking is
        # elementwise shift/mask work.  Kept pending measurement on the
        # H100 (ROADMAP A7)
        if h2d is not None:
            L, const_q = h2d
            W2 = (L + 15) // 16
            W1 = (L + 31) // 32
            B = reads.shape[0]
            col = jnp.arange(L, dtype=jnp.int32)[None, :]
            w16 = jnp.repeat(reads[:, :W2], 16, axis=1)[:, :L]
            sh2 = (2 * (col & 15)).astype(jnp.uint32)
            codes = ((w16 >> sh2) & np.uint32(3)).astype(jnp.int32)
            b32 = jnp.repeat(reads[:, W2:W2 + W1], 32, axis=1)[:, :L]
            nbit = ((b32 >> (col & 31).astype(jnp.uint32))
                    & np.uint32(1)) != 0
            lens = reads[:, W2 + W1].astype(jnp.int32)
            minsc = jax.lax.bitcast_convert_type(reads[:, W2 + W1 + 1],
                                                 jnp.int32)
            reads = jnp.where(nbit, jnp.int32(4), codes)
            if const_q:
                quals = jnp.broadcast_to(quals.astype(jnp.int32), (B, L))
        out = self._align_device(d, params, reads.astype(jnp.int32),
                                 quals.astype(jnp.int32), lens, minsc,
                                 rdids, ss, uniform=uniform,
                                 full_out=full_out)
        # D2H shrink: genome positions and round logs stay int32, scores
        # travel int16 (2/word), and small counters / flags / read offsets
        # travel int8 (4/word).  Kept pending measurement on the H100
        # (ROADMAP A7)
        I32 = {"u_d1", "u_d2", "u_event", "h_rounds",
               "q2_d", "q2_bd1", "q2_bd2", "sp_src", "sp_w", "sp_ev",
               "q3_ld", "q3_rd", "r2_d", "r2_bd1", "r2_bd2",
               "r3_ld", "r3_rd"}
        # read-length-bounded fields fit int8 only for short reads (L is
        # static at trace time)
        L = reads.shape[1]
        I8 = {"u_flags", "u_dd", "u_ab", "h_alignable", "h_stop", "h_sat",
              "q2_bkind", "q2_bdir", "q2_dir", "q2_bknown",
              "q3_ldir", "q3_rdir", "r2_bkind", "r2_bdir", "r2_dir",
              "r2_bknown", "r3_ldir", "r3_rdir"}
        if L <= 127:
            I8 |= {"u_n_mm", "u_n_n", "u_clip_l", "u_clip_r", "u_x",
                   "q2_x", "q2_bx", "q3_lx", "q3_rx",
                   "r2_x", "r2_bx", "r3_lx", "r3_rx"}
        cols, specs = [], []
        half, quart = [], []
        for k in sorted(out):
            v = out[k]
            dt = v.dtype
            if dt == jnp.float32:
                v = jax.lax.bitcast_convert_type(v, jnp.int32)
            elif dt == jnp.bool_:
                v = v.astype(jnp.int32)
            v2 = v.reshape(v.shape[0], -1).astype(jnp.int32)
            if k in I32 or str(dt) == "float32":
                specs.append((k, str(dt), v.shape[1:], v2.shape[1], "i32"))
                cols.append(v2)
            elif k in I8:
                specs.append((k, str(dt), v.shape[1:], v2.shape[1], "i8"))
                quart.append(jnp.clip(v2, -128, 127))
            else:
                specs.append((k, str(dt), v.shape[1:], v2.shape[1], "i16"))
                half.append(jnp.clip(v2, -32768, 32767))
        if half:
            hcat = jnp.concatenate(half, axis=1)
            if hcat.shape[1] % 2:
                hcat = jnp.concatenate(
                    [hcat, jnp.zeros((hcat.shape[0], 1), jnp.int32)],
                    axis=1)
            packed16 = (hcat[:, 0::2] & 0xFFFF) | (hcat[:, 1::2] << 16)
            cols.append(packed16)
        if quart:
            qcat = jnp.concatenate(quart, axis=1)
            pad = (-qcat.shape[1]) % 4
            if pad:
                qcat = jnp.concatenate(
                    [qcat, jnp.zeros((qcat.shape[0], pad), jnp.int32)],
                    axis=1)
            packed8 = ((qcat[:, 0::4] & 0xFF)
                       | ((qcat[:, 1::4] & 0xFF) << 8)
                       | ((qcat[:, 2::4] & 0xFF) << 16)
                       | (qcat[:, 3::4] << 24))
            cols.append(packed8)
        buf = jnp.concatenate(cols, axis=1)
        # static; set at trace time.  Keyed by packed width so the spill
        # and full_out layouts of the same aligner can coexist
        self._out_specs[buf.shape[1]] = specs
        self._spill_meta[buf.shape[1]] = getattr(
            self, "_traced_spill_mdev", None)
        self._traced_spill_mdev = None
        return buf

    @staticmethod
    def _pack_h2d(codes: np.ndarray, quals: np.ndarray,
                  lens: np.ndarray, minsc: np.ndarray):
        """Host-side H2D shrink: 2-bit code words + N bitmask + lens +
        minsc in ONE uint32 buffer (+ constant-qual elision): one upload
        per batch instead of five small ones (ROADMAP A7).  Returns
        (buf, quals, h2d)."""
        B, L = codes.shape
        W2 = (L + 15) // 16
        W1 = (L + 31) // 32
        buf = np.empty((B, W2 + W1 + 2), np.uint32)
        c = np.zeros((B, W2 * 16), np.uint32)
        c[:, :L] = codes & 3
        sh = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
        np.bitwise_or.reduce(c.reshape(B, W2, 16) << sh, axis=2,
                             out=buf[:, :W2])
        nb = np.zeros((B, W1 * 32), np.uint32)
        nb[:, :L] = codes > 3
        sh1 = np.arange(32, dtype=np.uint32)[None, None, :]
        np.bitwise_or.reduce(nb.reshape(B, W1, 32) << sh1, axis=2,
                             out=buf[:, W2:W2 + W1])
        buf[:, W2 + W1] = lens.astype(np.uint32)
        buf[:, W2 + W1 + 1] = np.asarray(minsc, np.int64).astype(
            np.int32).view(np.uint32)
        const_q = bool((quals == quals.flat[0]).all()) if quals.size else True
        q = (np.ascontiguousarray(quals[:1, :1])
             if const_q else np.asarray(quals, np.uint8))
        return (jnp.asarray(buf),
                jnp.asarray(np.asarray(q, np.uint8)), (L, const_q))

    def _fetch_out(self, packed) -> dict:
        buf = np.asarray(packed)         # ONE device->host transfer
        specs = self._out_specs[buf.shape[1]]
        out = {}
        off = 0
        # transfer layout: int32 columns, then int16 halves, then int8 quads
        n16 = sum(w for *_, w, m in specs if m == "i16")
        n8 = sum(w for *_, w, m in specs if m == "i8")
        w32 = sum(w for *_, w, m in specs if m == "i32")
        if n16:
            words = buf[:, w32:w32 + (n16 + 1) // 2]
            lo = (words << 16) >> 16            # sign-extended low half
            hi = words >> 16
            halves = np.empty((buf.shape[0], 2 * words.shape[1]),
                              np.int32)
            halves[:, 0::2] = lo
            halves[:, 1::2] = hi
        if n8:
            q0 = w32 + (n16 + 1) // 2
            qw = buf[:, q0:q0 + (n8 + 3) // 4]
            quads = np.empty((buf.shape[0], 4 * qw.shape[1]), np.int32)
            quads[:, 0::4] = (qw << 24) >> 24   # sign-extended bytes
            quads[:, 1::4] = (qw << 16) >> 24
            quads[:, 2::4] = (qw << 8) >> 24
            quads[:, 3::4] = qw >> 24
        off16 = off8 = 0
        for k, dt, shape, w, mode in specs:
            if mode == "i32":
                v = np.ascontiguousarray(buf[:, off:off + w])
                off += w
            elif mode == "i8":
                v = np.ascontiguousarray(quads[:, off8:off8 + w])
                off8 += w
            else:
                v = np.ascontiguousarray(halves[:, off16:off16 + w])
                off16 += w
            v = v.reshape((buf.shape[0],) + shape)
            if dt == "float32":
                v = v.view(np.float32)
            elif dt == "bool":
                v = v != 0
            elif mode == "i16":
                # restore clamped invalid-score sentinels
                v = np.where(v == -32768, np.int32(-(2 ** 30)), v)
            out[k] = v
        if "sp_src" in out:
            out = self._unspill(out, self._spill_meta[buf.shape[1]])
        return out

    @staticmethod
    def _unspill(o, meta):
        """Reconstruct dense [2B, Mdev] u_* arrays from the spill D2H
        layout (2 dense head slots + S compacted spill rows)."""
        Mdev, spliced = meta
        src = o.pop("sp_src")                       # [S]
        spw = o.pop("sp_w")                         # [S, 4|5]
        spev = o.pop("sp_ev", None)
        if src.size and src[-1] == -2:
            raise SpillOverflow
        lanes2 = o["u_score"].shape[0]
        Msp = Mdev - 2
        sel = src >= 0
        s2 = src[sel]
        ln = s2 // Msp
        sl = 2 + s2 % Msp

        def full(head, fill, dec):
            a = np.full((lanes2, Mdev), fill, np.int32)
            a[:, :2] = head
            a[ln, sl] = dec
            return a

        w0, w1, w2, w3 = (spw[sel, i] for i in range(4))
        o["u_d1"] = full(o["u_d1"], 0, w0)
        o["u_score"] = full(o["u_score"], -(2 ** 30),
                            ((w1 & 0xFFFF) ^ 0x8000) - 0x8000)
        o["u_flags"] = full(o["u_flags"], 0, (w1 >> 16) & 0x7F)
        o["u_ab"] = full(o["u_ab"], 127, (w1 >> 24) & 0x7F)
        o["u_clip_l"] = full(o["u_clip_l"], 0, w2 & 0xFF)
        o["u_clip_r"] = full(o["u_clip_r"], 0, (w2 >> 8) & 0xFF)
        o["u_n_mm"] = full(o["u_n_mm"], 0, (w2 >> 16) & 0xFF)
        o["u_n_n"] = full(o["u_n_n"], 0, (w2 >> 24) & 0x7F)
        o["u_x"] = full(o["u_x"], 0, w3 & 0xFF)
        if spliced:
            o["u_d2"] = full(o["u_d2"], 0, spw[sel, 4])
        else:
            o["u_dd"] = full(o["u_dd"], 0,
                             (((w3 >> 8) & 0xFF) ^ 0x80) - 0x80)
        if spev is not None:
            o["u_event"] = full(o["u_event"], -1, spev[sel])
        return o

    # ------------------------------------------------------------------
    def _align_device(self, d, params, reads, quals, lens, minsc,
                      rdids=None, ss=None, uniform=False, full_out=True):
        """Device computation for one batch: [B, L] -> candidate dict.

        Lanes 0..B-1 are forward, B..2B-1 reverse-complement.

        NOTE: the index bundle `d` and the `params` dict are jit ARGUMENTS,
        not closures — closed-over device arrays embed as executable
        constants, which the runtime handles ~50x slower per op (see
        ops/rank.py)."""
        meta = d.meta
        B, L = reads.shape
        if uniform:
            # all lens == L: reverse-complement is flip + complement,
            # no take_along_axis gather (XLA reverse = contiguous copy)
            g = reads[:, ::-1]
            rc = jnp.where(g < 4, 3 - g, jnp.int32(4))
            qr = quals[:, ::-1]
        else:
            col = jnp.arange(L, dtype=jnp.int32)[None, :]
            idxr = lens[:, None] - 1 - col
            ok = idxr >= 0
            g = jnp.take_along_axis(reads, jnp.maximum(idxr, 0), axis=1)
            rc = jnp.where(ok & (g < 4), 3 - g, jnp.int32(4))
            qr = jnp.where(ok, jnp.take_along_axis(
                quals, jnp.maximum(idxr, 0), axis=1), 0)
        ar = jnp.concatenate([reads, rc]).astype(jnp.int32)
        aq = jnp.concatenate([quals, qr]).astype(jnp.int32)
        al = jnp.concatenate([lens, lens]).astype(jnp.int32)
        am = jnp.concatenate([minsc, minsc]).astype(jnp.int32)

        # enough hit slots for anchor-stop segmentation: unique anchors
        # close every min_k+12 bp (hi_aligner.h:5603)
        H = max(self.max_hits, L // (self.min_k + 12) + 2)
        if getattr(d, "ftab2_top", None) is not None:
            # bigram double-step scan: two chars per gathered row, ~1.7x
            # on the search's while-loop (PERF.md; bit-identical events)
            hits = search_ops.partial_search2(
                d.blocked, d.fchr, d.ftab2_top, meta.zrow, meta.zrow2,
                meta.rows, ar, al, H, self.min_hit_len, self.min_k,
                uniform=uniform, anchor_stop=self.anchor_stop)
        else:
            hits = search_ops.partial_search(
                d.blocked, d.fchr, meta.zrow, meta.rows, ar, al,
                H, self.min_hit_len, self.min_k, uniform=uniform,
                anchor_stop=self.anchor_stop)

        P = self.cand_per_hit
        w = hits.bot - hits.top                                   # [2B, H]
        hv = jnp.arange(H, dtype=jnp.int32)[None, :] < hits.nh[:, None]
        # row-count gates: align-path hits resolve at most max(khits,kseeds)
        # rows (getAnchorHits skips wider hits entirely, hi_aligner.h:4348);
        # short re-search segments resolve only when nelt <= 5
        # (spliced_aligner.h:951)
        islong_h = (hits.hi - hits.lo) > self.min_k + 2
        maxsize = max(self.k, self.max_seeds)
        lite_wide = None
        if self.lite:
            # tier A resolves at most lite_cap rows per hit and only
            # align-capable (long) hits; hits wider than lite_cap but
            # narrow enough for the FULL pass to represent (<= its
            # max(k, max_seeds) row gate) flag h_sat and re-run — hits
            # wider than BOTH passes' gates resolve in neither, so they
            # need no routing
            full_max = maxsize
            maxsize = min(maxsize, self.lite_cap)
            lite_wide = jnp.any(hv & islong_h & (w > maxsize)
                                & (w <= full_max), axis=1)
            # lane meta (h_minw for the paired give-up replay) must see
            # the FULL pass's hit-visibility gates, not lite's
            hv_meta = hv & jnp.where(islong_h, w <= full_max,
                                     w <= self.short_rows)
            hv &= islong_h
        hv &= jnp.where(islong_h, w <= maxsize, w <= self.short_rows)
        P = max(P, self.short_rows, self.msize)
        j = jnp.arange(P, dtype=jnp.int32)
        cval = hv[:, :, None] & (j[None, None, :] < w[:, :, None])
        offs = resolve_ops.resolve_consecutive(
            d.blocked, d.fchr, d.mark_words, d.mark_chk,
            d.sa_marked, meta.zrow, meta.off_rate,
            jnp.where(hv, hits.top, 0), P, live=cval)             # [2B,H,P]
        lo = hits.lo[:, :, None]                                  # [2B,H,1]
        starts = (offs - lo).reshape(2 * B, H * P)
        cv = cval.reshape(2 * B, H * P)
        HP2 = 0
        if self.spliced:
            # prefix RE-SEARCH: the reference re-searches the uncovered
            # read prefix from scratch (local/global GFM search with
            # extoff anchored at the candidate's extended rdoff,
            # spliced_aligner.h:700-760) — its segments OVERLAP the chars
            # the chimeric global walk consumed past a junction, so the
            # flank's diagonal resolves even when the one-pass search left
            # fewer than min_hit_len clean chars.  Cut = lo of the
            # second-to-last recorded hit (the char below it was skipped).
            i2 = jnp.maximum(hits.nh - 2, 0)[:, None]
            cut = compact_ops.take_cols(hits.lo, i2)[:, 0]
            cut = jnp.where(hits.nh >= 2, cut, 0).astype(jnp.int32)
            # extension-aware cut (the reference's hybridSearch searches
            # the span its anchor EXTENSION leaves uncovered in the local
            # index, spliced_aligner.h:736 — not the raw segment bounds):
            # when a junction-boundary char was consumed into a chimeric
            # segment, the raw cut misses the true flank.  Take the first
            # align-capable width-1 hit's diagonal, find the leftmost
            # column of its clean suffix run, and tighten the cut to it.
            anchor_ok = (w == 1) & ((hits.hi - hits.lo) > self.min_k + 2)
            first_a = jnp.argmax(anchor_ok, axis=1)            # [2B]
            have_a = jnp.any(anchor_ok, axis=1)
            starts3 = starts[:, :H * P].reshape(2 * B, H, P)
            d0 = jnp.take_along_axis(
                starts3[:, :, 0], first_a[:, None], axis=1)[:, 0]
            rc0 = rk.ref_chars_block(d.ref_words, meta.n, d0[:, None],
                                     L)[:, 0, :]
            colL = jnp.arange(L, dtype=jnp.int32)[None, :]
            inl = colL < al[:, None]
            mm0 = inl & ((ar != jnp.minimum(rc0, 3)) | (ar > 3)
                         | (rc0 > 3))
            any0 = jnp.any(mm0, axis=1)
            last0 = (L - 1) - jnp.argmax(mm0[:, ::-1], axis=1)
            cut_ext = jnp.where(have_a & any0, last0 + 1,
                                jnp.int32(2 ** 30))
            cut = jnp.minimum(cut, cut_ext).astype(jnp.int32)
            H2 = 2
            # most lanes have no uncovered prefix to re-search: run the
            # scan over only the lanes whose cut can yield a hit
            # (search_lanes_live compacts + chunks; zeros elsewhere)
            if getattr(d, "ftab2_top", None) is not None:
                fn2 = lambda rr, ll: search_ops.partial_search2(  # noqa: E731
                    d.blocked, d.fchr, d.ftab2_top, meta.zrow,
                    meta.zrow2, meta.rows, rr, ll, H2,
                    self.min_hit_len, self.min_k)
            else:
                fn2 = lambda rr, ll: search_ops.partial_search(  # noqa: E731
                    d.blocked, d.fchr, meta.zrow, meta.rows, rr,
                    ll, H2, self.min_hit_len, self.min_k)
            hits2 = search_ops.search_lanes_live(
                fn2, ar, cut, self.min_hit_len)
            w2 = hits2.bot - hits2.top
            hv2 = jnp.arange(H2, dtype=jnp.int32)[None, :] \
                < hits2.nh[:, None]
            # a short flank can be globally frequent yet unique within the
            # reference's 57 kb local window — resolve more rows here (the
            # proximity filter below keeps only window-local ones).  Full-SA
            # indexes resolve rows with a plain gather, so the wider cap is
            # cheap; sampled-SA indexes keep the narrow cap (each row costs
            # an LF walk).
            P2 = 32 if self.meta.off_rate == 0 else self.short_rows
            hv2 &= w2 <= P2
            j2 = jnp.arange(P2, dtype=jnp.int32)
            cval2 = hv2[:, :, None] & (j2[None, None, :] < w2[:, :, None])
            offs2 = resolve_ops.resolve_consecutive(
                d.blocked, d.fchr, d.mark_words, d.mark_chk,
                d.sa_marked, meta.zrow, meta.off_rate,
                jnp.where(hv2, hits2.top, 0), P2, live=cval2)
            starts2 = (offs2
                       - hits2.lo[:, :, None]).reshape(2 * B, H2 * P2)
            cv2 = cval2.reshape(2 * B, H2 * P2)
            HP2 = H2 * P2
            starts = jnp.concatenate([starts, starts2], axis=1)
            cv = jnp.concatenate([cv, cv2], axis=1)
        # device-side dedup + compaction: different anchors of the same read
        # resolve to the same genome start, so most of the H*P slots are
        # duplicates or invalid.  Sort per lane, mark uniques, compact the
        # unique starts into the first C slots — the extension then runs on
        # a 16/C-times smaller candidate matrix.
        # align-path eligibility per slot (getAnchorHits, hi_aligner.h:
        # 4341-4351): hits longer than minK+2 only; after an anchor stop
        # the search is mid-read, so only width-1 hits resolve (max_size=1)
        BIG = np.int32(2**30)
        SHORTBIT = np.int32(2**30)
        hlen = (hits.hi - hits.lo)[:, :, None]                    # [2B,H,1]
        hlen_flat = jnp.broadcast_to(
            hlen, (2 * B, H, P)).reshape(2 * B, H * P)
        w_flat = jnp.broadcast_to(
            w[:, :, None], (2 * B, H, P)).reshape(2 * B, H * P)
        align_slot = (hlen_flat > self.min_k + 2) \
            & ((w_flat == 1) | ~hits.stopped[:, None])
        if HP2:
            # re-search rows are sweep-only flank candidates
            align_slot = jnp.concatenate(
                [align_slot, jnp.zeros((2 * B, HP2), bool)], axis=1)
        if self.spliced:
            # local-search proximity: a short flank resolves only where it
            # lies within intron range of an align-capable diagonal (the
            # reference searches the remaining span in the 57kb local
            # index AROUND the anchor, spliced_aligner.h:700-736)
            lkey = jnp.where(cv & align_slot, starts,
                             np.int32(2 ** 31 - 2))
            lsort = jnp.sort(lkey, axis=1)[:, :8]
            adist = jnp.abs(starts[:, :, None]
                            - lsort[:, None, :]).min(axis=2)
            near = adist <= self.scoring.max_intron_len
            cv &= align_slot | near
        # compaction key: align-capable candidates claim slots first
        # (sweep-only short/wide anchors must not crowd out real diagonals)
        is_short = ~align_slot
        SENT = np.int32(2 ** 31 - 2)
        ident = jnp.where(cv, starts + jnp.where(is_short, SHORTBIT, 0),
                          SENT)
        if self.spliced:
            # sweep-only slots rank by distance to the nearest
            # align-capable diagonal, NOT by absolute position: the
            # reference's local search produces only window-local
            # diagonals (hgfm.h:1553+ local index around the anchor), so
            # when short-segment rows outnumber the candidate slots the
            # window-local ones — the only ones the junction sweep can
            # join — must claim the slots first
            skey = jnp.where(cv, jnp.where(
                is_short, SHORTBIT + jnp.minimum(adist, SHORTBIT - 1),
                starts), SENT)
        else:
            skey = ident
        # keep the first occurrence of each distinct diagonal, compacted
        # in ascending (skey, slot) order — same result as a
        # sort+argsort+gather chain, but as masked reductions (see
        # ops/compact.py; which form pays on the H100 is ROADMAP C2)
        Jk = ident.shape[1]
        kj = ident[:, :, None]                                # [2B, J, 1]
        kk = ident[:, None, :]                                # [2B, 1, J]
        tril = np.tril(np.ones((Jk, Jk), bool), -1)[None]     # k < j
        kept = (ident != SENT) & ~jnp.any((kk == kj) & tril, axis=2)
        sj = skey[:, :, None]
        sk = skey[:, None, :]
        krank = jnp.where(
            kept,
            (((sk < sj) | ((sk == sj) & tril)) & kept[:, None, :]
             ).sum(axis=2, dtype=jnp.int32),
            np.int32(Jk))
        C = self.max_cands
        csel = (krank[:, None, :]
                == jnp.arange(C, dtype=jnp.int32)[None, :, None]) \
            & kept[:, None, :]
        cvalid = jnp.any(csel, axis=2)
        cstart = compact_ops.select_ranked(csel, starts)
        cshort = compact_ops.select_ranked(csel, is_short)
        # a diagonal present as both long and short keeps only the long slot
        dup_short = cshort & jnp.any(
            (cstart[:, :, None] == cstart[:, None, :])
            & ~cshort[:, None, :] & cvalid[:, None, :], axis=2)
        cvalid &= ~dup_short
        # provenance per compact candidate: min "actual rounds before"
        # (search-budget replay) and post-anchor-stop flag
        ab_flat = jnp.broadcast_to(
            hits.abefore[:, :, None], (2 * B, H, P)).reshape(2 * B, H * P)
        post_flat = jnp.broadcast_to(
            hits.post[:, :, None], (2 * B, H, P)).reshape(2 * B, H * P)
        if HP2:
            # the re-search runs inside the source candidate's recursion:
            # inherit the lane's last-hit provenance
            ilast = jnp.maximum(hits.nh - 1, 0)[:, None]
            ab2 = compact_ops.take_cols(hits.abefore, ilast)
            po2 = compact_ops.take_cols(hits.post, ilast)
            ab_flat = jnp.concatenate(
                [ab_flat, jnp.broadcast_to(ab2, (2 * B, HP2))], axis=1)
            post_flat = jnp.concatenate(
                [post_flat, jnp.broadcast_to(po2, (2 * B, HP2))], axis=1)
        same = cstart[:, :, None] == starts[:, None, :]           # [2B,C,HP]
        same &= cv[:, None, :]
        cab = jnp.where(same, ab_flat[:, None, :], BIG).min(axis=2)
        cpost = ~jnp.any(same & ~post_flat[:, None, :], axis=2)
        # sweep-only candidates (short or wide-while-stopped) never become
        # ungapped alignments themselves
        cvalid_long = cvalid & jnp.any(same & align_slot[:, None, :], axis=2)
        # split the compacted pool: the first core_cands slots get the
        # full plane/junction-sweep treatment; the remaining slots exist
        # only so >k equal-score multimap placements all enter the RNG
        # report pool (selectByScore semantics) — they need ungapped
        # extension scores, nothing else
        CC = min(self.core_cands, cstart.shape[1])
        xstart, xvalid = cstart[:, CC:], cvalid_long[:, CC:]
        xab, xpost = cab[:, CC:], cpost[:, CC:]
        cstart, cvalid = cstart[:, :CC], cvalid[:, :CC]
        cab, cpost = cab[:, :CC], cpost[:, :CC]
        cvalid_long = cvalid_long[:, :CC]
        # ONE diagonal ref-char gather serves the penalty planes, the
        # junction sweep windows, and the ungapped extension: the sweep
        # window [start - margin, start + L + margin) is a superset of the
        # extension's [start, start + L)
        sp = self.splice_params
        g_budget = max(1, (-int(self.scoring.min_score(L))
                           - min(sp.rd_gap_open, sp.rf_gap_open))
                       // max(min(sp.rd_gap_ext, sp.rf_gap_ext), 1))
        g_budget = min(g_budget, sp.min_intron - 1)
        margin = max(16, g_budget)
        mstart = jnp.where(cvalid, cstart, -1)
        ch = splice_ops.diag_chars(d.ref_words, meta.n, mstart, L, margin)
        snv1_w = snv2_w = None
        if self.graph is not None:
            snv1_w = splice_ops.diag_chars(params["snv1"], meta.n,
                                           mstart, L, margin)
            snv2_w = splice_ops.diag_chars(params["snv2"], meta.n,
                                           mstart, L, margin)
        planes = extend_ops.pen_planes(
            d.ref_words, meta.n, ar, aq, al,
            mstart, params["mm_pen"],
            self.scoring.n_pen,
            snv_delta1=params["snv1"] if self.graph is not None else None,
            snv_delta2=params["snv2"] if self.graph is not None else None,
            win_chars=ch, win_margin=margin,
            snv1_win=snv1_w, snv2_win=snv2_w)
        ext = extend_ops.extend_grouped(
            d.ref_words, meta.n, ar, aq, al,
            jnp.where(cvalid, cstart, -1), params["mm_pen"],
            params["clip_pen"], self.scoring.n_pen,
            allow_softclip=not self.scoring.no_softclip,
            planes=planes, uniform_len=uniform,
            minsc=am, mm_min=self.scoring.mm_min)
        # per-lane search metadata for the paired give-up replay (the
        # interleaved nextBWT/align simulation in align/replay.py):
        # round log, round count, align() verdict ingredients
        if xstart.shape[1]:
            planes_x = extend_ops.pen_planes(
                d.ref_words, meta.n, ar, aq, al,
                jnp.where(xvalid, xstart, -1), params["mm_pen"],
                self.scoring.n_pen,
                snv_delta1=(params["snv1"] if self.graph is not None
                            else None),
                snv_delta2=(params["snv2"] if self.graph is not None
                            else None))
            ext_x = extend_ops.extend_grouped(
                d.ref_words, meta.n, ar, aq, al,
                jnp.where(xvalid, xstart, -1), params["mm_pen"],
                params["clip_pen"], self.scoring.n_pen,
                allow_softclip=not self.scoring.no_softclip,
                planes=planes_x, uniform_len=uniform,
                minsc=am, mm_min=self.scoring.mm_min)
        else:
            ext_x = None
        wpos = jnp.where((hv_meta if self.lite else hv) & (w > 0), w,
                         jnp.int32(2 ** 30))
        lane_minw = wpos.min(axis=1)                            # [2B]
        lane_alignable = jnp.any(align_slot, axis=1)
        out = {"starts": cstart, "score": ext.score, "n_mm": ext.n_mm,
               "n_n": ext.n_n, "clip_l": ext.clip_l, "clip_r": ext.clip_r,
               "valid": cvalid_long & ext.ok,
               "ab": cab, "post": cpost}
        if self.lite:
            # per-lane saturation: distinct align-capable diagonals (sums
            # across shards at merge) + 64 when a hit was wider than
            # lite_cap — either way the read re-runs through the full pass
            n_long = (kept & ~is_short).sum(axis=1, dtype=jnp.int32)
            out["h_sat"] = (jnp.minimum(n_long, 63)
                            + 64 * lite_wide.astype(jnp.int32))
        if self.lane_meta:
            # per-lane search round logs: only the paired give-up replay
            # reads these (don't ship them for unpaired runs)
            out.update({"h_rounds": hits.rounds, "h_rn": hits.nrounds,
                        "h_minw": lane_minw,
                        "h_alignable": lane_alignable,
                        "h_stop": hits.stopped})
        # --- junction candidates: novel sweep + event injections ---
        # (g_budget: static gap bound from the longest read's score budget —
        # a gap of size g costs open + ext*g, which must stay within -minsc;
        # gaps of min_intron or more are introns, not indels)
        if sp.allow_spliced:
            # the O(C^2) diagonal-pair sweep is needed only for splice
            # joins; DNA indel geometry is fully covered by the
            # self-sweep's wide rows below (same shifted-window planes)
            res = splice_ops.pair_sweep(
                ch, planes.pen_raw, planes.pen, planes.mm_raw,
                cstart, cvalid, al, am,
                (params["tab_donor"], params["tab_acc1"],
                 params["tab_acc2"]),
                self.splice_params, max_gap=g_budget)
            sel = splice_ops.select_pairs(res, cstart, top=self.max_pairs)
            T0 = self.max_pairs
            sel["ab"] = jnp.maximum(
                compact_ops.take_cols(cab, sel["i"]),
                compact_ops.take_cols(cab, sel["j"]))
            sel["post"] = compact_ops.take_cols(cpost, sel["i"]) \
                & compact_ops.take_cols(cpost, sel["j"])
            blocks = [dict(sel, known=jnp.zeros((2 * B, T0), jnp.int32),
                           event=jnp.full((2 * B, T0), -1, jnp.int32),
                           selfgap=jnp.zeros((2 * B, T0), jnp.int32))]
        else:
            blocks = []
        if self.use_ss or self.has_indels:
            C = cstart.shape[1]
            zero3 = jnp.zeros((2 * B, C, 1), jnp.int32)
            al3 = jnp.broadcast_to(al[:, None, None], (2 * B, C, 1))
            P_raw = jnp.concatenate(
                [zero3, jnp.cumsum(planes.pen_raw, axis=2)], axis=2)
            tot_raw = jnp.take_along_axis(P_raw, al3, axis=2)[:, :, 0]
        if self.use_ss:
            # known/temp splice-site injection (SNV-forgiving source
            # prefixes: a catalog SNV inside the source exon piece is a
            # zero-cost snpID edit in the reference's combine)
            rd2 = jnp.concatenate([rdids, rdids]).astype(jnp.int32)
            Pm = jnp.concatenate(
                [zero3, jnp.cumsum(planes.mm_raw.astype(jnp.int32), axis=2)],
                axis=2)
            tot_m = jnp.take_along_axis(Pm, al3, axis=2)[:, :, 0]
            P_fg = jnp.concatenate(
                [zero3, jnp.cumsum(planes.pen, axis=2)], axis=2)
            tot_fg = jnp.take_along_axis(P_fg, al3, axis=2)[:, :, 0]
            inj = splice_ops.inject_known(
                d.ref_words, meta.n, ar, aq, al, rd2,
                cstart, cvalid, P_fg, tot_fg, Pm, tot_m,
                ss["ss_kd"], ss["ss_ka"], ss["ss_rdid"],
                ss["ss_ka_s"], ss["ss_kd_s"], ss["ss_rdid_a"],
                params["mm_pen"], self.scoring.n_pen, am,
                slots=self.ss_slots,
                src_clip_l=ext.clip_l, src_clip_r=ext.clip_r,
                clip_pen=params["clip_pen"],
                snv_delta1=params.get("snv1"),
                snv_delta2=params.get("snv2"),
                kd_lob=ss.get("ss_kd_lob"), ka_lob=ss.get("ss_ka_lob"),
                ss_shift=ss.get("ss_shift"))
            J = inj["score"].shape[1]
            src_i = inj.pop("src")
            inj["ab"] = compact_ops.take_cols(cab, src_i)
            inj["post"] = compact_ops.take_cols(cpost, src_i)
            blocks.append(dict(inj, known=jnp.ones((2 * B, J), jnp.int32),
                               event=jnp.full((2 * B, J), -1, jnp.int32),
                               selfgap=jnp.zeros((2 * B, J), jnp.int32)))
        if self.has_indels and not self.lite:
            # known ALT indel injection
            P_snv = jnp.concatenate(
                [zero3, jnp.cumsum(planes.pen, axis=2)], axis=2)
            tot_snv = jnp.take_along_axis(P_snv, al3, axis=2)[:, :, 0]
            injd = splice_ops.inject_indels(
                d.ref_words, meta.n, ar, aq, al,
                cstart, cvalid, P_snv, tot_snv,
                params["ind_ip"], params["ind_len"], params["ind_chars"],
                params["ind_rkey"], params["ind_rlen"], params["ind_rrow"],
                params["mm_pen"], self.scoring.n_pen, am,
                snv_delta1=params["snv1"], snv_delta2=params["snv2"],
                slots=self.ss_slots)
            Ji = injd["score"].shape[1]
            src_i = injd.pop("src")
            injd["ab"] = compact_ops.take_cols(cab, src_i)
            injd["post"] = compact_ops.take_cols(cpost, src_i)
            blocks.append(dict(injd,
                               known=jnp.ones((2 * B, Ji), jnp.int32),
                               selfgap=jnp.zeros((2 * B, Ji), jnp.int32)))
        # single-anchor small-gap sweep: novel indels whose short flank has
        # no global FM anchor (the partial search walks through the gap and
        # lands on a chimeric diagonal; the reference re-searches the span
        # in its 57kb local index, spliced_aligner.h:736)
        if not self.lite:
            selfw = splice_ops.self_indel_sweep(
                ch, ar, aq, al, cstart, cvalid, am, params["mm_pen"],
                self.scoring.n_pen, self.splice_params,
                snv1_w=snv1_w, snv2_w=snv2_w, max_gap=g_budget)
            src_i = selfw.pop("src")
            Cs = cstart.shape[1]
            sab = compact_ops.take_cols(cab, src_i)
            spost = compact_ops.take_cols(cpost, src_i)
            strict = {k2: selfw[k2] for k2 in
                      ("score", "d1", "d2", "x", "kind", "spldir",
                       "splscore")}
            blocks.append(dict(strict, ab=sab, post=spost,
                               known=jnp.zeros((2 * B, Cs), jnp.int32),
                               event=jnp.full((2 * B, Cs), -1, jnp.int32),
                               selfgap=jnp.ones((2 * B, Cs), jnp.int32)))
            if not sp.allow_spliced:
                # wide rows: both diagonals must be live candidates (the
                # pair_sweep / combineWith two-FM-anchor geometry, not
                # subject to the local-search flank floor or best-score
                # suppression)
                other_d = selfw["w_d1"] + selfw["w_d2"] - cstart
                eqm = (other_d[:, :, None]
                       == jnp.where(cvalid, cstart, -1)[:, None, :])
                pair_eq = jnp.any(eqm, axis=2)
                # the pair inherits the LATER anchor's search round (the
                # budget-replay gate uses max(ab_i, ab_j), like the pair
                # block)
                oidx = jnp.argmax(eqm, axis=2).astype(jnp.int32)
                wab = jnp.maximum(sab, jnp.where(
                    pair_eq, compact_ops.take_cols(cab, oidx), 0))
                wpost = spost & jnp.where(
                    pair_eq, compact_ops.take_cols(cpost, oidx), True)
                wsc = jnp.where(pair_eq, selfw["w_score"],
                                -splice_ops._BIG)
                wide = {"score": wsc, "d1": selfw["w_d1"],
                        "d2": selfw["w_d2"], "x": selfw["w_x"],
                        "kind": jnp.where(pair_eq, selfw["w_kind"], 0),
                        "spldir": selfw["w_spldir"],
                        "splscore": selfw["w_splscore"]}
                blocks.append(dict(
                    wide, ab=wab, post=wpost,
                    known=jnp.zeros((2 * B, Cs), jnp.int32),
                    event=jnp.full((2 * B, Cs), -1, jnp.int32),
                    selfgap=jnp.zeros((2 * B, Cs), jnp.int32)))
        # (splscore is consumed on-device only - not shipped to the host)
        # --- unified slot compaction: merge the ungapped candidates and
        # every junction block into ONE per-slot schema, keep each lane's
        # M best (valid-first, score-desc, stable) slots, and ship only
        # those.  D2H bytes and the host phase both scale with slot count;
        # lanes rarely carry more than a few real candidates.
        # (event rows exist only for known ALT indels: the plane is
        # omitted on indel-free indexes; the host defaults it to -1.)
        Cb = cstart.shape[1]
        BIGs = np.int32(2 ** 30)
        z_b = jnp.zeros((2 * B, Cb), jnp.int32)
        uni = {"score": ext.score, "d1": cstart, "d2": cstart,
               "x": z_b, "kind": z_b, "spldir": z_b, "known": z_b,
               "ab": cab, "post": cpost.astype(jnp.int32),
               "selfgap": z_b, "n_mm": ext.n_mm, "n_n": ext.n_n,
               "clip_l": ext.clip_l, "clip_r": ext.clip_r,
               "alt": ext.alt_score,
               "valid": (cvalid_long & ext.ok).astype(jnp.int32)}
        if self.has_indels:
            uni["event"] = jnp.full((2 * B, Cb), -1, jnp.int32)
        if ext_x is not None:
            Xq = xstart.shape[1]
            zx = jnp.zeros((2 * B, Xq), jnp.int32)
            blocks.append(dict(
                score=jnp.where(xvalid & ext_x.ok, ext_x.score,
                                -splice_ops._BIG),
                d1=xstart, d2=xstart, x=zx, kind=zx, spldir=zx,
                known=zx, ab=xab, post=xpost.astype(jnp.int32),
                selfgap=zx,
                n_mm=ext_x.n_mm, n_n=ext_x.n_n,
                clip_l=ext_x.clip_l, clip_r=ext_x.clip_r,
                alt=ext_x.alt_score,
                event=jnp.full((2 * B, Xq), -1, jnp.int32)))
        for b in blocks:
            W2 = b["score"].shape[1]
            zw = jnp.zeros((2 * B, W2), jnp.int32)
            uni = {
                "score": jnp.concatenate([uni["score"], b["score"]], 1),
                "d1": jnp.concatenate([uni["d1"], b["d1"]], 1),
                "d2": jnp.concatenate([uni["d2"], b["d2"]], 1),
                "x": jnp.concatenate([uni["x"], b["x"]], 1),
                "kind": jnp.concatenate([uni["kind"], b["kind"]], 1),
                "spldir": jnp.concatenate([uni["spldir"],
                                           b["spldir"]], 1),
                "known": jnp.concatenate([uni["known"], b["known"]], 1),
                "ab": jnp.concatenate([uni["ab"], b["ab"]], 1),
                "post": jnp.concatenate(
                    [uni["post"], b["post"].astype(jnp.int32)], 1),
                "selfgap": jnp.concatenate([uni["selfgap"],
                                            b["selfgap"]], 1),
                "n_mm": jnp.concatenate(
                    [uni["n_mm"], b.get("n_mm", zw)], 1),
                "n_n": jnp.concatenate(
                    [uni["n_n"], b.get("n_n", zw)], 1),
                "clip_l": jnp.concatenate(
                    [uni["clip_l"], b.get("clip_l", zw)], 1),
                "clip_r": jnp.concatenate(
                    [uni["clip_r"], b.get("clip_r", zw)], 1),
                "alt": jnp.concatenate(
                    [uni["alt"],
                     b.get("alt", zw + np.int32(extend_ops.NO_ALT))], 1),
                "valid": jnp.concatenate(
                    [uni["valid"],
                     (b["score"] > -BIGs).astype(jnp.int32)], 1),
                **({"event": jnp.concatenate([uni["event"],
                                              b["event"]], 1)}
                   if self.has_indels else {}),
            }
        Ktot = uni["score"].shape[1]
        # host-side column compaction keeps M=10 (valid-first, score-desc)
        # slots with the SAME ordering key, so truncating to 10 on device
        # is lossless
        Mdev = min(Ktot, max(10, self.msize + 2))
        use_spill = (not full_out) and Mdev > 2
        if Mdev < Ktot or use_spill:
            skey = jnp.where(uni["valid"] > 0, -uni["score"],
                             np.int32(2 ** 31 - 1))
            # stable top-Mdev by (valid desc, score desc) without the
            # argsort + per-field gather chain: one masked reduction that
            # fuses across fields (ROADMAP C2)
            mrank = compact_ops.stable_rank_asc(skey)
            msel = (mrank[:, None, :]
                    == jnp.arange(Mdev, dtype=jnp.int32)[None, :, None])
            uni = {k2: compact_ops.select_ranked(msel, v2)
                   for k2, v2 in uni.items()}
        # D2H shrink: the trimmed-representation alt score is consumed
        # only for a lane's BEST candidate (the host zsalt gate fires for
        # a read's sole best only; equal-score multimaps get their ZS
        # from the second placement instead) — ship one i16 per lane,
        # not per slot
        bslot = jnp.argmax(jnp.where(uni["valid"] > 0, uni["score"],
                                     np.int32(-2 ** 30)), axis=1)
        uni["alt"] = compact_ops.take_cols(uni["alt"], bslot[:, None])
        # D2H shrink: 4 single-bit fields + the (kind, spldir) pair pack
        # into one byte per slot; spldir is only ever nonzero for splice
        # joins, so the pair has 8 reachable values (3 bits)
        cs = jnp.where(uni["spldir"] > 0, 3 + uni["spldir"], uni["kind"])
        uni["flags"] = (uni["valid"] | (uni["post"] << 1)
                        | (uni["selfgap"] << 2) | (uni["known"] << 3)
                        | (cs << 4))
        for k2 in ("valid", "post", "selfgap", "known", "kind", "spldir"):
            del uni[k2]
        if not sp.allow_spliced and not self.use_ss:
            # DNA mode: |d2 - d1| <= max(gap budget, ALT indel len < 20),
            # so the second diagonal ships as a byte delta (ss injection
            # produces full-size introns — those keep the wide layout)
            uni["dd"] = uni["d2"] - uni["d1"]
            del uni["d2"]
        if use_spill:
            # SPILL D2H layout: slots are valid-first/score-desc and only
            # a few % are valid on real corpora — ship slots 0-1 dense
            # and compact the remaining valid slots into S = 2B spill
            # rows of 4 packed words (+1 word on graph indexes for the
            # ALT-event row).  An overflow (multimap-saturated batch,
            # > S valid spill slots) is flagged in the last sp_src row
            # and the host re-runs the batch with full_out=True.
            Msp = Mdev - 2
            S = 2 * B
            spmask = (uni["flags"][:, 2:] & 1) > 0
            flatm = spmask.reshape(-1)
            fidx = jnp.arange(2 * B * Msp, dtype=jnp.int32)
            BIGI = np.int32(2 ** 30)
            src = jnp.sort(jnp.where(flatm, fidx, BIGI))
            src = src[:S] if src.shape[0] >= S else jnp.concatenate(
                [src, jnp.full(S - src.shape[0], BIGI, jnp.int32)])
            n_sp = flatm.sum()
            src = jnp.where(src >= BIGI, np.int32(-1), src)
            src = src.at[S - 1].set(
                jnp.where(n_sp > S, np.int32(-2), src[S - 1]))
            g = jnp.maximum(src, 0)
            tk = lambda a: a[:, 2:].reshape(-1)[g]  # noqa: E731
            sc16 = jnp.clip(uni["score"], -32768, 32767)
            w0 = tk(uni["d1"])
            w1 = (tk(sc16) & 0xFFFF) \
                | ((tk(uni["flags"]) & 0x7F) << 16) \
                | (jnp.clip(tk(uni["ab"]), 0, 127) << 24)
            w2 = (jnp.clip(tk(uni["clip_l"]), 0, 255) & 0xFF) \
                | ((jnp.clip(tk(uni["clip_r"]), 0, 255) & 0xFF) << 8) \
                | ((jnp.clip(tk(uni["n_mm"]), 0, 255) & 0xFF) << 16) \
                | (jnp.clip(tk(uni["n_n"]), 0, 127) << 24)
            if sp.allow_spliced or self.use_ss:
                # spliced/ss-injecting slots carry a full second diagonal
                # instead of the byte delta
                w3 = jnp.clip(tk(uni["x"]), 0, 255) & 0xFF
                words = [w0, w1, w2, w3, tk(uni["d2"])]
            else:
                w3 = (jnp.clip(tk(uni["x"]), 0, 255) & 0xFF) \
                    | ((tk(uni["dd"]) & 0xFF) << 8)
                words = [w0, w1, w2, w3]
            out["sp_src"] = src
            out["sp_w"] = jnp.stack(words, axis=1)
            if "event" in uni:
                out["sp_ev"] = tk(uni["event"])
            self._traced_spill_mdev = (Mdev,
                                       bool(sp.allow_spliced
                                            or self.use_ss))
            for k2 in list(uni):
                if k2 != "alt":
                    uni[k2] = uni[k2][:, :2]
        for k2, v2 in uni.items():
            out["u_" + k2] = v2
        # the base-block per-slot fields are superseded by the unified set
        for k2 in ("starts", "score", "n_mm", "n_n", "clip_l", "clip_r",
                   "valid", "ab", "post"):
            del out[k2]
        if self.spliced:
            # second junction (multi-exon reads): composite sweep off the
            # best UNGATED junction candidate (its unfixed tail's penalties
            # are recoverable by the second junction), restricted to pairs
            # whose diagonals both have planes
            Cc = cstart.shape[1]
            rawf = res.raw.reshape(2 * B, Cc * Cc)
            # top-2 base pairs: with 4 short exons every pair carries
            # heavy unexplained-tail penalties and the raw argmax can
            # land on a non-adjacent pair whose sides cannot be
            # recovered; the runner-up (usually an adjacent-exon pair)
            # gets its own second sweep (the reference explores pairs
            # recursively, hybridSearch_recur)
            for pfx2, pfx3 in (("q2_", "q3_"), ("r2_", "r3_")):
                bsel = jnp.argmax(rawf, axis=1)
                if pfx2 == "q2_":
                    rawf = jnp.where(
                        jnp.arange(Cc * Cc, dtype=jnp.int32)[None, :]
                        == bsel[:, None], np.int32(-(2 ** 30)), rawf)
                b_i = (bsel // Cc).astype(jnp.int32)
                b_j = (bsel % Cc).astype(jnp.int32)
                gpair = lambda a: jnp.take_along_axis(  # noqa: E731
                    a.reshape(2 * B, Cc * Cc), bsel[:, None], axis=1)[:, 0]
                b_score = gpair(res.raw)
                b_x = gpair(res.x)
                b_kind = gpair(res.kind)
                b_d1 = compact_ops.take_cols(cstart, b_i[:, None])[:, 0]
                b_d2 = compact_ops.take_cols(cstart, b_j[:, None])[:, 0]
                b_ok = (b_score > -(2 ** 29)) \
                    & (b_kind != splice_ops.KIND_NONE)
                q2 = splice_ops.second_sweep(
                    ch, planes.pen_raw, planes.mm_raw, cstart, cvalid,
                    al, am,
                    (params["tab_donor"], params["tab_acc1"],
                     params["tab_acc2"]),
                    self.splice_params, b_i, b_j, b_x, b_score, b_ok,
                    ss=ss, rdids=rd2)
                # 3-junction composite: the PER-SIDE minsc-gated results
                # miss reads whose left and right extra junctions only
                # reach minsc TOGETHER (4 short exons); the side scores
                # share the base pair's full-read penalties and act on
                # disjoint read regions, so total = left_u + right_u -
                # base (hybridSearch_recur depth-3)
                BIGs2 = np.int32(2 ** 29)
                lu, ru = q2["left"], q2["right"]
                q3_sc = (lu["uscore"] + ru["uscore"] - b_score).astype(
                    jnp.int32)
                q3_ok = (lu["uscore"] > -BIGs2) & (ru["uscore"] > -BIGs2) \
                    & b_ok & (q3_sc >= am)
                q3_sc = jnp.where(q3_ok, q3_sc, -(2 ** 30))
                out.update({
                    pfx2 + "score": jnp.stack([q2["right"]["score"],
                                               q2["left"]["score"]],
                                              axis=1),
                    pfx2 + "d": jnp.stack([q2["right"]["d"],
                                           q2["left"]["d"]], axis=1),
                    pfx2 + "x": jnp.stack([q2["right"]["x"],
                                           q2["left"]["x"]], axis=1),
                    pfx2 + "dir": jnp.stack([q2["right"]["dir"],
                                             q2["left"]["dir"]], axis=1),
                    pfx2 + "bd1": b_d1, pfx2 + "bd2": b_d2,
                    pfx2 + "bx": b_x, pfx2 + "bkind": b_kind,
                    pfx2 + "bdir": gpair(res.spldir),
                    pfx2 + "bknown": jnp.zeros(2 * B, jnp.int32),
                    pfx3 + "score": q3_sc,
                    pfx3 + "ld": lu["ud"], pfx3 + "lx": lu["ux"],
                    pfx3 + "ldir": lu["udir"],
                    pfx3 + "rd": ru["ud"], pfx3 + "rx": ru["ux"],
                    pfx3 + "rdir": ru["udir"],
                })
        return out

    # ------------------------------------------------------------------
    def rescue_mates(self, codes, quals, lens, anchors, rc_flags,
                     maxins: int):
        """Anchored mate rescue (alignMate equivalent): align each mate in
        a window around its partner's position.  codes/quals [R, L] in the
        ORIGINAL read orientation; rc_flags marks mates whose expected
        strand is reverse-complement.  Returns list[list[Alignment]] with
        read_idx = job index."""
        R, L = codes.shape
        if R == 0:
            return []
        # the reference searches the whole 57,344 bp local-index window
        # containing the anchor (alignMate -> getLocalGFM)
        WIN_IVAL, WIN_LEN = 56320, 57344
        CHUNK = 128
        Rp = min(CHUNK, 1 << (max(R - 1, 1)).bit_length())
        # orient reads to the expected strand on host
        oc = codes.astype(np.int32).copy()
        oq = quals.astype(np.int32).copy()
        for i in np.flatnonzero(rc_flags):
            Lr = int(lens[i])
            seq = oc[i, :Lr]
            oc[i, :Lr] = np.where(seq < 4, 3 - seq, 4)[::-1]
            oq[i, :Lr] = oq[i, :Lr][::-1]
        ws_all = (np.asarray(anchors, np.int64) // WIN_IVAL) * WIN_IVAL
        key = (Rp, L)
        fn = self._rescue_jits.get(key)
        if fn is None:
            from ..ops import rescue as rescue_ops

            def _run(d, params, reads, quals_, lens_, wstart):
                return rescue_ops.rescue_candidates(
                    d.ref_words, self.meta.n, reads, quals_, lens_, wstart,
                    WIN_LEN, params["mm_pen"], params["clip_pen"],
                    self.scoring.n_pen,
                    allow_softclip=not self.scoring.no_softclip,
                    snv_delta1=(params["snv1"] if self.graph is not None
                                else None),
                    snv_delta2=(params["snv2"] if self.graph is not None
                                else None))
            fn = jax.jit(_run)
            self._rescue_jits[key] = fn
        starts_l, sc_l, cl_l, cr_l, mm_l, nn_l, ok_l = \
            [], [], [], [], [], [], []
        for c0 in range(0, R, Rp):
            c1 = min(c0 + Rp, R)
            ocp = np.full((Rp, L), 4, np.int32)
            oqp = np.zeros((Rp, L), np.int32)
            olp = np.ones(Rp, np.int32)
            owp = np.zeros(Rp, np.int32)
            ocp[:c1 - c0] = oc[c0:c1]
            oqp[:c1 - c0] = oq[c0:c1]
            olp[:c1 - c0] = lens[c0:c1]
            owp[:c1 - c0] = ws_all[c0:c1]
            starts_d, ext = fn(self.dev, self.params, jnp.asarray(ocp),
                               jnp.asarray(oqp), jnp.asarray(olp),
                               jnp.asarray(owp))
            m = c1 - c0
            starts_l.append(np.asarray(starts_d)[:m])
            sc_l.append(np.asarray(ext.score)[:m])
            cl_l.append(np.asarray(ext.clip_l)[:m])
            cr_l.append(np.asarray(ext.clip_r)[:m])
            mm_l.append(np.asarray(ext.n_mm)[:m])
            nn_l.append(np.asarray(ext.n_n)[:m])
            ok_l.append(np.asarray(ext.ok)[:m])
        starts = np.concatenate(starts_l)
        sc = np.concatenate(sc_l)
        clip_l = np.concatenate(cl_l)
        clip_r = np.concatenate(cr_l)
        n_mm = np.concatenate(mm_l)
        n_n = np.concatenate(nn_l)
        okm = np.concatenate(ok_l)
        out = []
        nfr = len(self.frag_ref)
        for i in range(R):
            Lr = int(lens[i])
            minsc = self.scoring.min_score(Lr)
            recs = []
            seen = set()
            order = np.argsort(-sc[i], kind="stable")
            for t in order:
                if not okm[i, t] or sc[i, t] < minsc:
                    continue
                s = int(starts[i, t])
                if s in seen:
                    continue
                seen.add(s)
                astart = s + int(clip_l[i, t])
                span = Lr - int(clip_l[i, t]) - int(clip_r[i, t])
                f = min(max(int(np.searchsorted(
                    self.frag_joined, astart, "right")) - 1, 0), nfr - 1)
                if not (astart >= self.frag_joined[f]
                        and astart + span <= self.frag_joined[f + 1]):
                    continue
                recs.append(Alignment(
                    read_idx=i, rc=bool(rc_flags[i]),
                    ref_id=int(self.frag_ref[f]),
                    ref_pos=int(self.frag_off[f] + astart
                                - self.frag_joined[f]),
                    joined_pos=s, clip_l=int(clip_l[i, t]),
                    clip_r=int(clip_r[i, t]), aln_span=span,
                    score=int(sc[i, t]), n_mm=int(n_mm[i, t]),
                    n_n=int(n_n[i, t]), mapq=0, nh=1, secondary=False))
            if len(recs) >= 2:
                # other in-window placements surface as ZS (secbest)
                recs[0] = dataclasses.replace(recs[0], zs=recs[1].score)
                for t2 in range(1, len(recs)):
                    recs[t2] = dataclasses.replace(recs[t2],
                                                   zs=recs[0].score)
            # alignMate resolves a local segment only when nelt <= 5
            # (hi_aligner.h:4760): a mate matching the window more than
            # 5 times equally well is never rescued
            if recs:
                nbest = sum(1 for a in recs if a.score == recs[0].score)
                if nbest > 5:
                    recs = []
            out.append(recs)
        return out

    # ------------------------------------------------------------------
    def annotate_snps(self, a, rd_aligned):
        """(Zs:Z string, aligned-read offsets of SNV-matched columns).

        The offsets are excluded from NM/XM, mirroring how the reference
        marks snpID edits and skips them in mismatch accounting
        (aligner_result.cpp NM computation; sam.h:978 Zs emission).
        Junction alignments scan both segments; a known ALT indel adds its
        own D/I entry at the junction offset."""
        if self.graph is None:
            return None, ()
        g = self.graph
        entries = []
        snv_offs = []
        cl = a.clip_l
        L_al = len(rd_aligned)
        rd_len = L_al + cl + a.clip_r
        segs = [(diag + lo, lo - cl, hi - lo)
                for (lo, hi, diag) in a.segments(rd_len)[0]]
        for (jstart, off0, slen) in segs:
            if slen <= 0:
                continue
            lo = int(np.searchsorted(g.snv_joined, jstart))
            hi = int(np.searchsorted(g.snv_joined, jstart + slen))
            for t in range(lo, hi):
                off = off0 + int(g.snv_joined[t]) - jstart
                if 0 <= off < L_al and rd_aligned[off] == g.snv_alt[t]:
                    entries.append(
                        (off, "S",
                         self.variants.snp_names[int(g.snv_id[t])]))
                    snv_offs.append(off)
        if a.junc_kind in (2, 3) and a.junc_known and a.junc_snp >= 0:
            ch = "D" if a.junc_kind == 2 else "I"
            entries.append((a.junc_x - cl, ch,
                            self.variants.snp_names[a.junc_snp]))
        if not entries:
            return None, tuple(snv_offs)
        entries.sort()
        parts, prev = [], -1
        for o, ch, nm in entries:
            parts.append(f"{o - prev - 1}|{ch}|{nm}")
            prev = o
        return ",".join(parts), tuple(snv_offs)

    # ------------------------------------------------------------------
    def align_batch(self, codes: np.ndarray, quals: np.ndarray,
                    lens: np.ndarray, rdids: np.ndarray = None,
                    paired: bool = False) -> BatchResult:
        """Align one padded batch; returns per-read alignment lists.

        In spliced mode the batch re-runs until the splice-site DB reaches a
        fixed point: novel junctions reported by earlier reads become
        zero-penalty known sites for later reads (readid-gated on device),
        replicating the reference's sequential temp-splice-site semantics
        (useTempSpliceSite, hisat2.cpp:3180-3203,3559) batch-synchronously."""
        try:
            return self.collect(self.dispatch(codes, quals, lens, rdids),
                                paired=paired)
        except Exception as e:
            # --passMemExc-style recovery (gfm.h:1890 semantics, applied
            # to the align side): on device OOM, halve the batch on the
            # SAME device(s) and merge the halves' raw rows
            if "RESOURCE_EXHAUSTED" not in str(e) or codes.shape[0] < 2 \
                    or paired:
                raise      # paired batches interleave mate blocks: the
                           # caller owns the split there
            import sys
            B = codes.shape[0]
            h = B // 2
            where = sorted({str(d) for dev in self.devs
                            for d in dev.ref_words.devices()})
            print(f"warning: out of device memory on {', '.join(where)} "
                  f"with a {B}-read batch; retrying as two halves there",
                  file=sys.stderr)
            if rdids is None:
                rdids = np.arange(B, dtype=np.int64)
            r1 = self.align_batch(codes[:h], quals[:h], lens[:h],
                                  rdids[:h], paired=False)
            r2 = self.align_batch(codes[h:], quals[h:], lens[h:],
                                  rdids[h:], paired=False)
            cols = []
            for c1, c2 in zip(r1.raw["cols"], r2.raw["cols"]):
                c2 = np.asarray(c2).copy()
                cols.append(np.concatenate([np.asarray(c1), c2]))
            cols[0][len(r1.raw["cols"][0]):] += h
            return BatchResult(n_reads=B, raw={"cols": cols})

    def dispatch(self, codes: np.ndarray, quals: np.ndarray,
                 lens: np.ndarray, rdids: np.ndarray = None):
        """Enqueue one batch on the device (returns immediately; JAX
        dispatch is asynchronous).  Pair with collect() to overlap device
        compute with host-side processing of the previous batch.

        Spliced aligners dispatch the fast DNA-mode pass here; collect()
        then runs the full junction machinery on the subset of reads
        whose pass-1 best is imperfect."""
        if self._fast is not None:
            h1 = self._fast.dispatch(codes, quals, lens, rdids)
            return ("2pass", h1, codes, quals, lens, rdids)
        if rdids is None:
            rdids = np.arange(codes.shape[0], dtype=np.int64)
        minsc = np.array([self.scoring.min_score(int(l)) for l in lens],
                         np.int64)
        uniform = bool(np.all(np.asarray(lens) == codes.shape[1]))
        ver = self.splice_db.n_sites if self.splice_db is not None else 0
        rd, qd, h2d = self._pack_h2d(np.asarray(codes), np.asarray(quals),
                                     np.asarray(lens), minsc)
        packed = self._dispatch_packed(rd, qd, rdids, uniform, h2d)
        for pk in packed:
            # enqueue the D2H copy NOW, before the next batch's compute is
            # dispatched — otherwise the (serialized) transfer queues
            # behind it and collect() stalls a full device step
            pk.copy_to_host_async()
        return (packed, codes, quals, lens, rdids, minsc, ver)

    def _dispatch_packed(self, rd, qd, rdids, uniform, h2d,
                         full_out=False):
        return [self._device_step(
            dev, {**self.params, **self.shard_params[i]}, rd, qd,
            None, None,
            jnp.asarray(rdids, jnp.int32) if self.use_ss else None,
            (self.splice_db.device_tables(b, dev.meta.n)
             if self.use_ss else None), uniform=uniform, h2d=h2d,
            full_out=full_out)
            for i, (dev, b) in enumerate(zip(self.devs,
                                             self.shard_bases))]

    def _merge_or_respill(self, packed, codes, quals, lens, rdids):
        """_merge_shards, falling back to a full_out re-dispatch when a
        spill-layout batch overflowed its S = 2B spill rows (multimap-
        saturated batches; compiles the full layout lazily, once)."""
        try:
            return self._merge_shards(packed)
        except SpillOverflow:
            minsc = np.array(
                [self.scoring.min_score(int(l)) for l in lens], np.int64)
            uniform = bool(np.all(np.asarray(lens) == codes.shape[1]))
            rd, qd, h2d = self._pack_h2d(
                np.asarray(codes), np.asarray(quals),
                np.asarray(lens), minsc)
            if rdids is None:
                rdids = np.arange(codes.shape[0], dtype=np.int64)
            return self._merge_shards(self._dispatch_packed(
                rd, qd, rdids, uniform, h2d, full_out=True))

    def collect(self, handle, paired: bool = False) -> BatchResult:
        """Finish a dispatched batch: fetch, run the host phase, and (in
        spliced mode) iterate the splice-table fixed point — re-running the
        device pass when the dispatched one used a stale site table."""
        if isinstance(handle, tuple) and handle and handle[0] == "2pass":
            return self._collect_two_pass(handle, paired)
        if isinstance(handle, tuple) and handle and handle[0] == "2pass2":
            return self._finish_two_pass(handle, paired)
        packed, codes, quals, lens, rdids, minsc, ver = handle
        res = self._host_phase(
            self._merge_or_respill(packed, codes, quals, lens, rdids),
            codes, quals, lens, minsc, paired=paired)
        if not self.spliced or self.splice_db is None:
            return res
        for _ in range(4):
            if self.tmo:
                break           # --tmo: no temp splice sites
            added = self.splice_db.collect_from_alignments(
                res.alignments, rdids, lens, codes, self.ref_codes)
            if not added and self.splice_db.n_sites == ver:
                break
            ver = self.splice_db.n_sites
            h = self._dispatch_full(codes, quals, lens, rdids)
            res = self._host_phase(self._merge_shards(h[0]), codes, quals,
                                   lens, minsc, paired=paired)
        return res

    def _dispatch_full(self, codes, quals, lens, rdids=None):
        """The full (spliced) device pass on exactly these arrays."""
        saved, self._fast = self._fast, None
        try:
            return self.dispatch(codes, quals, lens, rdids)
        finally:
            self._fast = saved

    def advance(self, handle, paired: bool = False):
        """Move a dispatched batch one stage forward WITHOUT waiting on
        newly-enqueued device work: for two-pass handles, collect pass 1,
        compute the routing set, and dispatch the pass-2 bucket — the
        returned stage-2 handle's collect() then only waits for a step
        that is already in the device queue.  Pipelined callers invoke
        advance() on a mid-queue handle so pass 2 overlaps later batches'
        pass 1 (without it, collect() serializes a full device round trip
        per batch).  Non-two-pass handles return unchanged."""
        if isinstance(handle, tuple) and handle and handle[0] == "2pass":
            return self._advance_two_pass(handle, paired)
        return handle

    def _collect_two_pass(self, handle, paired: bool) -> BatchResult:
        return self._finish_two_pass(
            self._advance_two_pass(handle, paired), paired)

    def _route_two_pass(self, st) -> np.ndarray:
        """One routing round: read indices whose pass-1 answer is not
        final (unaligned / under-covered / slot-saturated / boundary
        overlap with known indels or newly-added splice sites)."""
        (has, best, bdirty, r_rd, r_lo, r_hi, sat, ver1, processed) = st
        B = has.shape[0]
        # pass-1 completeness: a read is final when its best is PERFECT,
        # or when the best is a fully-covered plain form (no soft clip,
        # no junction) that no novel gap can beat or tie (the cheapest
        # gap costs open+extend).  The reference only recurses into the
        # gap/junction machinery over UNCOVERED spans (hybridSearch,
        # spliced_aligner.h:113-214): a clipped best leaves a span and
        # gains gap-form ZS evidence there (measured: clip-2 best at -4
        # carries a -20 gap-form ZS), so clipped/junctioned bests re-run;
        # covered mismatched bests do not.  Free known-ALT-indel ties
        # are routed by the indel-boundary check; zero-penalty known-
        # junction ties by pass-1 injection (spliced).
        sp = self.splice_params
        gapmin = min(sp.rd_gap_open + sp.rd_gap_ext,
                     sp.rf_gap_open + sp.rf_gap_ext)
        final = has & ((best >= 0)
                       | ((best > -gapmin) & ~bdirty))
        needs = ~final
        if sat is not None:
            needs |= sat
        if self._indel_bounds is not None and r_rd is not None:
            bnd = self._indel_bounds
            near = (np.searchsorted(bnd, r_hi + 1)
                    - np.searchsorted(bnd, r_lo - 1)) > 0
            needs[r_rd[near]] = True
        if self.splice_db is not None and r_rd is not None:
            # perfect placements whose span covers a splice-site
            # boundary the pass-1 table did NOT yet contain (a
            # zero-penalty junction can TIE a perfect ungapped form).
            # With pass-1 known-site injection the established table
            # is already represented, so only sites added since the
            # pass-1 dispatch route; without injection (-a fast
            # twin), every boundary routes.
            since = ver1 if getattr(self._fast, "inject_ss", False) \
                else 0
            bnd = self.splice_db.joined_boundaries(since=since)
            if bnd.size:
                near = (np.searchsorted(bnd, r_hi + 1)
                        - np.searchsorted(bnd, r_lo - 1)) > 0
                needs[r_rd[near]] = True
        needs &= ~processed
        return np.flatnonzero(needs)

    def _dispatch_sub(self, codes, quals, lens, rdids, sub):
        """Dispatch the routed subset through the full layout, padded to
        a power-of-two bucket (bounds the compiled-variant count while
        avoiding a full-B pass for a small subset)."""
        B = codes.shape[0]
        L = codes.shape[1]
        Bs = max(256, B // 8)
        while Bs < sub.size:
            Bs *= 2
        Bs = min(Bs, B)
        n = sub.size
        sc_ = np.zeros((Bs, L), np.asarray(codes).dtype)
        sq_ = np.zeros((Bs, L), np.asarray(quals).dtype)
        sl_ = np.zeros(Bs, np.asarray(lens).dtype)
        sr_ = np.zeros(Bs, np.int64)
        sc_[:n] = np.asarray(codes)[sub]
        sq_[:n] = np.asarray(quals)[sub]
        sl_[:n] = np.asarray(lens)[sub]
        sr_[:n] = np.asarray(rdids)[sub]
        return self._dispatch_full(sc_, sq_, sl_, sr_)

    def _advance_two_pass(self, handle, paired: bool):
        _, h1, codes, quals, lens, rdids = handle
        ver1 = h1[6] if isinstance(h1, tuple) and len(h1) >= 7 else 0
        res1 = self._fast.collect(h1, paired=paired)
        B = res1.n_reads
        if rdids is None:
            rdids = np.arange(B, dtype=np.int64)
        # pass-1 summary per read: any alignment / best score / spans
        has = np.zeros(B, bool)
        best = np.full(B, -2 ** 40, np.int64)
        bdirty = np.zeros(B, bool)      # a best row is clipped/junctioned
        r_rd = r_lo = r_hi = None
        if res1.raw is not None and len(res1.raw["cols"][0]):
            c = res1.raw["cols"]
            r_rd = np.asarray(c[0])
            sc = np.asarray(c[8])
            has[r_rd] = True
            np.maximum.at(best, r_rd, sc)
            dirty = (np.asarray(c[5]) > 0) | (np.asarray(c[6]) > 0) \
                | (np.asarray(c[16]) != 0)
            isb = sc == best[r_rd]
            np.logical_or.at(bdirty, r_rd[isb & dirty], True)
            r_lo = np.asarray(c[4]) + np.asarray(c[5])      # aln_start
            r_hi = r_lo + np.asarray(c[7])                  # + aln_span
        # slot saturation (lite tier only): reads whose placement pool
        # exceeded the lite caps re-run through the full layout
        sat = None
        if res1.lanes is not None and "h_sat" in res1.lanes:
            v = np.asarray(res1.lanes["h_sat"])
            cap = getattr(self._fast, "lite_cap", 8)
            sat = (v[:B] > cap) | (v[B:2 * B] > cap)
        processed = np.zeros(B, bool)
        st = (has, best, bdirty, r_rd, r_lo, r_hi, sat, ver1, processed)
        sub = self._route_two_pass(st)
        h2 = None
        ver0 = self.splice_db.n_sites if self.splice_db else 0
        if sub.size:
            processed[sub] = True
            h2 = self._dispatch_sub(codes, quals, lens, rdids, sub)
        return ("2pass2", st, res1, h2, sub, ver0,
                codes, quals, lens, rdids)

    def _finish_two_pass(self, stage2, paired: bool) -> BatchResult:
        (_, st, merged, h2, sub, ver0,
         codes, quals, lens, rdids) = stage2
        B = merged.n_reads
        processed = st[-1]
        for it in range(3):
            if h2 is None:
                break
            res2 = self.collect(h2, paired=paired)
            merged = self._merge_two_pass(merged, res2, sub, B)
            if self.splice_db is None or \
                    self.splice_db.n_sites == ver0:
                break   # no new sites -> the needs-set cannot grow
            ver0 = self.splice_db.n_sites
            sub = self._route_two_pass(st)
            h2 = None
            if sub.size:
                processed[sub] = True
                h2 = self._dispatch_sub(codes, quals, lens, rdids, sub)
        return merged

    def _merge_two_pass(self, res1, res2, sub, B):
        """Replace subset reads' rows/metadata in res1 with res2's."""
        subset = np.zeros(B, bool)
        subset[sub] = True
        cols1 = (res1.raw["cols"] if res1.raw is not None else None)
        cols2 = (res2.raw["cols"] if res2.raw is not None else None)
        parts = []
        if cols1 is not None and len(cols1[0]):
            rd1 = np.asarray(cols1[0])
            keep = ~subset[rd1]
            parts.append([np.asarray(c)[keep] for c in cols1])
        if cols2 is not None and len(cols2[0]):
            rd2 = np.asarray(cols2[0])
            live = rd2 < len(sub)          # padded lanes have no rows
            remap = sub[rd2[live]]
            p2 = [np.asarray(c)[live] for c in cols2]
            p2[0] = remap
            parts.append(p2)
        if parts:
            ncol = len(parts[0])
            cols = [np.concatenate([p[j] for p in parts])
                    for j in range(ncol)]
            order = np.argsort(cols[0], kind="stable")
            cols = [c[order] for c in cols]
            raw = {"cols": cols}
        else:
            raw = None
        orient = res1.orient_ranks
        if orient is not None and res2.orient_ranks is not None:
            orient = np.array(orient)
            orient[sub] = np.array(res2.orient_ranks)[:sub.size]
        lanes = res1.lanes
        if lanes is not None and res2.lanes is not None:
            lanes = {k: (np.array(v) if hasattr(v, "shape") else v)
                     for k, v in lanes.items()}
            Bs = res2.n_reads
            for k, v2 in res2.lanes.items():
                v1 = lanes.get(k)
                if v1 is None or not hasattr(v2, "shape"):
                    continue
                v2 = np.asarray(v2)
                if v2.shape[0] == 2 * Bs and v1.shape[0] == 2 * B:
                    v1[sub] = v2[:sub.size]
                    v1[B + sub] = v2[Bs:Bs + sub.size]
                    lanes[k] = v1
        return BatchResult(n_reads=B, lanes=lanes, orient_ranks=orient,
                           raw=raw)

    # position-valued output keys (rebased by shard_base at merge)
    _POS_KEYS = ("u_d1", "u_d2", "q2_d", "q2_bd1", "q2_bd2")

    def _merge_shards(self, packed_list) -> dict:
        """Fetch per-shard packed outputs and merge into one candidate
        dict with GLOBAL joined coordinates (candidate rows concatenate;
        the host phase dedup/selection then sees the union)."""
        outs = [self._fetch_out(pk) for pk in packed_list]
        if len(outs) == 1 and self.shard_bases[0] == 0:
            out0 = outs[0]
            rdb = self.shard_row_db[0]
            if rdb is not None and "u_event" in out0:
                v = out0["u_event"]
                ev = v >= 0
                v = v.copy()
                v[ev] = rdb[v[ev]]
                out0["u_event"] = v
            return out0
        merged = {}
        # q2_* keys are PER-LANE composite results (two-junction seeds),
        # not candidate rows: keep the whole set from the shard whose best
        # composite score wins, selected once per lane
        best_q2 = None
        if "q2_score" in outs[0]:
            best_q2 = np.argmax(np.stack(
                [o["q2_score"].max(axis=1) for o in outs]), axis=0)
        for k in outs[0]:
            vs = []
            for si, (o, base) in enumerate(zip(outs, self.shard_bases)):
                v = o[k]
                if k in self._POS_KEYS:
                    v = v.astype(np.int64) + base
                elif k == "u_event":
                    # shard-local indel-table rows -> global VariantDB rows
                    rdb = self.shard_row_db[si]
                    if rdb is not None:
                        ev = v >= 0
                        v = v.copy()
                        v[ev] = rdb[v[ev]]
                vs.append(v)
            if k.startswith("q2_"):
                stk = np.stack(vs)                      # [S, 2B, ...]
                idx = best_q2.reshape((1, -1) + (1,) * (stk.ndim - 2))
                merged[k] = np.take_along_axis(stk, idx, axis=0)[0]
            elif k == "h_minw":
                merged[k] = np.minimum.reduce(vs)
            elif k in ("h_alignable", "h_stop"):
                merged[k] = np.logical_or.reduce(vs)
            elif k in ("h_rn", "h_sat"):
                merged[k] = np.add.reduce(vs)
            elif k == "h_rounds":
                merged[k] = vs[0]
            elif vs[0].ndim >= 2:
                merged[k] = np.concatenate(vs, axis=1)
            else:
                merged[k] = vs[0]
        return merged

    def _run_batch(self, codes: np.ndarray, quals: np.ndarray,
                   lens: np.ndarray, rdids: np.ndarray,
                   paired: bool = False) -> BatchResult:
        minsc = np.array([self.scoring.min_score(int(l)) for l in lens],
                         np.int64)
        uniform = bool(np.all(np.asarray(lens) == codes.shape[1]))
        rd, qd, h2d = self._pack_h2d(np.asarray(codes), np.asarray(quals),
                                     np.asarray(lens), minsc)
        packed = self._dispatch_packed(rd, qd, rdids, uniform, h2d)
        return self._host_phase(
            self._merge_or_respill(packed, codes, quals, lens, rdids),
            codes, quals, lens, minsc)

    def _eval_order_suppress(self, valid, score, junc_kind, lanes_meta,
                             lens, minsc, B, K):
        """Unpaired interleaved-search replay + sink best gating.

        Replays the reference's fw/rc round interleave (HI_Aligner::go)
        per read, drops candidates of lanes the reference never aligned,
        and suppresses candidates whose score is below the best reported
        by earlier-completing lanes (`minsc = max(minsc,
        sink.bestUnp1())`, spliced_aligner.h:635-637).  Returns (valid,
        best_before_lane [2B], orientation report ranks [B, 2]).

        Python replay runs only for reads where order can matter: both
        orientations carry candidates, a give-up gate could fire, or a
        lane completes with a false align() verdict."""
        v2 = valid.reshape(2 * B, K)
        sc2 = np.where(v2, score.reshape(2 * B, K), np.int64(-2 ** 40))
        lane_best = sc2.max(axis=1)                             # [2B]
        ms64 = np.asarray(minsc, np.int64)
        # vectorized round log: byte t of lane l = len*2 + uniq
        words = np.asarray(lanes_meta["h_rounds"])
        rn2b = np.asarray(lanes_meta["h_rn"]).astype(np.int64)
        bts = ((words[:, :, None] >> (np.arange(4) * 8)[None, None, :])
               & 0xFF).reshape(2 * B, -1)
        minw_cap = 2 * max(2 * self.k, 10)
        verdict2b = np.asarray(lanes_meta["h_alignable"]).astype(bool) \
            & (np.asarray(lanes_meta["h_minw"]) <= minw_cap)
        spl_l = (v2 & (junc_kind.reshape(2 * B, K)
                       == splice_ops.KIND_SPL)).any(axis=1)
        spl = (spl_l[:B] | spl_l[B:]).astype(np.int64)

        # ---- fully vectorized 2-lane interleave (replay_pair, unpaired
        # flow) across all reads: lanes are (fw, rc) of the same mate,
        # found[] = {last align() verdict, False}, so the FIRST lane that
        # completes with a false verdict ends the whole search
        R = bts.shape[1]
        rlen = (bts >> 1).astype(np.int64).reshape(2, B, R) \
            .transpose(1, 0, 2)                                # [B, 2, R]
        runiq = (bts & 1).astype(bool).reshape(2, B, R).transpose(1, 0, 2)
        rn = np.stack([rn2b[:B], rn2b[B:]], axis=1)            # [B, 2]
        verdict = np.stack([verdict2b[:B], verdict2b[B:]], axis=1)
        lbest = np.stack([lane_best[:B], lane_best[B:]], axis=1)
        idxmask = np.arange(R)[None, None, :] < rn[:, :, None]
        P2 = np.zeros((B, 2, R + 1), np.int64)
        P2[:, :, 1:] = np.cumsum(np.where(idxmask, rlen * rlen, 0), axis=2)
        mk2 = np.int64(self.min_k) ** 2
        mmmax = max(self.scoring.mm_max, 1)
        NEG = np.int64(-2 ** 62)
        INF = np.int64(2 ** 62 - 1)
        k = np.zeros((B, 2), np.int64)
        na = np.zeros((B, 2), np.int64)
        done = rn == 0                       # empty lanes never complete
        ended = np.zeros(B, bool)
        comp_rank = np.full((B, 2), -1, np.int64)
        order_ctr = np.zeros(B, np.int64)
        best_unp = np.full(B, np.int64(-2 ** 40))
        ar = np.arange(B)
        for _ in range(2 * R + 4):
            act = ~ended & ~done.all(axis=1)
            if not act.any():
                break
            cum = np.take_along_axis(P2, k[:, :, None], axis=2)[:, :, 0]
            pen = np.minimum(2 * na, 62)
            scl = np.where(k == 0, INF,
                           cum - na * mk2 - (np.int64(1) << pen))
            scl = np.where(done, NEG, scl)
            pick = np.argmax(scl, axis=1)            # ties -> fw (lane 0)
            pna = na[ar, pick]
            # budget gate (hi_aligner.h:3993-4027): unpaired -> search over
            maxmm = -(-np.maximum(-best_unp, 0) // mmmax)
            budget = act & (best_unp >= ms64[:B]) \
                & (pna > maxmm + spl + 1)
            # sibling gate (hi_aligner.h:4030-4036): search over
            sibna = na[ar, 1 - pick]
            sibdone = done[ar, 1 - pick]
            sib = act & ~budget & sibdone & (best_unp < ms64[:B]) \
                & (pna > sibna + 1)
            ended |= budget | sib
            consume = act & ~budget & ~sib
            kp = k[ar, pick]
            uq = runiq[ar, pick, np.minimum(kp, R - 1)]
            k[ar, pick] = np.where(consume, kp + 1, kp)
            na[ar, pick] = np.where(consume & ~uq, pna + 1, pna)
            complete = consume & (k[ar, pick] == rn[ar, pick])
            done[ar, pick] |= complete
            vd = verdict[ar, pick]
            newrank = complete & vd & (comp_rank[ar, pick] < 0)
            comp_rank[ar, pick] = np.where(newrank, order_ctr,
                                           comp_rank[ar, pick])
            order_ctr += newrank
            upd = complete & vd & (lbest[ar, pick] >= ms64[:B])
            best_unp = np.where(upd, np.maximum(best_unp,
                                                lbest[ar, pick]),
                                best_unp)
            # go() break: a false-verdict completion ends the search
            ended |= complete & ~vd

        completed = comp_rank >= 0                              # [B, 2]
        # sink best gate: lanes completing later report only candidates
        # that beat the best accepted by earlier lanes
        first = np.where(completed & (comp_rank == 0), lbest,
                         np.int64(-2 ** 40)).max(axis=1)
        first = np.where(first >= ms64[:B], first, np.int64(-2 ** 40))
        bb = np.where(comp_rank >= 1, first[:, None], np.int64(-2 ** 40))
        bb = np.where(completed, bb, np.int64(2 ** 40))        # drop all
        best_before = np.concatenate([bb[:, 0], bb[:, 1]])
        gate = np.maximum(best_before,
                          ms64[np.arange(2 * B) % B])
        v2 &= sc2 >= gate[:, None]
        ranks = np.where(comp_rank < 0, 2, comp_rank)
        return v2.reshape(-1), best_before, ranks

    def _host_phase(self, o_np: dict, codes: np.ndarray, quals: np.ndarray,
                    lens: np.ndarray, minsc: np.ndarray,
                    paired: bool = False) -> BatchResult:
        tick = section_timer("host_phase")
        B = codes.shape[0]
        # unpack the per-slot flags byte and the DNA-mode d2 delta (see
        # _align_device's D2H shrink)
        if "u_flags" in o_np:
            fl = o_np.pop("u_flags")
            cs = (fl >> 4) & 7
            o_np["u_valid"] = fl & 1
            o_np["u_post"] = (fl >> 1) & 1
            o_np["u_selfgap"] = (fl >> 2) & 1
            o_np["u_known"] = (fl >> 3) & 1
            o_np["u_kind"] = np.where(cs >= 4, np.int32(splice_ops.KIND_SPL),
                                      cs)
            o_np["u_spldir"] = np.where(cs >= 4, cs - 3, 0)
        if "u_dd" in o_np:
            o_np["u_d2"] = o_np["u_d1"] + o_np.pop("u_dd")
        U = o_np["u_score"].shape[1]    # unified slots (device-compacted)
        # composite columns: (2 two-junction + 1 three-junction) per
        # swept base pair (top-2 raw pairs)
        Q = 0
        qpfx = []
        for p2, p3 in (("q2_", "q3_"), ("r2_", "r3_")):
            if p2 + "score" in o_np:
                qpfx.append((p2, p3))
                Q += 3 if p3 + "score" in o_np else 2
        K = U + Q

        # int32 math throughout the host phase when positions fit (the
        # arrays are memory-bound; int64 doubles the traffic) — sharded
        # multi-gigabase genomes fall back to int64
        hdt = np.int64 if self.meta.n >= 2 ** 31 - 2 ** 24 else np.int32

        def flat(u, q=None):
            if not Q:
                # reshape of a C-contiguous [2B, U] int32 array is a VIEW
                return u.astype(hdt, copy=False).reshape(-1)
            blocks_ = [u.astype(hdt, copy=False),
                       (np.zeros((2 * B, Q)) if q is None
                        else q).astype(hdt, copy=False)]
            return np.concatenate(blocks_, axis=1).reshape(-1)

        q_j3x = q_j3d4 = q_j3kind = q_j3dir = None
        if Q:
            # per swept base pair: column 0 = right-extension composite
            # (junctions at bx then sweep x); column 1 = left-extension
            # (sweep x then bx); column 2 = the 3-junction combo
            # (left x, bx, right x)
            ones = np.ones(2 * B, np.int32)
            zeros = np.zeros(2 * B, np.int32)
            cs = {k: [] for k in ("start", "score", "j1x", "j1d2",
                                  "j1kind", "j1dir", "j1known", "j2x",
                                  "j2d3", "j2kind", "j2dir", "j3x",
                                  "j3d4", "j3kind", "j3dir")}
            for p2, p3 in qpfx:
                g = lambda k: o_np[p2 + k]  # noqa: E731
                cs["start"] += [g("bd1"), g("d")[:, 1]]
                cs["score"] += [g("score")[:, 0], g("score")[:, 1]]
                cs["j1x"] += [g("bx"), g("x")[:, 1]]
                cs["j1d2"] += [g("bd2"), g("bd1")]
                cs["j1kind"] += [g("bkind"), ones]
                cs["j1dir"] += [g("bdir"), g("dir")[:, 1]]
                cs["j1known"] += [g("bknown"), zeros]
                cs["j2x"] += [g("x")[:, 0], g("bx")]
                cs["j2d3"] += [g("d")[:, 0], g("bd2")]
                cs["j2kind"] += [ones, g("bkind")]
                cs["j2dir"] += [g("dir")[:, 0], g("bdir")]
                cs["j3x"] += [zeros, zeros]
                cs["j3d4"] += [zeros, zeros]
                cs["j3kind"] += [zeros, zeros]
                cs["j3dir"] += [zeros, zeros]
                if p3 + "score" in o_np:
                    g3 = lambda k: o_np[p3 + k]  # noqa: E731
                    cs["start"].append(g3("ld"))
                    cs["score"].append(g3("score"))
                    cs["j1x"].append(g3("lx"))
                    cs["j1d2"].append(g("bd1"))
                    cs["j1kind"].append(ones)
                    cs["j1dir"].append(g3("ldir"))
                    cs["j1known"].append(zeros)
                    cs["j2x"].append(g("bx"))
                    cs["j2d3"].append(g("bd2"))
                    cs["j2kind"].append(g("bkind"))
                    cs["j2dir"].append(g("bdir"))
                    cs["j3x"].append(g3("rx"))
                    cs["j3d4"].append(g3("rd"))
                    cs["j3kind"].append(ones)
                    cs["j3dir"].append(g3("rdir"))
            q_start = np.stack(cs["start"], 1)
            q_score = np.stack(cs["score"], 1).astype(np.int64)
            q_j1x = np.stack(cs["j1x"], 1)
            q_j1d2 = np.stack(cs["j1d2"], 1)
            q_j1kind = np.stack(cs["j1kind"], 1)
            q_j1dir = np.stack(cs["j1dir"], 1)
            q_j1known = np.stack(cs["j1known"], 1)
            q_j2x = np.stack(cs["j2x"], 1)
            q_j2d3 = np.stack(cs["j2d3"], 1)
            q_j2kind = np.stack(cs["j2kind"], 1)
            q_j2dir = np.stack(cs["j2dir"], 1)
            q_j3x = np.stack(cs["j3x"], 1)
            q_j3d4 = np.stack(cs["j3d4"], 1)
            q_j3kind = np.stack(cs["j3kind"], 1)
            q_j3dir = np.stack(cs["j3dir"], 1)
        else:
            q_start = q_score = q_j1x = q_j1d2 = q_j1kind = None
            q_j1dir = q_j1known = q_j2x = q_j2d3 = q_j2kind = q_j2dir = None

        starts = flat(o_np["u_d1"], q_start)
        score = flat(o_np["u_score"], q_score)
        n_mm = flat(o_np["u_n_mm"])
        n_n_dev = flat(o_np["u_n_n"])
        clip_l = flat(o_np["u_clip_l"])
        clip_r = flat(o_np["u_clip_r"])
        junc_kind = flat(o_np["u_kind"], q_j1kind)
        junc_x = flat(o_np["u_x"], q_j1x)
        d2 = flat(o_np["u_d2"], q_j1d2)
        spl_dir = flat(o_np["u_spldir"], q_j1dir)
        junc_known = flat(o_np["u_known"], q_j1known)
        junc_event = flat(o_np.get("u_event",
                                   np.full((2 * B, U), -1, np.int32)),
                          np.full((2 * B, Q), -1) if Q else None)
        junc2_kind = flat(np.zeros((2 * B, U)), q_j2kind)
        junc2_x = flat(np.zeros((2 * B, U)), q_j2x)
        junc2_d3 = flat(o_np["u_d2"], q_j2d3)
        junc2_dir = flat(np.zeros((2 * B, U)), q_j2dir)
        junc3_kind = flat(np.zeros((2 * B, U)), q_j3kind)
        junc3_x = flat(np.zeros((2 * B, U)), q_j3x)
        junc3_d4 = flat(o_np["u_d2"], q_j3d4)
        junc3_dir = flat(np.zeros((2 * B, U)), q_j3dir)
        # u_alt ships one value per LANE per shard (its best slot's
        # trimmed-rep score); scatter it back to the lane's globally best
        # slot (same argmax as the device ran per shard)
        NOALT = -(2 ** 30)
        us_b = np.where(o_np["u_valid"] > 0, o_np["u_score"], NOALT)
        bs_b = us_b.argmax(axis=1)
        lrange = np.arange(2 * B)
        ualt_full = np.full((2 * B, U), NOALT, o_np["u_alt"].dtype)
        ualt_full[lrange, bs_b] = o_np["u_alt"][
            lrange, bs_b // (U // o_np["u_alt"].shape[1])]
        alt_dev = flat(ualt_full,
                       np.full((2 * B, Q), -(2 ** 30)) if Q else None)
        # map indel-event table rows to VariantDB snp indices
        # u_event was mapped to GLOBAL VariantDB rows in _merge_shards
        junc_snp = junc_event.astype(np.int64)
        BIGV = 2 ** 29
        vparts = [o_np["u_valid"] > 0]
        if Q:
            vparts.append((q_score > -BIGV)
                          & (q_j1kind != splice_ops.KIND_NONE))
        valid = np.concatenate(vparts, axis=1).reshape(-1)

        lanes_meta = ({k: o_np[k] for k in
                       ("h_rounds", "h_rn", "h_minw", "h_alignable",
                        "h_stop")}
                      if "h_rounds" in o_np else None)
        if "h_sat" in o_np:
            lanes_meta = dict(lanes_meta or {}, h_sat=o_np["h_sat"])
        lane = np.repeat(np.arange(2 * B, dtype=np.int64), K)
        tick("unpack")
        # host-side policy filters (all vectorized)
        # vectorize per-length scoring bounds over the distinct lengths
        ulens, uinv = np.unique(lens, return_inverse=True)
        maxn = np.array([self.scoring.max_n(int(l)) for l in ulens],
                        np.int64)[uinv]
        read_of_lane = lane % B
        is_rc = lane >= B
        # pairs span the whole read: their N count is the read's N count
        inlen = np.arange(codes.shape[1])[None, :] < np.asarray(lens)[:, None]
        n_read = ((codes > 3) & inlen).sum(axis=1).astype(np.int64)
        n_n = np.where(junc_kind > 0, n_read[read_of_lane], n_n_dev)
        if self.tmo:
            # --tmo: every splice junction must be a known site
            # (hisat2.cpp tranMapOnly); second/third junctions come from
            # the novel sweep, so composites are dropped outright
            valid = valid & ~((junc_kind == splice_ops.KIND_SPL)
                              & (junc_known == 0))
            valid = valid & (junc2_kind != splice_ops.KIND_SPL) \
                & (junc3_kind != splice_ops.KIND_SPL)
        if self.require_xs:
            # --dta-cufflinks: spliced alignments need a classified
            # strand (XS) or a known site (hisat2.cpp dta-cufflinks)
            valid = valid & ~((junc_kind == splice_ops.KIND_SPL)
                              & (spl_dir == 0) & (junc_known == 0))
        if self.no_fw:
            valid = valid & is_rc
        if self.no_rc:
            valid = valid & ~is_rc
        # conflicting splice-strand evidence across one read's junctions
        # (hi_aligner.h:3644-3705): penConflictSplice, driver default
        # 1,000,000 (hisat2.cpp:483) — with the default this simply
        # drops multi-junction composites whose classified dirs disagree
        if self.scoring.pen_conflict_splice:
            dd = np.stack([
                np.where(junc_kind == splice_ops.KIND_SPL, spl_dir, 0),
                np.where(junc2_kind == splice_ops.KIND_SPL, junc2_dir, 0),
                np.where(junc3_kind == splice_ops.KIND_SPL, junc3_dir, 0)])
            fwish = ((dd == 1) | (dd == 3)).any(axis=0)
            rcish = ((dd == 2) | (dd == 4)).any(axis=0)
            score = np.where(
                fwish & rcish,
                score - np.int64(self.scoring.pen_conflict_splice), score)
        is_pair = junc_kind > 0
        valid = valid & (n_n <= maxn[read_of_lane]) \
            & (is_pair | (score >= minsc[read_of_lane]))
        # column compaction: all downstream work (containment, merge loops,
        # lexsorts) scales with K, but each lane rarely carries more than a
        # few valid candidates — keep the M best (valid-first, score desc)
        # slots per lane and drop the rest of the K columns
        ab = flat(o_np["u_ab"])
        post = flat(o_np["u_post"]).astype(bool)
        selfgap = flat(o_np["u_selfgap"]).astype(bool)
        tick("policy")
        M = max(10, self.msize + 2)
        if M < K:
            v2 = valid.reshape(2 * B, K)
            sc2 = np.where(v2, score.reshape(2 * B, K), np.int64(-2 ** 40))
            ordc = np.lexsort((-sc2, ~v2), axis=1)[:, :M]
            take = (np.arange(2 * B, dtype=np.int64)[:, None] * K
                    + ordc).reshape(-1)
            (valid, starts, score, n_mm, n_n, clip_l, clip_r, junc_kind,
             junc_x, d2, spl_dir, junc_known, junc_event, junc_snp,
             junc2_kind, junc2_x, junc2_d3, junc2_dir,
             junc3_kind, junc3_x, junc3_d4, junc3_dir, ab, post,
             selfgap, alt_dev) = (a[take] for a in (
                 valid, starts, score, n_mm, n_n, clip_l, clip_r, junc_kind,
                 junc_x, d2, spl_dir, junc_known, junc_event, junc_snp,
                 junc2_kind, junc2_x, junc2_d3, junc2_dir,
                 junc3_kind, junc3_x, junc3_d4, junc3_dir, ab, post,
                 selfgap, alt_dev))
            K = M
            lane = np.repeat(np.arange(2 * B, dtype=np.int64), K)
            read_of_lane = lane % B
            is_rc = lane >= B
            is_pair = junc_kind > 0
        tick("compact")
        # fragment containment (joinedToTextOff straddle check, gfm.h:5076);
        # junction candidates check each segment separately, and a splice may
        # cross an N-gap fragment boundary within the same reference.
        # COMPRESSED to the valid slots (typically a few % of the [2B, K]
        # grid; the full-size planes consumed downstream scatter back and
        # are don't-care at invalid slots).
        N = len(starts)
        KIND_SPL = splice_ops.KIND_SPL
        KIND_DEL = splice_ops.KIND_DEL
        KIND_INS = splice_ops.KIND_INS
        vi = np.flatnonzero(valid)
        st_v, d2_v = starts[vi], d2[vi]
        jk_v, jx_v = junc_kind[vi], junc_x[vi]
        cl_v, cr_v = clip_l[vi], clip_r[vi]
        ip_v = jk_v > 0
        L_v = lens[read_of_lane[vi]].astype(hdt)
        insl_v = np.where(jk_v == KIND_INS, st_v - d2_v, 0)
        as_v = st_v + cl_v
        le_v = np.where(ip_v, st_v + jx_v,
                        as_v + L_v - cl_v - cr_v)           # exclusive
        rs_v = np.where(jk_v == KIND_INS, st_v + jx_v, d2_v + jx_v)
        j2k_v, j2x_v = junc2_kind[vi], junc2_x[vi]
        isq2_v = j2k_v > 0
        j3k_v, j3x_v = junc3_kind[vi], junc3_x[vi]
        isq3_v = j3k_v > 0
        span_r_v = np.where(isq2_v, j2x_v, L_v) - jx_v - insl_v
        nfr = len(self.frag_ref)
        fl = np.clip(np.searchsorted(self.frag_joined, as_v,
                                     "right") - 1, 0, nfr - 1)
        contained_l = (as_v >= self.frag_joined[fl]) & \
            (le_v <= self.frag_joined[fl + 1])
        fr = np.clip(np.searchsorted(self.frag_joined, rs_v, "right") - 1,
                     0, nfr - 1)
        contained_r = (rs_v >= self.frag_joined[fr]) & \
            (rs_v + span_r_v <= self.frag_joined[fr + 1])
        same_chr = self.frag_ref[fl] == self.frag_ref[fr]
        pair_ok = contained_l & contained_r & same_chr & \
            ((jk_v == KIND_SPL) | (fl == fr))
        ok_v = np.where(ip_v, pair_ok, contained_l)
        # reference-space skip length (an intron may span an N gap)
        rp_l_end = self.frag_off[fl] + (le_v - 1 - self.frag_joined[fl])
        rp_r = self.frag_off[fr] + (rs_v - self.frag_joined[fr])
        jl_v = np.where(
            jk_v == KIND_SPL, rp_r - rp_l_end - 1,
            np.where(jk_v == KIND_DEL, d2_v - st_v,
                     np.where(jk_v == KIND_INS, -(st_v - d2_v), 0)))
        ok_v &= ~((jk_v == KIND_SPL) & (jl_v < 1))
        # second junction (always a splice): third segment containment +
        # reference-space intron length
        j2l_v = np.zeros(len(vi), np.int64)
        j3l_v = np.zeros(len(vi), np.int64)
        if Q:
            rs3 = junc2_d3[vi] + j2x_v
            span3 = np.where(isq3_v, j3x_v, L_v) - j2x_v
            f3 = np.clip(np.searchsorted(self.frag_joined, rs3,
                                         "right") - 1, 0, nfr - 1)
            contained_3 = (rs3 >= self.frag_joined[f3]) & \
                (rs3 + span3 <= self.frag_joined[f3 + 1])
            seg2_end = rs_v + span_r_v      # exclusive, on the d2 diagonal
            rp_2end = self.frag_off[fr] + (seg2_end - 1
                                           - self.frag_joined[fr])
            rp_3 = self.frag_off[f3] + (rs3 - self.frag_joined[f3])
            j2l_v = np.where(isq2_v, rp_3 - rp_2end - 1, 0)
            ok_v &= ~isq2_v | (contained_3
                               & (self.frag_ref[f3] == self.frag_ref[fr])
                               & (j2l_v >= 1))
            # fourth segment (3-junction composites): containment +
            # reference-space intron length of the third junction
            rs4 = junc3_d4[vi] + j3x_v
            span4 = L_v - j3x_v
            f4 = np.clip(np.searchsorted(self.frag_joined, rs4,
                                         "right") - 1, 0, nfr - 1)
            contained_4 = (rs4 >= self.frag_joined[f4]) & \
                (rs4 + span4 <= self.frag_joined[f4 + 1])
            seg3_end = rs3 + span3
            rp_3end = self.frag_off[f3] + (seg3_end - 1
                                           - self.frag_joined[f3])
            rp_4 = self.frag_off[f4] + (rs4 - self.frag_joined[f4])
            j3l_v = np.where(isq3_v, rp_4 - rp_3end - 1, 0)
            ok_v &= ~isq3_v | (contained_4
                               & (self.frag_ref[f4] == self.frag_ref[f3])
                               & (j3l_v >= 1))
        valid = np.zeros(N, bool)
        valid[vi[ok_v]] = True
        ins_len = np.zeros(N, hdt)
        ins_len[vi] = insl_v
        junc_len = np.zeros(N, hdt)
        junc_len[vi] = jl_v
        junc2_len = np.zeros(N, hdt)
        junc2_len[vi] = j2l_v
        junc3_len = np.zeros(N, hdt)
        junc3_len[vi] = j3l_v
        L_of = lens[read_of_lane].astype(hdt, copy=False)

        tick("contain")
        # search-budget replay (nextBWT give-up, hi_aligner.h:3988-4035):
        # once an alignment scoring `best` exists, the reference performs at
        # most maxmm(best) + #splices(best) + 1 further non-unique search
        # rounds per orientation; candidates born in later rounds are never
        # generated.  `ab` = non-unique rounds before a candidate's earliest
        # source segment.
        selfgap_shadow = np.full(B, -2 ** 40, np.int64)
        vsel = np.flatnonzero(valid)
        if vsel.size:
            r_v = read_of_lane[vsel]
            sc_v = score[vsel]
            bestr = np.full(B, -2 ** 40, np.int64)
            np.maximum.at(bestr, r_v, sc_v)
            isb_v = sc_v == bestr[r_v]
            best_spl = np.zeros(B, bool)
            best_spl[r_v[(junc_kind[vsel] == splice_ops.KIND_SPL)
                         & isb_v]] = True
            maxmm = -(-np.maximum(-bestr, 0) // max(self.scoring.mm_max, 1))
            allowed = maxmm + best_spl + 1
            keep_v = (ab[vsel] <= allowed[r_v]) | isb_v
            # single-anchor gap joins survive only at the read's best
            # score: the reference's best-first local search never pursues
            # a strictly-worse gap once a better alignment exists (verified
            # vs oracle: an equal-score remote 32M1D68M IS reported, a
            # worse-by-2 remote 86M1I13M is not and never feeds ZS)
            sg_sup = selfgap[vsel] & (sc_v < bestr[r_v])
            keep_v &= ~sg_sup
            # ...but a worse gap join that is a representation of the BEST
            # placement's own region (diagonals differ by at most the gap
            # length) IS evaluated by the reference — extending that anchor
            # produces both forms — and its score feeds secbest/ZS without
            # ever being reported (oracle: 92M8S AS:-16 ZS:-17 where -17
            # is the suppressed 92M4D8M of the same locus; a gap at any
            # OTHER region never feeds ZS — the best-first search never
            # pursues it)
            # ...gated by the reference's local-search flank floors (the
            # gap must be reachable: head flank >= minAnchorLen, or for a
            # TAIL flank >= 8 read chars (del) / >= 9 genome chars (ins)
            # — oracle probe: a 6-char del tail or a 4bp-ins-in-6 tail is
            # never evaluated, so it must not feed ZS either)
            sup_i = np.flatnonzero(sg_sup & (sc_v >= minsc[r_v]))
            for j in sup_i:
                rj = r_v[j]
                cj = vsel[j]
                Lr = int(lens[rj])
                x = int(junc_x[cj])
                gl = int(junc_len[cj])
                if x <= Lr - x:           # head-side flank
                    if x < 7:
                        continue
                elif junc_kind[cj] == splice_ops.KIND_INS:
                    if Lr - x - max(-gl, 0) < 9:
                        continue
                elif Lr - x < 8:          # tail-side del
                    continue
                # the gap is only pursued off a CLIPPED best (an ungapped
                # extension with an unexplained tail); a clean best ends
                # the region's evaluation before any gap
                near_best = isb_v & (r_v == rj) \
                    & ((clip_l[vsel] + clip_r[vsel]) > 0) & (
                    np.abs(starts[vsel] - starts[vsel[j]]) <= 64)
                if near_best.any():
                    selfgap_shadow[rj] = max(selfgap_shadow[rj],
                                             int(sc_v[j]))
            # post-anchor-stop candidates exist only when the pre-stop
            # anchor's extension leaves part of the read uncovered
            # (hybridSearch re-search); a full-coverage candidate in the
            # same lane means the reference never searched further
            full0 = np.zeros(2 * B, bool)
            l_v = lane[vsel]
            full0[l_v[keep_v & ~post[vsel]
                      & (clip_l[vsel] + clip_r[vsel] == 0)]] = True
            keep_v &= ~(post[vsel] & full0[l_v])
            valid = np.zeros(N, bool)
            valid[vsel[keep_v]] = True

        tick("budget")
        # candidate-region merge (getAnchorHits `overlapped`, hi_aligner.h:
        # 4408-4419): a coordinate within maxIntronLen of a STRICTLY better
        # candidate merges into it (equal-score multimaps all survive -
        # verified vs oracle on an 800 bp-apart duplicated unit)
        W = self.scoring.max_intron_len
        Km0 = K
        validm0 = valid.reshape(2 * B, Km0)
        # only lanes with >= 2 surviving candidates can merge anything —
        # run the column scan on that (few-%) row subset only
        multi0 = np.flatnonzero(validm0.sum(axis=1) >= 2)
        if multi0.size:
            v_m = validm0[multi0]
            s_m0 = starts.reshape(2 * B, Km0)[multi0]
            sc_m0 = np.where(v_m, score.reshape(2 * B, Km0)[multi0],
                             np.int64(-2 ** 40))
            jk_m0 = junc_kind.reshape(2 * B, Km0)[multi0]
            ordm0 = np.lexsort((-jk_m0, s_m0, -sc_m0), axis=1)
            s_s0 = np.take_along_axis(s_m0, ordm0, axis=1)
            v_s0 = np.take_along_axis(v_m, ordm0, axis=1)
            sc_s0 = np.take_along_axis(sc_m0, ordm0, axis=1)
            R0 = multi0.size
            jk_s0 = np.take_along_axis(jk_m0, ordm0, axis=1)
            cl_s0 = np.take_along_axis(
                (clip_l + clip_r).astype(np.int64).reshape(
                    2 * B, Km0)[multi0], ordm0, axis=1)
            kept0 = np.zeros((R0, Km0), bool)
            kept_pos0 = np.full((R0, Km0), -2 ** 60, np.int64)
            kept_sc0 = np.full((R0, Km0), -2 ** 40, np.int64)
            kept_gap0 = np.zeros((R0, Km0), bool)
            minsc_m0 = minsc[multi0 % B]
            for r in range(Km0):
                # rows are sorted valid-(score desc)-first: the first column
                # with no valid entry anywhere ends the scan
                if not v_s0[:, r].any():
                    break
                cand = s_s0[:, r]
                csc = sc_s0[:, r]
                dk = np.abs(kept_pos0 - cand[:, None])
                better = kept_sc0 > csc[:, None]
                near = ((dk <= W) & better).any(axis=1)
                keep_r = v_s0[:, r] & ~near
                kept0[:, r] = keep_r
                # a merged-away representation of the SAME region (the
                # reference's ungapped anchor extension vs its gap join;
                # diagonals differ by at most the gap length) was still
                # EVALUATED by the reference: its score feeds secbest/ZS
                # (oracle: 90M2I8M AS:-11 ZS:-18, -18 = the merged clip
                # form); remote merged candidates never feed ZS
                # ...ungapped forms only: a merged gapped/spliced variant
                # (e.g. the novel-penalized twin of a known-injected
                # junction) is the SAME evaluation in the reference, not a
                # second one.  The clip form fires only with a clip of
                # trimMax-1..trimMax (= 9..10 at defaults) — oracle probe:
                # gap-best with clip form 8 or >= 11 shows no ZS, 9-10 do
                # (the trim5/trim3 re-report branch is what surfaces it)
                tmax0 = np.maximum(-minsc_m0, 0) \
                    // max(self.scoring.mm_min, 1)
                sup_r = v_s0[:, r] & near & (csc >= minsc_m0) \
                    & (jk_s0[:, r] == 0) \
                    & (cl_s0[:, r] >= tmax0 - 1) & (cl_s0[:, r] <= tmax0) \
                    & ((dk <= 64) & better & kept_gap0).any(axis=1)
                if sup_r.any():
                    np.maximum.at(selfgap_shadow, multi0[sup_r] % B,
                                  csc[sup_r])
                kept_pos0[:, r] = np.where(keep_r, cand, np.int64(-2 ** 60))
                kept_sc0[:, r] = np.where(keep_r, csc, np.int64(-2 ** 40))
                # DEL/INS bests only: a SPLICED best's clip form is never
                # re-reported (oracle: 90M200N10M AS:0 carries no ZS)
                kept_gap0[:, r] = keep_r & (
                    (jk_s0[:, r] == splice_ops.KIND_DEL)
                    | (jk_s0[:, r] == splice_ops.KIND_INS))
            vm0 = np.zeros((R0, Km0), bool)
            np.put_along_axis(vm0, ordm0, kept0, axis=1)
            validm0[multi0] &= vm0          # writes through into `valid`

        tick("regionmerge")
        # evaluation-order suppression (sink best gating): every combined
        # representation is reported only if its score beats the mate's
        # best-so-far (`minsc = max(minsc, sink.bestUnp1())`,
        # spliced_aligner.h:635-637 et al.) — a lane whose search completes
        # AFTER a better lane reports NOTHING below that best, and its
        # candidates never feed ZS/NH.  Completion order comes from the
        # interleaved-search replay (align/replay.py).
        best_before = np.full(2 * B, np.int64(-2 ** 40))
        orient_ranks = None
        if not paired and lanes_meta is not None \
                and "h_rounds" in lanes_meta:
            # the interleave replay runs for GRAPH indexes too: the
            # linear-FM round structure it replays is the same (variants
            # are handled in extension, not search), and enabling it
            # closed 29 graph-fuzz divergences (102 -> 73)
            valid, best_before, orient_ranks = self._eval_order_suppress(
                valid, score, junc_kind, lanes_meta, lens, minsc, B, K)

        tick("evalorder")
        # redundancy rule (HI_Aligner::redundant): a candidate whose
        # leftmost aligned position falls WITHIN the reference extent of an
        # already-reported alignment of the same mate (either orientation)
        # is never reported.  Processing order approximates the reference's
        # best-first reporting: score desc, junction forms first on ties
        # (the spliced extension of an anchor wins over an equal-scoring
        # ungapped placement it contains), then position.
        Km = K
        K2 = 2 * Km
        validm = valid.reshape(2 * B, Km)
        # fold fw/rc lanes of the same mate together (redundant() scans all
        # reported alignments of the mate regardless of orientation); only
        # reads with >= 2 surviving candidates can suppress anything — the
        # column scan runs on that (few-%) row subset only
        vread = np.concatenate([validm[:B], validm[B:]], axis=1)  # [B, 2Km]
        shadow_sec = selfgap_shadow.copy()
        rsel = np.flatnonzero(vread.sum(axis=1) >= 2)
        if rsel.size:
            rsel2 = np.concatenate([rsel, rsel + B])   # both lanes
            ext_start = ((starts + clip_l)
                         .reshape(2 * B, Km)[rsel2])   # [2R, Km]
            span_m = ((L_of - clip_l - clip_r
                       - np.where(is_pair, ins_len, 0)
                       + np.where(junc_kind > 0, junc_len, 0)
                       + junc2_len + junc3_len).reshape(2 * B, Km)[rsel2])
            R = rsel.size
            vsub = vread[rsel]
            s_r = np.concatenate([ext_start[:R], ext_start[R:]], axis=1)
            e_r = s_r + np.concatenate([span_m[:R], span_m[R:]],
                                       axis=1) - 1
            scm = score.reshape(2 * B, Km)[rsel2]
            sc_r = np.where(vsub, np.concatenate([scm[:R], scm[R:]],
                                                 axis=1),
                            np.int64(-2 ** 40))
            jkm = junc_kind.reshape(2 * B, Km)[rsel2]
            jk_r = np.concatenate([jkm[:R], jkm[R:]], axis=1)
            jxm = junc_x.reshape(2 * B, Km)[rsel2]
            jx_r = np.concatenate([jxm[:R], jxm[R:]], axis=1)
            # known-site junction forms outrank novel ones at equal
            # (score, start): the reference's combineWith tries known
            # sites first and keeps the first perfect form, so an
            # equal-scoring novel placement must not shadow the known
            # one (observed: a known len-127 intron vs a chance novel
            # len-138 form, both score 0)
            knm = junc_known.reshape(2 * B, Km)[rsel2]
            kn_r = np.concatenate([knm[:R], knm[R:]], axis=1)
            # forgiven catalog-indel representations rank BELOW plain
            # forms at equal (score, start): the reference's extension
            # walk engages ALT indels only at raw mismatches, so an
            # equal-scoring 96M1I3M twin of a plain 100M (fz933/jf66
            # class: the injected event does not absorb a mismatch) is
            # never generated there — the plain form must be kept and
            # the indel twin treated as a duplicate (no ZS; the sink's
            # same-coord record is the plain one)
            evm = junc_snp.reshape(2 * B, Km)[rsel2]
            ev_r = np.concatenate([evm[:R], evm[R:]], axis=1)
            forg_ind = ((jk_r == splice_ops.KIND_DEL)
                        | (jk_r == splice_ops.KIND_INS)) & (ev_r >= 0)
            ordm = np.lexsort((-jk_r, -kn_r, forg_ind, s_r, -sc_r),
                              axis=1)
            s_s = np.take_along_axis(s_r, ordm, axis=1)
            e_s = np.take_along_axis(e_r, ordm, axis=1)
            v_s = np.take_along_axis(vsub, ordm, axis=1)
            crm = (clip_l + clip_r).reshape(2 * B, Km)[rsel2]
            full_r = np.concatenate([crm[:R], crm[R:]], axis=1) == 0
            full_s = np.take_along_axis(full_r, ordm, axis=1)
            sc_s = np.take_along_axis(sc_r, ordm, axis=1)
            jx_s = np.take_along_axis(jx_r, ordm, axis=1)
            fi_s = np.take_along_axis(forg_ind, ordm, axis=1)
            kept = np.zeros((R, K2), bool)
            kept_s = np.full((R, K2), -2 ** 60, np.int64)
            kept_e = np.full((R, K2), -2 ** 60, np.int64)
            kept_jx = np.full((R, K2), -1, np.int64)
            # redundancy-suppressed candidates still count as secondary-best
            # evidence (the reference's sink saw them; they feed ZS but
            # neither NH nor MAPQ - observed: spliced primary with ZS:i:0
            # from its contained equal-scoring ungapped representation)
            shadow_sub = np.full(R, -2 ** 40, np.int64)
            for r in range(K2):
                if not v_s[:, r].any():
                    break
                cand = s_s[:, r]
                inside = ((cand[:, None] >= kept_s)
                          & (cand[:, None] <= kept_e)).any(axis=1)
                keep_r = v_s[:, r] & ~inside
                kept[:, r] = keep_r
                kept_s[:, r] = np.where(keep_r, cand, np.int64(-2 ** 60))
                kept_e[:, r] = np.where(keep_r, e_s[:, r],
                                        np.int64(-2 ** 60))
                kept_jx[:, r] = np.where(keep_r, jx_s[:, r], -1)
                # an exact same-start suppression with the SAME junction
                # shape is a duplicate representation of the kept
                # alignment, not secondary evidence; a same-start form
                # with a DIFFERENT junction (e.g. a shifted motif-less
                # splice point from a neighboring temp site) is a
                # distinct alignment the reference reports, so its score
                # still feeds ZS
                same_start = ((cand[:, None] == kept_s)
                              & (jx_s[:, r][:, None] == kept_jx)) \
                    .any(axis=1)
                # a forgiven-indel twin at the SAME start as any kept
                # form is a duplicate representation (fz933 class: the
                # oracle's sink holds only the plain same-coord record,
                # ZS comes from the true second-best placement)
                same_start |= (fi_s[:, r]
                               & (cand[:, None] == kept_s).any(axis=1))
                supp = v_s[:, r] & inside & full_s[:, r] & ~same_start
                shadow_sub = np.where(
                    supp, np.maximum(shadow_sub, sc_s[:, r]), shadow_sub)
            vr = np.zeros((R, K2), bool)
            np.put_along_axis(vr, ordm, kept, axis=1)
            validm[rsel] &= vr[:, :Km]      # writes through into `valid`
            validm[rsel + B] &= vr[:, Km:]
            shadow_sec[rsel] = shadow_sub

        tick("redundancy")
        lane_best = np.full(2 * B, -2 ** 40, np.int64)
        sel = np.flatnonzero(valid)
        if sel.size:
            np.maximum.at(lane_best, lane[sel], score[sel])
        if lanes_meta is not None:
            lanes_meta["best"] = lane_best
        if not sel.size:
            return BatchResult(n_reads=B, lanes=lanes_meta,
                               orient_ranks=orient_ranks)
        # dedup identical (read, orient, start, junction), keeping the BEST
        # score per placement (a known splice site and the novel sweep can
        # produce the same junction; the known, unpenalized one must win)
        r = read_of_lane[sel]
        o = is_rc[sel].astype(np.int64)
        s = starts[sel].astype(np.int64)
        key = ((((((r * 2 + o) << 33) + s) << 2) + junc_kind[sel]) << 7) \
            + junc_x[sel]
        kd2 = (junc_len[sel] * 256 + junc2_x[sel] % 256) * 128 \
            + junc3_x[sel] % 128
        perm = np.lexsort((-score[sel], kd2, key))
        kk, kk2 = key[perm], kd2[perm]
        firstmask = np.ones(len(perm), bool)
        firstmask[1:] = (kk[1:] != kk[:-1]) | (kk2[1:] != kk2[:-1])
        idx = sel[perm[firstmask]]
        r, o = read_of_lane[idx], is_rc[idx].astype(np.int64)
        s = starts[idx].astype(np.int64)
        sc = score[idx].astype(np.int64)
        # deterministic selection order: per read, score desc then position,
        # ungapped before junction candidates at equal (score, position)
        order = np.lexsort((junc_x[idx], -junc_known[idx],
                            junc_kind[idx], o, s, -sc, r))
        idx, r, o, s, sc = idx[order], r[order], o[order], s[order], sc[order]
        # per-read segments
        bnd = np.flatnonzero(np.diff(r, prepend=-1))
        seg_len = np.diff(np.append(bnd, len(r)))
        seg_of = np.repeat(np.arange(len(bnd)), seg_len)
        pos_in_seg = np.arange(len(r)) - bnd[seg_of]
        # per-segment summary -> MAPQ (vectorized BowtieMapq2).  The secbest
        # considers BOTH the second distinct placement and the best
        # alternate representation of the best placement (trimmed variants
        # the reference also counts into AlnSetSumm — hence ZS with NH:i:1)
        seg_read = r[bnd]
        best = sc[bnd]
        # trimmed-representation ZS: the reference's trim5/trim3 branches
        # (spliced_aligner.h:1065-1105) REPORT a soft-clipped copy of the
        # anchor when the clip needed to shed the outermost penalized
        # column is within trimMax = -minsc / mm_min of the lane end
        # (probe-verified against the oracle: at defaults a 5' clip fires
        # for <= 10, a 3' clip for <= 9, independent of orientation and
        # window content).  The trimmed copy enters the report buffer and
        # becomes ZS, but the selected best's MAPQ ignores it.
        tick("dedup")
        gb = idx[bnd]
        alt_of_best = np.full(len(bnd), -2 ** 40, np.int64)
        # trimmed-representation scores come precomputed from the device
        # (extend_grouped alt_score: T-gated trim-through-first/last
        # penalized column, the probe-verified zsalt formula) — the host
        # only applies the minsc and sink-best gates, on eligible segments
        # (full ungapped best alignments with >= 1 penalized column)
        # ungapped bests with any penalized or clipped column are
        # eligible; the device alt already excludes the selected form
        # itself (ops/extend.py anchor-form model), so clipped bests
        # can carry a losing both-clips form (oracle: mm@{8,99} primary
        # 99M1S with ZS:-20)
        el = np.flatnonzero((junc_kind[gb] == 0)
                            & (((n_mm[gb] + n_n[gb]) > 0)
                               | (clip_l[gb] > 0) | (clip_r[gb] > 0)))
        if el.size:
            ge = gb[el]
            rde = seg_read[el]
            alt = alt_dev[ge].astype(np.int64)
            alt = np.where(alt >= minsc[rde], alt, np.int64(-2 ** 40))
            # a trimmed representation is reported during its candidate's
            # own processing, but still sits behind the sink best gate of
            # earlier-completing lanes
            alt = np.where(alt >= best_before[lane[ge]], alt,
                           np.int64(-2 ** 40))
            alt_of_best[el] = alt
        # spliced trimmed-representation ZS: for a single-junction best
        # with raw mismatch(es) in a terminal flank, the reference's
        # recursion REPORTS the intermediate soft-clipped form before the
        # 1-mm-per-level direct extension completes the alignment
        # (spliced_aligner.h:1065-1105 trim branch, then :1770-1830) —
        # each such intermediate scores best + pen(trimmed mms) -
        # clip(k) and feeds secbest/ZS (oracle-verified closed form on
        # the RNA fuzz: ZS = AS + 6 - 2k at q40 for every flank mm)
        # (the raw n_mm column is 0 for spliced candidates — flank
        # mismatches are only recovered at render time — so eligibility
        # is by score and the mismatch scan below decides)
        # the stage-walk caps below (r_cap 9/5/0, left 10, mkl=8) were
        # oracle-fitted AT DEFAULT SCORING (--mp 6,2 --sp 2,1
        # --score-min L,0,-0.2); under other penalty settings the
        # trimmed-intermediate geometry changes and the zs_cand > best_e
        # branch could silently rewrite the primary — gate the whole
        # model to default scoring and fall back to no-ZS otherwise
        sc_def = self.scoring
        default_scoring = (
            sc_def.mm_max == 6 and sc_def.mm_min == 2
            and sc_def.sp_max == 2 and sc_def.sp_min == 1
            and not sc_def.no_softclip
            and sc_def.score_min == SimpleFunc("L", 0.0, -0.2))
        elj = np.flatnonzero((junc_kind[gb] == 1)
                             & (junc2_kind[gb] == 0)
                             & (clip_l[gb] == 0) & (clip_r[gb] == 0)
                             & (best < 0)) if default_scoring else \
            np.empty(0, np.int64)
        if elj.size:
            mmtab = self.scoring.mm_pen_table()
            cliptab = self.scoring.clip_pen_table()
            ref = self.ref_codes
            snv_pos = snv_alt = None
            if self.variants is not None and \
                    len(getattr(self.variants, "snp_pos", ())):
                kind = np.asarray(self.variants.snp_kind)
                sgl = np.flatnonzero(kind == 0)
                jo = np.asarray(self.variants.snp_joined)[sgl]
                so_v = np.argsort(jo, kind="stable")
                snv_pos = jo[so_v].astype(np.int64)
                snv_alt = np.asarray(
                    self.variants.snp_seq)[sgl][so_v].astype(np.int64)

            def forgiven(jpos, rdc):
                if snv_pos is None:
                    return False
                i = int(np.searchsorted(snv_pos, jpos, side="left"))
                while i < len(snv_pos) and snv_pos[i] == jpos:
                    if snv_alt[i] == rdc:
                        return True
                    i += 1
                return False

            for e in elj:
                g = int(gb[e])
                rd = int(seg_read[e])
                L = int(lens[rd])
                rc_f = bool(o[bnd[e]])
                seq_or = codes[rd, :L].astype(np.int64)
                qual_or = quals[rd, :L].astype(np.int64)
                if rc_f:
                    seq_or = np.where(seq_or < 4, 3 - seq_or,
                                      seq_or)[::-1]
                    qual_or = qual_or[::-1]
                # batch quals are PHRED (io.fasta decode_quals)
                ph = np.clip(qual_or, 0, 40)
                s0 = int(s[bnd[e]])
                jx = int(junc_x[g])
                jl = int(junc_len[g])
                if jx <= 0 or jx >= L or jl <= 0 \
                        or s0 + jl + L > len(ref):
                    continue
                exp = np.empty(L, np.int64)
                exp[:jx] = ref[s0:s0 + jx]
                exp[jx:] = ref[s0 + jx + jl:s0 + jl + L]
                diff = np.flatnonzero((exp != seq_or) & (seq_or < 4)
                                      & (exp < 4))
                raw_mm = [int(p) for p in diff
                          if not forgiven(s0 + p + (jl if p >= jx
                                                    else 0),
                                          int(seq_or[p]))]
                if not raw_mm:
                    continue
                best_e = int(best[e])
                gate = max(int(minsc[rd]), int(best_before[lane[g]]))
                pen = {p: int(mmtab[ph[p]]) for p in raw_mm}
                zs_cand = -2 ** 40
                win = None                   # (side, k) of best trim
                # trimMax = (stage - gate) // sc(0), sc(0) = sp_min
                # flank-length caps (oracle-fitted on the RNA fuzz,
                # consistent with the round-2 ungapped probe bounds
                # 5' <= 10 / 3' <= 9): whether the trimmed intermediate
                # completes its own junction re-combine depends on the
                # motif class — right flanks complete for canonical
                # k <= 9, semi-canonical k <= 5, never for motif-less;
                # left flanks for k <= 10 regardless of motif
                sdir = int(spl_dir[g])
                r_cap = 9 if sdir in (1, 2) else (
                    5 if sdir in (3, 4) else 0)
                sp_min = int(cliptab[0])
                # stage walk, innermost flank mm outward: at stage t the
                # recursion is stuck at mm p_t and reports the trim; it
                # advances past p_t only when the direct extension gate
                # holds — rext = gap to the next stop >= min(minK_local,
                # remaining) (spliced_aligner.h:1801: rightext >=
                # min(_minK_local, rdlen - len - rdoff))
                mkl = 8
                # trims may not consume a whole exon segment
                right = sorted(p for p in raw_mm if p > jx)
                for t, p in enumerate(right):
                    k = L - p
                    stage = best_e + sum(pen[q2] for q2 in right[t:])
                    clip = int(cliptab[ph[p:]].sum())
                    cand = stage - clip
                    if k <= r_cap and k < (stage - gate) // sp_min \
                            and cand >= int(minsc[rd]) and cand > zs_cand:
                        zs_cand, win = cand, ("r", k)
                    nxt = right[t + 1] if t + 1 < len(right) else L
                    if nxt - p < min(mkl, k):
                        break          # direct-ext gate fails: no deeper
                left_f = sorted((p for p in raw_mm if p < jx - 1),
                                reverse=True)
                for t, p in enumerate(left_f):
                    k = p + 1
                    stage = best_e + sum(pen[q2] for q2 in left_f[t:])
                    clip = int(cliptab[ph[:p + 1]].sum())
                    cand = stage - clip
                    if k <= 10 and k < (stage - gate) // sp_min and \
                            cand >= int(minsc[rd]) and cand > zs_cand:
                        zs_cand, win = cand, ("l", k)
                    nxt = left_f[t + 1] if t + 1 < len(left_f) else -1
                    if p - nxt < min(mkl, k):
                        break
                if win is None:
                    continue
                if zs_cand > best_e:
                    # the trimmed form outranks the full one: the
                    # reference reports the trim FIRST, then the direct
                    # extension's full form fails the sink-best gate and
                    # is never reported — so the soft-clipped variant IS
                    # the alignment, with no ZS (oracle rf182 shape)
                    if win[0] == "r":
                        clip_r[g] = win[1]
                    else:
                        clip_l[g] = win[1]
                    sc[bnd[e]] = zs_cand
                    best[e] = zs_cand
                elif zs_cand > alt_of_best[e]:
                    alt_of_best[e] = zs_cand
        tick("zsalt")
        alt_valid = alt_of_best >= minsc[seg_read]
        sec_cand = np.where(seg_len > 1,
                            sc[np.minimum(bnd + 1, len(r) - 1)],
                            np.int64(-2 ** 40))
        # ZS counts trimmed representations of the best placement too;
        # MAPQ's secbest counts only DISTINCT placements (the reference
        # reports ZS yet MAPQ 60 when the only secbest is a trimmed variant)
        secbest = np.maximum(sec_cand, np.where(alt_valid, alt_of_best,
                                                np.int64(-2 ** 40)))
        shadow = shadow_sec[seg_read]
        secbest = np.maximum(secbest, shadow)
        has_sec = (seg_len > 1) | alt_valid | (shadow > -2 ** 39)
        perfect = np.array([self.scoring.perfect_score(int(l))
                            for l in ulens], np.int64)[uinv[seg_read]]
        mq = mapq_mod.mapq_selected(best, np.maximum(sec_cand, -2 ** 30),
                              seg_len > 1, perfect, minsc[seg_read])
        seg_zs = np.where(has_sec, secbest, 0)
        n_rep = np.minimum(seg_len, self.k)
        # the report pool keeps ALL selectable placements (the RNG
        # tie-break shuffles the full streak before truncating to k,
        # selectByScore aln_sink.h:2504) — truncation to k happens in
        # finalize_unpaired
        keep = pos_in_seg < np.minimum(seg_len, self.msize)[seg_of]
        # fragment mapping for kept candidates
        ki = np.flatnonzero(keep)
        gi = idx[ki]
        astart = (s[ki] + clip_l[gi]).astype(np.int64)
        fi = np.searchsorted(self.frag_joined, astart, "right") - 1
        ref_id = self.frag_ref[fi]
        ref_pos = self.frag_off[fi] + (astart - self.frag_joined[fi])
        rd_len = lens[r[ki]]
        # array-native result (RAW_COLS order); Alignment objects
        # materialize lazily only for object-path consumers
        so = seg_of[ki]
        cols = [r[ki], o[ki], ref_id, ref_pos, s[ki],
                clip_l[gi], clip_r[gi],
                (rd_len.astype(np.int64) - clip_l[gi] - clip_r[gi]
                 + junc_len[gi] + junc2_len[gi] + junc3_len[gi]),
                sc[ki], n_mm[gi], n_n[gi], mq[so], n_rep[so],
                pos_in_seg[ki] > 0, has_sec[so], seg_zs[so],
                junc_kind[gi], junc_x[gi], junc_len[gi], d2[gi],
                spl_dir[gi], junc_known[gi], junc_snp[gi],
                junc2_kind[gi], junc2_x[gi], junc2_len[gi],
                junc2_d3[gi], junc2_dir[gi],
                junc3_kind[gi], junc3_x[gi], junc3_len[gi],
                junc3_d4[gi], junc3_dir[gi]]
        tick("finish")
        tick(None)
        return BatchResult(n_reads=B, orient_ranks=orient_ranks,
                           lanes=lanes_meta, raw={"cols": cols})
