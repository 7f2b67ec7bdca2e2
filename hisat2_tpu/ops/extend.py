"""Batched ungapped extension + scoring over the packed reference.

Batched reshaping of GenomeHit::extend / alignWithALTs_recur
(hi_aligner.h:1891-3377): instead of a per-read recursive
byte-compare against BitPairReference::getStretch, every candidate
(read lane, genome start) becomes one vector lane; the whole read is gathered
from the 2-bit reference and compared in one fused pass, with
quality-dependent mismatch penalties (Scoring::mm, scoring.h:294) and the
constant N penalty applied elementwise.

Candidates are GROUPED per read lane ([B, C] starts): the read/quality
arrays broadcast along C instead of being gathered, so the only large gather
is the reference stretch.

Soft-clipping: HISAT2 end-to-end alignments may trim either end with a
per-base penalty (GenomeHit::calculateScore, hi_aligner.h:3695-3702;
Scoring::sc, scoring.h:312-318).  Penalty minimization over (trim5, trim3)
decomposes into two independent prefix/suffix maximizations solved with
cumulative sums + argmax per lane — no search loop.  Reference quirk
replicated: the trim3 clip cost indexes quality from the *start* of the read
(hi_aligner.h:3700-3702 uses qual[i] for i < _trim3).

ALT (SNP/indel) branching and spliced joins layer on top (align/graph,
align/splice).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import compact as compact_ops
from . import rank as rk

_OOB_PEN = 100000  # out-of-text column: forces the optimizer to clip it
NO_ALT = -(2 ** 30)  # alt_score when no alternate representation exists


class ExtendResult(NamedTuple):
    score: jnp.ndarray    # int32 [B, C] total score (<= 0), best clipping
    n_mm: jnp.ndarray     # int32 [B, C] mismatches within the aligned region
                          #   (known-SNP matches excluded, like the
                          #    reference's snpID-tagged edits)
    n_n: jnp.ndarray      # int32 [B, C] read-N columns within aligned region
    n_snp: jnp.ndarray    # int32 [B, C] columns matched via a known SNP alt
    clip_l: jnp.ndarray   # int32 [B, C] soft-clip at read start (trim5)
    clip_r: jnp.ndarray   # int32 [B, C] soft-clip at read end (trim3)
    ok: jnp.ndarray       # bool  [B, C] aligned region non-empty and in-text
    alt_score: jnp.ndarray  # int32 [B, C] best ALTERNATE representation of
                          #   the same placement (clip through the first/
                          #   last penalized column, or undo the optimal
                          #   clip).  The reference surfaces these trimmed
                          #   GenomeHits as secbest scores (ZS tag); NO_ALT
                          #   when the candidate has no penalized column.


class PenPlanes(NamedTuple):
    """Per-candidate-diagonal column data, shared by the ungapped extension
    and the junction sweep (ops/splice.py)."""
    pen: jnp.ndarray       # int32 [B, C, L] penalty, known SNPs forgiven
    pen_raw: jnp.ndarray   # int32 [B, C, L] penalty, SNPs NOT forgiven
    mm: jnp.ndarray        # bool  [B, C, L] mismatch (SNP-forgiven)
    mm_raw: jnp.ndarray    # bool  [B, C, L] mismatch incl. SNP matches
    isn: jnp.ndarray       # bool  [B, C, L] read-N column
    snp_ok: jnp.ndarray    # bool  [B, C, L] column matched via known SNP
    vp: jnp.ndarray        # bool  [B, C, L] column within read length


def pen_planes(ref_words, n_text: int, reads, quals, lens, cand_start,
               mm_pen, n_pen: int,
               snv_delta1=None, snv_delta2=None,
               win_chars=None, win_margin: int = 0,
               snv1_win=None, snv2_win=None) -> PenPlanes:
    """Gather reference chars along candidate diagonals and compute
    per-column penalties (one big gather; everything else fuses).

    win_chars/snv*_win: optional pre-gathered diagonal windows
    (splice.diag_chars output, [B, C, L + 2*win_margin]) — the junction
    sweep gathers the same diagonals with margin, so the pipeline gathers
    once and both consumers slice."""
    rd = reads[:, None, :]                                    # [B, 1, L]
    q = jnp.minimum(quals, 63)[:, None, :]
    ln = lens[:, None]                                        # [B, 1]
    L = reads.shape[1]
    col = jnp.arange(L, dtype=jnp.int32)[None, None, :]
    pos = cand_start[:, :, None] + col                        # [B, C, L]
    vp = jnp.broadcast_to(col < ln[:, :, None], pos.shape)

    oob = vp & ((pos < 0) | (pos >= n_text))
    if win_chars is not None:
        rc4 = win_chars[:, :, win_margin:win_margin + L]
    else:
        rc4 = rk.ref_chars_block(ref_words, n_text, cand_start, L)
    rc = jnp.minimum(rc4, 3)          # keep legacy clip-to-text semantics
    isn = vp & (rd >= 4)
    mm_raw = vp & (rd < 4) & (rd != rc) & ~oob
    if snv_delta1 is not None:
        v1 = (snv1_win[:, :, win_margin:win_margin + L]
              if snv1_win is not None
              else rk.ref_chars_block(snv_delta1, n_text, cand_start, L))
        v2 = (snv2_win[:, :, win_margin:win_margin + L]
              if snv2_win is not None
              else rk.ref_chars_block(snv_delta2, n_text, cand_start, L))
        v1 = jnp.minimum(v1, 3)
        v2 = jnp.minimum(v2, 3)
        snp_ok = mm_raw & (((v1 != 0) & (rd == ((rc + v1) & 3)))
                           | ((v2 != 0) & (rd == ((rc + v2) & 3))))
        mm = mm_raw & ~snp_ok
    else:
        snp_ok = jnp.zeros_like(mm_raw)
        mm = mm_raw
    base = (jnp.where(isn, np.int32(n_pen), 0)
            + jnp.where(oob, np.int32(_OOB_PEN), 0))
    mmp = jnp.where(mm, mm_pen[q], 0)
    pen = mmp + base
    pen_raw = jnp.where(mm_raw, mm_pen[q], 0) + base
    return PenPlanes(pen=pen, pen_raw=pen_raw, mm=mm, mm_raw=mm_raw,
                     isn=isn, snp_ok=snp_ok, vp=vp)


def live_pen_prefix(ref_words, n_text: int, reads, quals, lens,
                    mm_pen, n_pen: int, fresh, live, pos_list,
                    snv_delta1=None, snv_delta2=None, chunk: int = 4096):
    """Penalty/raw-mismatch prefix SCALARS along only the LIVE fresh
    diagonals of an injection candidate grid.

    The event-injection kernels (ops/splice.py inject_known /
    inject_indels) multiply candidate columns ~5x, but each injected
    column consumes only a handful of scalars from its penalty plane:
    the forgiven-penalty prefix at the junction split point(s) and the
    plane totals.  Materializing full [N, J, L] planes for every column
    gathers ~50M reference chars per batch while typically <2% of the
    columns are live (a nearby catalog event within the read window).
    Here live columns are compacted to the front (stable argsort — the
    same trick as ops/resolve.resolve_rows_sparse), their planes are
    computed `chunk` columns at a time under a while_loop with a
    dynamic trip count, reduced immediately to the requested scalars,
    and scattered back by prefix-sum position.  Bit-identical to the
    dense plane prefixes: integer masked sums equal cumsum+gather.

    fresh/live: [N, J]; pos_list: list of [N, J] int32 read positions
    (prefix taken over columns < p, i.e. P[p] of the [0, cumsum] plane).
    Returns (pen_total, mm_total, [(pen_at_p, mm_at_p), ...]) — all
    [N, J] int32, zeros on dead columns.
    """
    N, J = fresh.shape
    L = reads.shape[1]
    M = N * J
    nP = len(pos_list)
    S = 2 + 2 * nP
    fresh_f = fresh.reshape(-1)
    pos_f = [p.reshape(-1) for p in pos_list]

    def scalars(colids):
        lane = colids // J
        rd = reads[lane]
        q = jnp.minimum(quals[lane], 63)
        ln = lens[lane]
        st = fresh_f[colids]
        colL = jnp.arange(L, dtype=jnp.int32)[None, :]
        posg = st[:, None] + colL
        vp = colL < ln[:, None]
        oob = vp & ((posg < 0) | (posg >= n_text))
        rc4 = rk.ref_chars_block(ref_words, n_text, st[:, None], L)[:, 0]
        rc = jnp.minimum(rc4, 3)
        isn = vp & (rd >= 4)
        mm_raw = vp & (rd < 4) & (rd != rc) & ~oob
        if snv_delta1 is not None:
            v1 = jnp.minimum(rk.ref_chars_block(
                snv_delta1, n_text, st[:, None], L)[:, 0], 3)
            v2 = jnp.minimum(rk.ref_chars_block(
                snv_delta2, n_text, st[:, None], L)[:, 0], 3)
            snp_ok = mm_raw & (((v1 != 0) & (rd == ((rc + v1) & 3)))
                               | ((v2 != 0) & (rd == ((rc + v2) & 3))))
            mm = mm_raw & ~snp_ok
        else:
            mm = mm_raw
        pen = (jnp.where(mm, mm_pen[q], 0)
               + jnp.where(isn, np.int32(n_pen), 0)
               + jnp.where(oob, np.int32(_OOB_PEN), 0))
        mint = mm_raw.astype(jnp.int32)
        outs = [pen.sum(axis=1), mint.sum(axis=1)]
        for pf in pos_f:
            m = colL < pf[colids][:, None]
            outs.append(jnp.where(m, pen, 0).sum(axis=1))
            outs.append(jnp.where(m, mint, 0).sum(axis=1))
        return jnp.stack(outs, axis=1)                       # [K, S]

    def unpack(rows):
        outs = [rows[:, i].reshape(N, J) for i in range(S)]
        return outs[0], outs[1], [(outs[2 + 2 * i], outs[3 + 2 * i])
                                  for i in range(nP)]

    lv = live.reshape(-1)
    if M <= chunk:
        vals = jnp.where(lv[:, None],
                         scalars(jnp.arange(M, dtype=jnp.int32)), 0)
        return unpack(vals)
    lvi = lv.astype(jnp.int32)
    posc = jnp.cumsum(lvi) - lvi                 # exclusive prefix sum
    total = posc[-1] + lvi[-1]
    src = jnp.argsort(1 - lvi, stable=True).astype(jnp.int32)
    nch = (M + chunk - 1) // chunk
    Mp = nch * chunk
    srcp = jnp.zeros((Mp,), jnp.int32).at[:M].set(src)
    buf0 = jnp.zeros((Mp, S), jnp.int32)

    def cond(st):
        return st[0] * chunk < total

    def body(st):
        k, buf = st
        ids = jax.lax.dynamic_slice(srcp, (k * chunk,), (chunk,))
        return k + 1, jax.lax.dynamic_update_slice(
            buf, scalars(ids), (k * chunk, 0))

    _, buf = jax.lax.while_loop(cond, body, (jnp.int32(0), buf0))
    rows = buf[jnp.minimum(posc, Mp - 1)]
    return unpack(jnp.where(lv[:, None], rows, 0))


def extend_grouped(ref_words, n_text: int, reads, quals, lens,
                   cand_start, mm_pen, clip_pen, n_pen: int,
                   allow_softclip: bool = True,
                   snv_delta1=None, snv_delta2=None,
                   planes: PenPlanes = None,
                   uniform_len: bool = False,
                   minsc=None, mm_min: int = 1) -> ExtendResult:
    """reads/quals: int32 [B, L]; lens: int32 [B]; cand_start: int32 [B, C]
    (joined genome start per candidate; negative = invalid).
    mm_pen / clip_pen: int32 [64] per-quality penalty tables.
    snv_delta1/2: optional 2-bit SNP planes (index/graph.py) — a column
    whose read base equals a known alt allele scores as a match
    (alignWithALTs semantics, hi_aligner.h:2586)."""
    B, L = reads.shape
    C = cand_start.shape[1]
    q = jnp.minimum(quals, 63)[:, None, :]
    ln = lens[:, None]                                        # [B, 1]
    col = jnp.arange(L, dtype=jnp.int32)[None, None, :]
    if planes is None:
        planes = pen_planes(ref_words, n_text, reads, quals, lens,
                            cand_start, mm_pen, n_pen, snv_delta1, snv_delta2)
    pen, mm, isn, snp_ok, vp = (planes.pen, planes.mm, planes.isn,
                                planes.snp_ok, planes.vp)
    total_pen = pen.sum(axis=-1)                              # [B, C]

    lnc = jnp.broadcast_to(ln, (B, C))
    if allow_softclip:
        ccost = jnp.where(vp, clip_pen[q], 0)
        zeros = jnp.zeros((B, C, 1), jnp.int32)
        # prefix penalty sums P[a] = sum(pen[:a]); clip-cost prefix C[a]
        P = jnp.concatenate([zeros, jnp.cumsum(pen, axis=-1)], axis=-1)
        Cc = jnp.concatenate([zeros, jnp.cumsum(ccost, axis=-1)], axis=-1)
        brange = jnp.arange(L + 1, dtype=jnp.int32)[None, None, :]
        in_read = brange <= lnc[:, :, None]
        # trim-anchor rule (oracle-probed, spliced_aligner.h:1065-1105
        # trim branches + hybridSearch anchor structure): a clipped
        # representation exists only when the kept region's boundary
        # abuts a penalty-free run of >= minAnchorLen(7) columns — the
        # reference's trims fire off an extended anchor, and anchors
        # shorter than that are never extended (probes: mm at {94,98}
        # stays 100M because the 95..97 island is 3 cols, while mm at
        # {50,98} clips 98M2S off the 47-col anchor; {92,99} stays
        # 100M — 93..98 is 6 cols — but {91,99} clips 99M1S off the
        # 7-col 92..98 anchor)
        pencol = (pen > 0) & vp
        colg = jnp.arange(L, dtype=jnp.int32)[None, None, :]
        lastpen = jax.lax.cummax(
            jnp.where(pencol, colg, jnp.int32(-1)), axis=2)
        nextpen = jnp.flip(jax.lax.cummax(
            jnp.flip(jnp.where(pencol, jnp.int32(L) - 1 - colg,
                               jnp.int32(-1)), -1), axis=2), -1)
        nextpen = jnp.where(nextpen >= 0, jnp.int32(L) - 1 - nextpen,
                            lnc[:, :, None])
        # run_l[a] = pen-free run starting at column a (for a < L)
        run_l = jnp.concatenate(
            [jnp.minimum(nextpen, lnc[:, :, None]) - colg,
             jnp.zeros((B, C, 1), jnp.int32)], axis=-1)
        # run_r[a] = pen-free run ending just below boundary a
        run_r = jnp.concatenate(
            [zeros, colg - lastpen], axis=-1)
        # left clip of a columns gains P[a] - C[a].  On gain TIES the
        # reference keeps the LARGER clip (its trim loop scans clip
        # lengths ascending with >=; oracle: 6S94M beats the equal-score
        # 3S97M+1mm form) — argmax returns the FIRST max, so take it on
        # the reversed axis
        MINA = np.int32(7)                     # tpol.minAnchorLen
        lgs = jnp.where(in_read & ((brange == 0) | (run_l >= MINA)),
                        P - Cc, -1)
        clip_l = (jnp.int32(L)
                  - jnp.argmax(lgs[..., ::-1], axis=-1)).astype(jnp.int32)
        gl = compact_ops.take_last(lgs, clip_l)
        # right clip of b columns gains (P[len] - P[len-b]) - C[b]
        # (trim3 clip COST uses quality of the first b columns — replicating
        # hi_aligner.h:3700-3702 exactly)
        if uniform_len:
            # all lens == L (STATIC flag, the padded-batch common case):
            # P[len-b] is a pure reversal, which avoids the general
            # per-lane gather below
            p_at = jnp.flip(P, -1)
            r_at = jnp.flip(run_r, -1)
        else:
            bsel = jnp.maximum(lnc[:, :, None] - brange, 0)
            p_at = jnp.take_along_axis(P, bsel, -1)
            r_at = jnp.take_along_axis(run_r, bsel, -1)
        p_len = compact_ops.take_last(P, lnc)[:, :, None]
        rgs = jnp.where(in_read & ((brange == 0) | (r_at >= MINA)),
                        p_len - p_at - Cc, -1)
        clip_r = (jnp.int32(L)
                  - jnp.argmax(rgs[..., ::-1], axis=-1)).astype(jnp.int32)
        gr = compact_ops.take_last(rgs, clip_r)
        gl = jnp.maximum(gl, 0)
        gr = jnp.maximum(gr, 0)
        clip_l = jnp.where(gl > 0, clip_l, 0)
        clip_r = jnp.where(gr > 0, clip_r, 0)
        score = -(total_pen - gl - gr)
        # liveness uses the UNRESTRICTED optimal clip (pre-anchor-rule
        # semantics): a diagonal whose gain-optimal trim consumes the
        # whole read has no alignable core and must stay dead — the
        # anchor rule above zeroes such clips, which otherwise floods
        # the spill layout with full-length junk candidates
        lgs_u = jnp.where(in_read, P - Cc, -1)
        clip_lu = (jnp.int32(L)
                   - jnp.argmax(lgs_u[..., ::-1], axis=-1)
                   ).astype(jnp.int32)
        glu = compact_ops.take_last(lgs_u, clip_lu)
        rgs_u = jnp.where(in_read, p_len - p_at - Cc, -1)
        clip_ru = (jnp.int32(L)
                   - jnp.argmax(rgs_u[..., ::-1], axis=-1)
                   ).astype(jnp.int32)
        gru = compact_ops.take_last(rgs_u, clip_ru)
        ok = (jnp.where(glu > 0, clip_lu, 0)
              + jnp.where(gru > 0, clip_ru, 0)) < lnc
        # --- alternate representation score (trimmed-representation ZS,
        # spliced_aligner.h:1065-1105): the reference REPORTS a soft-clipped
        # copy of a full ungapped best that sheds the outermost penalized
        # column, when the clip is within trimMax = -minsc / mm_min (trim5)
        # resp. trimMax - 1 (trim3).  Probe-verified host formula
        # (align/pipeline.py zsalt block) moved onto the device: the P / Cc
        # prefix planes are already materialized here, so each variant is a
        # small gather.  alt is NO_ALT when no penalized column exists or
        # both trims exceed their bounds; the host applies the remaining
        # (minsc, sink-best) gates.
        alt = jnp.full((B, C), np.int32(NO_ALT))
        if minsc is not None:
            # anchor-form model (oracle-probed; replaces the round-3
            # fitted first/last-penalized-column formula): for every
            # pen-free anchor [a, nextpen[a]) of >= 7 columns, the trim
            # branch reports the form that clips the read OUTSIDE the
            # anchor on each side where the clip fits trimMax (5' <= T,
            # 3' <= T-1 with T = -minsc/mm_min; an over-cap side
            # extends through, keeping its penalties).  Forms with at
            # least one applied clip feed ZS when they lose selection;
            # extend-through-only twins never do (probe: mm@{50,98}
            # primary 98M2S carries no ZS from the full -12 form, while
            # mm@{8,99} primary 99M1S carries ZS:-20 from the
            # both-clips form of its single anchor).
            T = ((-minsc) // np.int32(max(mm_min, 1)))[:, None]  # [B,1]
            # forms are enumerated on two SMALL domains (full [B,C,L]
            # planes OOM a genome-scale shard):
            #  - anchors STARTING in the first TW columns (their cl is
            #    capped at T < TW anyway); both/left/right forms
            #  - right-clip-only forms keyed by clip length b <= T-1
            #    (f_r depends only on the anchor END lnc-b)
            TW = int(min(L, 64))
            aw = jnp.arange(TW, dtype=jnp.int32)[None, None, :]
            pen_w = pencol[..., :TW]
            a_colw = jnp.concatenate(
                [jnp.ones((B, C, 1), bool), pen_w[..., :TW - 1]],
                axis=-1)
            a_okw = a_colw & (run_l[..., :TW] >= MINA) \
                & (aw < lnc[:, :, None])
            a1_w = jnp.minimum(nextpen[..., :TW], lnc[:, :, None])
            Tl = T[:, :, None]
            cl_w = jnp.where((aw > 0) & (aw <= Tl), aw, 0)
            crw_raw = lnc[:, :, None] - a1_w
            cr_w = jnp.where((crw_raw > 0) & (crw_raw <= Tl - 1),
                             crw_raw, 0)

            # form scores WITHOUT per-element gathers over [B,C,TW]:
            # the left index is the position itself, so P/Cc at cl are
            # aligned SLICES; only P at the anchor end a1 and the trim3
            # cost at cr (quality-prefix quirk, hi_aligner.h:3700) need
            # a dynamic index each
            maskL = (aw > 0) & (aw <= Tl)
            maskR = (crw_raw > 0) & (crw_raw <= Tl - 1)
            P_a = P[..., :TW]
            C_a = Cc[..., :TW]
            # P at the anchor end a1 equals P at the anchor start a —
            # the run [a, a1) is penalty-free by construction — so the
            # only dynamic index left is the trim3 cost at cr.  Resolve
            # it with a static select chain instead of a take_along
            # gather; cr is capped by trimMax-1, clamped to 32 (alt
            # forms with >32-column clips cannot arise below ~320 bp
            # reads at default scoring)
            KCR = int(min(TW, 32))
            C_cr = jnp.zeros_like(cr_w)
            for b in range(1, KCR):
                C_cr = jnp.where(cr_w == b, Cc[..., b:b + 1], C_cr)
            maskR = maskR & (crw_raw < KCR)
            P_cl_e = jnp.where(maskL, P_a, 0)
            C_cl_e = jnp.where(maskL, C_a, 0)
            P_hi_e = jnp.where(maskR, P_a, p_len)
            C_cr_e = jnp.where(maskR, C_cr, 0)
            f_b = -(P_hi_e - P_cl_e) - C_cl_e - C_cr_e
            f_l = -(p_len - P_cl_e) - C_cl_e
            f_r_w = -P_hi_e - C_cr_e
            z3 = jnp.zeros_like(cl_w)
            ms3 = minsc[:, None, None]
            sel_cl = clip_l[:, :, None]
            sel_cr = clip_r[:, :, None]

            def loser(ok_f, sc_f, cl_f, cr_f):
                is_sel = (cl_f == sel_cl) & (cr_f == sel_cr)
                okf = ok_f & ((cl_f > 0) | (cr_f > 0)) & ~is_sel \
                    & (sc_f >= ms3)
                return jnp.where(okf, sc_f, np.int32(NO_ALT))

            # right-clip-only forms on the b-domain [0, Tmax]: anchor
            # ends at pen column lnc-b with a >= MINA clean run before
            Tmax = int(min(L, 64))
            bw = jnp.arange(Tmax, dtype=jnp.int32)[None, None, :]
            # pen at column (lnc-b): P[lnc-b+1] - P[lnc-b]; p_at[b] =
            # P[lnc-b], so pen = p_at[b-1] - p_at[b]
            pa = p_at[..., :Tmax]
            pa_m1 = jnp.concatenate(
                [p_len[..., :1], p_at[..., :Tmax - 1]], axis=-1)
            pen_b = jnp.concatenate(
                [jnp.zeros((B, C, 1), jnp.int32),
                 (pa_m1 - pa)[..., 1:]], axis=-1)
            ok_b = (bw > 0) & (bw <= Tl - 1) & (pen_b > 0) \
                & (r_at[..., :Tmax] >= MINA) & (bw < lnc[:, :, None])
            C_b = Cc[..., :Tmax] if Cc.shape[-1] >= Tmax else Cc
            f_r_b = -pa - C_b[..., :Tmax]
            l_rb = loser(ok_b, f_r_b,
                         jnp.zeros((B, C, Tmax), jnp.int32),
                         jnp.broadcast_to(bw, (B, C, Tmax)))

            # completion-order approximation (oracle-probed): the walk
            # reports, per anchor, both-clips first, then single-side
            # trims, then the full extension; a later form enters the
            # sink only when it beats the running best, so
            #  - selected both-clip: nothing preceded it -> no ZS form
            #  - selected single-clip: only its OWN anchor's both-form
            #    can precede it
            #  - selected full: every anchor's best clip form preceded
            best_any = jnp.maximum(
                jnp.maximum(
                    jnp.maximum(loser(a_okw, f_b, cl_w, cr_w),
                                loser(a_okw, f_l, cl_w, z3)),
                    loser(a_okw, f_r_w, z3, cr_w)).max(axis=-1),
                l_rb.max(axis=-1))
            own = ((cl_w == sel_cl) & (sel_cl > 0)) \
                | ((cr_w == sel_cr) & (sel_cr > 0))
            best_own_b = jnp.where(
                own, loser(a_okw, f_b, cl_w, cr_w),
                np.int32(NO_ALT)).max(axis=-1)
            sel_full = (clip_l == 0) & (clip_r == 0)
            sel_both = (clip_l > 0) & (clip_r > 0)
            alt = jnp.where(sel_full, best_any,
                            jnp.where(sel_both, np.int32(NO_ALT),
                                      best_own_b))
    else:
        clip_l = jnp.zeros((B, C), jnp.int32)
        clip_r = jnp.zeros((B, C), jnp.int32)
        score = -total_pen
        ok = jnp.ones((B, C), bool)
        alt = jnp.full((B, C), np.int32(NO_ALT))
    ok &= (cand_start >= 0)
    ok &= score > -(_OOB_PEN // 2)
    # aligned-region mismatch counts for reporting
    keep = (col >= clip_l[:, :, None]) & (col < (lnc - clip_r)[:, :, None])
    return ExtendResult(score.astype(jnp.int32),
                        (mm & keep).sum(axis=-1).astype(jnp.int32),
                        (isn & keep).sum(axis=-1).astype(jnp.int32),
                        (snp_ok & keep).sum(axis=-1).astype(jnp.int32),
                        clip_l, clip_r, ok, alt.astype(jnp.int32))
