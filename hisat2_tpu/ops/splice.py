"""Batched junction discovery: splice joins + novel indels, on device.

The reference discovers splice junctions / indels one read at a time by
sweeping a junction point between two anchored GenomeHits
(GenomeHit::combineWith, /root/reference/hi_aligner.h:1286-1886): prefix
mismatch scores on the left anchor's diagonal, suffix scores on the right
anchor's diagonal, a donor/acceptor classification (GT-AG, GC-AG, AT-AC and
reverse complements, hi_aligner.h:1453-1527), a position-weight-matrix
probability (SpliceSiteDB::probscore, splice_site.cpp:788-850) and
anchor-length/intron-length gates (calculateScore, hi_aligner.h:3569-3641).

Here the whole combine is ONE batched device computation over all candidate
diagonal pairs of every (read, orientation) lane:

  pen[b,c,l]     per-column penalties on each candidate diagonal (gathered
                 once, shared with the ungapped extension)
  P[b,c,x]       prefix-penalty cumsums  ->  left-anchor score at split x
  total-P        suffix sums             ->  right-anchor score at split x
  donor/acceptor per-diagonal rolling 2-bit windows -> classification codes
                 and PWM table lookups (donor 9-mer, acceptor 7+8-mer halves)
  pair sweep     lax.scan over x-blocks; per (lane, i, j) running argmax with
                 the reference's exact preference order (any canonical/semi
                 junction beats any unclassified one, then score, then PWM
                 probability; first x wins ties - hi_aligner.h:1588-1603)

Pair kind is fixed by the diagonal gap D = start_j - start_i:
  D >= minIntronLen  -> splice (EDIT_TYPE_SPL, CIGAR N)
  1 <= D < minIntron -> deletion (read gap, CIGAR D, affine rdg penalty)
  -max_gap <= D <= -1-> insertion (ref gap, CIGAR I, affine rfg penalty)
matching combineWith's spliced/del/ins trichotomy (hi_aligner.h:1344-1355).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import compact as compact_ops

# --- splice-site PWM priors -------------------------------------------------
# Published position-weight matrices used by the reference's probscore
# (splice_site.cpp:31-50; donor: Yeo & Burge 2004, acceptor: Solovyev,
# "Bioinformatics - From Genomes to Drugs" Vol I Ch 3).  Background base
# probabilities {A,C,G,T} = {.27,.23,.23,.27} (splice_site.h:66).
DONOR_LEN = 9            # 3 exonic + 6 intronic   (splice_site.h:49-51)
ACC_LEN = 15             # 14 intronic + 1 exonic  (splice_site.h:59-61)
ACC_LEN1 = ACC_LEN // 2  # table split halves      (splice_site.h:62-63)
ACC_LEN2 = ACC_LEN - ACC_LEN1

_DONOR_PROB = np.array([
    [0.340, 0.604, 0.092, 0.001, 0.001, 0.526, 0.713, 0.071, 0.160],
    [0.363, 0.129, 0.033, 0.001, 0.001, 0.028, 0.076, 0.055, 0.165],
    [0.183, 0.125, 0.803, 1.000, 0.001, 0.419, 0.118, 0.814, 0.209],
    [0.114, 0.142, 0.073, 0.001, 1.000, 0.025, 0.093, 0.059, 0.462],
], np.float64)
_ACC_PROB = np.array([
    [0.090, 0.084, 0.075, 0.068, 0.076, 0.080, 0.097, 0.092, 0.076, 0.078,
     0.237, 0.042, 1.000, 0.001, 0.239],
    [0.310, 0.310, 0.307, 0.293, 0.326, 0.330, 0.373, 0.385, 0.410, 0.352,
     0.309, 0.708, 0.001, 0.001, 0.138],
    [0.125, 0.115, 0.106, 0.104, 0.110, 0.113, 0.113, 0.085, 0.066, 0.064,
     0.212, 0.003, 0.001, 1.000, 0.520],
    [0.463, 0.440, 0.470, 0.494, 0.471, 0.463, 0.408, 0.429, 0.445, 0.504,
     0.240, 0.246, 0.001, 0.001, 0.104],
], np.float64)
_BACKGROUND = np.array([0.27, 0.23, 0.23, 0.27], np.float64)

# junction direction classes (splice_site.h SPL_*)
SPL_UNKNOWN, SPL_FW, SPL_RC, SPL_SEMI_FW, SPL_SEMI_RC = 0, 1, 2, 3, 4
# pair kinds
KIND_NONE, KIND_SPL, KIND_DEL, KIND_INS = 0, 1, 2, 3


def junction_prob_tables():
    """Precompute the reference's summed PWM tables (init_junction_prob,
    splice_site.cpp:52-105): donor_sum[4^9], acc1[4^7], acc2[4^8], float32.
    probscore(d, a1, a2) = 1 / (1 + donor_sum[d]*acc1[a1]*acc2[a2])."""
    dlog = np.log(_DONOR_PROB / _BACKGROUND[:, None])     # [4, 9]
    alog = np.log(_ACC_PROB / _BACKGROUND[:, None])       # [4, 15]

    def summed(logp, ncols, col0):
        n = 1 << (2 * ncols)
        idx = np.arange(n, dtype=np.int64)
        s = np.zeros(n, np.float64)
        for j in range(ncols):
            base = (idx >> (2 * j)) & 3
            s += logp[base, col0 + ncols - j - 1]
        return np.exp(-s).astype(np.float32)

    donor_sum = summed(dlog, DONOR_LEN, 0)
    acc1 = summed(alog, ACC_LEN1, 0)
    acc2 = summed(alog, ACC_LEN2, ACC_LEN1)
    return donor_sum, acc1, acc2


def probscore_host(donor9: int, acc15: int, tables=None) -> float:
    """Host-side probscore for tests (splice_site.cpp:788-850, non-NEW
    model): sigmoid of the summed PWM log-odds."""
    if tables is None:
        tables = junction_prob_tables()
    d, a1t, a2t = tables
    a1 = acc15 >> (2 * ACC_LEN2)
    a2 = acc15 & ((1 << (2 * ACC_LEN2)) - 1)
    return float(1.0 / (1.0 + d[donor9] * a1t[a1] * a2t[a2]))


def max_intron_len(anchor, min_anchor):
    """MaxIntronLen (hi_aligner.h:48-57): longer anchors license longer
    introns; 0 below the minimum anchor length.  Vectorized (jnp/np)."""
    a = jnp.maximum(anchor, 2)
    shift = jnp.clip((a << 1) - 4, 13, 30)
    return jnp.where(anchor >= min_anchor, jnp.int32(1) << shift, 0)


def max_intron_len_noncan(anchor, min_anchor):
    """MaxIntronLen_noncan (hi_aligner.h:70-79)."""
    a = jnp.maximum(anchor, 5)
    shift = jnp.minimum((a << 1) - 10, 30)
    return jnp.where(anchor >= min_anchor, jnp.int32(1) << shift, 0)


def intron_len_prob(anchor, intron_len, max_intron):
    """intronLen_prob (hi_aligner.h:59-67)."""
    exp_len = jnp.where(anchor < 14,
                        jnp.int32(1) << jnp.minimum((anchor << 1) + 4, 30),
                        max_intron)
    exp_len = jnp.minimum(exp_len, max_intron)
    return jnp.minimum(intron_len.astype(jnp.float32)
                       / exp_len.astype(jnp.float32), 1.0)


def intron_len_prob_noncan(anchor, intron_len, max_intron):
    """intronLen_prob_noncan (hi_aligner.h:81-89)."""
    exp_len = jnp.where(anchor < 16,
                        jnp.int32(1) << jnp.minimum(anchor << 1, 30),
                        max_intron)
    exp_len = jnp.minimum(exp_len, max_intron)
    return jnp.minimum(intron_len.astype(jnp.float32)
                       / exp_len.astype(jnp.float32), 1.0)


class SpliceParams(NamedTuple):
    """Static splice/gap policy (tp.h, scoring.h; all plain ints/floats so
    the bundle is hashable for jit)."""
    min_intron: int = 20
    max_intron: int = 500000
    pen_can: int = 0             # --pen-cansplice
    pen_noncan: int = 12         # --pen-noncansplice
    # intron length penalty G,-8,1: trunc(max(0, -8 + ln(D)))
    lenpen_const: float = -8.0
    lenpen_coef: float = 1.0
    lenpen_nc_const: float = -8.0   # noncanonical (G,-8,2 under --dta)
    lenpen_nc_coef: float = 1.0
    min_anchor: int = 7          # novel canonical  (tpol ctor hisat2.cpp:3845)
    min_anchor_noncan: int = 14
    rd_gap_open: int = 5         # deletion (read gap)
    rd_gap_ext: int = 3
    rf_gap_open: int = 5         # insertion (ref gap)
    rf_gap_ext: int = 3
    max_gap: int = 10            # static insertion-length cap (maxReadGaps)
    allow_spliced: bool = True   # False = --no-spliced-alignment (indel-only)


class PairResult(NamedTuple):
    """Per (lane, i, j) best junction from the sweep."""
    score: jnp.ndarray     # int32 [N, C, C]  (<= 0; -BIG when invalid)
    x: jnp.ndarray         # int32 [N, C, C]  first read pos of right segment
    kind: jnp.ndarray      # int32 [N, C, C]  KIND_*
    spldir: jnp.ndarray    # int32 [N, C, C]  SPL_*
    splscore: jnp.ndarray  # f32   [N, C, C]  PWM probscore at x (canonical)
    raw: jnp.ndarray       # int32 [N, C, C]  score before the minsc gate -
                           #   seeds the second-junction composite, where
                           #   the unfixed tail's penalties are recoverable


_BIG = np.int32(2 ** 30)

# bucket-index geometry for the sorted site tables: NB bins of 2^shift
# joined bases each; lob[b] = first table row with key >= b << shift.
# A query then binary-searches only its bin's span — SS_SB masked steps
# (span + incremental-merge headroom bounded at rebuild time,
# align/splice_db.device_tables) instead of log2(capacity) ~ 19 gathered
# steps over the full table.  Identical results to jnp.searchsorted.
SS_NBINS = 1 << 19
SS_SB = 12              # covers spans up to 4096 (checked at rebuild)
SS_MERGE_HEADROOM = 1024


def table_searchsorted(tab, q, lob=None, shift=None):
    """searchsorted(tab, q, side='left'), bucket-accelerated when a
    bucket index (lob [SS_NBINS+1], shift 0-d int32) is provided."""
    if lob is None:
        return jnp.searchsorted(tab, q)
    NB = lob.shape[0] - 1
    b = jnp.clip(jnp.right_shift(q, shift.astype(q.dtype)), 0, NB - 1)
    lo = lob[b]
    hi = lob[b + 1]
    Sm1 = tab.shape[0] - 1
    for _ in range(SS_SB):
        mid = (lo + hi) >> 1
        v = tab[jnp.clip(mid, 0, Sm1)]
        act = lo < hi
        go = v < q
        lo = jnp.where(act & go, mid + 1, lo)
        hi = jnp.where(act & ~go, mid, hi)
    return lo



# per-position PWM factors: table[kmer] = prod_j BACKGROUND[b_j]/PROB[b_j, j]
# (exp of the summed log-odds) — evaluating the product directly with one
# 4-way select per window position is elementwise work, where the
# packed-kmer table lookup would be one gather per (lane, cand, x) cell
# (6 gathers x ~12M cells per spliced device step)
_F_DONOR = (_BACKGROUND[:, None] / _DONOR_PROB).astype(np.float32)  # [4, 9]
_F_ACC = (_BACKGROUND[:, None] / _ACC_PROB).astype(np.float32)      # [4,15]


def _pwm_prod(ch, M, offs, fmat, rc=False, out_len=None):
    """Π_t fmat[char(x+offs[t]), col_t] over the rolling window — the
    same value as table[_pack_window(...)] up to f32 product rounding.
    Column mapping matches _pack_window: fw col_t = t, rc col_t =
    len(offs)-1-t on the complemented char (chars > 3 read as 0/A)."""
    N, C, W = ch.shape
    L1 = out_len if out_len is not None else W - 2 * M
    k = len(offs)
    acc = None
    for t, off in enumerate(offs):
        c = jax.lax.dynamic_slice_in_dim(ch, M + off, L1, axis=2)
        c = jnp.where(c > 3, 0, c)
        if rc:
            c = 3 - c
            f = fmat[:, k - 1 - t]
        else:
            f = fmat[:, t]
        term = jnp.where(c == 0, f[0],
                         jnp.where(c == 1, f[1],
                                   jnp.where(c == 2, f[2], f[3])))
        acc = term if acc is None else acc * term
    return acc


def _pwm_planes(ch, M, L):
    """(dsum_fw, dsum_rc, asum_fw, asum_rc) PWM products at every x."""
    return (_pwm_prod(ch, M, range(-3, 6), _F_DONOR, out_len=L + 1),
            _pwm_prod(ch, M, range(-6, 3), _F_DONOR, rc=True,
                      out_len=L + 1),
            _pwm_prod(ch, M, range(-14, 1), _F_ACC, out_len=L + 1),
            _pwm_prod(ch, M, range(-1, 14), _F_ACC, rc=True,
                      out_len=L + 1))


def _pack_window(ch, M, offs, rc=False, out_len=None):
    """Rolling 2-bit pack of diagonal chars: code[b,c,x] over window
    positions x+offs (ascending genomic order; rc=True packs the
    reverse-complement read right-to-left like the reference's SPL_RC
    extraction, hi_aligner.h:1558-1581).  ch: [N, C, L+2M] (4 = out of
    text -> packs as 0, matching `if(base > 3) base = 0`)."""
    N, C, W = ch.shape
    L1 = out_len if out_len is not None else W - 2 * M
    k = len(offs)
    code = jnp.zeros((N, C, L1), jnp.int32)
    for t, off in enumerate(offs):
        c = jax.lax.dynamic_slice_in_dim(ch, M + off, L1, axis=2)
        c = jnp.where(c > 3, 0, c)
        if rc:
            c = 3 - c
            code = code | (c << (2 * t))
        else:
            code = code | (c << (2 * (k - 1 - t)))
    return code


def diag_chars(ref_words, n_text: int, starts, L: int, margin: int):
    """Gather reference chars along candidate diagonals with margin:
    out[b,c,m] = ref[starts[b,c] + m - margin], 4 when out of text."""
    from . import rank as rk
    return rk.ref_chars_block(ref_words, n_text, starts - margin,
                              L + 2 * margin)



def _take_x_i(v, bx, L1):
    """v[n, i, bx[n, i, j]] without a gather: one-hot select over x,
    fused by XLA into the reduction (instead of a broadcasted
    take_along_axis, one gathered index per (n, i, j) cell)."""
    sel = bx[:, :, :, None] == jnp.arange(L1, dtype=jnp.int32)
    return jnp.where(sel, v[:, :, None, :], 0).sum(axis=3, dtype=v.dtype)


def _take_x_j(v, bx, L1):
    """v[n, j, bx[n, i, j]] (right-diagonal indexing)."""
    sel = bx[:, :, :, None] == jnp.arange(L1, dtype=jnp.int32)
    return jnp.where(sel, v[:, None, :, :], 0).sum(axis=3, dtype=v.dtype)


def pair_sweep(ch, pen_spl, pen_ind, ismm, starts, valid, lens, minsc,
               tables, prm: SpliceParams, xblock: int = 32,
               max_gap: int = None) -> PairResult:
    """The batched combineWith junction sweep.

    ch:      [N, C, L+2M] diagonal ref chars (diag_chars)
    pen_spl: [N, C, L] per-column penalty, SNPs NOT forgiven (spliced joins
             create plain MM edits - hi_aligner.h:1726)
    pen_ind: [N, C, L] per-column penalty, known SNPs forgiven (indel joins
             tag snpIDs and skip their cost - hi_aligner.h:1781-1797, 3561)
    ismm:    [N, C, L] bool penalized column (for anchor-length gates)
    starts:  [N, C] int32 diagonal origins (joined pos of read base 0)
    valid:   [N, C] bool
    lens:    [N] int32
    minsc:   [N] int32 minimum alignment score
    tables:  (donor_sum, acc1, acc2) device arrays
    """
    N, C, L = pen_spl.shape
    M = (ch.shape[2] - L) // 2
    donor_sum, acc1t, acc2t = tables
    zero3 = jnp.zeros((N, C, 1), jnp.int32)
    Ps = jnp.concatenate([zero3, jnp.cumsum(pen_spl, axis=2)], axis=2)
    Pi = jnp.concatenate([zero3, jnp.cumsum(pen_ind, axis=2)], axis=2)
    Pm = jnp.concatenate(
        [zero3, jnp.cumsum(ismm.astype(jnp.int32), axis=2)], axis=2)
    lens3 = lens[:, None, None]
    tot_s = jnp.take_along_axis(Ps, jnp.broadcast_to(lens3, (N, C, 1)),
                                axis=2)[:, :, 0]                    # [N, C]
    tot_i = jnp.take_along_axis(Pi, jnp.broadcast_to(lens3, (N, C, 1)),
                                axis=2)[:, :, 0]

    # --- per-diagonal junction features over x = 0..L ---
    # (splice classification + PWM only when spliced joins are allowed;
    #  --no-spliced-alignment sweeps indels only)
    if prm.allow_spliced:
        d0 = jax.lax.dynamic_slice_in_dim(ch, M + 0, L + 1, axis=2)
        d1 = jax.lax.dynamic_slice_in_dim(ch, M + 1, L + 1, axis=2)
        a0 = jax.lax.dynamic_slice_in_dim(ch, M - 2, L + 1, axis=2)
        a1_ = jax.lax.dynamic_slice_in_dim(ch, M - 1, L + 1, axis=2)
        dcode = jnp.where((d0 < 4) & (d1 < 4), d0 * 16 + d1, 255)
        acode = jnp.where((a0 < 4) & (a1_ < 4), a0 * 16 + a1_, 255)

        # PWM probabilities per diagonal (rolling windows; fw uses the left
        # diagonal for the donor and right for the acceptor, rc swaps+rc's)
        dsum_fw, dsum_rc, asum_fw, asum_rc = _pwm_planes(ch, M, L)

    starts_l = starts[:, :, None]                                  # [N,C,1]
    starts_r = starts[:, None, :]                                  # [N,1,C]
    D = starts_r - starts_l                                        # [N,C,C]
    is_spl = (D >= prm.min_intron) & (D <= prm.max_intron) \
        & prm.allow_spliced
    is_del = (D >= 1) & (D < prm.min_intron)
    is_ins = (D <= -1) & (D >= -(max_gap if max_gap else prm.max_gap))
    pmask = valid[:, :, None] & valid[:, None, :] & (is_spl | is_del | is_ins)
    I = jnp.maximum(-D, 0)                                         # ins len
    # affine gap cost: open = const + linear for the first base, linear per
    # extension (scoring.h:447-470) => total = const + linear * gaplen
    gap_pen = jnp.where(
        is_del, prm.rd_gap_open + prm.rd_gap_ext * D,
        jnp.where(is_ins, prm.rf_gap_open + prm.rf_gap_ext * (-D), 0))

    nblk = (L + xblock) // xblock
    # insertion shifts beyond the score budget never pass minsc
    V = min(prm.max_gap, L - 1, max_gap if max_gap else prm.max_gap)
    # pad the x axis by V + xblock so every shifted contiguous slice below
    # stays in bounds; padded prefix columns repeat the total (=> suffix 0)
    pad = V + xblock
    Pi_p = jnp.concatenate(
        [Pi, jnp.broadcast_to(tot_i[:, :, None], (N, C, pad))], axis=2)
    Ps_p = jnp.concatenate(
        [Ps, jnp.broadcast_to(tot_s[:, :, None], (N, C, pad))], axis=2)
    # RAW (forgiveness-blind) mismatch counts per column, for the indel
    # x tie rule below: the reference's extension walks raw matches first
    # and engages ALT forgiveness only at a mismatch, so among equal-score
    # gap placements it lands on the one using the FEWEST forgiven columns
    # (oracle-probed: fz1264 90M4D10M over 89M4D11M where x=89 needs a
    # forgiven SNV; ties within equal raw counts keep the lowest x)
    Pr = jnp.concatenate(
        [zero3, jnp.cumsum((pen_spl > 0).astype(jnp.int32), axis=2)],
        axis=2)
    tot_r = jnp.take_along_axis(Pr, jnp.broadcast_to(lens3, (N, C, 1)),
                                axis=2)[:, :, 0]
    Pr_p = jnp.concatenate(
        [Pr, jnp.broadcast_to(tot_r[:, :, None], (N, C, pad))], axis=2)
    # per-diagonal suffix penalties S[c, x] = total - prefix
    SSi = tot_i[:, :, None] - Pi_p                                # [N,C,Lp]
    SSs = tot_s[:, :, None] - Ps_p
    SSr = tot_r[:, :, None] - Pr_p
    if prm.allow_spliced:
        # --- budget-scan base planes (combineWith's scan REGION,
        # hi_aligner.h:1330-1336 + 1470-1490): the prefix/suffix mismatch
        # scans start at the pair's hit-segment boundaries (this_rdoff /
        # other_rdoff + other_len), not the read ends, and break once the
        # penalty accumulated WITHIN the region drops below remainsc.
        # Per diagonal, the left base at junction x is the penalty plateau
        # of the last clean run (>= 8 cols, minK_local) at or before x;
        # the right base mirrors it.  budget = plane - base <= -minsc.
        mmc = pen_spl > 0                                       # [N,C,L]
        colL = jnp.arange(L, dtype=jnp.int32)[None, None, :]
        lastmm = jax.lax.cummax(jnp.where(mmc, colL, -1), axis=2)
        nxt = jax.lax.cummax(
            jnp.where(mmc[:, :, ::-1], colL, -1), axis=2)[:, :, ::-1]
        nextmm = jnp.where(nxt >= 0, (L - 1) - nxt, L)
        runlen = nextmm - (lastmm + 1)
        qual_col = ~mmc & (runlen >= 8)
        PsL = Ps[:, :, :L]                                      # at col x'
        SSsL = tot_s[:, :, None] - PsL
        lpv = jnp.where(qual_col, PsL, 0)
        base_l = jnp.concatenate(
            [zero3, jax.lax.cummax(lpv, axis=2)], axis=2)       # [N,C,L+1]
        rv = jnp.where(qual_col, SSsL, 0)
        base_r = jnp.concatenate(
            [jax.lax.cummax(rv[:, :, ::-1], axis=2)[:, :, ::-1], zero3],
            axis=2)
        base_l = jnp.concatenate(
            [base_l, jnp.broadcast_to(base_l[:, :, -1:], (N, C, pad))],
            axis=2)
        base_r = jnp.concatenate(
            [base_r, jnp.broadcast_to(base_r[:, :, -1:], (N, C, pad))],
            axis=2)
        # pad classification/PWM planes to the same sliceable length
        zpadi = jnp.full((N, C, pad), 255, jnp.int32)
        zpadf = jnp.zeros((N, C, pad), jnp.float32)
        dcode = jnp.concatenate([dcode, zpadi], axis=2)
        acode = jnp.concatenate([acode, zpadi], axis=2)
        dsum_fw = jnp.concatenate([dsum_fw, zpadf], axis=2)
        dsum_rc = jnp.concatenate([dsum_rc, zpadf], axis=2)
        asum_fw = jnp.concatenate([asum_fw, zpadf], axis=2)
        asum_rc = jnp.concatenate([asum_rc, zpadf], axis=2)

    # precompute per-(pair, insertion-shift) one-hot masks outside the scan
    ins_sel = [(is_ins & (I == v)) for v in range(1, V + 1)]

    def blk(carry, b0):
        bk, bx, bp, btk = carry
        x0 = b0 * xblock
        xs = x0 + jnp.arange(xblock, dtype=jnp.int32)              # [W]
        x4 = xs[None, None, None, :]                               # [1,1,1,W]
        sl = lambda a, off: jax.lax.dynamic_slice_in_dim(  # noqa: E731
            a, x0 + off, xblock, axis=2)
        lens4 = lens[:, None, None, None]
        vx = (x4 >= 1) & (x4 + I[:, :, :, None] <= lens4 - 1) & (x4 <= L)

        # indel scores: left prefix on SNP-forgiving plane + shifted suffix
        # (the shift handles insertions without any per-pair gather)
        Pl_i = sl(Pi_p, 0)[:, :, None, :]                          # [N,C,1,W]
        Pl_r = sl(Pr_p, 0)[:, :, None, :]
        score_ind = -(Pl_i + sl(SSi, 0)[:, None, :, :])
        raw4 = Pl_r + sl(SSr, 0)[:, None, :, :]
        for v in range(1, V + 1):
            sv = -(Pl_i + sl(SSi, v)[:, None, :, :])
            rv = Pl_r + sl(SSr, v)[:, None, :, :]
            isv = ins_sel[v - 1][:, :, :, None]
            score_ind = jnp.where(isv, sv, score_ind)
            raw4 = jnp.where(isv, rv, raw4)
        score_ind = score_ind - gap_pen[:, :, :, None]

        if prm.allow_spliced:
            lp4 = sl(Ps_p, 0)[:, :, None, :]                       # [N,C,1,W]
            rp4 = sl(SSs, 0)[:, None, :, :]                        # [N,1,C,W]
            s_spl = -(lp4 + rp4)
            # combineWith's x scan is BUDGET-BOUNDED (hi_aligner.h:
            # 1470-1490): the prefix/suffix mismatch scans break once the
            # penalty accumulated within the scan REGION drops below
            # remainsc, so x positions out of budget never compete —
            # without this, an accidental canonical motif at a
            # high-mismatch x outranks the true noncanonical junction
            # (the dir preference ignores score) and noncan novel
            # junctions are lost wholesale.  The bases subtract penalty
            # outside the pair's hit segments (multi-junction reads).
            m4 = minsc[:, None, None, None]
            budget4 = (lp4 - sl(base_l, 0)[:, :, None, :] <= -m4) \
                & (rp4 - sl(base_r, 0)[:, None, :, :] <= -m4)
            dl = sl(dcode, 0)[:, :, None, :]                       # [N,C,1,W]
            ar = sl(acode, 0)[:, None, :, :]                       # [N,1,C,W]
            # 0x23=GT 0x02=AG 0x13=CT(rc AG) 0x01=AC(rc GT) 0x21=GC
            # 0x03=AT 0x20=GA; constants mirror hi_aligner.h:1454-1458
            can_fw = (dl == 0x23) & (ar == 0x02)
            can_rc = (dl == 0x13) & (ar == 0x01)
            semi_fw = ((dl == 0x21) & (ar == 0x02)) \
                | ((dl == 0x03) & (ar == 0x01))
            semi_rc = ((dl == 0x13) & (ar == 0x21)) \
                | ((dl == 0x20) & (ar == 0x03))
            canonical = can_fw | can_rc
            has_dir = canonical | semi_fw | semi_rc
            # PWM score of the junction (canonical only)
            prod = jnp.where(
                can_fw,
                sl(dsum_fw, 0)[:, :, None, :]
                * sl(asum_fw, 0)[:, None, :, :],
                sl(dsum_rc, 0)[:, None, :, :]
                * sl(asum_rc, 0)[:, :, None, :])
            splsc = jnp.where(canonical, 1.0 / (1.0 + prod), 0.0)
            sp4 = is_spl[:, :, :, None]
            score = jnp.where(
                sp4,
                s_spl - jnp.where(canonical, prm.pen_can, prm.pen_noncan),
                score_ind)
            hd = jnp.where(sp4 & has_dir, 1, 0)
            ssc = jnp.where(sp4, splsc, 0.0)
        else:
            score = score_ind
            hd = jnp.zeros_like(score)
            ssc = jnp.zeros_like(score, jnp.float32)

        valid4 = vx & pmask[:, :, :, None]
        if prm.allow_spliced:
            valid4 &= ~sp4 | budget4
        # composite key encodes the reference preference (hi_aligner.h:
        # 1588-1603): classified dir > score > PWM prob > first (lowest) x.
        # score fits 22 bits after clamping to [-2^21, 0].
        k1 = jnp.where(valid4,
                       (hd << 23) + jnp.maximum(score, -(2 ** 21))
                       + (2 ** 21), -1)
        m1 = k1.max(axis=3)                                        # [N,C,C]
        tie1 = k1 == m1[:, :, :, None]
        s2 = jnp.where(tie1, ssc, -1.0).max(axis=3)
        tie2 = tie1 & (jnp.where(tie1, ssc, -1.0) == s2[:, :, :, None])
        # x tie rule: splices keep the FIRST (lowest) x; indel ties rank
        # by RAW mismatch count first (fewest forgiven columns — the
        # reference's extension walks raw matches and engages ALT
        # forgiveness only at a mismatch: oracle fz1264 90M4D10M beats
        # 89M4D11M whose x=89 needs a forgiven SNV; within equal raw
        # counts the lowest x wins: fz1157 64M5D36M, fz206 76M5D24M)
        ind_tk = raw4 * np.int32(L + 2) + x4
        tkey4 = jnp.where(sp4, x4, ind_tk) if prm.allow_spliced else ind_tk
        xtk = jnp.where(tie2, jnp.broadcast_to(tkey4, tie2.shape),
                        _BIG).min(axis=3)
        xbest = jnp.where(is_spl, xtk, xtk % np.int32(L + 2))
        # merge with carry: same preference order, then the tie key
        better = (m1 > bk) | ((m1 == bk) & (s2 > bp)) \
            | ((m1 == bk) & (s2 == bp) & (xtk < btk))
        bk = jnp.where(better, m1, bk)
        bp = jnp.where(better, s2, bp)
        bx = jnp.where(better, xbest, bx)
        btk = jnp.where(better, xtk, btk)
        return (bk, bx, bp, btk), None

    init = (jnp.full((N, C, C), -1, jnp.int32),
            jnp.zeros((N, C, C), jnp.int32),
            jnp.full((N, C, C), -1.0, jnp.float32),
            jnp.full((N, C, C), _BIG, jnp.int32))
    (bk, bx, bp, _btk), _ = jax.lax.scan(
        blk, init, jnp.arange(nblk, dtype=jnp.int32))
    # decompose the winning key back into score (dir bit recomputed below)
    bs = jnp.where(bk >= 0, (bk & ((1 << 23) - 1)) - 2 ** 21,
                   -_BIG)
    bp = jnp.maximum(bp, 0.0)

    # recover spldir/kind at the chosen x (dcode indexed by LEFT diagonal i,
    # acode by RIGHT diagonal j)
    if prm.allow_spliced:
        dl = _take_x_i(dcode[:, :, :L + 1], bx, L + 1)
        ar = _take_x_j(acode[:, :, :L + 1], bx, L + 1)
        can_fw = (dl == 0x23) & (ar == 0x02)
        can_rc = (dl == 0x13) & (ar == 0x01)
        semi_fw = ((dl == 0x21) & (ar == 0x02)) \
            | ((dl == 0x03) & (ar == 0x01))
        semi_rc = ((dl == 0x13) & (ar == 0x21)) \
            | ((dl == 0x20) & (ar == 0x03))
        spldir = jnp.where(
            can_fw, SPL_FW,
            jnp.where(can_rc, SPL_RC,
                      jnp.where(semi_fw, SPL_SEMI_FW,
                                jnp.where(semi_rc, SPL_SEMI_RC,
                                          SPL_UNKNOWN))))
        spldir = jnp.where(is_spl, spldir, SPL_UNKNOWN)
    else:
        spldir = jnp.zeros((N, C, C), jnp.int32)
    kind = jnp.where(is_spl, KIND_SPL,
                     jnp.where(is_del, KIND_DEL,
                               jnp.where(is_ins, KIND_INS, KIND_NONE)))

    # --- gates (novel junctions; calculateScore hi_aligner.h:3569-3641
    #     + combineWith pre-gate hi_aligner.h:1662-1678) ---
    lens2 = lens[:, None, None]
    canonical = (spldir == SPL_FW) | (spldir == SPL_RC)
    x = bx
    mm_l = _take_x_i(Pm, x, L + 1)
    xr = jnp.minimum(x + I, L)
    tot_m = jnp.take_along_axis(Pm, jnp.broadcast_to(lens3, (N, C, 1)),
                                axis=2)[:, :, 0]
    mm_r = tot_m[:, None, :] - _take_x_j(Pm, xr, L + 1)

    ok = bs > -_BIG // 2
    shorter_raw = jnp.minimum(x, lens2 - x)
    # combineWith pre-gate
    pre_can = (shorter_raw < prm.min_anchor) & (intron_len_prob(
        shorter_raw, D, prm.max_intron) > 0.01)
    pre_non = (shorter_raw < prm.min_anchor_noncan) & (intron_len_prob_noncan(
        shorter_raw, D, prm.max_intron) > 0.01)
    spl_ok = jnp.where(canonical, ~pre_can, ~pre_non)
    # calculateScore gates with mm-adjusted anchors
    adj_l = x - 2 * mm_l
    adj_r = (lens2 - x) - 2 * mm_r
    shorter = jnp.maximum(jnp.minimum(adj_l, adj_r), 1)
    thresh = jnp.where(canonical,
                       max_intron_len(shorter, prm.min_anchor),
                       max_intron_len_noncan(shorter, prm.min_anchor_noncan))
    gated = thresh < prm.max_intron
    spl_ok &= ~(gated & (D > thresh))
    # PWM probability thresholds scale with intron length
    pth = jnp.where(D >= (1 << 16), 0.99,
                    jnp.where(D >= (1 << 15), 0.97,
                              jnp.where(D >= (1 << 14), 0.94,
                                        jnp.where(D >= (1 << 13), 0.91,
                                                  jnp.where(D >= (1 << 12),
                                                            0.88, 0.8)))))
    spl_ok &= ~(gated & canonical & (bp < pth))
    # the shorter side must be clean (no mismatches) when gated
    short_is_left = adj_l <= adj_r
    mm_short = jnp.where(short_is_left, mm_l, mm_r)
    spl_ok &= ~(gated & (mm_short > 0))
    # intron length penalty: trunc(max(0, const + coef*ln(D)))
    logd = jnp.log(jnp.maximum(D, 1).astype(jnp.float32))
    lenpen = jnp.where(
        canonical,
        (prm.lenpen_const + prm.lenpen_coef * logd).astype(jnp.int32),
        (prm.lenpen_nc_const + prm.lenpen_nc_coef * logd).astype(jnp.int32))
    lenpen = jnp.maximum(lenpen, 0)
    score = jnp.where(kind == KIND_SPL, bs - lenpen, bs)
    ok &= jnp.where(kind == KIND_SPL, spl_ok, True)
    raw = jnp.where(ok, score, -_BIG)
    ok &= score >= minsc[:, None, None]
    score = jnp.where(ok, score, -_BIG)
    return PairResult(score=score, x=x, kind=kind, spldir=spldir,
                      splscore=bp, raw=raw)


def inject_known(ref_words, n_text: int, reads, quals, lens, rdids,
                 starts, valid, P_raw, tot_raw, Pm, tot_m,
                 kd, ka, krdid, ka_s, kd_s, krdid_a,
                 mm_pen, n_pen: int, minsc, slots: int = 2,
                 src_clip_l=None, src_clip_r=None, clip_pen=None,
                 snv_delta1=None, snv_delta2=None,
                 kd_lob=None, ka_lob=None, ss_shift=None):
    """Known/temp splice-site directed candidates (the batched equivalent
    of the reference's splice-site-driven re-alignment,
    spliced_aligner.h:296-407 getLeftSpliceSites / :409-500,1213-1338
    getRightSpliceSites): instead of recursive local search, each candidate
    diagonal enumerates nearby splice sites and INJECTS the complementary
    diagonal with the junction position fully determined by the site.

    Covers short-anchor junctions (below the FM search's min hit length) and
    gives known junctions their zero-penalty, gate-free scoring
    (edit.knownSpl, hi_aligner.h:3574).

    kd/ka:   int32 [S] donor (last left-exonic) / acceptor (first
             right-exonic) JOINED positions, sorted by kd
    krdid:   int64 [S] discovery read id (-1 = from file, always usable);
             a site is visible only to reads with rdid > its discovery rdid
             (mindist=0 single-thread semantics, hisat2.cpp:3559,
             spliced_aligner.h:305)
    ka_s/kd_s/krdid_a: the same sites sorted by acceptor position
    P_raw/tot_raw: SNP-unforgiving penalty prefixes/totals on the base
             candidate diagonals; Pm/tot_m their mismatch-count versions
    Returns dict of [N, 2*C*slots] candidate arrays.
    """
    from . import extend as extend_ops  # noqa: F401 (local, cycle-free)
    N, C = starts.shape
    L = reads.shape[1]
    S = kd.shape[0]
    rd2 = rdids[:, None]                                         # [N, 1]
    lens2 = lens[:, None]

    # --- donor-keyed: src diagonal is the LEFT side --------------------
    lo = table_searchsorted(kd, starts, kd_lob, ss_shift)        # [N, C]
    cand_x, cand_d2, cand_ok, cand_srcp = [], [], [], []
    for t in range(slots):
        idx = jnp.minimum(lo + t, S - 1)
        site_rd = krdid[idx]
        okd = (lo + t < S) & valid & (kd[idx] >= starts) \
            & (kd[idx] <= starts + lens2 - 2) \
            & ((site_rd < 0) | (site_rd < rd2))
        x = jnp.where(okd, kd[idx] - starts + 1, 1)
        cand_x.append(x)
        cand_d2.append(ka[idx] - x)
        cand_ok.append(okd)
        cand_srcp.append(jnp.arange(C, dtype=jnp.int32)[None, :]
                         .repeat(N, 0))
    # --- acceptor-keyed: src diagonal is the RIGHT side ----------------
    lo2 = table_searchsorted(ka_s, starts + 1, ka_lob, ss_shift)
    for t in range(slots):
        idx = jnp.minimum(lo2 + t, S - 1)
        site_rd = krdid_a[idx]
        oka = (lo2 + t < S) & valid & (ka_s[idx] >= starts + 1) \
            & (ka_s[idx] <= starts + lens2 - 1) \
            & ((site_rd < 0) | (site_rd < rd2))
        x = jnp.where(oka, ka_s[idx] - starts, 1)
        cand_x.append(x)
        cand_d2.append(kd_s[idx] - x + 1)   # here d2 = the LEFT diagonal
        cand_ok.append(oka)
        cand_srcp.append(jnp.arange(C, dtype=jnp.int32)[None, :]
                         .repeat(N, 0))
    J1 = C * slots                       # donor-keyed block
    x_all = jnp.concatenate(cand_x, axis=1)                     # [N, J]
    fresh = jnp.concatenate(cand_d2, axis=1)
    ok_all = jnp.concatenate(cand_ok, axis=1)
    src = jnp.concatenate(cand_srcp, axis=1)
    J = x_all.shape[1]

    # SNV-forgiving penalties: the reference's site-guided extend/combine
    # runs with ALT forgiveness (tempHit.extend -> alignWithALTs), so a
    # catalog SNV inside either exon piece costs nothing.  Only prefix
    # SCALARS of the fresh-diagonal planes are consumed here, so they
    # are computed over the LIVE columns only (live_pen_prefix compacts
    # ~50x at genome scale; dead columns read 0 and stay ok_all=False).
    x_m1 = jnp.maximum(x_all - 1, 0)
    tot_f, tot_fm, ppfx = extend_ops.live_pen_prefix(
        ref_words, n_text, reads, quals, lens, mm_pen, n_pen,
        fresh, ok_all, [x_all, x_m1],
        snv_delta1=snv_delta1, snv_delta2=snv_delta2)
    (pf_x, pfm_x), (pf_xm1, _) = ppfx
    # src-plane prefixes at x
    ps_x = jnp.take_along_axis(
        jnp.take_along_axis(P_raw, src[:, :, None], axis=1),
        x_all[:, :, None], axis=2)[:, :, 0]
    pm_x = jnp.take_along_axis(
        jnp.take_along_axis(Pm, src[:, :, None], axis=1),
        x_all[:, :, None], axis=2)[:, :, 0]
    tot_src = jnp.take_along_axis(tot_raw, src, axis=1)
    tot_srcm = jnp.take_along_axis(tot_m, src, axis=1)
    src_start = jnp.take_along_axis(starts, src, axis=1)

    is_donor_block = jnp.arange(J, dtype=jnp.int32)[None, :] < J1
    # inherited soft clips: combineWith extends the source GenomeHit,
    # which may already be trimmed (hi_aligner.h:1285 operates on the
    # trimmed hit) — the composite keeps the clip on the side the source
    # still covers.  Clip cost prefix Cc[a] = sum clip_pen[q[0..a)]
    # (the trim3 quirk indexes quality from the read START,
    # hi_aligner.h:3700-3702, so one prefix serves both ends).
    if src_clip_l is not None:
        q = jnp.minimum(quals, 63)
        ccost = jnp.where(
            jnp.arange(L, dtype=jnp.int32)[None, :] < lens2,
            clip_pen[q], 0)
        Cc = jnp.concatenate(
            [jnp.zeros((N, 1), jnp.int32), jnp.cumsum(ccost, axis=1)],
            axis=1)                                              # [N, L+1]
        cl_src = jnp.take_along_axis(src_clip_l, src, axis=1)
        cr_src = jnp.take_along_axis(src_clip_r, src, axis=1)
        cl_d = jnp.where(cl_src < x_all, cl_src, 0)
        cr_a = jnp.where((lens2 - cr_src) > x_all, cr_src, 0)
        ps_cl = jnp.take_along_axis(
            jnp.take_along_axis(P_raw, src[:, :, None], axis=1),
            cl_d[:, :, None], axis=2)[:, :, 0]
        cc_cl = jnp.take_along_axis(Cc, cl_d, axis=1)
        ps_cr = jnp.take_along_axis(
            jnp.take_along_axis(P_raw, src[:, :, None], axis=1),
            (lens2 - cr_a)[:, :, None], axis=2)[:, :, 0]
        cc_cr = jnp.take_along_axis(Cc, cr_a, axis=1)
    else:
        cl_d = cr_a = jnp.zeros((N, J), jnp.int32)
        ps_cl = cc_cl = cc_cr = jnp.zeros((N, J), jnp.int32)
        ps_cr = None
    # donor-keyed: left = src prefix (minus inherited left clip),
    # right = fresh suffix
    score_d = -((ps_x - ps_cl) + cc_cl + (tot_f - pf_x))
    mm_new_d = tot_fm - pfm_x
    anchor_d = lens2 - x_all
    d1_d, d2_d = src_start, fresh
    # acceptor-keyed: left = fresh prefix, right = src suffix (minus
    # inherited right clip)
    if ps_cr is not None:
        score_a = -(pf_x + (ps_cr - ps_x) + cc_cr)
    else:
        score_a = -(pf_x + (tot_src - ps_x))
    mm_new_a = pfm_x
    anchor_a = x_all
    d1_a, d2_a = fresh, src_start
    score = jnp.where(is_donor_block, score_d, score_a)
    mm_new = jnp.where(is_donor_block, mm_new_d, mm_new_a)
    anchor_new = jnp.where(is_donor_block, anchor_d, anchor_a)
    d1 = jnp.where(is_donor_block, d1_d, d1_a)
    d2 = jnp.where(is_donor_block, d2_d, d2_a)
    out_cl = jnp.where(is_donor_block, cl_d, 0)
    out_cr = jnp.where(is_donor_block, 0, cr_a)

    # junction classification from the site's flanking dinucleotides
    jl = d1 + x_all                       # first intron base (joined)
    jr = d2 + x_all - 1                   # last intron base
    def ref_at(p):
        from . import rank as rk
        oobp = (p < 0) | (p >= n_text)
        c = rk.ref_char(ref_words, jnp.clip(p, 0, n_text - 1))
        return jnp.where(oobp, jnp.int32(4), c)
    dl = jnp.where((ref_at(jl) < 4) & (ref_at(jl + 1) < 4),
                   ref_at(jl) * 16 + ref_at(jl + 1), 255)
    ar = jnp.where((ref_at(jr - 1) < 4) & (ref_at(jr) < 4),
                   ref_at(jr - 1) * 16 + ref_at(jr), 255)
    can_fw = (dl == 0x23) & (ar == 0x02)
    can_rc = (dl == 0x13) & (ar == 0x01)
    semi_fw = ((dl == 0x21) & (ar == 0x02)) | ((dl == 0x03) & (ar == 0x01))
    semi_rc = ((dl == 0x13) & (ar == 0x21)) | ((dl == 0x20) & (ar == 0x03))
    spldir = jnp.where(
        can_fw, SPL_FW,
        jnp.where(can_rc, SPL_RC,
                  jnp.where(semi_fw, SPL_SEMI_FW,
                            jnp.where(semi_rc, SPL_SEMI_RC, SPL_UNKNOWN))))

    # donor-coverage gate (oracle-probed, rf905 class): the LEFT exon
    # piece must reach the donor base cleanly — when the read column
    # just left of the junction (x-1) is a non-forgiven mismatch on the
    # left diagonal, the reference never forms this site's join: the
    # left anchor's extension stops before the donor (donor-keyed
    # lookup misses the site), and the acceptor-keyed combine's left
    # piece fails its anchor-purity gate (ned <= la//4 with a 0-length
    # junction-adjacent anchor, spliced_aligner.h:505-510).  The oracle
    # instead re-discovers a shifted novel junction at full penalty.
    ps_xm1 = jnp.take_along_axis(
        jnp.take_along_axis(P_raw, src[:, :, None], axis=1),
        x_m1[:, :, None], axis=2)[:, :, 0]
    left_pen_at_donor = jnp.where(is_donor_block, ps_x - ps_xm1,
                                  pf_x - pf_xm1)
    import os as _os
    if _os.environ.get('HISAT2_TPU_NO_DONOR_GATE') != '1':
        ok_all = ok_all & (left_pen_at_donor == 0)

    ok_all &= (x_all >= 1) & (x_all <= lens2 - 1) & (d2 > d1)
    # anchor-quality: the injected side must be clean enough
    # (nedits <= anchorLen / 4, spliced_aligner.h:391)
    ok_all &= mm_new <= anchor_new // 4
    ok_all &= score >= minsc[:, None]
    # the clip must not swallow the junction-adjacent anchor entirely
    ok_all &= (out_cl < x_all) & (out_cr < lens2 - x_all)
    score = jnp.where(ok_all, score, -_BIG)
    return dict(score=score, d1=d1, d2=d2, x=x_all,
                kind=jnp.where(ok_all, KIND_SPL, KIND_NONE),
                spldir=spldir,
                splscore=jnp.zeros_like(score, jnp.float32),
                clip_l=jnp.where(ok_all, out_cl, 0),
                clip_r=jnp.where(ok_all, out_cr, 0),
                src=src)


MAX_INS = 16     # longest known insertion handled by the injection kernel


def inject_indels(ref_words, n_text: int, reads, quals, lens,
                  starts, valid, P_snv, tot_snv,
                  ip, ilen, ins_chars, rkey, r_ilen, r_row,
                  mm_pen, n_pen: int, minsc,
                  snv_delta1=None, snv_delta2=None, slots: int = 2):
    """Known ALT indel (ins/del) candidates by event injection — the
    batched counterpart of alignWithALTs_recur branching into compatible
    indel ALTs (hi_aligner.h:2586-3377): for each candidate
    diagonal, nearby indel events determine the junction position and the
    complementary diagonal exactly; the variant costs nothing
    (snpID-tagged edits score 0, hi_aligner.h:3670-3686).

    ip/ilen: events sorted by joined position (ilen > 0 deletion,
    < 0 insertion); ins_chars: int32 [E, MAX_INS] unpacked alleles;
    rkey/r_ilen/r_row: the same events sorted by right-side key ip + ilen
    (r_row = index back into the left-sorted arrays).  The returned `event`
    field is the LEFT-sorted table row (host maps it to variant ids).
    P_snv/tot_snv: SNP-forgiving penalty prefixes on base diagonals."""
    from . import extend as extend_ops
    N, C = starts.shape
    L = reads.shape[1]
    E = ip.shape[0]
    lens2 = lens[:, None]

    xs_, d2_, ok_, src_, ev_, ln_ = [], [], [], [], [], []
    # left-keyed: src diagonal is the LEFT side; x = ip - d
    lo = jnp.searchsorted(ip, starts + 1)
    for t in range(slots):
        idx = jnp.minimum(lo + t, E - 1)
        okd = (lo + t < E) & valid & (ip[idx] >= starts + 1) \
            & (ip[idx] <= starts + lens2 - 1)
        x = jnp.where(okd, ip[idx] - starts, 1)
        xs_.append(x)
        d2_.append(starts + ilen[idx])
        ok_.append(okd)
        ev_.append(idx)
        ln_.append(ilen[idx])
        src_.append(jnp.broadcast_to(
            jnp.arange(C, dtype=jnp.int32)[None, :], (N, C)))
    # right-keyed: src diagonal is the RIGHT side; x = (ip + ilen) - d
    lo2 = jnp.searchsorted(rkey, starts + 1)
    for t in range(slots):
        idx = jnp.minimum(lo2 + t, E - 1)
        okd = (lo2 + t < E) & valid & (rkey[idx] >= starts + 1) \
            & (rkey[idx] <= starts + lens2 - 1)
        x = jnp.where(okd, rkey[idx] - starts, 1)
        xs_.append(x)
        d2_.append(starts - r_ilen[idx])   # = d1, the LEFT diagonal
        ok_.append(okd)
        ev_.append(r_row[idx])
        ln_.append(r_ilen[idx])
        src_.append(jnp.broadcast_to(
            jnp.arange(C, dtype=jnp.int32)[None, :], (N, C)))
    J1 = C * slots
    x_all = jnp.concatenate(xs_, axis=1)
    fresh = jnp.concatenate(d2_, axis=1)
    ok_all = jnp.concatenate(ok_, axis=1)
    event = jnp.concatenate(ev_, axis=1)
    elen = jnp.concatenate(ln_, axis=1)      # +del / -ins
    src = jnp.concatenate(src_, axis=1)
    J = x_all.shape[1]
    is_left = jnp.arange(J, dtype=jnp.int32)[None, :] < J1
    I = jnp.maximum(-elen, 0)

    # prefix scalars of the fresh-diagonal planes over LIVE columns only
    # (left side uses the prefix at x, right side at x + inslen)
    xr = jnp.minimum(x_all + I, L)
    tot_f, _, ppfx = extend_ops.live_pen_prefix(
        ref_words, n_text, reads, quals, lens, mm_pen, n_pen,
        fresh, ok_all, [x_all, xr],
        snv_delta1=snv_delta1, snv_delta2=snv_delta2)
    (pf_x, _), (pf_xr, _) = ppfx
    ps_x = jnp.take_along_axis(
        jnp.take_along_axis(P_snv, src[:, :, None], axis=1),
        x_all[:, :, None], axis=2)[:, :, 0]
    ps_xr = jnp.take_along_axis(
        jnp.take_along_axis(P_snv, src[:, :, None], axis=1),
        xr[:, :, None], axis=2)[:, :, 0]
    tot_src = jnp.take_along_axis(tot_snv, src, axis=1)
    src_start = jnp.take_along_axis(starts, src, axis=1)
    # left-keyed: left = src prefix at x, right = fresh suffix from x+I
    score_l = -(ps_x + (tot_f - pf_xr))
    # right-keyed: left = fresh prefix at x, right = src suffix from x+I
    score_r = -(pf_x + (tot_src - ps_xr))
    score = jnp.where(is_left, score_l, score_r)
    d1 = jnp.where(is_left, src_start, fresh)
    d2 = jnp.where(is_left, fresh, src_start)

    # insertions: the skipped read bases must equal the variant allele
    ins_ok = jnp.ones((N, J), bool)
    if E > 0:
        col = jnp.arange(MAX_INS, dtype=jnp.int32)[None, None, :]
        rpos = x_all[:, :, None] + col                   # [N, J, MAX_INS]
        rb = jnp.take_along_axis(
            jnp.broadcast_to(reads[:, None, :], (N, J, L)),
            jnp.minimum(rpos, L - 1), axis=2)
        ev_chars = ins_chars[jnp.maximum(event, 0)]      # [N, J, MAX_INS]
        need = col < I[:, :, None]
        ins_ok = jnp.where(need, rb == ev_chars, True).all(axis=2)
        ins_ok |= elen > 0

    ok_all &= (x_all >= 1) & (x_all + I <= lens2 - 1) & ins_ok
    ok_all &= score >= minsc[:, None]
    score = jnp.where(ok_all, score, -_BIG)
    return dict(score=score, d1=d1, d2=d2, x=x_all,
                kind=jnp.where(ok_all,
                               jnp.where(elen > 0, KIND_DEL, KIND_INS),
                               KIND_NONE),
                spldir=jnp.zeros_like(score),
                splscore=jnp.zeros_like(score, jnp.float32),
                event=jnp.where(ok_all, event, -1),
                src=src)


def self_indel_sweep(ch, reads, quals, lens, starts, valid, minsc,
                     mm_pen, n_pen: int, prm: SpliceParams,
                     snv1_w=None, snv2_w=None, max_gap: int = None):
    """Single-anchor small-gap (indel) discovery.

    For each candidate diagonal, sweep read/ref gaps of 1..max_gap against
    SHIFTED copies of its own reference window — the short side of the gap
    needs no FM anchor because the long side pins the diagonal and the gap
    is bounded.  This covers the reference's local-GFM-search rescue of
    indels whose short flank never forms a global anchor (the global
    partial search walks THROUGH the gap producing a chimeric hit on the
    wrong diagonal; SplicedAligner::hybridSearch_recur re-searches the
    remaining span in the 57kb local index instead,
    spliced_aligner.h:736,1391).

    ch: [N, C, L+2M] diagonal ref chars (diag_chars output, M >= max_gap);
    snv1_w/snv2_w: same-shape SNV delta windows (known SNVs are forgiven
    in indel joins like inject_indels/extension, hi_aligner.h:1781-1797).
    Returns one row per candidate ([N, C]) in pair_sweep's block format:
    d1/d2 = left/right diagonal so junc_len = d2 - d1 downstream.
    """
    N, C, W = ch.shape
    L = reads.shape[1]
    M = (W - L) // 2
    # gaps beyond the score budget (-minsc - open) / ext can never pass
    # the per-read minsc gate; the caller passes that bound (which may
    # exceed max_gap when gap costs are lowered via --rdg/--rfg — the
    # reference's deletion size is budget-limited, not constant-limited)
    G = int(min(M, max_gap if max_gap else prm.max_gap))
    rd = reads[:, None, :]
    mmq = mm_pen[jnp.minimum(quals, 63)][:, None, :]
    ln = lens[:, None]
    colL = jnp.arange(L, dtype=jnp.int32)[None, None, :]
    vp = colL < ln[:, :, None]
    isn_pen = jnp.where(vp & (rd >= 4), jnp.int32(n_pen), 0)
    zero3 = jnp.zeros((N, C, 1), jnp.int32)

    def prefix(delta):
        """(forgiving penalty prefix, RAW mismatch count prefix) — the raw
        count feeds the x tie rule: among equal-penalty gap placements the
        reference lands on the one using the fewest ALT-forgiven columns
        (its extension walks raw matches first; see pair_sweep)."""
        chs = jax.lax.dynamic_slice_in_dim(ch, M + delta, L, axis=2)
        mm = vp & (rd < 4) & (chs < 4) & (rd != chs)
        raw = jnp.concatenate(
            [zero3, jnp.cumsum(mm.astype(jnp.int32), axis=2)], axis=2)
        if snv1_w is not None:
            v1 = jax.lax.dynamic_slice_in_dim(snv1_w, M + delta, L, axis=2)
            v2 = jax.lax.dynamic_slice_in_dim(snv2_w, M + delta, L, axis=2)
            mm &= ~(((v1 != 0) & (rd == ((chs + v1) & 3)))
                    | ((v2 != 0) & (rd == ((chs + v2) & 3))))
        pen = (jnp.where(mm, mmq, 0) + isn_pen
               + jnp.where(vp & (chs > 3), jnp.int32(100000), 0))
        return (jnp.concatenate([zero3, jnp.cumsum(pen, axis=2)], axis=2),
                raw)

    def shifted(P, g, tot):
        # P[x + g] for x = 0..L (prefix saturates at the total)
        tail = jnp.broadcast_to(tot[:, :, None], (N, C, g))
        return jnp.concatenate([P[:, :, g:], tail], axis=2)

    ln2b = jnp.broadcast_to(ln, (N, C))
    P0, R0 = prefix(0)
    T0 = compact_ops.take_last(P0, ln2b)
    TR0 = compact_ops.take_last(R0, ln2b)
    xs = jnp.arange(L + 1, dtype=jnp.int32)[None, None, :]

    # two result sets from one pass over the planes:
    #  strict — the short flank must be >= minAnchorLen: the reference's
    #    local search never starts below it (`if(extoff <
    #    tpol.minAnchorLen()) extoff = tpol.minAnchorLen()`,
    #    spliced_aligner.h:724) — verified vs oracle: a 2bp insertion
    #    behind a 5bp flank is soft-clipped (7S93M), behind a 7bp flank it
    #    is aligned (7M4I89M); these rows are also best-score-suppressed
    #  wide — split anywhere (x >= 1), the two-FM-anchor combineWith
    #    geometry; valid only when the shifted diagonal is itself a
    #    candidate (the caller checks), like pair_sweep's indel rows
    #
    # each combo's penalty plane is folded into a running elementwise min
    # of ((pen << 6 | raw_mm) << 6 | combo_id); the (combo, x) winner
    # decodes from TWO final argmins instead of one reduction per combo —
    # tie-break order (pen, raw mismatches, combo order, lowest x): the
    # raw tier picks the placement using the fewest ALT-forgiven columns
    _PCAP = 1 << 19    # pen clamp so ((pen << 6 | raw) << 6 | cid) fits
    BIGP = jnp.int32(2 ** 31 - 1)
    run_s = jnp.full((N, C, L + 1), BIGP, jnp.int32)
    run_w = jnp.full((N, C, L + 1), BIGP, jnp.int32)
    A = jnp.int32(prm.min_anchor)
    cmeta = []     # cid -> (o1, o2, kind, gap cost)
    for g in range(1, G + 1):
        Pm, Rm = prefix(-g)
        Pp, Rp = prefix(+g)
        Tm = compact_ops.take_last(Pm, ln2b)
        Tp = compact_ops.take_last(Pp, ln2b)
        TRm = compact_ops.take_last(Rm, ln2b)
        TRp = compact_ops.take_last(Rp, ln2b)
        cdel = int(prm.rd_gap_open + prm.rd_gap_ext * g)
        cins = int(prm.rf_gap_open + prm.rf_gap_ext * g)
        okw_d = (xs >= 1) & (xs <= ln[:, :, None] - 1)
        okw_i = (xs >= 1) & (xs + g <= ln[:, :, None] - 1)
        oks_d = (xs >= A) & (xs <= ln[:, :, None] - A)
        oks_i = (xs >= A) & (xs + g <= ln[:, :, None] - A)
        combos = (
            # deletion, candidate holds the RIGHT segment: left = d - g
            (Pm + (T0[:, :, None] - P0) + cdel,
             Rm + (TR0[:, :, None] - R0), oks_d, okw_d,
             (-g, 0, KIND_DEL)),
            # deletion, candidate holds the LEFT segment: right = d + g
            (P0 + (Tp[:, :, None] - Pp) + cdel,
             R0 + (TRp[:, :, None] - Rp), oks_d, okw_d,
             (0, g, KIND_DEL)),
            # insertion, candidate holds the RIGHT segment: left = d + g
            (Pp + (T0[:, :, None] - shifted(P0, g, T0)) + cins,
             Rp + (TR0[:, :, None] - shifted(R0, g, TR0)),
             oks_i, okw_i, (g, 0, KIND_INS)),
            # insertion, candidate holds the LEFT segment: right = d - g
            (P0 + (Tm[:, :, None] - shifted(Pm, g, Tm)) + cins,
             R0 + (TRm[:, :, None] - shifted(Rm, g, TRm)),
             oks_i, okw_i, (0, -g, KIND_INS)),
        )
        for pen, raw, oks, okw, meta2 in combos:
            cid = len(cmeta)
            cmeta.append(meta2)
            packed = (jnp.minimum(pen, _PCAP - 1) * 64
                      + jnp.minimum(raw, 63)) * 64 + cid
            run_s = jnp.minimum(run_s, jnp.where(oks, packed, BIGP))
            run_w = jnp.minimum(run_w, jnp.where(okw, packed, BIGP))

    src = jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32)[None, :], (N, C))
    o1_t = jnp.asarray([m[0] for m in cmeta] + [0], jnp.int32)
    o2_t = jnp.asarray([m[1] for m in cmeta] + [0], jnp.int32)
    kd_t = jnp.asarray([m[2] for m in cmeta] + [0], jnp.int32)

    def pack(running, prefix_key=""):
        am = jnp.argmin(running, axis=2).astype(jnp.int32)
        val = running.min(axis=2)
        cid = jnp.minimum(val & 63, len(cmeta))
        best = val >> 12
        score = -best
        ok = valid & (score >= minsc[:, None]) \
            & (val < ((_PCAP - 1) * 4096))
        cid = jnp.where(ok, cid, len(cmeta))
        return {prefix_key + "score": jnp.where(ok, score, -_BIG),
                prefix_key + "d1": starts + o1_t[cid],
                prefix_key + "d2": starts + o2_t[cid],
                prefix_key + "x": jnp.where(ok, am, 0),
                prefix_key + "kind": jnp.where(ok, kd_t[cid], KIND_NONE),
                prefix_key + "spldir": jnp.zeros((N, C), jnp.int32),
                prefix_key + "splscore": jnp.zeros((N, C), jnp.float32)}
    out = pack(run_s)
    out.update(pack(run_w, "w_"))
    out["src"] = src
    return out


def second_sweep(ch, pen_spl, mm_raw, starts, valid, lens, minsc,
                 tables, prm: SpliceParams,
                 b_i, b_j, b_x, b_score, b_valid,
                 ss=None, rdids=None):
    """Second-junction sweep for multi-exon reads: given each lane's best
    junction candidate (segments on diagonals i0/j0 split at x1), sweep a
    SECOND splice junction against every candidate diagonal, on the right
    (j0 -> d3 at x2 > x1) and on the left (d0 -> i0 at x0 < x1).

    The composite's prefix/suffix penalties collapse to a constant plus the
    inner diagonal's own plane: Pc[x] = P_j0[x] - score1 - total_j0 (and
    symmetrically for the left) - so the sweep is the ordinary pair sweep
    with an offset, O(C * L) per lane.

    This is the batched shape of hybridSearch_recur's recursion depth 2
    (spliced_aligner.h:214+); the reference builds the same three-segment
    GenomeHits by recursive combineWith calls.
    """
    N, C, L = pen_spl.shape
    M = (ch.shape[2] - L) // 2
    donor_sum, acc1t, acc2t = tables
    zero3 = jnp.zeros((N, C, 1), jnp.int32)
    Ps = jnp.concatenate([zero3, jnp.cumsum(pen_spl, axis=2)], axis=2)
    Pm = jnp.concatenate(
        [zero3, jnp.cumsum(mm_raw.astype(jnp.int32), axis=2)], axis=2)
    lens3 = jnp.broadcast_to(lens[:, None, None], (N, C, 1))
    tot = jnp.take_along_axis(Ps, lens3, axis=2)[:, :, 0]

    d0c = jax.lax.dynamic_slice_in_dim(ch, M + 0, L + 1, axis=2)
    d1c = jax.lax.dynamic_slice_in_dim(ch, M + 1, L + 1, axis=2)
    a0c = jax.lax.dynamic_slice_in_dim(ch, M - 2, L + 1, axis=2)
    a1c = jax.lax.dynamic_slice_in_dim(ch, M - 1, L + 1, axis=2)
    dcode = jnp.where((d0c < 4) & (d1c < 4), d0c * 16 + d1c, 255)
    acode = jnp.where((a0c < 4) & (a1c < 4), a0c * 16 + a1c, 255)
    dsum_fw, dsum_rc, asum_fw, asum_rc = _pwm_planes(ch, M, L)

    def row(arr, idx):
        return jnp.take_along_axis(arr, idx[:, None, None], axis=1)[:, 0]

    def classify(dl, ar):
        can_fw = (dl == 0x23) & (ar == 0x02)
        can_rc = (dl == 0x13) & (ar == 0x01)
        semi_fw = ((dl == 0x21) & (ar == 0x02)) \
            | ((dl == 0x03) & (ar == 0x01))
        semi_rc = ((dl == 0x13) & (ar == 0x21)) \
            | ((dl == 0x20) & (ar == 0x03))
        spldir = jnp.where(
            can_fw, SPL_FW,
            jnp.where(can_rc, SPL_RC,
                      jnp.where(semi_fw, SPL_SEMI_FW,
                                jnp.where(semi_rc, SPL_SEMI_RC,
                                          SPL_UNKNOWN))))
        return spldir, can_fw | can_rc

    xs = jnp.arange(L + 1, dtype=jnp.int32)[None, None, :]     # [1,1,L+1]
    lens4 = lens[:, None, None]
    outs = {}
    for side in ("right", "left"):
        if side == "right":
            inner = b_j                     # donor side plane
            tot_in = jnp.take_along_axis(tot, inner[:, None], axis=1)[:, 0]
            Pc = row(Ps, inner)[:, None, :] \
                - (b_score + tot_in)[:, None, None]            # [N,1,L+1]
            Sd = tot[:, :, None] - Ps                          # [N,C,L+1]
            score = -(Pc + Sd)
            dl = row(dcode, inner)[:, None, :]
            ar = acode
            dsf, dsr = row(dsum_fw, inner)[:, None, :], dsum_rc
            asf, asr = asum_fw, row(asum_rc, inner)[:, None, :]
            D = starts - jnp.take_along_axis(
                starts, inner[:, None], axis=1)                # [N,C]
            vx = (xs > b_x[:, None, None]) & (xs <= lens4 - 1)
            mm_in = row(Pm, inner)
            anchor_l = (xs - b_x[:, None, None]) \
                - 2 * (mm_in[:, None, :] - jnp.take_along_axis(
                    mm_in, b_x[:, None], axis=1)[:, :, None])
            anchor_r = (lens4 - xs) - 2 * (
                jnp.take_along_axis(Pm, lens3, axis=2)[:, :, :1] - Pm)
        else:
            inner = b_i                     # acceptor side plane
            Sc = -(b_score[:, None, None]
                   + row(Ps, inner)[:, None, :])                # [N,1,L+1]
            Pd = Ps                                             # [N,C,L+1]
            score = -(Pd + Sc)
            dl = dcode
            ar = row(acode, inner)[:, None, :]
            dsf, dsr = dsum_fw, row(dsum_rc, inner)[:, None, :]
            asf, asr = row(asum_fw, inner)[:, None, :], asum_rc
            D = jnp.take_along_axis(starts, inner[:, None], axis=1) \
                - starts                                        # [N,C]
            vx = (xs >= 1) & (xs < b_x[:, None, None])
            anchor_l = xs - 2 * Pm
            in_mm = row(Pm, inner)
            anchor_r = (b_x[:, None, None] - xs) - 2 * (
                jnp.take_along_axis(in_mm, b_x[:, None], axis=1
                                    )[:, :, None] - in_mm[:, None, :])

        spldir4, canonical = classify(dl, ar)
        is_spl2 = (D >= prm.min_intron) & (D <= prm.max_intron) \
            & valid & b_valid[:, None]
        pen2 = jnp.where(canonical, prm.pen_can, prm.pen_noncan)
        prod = jnp.where((dl == 0x23) & (ar == 0x02), dsf * asf, dsr * asr)
        splsc = jnp.where(canonical, 1.0 / (1.0 + prod), 0.0)
        # known/temp splice sites: the second junction is free and gate-
        # exempt when it matches a usable site (knownSpl semantics)
        known4 = jnp.zeros((N, 1, L + 1), bool)
        if ss is not None:
            S = ss["ss_kd"].shape[0]
            xs1 = jnp.arange(L + 1, dtype=jnp.int32)[None, :]
            inner_start = jnp.take_along_axis(
                starts, inner[:, None], axis=1)              # [N, 1]
            if side == "right":
                # donor on the inner plane at x-1; acceptor on d3 at x
                posd = inner_start + xs1 - 1                 # [N, L+1]
                lo = table_searchsorted(ss["ss_kd"], posd,
                                        ss.get("ss_kd_lob"),
                                        ss.get("ss_shift"))
                known_c = jnp.zeros((N, C, L + 1), bool)
                for t in range(2):
                    ii = jnp.minimum(lo + t, S - 1)
                    m = (lo + t < S) & (ss["ss_kd"][ii] == posd)
                    if rdids is not None:
                        srd = ss["ss_rdid"][ii]
                        m &= (srd < 0) | (srd < rdids[:, None])
                    ka_v = ss["ss_ka"][ii]                   # [N, L+1]
                    known_c |= m[:, None, :] & (
                        ka_v[:, None, :]
                        == starts[:, :, None] + xs1[None, :, :])
                known4 = known_c
            else:
                # acceptor on the inner plane at x; donor on d0 at x-1
                posa = inner_start + xs1                     # [N, L+1]
                lo = table_searchsorted(ss["ss_ka_s"], posa,
                                        ss.get("ss_ka_lob"),
                                        ss.get("ss_shift"))
                known_c = jnp.zeros((N, C, L + 1), bool)
                for t in range(2):
                    ii = jnp.minimum(lo + t, S - 1)
                    m = (lo + t < S) & (ss["ss_ka_s"][ii] == posa)
                    if rdids is not None:
                        srd = ss["ss_rdid_a"][ii]
                        m &= (srd < 0) | (srd < rdids[:, None])
                    kd_v = ss["ss_kd_s"][ii]
                    known_c |= m[:, None, :] & (
                        kd_v[:, None, :]
                        == starts[:, :, None] + xs1[None, :, :] - 1)
                known4 = known_c
        pen2 = jnp.where(known4, 0, pen2)
        sc2 = score - pen2
        valid4 = vx & is_spl2[:, :, None]
        # novel gates (same thresholds as the primary sweep)
        sh = jnp.maximum(jnp.minimum(anchor_l, anchor_r), 1)
        thresh = jnp.where(canonical,
                           max_intron_len(sh, prm.min_anchor),
                           max_intron_len_noncan(sh, prm.min_anchor_noncan))
        gated = thresh < prm.max_intron
        D3 = D[:, :, None]
        pth = jnp.where(D3 >= (1 << 16), 0.99,
                        jnp.where(D3 >= (1 << 15), 0.97,
                                  jnp.where(D3 >= (1 << 14), 0.94,
                                            jnp.where(D3 >= (1 << 13), 0.91,
                                                      jnp.where(
                                                          D3 >= (1 << 12),
                                                          0.88, 0.8)))))
        ok4 = valid4 & (known4 | ~(gated & (D3 > thresh))
                        & ~(gated & canonical & (splsc < pth)))
        logd = jnp.log(jnp.maximum(D3, 1).astype(jnp.float32))
        lenpen = jnp.maximum(jnp.where(
            canonical,
            (prm.lenpen_const + prm.lenpen_coef * logd).astype(jnp.int32),
            (prm.lenpen_nc_const + prm.lenpen_nc_coef * logd
             ).astype(jnp.int32)), 0)
        lenpen = jnp.where(known4, 0, lenpen)
        sc2u = jnp.where(ok4, sc2 - lenpen, -_BIG)
        sc2 = jnp.where(sc2u >= minsc[:, None, None], sc2u, -_BIG)

        def fold(scv, pfx):
            # best (dir > score > prob > first x) folded over [C, L+1]
            hd = jnp.where(spldir4 != SPL_UNKNOWN, 1, 0)
            k1 = jnp.where(scv > -_BIG // 2,
                           (hd << 23) + jnp.maximum(scv, -(2 ** 21))
                           + 2 ** 21, -1)
            flat = k1.reshape(N, -1)
            m1 = flat.max(axis=1)
            tie = flat == m1[:, None]
            sflat = jnp.where(tie, splsc.reshape(N, -1), -1.0)
            s2b = sflat.max(axis=1)
            tie2 = tie & (sflat == s2b[:, None])
            pick = jnp.where(tie2, jnp.arange(flat.shape[1],
                                              dtype=jnp.int32)[None, :],
                             _BIG).min(axis=1)
            c_pick = jnp.minimum(pick // (L + 1), C - 1)
            x_pick = pick % (L + 1)
            dirflat = spldir4.reshape(N, -1)
            return {
                pfx + "score": jnp.where(
                    m1 >= 0, (m1 & ((1 << 23) - 1)) - 2 ** 21, -_BIG),
                pfx + "d": jnp.take_along_axis(
                    starts, c_pick[:, None], axis=1)[:, 0],
                pfx + "x": x_pick,
                pfx + "dir": jnp.take_along_axis(dirflat, jnp.minimum(
                    pick, flat.shape[1] - 1)[:, None], axis=1)[:, 0]}

        # the "u" set skips the per-side minsc gate: a side that cannot
        # stand alone may still reach minsc COMBINED with the other side
        # (3-junction composites; hybridSearch_recur recursion depth > 2,
        # spliced_aligner.h:183-214)
        outs[side] = dict(fold(sc2, ""), **fold(sc2u, "u"))
    return outs


def select_pairs(res: PairResult, starts, top: int = 4):
    """Flatten [N, C, C] pair results and take the top `top` per lane by
    score (ties by flattened index = leftmost diagonals first)."""
    N, C, _ = res.score.shape
    flat = res.score.reshape(N, C * C)
    val, idx = jax.lax.top_k(flat, top)                     # [N, T]
    i = idx // C
    j = idx % C
    gather = lambda a: jnp.take_along_axis(a.reshape(N, C * C), idx, axis=1)
    return dict(score=val, i=i, j=j,
                d1=jnp.take_along_axis(starts, i, axis=1),
                d2=jnp.take_along_axis(starts, j, axis=1),
                x=gather(res.x), kind=gather(res.kind),
                spldir=gather(res.spldir), splscore=gather(res.splscore))
