"""Batched partial search: the wavefront equivalent of HI_Aligner::partialSearch.

The reference walks one read at a time right-to-left over the global index,
recording maximal SA-range hits and restarting after each mismatch/empty range
(/root/reference/hi_aligner.h:5434-5678).  Here *all* (read, orientation)
lanes advance one LF step per scan iteration: per-lane state is
(top, bot, lo, rb) plus a fixed-capacity hit list, so the whole search is one
`lax.scan` of length max_read_len with two rank gathers per lane per step.

Semantics per lane, scanning pos = len-1 .. 0:
  - extend current range with read[pos]; if still non-empty, continue;
  - ANCHOR STOP (hi_aligner.h:5603-5608): once a segment is >= min_k+12 bp
    with a WIDTH-1 range, close it and restart — the reference stops its
    whole per-orientation search here and leaves the rest of the read to
    extension/recombination; we keep scanning so later segments exist for
    the junction sweep, but tag every segment with how many NON-UNIQUE
    rounds preceded it (numActualPartialSearch, hi_aligner.h:265-268) so the
    reporting layer can replay the reference's search budget
    (nextBWT give-up rule, hi_aligner.h:3988-4035).
    The stop is disarmed for a segment that still has >= 4 rows at
    min_k+8 bp (repetitive anchors keep extending — hi_aligner.h:5588).
  - otherwise close the current hit [pos+1, rb) (recorded if it spans
    >= min_hit_len bases) and restart at pos: the new range is the
    single-char range [fchr[c], fchr[c+1]) (so position pos starts the next
    hit), or the full range if read[pos] is N/absent (the char is skipped,
    mirroring partialSearch's N handling).
The hits partition the read into non-overlapping segments, exactly like the
reference's ReadBWTHit bookkeeping (hi_aligner.h:216-390).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import rank as rk


class PartialHits(NamedTuple):
    rounds: jnp.ndarray   # int32 [B, RW] byte-packed per-round log
    #                         (4 rounds/word, each len*2+uniq), ALL search
    #                         rounds incl. sub-min_hit_len segments - the
    #                         searchScore/give-up replay needs them
    nrounds: jnp.ndarray  # int32 [B]
    top: jnp.ndarray      # int32 [B, H]
    bot: jnp.ndarray      # int32 [B, H]
    lo: jnp.ndarray       # int32 [B, H]  leftmost read pos covered
    hi: jnp.ndarray       # int32 [B, H]  one past rightmost read pos covered
    nh: jnp.ndarray       # int32 [B]
    abefore: jnp.ndarray  # int32 [B, H]  # non-unique rounds before this one
    uniq: jnp.ndarray     # bool  [B, H]  anchor-stop / terminal segment
    post: jnp.ndarray     # bool  [B, H]  segment begins after an anchor stop
    #   (the reference never searches these in partialSearch — they model
    #    hybridSearch's re-search of uncovered regions, hi_aligner.h:4061)
    stopped: jnp.ndarray  # bool  [B]  lane had an anchor stop (search ended
    #   before consuming the whole read: getAnchorHits then resolves only
    #   width-1 hits — max_size=1, hi_aligner.h:4341)


def _partial_search_ref(blocked, fchr, zrow: int, rows: int,
                   reads, lens, max_hits: int = 8,
                   min_hit_len: int = 16, min_k: int = 16) -> PartialHits:
    """reads: int32 [B, L] codes (0-4), left-aligned; lens: int32 [B]."""
    B, L = reads.shape
    H = max_hits
    a_stop_len = np.int32(min_k + 12)
    a_cancel_len = np.int32(min_k + 8)

    R = L // 2 + 2          # worst case: a segment every other base

    def log_round(st, cond, seg_len, uq):
        ht, hb, hl, hh, ha, hu, hp, nh, na, rl, rn = st
        sel = (jnp.arange(R, dtype=jnp.int32)[None, :] == rn[:, None]) \
            & (cond & (rn < R))[:, None]
        val = jnp.minimum(seg_len, 126) * 2 + uq.astype(jnp.int32)
        rl = jnp.where(sel, val[:, None], rl)
        rn = rn + (cond & (rn < R)).astype(jnp.int32)
        return (ht, hb, hl, hh, ha, hu, hp, nh, na, rl, rn)

    def write_hit(st, cond, top, bot, lo_v, hi_v, uq, stopped):
        ht, hb, hl, hh, ha, hu, hp, nh, na, rl, rn = st
        write = cond & (nh < H)
        sel = (jnp.arange(H, dtype=jnp.int32)[None, :] == nh[:, None]) \
            & write[:, None]
        ht = jnp.where(sel, top[:, None], ht)
        hb = jnp.where(sel, bot[:, None], hb)
        hl = jnp.where(sel, lo_v[:, None], hl)
        hh = jnp.where(sel, hi_v[:, None], hh)
        ha = jnp.where(sel, na[:, None], ha)
        hu = jnp.where(sel, uq[:, None], hu)
        hp = jnp.where(sel, stopped[:, None], hp)
        nh = nh + write.astype(jnp.int32)
        na = na + (cond & ~uq).astype(jnp.int32)
        return (ht, hb, hl, hh, ha, hu, hp, nh, na, rl, rn)

    def step(state, s):
        (top, bot, lo, rb, arm, stopped,
         ht, hb, hl, hh, ha, hu, hp, nh, na, rl, rn) = state
        pos = lens - 1 - s                           # [B]
        active = pos >= 0
        c = jnp.take_along_axis(
            reads, jnp.maximum(pos, 0)[:, None], axis=1)[:, 0]
        cc = jnp.minimum(c, 3)
        valid_c = (c < 4) & active
        t2, b2 = rk.lf_range(blocked, fchr, zrow, top, bot, cc)
        ok = valid_c & (b2 > t2)
        seg = rb - pos                               # segment len incl. char
        width = b2 - t2
        # disarm the anchor stop for repetitive segments
        arm = arm & ~(ok & (seg - 1 >= a_cancel_len) & (width >= 4))
        astop = ok & arm & active & (seg >= a_stop_len) & (width == 1)
        fail = active & ~ok
        # close on mismatch/empty: [pos+1, rb)
        close_f = fail & (rb - (pos + 1) >= min_hit_len)
        st = (ht, hb, hl, hh, ha, hu, hp, nh, na, rl, rn)
        st = write_hit(st, close_f, top, bot, pos + 1, rb,
                       jnp.zeros((B,), bool), stopped)
        # close on anchor stop: [pos, rb) with the post-consume range
        st = write_hit(st, astop, t2, b2, pos, rb, jnp.ones((B,), bool),
                       stopped)
        # per-round log: EVERY closed segment (any length) is one
        # partialSearch round of the reference
        st = log_round(st, fail & ~stopped, rb - (pos + 1),
                       jnp.zeros((B,), bool))
        st = log_round(st, astop & ~stopped, rb - pos, jnp.ones((B,), bool))
        ht, hb, hl, hh, ha, hu, hp, nh, na, rl, rn = st
        stopped = stopped | astop
        # non-recorded failed segments still count as rounds when they were
        # actual searches (the reference records every round's hit; short
        # ones just never become candidates)
        na = na + (fail & (rb - (pos + 1) < min_hit_len)
                   & (rb > pos + 1)).astype(jnp.int32)
        # restart: after a mismatch the failing char is SKIPPED (nextBWT
        # advances cur past it, hi_aligner.h:4068: `if(hit._cur + 1 <
        # hit._len) hit._cur++;`), so the next segment starts at pos-1
        # with a full range; same for an anchor stop
        top_n = jnp.where(ok, t2, np.int32(0))
        bot_n = jnp.where(ok, b2, np.int32(rows))
        rb_n = jnp.where(ok, rb, pos)
        top_n = jnp.where(astop, np.int32(0), top_n)
        bot_n = jnp.where(astop, np.int32(rows), bot_n)
        rb_n = jnp.where(astop, pos, rb_n)
        arm = jnp.where(fail | astop, True, arm)
        top = jnp.where(active, top_n, top)
        bot = jnp.where(active, bot_n, bot)
        rb = jnp.where(active, rb_n, rb)
        lo = jnp.where(active, pos, lo)
        return (top, bot, lo, rb, arm, stopped,
                ht, hb, hl, hh, ha, hu, hp, nh, na, rl, rn), None

    z = jnp.zeros((B,), jnp.int32)
    zh = jnp.zeros((B, H), jnp.int32)
    zb = jnp.zeros((B, H), bool)
    zr = jnp.zeros((B, L // 2 + 2), jnp.int32)
    init = (z, jnp.full((B,), rows, jnp.int32),
            lens.astype(jnp.int32), lens.astype(jnp.int32),
            jnp.ones((B,), bool), jnp.zeros((B,), bool),
            zh, zh, zh, zh, zh, zb, zb, z, z, zr, z)
    (top, bot, lo, rb, arm, stopped,
     ht, hb, hl, hh, ha, hu, hp, nh, na, rl, rn), _ = \
        jax.lax.scan(step, init, jnp.arange(L, dtype=jnp.int32))
    # close the final open hit [lo, rb): a terminal full round is "unique"
    # (hi_aligner.h:5667-5670 counts the cur>=len CANDIDATE round as unique)
    close = (rb - lo) >= min_hit_len
    st = (ht, hb, hl, hh, ha, hu, hp, nh, na, rl, rn)
    st = write_hit(st, close, top, bot, lo, rb, jnp.ones((B,), bool),
                   stopped)
    st = log_round(st, (rb - lo > 0) & ~stopped, rb - lo,
                   jnp.ones((B,), bool))
    ht, hb, hl, hh, ha, hu, hp, nh, na, rl, rn = st
    # byte-pack the round log: 4 rounds per int32 word
    R = rl.shape[1]
    RW = (R + 3) // 4
    pad = jnp.zeros((B, RW * 4 - R), jnp.int32)
    rl4 = jnp.concatenate([rl, pad], axis=1).reshape(B, RW, 4)
    sh = jnp.arange(4, dtype=jnp.int32)[None, None, :] * 8
    rwords = (rl4 << sh).sum(axis=2)
    return PartialHits(rwords, rn, ht, hb, hl, hh, nh, ha, hu, hp, stopped)


def partial_search(blocked, fchr, zrow: int, rows: int,
                   reads, lens, max_hits: int = 8,
                   min_hit_len: int = 16, min_k: int = 16,
                   uniform: bool = False,
                   anchor_stop: bool = True) -> PartialHits:
    """Event-stream formulation of the wavefront search (same result as
    _partial_search_ref, bit-for-bit — see test_search_event_stream).

    The scan carries only (top, bot, rb, arm, stopped) and emits a
    3-plane per-step event stream (type, top, bot); hit slots, the round
    log, na counters and post/uniq flags all derive from the stream in
    ONE vectorized pass afterwards.  This removes the per-step [B, H]
    one-hot hit writes and [B, R] round-log updates that dominated the
    scan's memory traffic (the gather+rank math is the true floor)."""
    B, L = reads.shape
    H = max_hits
    lens = lens.astype(jnp.int32)
    # --no-anchorstop (hisat2.cpp ARG_NO_ANCHORSTOP): never end the
    # per-orientation search at a long unique anchor
    a_stop_len = np.int32(min_k + 12) if anchor_stop else np.int32(2**30)
    a_cancel_len = np.int32(min_k + 8)

    # right-to-left read chars, precomputed once: step s consumes
    # read[len-1-s].  One full-width gather here replaces L small
    # gathers inside the scan.
    if uniform:
        # all lens == L: the reverse-gather is a plain lane reverse,
        # which XLA lowers to a contiguous copy (no gather)
        rrev = reads[:, ::-1]
    else:
        colL = jnp.arange(L, dtype=jnp.int32)[None, :]
        ridx = lens[:, None] - 1 - colL
        rrev = jnp.where(ridx >= 0,
                         jnp.take_along_axis(reads, jnp.maximum(ridx, 0),
                                             axis=1), jnp.int32(4))

    def step(state, xs):
        s, c = xs
        top, bot, rb, arm, stopped = state
        pos = lens - 1 - s
        active = pos >= 0
        cc = jnp.minimum(c, 3)
        valid_c = (c < 4) & active
        t2, b2 = rk.lf_range(blocked, fchr, zrow, top, bot, cc)
        ok = valid_c & (b2 > t2)
        seg = rb - pos
        width = b2 - t2
        arm = arm & ~(ok & (seg - 1 >= a_cancel_len) & (width >= 4))
        astop = ok & arm & active & (seg >= a_stop_len) & (width == 1)
        fail = active & ~ok
        # event planes: 1 = mismatch close [pos+1, rb) with the PRE-LF
        # range; 2 = anchor stop [pos, rb) with the POST-LF range
        ev = jnp.where(astop, jnp.int32(2),
                       jnp.where(fail, jnp.int32(1), jnp.int32(0)))
        ev_top = jnp.where(astop, t2, top)
        ev_bot = jnp.where(astop, b2, bot)
        top_n = jnp.where(ok, t2, np.int32(0))
        bot_n = jnp.where(ok, b2, np.int32(rows))
        rb_n = jnp.where(ok, rb, pos)
        top_n = jnp.where(astop, np.int32(0), top_n)
        bot_n = jnp.where(astop, np.int32(rows), bot_n)
        rb_n = jnp.where(astop, pos, rb_n)
        arm = jnp.where(fail | astop, True, arm)
        top = jnp.where(active, top_n, top)
        bot = jnp.where(active, bot_n, bot)
        rb = jnp.where(active, rb_n, rb)
        stopped_out = stopped          # state BEFORE this step's astop
        stopped = stopped | astop
        return (top, bot, rb, arm, stopped), (ev, ev_top, ev_bot,
                                              stopped_out)

    z = jnp.zeros((B,), jnp.int32)
    init = (z, jnp.full((B,), rows, jnp.int32), lens.astype(jnp.int32),
            jnp.ones((B,), bool), jnp.zeros((B,), bool))
    (f_top, f_bot, f_rb, _, f_stopped), (ev, ev_top, ev_bot, ev_stop) = \
        jax.lax.scan(step, init,
                     (jnp.arange(L, dtype=jnp.int32), rrev.T))
    ev = ev.T                                   # [B, L]
    ev_top, ev_bot, ev_stop = ev_top.T, ev_bot.T, ev_stop.T
    return _finish_events(lens, H, min_hit_len, f_top, f_bot, f_rb,
                          f_stopped, ev, ev_top, ev_bot, ev_stop)


def search_lanes_live(search_fn, reads, lens, min_hit_len: int,
                      chunk: int = 2048):
    """Run a partial-search over only the lanes that can produce a hit.

    The spliced prefix RE-SEARCH (pipeline._align_device) hands every
    lane to the scan, but a lane whose uncovered prefix `cut` is shorter
    than min_hit_len can never record a hit (every write_hit /
    final-close span is bounded by the lane length) — its PartialHits
    row is all-zero by construction.  Typically most lanes have cut==0,
    yet the static-trip scan still issues their rank gathers every step.
    Here live lanes (lens >= min_hit_len) are compacted to the front and
    searched `chunk` lanes at a time under a dynamic-trip while_loop
    (the same argsort/prefix-sum pattern as resolve_rows_sparse); dead
    lanes are backfilled with zeros — identical to the dense scan for
    the hit slots (top/bot/lo/hi/nh), which is all the re-search
    consumes.  NOTE: the dense scan does record sub-min_hit_len ROUNDS
    (rounds/nrounds/stopped) for such lanes; do not use this wrapper
    where the search-budget round log of short lanes matters (the main
    search).  search_fn: (reads [K, L], lens [K]) -> PartialHits.
    """
    B, L = reads.shape
    if B <= chunk:
        return search_fn(reads, lens)
    lv = lens >= min_hit_len
    lvi = lv.astype(jnp.int32)
    pos = jnp.cumsum(lvi) - lvi
    total = pos[-1] + lvi[-1]
    src = jnp.argsort(1 - lvi, stable=True).astype(jnp.int32)
    nch = (B + chunk - 1) // chunk
    Bp = nch * chunk
    srcp = jnp.zeros((Bp,), jnp.int32).at[:B].set(src)
    protos = jax.eval_shape(
        search_fn, jax.ShapeDtypeStruct((chunk, L), reads.dtype),
        jax.ShapeDtypeStruct((chunk,), jnp.int32))
    bufs0 = tuple(jnp.zeros((Bp,) + p.shape[1:], p.dtype) for p in protos)

    def cond(st):
        return st[0] * chunk < total

    def body(st):
        k, bufs = st
        ids = jax.lax.dynamic_slice(srcp, (k * chunk,), (chunk,))
        ph = search_fn(reads[ids], lens.astype(jnp.int32)[ids])
        bufs = tuple(
            jax.lax.dynamic_update_slice(b, v, (k * chunk,)
                                         + (0,) * (b.ndim - 1))
            for b, v in zip(bufs, tuple(ph)))
        return k + 1, bufs

    _, bufs = jax.lax.while_loop(cond, body, (jnp.int32(0), bufs0))
    posc = jnp.minimum(pos, Bp - 1)
    outs = []
    for b in bufs:
        v = b[posc]
        m = lv.reshape((B,) + (1,) * (v.ndim - 1))
        outs.append(jnp.where(m, v, jnp.zeros((), b.dtype)))
    return PartialHits(*outs)


def _finish_events(lens, H, min_hit_len, f_top, f_bot, f_rb, f_stopped,
                   ev, ev_top, ev_bot, ev_stop):
    """Derive PartialHits from a per-position event stream (shared by
    the single- and double-step scans)."""
    B, L = ev.shape
    srange = jnp.arange(L, dtype=jnp.int32)[None, :]
    pos = lens[:, None] - 1 - srange            # [B, L] (monotone dec.)
    is_ev = ev > 0
    # rb at each event = pos of the previous event (init: len).  pos is
    # strictly decreasing in s, so a shifted running max over event
    # positions gives the previous event's pos.
    evpos = jnp.where(is_ev, pos, np.int32(2 ** 30))
    prev = jnp.concatenate(
        [jnp.full((B, 1), 2 ** 30, jnp.int32),
         jax.lax.cummin(evpos, axis=1)[:, :-1]], axis=1)
    rb_ev = jnp.where(prev < 2 ** 29, prev, lens[:, None])
    seg = jnp.where(ev == 2, rb_ev - pos, rb_ev - pos - 1)
    # terminal segment: [0, rb_final) with the final range, uniq=True
    term_seg = f_rb                              # lo == 0 after a full scan
    # hits = qualifying events (any astop; mismatch closes >= min_hit_len)
    rec = (ev == 2) | ((ev == 1) & (seg >= min_hit_len))
    # na (non-unique rounds before): mismatch closes with seg >= 1
    na_inc = ((ev == 1) & (seg >= 1)).astype(jnp.int32)
    na_before = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32),
         jnp.cumsum(na_inc, axis=1)[:, :-1]], axis=1)
    # compact the first H recorded events per lane, in order — rank-based
    # masked reductions instead of argsort+gather (see ops/compact.py;
    # which form pays on the H100 is ROADMAP C2)
    nrec = rec.sum(axis=1)
    rrank = jnp.cumsum(rec.astype(jnp.int32), axis=1) - 1
    hsel = rec[:, None, :] & (
        rrank[:, None, :]
        == jnp.arange(H, dtype=jnp.int32)[None, :, None])   # [B, H, L]
    gsel = lambda a: jnp.where(  # noqa: E731
        hsel, a[:, None, :], 0).sum(axis=2, dtype=jnp.int32)
    ht = gsel(ev_top)
    hb = gsel(ev_bot)
    hl = gsel(pos + (ev == 1).astype(jnp.int32))
    hh = gsel(rb_ev)
    ha = gsel(na_before)
    hu = jnp.any(hsel & (ev == 2)[:, None, :], axis=2)
    hp = jnp.any(hsel & ev_stop[:, None, :], axis=2)
    # append the terminal hit at slot nrec (if it qualifies and fits)
    term_ok = term_seg >= min_hit_len
    tslot = jnp.minimum(nrec, H - 1)[:, None]
    tsel = (jnp.arange(H, dtype=jnp.int32)[None, :] == tslot) \
        & term_ok[:, None] & (nrec < H)[:, None]
    ht = jnp.where(tsel, f_top[:, None], ht)
    hb = jnp.where(tsel, f_bot[:, None], hb)
    hl = jnp.where(tsel, 0, hl)
    hh = jnp.where(tsel, f_rb[:, None], hh)
    na_total = na_inc.sum(axis=1)
    ha = jnp.where(tsel, na_total[:, None], ha)
    hu = jnp.where(tsel, True, hu)
    hp = jnp.where(tsel, f_stopped[:, None], hp)
    nh = jnp.minimum(nrec + term_ok.astype(jnp.int32), H)
    # round log: EVERY event before the lane stopped, in order, plus the
    # terminal round; val = min(seg, 126)*2 + uniq
    round_ev = is_ev & ~ev_stop
    val = jnp.minimum(seg, 126) * 2 + (ev == 2)
    R = L // 2 + 2
    rrank_r = jnp.cumsum(round_ev.astype(jnp.int32), axis=1) - 1
    rsel = round_ev[:, None, :] & (
        rrank_r[:, None, :]
        == jnp.arange(R, dtype=jnp.int32)[None, :, None])   # [B, R, L]
    rl = jnp.where(rsel, val[:, None, :], 0).sum(axis=2, dtype=jnp.int32)
    nround = round_ev.sum(axis=1)
    term_round = (term_seg > 0) & ~f_stopped
    trslot = jnp.minimum(nround, R - 1)[:, None]
    trsel = (jnp.arange(R, dtype=jnp.int32)[None, :] == trslot) \
        & term_round[:, None] & (nround < R)[:, None]
    rl = jnp.where(trsel, jnp.minimum(term_seg, 126)[:, None] * 2 + 1, rl)
    rn = jnp.minimum(nround + term_round.astype(jnp.int32), R)
    RW = (R + 3) // 4
    pad = jnp.zeros((B, RW * 4 - R), jnp.int32)
    rl4 = jnp.concatenate([rl, pad], axis=1).reshape(B, RW, 4)
    sh = jnp.arange(4, dtype=jnp.int32)[None, None, :] * 8
    rwords = (rl4 << sh).sum(axis=2)
    return PartialHits(rwords, rn, ht, hb, hl, hh, nh, ha, hu, hp,
                       f_stopped)


def partial_search2(blocked, fchr, ftab2_top, zrow: int, zrow2: int,
                    rows: int, reads, lens, max_hits: int = 8,
                    min_hit_len: int = 16, min_k: int = 16,
                    uniform: bool = False,
                    anchor_stop: bool = True) -> PartialHits:
    """Double-step wavefront search: TWO read chars per scan iteration
    from ONE gathered row (bit-identical events to partial_search).

    The 44-column fused layout carries both the classic and the bigram
    (prev2, prev1) rank planes per 128-row block; gathers are
    latency-flat in row size on this hardware (PERF.md), so consuming
    two chars per gather halves the scan's dominant cost.  Per step:

      phase 1 (char c1): classic LF from the gathered rows — full
        per-char stop/disarm/mismatch semantics.
      phase 2 (char c2): for lanes whose phase-1 LF succeeded, the
        2-char range comes from the SAME rows via the bigram rank
        (ftab2[sym] + rank2, sym = c2*4 + c1); lanes that restarted at
        phase 1 start a fresh segment with the closed form
        [fchr[c2], fchr[c2+1]).

    Only linear-FM semantics change none: anchor-stop length/width
    checks run at every char, exactly like the reference's per-char
    loop (hi_aligner.h:5528-5608)."""
    B, L = reads.shape
    H = max_hits
    lens = lens.astype(jnp.int32)
    a_stop_len = np.int32(min_k + 12) if anchor_stop else np.int32(2**30)
    a_cancel_len = np.int32(min_k + 8)
    S = (L + 1) // 2

    if uniform:
        rrev = reads[:, ::-1]
    else:
        colL = jnp.arange(L, dtype=jnp.int32)[None, :]
        ridx = lens[:, None] - 1 - colL
        rrev = jnp.where(ridx >= 0,
                         jnp.take_along_axis(reads, jnp.maximum(ridx, 0),
                                             axis=1), jnp.int32(4))
    if L % 2:
        rrev = jnp.concatenate(
            [rrev, jnp.full((B, 1), 4, rrev.dtype)], axis=1)

    def phase(state, pos, c, t_new, b_new):
        """Shared per-char event/state logic given the LF result."""
        top, bot, rb, arm, stopped = state
        active = pos >= 0
        valid_c = (c < 4) & active
        ok = valid_c & (b_new > t_new)
        seg = rb - pos
        width = b_new - t_new
        arm = arm & ~(ok & (seg - 1 >= a_cancel_len) & (width >= 4))
        astop = ok & arm & active & (seg >= a_stop_len) & (width == 1)
        fail = active & ~ok
        ev = jnp.where(astop, jnp.int32(2),
                       jnp.where(fail, jnp.int32(1), jnp.int32(0)))
        ev_top = jnp.where(astop, t_new, top)
        ev_bot = jnp.where(astop, b_new, bot)
        top_n = jnp.where(ok, t_new, np.int32(0))
        bot_n = jnp.where(ok, b_new, np.int32(rows))
        rb_n = jnp.where(ok, rb, pos)
        top_n = jnp.where(astop, np.int32(0), top_n)
        bot_n = jnp.where(astop, np.int32(rows), bot_n)
        rb_n = jnp.where(astop, pos, rb_n)
        arm = jnp.where(fail | astop, True, arm)
        top = jnp.where(active, top_n, top)
        bot = jnp.where(active, bot_n, bot)
        rb = jnp.where(active, rb_n, rb)
        stopped_out = stopped
        stopped = stopped | astop
        restart = fail | astop
        return ((top, bot, rb, arm, stopped),
                (ev, ev_top, ev_bot, stopped_out), restart)

    def step(state, xs):
        s, c1, c2 = xs
        top, bot, rb, arm, stopped = state
        pos1 = lens - 1 - 2 * s
        pos2 = pos1 - 1
        # ONE row gather serves the classic LF (phase 1) AND the bigram
        # LF (phase 2, for lanes phase 1 advanced)
        i2 = jnp.concatenate([top, bot])
        rws = blocked[i2 >> 7]
        cc1 = jnp.minimum(c1, 3)
        r1 = rk.rank_from_rows(rws, i2, jnp.concatenate([cc1, cc1]),
                               zrow)
        lf1 = fchr[cc1]
        t1 = lf1 + r1[:B]
        b1 = lf1 + r1[B:]
        state, ev1, restart1 = phase(state, pos1, c1, t1, b1)
        # phase 2
        cc2 = jnp.minimum(c2, 3)
        sym = cc2 * 4 + cc1
        r2 = rk.rank2_from_rows(rws, i2, jnp.concatenate([sym, sym]),
                                zrow, zrow2)
        oh16 = (jnp.arange(16, dtype=jnp.int32)[None, :]
                == sym[:, None])
        base2 = jnp.where(oh16, ftab2_top[None, :], 0).sum(axis=1)
        t2b = base2 + r2[:B]
        b2b = base2 + r2[B:]
        oh4 = (jnp.arange(4, dtype=jnp.int32)[None, :] == cc2[:, None])
        t2f = jnp.where(oh4, fchr[None, :4], 0).sum(axis=1)
        b2f = jnp.where(oh4, fchr[None, 1:5], 0).sum(axis=1)
        t2 = jnp.where(restart1, t2f, t2b)
        b2 = jnp.where(restart1, b2f, b2b)
        state, ev2, _ = phase(state, pos2, c2, t2, b2)
        return state, (ev1, ev2)

    z = jnp.zeros((B,), jnp.int32)
    init = (z, jnp.full((B,), rows, jnp.int32), lens.astype(jnp.int32),
            jnp.ones((B,), bool), jnp.zeros((B,), bool))
    c1s = rrev[:, 0::2].T
    c2s = rrev[:, 1::2].T
    (f_top, f_bot, f_rb, _, f_stopped), (ev1, ev2) = jax.lax.scan(
        step, init, (jnp.arange(S, dtype=jnp.int32), c1s, c2s))

    def interleave(a1, a2):
        # [S, B] x2 -> [B, L] in original per-char order
        m = jnp.stack([a1, a2], axis=1)         # [S, 2, B]
        return m.transpose(2, 0, 1).reshape(B, 2 * S)[:, :L]

    ev = interleave(ev1[0], ev2[0])
    ev_top = interleave(ev1[1], ev2[1])
    ev_bot = interleave(ev1[2], ev2[2])
    ev_stop = interleave(ev1[3], ev2[3])
    return _finish_events(lens, H, min_hit_len, f_top, f_bot, f_rb,
                          f_stopped, ev, ev_top, ev_bot, ev_stop)
