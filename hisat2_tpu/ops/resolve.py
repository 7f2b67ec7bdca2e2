"""SA-range -> genome coordinate resolution (GroupWalk/getOffset equivalent).

The reference resolves each SA row by LF-walking left until it hits a sampled
row (GroupWalk2S, /root/reference/group_walk.h:1436; GFM::getOffset,
gfm.h:2374-2430).  Because our index samples by *text position* (every
2^off_rate-th joined offset is marked), the walk is guaranteed to terminate
within 2^off_rate steps — a static `fori_loop` bound with all lanes walking
in lock-step.  joined offset -> (reference id, ref offset) is a vectorized
binary search over the fragment table (GFM::joinedToTextOff, gfm.h:5076).

The walk body is FUSED: one step fetches the row's 128-row block (8 packed
BWT words + 4 mark words + occ/mark checkpoints) once and derives the BWT
char, the LF rank, the mark bit and the mark rank from that single fetch —
the HBM traffic per step is 4 gathers instead of the 7 a naive composition
of rank.py primitives would issue.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_PAIR_LO = np.uint32(0x55555555)
_FULL = np.uint32(0xFFFFFFFF)
_ONE = np.uint32(1)


def resolve_rows(blocked, fchr, mark_words, mark_chk, sa_marked,
                 zrow: int, off_rate: int, row):
    """SA values for each row in `row` (int32 [M]) -> joined offsets [M]."""
    if off_rate == 0:
        # every row marked: sa_marked IS the suffix array in row order
        return sa_marked[jnp.minimum(row, sa_marked.shape[0] - 1)]
    M = row.shape[0]
    w4 = jnp.arange(4, dtype=jnp.int32)[None, :]
    # mark words + checkpoint fused into the blocked row (widths 17/49,
    # index.format.fuse_blocked): ONE gather per step serves BWT char,
    # LF rank, mark bit and mark rank.  Legacy 12/44-col tables fall
    # back to separate mark gathers.
    fused_marks = blocked.shape[1] in (17, 49)
    Wm = blocked.shape[1] - 5

    def body(_, st):
        r, steps, done, mr_hit, st_hit = st
        blk = r >> 7
        within = r & 127
        brow = blocked[blk]                                 # [M, 12..49]
        bw = brow[:, 4:12]
        if fused_marks:
            mw = brow[:, Wm:Wm + 4]
            chk = brow[:, Wm + 4].astype(jnp.int32)
        else:
            mw = mark_words[(blk << 2)[:, None] + w4]              # [M, 4]
            chk = mark_chk[blk]
        # mark bit + mark rank from the same 4 words
        mword = jnp.take_along_axis(mw, ((r >> 5) & 3)[:, None],
                                    axis=1)[:, 0]
        marked = ((mword >> (r & 31).astype(jnp.uint32)) & _ONE) != 0
        nv_m = jnp.clip(within[:, None] - 32 * w4, 0, 32)
        sh_m = jnp.minimum(nv_m, 31).astype(jnp.uint32)
        msk_m = jnp.where(nv_m >= 32, _FULL, (_ONE << sh_m) - _ONE)
        mrank = chk + jax.lax.population_count(
            mw & msk_m).astype(jnp.int32).sum(axis=1)
        m = marked & ~done
        # defer the sa_marked lookup: record (mrank, steps) at the mark
        # and gather ONCE after the loop (16 fewer gathers per walk)
        mr_hit = jnp.where(m, mrank, mr_hit)
        st_hit = jnp.where(m, steps, st_hit)
        done = done | m
        # BWT char from the fetched block
        word = jnp.take_along_axis(bw, ((r >> 4) & 7)[:, None],
                                   axis=1)[:, 0]
        c = ((word >> (2 * (r & 15)).astype(jnp.uint32)) & np.uint32(3)
             ).astype(jnp.int32)
        # LF: occ checkpoint + in-block popcount over the same 8 words
        pat = (c.astype(jnp.uint32) * _PAIR_LO)[:, None]
        x = ~(bw ^ pat)
        pairs = x & (x >> _ONE) & _PAIR_LO
        nv = jnp.clip(within[:, None] - 16 * jnp.arange(
            8, dtype=jnp.int32)[None, :], 0, 16)
        sh = jnp.minimum(2 * nv, 31).astype(jnp.uint32)
        msk = jnp.where(nv >= 16, _FULL, (_ONE << sh) - _ONE)
        cnt = jax.lax.population_count(pairs & msk).astype(
            jnp.int32).sum(axis=1)
        corr = ((c == 0) & (zrow >= (blk << 7)) & (r > zrow)
                ).astype(jnp.int32)
        base = jnp.where(
            c < 2, jnp.where(c == 0, brow[:, 0], brow[:, 1]),
            jnp.where(c == 2, brow[:, 2], brow[:, 3])).astype(jnp.int32)
        r2 = fchr[c] + base + cnt - corr
        r = jnp.where(done, r, r2)
        steps = steps + (~done).astype(jnp.int32)
        return r, steps, done, mr_hit, st_hit

    st = (row.astype(jnp.int32), jnp.zeros((M,), jnp.int32),
          jnp.zeros((M,), bool), jnp.zeros((M,), jnp.int32),
          jnp.zeros((M,), jnp.int32))
    _, _, done, mr_hit, st_hit = jax.lax.fori_loop(
        0, (1 << off_rate) + 1, body, st)
    return jnp.where(
        done,
        sa_marked[jnp.minimum(mr_hit, sa_marked.shape[0] - 1)] + st_hit,
        0)


def resolve_rows_sparse(blocked, fchr, mark_words, mark_chk, sa_marked,
                        zrow: int, off_rate: int, row, live,
                        chunk: int = 32768):
    """resolve_rows over only the LIVE rows, walked in dynamic chunks.

    The candidate grid is mostly dead (hv/cval-masked slots: hits narrower
    than their row cap, invalid hits, padding) — typically ~5x more slots
    than live rows at genome scale (PERF.md config-6 profile).  The dense
    walk still gathers a 196 B block row per slot per LF step, so dead
    slots dominate the resolve stage's HBM traffic AND its loop-state
    copies.  Here live rows are compacted to the front (stable argsort of
    the mask — two gathers, no scatter), walked `chunk` rows at a time
    under a `while_loop` whose trip count is ceil(live_total/chunk), and
    scattered back by the exclusive-prefix-sum position.  Worst case
    (all live) does the same work as the dense walk; typical case cuts
    gather volume by the dead-slot ratio.  Dead rows return 0 (callers
    mask on `live` downstream, matching the previous `where(hv, top, 0)`
    garbage-walk semantics).
    """
    M = row.shape[0]
    if off_rate == 0:
        return jnp.where(
            live, sa_marked[jnp.minimum(row, sa_marked.shape[0] - 1)], 0)
    if M <= chunk:
        return jnp.where(live, resolve_rows(
            blocked, fchr, mark_words, mark_chk, sa_marked, zrow,
            off_rate, jnp.where(live, row, 0)), 0)
    nch = (M + chunk - 1) // chunk
    Mp = nch * chunk
    lv = live.astype(jnp.int32)
    pos = jnp.cumsum(lv) - lv                    # exclusive prefix sum [M]
    total = pos[-1] + lv[-1]
    src = jnp.argsort(1 - lv, stable=True)       # live-first permutation
    comp = jnp.zeros((Mp,), row.dtype).at[:M].set(
        jnp.where(live, row, 0)[src])
    out0 = jnp.zeros((Mp,), sa_marked.dtype)

    def cond(st):
        return st[0] * chunk < total

    def body(st):
        k, out = st
        rows_k = jax.lax.dynamic_slice(comp, (k * chunk,), (chunk,))
        res_k = resolve_rows(blocked, fchr, mark_words, mark_chk,
                             sa_marked, zrow, off_rate, rows_k)
        return k + 1, jax.lax.dynamic_update_slice(out, res_k,
                                                   (k * chunk,))

    _, out = jax.lax.while_loop(cond, body, (jnp.int32(0), out0))
    return jnp.where(live, out[jnp.minimum(pos, Mp - 1)], 0)


def resolve_consecutive(blocked, fchr, mark_words, mark_chk, sa_marked,
                        zrow: int, off_rate: int, top, P: int,
                        live=None, chunk: int = 32768):
    """SA values for the CONSECUTIVE rows top..top+P-1 per lane/hit.

    top: int32 [...]; returns [..., P] joined offsets.  On full-SA
    indexes (off_rate == 0, sa_marked padded to a multiple of 8 by
    to_device) the P consecutive entries come from ceil(P/8)+1 gathered
    8-entry ROWS — ~P/3 fewer gathered indices than the flat
    per-element gather, the hot op of the resolve stage.  Sampled-SA indexes fall back to the lock-step walk —
    sparse (live-compacted, chunk-walked) when a `live` [..., P] mask is
    given, dense otherwise."""
    j = jnp.arange(P, dtype=jnp.int32)
    ns = sa_marked.shape[0]
    if off_rate == 0 and ns % 8 == 0:
        nr = ns // 8
        NR = (P + 7) // 8 + 1
        rows = sa_marked.reshape(nr, 8)
        r0 = jnp.minimum(top, ns - 1) >> 3
        roff = jnp.arange(NR, dtype=jnp.int32)
        ridx = jnp.clip(r0[..., None] + roff, 0, nr - 1)
        words = rows[ridx].reshape(top.shape + (NR * 8,))
        wsel = (jnp.minimum(top, ns - 1) & 7)[..., None] + j
        out = jnp.zeros(top.shape + (P,), sa_marked.dtype)
        for wi in range(NR * 8):
            out = jnp.where(wsel == wi, words[..., wi:wi + 1], out)
        return out
    rowm = top[..., None] + j
    if live is not None:
        flat = resolve_rows_sparse(
            blocked, fchr, mark_words, mark_chk, sa_marked, zrow,
            off_rate, rowm.reshape(-1), live.reshape(-1), chunk=chunk)
    else:
        flat = resolve_rows(blocked, fchr, mark_words, mark_chk,
                            sa_marked, zrow, off_rate, rowm.reshape(-1))
    return flat.reshape(rowm.shape)


def joined_to_ref(frag_joined, frag_ref, frag_off, pos, span):
    """Map joined [pos, pos+span) -> (ref_id, ref_offset, in_bounds).

    in_bounds is False when the interval crosses a fragment boundary (the
    joined text concatenates fragments with nothing between them, so a hit
    spanning two fragments is bogus — same check as the reference's
    straddled logic in joinedToTextOff)."""
    f = jnp.searchsorted(frag_joined, pos, side="right") - 1
    f = jnp.clip(f, 0, frag_ref.shape[0] - 1)
    ok = (pos >= frag_joined[f]) & (pos + span <= frag_joined[f + 1])
    return frag_ref[f], frag_off[f] + (pos - frag_joined[f]), ok
