"""Batched rank / LF-mapping primitives (jnp; the hot inner ops).

These are the batched equivalents of the reference's per-row side walk:
  countBt2Side  (gfm.h:2557-2625)  -> rank()
  mapLF         (gfm.h:3280-3357)  -> lf()
Every function is vectorized over a lane axis: one call advances a whole
batch of rows.  rank = occ checkpoint (gather) + masked popcount over the
8 packed uint32 words of a 128-row block; XLA fuses the bit-math into a few
elementwise ops per lane, and the device-memory traffic is the gather.

CONSTANTS RULE: never materialize jnp arrays at module/trace scope
(jnp.uint32(...), module-level jnp.arange, closed-over device arrays).
They embed as captured device-buffer constants in the executable instead
of program literals.  Constants here are numpy scalars (folded into the
HLO as literals); all real arrays are function ARGUMENTS.  What a captured
constant costs on the H100 is not measured (ROADMAP C2).

All row indices are int32; packed words are uint32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..index.format import WORDS_PER_BLOCK

_PAIR_LO = np.uint32(0x55555555)
_FULL = np.uint32(0xFFFFFFFF)
_ONE = np.uint32(1)


def _word_offsets():
    return jnp.arange(WORDS_PER_BLOCK, dtype=jnp.int32)[None, :]


def rank_from_rows(row, i, c, zrow: int):
    """rank() given the PRE-GATHERED blocked rows for positions i —
    lets one gather serve several rank flavors (partial_search2 computes
    both the 1-char and the bigram LF from the same rows)."""
    blk = i >> 7
    within = i & 127
    # occ[c] via a 4-way select (cheaper than a second gather)
    base = jnp.where(
        c < 2,
        jnp.where(c == 0, row[:, 0], row[:, 1]),
        jnp.where(c == 2, row[:, 2], row[:, 3])).astype(jnp.int32)
    w = row[:, 4:12]
    pat = (c.astype(jnp.uint32) * _PAIR_LO)[:, None]
    x = ~(w ^ pat)
    pairs = x & (x >> _ONE) & _PAIR_LO                             # 1/match-pair
    nvalid = jnp.clip(within[:, None] - 16 * _word_offsets(), 0, 16)
    shift = jnp.minimum(2 * nvalid, 31).astype(jnp.uint32)
    mask = jnp.where(nvalid >= 16, _FULL, (_ONE << shift) - _ONE)
    cnt = jax.lax.population_count(pairs & mask).astype(jnp.int32).sum(axis=1)
    # '$' is packed as char 0 at zrow; the occ checkpoints exclude it, so the
    # phantom only appears in the in-block popcount: subtract when zrow lies
    # in [block_start, i).
    corr = ((c == 0) & (zrow >= (blk << 7)) & (i > zrow)).astype(jnp.int32)
    return base + cnt - corr


def rank(blocked, zrow: int, i, c):
    """# occurrences of char c in bwt[0:i), '$' excluded.  i,c: int32 [B].

    blocked: the fused [nblocks+1, 12+] layout (index.format.fuse_blocked)
    — occ checkpoint + the block's 8 BWT words in ONE gathered row, so
    one gather serves both.
    """
    return rank_from_rows(blocked[i >> 7], i, c, zrow)


def lf(blocked, fchr, zrow: int, i, c):
    """LF mapping: row of the suffix obtained by prepending char c."""
    return fchr[c] + rank(blocked, zrow, i, c)


def lf_range(blocked, fchr, zrow: int, top, bot, c):
    """One backward-search step on [top, bot) ranges (2 rank queries/lane)."""
    i2 = jnp.concatenate([top, bot])
    c2 = jnp.concatenate([c, c])
    r = lf(blocked, fchr, zrow, i2, c2)
    b = top.shape[0]
    return r[:b], r[b:]


def bwt_char(bwt_words, i):
    """BWT char at row i (the '$' slot reads as 0; callers guard via marks)."""
    w = bwt_words[i >> 4]
    return ((w >> (2 * (i & 15)).astype(jnp.uint32)) & np.uint32(3)
            ).astype(jnp.int32)


def mark_rank(mark_words, mark_chk, i):
    """# of marked rows in [0, i): checkpoint + masked popcount over the
    4 mark words of the row's 128-row block."""
    blk = i >> 7
    base = mark_chk[blk]
    woff = jnp.arange(4, dtype=jnp.int32)[None, :]
    w = mark_words[(blk << 2)[:, None] + woff]                    # [B, 4]
    within = i & 127
    nvalid = jnp.clip(within[:, None] - 32 * woff, 0, 32)
    shift = jnp.minimum(nvalid, 31).astype(jnp.uint32)
    mask = jnp.where(nvalid >= 32, _FULL, (_ONE << shift) - _ONE)
    cnt = jax.lax.population_count(w & mask).astype(jnp.int32).sum(axis=1)
    return base + cnt


def is_marked(mark_words, i):
    w = mark_words[i >> 5]
    return ((w >> (i & 31).astype(jnp.uint32)) & _ONE) != 0


def ref_char(ref_words, pos):
    """Joined-reference char at position pos (2-bit gather; getStretch
    equivalent, reference.h:59)."""
    w = ref_words[pos >> 4]
    return ((w >> (2 * (pos & 15)).astype(jnp.uint32)) & np.uint32(3)
            ).astype(jnp.int32)


# branch gate: above 8M words (134.2 Mbp of joined text) a 128-padded
# operand takes the 128-word-row branch of ref_chars_block.  The gate was
# sized for a tiled device layout in which the [nw//8, 8] view costs a
# scratch copy of the whole text; whether one branch serves every size on
# the H100 is open (ROADMAP C2).  A module constant, so tests can force
# the 128-word-row branch on small fixtures.
_ROW8_MAX_WORDS = 8 << 20


def ref_chars_branch(nw: int) -> str:
    """Which gather branch ref_chars_block takes for a ref_words operand
    of nw words: 'row128', 'row8', 'slice8' or 'word'."""
    if nw % 128 == 0 and nw > _ROW8_MAX_WORDS:
        return "row128"
    if nw % 8 == 0:
        return "row8" if nw <= _ROW8_MAX_WORDS else "slice8"
    return "word"


def ref_chars_block(ref_words, n_text: int, start, L: int):
    """Chars ref[start + t] for t in [0, L): [..., L] int32, 4 where the
    position leaves the text.

    Instead of one scalar word-gather per CHAR (ref_char over a [N,C,L]
    position grid), this gathers each diagonal's packed words and
    extracts the chars with a one-hot select + shift (elementwise work).
    When ref_words is padded to a multiple of 8 (done by
    FMIndex.to_device), the gather fetches 8-word ROWS: the span of
    W + 7 <= 15 consecutive words always fits in 2 rows, so each
    diagonal costs 2 row gathers instead of W word gathers (the select
    widens to 16 one-hots).  Which of the branches pays on the H100 is
    not measured (ROADMAP C2)."""
    W = L // 16 + 2
    w0 = start >> 4                                       # [..., C]
    rel = (start & 15)[..., None]                         # char offset in w0
    nw = ref_words.shape[0]
    t = jnp.arange(L, dtype=jnp.int32)
    bitpos = rel + t                                      # broadcast [..., L]
    sh = (2 * (bitpos & 15)).astype(jnp.uint32)
    branch = ref_chars_branch(nw)
    if branch == "row128":
        # genome-scale: gather 128-word rows of a [nw//128, 128] view.
        # The W-word span at any 128-word phase needs
        # ceil((127 + W)/128) rows (2 for W <= 129, i.e. reads + margin
        # up to ~2000 chars); the span is then extracted with one
        # take_along_axis over the gathered words.
        nr = nw // 128
        NRR = (126 + W) // 128 + 1
        r0 = w0 >> 7
        roff = jnp.arange(NRR, dtype=jnp.int32)
        ridx = jnp.clip(r0[..., None] + roff, 0, nr - 1)
        rows = ref_words.reshape(nr, 128)
        wide = rows[ridx].reshape(w0.shape + (NRR * 128,))
        base = (w0 & 127)[..., None]                      # [..., C, 1]
        words = jnp.take_along_axis(
            wide, base + jnp.arange(W, dtype=jnp.int32), axis=-1)
        wsel = bitpos >> 4                                # in [0, W)
        NW = W
    elif branch in ("row8", "slice8"):
        nr = nw // 8
        NR = (W + 7) // 8 + 1       # rows covering W words at any offset
        r0 = w0 >> 3
        roff = jnp.arange(NR, dtype=jnp.int32)
        ridx = jnp.clip(r0[..., None] + roff, 0, nr - 1)
        if branch == "row8":
            # row-gather over a [nr, 8] view (below the gate — see
            # _ROW8_MAX_WORDS)
            rows = ref_words.reshape(nr, 8)
            words = rows[ridx].reshape(w0.shape + (NR * 8,))
        else:
            # not 128-padded (legacy upload): gather 8-word SLICES from
            # the flat array; FMIndex.to_device pads to 128 words, so
            # the 128-word-row branch runs instead
            words = jax.lax.gather(
                ref_words,
                (ridx * 8)[..., None].astype(jnp.int32),
                jax.lax.GatherDimensionNumbers(
                    offset_dims=(ridx.ndim,),
                    collapsed_slice_dims=(),
                    start_index_map=(0,)),
                slice_sizes=(8,),
                mode=jax.lax.GatherScatterMode.CLIP,
            ).reshape(w0.shape + (NR * 8,))               # [..., C, NR*8]
        wsel = (w0 & 7)[..., None] + (bitpos >> 4)        # in [0, NR*8)
        NW = NR * 8
    else:
        woff = jnp.arange(W, dtype=jnp.int32)
        widx = jnp.clip(w0[..., None] + woff, 0, nw - 1)
        words = ref_words[widx]                           # [..., C, W]
        wsel = bitpos >> 4                                # in [0, W)
        NW = W
    sel = jnp.zeros(wsel.shape[:-1] + (L,), jnp.uint32)
    for wi in range(NW):
        sel = jnp.where(wsel == wi, words[..., wi:wi + 1], sel)
    ch = ((sel >> sh) & np.uint32(3)).astype(jnp.int32)
    pos = start[..., None] + t
    return jnp.where((pos < 0) | (pos >= n_text), jnp.int32(4), ch)


_NIB_LO = np.uint32(0x11111111)


def rank2_from_rows(row, i, sym, zrow: int, zrow2: int):
    """rank2() on pre-gathered 44-column rows (see rank_from_rows)."""
    blk = i >> 7
    within = i & 127
    # occ2[sym] via one-hot reduce (instead of a per-lane dynamic
    # column index, which would be a second gather)
    onehot = (jnp.arange(16, dtype=jnp.int32)[None, :]
              == sym[:, None].astype(jnp.int32))
    base = jnp.where(onehot, row[:, 12:28].astype(jnp.int32), 0
                     ).sum(axis=1)
    w = row[:, 28:44]                                         # [B, 16]
    pat = (sym.astype(jnp.uint32) * _NIB_LO)[:, None]
    x = w ^ pat
    m = x | (x >> _ONE) | (x >> np.uint32(2)) | (x >> np.uint32(3))
    hit = (~m) & _NIB_LO                       # bit0 of matching nibbles
    woff = jnp.arange(16, dtype=jnp.int32)[None, :]
    nvalid = jnp.clip(within[:, None] - 8 * woff, 0, 8)
    shift = jnp.minimum(4 * nvalid, 31).astype(jnp.uint32)
    mask = jnp.where(nvalid >= 8, _FULL, (_ONE << shift) - _ONE)
    cnt = jax.lax.population_count(hit & mask).astype(jnp.int32).sum(axis=1)
    corr = jnp.zeros_like(cnt)
    for zr in (zrow, zrow2):
        if zr >= 0:
            corr = corr + ((sym == 0) & (zr >= (blk << 7))
                           & (i > zr)).astype(jnp.int32)
    return base + cnt - corr


def rank2(blocked, zrow: int, zrow2: int, i, sym):
    """# rows j < i whose two PRECEDING text chars form 4-bit symbol
    `sym` (prev2*4 + prev1) — the bigram-BWT rank backing the
    double-step backward search (ops/search.partial_search2).

    blocked: the 44-column fused layout (index.format.fuse_blocked with
    bigram planes): cols 12..27 = occ2 checkpoint, 28..43 = 16 packed
    4-bit symbol words per 128-row block.  The <=2 rows with SA < 2
    (zrow, zrow2) pack symbol 0; corrected like rank()'s '$' slot."""
    return rank2_from_rows(blocked[i >> 7], i, sym, zrow, zrow2)
