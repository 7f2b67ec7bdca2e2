"""Mate rescue: anchored search for the unaligned mate of a pair.

The reference rescues a mate by searching the LOCAL index around the
aligned mate's position with 8 bp minimum anchors (HI_Aligner::alignMate,
hi_aligner.h:4696-4870).  Here index search is skipped entirely: the
candidate window is small (the pair's insert range), so the mate is matched
against every diagonal of the window at once with a grouped one-hot
cross-correlation — one convolution (cuDNN on a GPU) — and the top
diagonals are rescored exactly by the standard extension kernel
(quality-aware penalties, known-SNP forgiveness, soft clips).

matches[r, d] = sum_t [read[r, t] == ref[win_start[r] + d + t]]

The one-hots are bfloat16, so a count is exact up to 256 (a bf16 holds
every integer up to 2^8): reads longer than 256 bp need integer counts
(ROADMAP B2).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import extend as extend_ops
from . import rank as rk


def window_match_counts(refc, reads):
    """matches[r, d] = #{t : reads[r, t] == refc[r, d + t] < 4} as float32
    [R, W] for refc [R, W + L - 1] and reads [R, L] (codes 0..3, 4 = N or
    padding, which matches nothing)."""
    R, L = reads.shape
    span = refc.shape[1]
    # grouped one-hot cross-correlation: one conv group per lane
    ref1h = (refc[:, None, :] == jnp.arange(4, dtype=jnp.int32)
             [None, :, None]).astype(jnp.bfloat16)            # [R, 4, span]
    rd1h = (reads[:, None, :] == jnp.arange(4, dtype=jnp.int32)
            [None, :, None]).astype(jnp.bfloat16)             # [R, 4, L]
    matches = jax.lax.conv_general_dilated(
        ref1h.reshape(1, R * 4, span),                        # NCW
        rd1h.reshape(R, 4, L),                                # OIW
        window_strides=(1,), padding="VALID",
        feature_group_count=R)[0]                             # [R, W]
    return matches.astype(jnp.float32)


def rescue_candidates(ref_words, n_text: int, reads, quals, lens,
                      win_start, W: int, mm_pen, clip_pen,
                      n_pen: int, allow_softclip: bool = True,
                      snv_delta1=None, snv_delta2=None, top: int = 8):
    # top must exceed the reference's nelt cap of 5 (hi_aligner.h:4760):
    # the host counts equally-scoring placements among these diagonals to
    # decide whether the mate repeats too often in the window to rescue
    """reads: int32 [R, L] mate codes ALREADY in the expected orientation;
    win_start: int32 [R] joined start of each lane's search window of W
    diagonals (the reference searches the 57,344 bp local-index window
    containing the anchor — hier_idx_common.h:24-31).  Returns
    (starts [R, top], ExtendResult) for the best-matching diagonals."""
    L = reads.shape[1]

    # gather the window's reference chars once: [R, W + L - 1]
    span = W + L - 1
    col = jnp.arange(span, dtype=jnp.int32)[None, :]
    pos = win_start[:, None] + col
    oob = (pos < 0) | (pos >= n_text)
    refc = jnp.where(oob, jnp.int32(4),
                     rk.ref_char(ref_words, jnp.clip(pos, 0, n_text - 1)))

    matches = window_match_counts(refc, reads)               # [R, W]
    _, didx = jax.lax.top_k(matches, top)                     # [R, top]
    starts = win_start[:, None] + didx

    ext = extend_ops.extend_grouped(
        ref_words, n_text, reads, quals, lens, starts,
        mm_pen, clip_pen, n_pen, allow_softclip=allow_softclip,
        snv_delta1=snv_delta1, snv_delta2=snv_delta2)
    return starts, ext
