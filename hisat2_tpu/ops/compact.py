"""Small-axis gather / sort replacements for the candidate hot path.

`take_along_axis` over a short axis (candidate slots, C/J <= ~150) is a
gather per element, and XLA's sort lowers to many bitonic passes.  For
those widths a masked reduction — broadcast-compare the index against an
iota and reduce — is elementwise work that XLA fuses into a handful of
passes.  The choice was made for another accelerator; whether it pays on
the H100 at the [B~16K, J~50] shapes the candidate pipeline uses is not
measured (ROADMAP C2).  (The reference has no analog: its per-read C++
touches one candidate at a time; this file serves the *batched*
candidate bookkeeping.)

Use these ONLY for small J — the work is O(B * M * J).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def take_cols(v, idx):
    """take_along_axis(v, idx, axis=1) for v: [B, J] with SMALL J.

    idx: [B, M] int32; out-of-range indices yield 0/False."""
    J = v.shape[1]
    sel = idx[:, :, None] == jnp.arange(J, dtype=jnp.int32)[None, None, :]
    if v.dtype == jnp.bool_:
        return jnp.any(sel & v[:, None, :], axis=-1)
    return jnp.where(sel, v[:, None, :], 0).sum(axis=-1, dtype=v.dtype)


def take_last(v, idx):
    """take_along_axis(v, idx[..., None], axis=-1)[..., 0] for v: [B, C, W]
    with small-ish W (penalty-plane prefix lookups).  idx: [B, C]."""
    W = v.shape[-1]
    sel = idx[..., None] == jnp.arange(W, dtype=jnp.int32)
    if v.dtype == jnp.bool_:
        return jnp.any(sel & v, axis=-1)
    return jnp.where(sel, v, 0).sum(axis=-1, dtype=v.dtype)


def stable_rank_asc(key):
    """Stable ascending sort rank per lane: rank[b, j] = position of
    element j in jnp.argsort(key[b], stable=True).  key: [B, J] int32."""
    J = key.shape[1]
    kj = key[:, :, None]                  # key[j]
    kk = key[:, None, :]                  # key[k]
    tri = np.tril(np.ones((J, J), bool), -1)[None]      # k < j
    return ((kk < kj) | ((kk == kj) & tri)).sum(axis=-1,
                                                dtype=jnp.int32)


def select_ranked(sel, v, fill=0):
    """Gather v[b, j] into slot m where sel[b, m, j] (at most one j per
    (b, m)); empty slots get `fill`.  sel: [B, M, J] bool, v: [B, J]."""
    if v.dtype == jnp.bool_:
        return jnp.any(sel & v[:, None, :], axis=-1)
    out = jnp.where(sel, v[:, None, :], 0).sum(axis=-1, dtype=v.dtype)
    if fill:
        out = jnp.where(jnp.any(sel, axis=-1), out, fill)
    return out
